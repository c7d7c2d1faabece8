"""Batched serving engine of the port (counterpart of
``repro.serve.engine``): slot-based continuous batching over the model
zoo's cache API.

``generate_batch`` is lockstep batched generation: one prefill of the
whole prompt batch through the cached forward, then one decode step per
new token. The slot engine (``submit``/``step``) admits a queued request
into a free slot by prefilling its prompt one token at a time through
the batched decode step, as the reference does: every slot's cache
advances with it. Decoding is greedy (``argmax``, ties to the lower
token id) or, with ``temperature > 0``, sampled from a
``torch.Generator`` seeded by ``seed``.

Drift injection, the health monitor and its fallback, in-service
recalibration and the telemetry registry come with ROADMAP queue 1, item
11: the constructor refuses their keywords rather than ignoring them.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import ModelFns

#: keywords of the reference's engine whose features are not ported yet
_UNPORTED = ("drift_key", "drift_schedule", "health", "fallback_backend",
             "auto_recalibrate", "metrics", "report_every", "layout_version")


def engine_from_artifact(artifact, cfg: ModelConfig, *, mesh=None,
                         device=None, **engine_kw) -> "ServingEngine":
    """A ``ServingEngine`` serving a model ``DeployArtifact`` on its packed
    backend, on ``device`` (``cuda`` unless ``"cpu"``). ``artifact`` is an
    artifact (``repro_torch.api.model_artifact``) or the path of one saved
    by either package, loaded with ``DeployArtifact.load``. ``cfg``'s
    ``cim`` is replaced by the artifact's pinned config, so the engine runs
    exactly the quantization state that was packed. Column-parallel
    serving (``mesh``) comes with ROADMAP queue 1, item 12."""
    from repro_torch.api import DeployArtifact
    from repro_torch.models.registry import get_model
    if mesh is not None:
        raise NotImplementedError("column-parallel serving is not ported yet "
                                  "(ROADMAP queue 1, item 12)")
    if isinstance(artifact, (str, os.PathLike)):
        artifact = DeployArtifact.load(os.fspath(artifact), device=device)
    if not isinstance(artifact, DeployArtifact):
        raise TypeError(f"engine_from_artifact takes a DeployArtifact or its "
                        f"path, got {type(artifact).__name__}")
    if artifact.kind != "model":
        raise ValueError(f"engine_from_artifact needs a 'model' artifact, "
                         f"got kind={artifact.kind!r}")
    serve_cfg = dataclasses.replace(cfg, cim=artifact.config)
    return ServingEngine(get_model(serve_cfg), serve_cfg, artifact.params,
                         device=device, **engine_kw)


def _next_token(logits: torch.Tensor, temperature: float,
                gen: torch.Generator) -> torch.Tensor:
    """(B, T, V) logits -> (B, 1) int32 next tokens from the last position:
    argmax, or a draw from softmax(logits / temperature)."""
    last = logits[:, -1, :].to(torch.float32)
    if temperature > 0:
        probs = torch.softmax(last / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
    else:
        nxt = torch.argmax(last, dim=-1)
    return nxt[:, None].to(torch.int32)


def make_prefill(model: ModelFns, cfg: ModelConfig):
    """(params, cache, tokens (B, T)) -> (logits (B, T, V), cache), through
    the decode path so the caches fill in one pass."""
    def prefill(params, cache, tokens):
        return model.decode_step(params, cache, tokens, cfg)
    return prefill


def make_decode_step(model: ModelFns, cfg: ModelConfig,
                     temperature: float = 0.0):
    """(params, cache, tokens (B, 1), generator) -> (next tokens (B, 1)
    int32, cache)."""
    def step(params, cache, tokens, gen):
        logits, cache = model.decode_step(params, cache, tokens, cfg)
        return _next_token(logits, temperature, gen), cache
    return step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                   # (T,) int32
    max_new_tokens: int
    eos_id: int = -1                     # -1: run to max_new_tokens
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Fixed-B slot engine. Prompts are prefilled one slot at a time through
    the batched decode step; decode steps advance all live slots
    together. ``params`` are moved to ``device`` (``cuda`` unless
    ``"cpu"``)."""

    def __init__(self, model: ModelFns, cfg: ModelConfig, params,
                 batch_size: int = 8, max_len: int = 1024,
                 temperature: float = 0.0, seed: int = 0, *, device=None,
                 **unported):
        if unported:
            bad = sorted(unported)
            known = [k for k in bad if k in _UNPORTED]
            if known:
                raise NotImplementedError(
                    f"ServingEngine: {known} (drift, health, fallback, "
                    "recalibration, telemetry) are not ported yet (ROADMAP "
                    "queue 1, item 11)")
            raise TypeError(f"ServingEngine: unexpected keywords {bad}")
        self.device = resolve_device(device)
        self.model, self.cfg = model, cfg
        self.params = to_device(params, self.device)
        self.B, self.max_len = batch_size, max_len
        self.temperature = temperature
        self.cache = model.init_cache(cfg, batch_size, max_len,
                                      device=self.device)
        self._prefill_fn = make_prefill(model, cfg)
        self._step_fn = make_decode_step(model, cfg, temperature)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.t = 0                           # model invocations so far
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.queue: List[Request] = []
        self.last_tok = np.zeros((batch_size, 1), np.int32)
        self._next_rid = 0
        self.retired = 0

    def submit(self, prompt, max_new_tokens: int, eos_id: int = -1) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, np.asarray(prompt, np.int32),
                                  max_new_tokens, eos_id))
        return rid

    def _tokens(self, tok: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(tok, dtype=np.int32)).to(self.device)

    def _invoke_step(self, tok: np.ndarray) -> np.ndarray:
        """One model invocation over the whole batch."""
        self.t += 1
        nxt, self.cache = self._step_fn(self.params, self.cache,
                                        self._tokens(tok), self.gen)
        return nxt.cpu().numpy()

    def _admit(self) -> None:
        """Fill empty slots: prefill the prompt token by token, batched with
        the other slots' last tokens, as the reference does (every slot's
        cache advances with it)."""
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                for t in req.prompt:
                    tok = np.array(self.last_tok)
                    tok[i, 0] = t
                    nxt = self._invoke_step(tok)
                    self.last_tok[i, 0] = nxt[i, 0]

    def step(self) -> List[Dict]:
        """One decode step for all active slots; returns finished requests."""
        self._admit()
        if all(s is None for s in self.slots):
            return []
        nxt = self._invoke_step(self.last_tok)
        finished = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(nxt[i, 0])
            req.output.append(tok)
            self.last_tok[i, 0] = tok
            if tok == req.eos_id or len(req.output) >= req.max_new_tokens:
                req.done = True
                finished.append({"rid": req.rid, "tokens": req.output})
                self.slots[i] = None
                self.retired += 1
        return finished

    def generate_batch(self, prompts: np.ndarray,
                       max_new_tokens: int) -> np.ndarray:
        """Lockstep batched generation: prompts (B, Tp) -> (B, Tnew). The
        first new token is the prefill's argmax; the rest follow the
        engine's decoding rule."""
        if prompts.shape[0] != self.B:
            raise ValueError(f"generate_batch takes {self.B} prompts, got "
                             f"{prompts.shape[0]}")
        cache = self.model.init_cache(self.cfg, self.B, self.max_len,
                                      device=self.device)
        logits, cache = self._prefill_fn(self.params, cache,
                                         self._tokens(prompts))
        self.t += 1
        tok = _next_token(logits, 0.0, self.gen)
        outs = [tok]
        for _ in range(max_new_tokens - 1):
            self.t += 1
            tok, cache = self._step_fn(self.params, cache, tok, self.gen)
            outs.append(tok)
        return torch.cat(outs, dim=1).cpu().numpy()
