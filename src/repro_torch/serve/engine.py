"""Batched serving engine of the port (counterpart of
``repro.serve.engine``): slot-based continuous batching over the model
zoo's cache API.

``generate_batch`` is lockstep batched generation: one prefill of the
whole prompt batch through the cached forward, then one decode step per
new token. An encoder-decoder (whisper) decodes against the encoder
states the caller put in ``engine.cache["enc_out"]`` (``whisper.encode``
of its log-mel frames), the slot engine's contract: ``generate_batch``
carries them into its fresh cache and raises where the caller put none
(the reference's re-inits them to zeros, ROADMAP fault 13). The slot
engine (``submit``/``step``) admits a queued request
into a free slot by prefilling its prompt one token at a time through
the batched decode step, as the reference does: every slot's cache
advances with it. Decoding is greedy (``argmax``, ties to the lower
token id) or, with ``temperature > 0``, sampled from a
``torch.Generator`` seeded by ``seed``.

Self-healing serving (DESIGN.md §11): the engine optionally models a
drifting chip (``drift_key``, a drift source such as
``core.variation.Sampler``, with ``drift_schedule``): every model
invocation serves one drift realization of the packed planes at the
request count ``t``, which ticks once per invocation (a prefill, each
admitted prompt token, each decode step). With ``health`` (a
``serve.health.DriftMonitor``) it watches its logit statistics every
decode step, degrades to ``fallback_backend`` (the digital ``ref``
backend on the pristine planes, a backend visible in ``health()``) on
hard drift, and re-fits the column scales in place with
``recalibrate()``.

Telemetry (DESIGN.md §12): every engine owns an ``obs``
``MetricsRegistry`` (pass ``metrics=`` to share one). Queue wait,
prefill and decode-step spans land in its histograms and event log;
token and request counters and the queue-depth and active-slot gauges
follow the slots. A span synchronises with the card before it closes
(the tokens are read back inside it), so it times the device work.
``metrics()`` folds it all with ``health()``, the throughput and, when
the ``obs.adc`` collector is armed, the ADC saturation summary; armed,
the monitor also ingests an ``adc_clip_rate`` statistic per step.

Column-parallel serving (DESIGN.md §10): ``engine_from_artifact(...,
mesh=)`` places the artifact column-sharded on this rank of ``mesh`` (a
``DeviceMesh`` over one process per rank) and installs it as the session
mesh, so every CIM linear runs the kernels on the rank's columns and
all-gathers the outputs. Every rank runs the same engine on the same
prompts and gets the same logits, so greedy decoding (or sampling from
the same seeded generator) gives every rank the same tokens, equal to the
single-device engine's. The engine pins the session mesh at build time
and raises if a later ``step``/``generate_batch`` runs under another.
With ``cfg.flash_decode`` the engine's caches, made under that mesh, are
time-sharded over its ``"model"`` ranks (``models.layers.kv_cache``) and
each one-token step runs the sequence-parallel flash decode; the prompt's
prefill writes each row on its owning rank. Under a mesh the engine runs
eagerly: it captures no CUDA graph.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import colshard
from repro_torch.core.variation import DriftSchedule, DriftState, drift_tree
from repro_torch.models.registry import ModelFns
from repro_torch.obs import adc as obs_adc
from repro_torch.obs import names as M
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracing import Tracer

from .health import logit_stats_device

def engine_from_artifact(artifact, cfg: ModelConfig, *, mesh=None,
                         mesh_axis: str = "model", device=None, rules=None,
                         **engine_kw) -> "ServingEngine":
    """A ``ServingEngine`` serving a model ``DeployArtifact`` on its packed
    backend, on ``device`` (``cuda`` unless ``"cpu"``). ``artifact`` is an
    artifact (``repro_torch.api.model_artifact``) or the path of one saved
    by either package, loaded with ``DeployArtifact.load``. ``cfg``'s
    ``cim`` is replaced by the artifact's pinned config, so the engine runs
    exactly the quantization state that was packed, and the artifact's
    ``layout_version`` pins the engine's recalibration deltas. The drift,
    health and telemetry keywords pass through to ``ServingEngine``.

    ``mesh`` (a ``DeviceMesh`` this rank belongs to) turns on
    column-parallel serving: the artifact is loaded (or placed) with its
    CIM nodes column-sharded over ``mesh_axis``, and ``mesh`` becomes the
    session mesh for the process's lifetime (``mesh=None`` does not clear
    an installed one; scope an engine in ``nn.module.session_mesh`` to mix
    sharded and unsharded engines in one process). With ``rules`` as well
    (``launch.mesh.sharding_rules``) the whole tree is placed by
    ``nn.module.shard_params``: the packed nodes by their columns as
    above, and the raw leaves as the rules put them (a vocab-parallel
    embedding and LM head over ``"model"``)."""
    from repro_torch.api import DeployArtifact
    from repro_torch.models.registry import get_model
    if rules is not None and mesh is None:
        raise ValueError("engine_from_artifact: rules place the tree on a "
                         "mesh; pass mesh= too")
    placed_by_rules = rules is not None
    if isinstance(artifact, (str, os.PathLike)):
        artifact = DeployArtifact.load(
            os.fspath(artifact), mesh=None if placed_by_rules else mesh,
            mesh_axis=mesh_axis,
            device="cpu" if placed_by_rules else device)
    elif (isinstance(artifact, DeployArtifact) and mesh is not None
          and not placed_by_rules):
        artifact = artifact.shard(mesh, mesh_axis=mesh_axis, device=device)
    if not isinstance(artifact, DeployArtifact):
        raise TypeError(f"engine_from_artifact takes a DeployArtifact or its "
                        f"path, got {type(artifact).__name__}")
    if artifact.kind != "model":
        raise ValueError(f"engine_from_artifact needs a 'model' artifact, "
                         f"got kind={artifact.kind!r}")
    serve_cfg = dataclasses.replace(cfg, cim=artifact.config)
    if placed_by_rules:
        from repro_torch.nn.module import shard_params
        if mesh_axis != "model":
            raise ValueError("rules place the packed columns over 'model'")
        colshard.check_mesh(mesh, mesh_axis)
        artifact = dataclasses.replace(artifact, params=shard_params(
            artifact.params, get_model(serve_cfg).specs(serve_cfg), mesh,
            rules, device=resolve_device(device)))
    if mesh is not None:
        from repro_torch.nn.module import current_rules, set_activation_rules
        set_activation_rules(current_rules(), mesh)
    return ServingEngine(get_model(serve_cfg), serve_cfg, artifact.params,
                         device=device,
                         layout_version=artifact.layout_version, **engine_kw)


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


def _drifting(drift_key, schedule: Optional[DriftSchedule]) -> bool:
    return (drift_key is not None and schedule is not None
            and not schedule.is_static_zero)


def _make_engine_step(model: ModelFns, cfg: ModelConfig, temperature: float,
                      drift_key, schedule: Optional[DriftSchedule],
                      with_stats: bool):
    """Drift-aware decode step (params, cache, tokens, generator, t) ->
    (next tokens, cache, stats): one chip realization at request count
    ``t`` and, with the health hook armed, the logit statistics the
    monitor ingests (0-d tensors, read on the host by the caller)."""
    drifting = _drifting(drift_key, schedule)

    def step(params, cache, tokens, gen, t):
        p = (drift_tree(params, drift_key, DriftState(schedule, t))
             if drifting else params)
        logits, cache = model.decode_step(p, cache, tokens, cfg)
        stats = logit_stats_device(logits[:, -1, :]) if with_stats else {}
        return _next_token(logits, temperature, gen), cache, stats
    return step


def _make_engine_prefill(model: ModelFns, cfg: ModelConfig, drift_key,
                         schedule: Optional[DriftSchedule]):
    drifting = _drifting(drift_key, schedule)

    def prefill(params, cache, tokens, t):
        p = (drift_tree(params, drift_key, DriftState(schedule, t))
             if drifting else params)
        return model.decode_step(p, cache, tokens, cfg)
    return prefill


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                   # (T,) int32
    max_new_tokens: int
    eos_id: int = -1                     # -1: run to max_new_tokens
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0                # wall clock at submit()
    t_admit: float = 0.0                 # wall clock at slot admission


class ServingEngine:
    """Fixed-B slot engine. Prompts are prefilled one slot at a time through
    the batched decode step; decode steps advance all live slots
    together. ``params`` are moved to ``device`` (``cuda`` unless
    ``"cpu"``).

    With ``drift_key``/``drift_schedule`` the engine serves a drifting
    chip. With ``health`` it observes its logit statistics every decode
    step; past the monitor's hard threshold it serves ``fallback_backend``
    on the pristine planes (digit storage does not drift, only the analog
    evaluation does) until ``recalibrate()`` lands a fresh ``ScaleDelta``.
    ``auto_recalibrate=True`` recalibrates instead of falling back."""

    def __init__(self, model: ModelFns, cfg: ModelConfig, params,
                 batch_size: int = 8, max_len: int = 1024,
                 temperature: float = 0.0, seed: int = 0, *,
                 drift_key=None,
                 drift_schedule: Optional[DriftSchedule] = None,
                 health=None,
                 fallback_backend: str = "ref",
                 auto_recalibrate: bool = False,
                 layout_version: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 report_every: int = 0,
                 device=None):
        from repro_torch.nn.module import current_mesh
        self.device = resolve_device(device)
        self.mesh = current_mesh()           # pinned: see _check_mesh
        self.model, self.cfg = model, cfg
        self.params = to_device(params, self.device)
        self.B, self.max_len = batch_size, max_len
        self.temperature = temperature
        self.cache = model.init_cache(cfg, batch_size, max_len,
                                      device=self.device)
        # the blank encoder states of an encoder-decoder's cache, and their
        # version: generate_batch serves only states the caller put there
        blank = self.cache.get("enc_out")
        self._blank_enc = (blank, None if blank is None else blank._version)
        self.drift_key = drift_key
        self.drift_schedule = drift_schedule
        self.monitor = health
        self.fallback_backend = fallback_backend
        self.auto_recalibrate = auto_recalibrate
        self.layout_version = layout_version
        self.fallback_active = False
        self.t = 0                           # request-count drift clock
        self._pristine = self.params         # pre-recalibration reference
        self._fallback_step = None           # built on the first fallback
        self._step_fn = _make_engine_step(model, cfg, temperature, drift_key,
                                          drift_schedule, health is not None)
        self._prefill_fn = _make_engine_prefill(model, cfg, drift_key,
                                                drift_schedule)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.queue: List[Request] = []
        self.last_tok = np.zeros((batch_size, 1), np.int32)
        self._next_rid = 0
        self.retired = 0                     # requests completed, ever
        self.registry = metrics if metrics is not None else MetricsRegistry()
        self.tracer = Tracer(self.registry)
        self.report_every = report_every     # stderr line every N steps
        self._decode_steps = 0
        self._last_sat = 0                   # adc totals at last observation,
        self._last_conv = 0                  # for the per-step clip rate

    def submit(self, prompt, max_new_tokens: int, eos_id: int = -1) -> int:
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, np.asarray(prompt, np.int32), max_new_tokens,
                      eos_id, t_submit=time.time())
        self.queue.append(req)
        self.registry.counter(M.REQUESTS_SUBMITTED).inc()
        self.registry.gauge(M.QUEUE_DEPTH).set(len(self.queue))
        self.registry.log_event("request_submitted", rid=rid,
                                prompt_len=int(req.prompt.shape[0]),
                                max_new_tokens=max_new_tokens)
        return rid

    def _tokens(self, tok: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(tok, dtype=np.int32)).to(self.device)

    # -- self-healing internals ----------------------------------------------

    def _check_mesh(self, where: str) -> None:
        """Raise when generation runs under another session mesh than the
        engine was built under: its params were placed for that mesh."""
        from repro_torch.nn.module import current_mesh
        cur = current_mesh()
        if cur is self.mesh or cur == self.mesh:
            return
        raise RuntimeError(
            f"ServingEngine.{where}: the session mesh changed since this "
            f"engine was built (built under {self.mesh!r}, now {cur!r}). "
            "Rebuild the engine under the new mesh, or scope build and "
            "generation together in repro_torch.nn.module.session_mesh.")

    def _devices(self) -> int:
        from repro_torch.kernels.ops import col_shards
        return col_shards(self.mesh)

    def _invoke_step(self, tok: np.ndarray) -> np.ndarray:
        """One model invocation over the whole batch: the drift clock
        ticks, then the fallback or the (drifted) step runs, and the
        health monitor observes it."""
        t = self.t
        self.t += 1
        if self.fallback_active:
            nxt, self.cache = self._fallback()(self.params_clean(),
                                               self.cache, self._tokens(tok),
                                               self.gen)
            return nxt.cpu().numpy()
        nxt, self.cache, stats = self._step_fn(self.params, self.cache,
                                               self._tokens(tok), self.gen, t)
        nxt = nxt.cpu().numpy()
        self._observe_health(stats)
        return nxt

    def _observe_health(self, stats) -> None:
        """Feed one step's statistics to the drift monitor and react.
        When the ADC collector is armed, the saturation totals folded
        since the previous observation become an ``adc_clip_rate``
        statistic."""
        if self.monitor is None or not stats:
            return
        host = {k: float(v) for k, v in stats.items()}
        if obs_adc.enabled():
            sat, conv = obs_adc.totals()
            d_sat, d_conv = sat - self._last_sat, conv - self._last_conv
            self._last_sat, self._last_conv = sat, conv
            if d_conv > 0:
                host["adc_clip_rate"] = d_sat / d_conv
        self.monitor.observe(host)
        if self.monitor.hard_drifted and not self.fallback_active:
            self.monitor.hard_events += 1
            if self.auto_recalibrate:
                self.recalibrate()
            elif self.fallback_backend:
                self.fallback_active = True

    def params_clean(self):
        """The pristine packed tree (digit storage does not drift)."""
        return self._pristine

    def _fallback(self):
        if self._fallback_step is None:
            fcfg = dataclasses.replace(
                self.cfg, cim=self.cfg.cim.replace(mode=self.fallback_backend))
            self._fallback_step = make_decode_step(self.model, fcfg,
                                                   self.temperature)
        return self._fallback_step

    def recalibrate(self, *, probes: int = 64,
                    gen: Optional[torch.Generator] = None, codes=None):
        """Re-fit the column scales against the drift at the current
        request count and swap the corrected params in: fit a
        ``ScaleDelta`` from the pristine planes to the drift realization
        at ``t`` (``eval/recalibrate.py``; Rademacher probes from ``gen``,
        else the engine's generator, or the per-node ``codes``), apply it
        to the pristine tree (deltas are absolute), leave the fallback and
        re-arm the monitor. Returns the delta (``delta.save`` keeps it)."""
        from repro_torch.eval.recalibrate import (apply_scale_delta_params,
                                                  fit_scale_delta)
        meta = {"t": int(self.t), "probes": probes}
        if _drifting(self.drift_key, self.drift_schedule):
            observed = drift_tree(self._pristine, self.drift_key,
                                  DriftState(self.drift_schedule, self.t))
        else:
            observed = self._pristine   # no drift model: identity delta
        delta = fit_scale_delta(self._pristine, observed,
                                gen=self.gen if gen is None else gen,
                                probes=probes, codes=codes, meta=meta)
        if self.layout_version is not None:
            delta = dataclasses.replace(delta,
                                        layout_version=self.layout_version)
        self.params = apply_scale_delta_params(self._pristine, delta)
        self.fallback_active = False
        if self.monitor is not None:
            self.monitor.note_recalibration()
        self.registry.counter(M.RECALIBRATIONS).inc()
        self.registry.log_event("recalibration", t=int(self.t), probes=probes)
        return delta

    def health(self) -> Dict:
        """The self-healing state: the monitor's snapshot (when one is
        armed), the engine's drift and fallback status, and the admission
        state."""
        snap = self.monitor.snapshot() if self.monitor is not None else {}
        snap.update({
            "t": self.t,
            "fallback_active": self.fallback_active,
            "drifting": _drifting(self.drift_key, self.drift_schedule),
            "mesh": None if self.mesh is None else repr(self.mesh),
            "queue_depth": len(self.queue),
            "active_slots": sum(s is not None for s in self.slots),
            "slots": self.B,
            "submitted": self._next_rid,
            "retired": self.retired,
        })
        return snap

    def _throughput(self):
        toks = self.registry.counter(M.TOKENS_GENERATED).value
        dec = self.registry.histogram(M.DECODE_STEP_SECONDS)
        return toks, dec, (toks / dec.sum if dec.sum > 0 else 0.0)

    def metrics(self) -> Dict:
        """One JSON-safe telemetry view (DESIGN.md §12): ``health()``, the
        throughput, the ADC saturation summary (when the collector is
        armed) and the registry's snapshot."""
        toks, dec, tps = self._throughput()
        return {
            "health": self.health(),
            "throughput": {
                "tokens_generated": toks,
                "decode_steps": dec.count,
                "decode_seconds": dec.sum,
                "tokens_per_sec": tps,
                "devices": self._devices(),
                "tokens_per_sec_per_device": tps / self._devices(),
            },
            "saturation": obs_adc.summary() if obs_adc.enabled() else None,
            "metrics": self.registry.snapshot(),
        }

    def _maybe_report(self) -> None:
        """A one-line operator report on stderr every ``report_every``
        decode steps (0: off)."""
        if not self.report_every or self._decode_steps % self.report_every:
            return
        toks, _, tps = self._throughput()
        line = (f"[serve.metrics] t={self.t} tokens={toks} tok/s={tps:.1f} "
                f"queue={len(self.queue)} "
                f"active={sum(s is not None for s in self.slots)}/{self.B} "
                f"retired={self.retired}")
        if self.monitor is not None:
            line += (f" score={self.monitor.score:.2f}"
                     f" fallback={self.fallback_active}")
        if obs_adc.enabled():
            line += f" clip_rate={obs_adc.summary()['clip_rate']:.4f}"
        print(line, file=sys.stderr)

    # -- the slot engine -----------------------------------------------------

    def _admit(self) -> None:
        """Fill empty slots: prefill the prompt token by token, batched with
        the other slots' last tokens, as the reference does (every slot's
        cache advances with it)."""
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                req.t_admit = time.time()
                self.registry.histogram(M.QUEUE_WAIT_SECONDS).observe(
                    req.t_admit - req.t_submit)
                with self.tracer.span("serve.prefill", rid=req.rid,
                                      tokens=int(req.prompt.shape[0])):
                    for t in req.prompt:
                        tok = np.array(self.last_tok)
                        tok[i, 0] = t
                        nxt = self._invoke_step(tok)
                        self.last_tok[i, 0] = nxt[i, 0]
                self.registry.gauge(M.QUEUE_DEPTH).set(len(self.queue))
                self.registry.gauge(M.ACTIVE_SLOTS).set(
                    sum(s is not None for s in self.slots))

    def step(self) -> List[Dict]:
        """One decode step for all active slots; returns finished requests."""
        self._check_mesh("step")
        self._admit()
        if all(s is None for s in self.slots):
            return []
        with self.tracer.span("serve.decode.step"):
            nxt = self._invoke_step(self.last_tok)
        self._decode_steps += 1
        active = sum(s is not None for s in self.slots)
        self.registry.counter(M.TOKENS_GENERATED).inc(active)
        finished = []
        now = time.time()
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
                self.registry.counter(M.REQUESTS_COMPLETED).inc()
                self.registry.histogram(M.REQUEST_LATENCY_SECONDS).observe(
                    now - req.t_submit)
                self.registry.log_event(
                    "request_completed", rid=req.rid,
                    tokens=len(req.output), latency=now - req.t_submit,
                    queue_wait=req.t_admit - req.t_submit)
        if finished:
            self.registry.gauge(M.ACTIVE_SLOTS).set(
                sum(s is not None for s in self.slots))
        self._maybe_report()
        return finished

    # -- the lockstep batched API ----------------------------------------------

    def _encoder_states(self) -> torch.Tensor:
        """The encoder states the caller put in ``cache["enc_out"]`` (B,
        frames, d_model); raises where it holds the blank ones
        ``init_cache`` made (neither replaced nor written in place)."""
        enc = self.cache["enc_out"]
        blank, version = self._blank_enc
        if enc is blank and enc._version == version:
            raise ValueError(
                f"generate_batch: {self.cfg.family} decodes against encoder "
                "states, and engine.cache['enc_out'] holds none; put "
                "whisper.encode(params, frames, cfg) of the requests' "
                "log-mel frames there first")
        if enc.shape[0] != self.B:
            raise ValueError(f"generate_batch: engine.cache['enc_out'] holds "
                             f"states of {enc.shape[0]} requests, the "
                             f"engine serves {self.B}")
        return enc

    def generate_batch(self, prompts: np.ndarray,
                       max_new_tokens: int) -> np.ndarray:
        """Lockstep batched generation: prompts (B, Tp) -> (B, Tnew). The
        first new token is the prefill's argmax; the rest follow the
        engine's decoding rule. The prefill runs on the (drifted) packed
        planes; decode steps take the fallback while it is active. An
        encoder-decoder decodes against the states in
        ``engine.cache["enc_out"]``, which the caller puts there."""
        self._check_mesh("generate_batch")
        if prompts.shape[0] != self.B:
            raise ValueError(f"generate_batch takes {self.B} prompts, got "
                             f"{prompts.shape[0]}")
        enc = self._encoder_states() if "enc_out" in self.cache else None
        cache = self.model.init_cache(self.cfg, self.B, self.max_len,
                                      device=self.device)
        if enc is not None:
            cache["enc_out"] = enc
        with self.tracer.span("serve.prefill", tokens=int(prompts.shape[1]),
                              batch=self.B):
            logits, cache = self._prefill_fn(self.params, cache,
                                             self._tokens(prompts), self.t)
            self.t += 1
            tok = _next_token(logits, 0.0, self.gen)
            outs = [tok.cpu()]
        self.registry.counter(M.TOKENS_GENERATED).inc(self.B)
        for _ in range(max_new_tokens - 1):
            t = self.t
            self.t += 1
            with self.tracer.span("serve.decode.step"):
                if self.fallback_active:
                    tok, cache = self._fallback()(self.params_clean(), cache,
                                                  tok, self.gen)
                    stats = {}
                else:
                    tok, cache, stats = self._step_fn(self.params, cache, tok,
                                                      self.gen, t)
                outs.append(tok.cpu())
            self._decode_steps += 1
            self.registry.counter(M.TOKENS_GENERATED).inc(self.B)
            self._observe_health(stats)
            self._maybe_report()
        return torch.cat(outs, dim=1).numpy()
