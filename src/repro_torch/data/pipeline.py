"""Deterministic synthetic data (counterpart of ``repro.data.pipeline``):
the LM token stream and the image set.

LM stream: per batch, a random sparse transition table (64 states, 4
candidate tokens each, drawn from the first ``min(64, vocab)`` tokens)
drives a Markov chain per row, so the cross-entropy falls well below
uniform as a model learns (unigram structure alone takes it from
ln(vocab) toward ln(64)). The reference draws it with ``jax.random``;
the port draws the same process with a ``torch.Generator`` seeded from
(seed, step), so a batch depends on (seed, step) alone and a stream can
start at any step, but the tokens are not the reference's (randomness
does not cross frameworks: parity tests feed the JAX stream's batches
to both packages).

Image set: no CIFAR is available offline. Each class is a fixed random
low-frequency template, and a sample is its template, randomly shifted,
plus small noise; numpy only, so it gives the reference's arrays for the
same seed. The CIFAR-shaped requests of ``chip_smoke.py``, the QAT
harness's batches (``synth_classification_batch``, deterministic in
(seed, step)) and the parity tests come from here.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

#: states of the LM stream's transition table, and candidates per state
ORDER_STATES = 64
CANDIDATES = 4


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------

def markov_draws(seed: int, step: int, batch: int, seq_len: int,
                 vocab: int) -> Dict[str, torch.Tensor]:
    """The random draws of the stream's batch ``step``: the transition
    ``table`` (64, 4) of tokens below ``min(64, vocab)``, each row's
    ``start`` state (batch,) and each position's ``choice`` (seq_len,
    batch) of a candidate, int64 on the CPU."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    g = torch.Generator().manual_seed(int(mixed[0]))
    return {"table": torch.randint(0, min(64, vocab),
                                   (ORDER_STATES, CANDIDATES), generator=g),
            "start": torch.randint(0, ORDER_STATES, (batch,), generator=g),
            "choice": torch.randint(0, CANDIDATES, (seq_len, batch),
                                    generator=g)}


def markov_walk(table: torch.Tensor, state: torch.Tensor,
                choice: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the chain from ``state`` (batch,) through ``choice`` (T, batch):
    each token is ``table[state % 64, choice]`` and the state moves to
    ``(state * 31 + token) % 64``. Returns (tokens (batch, T), the state
    after them)."""
    toks = []
    for c in choice:
        tok = table[state % ORDER_STATES, c]
        state = (state * 31 + tok) % ORDER_STATES
        toks.append(tok)
    return torch.stack(toks, dim=1), state


def make_lm_pipeline(*, vocab: int, seq_len: int, global_batch: int,
                     seed: int = 0, start_step: int = 0
                     ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {"tokens": (B, T+1) int32} from batch ``start_step`` on:
    model input is [:, :-1], labels [:, 1:]. Batch ``step`` depends on
    (seed, step) alone, so a resumed run starts the stream at its step."""
    step = start_step
    while True:
        d = markov_draws(seed, step, global_batch, seq_len + 1, vocab)
        toks, _ = markov_walk(d["table"], d["start"], d["choice"])
        yield {"tokens": toks.numpy().astype(np.int32)}
        step += 1


def lm_batch_specs(seq_len: int, global_batch: int):
    """{"tokens": (shape, dtype)} of the stream's batches."""
    return {"tokens": ((global_batch, seq_len + 1), torch.int32)}


# ---------------------------------------------------------------------------
# synthetic image classification (the paper's CIFAR stand-in)
# ---------------------------------------------------------------------------


def make_image_dataset(n_classes: int = 10, hw: int = 32, n: int = 2048,
                       seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x (N, H, W, 3) float32 in [-2, 2], y (N,) int32)."""
    rng = np.random.RandomState(seed)
    base = rng.randn(n_classes, 8, 8, 3).astype(np.float32)
    templates = np.stack([
        np.stack([np.kron(base[c, :, :, ch], np.ones((hw // 8, hw // 8)))
                  for ch in range(3)], axis=-1)
        for c in range(n_classes)])
    templates /= np.abs(templates).max(axis=(1, 2, 3), keepdims=True) + 1e-6
    y = rng.randint(0, n_classes, size=n).astype(np.int32)
    x = templates[y]
    sh = rng.randint(-4, 5, size=(n, 2))
    for i in range(n):
        x[i] = np.roll(x[i], sh[i], axis=(0, 1))
    x = x + 0.25 * rng.randn(*x.shape).astype(np.float32)
    return np.clip(x, -2, 2), y


def synth_classification_batch(x, y, batch: int, step: int, seed: int = 0):
    """The training batch of ``step``: ``batch`` indices drawn with
    replacement from a RandomState seeded by (seed, step), as the
    reference draws them."""
    rng = np.random.RandomState(seed * 100003 + step)
    idx = rng.randint(0, x.shape[0], size=batch)
    return x[idx], y[idx]
