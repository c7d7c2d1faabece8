"""Deterministic synthetic image data (counterpart of the image part of
``repro.data.pipeline``; numpy only, so it gives the reference's arrays
for the same seed).

No CIFAR is available offline: each class is a fixed random
low-frequency template, and a sample is its template, randomly shifted,
plus small noise. The CIFAR-shaped requests of ``chip_smoke.py``, the
QAT harness's batches (``synth_classification_batch``, deterministic in
(seed, step)) and the parity tests come from here.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


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
