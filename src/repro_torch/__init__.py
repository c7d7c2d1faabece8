"""PyTorch/CUDA port of the column-wise CIM quantization library.

Mirrors ``src/repro`` module by module (``core``, ``kernels``, ``api``,
``models``, ``data``) and imports neither ``jax`` nor ``repro``: parameters
are plain dictionaries of tensors laid out like the JAX trees, so
``repro_torch.interop`` carries them across as numpy.

Every public entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without ``device="cpu"`` it raises
(``resolve_device``). On a CUDA tensor the deploy path launches the
hand-written Hopper kernel in ``csrc/``; on a CPU tensor it runs the
kernel's plain PyTorch version in ``kernels/ref.py``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default. Raises when
    CUDA is asked for (explicitly or by default) and no card is present —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def to_device(tree, device: torch.device):
    """Move every tensor leaf of a nested dict/list tree to ``device`` (a
    no-op for tensors already there); other leaves pass through. Numpy
    trees from the JAX package go through ``repro_torch.interop``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


__all__ = ["resolve_device", "to_device"]
