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


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict/list tree (tuples come back
    as lists); ``rest`` are trees with at least ``tree``'s structure, whose
    matching nodes (a leaf of ``tree`` may face a subtree) are passed
    along."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of a nested dict/list tree, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def to_device(tree, device: torch.device):
    """Move every tensor leaf of a nested dict/list tree to ``device`` (a
    no-op for tensors already there); other leaves pass through, and so
    do column-sharded leaves, which stay on the rank they were placed on
    (``core.colshard``). Numpy trees from the JAX package go through
    ``repro_torch.interop``."""
    from repro_torch.core.colshard import is_col_sharded
    return tree_map(lambda v: v.to(device) if (
        isinstance(v, torch.Tensor) and not is_col_sharded(v)) else v, tree)


__all__ = ["resolve_device", "to_device", "tree_leaves", "tree_map"]
