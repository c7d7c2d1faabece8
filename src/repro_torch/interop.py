"""Carry parameter trees between the JAX package and the port as numpy.

The JAX package's params, BatchNorm state and packed trees become numpy
with ``jax.tree.map(np.asarray, tree)`` on its side; ``from_numpy_tree``
turns such a tree into the port's (torch tensors on a device), and
``to_numpy_tree`` reverses it. Each leaf goes through the checkpoint
loader's decoder (``checkpoint.ckpt.decode_leaf``) on its raw bytes and
dtype name, so there is one int4 rule: dense int4 leaves
(``ml_dtypes.int4``, which ``torch.from_numpy`` refuses) become int8
holding [-8, 7], the port's dense int4 storage, and bfloat16 leaves keep
their bits. Nibble-packed uint8 planes pass through byte for byte.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import decode_leaf


def _leaf_to_torch(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    return decode_leaf(a, a.dtype.name, a.shape).to(device)


def from_numpy_tree(tree, device=None):
    """Nested dicts/lists of numpy arrays (or scalars) -> the same nesting
    of tensors on ``device`` (``cuda`` unless ``"cpu"``). Tuples become
    lists, as the reference's ``pack_model`` normalizes them."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _leaf_to_torch(node, dev)
    return walk(tree)


def to_numpy_tree(tree):
    """Inverse of ``from_numpy_tree``: tensors -> numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree
