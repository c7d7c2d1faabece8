"""int8 gradient compression with error feedback (counterpart of
``repro.train.grad_compress``).

Data-parallel gradient synchronization as an exact float32 reduce-scatter
plus an int8 all-gather, over a ``torch.distributed`` process group: each
rank takes the mean of its shard of the flat gradient
(``reduce_scatter_tensor``), quantizes it to int8 with one scale per
shard, and all-gathers the codes and the scales
(``all_gather_into_tensor``): 4x fewer all-gather bytes than float32. The
local quantization residual is kept in an error-feedback buffer (this
rank's region of the flat gradient) and added to the next step's
gradient (Karimireddy et al. 2019).

With no group the arithmetic is the reference's on a one-device mesh:
the mean of one shard, quantized, dequantized, with its residual as the
error feedback; not an identity. Divisions are by tensors, so they round
as IEEE division on the CPU and on CUDA alike (CUDA multiplies by the
reciprocal where the divisor is a Python scalar).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree_leaves, tree_map


def _div(x: torch.Tensor, d) -> torch.Tensor:
    return x / torch.as_tensor(d, dtype=x.dtype, device=x.device)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = _div(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_leaf(g: torch.Tensor, ef: torch.Tensor,
                         group: Optional[dist.ProcessGroup] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Synchronize one gradient leaf over ``group`` (every rank calls it
    with its own ``g`` and ``ef``) with int8 compression and error
    feedback. Returns (the synced mean gradient, the new error feedback).
    ``group=None`` runs the one-device arithmetic without collectives."""
    n = 1 if group is None else dist.get_world_size(group)
    idx = 0 if group is None else dist.get_rank(group)
    flat = g.reshape(-1).to(torch.float32) + ef.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard_len = flat.shape[0] // n
    # exact reduce-scatter: each rank ends up with the mean of its shard
    if group is None:
        my_shard = flat
    else:
        my_shard = flat.new_empty(shard_len)
        dist.reduce_scatter_tensor(my_shard, flat, op=dist.ReduceOp.SUM,
                                   group=group)
    my_shard = _div(my_shard, n)
    # compress this shard, all-gather the codes and the scales
    q, scale = quantize_int8(my_shard)
    if group is None:
        q_all, s_all = q, scale.reshape(1)
    else:
        q_all = q.new_empty(n * shard_len)
        s_all = scale.new_empty(n)
        dist.all_gather_into_tensor(q_all, q, group=group)
        dist.all_gather_into_tensor(s_all, scale.reshape(1), group=group)
    synced = (q_all.reshape(n, shard_len).to(torch.float32)
              * s_all[:, None]).reshape(-1)
    # error feedback: what this shard lost in quantization, in this rank's
    # region of the flat gradient
    ef_flat = torch.zeros_like(flat)
    ef_flat[idx * shard_len:(idx + 1) * shard_len] = (
        my_shard - dequantize_int8(q, scale))
    if pad:
        synced = synced[:-pad]
        ef_flat = ef_flat[:-pad]
    return synced.reshape(g.shape).to(g.dtype), ef_flat.reshape(g.shape)


def compressed_psum_tree(grads, ef_state,
                         group: Optional[dist.ProcessGroup] = None):
    """``compressed_psum_leaf`` over a gradient tree: (synced tree, new
    error-feedback tree)."""
    out = tree_map(lambda g, e: compressed_psum_leaf(g, e, group), grads,
                   ef_state)
    return (tree_map(lambda _, o: o[0], grads, out),
            tree_map(lambda _, o: o[1], grads, out))


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compression_ratio(params) -> float:
    """Collective bytes against a float32 all-reduce: the reduce-scatter
    stays float32 (exact), the all-gather moves int8 and one float32
    scale per shard."""
    total = sum(p.numel() for p in tree_leaves(params))
    f32_bytes = 2 * 4 * total            # RS + AG at f32
    comp_bytes = 4 * total + 1 * total   # RS f32 + AG int8 (scales ~0)
    return comp_bytes / f32_bytes
