"""The port's int8 gradient compression (``repro_torch.train.grad_compress``)
against the JAX package's, on the CPU.

One rank: ``compressed_psum_tree`` with no group (the one-device
arithmetic) against the reference's inside a 1-device ``shard_map``
(``tests/test_fault_tolerance.py``'s case), bit for bit; the error
feedback holds exactly the residual (synced + error feedback == the
gradient plus the old feedback, bit for bit), and a second step with
that feedback agrees too. ``quantize_int8`` / ``dequantize_int8`` equal
the reference's.

2 and 4 ranks: gloo processes (``torch.multiprocessing``, a free port on
localhost, a 120 s limit) each synchronize their own gradients over the
process group (``reduce_scatter_tensor`` + ``all_gather_into_tensor``),
against a numpy model of the reference's algorithm (the mean of each
rank's shard, int8 codes and a scale per shard, every rank's error
feedback in its own region). The gradients lie on a grid of 2^-8 in
[-4, 4), so their sums are exact in any order and the mean over 2 or 4
ranks is exact: the comparison is bit for bit whatever order gloo sums
in (a second step would add the feedback, which is off the grid; the
one-rank test covers it). A leaf of 17 values pads its last shard.
"""
import functools
import socket
import time
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.train import grad_compress as jgc
from repro_torch.train import grad_compress as tgc

SHAPES = {"w": (64, 8), "b": (17,)}


def _grads(seed, grid=False):
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in SHAPES.items():
        x = rng.standard_normal(shape).astype(np.float32)
        if grid:
            x = np.clip(np.round(x * 256) / 256, -4, 4 - 2 ** -8)
        out[k] = x.astype(np.float32)
    return out


def _reference(g, ef):
    from jax.sharding import PartitionSpec as P
    from repro.nn.module import shard_map
    mesh = jax.make_mesh((1,), ("data",))
    fn = shard_map(functools.partial(jgc.compressed_psum_tree,
                                     axis_name="data"),
                   mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                   check_vma=False)
    synced, ef2 = fn(g, ef)
    return (jax.tree.map(np.asarray, synced), jax.tree.map(np.asarray, ef2))


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_one_rank_matches_reference_and_keeps_the_residual():
    g = _grads(0)
    ef = jax.tree.map(np.asarray, jgc.init_error_feedback(g))
    tg, tef = _torch(g), tgc.init_error_feedback(_torch(g))
    for _ in range(2):                    # the second step reads the feedback
        want_s, want_ef = _reference(g, ef)
        got_s, got_ef = tgc.compressed_psum_tree(tg, tef)
        for k in SHAPES:
            np.testing.assert_array_equal(got_s[k].numpy(), want_s[k])
            np.testing.assert_array_equal(got_ef[k].numpy(), want_ef[k])
            # synced + feedback is exactly the gradient plus old feedback
            np.testing.assert_array_equal(
                (got_s[k] + got_ef[k]).numpy(), (tg[k] + tef[k]).numpy())
            step = float(np.abs(g[k] + ef[k]).max()) / 127.0
            assert float((got_s[k] - tg[k]).abs().max()) <= step + 1e-6
        ef, tef = want_ef, got_ef


def test_quantize_matches_reference():
    x = _grads(3)["w"]
    q, s = tgc.quantize_int8(torch.from_numpy(x))
    jq, js = jgc.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8 and float(s) == float(js)
    np.testing.assert_array_equal(tgc.dequantize_int8(q, s).numpy(),
                                  np.asarray(jgc.dequantize_int8(jq, js)))
    params = {k: jnp.zeros(v) for k, v in SHAPES.items()}
    assert tgc.compression_ratio(_torch(jax.tree.map(np.asarray, params))) \
        == jgc.compression_ratio(params) == 0.625


def _model(grads, efs):
    """The reference's algorithm in numpy over ``n`` ranks' gradients:
    per rank (synced, error feedback)."""
    n = len(grads)
    out = [({}, {}) for _ in range(n)]
    for k in grads[0]:
        flats = [g[k].reshape(-1) + e[k].reshape(-1)
                 for g, e in zip(grads, efs)]
        pad = (-flats[0].size) % n
        flats = [np.pad(f, (0, pad)) for f in flats]
        length = flats[0].size // n
        total = np.sum(np.stack(flats), axis=0, dtype=np.float32)
        shards = total.reshape(n, length) / np.float32(n)
        codes, scales = [], []
        for sh in shards:
            scale = (np.abs(sh).max() + np.float32(1e-12)) / np.float32(127)
            codes.append(np.clip(np.round(sh / scale), -127, 127
                                 ).astype(np.int8))
            scales.append(np.float32(scale))
        synced = np.concatenate([c.astype(np.float32) * s
                                 for c, s in zip(codes, scales)])
        shape = grads[0][k].shape
        for r in range(n):
            ef = np.zeros(n * length, np.float32)
            ef[r * length:(r + 1) * length] = (
                shards[r] - codes[r].astype(np.float32) * scales[r])
            out[r][0][k] = synced[:synced.size - pad].reshape(shape)
            out[r][1][k] = ef[:ef.size - pad].reshape(shape)
    return out


def _rank(rank, world, port, out_dir, steps):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        g = _torch(_grads(10 + rank, grid=True))
        ef = tgc.init_error_feedback(g)
        hist = []
        for _ in range(steps):
            synced, ef = tgc.compressed_psum_tree(g, ef, dist.group.WORLD)
            hist.append((synced, ef))
        torch.save(hist, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_match_a_numpy_model_of_the_reference(world, tmp_path):
    steps = 1
    ctx = mp.start_processes(_rank, args=(world, _free_port(), str(tmp_path),
                                          steps),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo ranks did not end within 120 s")
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    grads = [_grads(10 + r, grid=True) for r in range(world)]
    efs = [{k: np.zeros(v, np.float32) for k, v in SHAPES.items()}
           for _ in range(world)]
    for step in range(steps):
        want = _model(grads, efs)
        for r in range(world):
            synced, ef = got[r][step]
            for k in SHAPES:
                np.testing.assert_array_equal(synced[k].numpy(),
                                              want[r][0][k])
                np.testing.assert_array_equal(ef[k].numpy(), want[r][1][k])
        efs = [w[1] for w in want]
