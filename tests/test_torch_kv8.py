"""The int8 KV cache on the port against the JAX package, on the CPU:
``_kv_quantize`` bit for bit (ties at .5, all-zero rows, bfloat16 and
float32 rows), the int8 branch of ``gqa_attend`` at decode (codes and
per-(token, head) scales written at each row's length, the whole cache
dequantized to the compute dtype before the attention), its clamped
write at the cache's end, and the reduced llama3-8b with
``kv_cache_dtype="int8"`` served by both engines (``tests/_torch_zoo.py``).

The layer's params are the reference's own, carried across by
``interop``; outputs agree within 1e-5, and the caches' codes and scales
are, bit for bit, the reference's write of the port's new rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_zoo as zoo
from repro.models import layers as JL
from repro.models.registry import get_model as j_get_model
from repro_torch.interop import from_numpy_tree
from repro_torch.models import layers as TL
from repro_torch.models.registry import get_model

ARCH = "llama3-8b"
INT8 = {"kv_cache_dtype": "int8"}
B = zoo.B
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def reference():
    return zoo.make_reference(ARCH, **INT8)


def _rows(dtype):
    """(3, 5, 2, 16) K/V rows: random, a row whose scale is exactly 1 with
    every code a tie at .5 (half to even), and all-zero rows."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32) * 3
    x[1, 2, 0] = [127, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5, 4.5, -5.5,
                  6.5, 0, -127, 7.5, 8.5, -9.5]
    x[2, 0] = 0.0
    x[0, 4, 1] = 0.0
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_quantize_bit_equal_to_reference(dtype):
    """Codes and scales bit for bit the reference function's as its code
    reads (``max|x| / 127 + 1e-9``, each step rounded: JAX run eagerly).
    Compiled, XLA turns the division by the constant into a multiply by
    its float32 reciprocal fused with the add: the codes stay the same
    and the scales move by at most one ulp."""
    x = _rows(dtype)
    xj = jnp.asarray(x.to(torch.float32).numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    q, s = TL._kv_quantize(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == (3, 5, 2)
    assert int(q[1, 2, 0, 1]) == 2 and int(q[1, 2, 0, 2]) == -4  # even ties
    qj, sj = JL._kv_quantize(xj)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(sj).view(np.int32))
    qc, sc = jax.jit(JL._kv_quantize)(xj)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qc))
    ulps = np.abs(s.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(sc).view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert not q[2, 0].any() and bool((s[2, 0] == np.float32(1e-9)).all())


def _kv8_cache(rng, cfg, max_len):
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {"k": rng.integers(-127, 128, (B, max_len, kvh, hd)).astype(
                np.int8),
            "v": rng.integers(-127, 128, (B, max_len, kvh, hd)).astype(
                np.int8),
            "k_scale": (rng.random((B, max_len, kvh)) * 0.05).astype(
                np.float32),
            "v_scale": (rng.random((B, max_len, kvh)) * 0.05).astype(
                np.float32)}


def _layer(reference, jcfg, tcfg, x, cache0, idx, t):
    """JAX's and the port's int8 ``gqa_attend`` on the same inputs:
    ((y, cache) JAX, (y, cache) port)."""
    p_np = jax.tree.map(lambda a: a[0], reference["params"]["layers"]["attn"])
    pos = (idx[:, None] + np.arange(t)[None]).astype(np.int32)
    want = jax.jit(lambda p, x_, c: JL.gqa_attend(
        p, x_, jcfg, positions=jnp.asarray(pos), cache=c))(
        p_np, jnp.asarray(x), {**{k: jnp.asarray(v) for k, v in
                                  cache0.items()}, "len": jnp.asarray(idx)})
    got = TL.gqa_attend(
        from_numpy_tree(p_np, zoo.CPU), torch.from_numpy(x), tcfg,
        positions=torch.from_numpy(pos).long(),
        cache={**{k: torch.from_numpy(v.copy()) for k, v in cache0.items()},
               "len": torch.from_numpy(idx)})
    return want, got


@pytest.mark.parametrize("back,t", [(4, 1), (5, 3), (1, 2), (0, 1)])
def test_int8_gqa_decode_and_end_write_match_reference(reference, back, t):
    """Decode steps of 1 to 3 positions at ``len = max_len - back``, one row
    well inside the cache; at back < t the write runs past the cache and
    clamps its start as the reference's ``dynamic_update_slice``. The
    port's cache is, bit for bit, that write of the port's own new codes
    and scales (from a cache with room for them); outputs and scales
    agree with JAX's layer within 1e-5, and the codes within one step
    (the two frameworks' projections differ in the last bit, which may
    move a code across a rounding boundary)."""
    jcfg, tcfg = zoo.cfgs(ARCH)
    jcfg, tcfg = jcfg.replace(**INT8), tcfg.replace(**INT8)
    max_len = 8
    rng = np.random.default_rng(10 * back + t)
    x = rng.standard_normal((B, t, tcfg.d_model)).astype(np.float32)
    cache0 = _kv8_cache(rng, tcfg, max_len)
    idx = np.full((B,), max_len - back, np.int32)
    idx[0] = 2
    (y_j, c_j), (y_t, c_t) = _layer(reference, jcfg, tcfg, x, cache0, idx, t)
    big = {k: np.concatenate([v, np.zeros_like(v[:, :t])], 1)
           for k, v in cache0.items()}
    _, (_, c_big) = _layer(reference, jcfg, tcfg, x, big, idx, t)
    rows = np.arange(B)[:, None]
    cols = idx[:, None] + np.arange(t)[None]
    for name, c0 in cache0.items():
        new = c_big[name].numpy()[rows, cols]
        dus = jax.vmap(lambda c, n, i: jax.lax.dynamic_update_slice(
            c, n, (i,) + (0,) * (c.ndim - 1)))(
            jnp.asarray(c0), jnp.asarray(new), jnp.asarray(idx))
        np.testing.assert_array_equal(c_t[name].numpy(), np.asarray(dus))
        if name in ("k", "v"):
            step = np.abs(c_t[name].numpy().astype(np.int32)
                          - np.asarray(c_j[name]).astype(np.int32))
            assert step.max() <= 1 and (step > 0).mean() < 0.01, name
        else:
            np.testing.assert_allclose(c_t[name].numpy(),
                                       np.asarray(c_j[name]), **TOL)
    np.testing.assert_array_equal(c_t["len"].numpy(), idx + t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)


def test_init_cache_matches_reference():
    """int8 codes and float32 (B, max_len, KvH) scales per layer, as the
    reference's ``init_cache``."""
    jcfg, tcfg = zoo.cfgs(ARCH)
    jcfg, tcfg = jcfg.replace(**INT8), tcfg.replace(**INT8)
    want = j_get_model(jcfg).init_cache(jcfg, 3, 20)["layers"]
    got = get_model(tcfg).init_cache(tcfg, 3, 20, device=zoo.CPU)["layers"]
    assert set(got) == set(want) == {"k", "v", "k_scale", "v_scale", "len"}
    for f, w in want.items():
        assert tuple(got[f].shape) == w.shape, f
        assert str(got[f].dtype).replace("torch.", "") == w.dtype.name, f


def test_emulate_and_deploy_match_reference(reference):
    zoo.check_emulate_and_deploy(reference)


@pytest.mark.parametrize("mode", ["emulate", "deploy"])
def test_decode_through_the_int8_cache_matches_reference(reference, mode):
    """The prompt decoded one token at a time through the int8 cache: each
    step's logits against the reference's decode step on the same cache
    layout, at 1e-4 (through the int8 cache the decoded logits part from
    the full forward's in both packages alike, by 0.68 of their largest
    at this size: the cache's quantization, not the port); then the
    overrun check."""
    jcfg, tcfg = zoo.cfgs(ARCH)
    jcfg, tcfg = jcfg.replace(**INT8), tcfg.replace(**INT8)
    model, jmodel = get_model(tcfg), j_get_model(jcfg)
    tokens = reference["tokens"]
    if mode == "deploy":
        j_params = jax.tree.map(jnp.asarray, reference["packed"])
        params = from_numpy_tree(reference["packed"], zoo.CPU)
        jcfg = jcfg.replace(cim=jcfg.cim.replace(mode="deploy"))
        tcfg = tcfg.replace(cim=tcfg.cim.replace(mode="deploy"))
    else:
        j_params = jax.tree.map(jnp.asarray, reference["params"])
        params = from_numpy_tree(reference["params"], zoo.CPU)
    jstep = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t, jcfg))
    j_cache = jmodel.init_cache(jcfg, B, zoo.T + 2)
    cache = model.init_cache(tcfg, B, zoo.T + 2, device=zoo.CPU)
    for t in range(zoo.T):
        j_logits, j_cache = jstep(j_params, j_cache,
                                  jnp.asarray(tokens[:, t:t + 1]))
        logits, cache = model.decode_step(
            params, cache, torch.from_numpy(np.array(tokens[:, t:t + 1])),
            tcfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   **zoo.LOGIT_TOL)
    assert cache["layers"]["len"].tolist() == [[zoo.T] * B] * 2
    with pytest.raises(ValueError, match="overrun"):
        model.decode_step(params, cache,
                          torch.from_numpy(np.array(tokens[:, :3])), tcfg)


def test_engine_serves_the_reference_engines_tokens(reference):
    zoo.check_engine_tokens(reference)
