"""MLA attention (DeepSeek-V3) on the port against the JAX package, on the
CPU: ``mla_attend`` at prefill and at decode, the latent cache's layout,
its clamped write at the cache's end, and the reduced deepseek-v3-671b
(MLA in both its dense and its MoE layer) through the zoo's checks
(``tests/_torch_zoo.py``: specs, emulate and deploy logits, decode
against the forward, served tokens).

The layer's params are the reference's own (JAX ``init_params`` carried
across by ``interop``), its inputs made with numpy; outputs and caches
agree within 1e-5 (the two frameworks' projections differ in the last
bit).
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

ARCH = "deepseek-v3-671b"
B = zoo.B
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def reference():
    return zoo.make_reference(ARCH)


def _attn_params(reference):
    """Layer 0 of the dense stack's MLA params: (numpy tree, port tree)."""
    p_np = jax.tree.map(lambda a: a[0],
                        reference["params"]["dense_layers"]["attn"])
    return p_np, from_numpy_tree(p_np, zoo.CPU)


def _cache(rng, cfg, max_len):
    m = cfg.mla
    return (rng.standard_normal((B, max_len, m.kv_lora_rank))
            .astype(np.float32),
            rng.standard_normal((B, max_len, 1, m.qk_rope_dim))
            .astype(np.float32))


@pytest.mark.parametrize("t,decode", [(7, False), (1, True), (3, True)])
def test_mla_attend_matches_reference(reference, t, decode):
    """Prefill (no cache) and decode steps of 1 and 3 positions over a
    latent cache with other contents at each row's own length: outputs and
    the written caches against JAX's ``mla_attend``."""
    jcfg, tcfg = zoo.cfgs(ARCH)
    p_np, p_t = _attn_params(reference)
    rng = np.random.default_rng(t + 10 * decode)
    x = rng.standard_normal((B, t, tcfg.d_model)).astype(np.float32)
    if not decode:
        pos = np.arange(t, dtype=np.int32)
        y_j, _ = jax.jit(lambda p, x_: JL.mla_attend(
            p, x_, jcfg, positions=jnp.asarray(pos)))(p_np, jnp.asarray(x))
        y_t, c_t = TL.mla_attend(p_t, torch.from_numpy(x), tcfg,
                                 positions=torch.from_numpy(pos).long())
        assert c_t is None
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
        return
    max_len = 12
    ckv0, kr0 = _cache(rng, tcfg, max_len)
    idx = np.array([4, 7], np.int32)
    pos = (idx[:, None] + np.arange(t)[None]).astype(np.int32)
    y_j, c_j = jax.jit(lambda p, x_, c: JL.mla_attend(
        p, x_, jcfg, positions=jnp.asarray(pos), cache=c))(
        p_np, jnp.asarray(x), {"ckv": jnp.asarray(ckv0),
                               "krope": jnp.asarray(kr0),
                               "len": jnp.asarray(idx)})
    y_t, c_t = TL.mla_attend(
        p_t, torch.from_numpy(x), tcfg,
        positions=torch.from_numpy(pos).long(),
        cache={"ckv": torch.from_numpy(ckv0.copy()),
               "krope": torch.from_numpy(kr0.copy()),
               "len": torch.from_numpy(idx)})
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    for f in ("ckv", "krope"):
        np.testing.assert_allclose(c_t[f].numpy(), np.asarray(c_j[f]), **TOL)
    np.testing.assert_array_equal(c_t["len"].numpy(), idx + t)


@pytest.mark.parametrize("int8_kv", [False, True])
def test_init_cache_matches_reference(int8_kv):
    """MLA's latent cache (``ckv``, ``krope``; the KV cache dtype does not
    apply to it), stacked per layer stack: shapes and dtypes as the
    reference's, zero-filled."""
    jcfg, tcfg = zoo.cfgs(ARCH, mode="deploy")
    kw = {"kv_cache_dtype": "int8"} if int8_kv else {}
    jcfg, tcfg = jcfg.replace(**kw), tcfg.replace(**kw)
    want = j_get_model(jcfg).init_cache(jcfg, 3, 20)
    got = get_model(tcfg).init_cache(tcfg, 3, 20, device=zoo.CPU)
    assert set(got) == set(want) == {"dense_layers", "moe_layers"}
    for stack in want:
        assert set(got[stack]) == set(want[stack]) == {"ckv", "krope", "len"}
        for f, w in want[stack].items():
            g = got[stack][f]
            assert tuple(g.shape) == w.shape, (stack, f)
            assert str(g.dtype).replace("torch.", "") == w.dtype.name
            assert not g.any()
    m = tcfg.mla
    assert got["dense_layers"]["ckv"].shape == (1, 3, 20, m.kv_lora_rank)
    assert got["moe_layers"]["krope"].shape == (1, 3, 20, 1, m.qk_rope_dim)


@pytest.mark.parametrize("back,t", [(1, 2), (0, 1), (0, 3)])
def test_latent_cache_write_at_the_end_matches_reference(reference, back,
                                                         t):
    """``mla_attend`` with a cache, called below ``decode_step``'s host
    check, at ``len = max_len - back`` with T new positions: the write
    runs past the cache and clamps its start on the device as the
    reference's ``dynamic_update_slice``. The port's cache is, bit for
    bit, the reference's write of the port's new latent rows; caches and
    outputs agree with JAX's layer within 1e-5."""
    jcfg, tcfg = zoo.cfgs(ARCH)
    p_np, p_t = _attn_params(reference)
    max_len = 6
    rng = np.random.default_rng(10 * back + t)
    x = rng.standard_normal((B, t, tcfg.d_model)).astype(np.float32)
    ckv0, kr0 = _cache(rng, tcfg, max_len)
    idx = np.full((B,), max_len - back, np.int32)
    idx[0] -= 3                             # one row well inside the cache
    pos = (idx[:, None] + np.arange(t)[None]).astype(np.int32)
    y_j, c_j = jax.jit(lambda p, x_, c: JL.mla_attend(
        p, x_, jcfg, positions=jnp.asarray(pos), cache=c))(
        p_np, jnp.asarray(x), {"ckv": jnp.asarray(ckv0),
                               "krope": jnp.asarray(kr0),
                               "len": jnp.asarray(idx)})

    def port(ckv, kr):
        return TL.mla_attend(p_t, torch.from_numpy(x), tcfg,
                             positions=torch.from_numpy(pos).long(),
                             cache={"ckv": torch.from_numpy(ckv.copy()),
                                    "krope": torch.from_numpy(kr.copy()),
                                    "len": torch.from_numpy(idx)})
    y_t, c_t = port(ckv0, kr0)
    # the port's new rows, from a cache with room for them
    _, c_big = port(np.concatenate([ckv0, np.zeros_like(ckv0[:, :t])], 1),
                    np.concatenate([kr0, np.zeros_like(kr0[:, :t])], 1))
    rows = np.arange(B)[:, None]
    cols = idx[:, None] + np.arange(t)[None]
    for name, c0 in (("ckv", ckv0), ("krope", kr0)):
        new = c_big[name].numpy()[rows, cols]
        dus = jax.vmap(lambda c, n, i: jax.lax.dynamic_update_slice(
            c, n, (i,) + (0,) * (c.ndim - 1)))(
            jnp.asarray(c0), jnp.asarray(new), jnp.asarray(idx))
        np.testing.assert_array_equal(c_t[name].numpy(), np.asarray(dus))
        np.testing.assert_allclose(c_t[name].numpy(), np.asarray(c_j[name]),
                                   **TOL)
    np.testing.assert_array_equal(c_t["len"].numpy(), idx + t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)


@pytest.mark.parametrize("mode,pack_dtype", [("emulate", "int8"),
                                             ("deploy", "int4")])
def test_specs_match_reference(mode, pack_dtype):
    zoo.check_specs(ARCH, mode, pack_dtype)


def test_emulate_and_deploy_match_reference(reference):
    zoo.check_emulate_and_deploy(reference)


@pytest.mark.parametrize("mode", ["emulate", "deploy"])
def test_decode_matches_forward(reference, mode):
    zoo.check_decode_matches_forward(reference, mode)


def test_engine_serves_the_reference_engines_tokens(reference):
    zoo.check_engine_tokens(reference)


def test_artifact_on_disk_serves_the_reference_engines_tokens(reference,
                                                              tmp_path):
    """The port's own pack of the reference's params, saved with its
    ``meta["arch"]`` and served from the path by ``engine_from_artifact``:
    MLA's packed nodes survive the round trip bit for bit, and the greedy
    tokens are the JAX engine's."""
    from repro_torch import api as tapi
    from repro_torch.serve.engine import engine_from_artifact
    _, tcfg = zoo.cfgs(ARCH)
    art = tapi.model_artifact(from_numpy_tree(reference["params"], zoo.CPU),
                              tcfg.cim, meta={"arch": ARCH}, device=zoo.CPU)
    attn = art.params["dense_layers"]["attn"]
    assert {"wq_a", "wq_b", "wkv_a", "wkv_b", "wo"} <= set(attn)
    assert all("w_digits" in attn[n] for n in ("wq_a", "wkv_b", "wo"))
    path = str(tmp_path / "deepseek")
    art.save(path)
    loaded = tapi.DeployArtifact.load(path, device=zoo.CPU)
    assert loaded.meta["arch"] == ARCH
    assert loaded.meta["col_shard"] == art.meta["col_shard"]
    for n in ("wq_b", "wkv_a"):
        assert torch.equal(loaded.params["dense_layers"]["attn"][n][
            "w_digits"], attn[n]["w_digits"])
    eng = engine_from_artifact(path, tcfg, batch_size=B, max_len=32,
                               device=zoo.CPU)
    np.testing.assert_array_equal(
        eng.generate_batch(reference["tokens"], zoo.NEW), reference["served"])
