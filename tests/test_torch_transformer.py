"""The MoE transformer slice of the port against the JAX package, on the
CPU: reduced moonshot-v1-16b-a3b (1 dense layer, 1 MoE layer of 8
experts, top-2, 1 shared expert) with the zoo-parity CIM config (4-bit
weights on 2-bit cells, 8-bit activations, 6-bit partial sums, 32x32
arrays) in float32.

The JAX package initialises the params; ``repro_torch.interop`` carries
them across as numpy. The port's specs, emulate logits, packed
artifact and deploy logits then match the reference's (logits at rtol /
atol 1e-4, planes byte for byte); within the port deploy equals emulate
bit for bit. The MoE routing (top-k ties, capacity overflow, dropped
slots) and each expert's filled-slot count are held against the
reference's formulas on the same logits, and the MoE block gives the
same output with and without the counts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs.registry import get_config as j_get_config
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.models import layers as JL
from repro.models.registry import get_model as j_get_model
from repro.nn import init_params as j_init_params
from repro.nn.module import ParamSpec as JParamSpec
from repro_torch import api as tapi
from repro_torch.configs.registry import get_config
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.models import layers as TL
from repro_torch.models import transformer
from repro_torch.models.registry import get_model
from repro_torch.nn.module import ParamSpec, torch_dtype

CPU = "cpu"
ARCH = "moonshot-v1-16b-a3b"
B, T = 2, 8
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CIM = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
           act_bits=8, psum_bits=6, array_rows=32, array_cols=32)


def _cfgs(**kw):
    cim = dict(CIM, **kw)
    common = dict(compute_dtype="float32", remat=False)
    return (j_get_config(ARCH, reduced=True,
                         cim=JCIMConfig(**cim)).replace(**common),
            get_config(ARCH, reduced=True,
                       cim=TCIMConfig(**cim)).replace(**common))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference():
    """JAX params, tokens, emulate logits, and per pack dtype the packed
    artifact and its deploy logits (jitted; Pallas in interpret mode)."""
    jcfg, _ = _cfgs()
    model = j_get_model(jcfg)
    params = jax.jit(lambda k: j_init_params(model.specs(jcfg), k))(
        jax.random.PRNGKey(0))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, T), 0,
                                           jcfg.vocab), np.int32)
    out = {"params": _np(params), "tokens": tokens,
           "emulate": np.asarray(jax.jit(
               lambda p, t: model.forward(p, t, jcfg))(params, tokens))}
    for dt in ("int8", "int4"):
        art = japi.model_artifact(params, jcfg.cim.replace(pack_dtype=dt))
        dcfg = jcfg.replace(cim=art.config)
        out[dt] = (_np(art.params), art.meta["col_shard"], np.asarray(
            jax.jit(lambda p, t: model.forward(p, t, dcfg))(art.params,
                                                            tokens)))
    return out


def _spec_leaves(tree, path=""):
    if isinstance(tree, (ParamSpec, JParamSpec)):
        yield path, tree
        return
    for k in sorted(tree):
        yield from _spec_leaves(tree[k], f"{path}/{k}")


def _dtype_name(d):
    if isinstance(d, torch.dtype) or d == "int4":
        return str(torch_dtype(d)).replace("torch.", "")
    name = np.dtype(d).name
    return "int8" if name == "int4" else name   # the port's dense int4


@pytest.mark.parametrize("mode,pack_dtype", [
    ("emulate", "int8"), ("deploy", "int8"), ("deploy", "int4")])
def test_specs_match_reference(mode, pack_dtype):
    jcfg, tcfg = _cfgs(mode=mode, pack_dtype=pack_dtype)
    want = dict(_spec_leaves(j_get_model(jcfg).specs(jcfg)))
    got = dict(_spec_leaves(get_model(tcfg).specs(tcfg)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert _dtype_name(got[k].dtype) == _dtype_name(w.dtype), k


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    if want.dtype.name == "int4":
        want = want.astype(np.int8)        # the port's dense int4 storage
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("pack_dtype", ["int8", "int4"])
def test_moonshot_slice_matches_reference(reference, pack_dtype):
    _, tcfg = _cfgs(pack_dtype=pack_dtype)
    model = get_model(tcfg)
    params = from_numpy_tree(reference["params"], CPU)
    tokens = torch.from_numpy(np.array(reference["tokens"]))
    em = model.forward(params, tokens, tcfg)
    assert em.shape == (B, T, tcfg.vocab) and em.dtype == torch.float32
    np.testing.assert_allclose(em.numpy(), reference["emulate"], **LOGIT_TOL)

    j_packed, j_col_shard, j_deploy = reference[pack_dtype]
    art = tapi.model_artifact(params, tcfg.cim, device=CPU)
    assert art.kind == "model" and art.config.mode == "deploy"
    assert art.meta["col_shard"] == j_col_shard
    _assert_trees_equal(to_numpy_tree(art.params), j_packed)
    moe = art.params["moe_layers"]["moe"]
    assert moe["wg_digits"].shape[:2] == (1, tcfg.moe.n_experts)
    assert set(moe) >= {"wg_occ", "wg_k_logical", "wg_s_w", "router",
                        "shared"}

    dcfg = tcfg.replace(cim=art.config)
    dp = model.forward(art.params, tokens, dcfg)
    np.testing.assert_allclose(dp.numpy(), j_deploy, **LOGIT_TOL)
    # within the port, deploy is bit-identical with emulate
    np.testing.assert_array_equal(dp.numpy(), em.numpy())
    # a tree packed by the JAX package serves on the port as it is
    dj = model.forward(from_numpy_tree(j_packed, CPU), tokens, dcfg)
    np.testing.assert_array_equal(dj.numpy(), dp.numpy())


@pytest.mark.parametrize("mode", ["emulate", "deploy"])
def test_decode_matches_forward(reference, mode):
    """As ``tests/test_models.py:58``: decoding the prompt one token at a
    time through the KV cache gives the full forward's logits."""
    _, tcfg = _cfgs()
    model = get_model(tcfg)
    params = from_numpy_tree(reference["params"], CPU)
    if mode == "deploy":
        art = tapi.model_artifact(params, tcfg.cim, device=CPU)
        params, tcfg = art.params, tcfg.replace(cim=art.config)
    tokens = torch.from_numpy(np.array(reference["tokens"]))
    full = model.forward(params, tokens, tcfg)
    cache = model.init_cache(tcfg, B, T + 4, device=CPU)
    outs = []
    for t in range(T):
        lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1], tcfg)
        outs.append(lg[:, 0])
    assert cache["moe_layers"]["len"].tolist() == [[T] * B]
    dec = torch.stack(outs, dim=1)
    rel = float((full - dec).abs().max() / full.abs().max())
    assert rel < 5e-3, rel
    with pytest.raises(ValueError, match="overrun"):
        model.decode_step(params, cache, tokens[:, :5], tcfg)


@pytest.mark.parametrize("back,t", [(1, 2), (0, 1)])
def test_cache_write_at_the_end_matches_reference(reference, back, t):
    """The attention layer with a decode cache, called below
    ``decode_step``'s host check, at ``len = max_len - back`` with T new
    positions: the write runs past the cache, and the port clamps its start
    on the device as the reference's ``dynamic_update_slice`` does. The
    port's cache is, bit for bit, the reference's write of the port's new
    K/V rows (the two frameworks' projections differ in the last bit); the
    two layers' caches and outputs agree within 1e-5."""
    jcfg, tcfg = _cfgs()
    p_np = jax.tree.map(lambda a: a[0],
                        reference["params"]["dense_layers"]["attn"])
    p_t = from_numpy_tree(p_np, CPU)
    max_len, kvh, hd = 6, tcfg.n_kv_heads, tcfg.resolved_head_dim
    rng = np.random.default_rng(10 * back + t)
    x = rng.standard_normal((B, t, tcfg.d_model)).astype(np.float32)
    k0, v0 = (rng.standard_normal((B, max_len, kvh, hd)).astype(np.float32)
              for _ in range(2))
    idx = np.full((B,), max_len - back, np.int32)
    idx[0] -= 2                             # one row well inside the cache
    pos = (idx[:, None] + np.arange(t)[None]).astype(np.int32)
    y_j, c_j = jax.jit(lambda p, x_, c: JL.gqa_attend(
        p, x_, jcfg, positions=jnp.asarray(pos), cache=c))(
        p_np, jnp.asarray(x), {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
                               "len": jnp.asarray(idx)})

    def port(k_init, v_init):
        return TL.gqa_attend(
            p_t, torch.from_numpy(x), tcfg,
            positions=torch.from_numpy(pos).long(),
            cache={"k": torch.from_numpy(k_init.copy()),
                   "v": torch.from_numpy(v_init.copy()),
                   "len": torch.from_numpy(idx)})
    y_t, c_t = port(k0, v0)
    # the port's new rows, from a cache with room for them
    pad = np.zeros((B, t, kvh, hd), np.float32)
    _, c_big = port(np.concatenate([k0, pad], 1), np.concatenate([v0, pad], 1))
    rows = np.arange(B)[:, None]
    cols = idx[:, None] + np.arange(t)[None]
    for name, c0 in (("k", k0), ("v", v0)):
        new = c_big[name].numpy()[rows, cols]
        dus = jax.vmap(lambda c, n, i: jax.lax.dynamic_update_slice(
            c, n, (i, 0, 0)))(jnp.asarray(c0), jnp.asarray(new),
                              jnp.asarray(idx))
        np.testing.assert_array_equal(c_t[name].numpy(), np.asarray(dus))
        np.testing.assert_allclose(c_t[name].numpy(), np.asarray(c_j[name]),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(c_t["len"].numpy(), idx + t)
    np.testing.assert_array_equal(np.asarray(c_j["len"]), idx + t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)


def test_decode_past_max_len_matches_reference(reference):
    """``_decode_step`` (``decode_step`` below its host check, the path a
    replayed CUDA graph takes) decodes past ``max_len`` as the
    reference's ``decode_step`` does (it has no check): the cache write
    clamps to the last T rows. A 6-token prompt in a cache of 7, then two
    single-token steps, the second past the end: the logits of every step
    and the final caches match JAX's."""
    jcfg, tcfg = _cfgs()
    jmodel, model = j_get_model(jcfg), get_model(tcfg)
    tokens = np.array(reference["tokens"])
    j_params = jax.tree.map(jnp.asarray, reference["params"])
    params = from_numpy_tree(reference["params"], CPU)
    jstep = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t, jcfg))
    j_cache = jmodel.init_cache(jcfg, B, 7)
    cache = model.init_cache(tcfg, B, 7, device=CPU)
    for t0, t1 in ((0, 6), (6, 7), (7, 8)):
        j_logits, j_cache = jstep(j_params, j_cache,
                                  jnp.asarray(tokens[:, t0:t1]))
        logits, cache = transformer._decode_step(
            params, cache, torch.from_numpy(tokens[:, t0:t1]), tcfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   **LOGIT_TOL)
    for stack in cache:
        np.testing.assert_array_equal(cache[stack]["len"].numpy(),
                                      np.asarray(j_cache[stack]["len"]))
        assert int(cache[stack]["len"].max()) == 8
        for f in ("k", "v"):
            np.testing.assert_allclose(cache[stack][f].numpy(),
                                       np.asarray(j_cache[stack][f]),
                                       rtol=1e-5, atol=1e-5)


def _j_route(logits, cfg):
    """The reference's routing (``models/layers.py:771-797``), on given
    logits: (sel, slot)."""
    mo = cfg.moe
    n_tok = logits.shape[0]
    e, k = mo.n_experts, mo.top_k
    _, sel = jax.lax.top_k(logits, k)
    cap = int(mo.capacity_factor * n_tok * k / e) + 1
    if n_tok * k <= 256:
        cap = n_tok * k
    flat_e = sel.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    start = jnp.searchsorted(e_sorted, jnp.arange(e), side="left")
    pos_in_e = jnp.arange(n_tok * k) - start[e_sorted]
    slot_sorted = jnp.where(pos_in_e < cap, e_sorted * cap + pos_in_e,
                            e * cap)
    inv = jnp.zeros_like(order).at[order].set(jnp.arange(order.shape[0]))
    return np.asarray(sel), np.asarray(slot_sorted[inv]), cap


@pytest.mark.parametrize("n_tok", [40, 160])
def test_routing_matches_reference_with_ties_and_overflow(n_tok):
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(n_tok)
    # few distinct values: many exact ties; a skew toward expert 3
    logits = rng.integers(0, 3, (n_tok, tcfg.moe.n_experts)).astype(np.float32)
    logits[:, 3] += 2.0
    sel_j, slot_j, cap_j = _j_route(jnp.asarray(logits), jcfg)
    gates, sel, slot, cap = TL.route(torch.from_numpy(logits), tcfg)
    assert cap == cap_j
    np.testing.assert_array_equal(sel.numpy(), sel_j)
    np.testing.assert_array_equal(slot.numpy(), slot_j)
    dropped = int((slot == tcfg.moe.n_experts * cap).sum())
    assert dropped > 0 if n_tok * tcfg.moe.top_k > 256 else dropped == 0
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("n_tok", [40, 160])
def test_expert_counts_equal_the_reference_slot_fill(n_tok):
    """Each expert's filled capacity slots (``counts``, what the experts
    kernel computes alone) from the port's slots equal the fill of the
    reference's slot assignment on the same logits: min(pairs routed to
    the expert, cap), capacity overflow included."""
    jcfg, tcfg = _cfgs()
    e = tcfg.moe.n_experts
    rng = np.random.default_rng(n_tok + 1)
    logits = rng.integers(0, 3, (n_tok, e)).astype(np.float32)
    logits[:, 3] += 2.0                     # expert 3 overflows at 160
    sel_j, slot_j, cap = _j_route(jnp.asarray(logits), jcfg)
    _, _, slot, _ = TL.route(torch.from_numpy(logits), tcfg)
    counts = TL.expert_counts(slot, e, cap)
    assert counts.dtype == torch.int32 and counts.shape == (e,)
    fill = np.bincount(slot_j[slot_j < e * cap] // cap, minlength=e)
    np.testing.assert_array_equal(counts.numpy(), fill)
    routed = np.bincount(sel_j.reshape(-1), minlength=e)
    np.testing.assert_array_equal(counts.numpy(), np.minimum(routed, cap))
    assert (routed > cap).any() == (n_tok * tcfg.moe.top_k > 256)


@pytest.mark.parametrize("psum_bits", [6, 1])
def test_moe_block_same_with_and_without_counts_and_matches_reference(
        reference, psum_bits, monkeypatch):
    """The deploy MoE block (int8 banks): with ``counts`` the experts
    kernel gives the empty capacity slots a zero-row value, which the
    combine step never reads, so the block's output is bit for bit the one
    computed on every slot; it matches the reference's ``_apply_moe_jit``
    at the launcher's 6-bit partial sums and under the sign ADC."""
    import repro_torch.kernels.ops as tops
    jcfg, tcfg = _cfgs(psum_bits=psum_bits)
    p_np = jax.tree.map(lambda a: a[0],
                        reference["int8"][0]["moe_layers"]["moe"])
    x = (np.random.default_rng(psum_bits).standard_normal(
        (B, T, tcfg.d_model)).astype(np.float32))
    dcfg_j = jcfg.replace(cim=jcfg.cim.replace(mode="deploy"))
    dcfg_t = tcfg.replace(cim=tcfg.cim.replace(mode="deploy"))
    want = np.asarray(jax.jit(lambda p, x_: JL._apply_moe_jit(p, x_, dcfg_j))(
        p_np, jnp.asarray(x)))
    p_t = from_numpy_tree(p_np, CPU)
    xt = torch.from_numpy(x)
    seen = []
    orig = tops.cim_matmul_experts_cuda

    def spy(*a, **kw):
        seen.append(kw.get("counts"))
        return orig(*a, **kw)
    monkeypatch.setattr(tops, "cim_matmul_experts_cuda", spy)
    got = TL.apply_moe(p_t, xt, dcfg_t)
    assert len(seen) == 3 and all(c is not None for c in seen)
    cap = B * T * tcfg.moe.top_k           # dropless at this size
    assert int(seen[0].min()) < cap         # some slots are empty
    monkeypatch.setattr(TL, "expert_counts", lambda *a: None)
    full = TL.apply_moe(p_t, xt, dcfg_t)
    assert seen[-1] is None
    assert torch.equal(got, full)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def test_moe_block_with_overflowing_expert_matches_reference(reference):
    """One MoE block whose router sends every token to expert 0, so that
    with n_tok * k = 320 > 256 expert 0 overflows its capacity and pairs
    are dropped; on deploy banks, against the reference's ``apply_moe``."""
    jcfg, tcfg = _cfgs()
    j_packed = reference["int8"][0]
    p_np = jax.tree.map(lambda a: a[0], j_packed["moe_layers"]["moe"])
    x = (np.random.default_rng(0).standard_normal((4, 40, tcfg.d_model))
         .astype(np.float32) + 1.0)
    router = np.array(p_np["router"]["w"])
    router[:, 0] = 1.0                      # logit 0 ~ sum(x): the largest
    p_np["router"]["w"] = router
    dcfg_j = jcfg.replace(cim=jcfg.cim.replace(mode="deploy"))
    dcfg_t = tcfg.replace(cim=tcfg.cim.replace(mode="deploy"))
    want = np.asarray(jax.jit(lambda p, x_: JL.apply_moe(p, x_, dcfg_j))(
        p_np, jnp.asarray(x)))
    p_t = from_numpy_tree(p_np, CPU)
    xt = torch.from_numpy(x)
    logits = xt.reshape(-1, tcfg.d_model) @ p_t["router"]["w"]
    _, sel, slot, cap = TL.route(logits, tcfg)
    sel_j, slot_j, _ = _j_route(jnp.asarray(logits.numpy()), jcfg)
    np.testing.assert_array_equal(sel.numpy(), sel_j)
    np.testing.assert_array_equal(slot.numpy(), slot_j)
    assert bool((sel[:, 0] == 0).all())
    assert int((slot == tcfg.moe.n_experts * cap).sum()) > 0
    got = TL.apply_moe(p_t, xt, dcfg_t)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


@pytest.mark.parametrize("chunk,causal,decode", [
    (0, True, False), (3, True, False), (3, False, False), (4, True, True)])
def test_attention_matches_reference(chunk, causal, decode):
    """The full and the KV-chunked online-softmax attention, with the causal
    mask, query offsets and valid KV lengths of decode."""
    rng = np.random.default_rng(chunk)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 3, 4, 8), (2, 11, 2, 8), (2, 11, 2, 8)))
    kw = dict(causal=causal, chunk=chunk)
    if decode:
        kw.update(q_offset=np.array([2, 5], np.int32),
                  kv_len=np.array([5, 8], np.int32))
    want = JL.attention(*(jnp.asarray(a) for a in (q, k, v)),
                        **{n: jnp.asarray(a) if isinstance(a, np.ndarray)
                           else a for n, a in kw.items()})
    got = TL.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                       **{n: torch.from_numpy(a) if isinstance(a, np.ndarray)
                          else a for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_unported_entries_raise():
    """Every entry of the reference's registry resolves; an unknown
    architecture and an unknown family still raise ``KeyError``."""
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("mamba-3b")
    _, tcfg = _cfgs()
    with pytest.raises(KeyError, match="unknown model family"):
        get_model(dataclasses.replace(tcfg, family="mamba"))
    assert get_model(get_config("xlstm-1.3b")).specs is not None
