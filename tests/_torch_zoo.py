"""Shared parts of the zoo's parity tests against the JAX package
(``tests/test_torch_zoo.py`` for the dense entries, ``tests/test_torch_mla.py``
for deepseek-v3-671b, ``tests/test_torch_{zamba2,xlstm,whisper,llava}.py``
for the recurrent and multimodal ones): each entry at its ``reduced()``
size with the zoo-parity CIM config (4-bit weights on 2-bit cells, 8-bit
activations, 6-bit partial sums, 32x32 arrays) in float32, params
initialised by the JAX package and carried across as numpy by
``repro_torch.interop``. Front-end inputs (whisper's raw log-mel frames,
llava's 4-D images, at ``frontend_input_shape``) are made with numpy.

The checks: the spec trees agree in names, shapes and dtypes; emulate
logits match the reference's at rtol / atol 1e-4; the reference's own
artifact serves on the port with deploy logits matching the reference's
deploy at 1e-4; within the port deploy equals emulate bit for bit;
decoding the prompt through the cache gives the full forward's logits
(the transformers'), or each decode step the reference's decode step at
1e-4 (every family; whisper's cache carries each side's encoder states),
and, with CIM off, the port's own forward at 5e-3; and the port's engine
serves the reference engine's greedy tokens from the reference's
artifact (whisper's: the slot engine with the encoder states injected
into its cache, as ``examples/serve_whisper_cim.py`` serves it).
"""
import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs.registry import get_config as j_get_config
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.models import whisper as j_whisper
from repro.models.registry import frontend_input_shape
from repro.models.registry import get_model as j_get_model
from repro.nn import init_params as j_init_params
from repro.nn.module import ParamSpec as JParamSpec
from repro.serve.engine import engine_from_artifact as j_engine_from_artifact
from repro_torch import api as tapi
from repro_torch.configs.registry import get_config
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.interop import from_numpy_tree
from repro_torch.models import whisper as t_whisper
from repro_torch.models.registry import get_model
from repro_torch.nn.module import ParamSpec, torch_dtype
from repro_torch.serve.engine import engine_from_artifact

CPU = "cpu"
B, T, NEW = 2, 8, 4
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CIM = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
           act_bits=8, psum_bits=6, array_rows=32, array_cols=32)


def cfgs(arch, **kw):
    """(JAX config, port config) of ``arch``'s reduced entry: the parity
    CIM config with ``kw``, float32 compute."""
    cim = dict(CIM, **kw)
    common = dict(compute_dtype="float32", remat=False)
    return (j_get_config(arch, reduced=True,
                         cim=JCIMConfig(**cim)).replace(**common),
            get_config(arch, reduced=True,
                       cim=TCIMConfig(**cim)).replace(**common))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def frontend_input(cfg, b=B):
    """The front-end input ``cfg``'s forward takes (raw log-mel frames,
    images or stub embeddings; ``frontend_input_shape``), float32 from
    numpy's seed 2 at scale 0.1, or None for text-only entries."""
    shape = frontend_input_shape(cfg, b)
    if shape is None:
        return None
    return (np.random.default_rng(2).standard_normal(shape) * 0.1).astype(
        np.float32)


def slot_run_with_encoder(engine, prompts, enc_out):
    """Whisper served as ``examples/serve_whisper_cim.py`` serves it: the
    encoder states injected into the slot engine's cache, then one request
    per prompt through ``submit``/``step``. Returns (B, NEW) int32 tokens
    in request order (JAX or port engine alike)."""
    engine.cache["enc_out"] = enc_out
    rids = [engine.submit(p, NEW) for p in prompts]
    done = {}
    while len(done) < len(rids):
        for fin in engine.step():
            done[fin["rid"]] = list(fin["tokens"])
    return np.array([done[r] for r in rids], np.int32)


def make_reference(arch, **kw):
    """The JAX side of ``arch``: params, tokens, the front-end input and
    emulate logits, the int8 artifact, its deploy logits and its engine's
    greedy tokens (jitted; Pallas in interpret mode). ``kw`` replaces
    config fields."""
    jcfg, _ = cfgs(arch)
    jcfg = jcfg.replace(**kw)
    model = j_get_model(jcfg)
    params = jax.jit(lambda k: j_init_params(model.specs(jcfg), k))(
        jax.random.PRNGKey(0))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, T), 0,
                                           jcfg.vocab), np.int32)
    extra = frontend_input(jcfg)
    ej = None if extra is None else jax.numpy.asarray(extra)
    art = japi.model_artifact(params, jcfg.cim)
    dcfg = jcfg.replace(cim=art.config)
    eng = j_engine_from_artifact(art, jcfg, batch_size=B, max_len=32)
    if jcfg.family == "whisper":
        enc = jax.jit(lambda p, e: j_whisper.encode(p, e, dcfg))(art.params,
                                                                 ej)
        served = slot_run_with_encoder(eng, tokens, enc)
    else:
        served = eng.generate_batch(tokens, NEW)
    return {"arch": arch, "kw": kw, "params": _np(params), "tokens": tokens,
            "extra": extra,
            "emulate": np.asarray(jax.jit(
                lambda p, t, e: model.forward(p, t, jcfg, e))(params, tokens,
                                                              ej)),
            "packed": _np(art.params), "meta": dict(art.meta),
            "deploy": np.asarray(jax.jit(
                lambda p, t, e: model.forward(p, t, dcfg, e))(art.params,
                                                              tokens, ej)),
            "served": served}


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


def check_specs(arch, mode, pack_dtype):
    jcfg, tcfg = cfgs(arch, mode=mode, pack_dtype=pack_dtype)
    want = dict(_spec_leaves(j_get_model(jcfg).specs(jcfg)))
    got = dict(_spec_leaves(get_model(tcfg).specs(tcfg)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert _dtype_name(got[k].dtype) == _dtype_name(w.dtype), k


def _port_cfg(reference):
    _, tcfg = cfgs(reference["arch"])
    return tcfg.replace(**reference["kw"])


def _extra(reference):
    """The reference's front-end input as a tensor, or None."""
    e = reference["extra"]
    return None if e is None else torch.from_numpy(np.array(e))


def check_emulate_and_deploy(reference):
    """Emulate logits against JAX's; the JAX package's artifact deployed on
    the port against JAX's deploy; the port's deploy of its own pack
    equal to its emulate (max difference 0.0)."""
    tcfg = _port_cfg(reference)
    model = get_model(tcfg)
    params = from_numpy_tree(reference["params"], CPU)
    tokens = torch.from_numpy(np.array(reference["tokens"]))
    extra = _extra(reference)
    em = model.forward(params, tokens, tcfg, extra)
    t_out = T + (tcfg.n_frontend_tokens if tcfg.family == "llava" else 0)
    assert em.shape == (B, t_out, tcfg.vocab) and em.dtype == torch.float32
    np.testing.assert_allclose(em.numpy(), reference["emulate"], **LOGIT_TOL)

    dcfg = tcfg.replace(cim=tcfg.cim.replace(mode="deploy"))
    dj = model.forward(from_numpy_tree(reference["packed"], CPU), tokens,
                       dcfg, extra)
    np.testing.assert_allclose(dj.numpy(), reference["deploy"], **LOGIT_TOL)

    art = tapi.model_artifact(params, tcfg.cim, device=CPU)
    assert art.meta["col_shard"] == reference["meta"]["col_shard"]
    dp = model.forward(art.params, tokens, tcfg.replace(cim=art.config),
                       extra)
    diff = float((dp - em).abs().max())
    assert diff == 0.0, diff
    np.testing.assert_array_equal(dp.numpy(), dj.numpy())


def check_decode_matches_forward(reference, mode):
    """As ``tests/test_models.py:58``: the prompt decoded one token at a
    time through the cache gives the full forward's logits."""
    tcfg = _port_cfg(reference)
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
    for stack in cache.values():
        assert stack["len"].tolist() == [[T] * B] * stack["len"].shape[0]
    rel = float((full - torch.stack(outs, dim=1)).abs().max()
                / full.abs().max())
    assert rel < 5e-3, rel
    with pytest.raises(ValueError, match="overrun"):
        model.decode_step(params, cache, tokens[:, :5], tcfg)


def check_engine_tokens(reference):
    """The reference's artifact, loaded as a port ``DeployArtifact`` with
    its ``meta`` (``col_shard`` names every packed node), served by the
    port's engine: greedy tokens equal the JAX engine's."""
    tcfg = _port_cfg(reference)
    art = tapi.DeployArtifact(
        kind="model", config=tcfg.cim.replace(mode="deploy"),
        params=from_numpy_tree(reference["packed"], CPU),
        meta=dict(reference["meta"]))
    eng = engine_from_artifact(art, tcfg, batch_size=B, max_len=32,
                               device=CPU)
    if tcfg.family == "whisper":
        enc = t_whisper.encode(art.params, _extra(reference),
                               tcfg.replace(cim=art.config))
        out = slot_run_with_encoder(eng, reference["tokens"], enc)
    else:
        out = eng.generate_batch(reference["tokens"], NEW)
    assert out.shape == (B, NEW) and out.dtype == np.int32
    np.testing.assert_array_equal(out, reference["served"])


def _decode_setup(reference, mode, cim_off=False):
    """(JAX config, port config, JAX params, port params) of ``mode``
    (emulate: the reference's params; deploy: its artifact), or with CIM
    off the emulate params under a config without CIM."""
    jcfg, _ = cfgs(reference["arch"])
    jcfg = jcfg.replace(**reference["kw"])
    tcfg = _port_cfg(reference)
    tree = reference["packed" if mode == "deploy" else "params"]
    if mode == "deploy":
        jcfg = jcfg.replace(cim=jcfg.cim.replace(mode="deploy"))
        tcfg = tcfg.replace(cim=tcfg.cim.replace(mode="deploy"))
    if cim_off:
        jcfg = jcfg.replace(cim=jcfg.cim.replace(enabled=False))
        tcfg = tcfg.replace(cim=tcfg.cim.replace(enabled=False))
    return (jcfg, tcfg, jax.tree.map(jax.numpy.asarray, tree),
            from_numpy_tree(tree, CPU))


def _check_lengths(cache, tcfg, params, tokens):
    """Every attention cache holds T positions per row, and a prefill past
    max_len raises (the recurrent states have no length)."""
    model = get_model(tcfg)
    if tcfg.family in ("xlstm",):
        return
    stack = cache["attn"] if tcfg.family == "zamba2" else (
        cache if tcfg.family == "whisper" else next(iter(cache.values())))
    assert stack["len"].tolist() == [[T] * B] * stack["len"].shape[0]
    with pytest.raises(ValueError, match="overrun"):
        model.decode_step(params, cache, tokens[:, :3], tcfg)


def check_decode_matches_reference(reference, mode):
    """The prompt decoded one token at a time through each package's cache:
    every step's logits against the reference's decode step at 1e-4
    (whisper's caches carry each package's own encoder states of the
    reference's input). The recurrences' float32 rounding may move 6-bit
    ADC decisions between a decode step and the full forward, in both
    packages alike, so the step is held against the step. Then each
    attention cache's lengths and the overrun check."""
    jcfg, tcfg, j_params, params = _decode_setup(reference, mode)
    jmodel, model = j_get_model(jcfg), get_model(tcfg)
    tokens = torch.from_numpy(np.array(reference["tokens"]))
    jstep = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t, jcfg))
    j_cache = jmodel.init_cache(jcfg, B, T + 2)
    cache = model.init_cache(tcfg, B, T + 2, device=CPU)
    if tcfg.family == "whisper":
        j_cache["enc_out"] = jax.jit(
            lambda p, e: j_whisper.encode(p, e, jcfg))(
            j_params, jax.numpy.asarray(reference["extra"]))
        cache["enc_out"] = t_whisper.encode(params, _extra(reference), tcfg)
    for t in range(T):
        j_logits, j_cache = jstep(j_params, j_cache,
                                  jax.numpy.asarray(reference["tokens"][
                                      :, t:t + 1]))
        logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1],
                                          tcfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   **LOGIT_TOL)
    _check_lengths(cache, tcfg, params, tokens)


def check_decode_matches_forward_without_cim(reference):
    """With CIM off, the prompt decoded one token at a time through the
    port's cache gives the port's own full forward's logits, at the JAX
    package's 5e-3 (``tests/test_models.py:77``); whisper's cache holds the
    encoder states of the forward's input."""
    _, tcfg, _, params = _decode_setup(reference, "emulate", cim_off=True)
    model = get_model(tcfg)
    tokens = torch.from_numpy(np.array(reference["tokens"]))
    extra = None if tcfg.family == "llava" else _extra(reference)
    full = model.forward(params, tokens, tcfg, extra)
    cache = model.init_cache(tcfg, B, T + 4, device=CPU)
    if tcfg.family == "whisper":
        cache["enc_out"] = t_whisper.encode(params, extra, tcfg)
    outs = []
    for t in range(T):
        lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1], tcfg)
        outs.append(lg[:, 0])
    rel = float((full - torch.stack(outs, dim=1)).abs().max()
                / full.abs().max())
    assert rel < 5e-3, rel
