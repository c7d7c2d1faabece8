"""Rank bodies of the port's column-parallel tests (imports no JAX).

Each test file spawns its gloo ranks once (``run_ranks``): every rank
joins a CPU process group on a free localhost port, builds a
``("model",)`` mesh, computes every case of the file single-device (no
session mesh) and sharded, and saves its results to ``rank<r>.pt`` under
the file's output directory; the cases of the file then compare them.
Inputs that come from the JAX package (theta fields, artifacts the
reference saved) are written to that directory by the parent first.
"""
from __future__ import annotations

import os

import numpy as np
import torch

CPU = "cpu"
CIM = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
           act_bits=8, psum_bits=6, array_rows=32, array_cols=32)
SIGMA_LINEAR, SIGMA_CONV = 0.2, 0.15


def run_ranks(body, world: int, out_dir: str, timeout_s: float = 120.0,
              device: str = CPU):
    """Spawn ``world`` gloo ranks on ``device`` (the CPU, or ranks sharing
    one card) running ``body(rank, world, mesh, out_dir)`` and join them
    within ``timeout_s``; returns each rank's saved results."""
    from repro_torch.launch import mesh as lm
    lm.spawn(_rank, world, (world, lm.free_port(), body, out_dir, device),
             timeout_s=timeout_s)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _rank(rank, world, port, body, out_dir, device):
    import torch.distributed as dist

    from repro_torch.launch import mesh as lm
    torch.set_num_threads(2)
    device = lm.init_rank(rank, world, port, backend="gloo", device=device,
                          timeout_s=100)
    try:
        mesh = lm.make_mesh(world, device=device, backend="gloo")
        out = body(rank, world, mesh, out_dir)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def sharded_and_single(fn, mesh, art_params, params):
    """(single, on full planes under the mesh, on the sharded artifact
    under the mesh) of ``fn(params)``."""
    from repro_torch.nn.module import session_mesh
    single = fn(params)
    with session_mesh(mesh):
        return single, fn(params), fn(art_params)


# ---------------------------------------------------------------------------
# tests/test_torch_sharded_ops.py
# ---------------------------------------------------------------------------

def linear_case(n, pack_dtype="int8", use_kernel=True, k=40,
                zero_band=False, mode="deploy"):
    """A calibrated (k, n) CIM linear packed for ``mode`` and its input."""
    from repro_torch import api
    cfg = api.CIMConfig(**CIM, pack_dtype=pack_dtype, use_kernel=use_kernel)
    p = api.init_linear(torch.Generator().manual_seed(0), k, n, cfg,
                        device=CPU)
    if zero_band:                    # dead planes: a band of tile 0 zeroed
        p["w"] = p["w"].clone()
        p["w"][:32, 4:12] = 0.0
    x = torch.from_numpy(np.random.RandomState(1).randn(6, k).astype(
        np.float32))
    p = api.calibrate_linear(x, p, cfg)
    dcfg = cfg.replace(mode=mode)
    return api.pack_linear(p, dcfg), x, dcfg


def conv_case(c_out, pack_dtype="int8", stride=2, padding="SAME",
              array_rows=32, mode="deploy", zero_band=False):
    from repro_torch import api
    cfg = api.CIMConfig(**dict(CIM, array_rows=array_rows), act_signed=False,
                        pack_dtype=pack_dtype)
    p = api.init_conv(torch.Generator().manual_seed(2), 3, 3, 8, c_out, cfg,
                      device=CPU)
    if zero_band:
        p["w"] = p["w"].clone()
        p["w"][:, :, :4, 2:6] = 0.0
    x = torch.relu(torch.from_numpy(np.random.RandomState(3).randn(
        2, 9, 9, 8).astype(np.float32)))
    p = api.calibrate_conv(x, p, cfg, stride=stride, padding=padding)
    dcfg = cfg.replace(mode=mode)
    return api.pack_conv(p, dcfg), x, dcfg


def ops_cases():
    """name -> (kind, case kwargs, forward kwargs, variation tag): the
    counterparts of ``tests/test_serve_sharded.py``'s layer cases."""
    cases = {}
    for n in (24, 22):
        for dt in ("int8", "int4"):
            cases[f"linear_{n}_{dt}"] = ("linear", dict(n=n, pack_dtype=dt),
                                         {}, None)
    cases["linear_oracle"] = ("linear", dict(n=22, use_kernel=False), {},
                              None)
    cases["linear_variation"] = ("linear", dict(n=22), {}, "linear_22")
    cases["linear_nibble_occ"] = ("linear", dict(n=22, pack_dtype="int4",
                                                 k=64, zero_band=True), {},
                                  None)
    cases["linear_nibble_occ_variation"] = (
        "linear", dict(n=22, pack_dtype="int4", k=64, zero_band=True), {},
        "linear_nibble")
    for c in (16, 10):
        for dt in ("int8", "int4"):
            cases[f"conv_{c}_{dt}"] = ("conv", dict(c_out=c, pack_dtype=dt),
                                       dict(stride=2), None)
    cases["conv_valid_stride1"] = ("conv", dict(c_out=10, stride=1,
                                                padding="VALID"),
                                   dict(stride=1, padding="VALID"), None)
    cases["conv_variation"] = ("conv", dict(c_out=10), dict(stride=2),
                               "conv_10")
    cases["conv_nibble_occ"] = ("conv", dict(c_out=10, pack_dtype="int4",
                                             array_rows=36, zero_band=True),
                                dict(stride=2), None)
    cases["linear_adc_free"] = ("linear", dict(n=22, mode="adc_free"), {},
                                None)
    cases["conv_adc_free"] = ("conv", dict(c_out=10, mode="adc_free"),
                              dict(stride=2), None)
    return cases


def theta_shapes():
    """The logical packed shapes the JAX package draws theta over."""
    from repro_torch.kernels.cim_matmul import logical_digits
    out = {}
    for tag, (kind, kw) in {
            "linear_22": ("linear", dict(n=22)),
            "linear_nibble": ("linear", dict(n=22, pack_dtype="int4", k=64,
                                             zero_band=True)),
            "conv_10": ("conv", dict(c_out=10))}.items():
        d = (linear_case if kind == "linear" else conv_case)(**kw)[0][
            "w_digits"]
        # the int8 conv planes are logical (S, kt, kh, kw, cpa, C_out)
        out[tag] = tuple((logical_digits(d) if kind == "linear" else d).shape)
    return out


def ops_body(rank, world, mesh, out_dir):
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.nn.module import session_mesh
    from repro_torch.obs import adc
    thetas = np.load(os.path.join(out_dir, "theta.npz"))
    results = {}
    for name, (kind, kw, fkw, tag) in ops_cases().items():
        make = linear_case if kind == "linear" else conv_case
        packed, x, dcfg = make(**kw)
        art = api.DeployArtifact(kind=kind, config=dcfg,
                                 params=packed).shard(mesh, device=CPU)
        fwd = api.linear if kind == "linear" else api.conv2d
        extra = dict(fkw, compute_dtype=torch.float32)
        if tag is not None:
            sigma = SIGMA_LINEAR if kind == "linear" else SIGMA_CONV
            extra.update(variation=torch.from_numpy(thetas[tag]),
                         variation_std=sigma)
        results[name] = sharded_and_single(
            lambda p: fwd(x, p, dcfg, **extra), mesh, art.params, packed)
        results[name + "/clean"] = fwd(x, packed, dcfg, **dict(
            fkw, compute_dtype=torch.float32))
        results[name + "/sharded_leaf"] = type(
            art.params["w_digits"]).__name__
    # the ADC collector: totals over the mesh against the single device's
    for kind in ("linear", "conv"):
        packed, x, dcfg = (linear_case(22) if kind == "linear"
                           else conv_case(10))
        # narrower ADC ranges than calibrated, so some conversions clip
        packed = dict(packed, s_p=packed["s_p"] * 0.25)
        fwd = api.linear if kind == "linear" else api.conv2d
        fkw = {} if kind == "linear" else dict(stride=2)
        got = {}
        for where in ("single", "sharded"):
            with adc.sampled():
                if where == "single":
                    y = fwd(x, packed, dcfg, **fkw)
                else:
                    with session_mesh(mesh):
                        y = fwd(x, packed, dcfg, **fkw)
                        summ = adc.summary()
                if where == "single":
                    summ = adc.summary()
            got[where] = (y, summ)
        results[f"adc_{kind}"] = got
    results["col_shards"] = (ops.col_shards(mesh), ops.col_shards(None),
                             ops.col_shards(mesh, "data"))
    return results


# ---------------------------------------------------------------------------
# tests/test_torch_serve_sharded.py and tests/test_torch_mesh.py
# ---------------------------------------------------------------------------

LM_ARCH, MOE_ARCH = "qwen3-0.6b", "moonshot-v1-16b-a3b"
DRIFT = dict(read_sigma=0.02, cell_rate=2e-4, col_rate=1e-3)


def lm_cfg(arch=LM_ARCH, **cim):
    """The reference test's ``_lm_artifact`` config: reduced, 32x32 arrays
    on the plain path, float32."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.cim_linear import CIMConfig
    return get_config(arch, reduced=True, cim=CIMConfig(
        **CIM, use_kernel=False, **cim)).replace(compute_dtype="float32",
                                                 remat=False)


def lm_inputs(vocab):
    rs = np.random.RandomState(0)
    return (torch.from_numpy(rs.randint(0, vocab, (2, 8)).astype(np.int32)),
            np.random.RandomState(0).randint(0, vocab, (2, 8)).astype(
                np.int32))


def _nodes(tree, path=()):
    if isinstance(tree, dict):
        if "w_digits" in tree:
            yield "/".join(path), tree
            return
        for k, v in tree.items():
            yield from _nodes(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _nodes(v, path + (str(i),))


def serve_body(rank, world, mesh, out_dir):
    import dataclasses

    from repro_torch import api
    from repro_torch.core import colshard
    from repro_torch.core.variation import (DriftSchedule, Sampler,
                                            drift_tree)
    from repro_torch.eval.recalibrate import (apply_scale_delta,
                                              fit_scale_delta)
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import session_mesh
    from repro_torch.serve.engine import engine_from_artifact
    res = {}
    path = os.path.join(out_dir, "jax_artifact")
    cfg = lm_cfg()
    model = get_model(cfg)
    single = api.DeployArtifact.load(path, device=CPU)
    sharded = api.DeployArtifact.load(path, mesh=mesh, device=CPU)
    serve_cfg = dataclasses.replace(cfg, cim=single.config)
    toks, prompts = lm_inputs(cfg.vocab)

    # placements: divisible nodes sharded, ragged ones whole, values kept
    place = {}
    for (name, n1), (_, n4) in zip(_nodes(single.params),
                                   _nodes(sharded.params)):
        n = n1["w_digits"].shape[-1]
        cols = colshard.col_range(mesh, "model", n)
        same = all(torch.equal(colshard.localize(v, cols), n4[k].to_local())
                   if colshard.is_col_sharded(n4[k]) else torch.equal(v, n4[k])
                   for k, v in n1.items())
        place[name] = (n, colshard.is_col_sharded(n4["w_digits"]), same)
    res["placements"] = place

    # a save of the sharded artifact: rank 0 writes the unsharded files
    sharded.save(os.path.join(out_dir, "saved_sharded"))
    if rank == 0:
        single.save(os.path.join(out_dir, "saved_single"))

    def fwd(params):
        return model.forward(params, toks, serve_cfg)
    res["logits"] = sharded_and_single(fwd, mesh, sharded.params,
                                       single.params)

    def tokens(**kw):
        t0 = kw.pop("t0", 0)
        eng1 = engine_from_artifact(single, cfg, batch_size=2, max_len=64,
                                    device=CPU, **kw)
        eng1.t = t0
        out1 = eng1.generate_batch(prompts, 6)
        with session_mesh(None):     # engine_from_artifact installs the mesh
            eng4 = engine_from_artifact(path, cfg, mesh=mesh, batch_size=2,
                                        max_len=64, device=CPU, **kw)
            eng4.t = t0
            out4 = eng4.generate_batch(prompts, 6)
            devices = eng4.metrics()["throughput"]["devices"]
        return out1, out4, devices
    res["tokens"] = tokens()
    res["sampled"] = tokens(temperature=1.0, seed=7)

    # drift: the same source and clock give the same realization
    sched = DriftSchedule(**DRIFT)
    res["drift_logits"] = sharded_and_single(
        lambda p: fwd(drift_tree(p, Sampler(7), sched.at(200))), mesh,
        sharded.params, single.params)
    res["drift_tokens"] = tokens(drift_key=Sampler(7), drift_schedule=sched,
                                 t0=150)

    # a ScaleDelta fitted on one device, applied to both placements
    drifted = drift_tree(single.params, Sampler(7), DriftSchedule(
        cell_rate=2e-4, col_rate=1e-3).at(300))
    delta = fit_scale_delta(single, drifted,
                            gen=torch.Generator().manual_seed(3), probes=16)
    recal1 = apply_scale_delta(single, delta)
    recal4 = apply_scale_delta(sharded, delta)
    leaves = {}
    for (name, n1), (_, n4) in zip(_nodes(recal1.params),
                                   _nodes(recal4.params)):
        leaves[name] = {k: (n1[k], colshard.full_leaf(n4[k]),
                            colshard.is_col_sharded(n4[k]))
                        for k in ("s_p", "deq_scale")}
    res["recal"] = (leaves, recal4.meta.get("delta_version"),
                    delta.delta_version)
    res["recal_logits"] = sharded_and_single(fwd, mesh, recal4.params,
                                             recal1.params)

    # moonshot: the packed banks go expert by expert through the sharded
    # dispatch under a mesh; the experts kernel is gated off
    res["moe"] = _moe_case(mesh)
    return res


def _moe_case(mesh):
    from repro_torch import api
    from repro_torch.core import colshard
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params, session_mesh
    cfg = lm_cfg(MOE_ARCH).replace(
        cim=lm_cfg(MOE_ARCH).cim.replace(use_kernel=True))
    model = get_model(cfg)
    art = api.model_artifact(init_params(model.specs(cfg), 0, device=CPU),
                             cfg.cim, device=CPU)
    dcfg = cfg.replace(cim=art.config)
    toks = lm_inputs(cfg.vocab)[0]
    calls = {"experts": 0}
    experts = ops.cim_matmul_experts

    def counted(*a, **kw):
        calls["experts"] += 1
        return experts(*a, **kw)
    ops.cim_matmul_experts = counted
    try:
        single = model.forward(art.params, toks, dcfg)
        k6_single = calls["experts"]
        sharded = art.shard(mesh, device=CPU)
        gathers = colshard.gather_cols.calls
        with session_mesh(mesh):
            got = model.forward(sharded.params, toks, dcfg)
        k6_sharded = calls["experts"] - k6_single
    finally:
        ops.cim_matmul_experts = experts
    banks = sum(colshard.is_col_sharded(v) for node in
                _walk_dicts(sharded.params) for k, v in node.items()
                if k.endswith("_digits") and k != "w_digits")
    return (single, got, k6_single, k6_sharded,
            colshard.gather_cols.calls - gathers, banks)


def _walk_dicts(tree):
    if isinstance(tree, dict):
        yield tree
        for v in tree.values():
            yield from _walk_dicts(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk_dicts(v)


def lm_body(rank, world, mesh, out_dir):
    """The reduced qwen3's logits and engine tokens on ``world`` ranks,
    loaded with ``mesh=`` from the JAX package's artifact."""
    import dataclasses

    from repro_torch import api
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import session_mesh
    from repro_torch.serve.engine import engine_from_artifact
    path = os.path.join(out_dir, "jax_artifact")
    cfg = lm_cfg()
    art = api.DeployArtifact.load(path, mesh=mesh, device=CPU)
    toks, prompts = lm_inputs(cfg.vocab)
    with session_mesh(mesh):
        logits = get_model(cfg).forward(
            art.params, toks, dataclasses.replace(cfg, cim=art.config))
        eng = engine_from_artifact(art, cfg, mesh=mesh, batch_size=2,
                                   max_len=64, device=CPU)
        return logits, eng.generate_batch(prompts, 6)


def cuda_body(rank, world, mesh, out_dir):
    """K1 and K3 on ``world`` gloo ranks sharing one card: each sharded
    layer against the single-device kernel, and the launches each rank
    made on its columns."""
    from repro_torch import api
    from repro_torch.kernels.cim_conv import cim_conv_cuda
    from repro_torch.kernels.cim_matmul import cim_matmul_cuda
    dev = torch.device(mesh.device_type)
    res = {}
    for name, make, fwd, fkw in (
            [(f"linear_{n}_{dt}", lambda n=n, dt=dt: linear_case(n, dt),
              api.linear, {}) for n in (24, 22) for dt in ("int8", "int4")]
            + [(f"conv_{c}_{dt}", lambda c=c, dt=dt: conv_case(c, dt),
                api.conv2d, dict(stride=2))
               for c in (16, 10) for dt in ("int8", "int4")]):
        packed, x, dcfg = make()
        packed = {k: v.to(dev) for k, v in packed.items()}
        x = x.to(dev)
        art = api.DeployArtifact(kind="linear", config=dcfg,
                                 params=packed).shard(mesh, device=dev)
        cim_matmul_cuda.launches = cim_conv_cuda.launches = 0
        out = sharded_and_single(
            lambda p: fwd(x, p, dcfg, compute_dtype=torch.float32, **fkw),
            mesh, art.params, packed)
        res[name] = (tuple(y.cpu() for y in out),
                     (cim_matmul_cuda.launches, cim_conv_cuda.launches))
    return res
