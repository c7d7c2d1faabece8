#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (each prints one line or a few; any failed check exits non-zero):

1. the device, and ``nvidia-smi``'s name and power limit;
2. builds the hand-written kernel ``src/repro_torch/csrc/cim_matmul.cu``;
3. holds the kernel against its plain PyTorch version on random inputs
   (dense, occupancy skip with dead columns and dead blocks, nibble
   planes, psum_bits 1/4/8, psum_quant off, int8 and uint8 activations,
   ragged M and N, conv 3x3/1x1 at stride 1/2, SAME/VALID);
4. the main path: ResNet-20 at full width (16, 32, 64; 32x32; 10
   classes) with the paper's CIFAR-10 settings, initialised from a seed,
   calibrated on one batch, packed at int8 and int4, answering batches of
   256 images in deploy mode. Deploy logits are held against emulate
   logits, the kernel's launch counters against 20 convs per forward,
   and the kernel is timed at the main path's shapes beside its plain
   version and its bound;
5. ResNet-18 (widths 64..512, 32x32) one deploy forward per pack dtype
   against emulate at batch 64;
6. a JSON line per kernel, the card's name and power limit, and the
   final JSON line.

Tolerances: the kernel and its plain version add the same float32 terms
in the same order with the same roundings, so they are expected to agree
bit for bit; the gate is rtol 1e-5 / atol 1e-4, the reference's own
kernel-vs-oracle tolerance. Deploy against emulate is gated at 1e-4 as in
``tests/test_cim_conv_deploy.py``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet: HBM3 rate and dense int8 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
KERNEL_TOL = dict(rtol=1e-5, atol=1e-4)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BATCH = 256
REQUESTS = 3                      # deploy forwards per pack dtype


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}; "
          f"count {torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    ptxas = [ln.strip() for ln in _build.build_log.get("cim_matmul", "")
             .splitlines() if "registers" in ln or "spill" in ln]
    print(f"phase 2 build: cim_matmul.cu in {time.perf_counter() - t0:.1f} s; "
          f"ptxas: {' | '.join(ptxas[:6]) or 'already built'}", flush=True)

    errs = {"cim_matmul": 0.0, "cim_conv": 0.0}

    # 3. kernel against its plain version
    n_cases = phase3_kernel_cases(torch, dev, errs)
    print(f"phase 3 kernel vs plain: {n_cases} cases pass; max |kernel - "
          f"plain| cim_matmul {errs['cim_matmul']!r}, cim_conv "
          f"{errs['cim_conv']!r}", flush=True)

    # 4. the main path: packed ResNet-20 inference
    timings = phase4_resnet20(torch, dev, errs)

    # 5. ResNet-18
    phase5_resnet18(torch, dev)

    # 6. results
    kernels = []
    for name, src, replaces in (
            ("cim_matmul", "src/repro_torch/csrc/cim_matmul.cu",
             "src/repro/kernels/cim_matmul.py:160"),
            ("cim_conv", "src/repro_torch/csrc/cim_matmul.cu",
             "src/repro/kernels/cim_conv.py:60")):
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": timings["launches"][name],
            "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def _compare(torch, got, want, name, what, errs):
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{name} {what}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
          "or non-finite output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    errs[name] = max(errs[name], err)
    check(bool(torch.allclose(got, want, **KERNEL_TOL)),
          f"{name} {what}: max |kernel - plain| = {err!r}")


def phase3_kernel_cases(torch, dev, errs) -> int:
    from repro_torch.core.nibble import (occupancy_map, pack_nibbles,
                                         unpack_nibbles)
    from repro_torch.kernels import ref
    from repro_torch.kernels.cim_conv import cim_conv_cuda
    from repro_torch.kernels.cim_matmul import cim_matmul_cuda

    g = torch.Generator().manual_seed(0)
    n_cases = 0
    # (M, kt, rows, N, unsigned, nibble groups or 0, occ, psum_bits, quant)
    for m, kt, rows, n, uns, groups, sparse, pb, quant in (
            (4096, 2, 126, 16, False, 0, False, 4, True),
            (4097, 2, 126, 20, False, 0, True, 1, True),
            (1000, 3, 126, 32, True, 9, True, 4, True),
            (777, 1, 128, 64, False, 1, False, 8, True),
            (513, 5, 126, 130, True, 0, True, 4, False),
            (300, 2, 126, 32, False, 0, False, 1, True),
            (257, 37, 126, 512, False, 9, True, 4, True),
            (64, 4, 128, 17, True, 2, True, 8, True)):
        if uns:
            a = torch.randint(0, 256, (m, kt, rows), generator=g,
                              dtype=torch.uint8)
        else:
            a = torch.randint(-8, 8, (m, kt, rows), generator=g,
                              dtype=torch.int8)
        d = torch.randint(-3, 4, (3, kt, rows, n), generator=g,
                          dtype=torch.int8)
        d[:, :, :, 3:9] = 0                    # dead columns
        d[1, 0] = 0                            # a fully dead (split, tile)
        occ = occupancy_map(d)
        digits = d
        if groups:
            digits = pack_nibbles(d.reshape(3, kt, groups, rows // groups, n)
                                  ).reshape(3, kt, rows // 2, n)
            check(torch.equal(unpack_nibbles(digits, groups=groups), d),
                  "nibble round trip")
        amax = 255 if uns else 8
        s_p = 0.5 + torch.rand((3, kt, n), generator=g) * amax * rows ** 0.5
        deq = torch.randn((3, kt, n), generator=g) * 0.1
        a, d, digits, occ, s_p, deq = (x.to(dev) for x in (
            a, d, digits, occ, s_p, deq))
        got = cim_matmul_cuda(a, digits, s_p, deq, occ if sparse else None,
                              psum_bits=pb, psum_quant=quant,
                              nibble_groups=max(groups, 1))
        want = ref.cim_matmul_ref(a, d, s_p, deq, psum_bits=pb,
                                  psum_quant=quant)
        torch.cuda.synchronize()
        _compare(torch, got, want, "cim_matmul",
                 f"M={m} kt={kt} rows={rows} N={n} uint8={uns} "
                 f"nibble={groups} occ={sparse} psum_bits={pb} quant={quant}",
                 errs)
        n_cases += 1

    for kh, stride, padding, nibble, sparse, pb in (
            (3, 1, "SAME", False, True, 4), (3, 2, "SAME", True, True, 4),
            (1, 2, "SAME", True, False, 8), (3, 1, "VALID", False, False, 1),
            (1, 1, "VALID", True, True, 1), (3, 2, "VALID", True, True, 4)):
        cpa = 128 // (kh * kh)
        c_in, c_out, kt = 2 * cpa + 3, 48, 3
        a = torch.randint(0, 8, (8, 17, 15, c_in), generator=g,
                          dtype=torch.int8)
        d6 = torch.randint(-1, 2, (3, kt, kh, kh, cpa, c_out), generator=g,
                           dtype=torch.int8)
        d6[:, -1, :, :, 3:] = 0                # padded channel slots
        d6[..., 5:9] = 0                       # dead output channels
        occ = occupancy_map(d6, conv=True)
        rows = kh * kh * cpa
        logical = d6.reshape(3, kt, rows, c_out)
        digits = (pack_nibbles(d6).reshape(3, kt, rows // 2, c_out) if nibble
                  else logical)
        s_p = 0.5 + torch.rand((3, kt, c_out), generator=g) * 20
        deq = torch.randn((3, kt, c_out), generator=g) * 0.1
        a, logical, digits, occ, s_p, deq = (x.to(dev) for x in (
            a, logical, digits, occ, s_p, deq))
        geo = dict(kh=kh, kw=kh, stride=stride, padding=padding,
                   c_per_array=cpa, psum_bits=pb)
        got = cim_conv_cuda(a, digits, s_p, deq, occ if sparse else None,
                            **geo)
        want = ref.cim_conv_ref(a, logical, s_p, deq, **geo)
        torch.cuda.synchronize()
        _compare(torch, got, want, "cim_conv",
                 f"{kh}x{kh} stride {stride} {padding} nibble={nibble} "
                 f"occ={sparse} psum_bits={pb}", errs)
        n_cases += 1
    return n_cases


# ---------------------------------------------------------------------------
# phases 4 and 5
# ---------------------------------------------------------------------------

def paper_cim(**kw):
    """Paper Table II CIFAR-10 settings (as benchmarks/common.py): 3-bit
    weights on 1-bit cells, 3-bit unsigned activations, 4-bit partial
    sums, 128x128 arrays, column-wise weight and psum scales."""
    from repro_torch.core.cim_linear import CIMConfig
    return CIMConfig(enabled=True, mode="emulate", weight_bits=3, cell_bits=1,
                     act_bits=3, psum_bits=4, array_rows=128, array_cols=128,
                     weight_granularity="column", psum_granularity="column",
                     act_signed=False, **kw)


def _events_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(op, m: int, out_elems: int, a_bytes: int):
    """(bytes time, ops time) in ms: each input read once, the output
    written once; int8 MACs (2 ops) of the occupied planes only."""
    rows = op["c_per_array"] * op["kh"] * op["kw"]
    s, kt, n = op["s_p"].shape
    occ = op["occ"]
    live = int(occ.sum()) if occ is not None else s * kt * n
    nbytes = (a_bytes + op["digits"].numel() + (occ.numel() if occ is not None
                                                 else 0)
              + 4 * (op["s_p"].numel() + op["deq"].numel()) + 4 * out_elems)
    ops = 2 * m * rows * live
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT8_OPS_PER_S


def _time_layers(torch, model_cfg, packed, taps, errs, reps: int):
    """Times both kernel wrappers and their plain versions on the operands
    the deploy forward gave each CIM conv; returns per-kernel sums over
    one forward and prints one line per layer."""
    from repro_torch.core.cim_conv import conv_deploy_operands
    from repro_torch.core.nibble import unpack_nibbles
    from repro_torch.kernels import ref
    from repro_torch.kernels.cim_conv import cim_conv_cuda
    from repro_torch.kernels.cim_matmul import cim_matmul_cuda
    from repro_torch.models.resnet import conv_layer_names

    cim = model_cfg.cim
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
               "ops_ms": 0.0} for k in ("cim_matmul", "cim_conv")}
    for name, stride in conv_layer_names(model_cfg):
        blk, layer = name.split(".")
        op = conv_deploy_operands(taps[name], packed[blk][layer], cim)
        kh, kw, cpa = op["kh"], op["kw"], op["c_per_array"]
        groups = kh * kw
        nibble = op["digits"].dtype == torch.uint8
        logical = (unpack_nibbles(op["digits"], groups=groups) if nibble
                   else op["digits"])
        geo = dict(kh=kh, kw=kw, stride=stride, padding="SAME",
                   c_per_array=cpa, psum_bits=cim.psum_bits,
                   psum_quant=cim.psum_quant)
        kt = op["digits"].shape[1]
        patches = ref.extract_conv_patches(op["a_int"], kh, kw, stride, "SAME",
                                           kt, cpa)
        b, ho, wo = patches.shape[:3]
        a_t = patches.reshape(b * ho * wo, kt, -1)
        n = op["digits"].shape[-1]
        mq = dict(psum_bits=cim.psum_bits, psum_quant=cim.psum_quant)
        calls = {
            "cim_matmul": (
                lambda: cim_matmul_cuda(a_t, op["digits"], op["s_p"],
                                        op["deq"], op["occ"],
                                        nibble_groups=groups, **mq),
                lambda: ref.cim_matmul_ref(a_t, logical, op["s_p"], op["deq"],
                                           **mq),
                a_t.numel()),
            "cim_conv": (
                lambda: cim_conv_cuda(op["a_int"], op["digits"], op["s_p"],
                                      op["deq"], op["occ"], **geo),
                lambda: ref.cim_conv_ref(op["a_int"], logical, op["s_p"],
                                         op["deq"], **geo),
                op["a_int"].numel()),
        }
        line = []
        for kname, (kern, plain, a_bytes) in calls.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            _compare(torch, got, want, kname, f"{name} at the main path's "
                     "shapes", errs)
            ms = _events_ms(torch, kern, reps)
            plain_ms = _events_ms(torch, plain, max(2, reps // 4), warmup=1)
            bytes_ms, ops_ms = _bound(op, b * ho * wo, b * ho * wo * n,
                                      a_bytes)
            t = tot[kname]
            t["ms"] += ms
            t["plain_ms"] += plain_ms
            t["bound_ms"] += max(bytes_ms, ops_ms)
            t["bytes_ms"] += bytes_ms
            t["ops_ms"] += ops_ms
            line.append(f"{kname} {ms:.4f} ms (plain {plain_ms:.4f}, bound "
                        f"{max(bytes_ms, ops_ms):.5f})")
        print(f"  {name}: M={b * ho * wo} kt={kt} rows={kh * kw * cpa} "
              f"N={n} nibble={nibble}: " + "; ".join(line), flush=True)
    for t in tot.values():
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else \
            "operations"
    return tot


def phase4_resnet20(torch, dev, errs):
    from repro_torch.api import pack_model
    from repro_torch.data.pipeline import make_image_dataset
    from repro_torch.kernels.cim_conv import cim_conv_cuda
    from repro_torch.kernels.cim_matmul import cim_matmul_cuda
    from repro_torch.models import resnet

    cim = paper_cim()
    cfg = resnet.ResNetConfig(name="resnet20-cifar10", depth=20, n_classes=10,
                              widths=(16, 32, 64), in_hw=32, cim=cim)
    n_convs = len(resnet.conv_layer_names(cfg))
    check(n_convs == 20, f"ResNet-20 has {n_convs} CIM convs, expected 20")
    x_all, _ = make_image_dataset(n_classes=10, hw=32,
                                  n=BATCH * (REQUESTS + 1), seed=0)
    batches = [torch.as_tensor(x_all[i * BATCH:(i + 1) * BATCH], device=dev)
               for i in range(REQUESTS + 1)]
    t0 = time.perf_counter()
    params, state = resnet.init(0, cfg)
    params = resnet.calibrate(params, state, batches[0], cfg)
    packed = {dt: pack_model(params, cim.replace(pack_dtype=dt))
              for dt in ("int8", "int4")}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dcfg = dataclasses.replace(cfg, cim=cim.replace(mode="deploy"))
    requests = batches[1:]
    want = [resnet.forward(params, state, xb, cfg, train=False)[0]
            for xb in requests]

    # the main path: only these deploy forwards may move the counters
    cim_matmul_cuda.launches = 0
    cim_conv_cuda.launches = 0
    got, ms = {}, {}
    for dt in ("int8", "int4"):
        got[dt], ms[dt] = [], []
        for xb in requests:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y, _ = resnet.forward(packed[dt], state, xb, dcfg, train=False)
            end.record()
            got[dt].append(y)
            ms[dt].append((start, end))
    torch.cuda.synchronize()
    launches = {"cim_matmul": cim_matmul_cuda.launches,
                "cim_conv": cim_conv_cuda.launches}
    forwards = 2 * len(requests)
    for k, v in launches.items():
        check(v == n_convs * forwards, f"{k} launched {v} times in "
              f"{forwards} forwards, expected {n_convs * forwards}")
    worst = 0.0
    for dt in ("int8", "int4"):
        for y, w in zip(got[dt], want):
            check(y.shape == (BATCH, 10) and bool(torch.isfinite(y).all()),
                  f"{dt} deploy logits: shape {tuple(y.shape)} or non-finite")
            worst = max(worst, float((y - w).abs().max()))
            check(bool(torch.allclose(y, w, **LOGIT_TOL)),
                  f"{dt} deploy logits vs emulate: max diff "
                  f"{float((y - w).abs().max())!r}")
        ms[dt] = [s.elapsed_time(e) for s, e in ms[dt]]
    print(f"phase 4 ResNet-20 (widths 16/32/64, 32x32, batch {BATCH}): set-up "
          f"(init, calibrate, 2 packs) {setup_s:.2f} s; {forwards} deploy "
          f"forwards; ms per batch int8 {[round(v, 3) for v in ms['int8']]}, "
          f"int4 {[round(v, 3) for v in ms['int4']]}; max |deploy - emulate| "
          f"{worst!r}; launches {launches} = 20 x {forwards}", flush=True)

    # per-kernel times at the main path's shapes, outside the counted run
    timings = {"launches": launches}
    for dt in ("int8", "int4"):
        _, _, taps = resnet.forward(packed[dt], state, requests[0], dcfg,
                                    train=False, return_taps=True)
        print(f"phase 4 per-layer times, {dt} planes (CUDA events):",
              flush=True)
        tot = _time_layers(torch, cfg, packed[dt], taps, errs, reps=20)
        for k, t in tot.items():
            print(f"phase 4 {k} {dt}: {t['ms']:.4f} ms per forward (20 "
                  f"launches), plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.5f} ms by {t['bound_by']} (bytes "
                  f"{t['bytes_ms']:.5f}, ops {t['ops_ms']:.5f})", flush=True)
        if dt == "int8":
            timings.update(tot)
    return timings


def phase5_resnet18(torch, dev) -> None:
    from repro_torch.api import pack_model
    from repro_torch.data.pipeline import make_image_dataset
    from repro_torch.models import resnet

    cim = paper_cim()
    cfg = resnet.ResNetConfig(name="resnet18", depth=18, n_classes=10,
                              in_hw=32, cim=cim)
    x, _ = make_image_dataset(n_classes=10, hw=32, n=128, seed=1)
    xc, xb = (torch.as_tensor(v, device=dev) for v in (x[:64], x[64:]))
    params, state = resnet.init(1, cfg)
    params = resnet.calibrate(params, state, xc, cfg)
    want, _ = resnet.forward(params, state, xb, cfg, train=False)
    dcfg = dataclasses.replace(cfg, cim=cim.replace(mode="deploy"))
    diffs = {}
    for dt in ("int8", "int4"):
        y, _ = resnet.forward(pack_model(params, cim.replace(pack_dtype=dt)),
                              state, xb, dcfg, train=False)
        check(y.shape == (64, 10) and bool(torch.isfinite(y).all()),
              f"ResNet-18 {dt} logits: shape or non-finite")
        diffs[dt] = float((y - want).abs().max())
        check(bool(torch.allclose(y, want, **LOGIT_TOL)),
              f"ResNet-18 {dt} deploy vs emulate: max diff {diffs[dt]!r}")
    print(f"phase 5 ResNet-18 (widths 64..512, 32x32, batch 64, k_tiles up "
          f"to 37): max |deploy - emulate| {diffs}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
