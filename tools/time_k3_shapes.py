#!/usr/bin/env python3
"""Run the CIM conv kernel (K3, ``cim_conv_cuda``) at the zoo's front-end
conv shapes on the card, for the checkout whose ``src`` is first on
``PYTHONPATH``, and time it.

    PYTHONPATH=src python3 tools/time_k3_shapes.py

Shapes, at ``chip_smoke.py`` phase 14's batch: whisper-small's stem,
conv1 (1x3, stride 1, SAME, 80 mel bins -> 768 on 3000 frames, H = 1)
and conv2 (1x3, stride 2, SAME, 768 -> 768: pads (0, 1) on the even
width), at c_per_array 42 (126-row tiles); llava's patch embed (14x14,
stride 14, VALID, 3 -> 1024 on 336 x 336 images) at c_per_array 1
(196-row tiles); the stems of ResNet-20 (batch 256, 3 -> 16) and
ResNet-18 (batch 64, 3 -> 64), 3x3 SAME on 32 x 32 x 3 at c_per_array
14. The serving launcher's S = 2 splits (digits -2..1),
6-bit partial sums, int8 codes, the occupancy map as the deploy path
passes it. Each shape is launched once and held against the plain
version bit for bit, then timed with ``chip_smoke.py``'s helpers (the
device time of a CUDA-graph replay of 20 launches, eager CUDA events
beside it) next to its bound; a launch the kernel refuses prints its
error instead. One JSON line per shape, then the card's name and power
limit. Run it for two checkouts in one call (parent, change, change,
parent) to compare them on one card.

The two stems of the ResNets (3 channels, 3x3, c_per_array 14) and
llava's patch embed take K3's packed segments, whisper's convs its staged
loads (``prepare`` in ``csrc/cim_mma.cuh``: packed where that at least
halves the staged tile row's k-steps). ``--loader staged`` or
``--loader packed`` runs the same shapes on a copy of the package under
``build/k3_<loader>`` whose rule is replaced: staged loads wherever the
staged tile row fits in 1 KB (every shape but the patch embed, which
only packed segments fit), or packed segments for every conv outside the
direct loads. So the two loaders are timed on the same shapes:

    PYTHONPATH=src python3 tools/time_k3_shapes.py --loader staged
    PYTHONPATH=src python3 tools/time_k3_shapes.py --loader packed
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.append(str(ROOT))
import chip_smoke  # noqa: E402  (timing and bound helpers)

#: (name, batch, H, W, C_in, kh, kw, stride, padding, c_per_array, C_out)
SHAPES = (
    ("whisper conv1", 8, 1, 3000, 80, 1, 3, 1, "SAME", 42, 768),
    ("whisper conv2", 8, 1, 3000, 768, 1, 3, 2, "SAME", 42, 768),
    ("llava patch embed", 4, 336, 336, 3, 14, 14, 14, "VALID", 1, 1024),
    ("resnet-20 stem", 256, 32, 32, 3, 3, 3, 1, "SAME", 14, 16),
    ("resnet-18 stem", 64, 32, 32, 3, 3, 3, 1, "SAME", 14, 64),
)
REPS = 20


def k3_case(g, name, b, h, w, c_in, kh, kw, stride, padding, cpa, n):
    from repro_torch.core.nibble import occupancy_map
    from repro_torch.kernels import ref
    from repro_torch.kernels.cim_conv import cim_conv_cuda
    kt = -(-c_in // cpa)
    a = torch.randint(-128, 128, (b, h, w, c_in), generator=g,
                      dtype=torch.int8)
    d6 = torch.randint(-2, 2, (2, kt, kh, kw, cpa, n), generator=g,
                       dtype=torch.int8)
    d = d6.reshape(2, kt, kh * kw * cpa, n)
    s_p = 20 + torch.rand((2, kt, n), generator=g) * 60
    deq = torch.randn((2, kt, n), generator=g) * 0.01
    a, d, s_p, deq, occ = (x.cuda() for x in (
        a, d, s_p, deq, occupancy_map(d6, conv=True)))
    kw_ = dict(kh=kh, kw=kw, stride=stride, padding=padding,
               c_per_array=cpa, psum_bits=6)
    row = {"shape": name, "input": [b, h, w, c_in], "kernel": [kh, kw],
           "stride": stride, "c_per_array": cpa, "kt": kt, "N": n}
    bound = chip_smoke._conv_bound(torch, a, d, occ, s_p, deq, kw_)
    row["bound_ms"] = max(bound)
    return row, (lambda: cim_conv_cuda(a, d, s_p, deq, occ, **kw_)), \
        (lambda: ref.cim_conv_ref(a, d, s_p, deq, **kw_))


#: the loader rule of ``prepare`` in ``csrc/cim_mma.cuh``, and its
#: replacement for each ``--loader``
RULE = """  g.packed = kImplicit && !g.direct &&
             2 * ((packed_k + 31) / 32) <= (staged_k + 31) / 32;
"""
RULES = {"staged": "  g.packed = kImplicit && !g.direct && staged_k > 1024;\n",
         "packed": "  g.packed = kImplicit && !g.direct;\n"}


def with_loader(loader: str) -> int:
    """Copy the package to ``build/k3_<loader>`` with the loader rule
    replaced by ``RULES[loader]`` and run this script on the copy."""
    dst = ROOT / "build" / f"k3_{loader}" / "src"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    core = dst / "repro_torch" / "csrc" / "cim_mma.cuh"
    text = core.read_text()
    if text.count(RULE) != 1:
        print(f"time_k3_shapes: the loader rule not found once in {core}",
              file=sys.stderr)
        return 1
    core.write_text(text.replace(RULE, RULES[loader]))
    env = dict(os.environ, PYTHONPATH=str(dst))
    return subprocess.run([sys.executable, __file__], env=env).returncode


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--loader"] and args[1:2] and args[1] in RULES:
        return with_loader(args[1])
    if args:
        print(f"usage: {sys.argv[0]} [--loader staged|packed]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("time_k3_shapes: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    g = torch.Generator().manual_seed(0)
    for shape in SHAPES:
        row, call, plain = k3_case(g, *shape)
        row["package"] = str(repro_torch.__file__)
        try:
            got = call()
            torch.cuda.synchronize()
        except RuntimeError as e:
            row["refused"] = str(e)
            print(json.dumps(row), flush=True)
            continue
        row["max_abs_err"] = float((got - plain()).abs().max())
        row["ms"] = chip_smoke._graph_ms(torch, call, REPS)
        row["events_ms"] = chip_smoke._events_ms(torch, call, REPS)
        print(json.dumps(row), flush=True)
        del call, plain, got
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
