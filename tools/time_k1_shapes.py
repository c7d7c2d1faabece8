#!/usr/bin/env python3
"""Time the CIM matmul kernel (K1, ``cim_matmul_cuda``) at the down
projections and other linears of the served transformers, and the MoE
experts kernel (K6) at moonshot's expert banks, on the card, for the
checkout whose ``src`` is first on ``PYTHONPATH``.

    PYTHONPATH=src python3 tools/time_k1_shapes.py

Each shape (the serving launcher's S = 2 splits and 6-bit partial sums,
int8 codes, the occupancy map passed as the deploy path does) is launched
once and held against the plain version bit for bit, then timed with
``chip_smoke.py``'s helpers: the device time of a CUDA-graph replay of 20
launches, and the eager CUDA-event time beside it. A launch the kernel
refuses prints its error instead. One JSON line per shape, then the
card's name and power limit. Run it for two checkouts in one call
(parent, change, change, parent) to compare them on one card.
"""
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.append(str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (timing and operand helpers)

#: K1 (name, M, kt, N, nibble planes): prefill (M 512 = 8 x 64 tokens) and
#: decode (M 8) of moonshot-v1-16b-a3b's attention projections (kt 16),
#: dense up projection (kt 16, N 11264) and down projection (kt 88),
#: llama3-8b's down projection (kt 112), deepseek-v3's MLA output
#: projection (kt 128) and dense down projection (kt 144), and MLA's
#: wkv_a (kt 56, N 576)
SHAPES = (
    ("moonshot wq", 512, 16, 2048, 0), ("moonshot wq", 8, 16, 2048, 0),
    ("moonshot wu", 512, 16, 11264, 0),
    ("moonshot wd", 512, 88, 2048, 0), ("moonshot wd", 8, 88, 2048, 0),
    ("llama3 wd", 512, 112, 4096, 0), ("llama3 wd", 8, 112, 4096, 0),
    ("deepseek wo", 512, 128, 7168, 0), ("deepseek wo", 8, 128, 7168, 0),
    ("deepseek wd", 512, 144, 7168, 0), ("deepseek wd", 512, 144, 7168, 1),
    ("deepseek wd", 8, 144, 7168, 0), ("deepseek wkv_a", 512, 56, 576, 0),
)
#: K6 (name, experts, capacity, kt, N): moonshot's 64-expert banks, up
#: (kt 16, N 1408) and down (kt 11, N 2048), at a prefill's capacity and
#: a decode step's
EXPERT_SHAPES = (
    ("moonshot experts up", 64, 64, 16, 1408),
    ("moonshot experts down", 64, 64, 11, 2048),
    ("moonshot experts up", 64, 8, 16, 1408),
)
REPS = 20


def k1_operands(g, m, kt, n, nibble):
    from repro_torch.core.nibble import occupancy_map, pack_nibbles
    a = torch.randint(-128, 128, (m, kt, 128), generator=g, dtype=torch.int8)
    d = torch.randint(-2, 2, (2, kt, 128, n), generator=g, dtype=torch.int8)
    s_p = 20 + torch.rand((2, kt, n), generator=g) * 60
    deq = torch.randn((2, kt, n), generator=g) * 0.01
    planes = pack_nibbles(d) if nibble else d
    return [x.cuda() for x in (a, d, planes, s_p, deq, occupancy_map(d))]


def k1_case(g, name, m, kt, n, nibble):
    from repro_torch.kernels import ref
    from repro_torch.kernels.cim_matmul import cim_matmul_cuda
    a, d, planes, s_p, deq, occ = k1_operands(g, m, kt, n, nibble)
    row = {"shape": name, "M": m, "kt": kt, "N": n, "nibble": nibble}
    return row, (lambda: cim_matmul_cuda(a, planes, s_p, deq, occ,
                                         psum_bits=6)), \
        (lambda: ref.cim_matmul_ref(a, d, s_p, deq, psum_bits=6))


def k6_case(g, name, e, c, kt, n):
    from repro_torch.kernels import ref
    from repro_torch.kernels.cim_matmul import cim_matmul_experts_cuda
    a, d, _, _, s_p, deq = (x.cuda() for x in chip_smoke._experts_operands(
        torch, g, e, c, kt, 128, n, False))
    counts = torch.randint(0, c + 1, (e,), generator=g,
                           dtype=torch.int32).cuda()
    row = {"shape": name, "E": e, "C": c, "kt": kt, "N": n}
    return row, (lambda: cim_matmul_experts_cuda(a, d, s_p, deq,
                                                 counts=counts,
                                                 psum_bits=6)), \
        (lambda: ref.cim_matmul_experts_ref(a, d, s_p, deq, counts=counts,
                                            psum_bits=6))


def main() -> int:
    if not torch.cuda.is_available():
        print("time_k1_shapes: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    g = torch.Generator().manual_seed(0)
    cases = ([(k1_case, s) for s in SHAPES]
             + [(k6_case, s) for s in EXPERT_SHAPES])
    for make, shape in cases:
        row, call, plain = make(g, *shape)
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
