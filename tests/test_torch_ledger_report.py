"""The port's ledger, report and perf tools (``launch/ledger.py``,
``launch/report.py``, ``launch/perf.py``).

- The ledger over qwen3-0.6b's cells on a (2, 2) mesh: one record a cell
  keyed ``arch|shape``, the skip from ``cell_status``, the fit as a bound
  read from the record (``fit_bound_gb``), and a rerun that counts nothing
  again (incremental).
- Given a ledger and a perf list in the reference's format (``fits_16gb``,
  ``compile_s``, the HLO's collective kinds), written here, both
  packages' ``report`` render the same tables; the port's own records
  render with the bound they carry.
- Every ``perf.EXPERIMENTS`` variant counts on a reduced cell.
"""
import dataclasses
import json

import pytest

from repro.launch import report as j_report
from repro_torch.configs.base import SHAPES
from repro_torch.launch import ledger, perf, report
from repro_torch.launch.mesh import MeshShape

MESH_22 = MeshShape((2, 2), ("data", "model"))


def _ref_record(kind, compute, memory, coll, peak_gb, fits):
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": coll}
    return {"status": "ok",
            "production": {
                "kind": kind, "compile_s": 41.2, "lower_s": 3.0,
                "chips": 256,
                "per_device": {"collective_ops": 17,
                               "bytes_per_device_peak": peak_gb * 1e9},
                "collectives": {"all-gather": 3.5e9, "all-reduce": 2e6,
                                "reduce-scatter": 7.7e12,
                                "all-to-all": 0, "collective-permute": 512}},
            "multipod": {"compile_s": 60.5, "peak_gb": peak_gb},
            "roofline": {**terms, "dominant": max(terms, key=terms.get),
                         "useful_ratio": 0.4321, "peak_hbm_gb": peak_gb,
                         "fits_16gb": fits, "source": "account"}}


REF_LEDGER = {
    "llama3-8b|train_4k": _ref_record("train", 2.5, 0.004, 1.7e-5, 12.3,
                                      True),
    "llama3-8b|decode_32k": _ref_record("decode", 3e-4, 0.07, 0.002, 31.0,
                                        False),
    "llama3-8b|long_500k": {"status": "skipped",
                            "reason": "skip: quadratic softmax attention"},
    "qwen3-0.6b|prefill_32k": {"status": "error", "error": "boom"},
}
REF_PERF = [
    {"label": "baseline", "status": "ok", "peak_hbm_gb": 9.5,
     "useful_ratio": 0.25, "roofline": {"compute_s": 1.5, "memory_s": 0.2,
                                        "collective_s": 3e-7,
                                        "dominant": "compute_s"}},
    {"label": "broken", "status": "error", "error": "ValueError: " + "x" * 80},
]


def test_reports_of_reference_format_are_identical():
    assert report.render(REF_LEDGER) == (
        "## Roofline\n\n" + j_report.roofline_table(REF_LEDGER)
        + "\n\n## Dry-run collectives\n\n"
        + j_report.dryrun_table(REF_LEDGER))
    assert report.roofline_table(REF_LEDGER) == \
        j_report.roofline_table(REF_LEDGER)
    assert report.dryrun_table(REF_LEDGER) == \
        j_report.dryrun_table(REF_LEDGER)
    assert report.render(REF_PERF) == j_report.perf_table(REF_PERF)
    for x in (0.5, 2e3, 3e6, 4e9, 5e12):
        assert report.fmt_b(x) == j_report.fmt_b(x)
        assert report.fmt_s(x * 1e-9) == j_report.fmt_s(x * 1e-9)


@pytest.fixture(scope="module")
def port_ledger(tmp_path_factory):
    out = tmp_path_factory.mktemp("ledger") / "ledger.json"
    argv = ["--only", "qwen3-0.6b", "--mesh", "2x2", "--out", str(out)]
    assert ledger.main(argv) == 0
    first = out.read_text()
    assert ledger.main(argv) == 0           # every cell done: nothing runs
    assert out.read_text() == first
    return json.loads(first)


def test_ledger_records_and_skips(port_ledger):
    assert sorted(port_ledger) == [f"qwen3-0.6b|{s}" for s in sorted(SHAPES)]
    skip = port_ledger["qwen3-0.6b|long_500k"]
    assert skip["status"] == "skipped" and "quadratic" in skip["reason"]
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = port_ledger[f"qwen3-0.6b|{shape}"]
        assert rec["status"] == "ok" and rec["mesh"] == "2x2"
        pd, r = rec["production"]["per_device"], rec["roofline"]
        assert pd["hlo_flops"] == rec["account"]["hlo_flops"] > 0
        assert pd["bytes_per_device_argument"] > 0
        assert r["fit_bound_gb"] == 80.0 and "fits_16gb" not in r
        assert rec["production"]["kind"] == SHAPES[shape].kind
        assert rec["production"]["count_s"] < 60


def test_port_records_render_with_their_bound(port_ledger):
    text = report.render(port_ledger)
    head = text.splitlines()[2]
    assert head.endswith("| fits 80GB |")
    assert "skip: quadratic softmax attention at 524288" in text
    assert "| arch | shape | count | coll ops | AG | AR | RS | BC | G |" \
        in text
    assert text.count("| qwen3-0.6b |") == 4 + 3


VARIANTS = [(cell, label) for cell, exp in sorted(perf.EXPERIMENTS.items())
            for label, _ in exp["variants"]]


@pytest.mark.parametrize("cell,label", VARIANTS,
                         ids=[f"{c}-{v}" for c, v in VARIANTS])
def test_every_perf_variant_counts_on_a_reduced_cell(cell, label):
    exp = perf.EXPERIMENTS[cell]
    kw = dict(exp["variants"])[label]
    shape = dataclasses.replace(SHAPES[exp["shape"]], seq_len=16,
                                global_batch=8)
    rec = perf.measure(exp["arch"], shape, label=label, mesh=MESH_22,
                       reduced=True, **kw)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert rec["collective_bytes"] > 0
    assert set(rec["roofline"]) == {"compute_s", "memory_s",
                                    "collective_s", "dominant"}
