"""The benchmark's files, its arithmetic and its trace reduction, on the
CPU."""
import ast
import re
from pathlib import Path

import pytest

from perfbench import counts, harness, trace

HERE = Path(harness.__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return harness.bench()


def test_benchmark_keys_and_names(bench):
    assert set(bench) == KEYS
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)


@pytest.mark.parametrize("kind", ["configs", "traffic", "workloads"])
def test_data_files_load(bench, kind):
    files = sorted((HERE / kind).glob("*.json"))
    assert files
    for f in files:
        assert isinstance(harness.load_json(f), dict), f


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        harness.config_of(bench, w["config"])
        traffic = harness.load_json(HERE / "traffic" / f"{w['traffic']}.json")
        assert (HERE / "drivers" / f"{traffic['kind']}.py").exists()
        cell = harness.load_json(HERE / "workloads" / f"{w['name']}.json")
        assert cell["limits"]


def test_paths_use_allowed_characters():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(HERE.parent).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_metric_files_match_their_entries(bench):
    declared = {m["name"] for m in bench["per_layer"]}
    on_disk = {p.name[:-3] for p in (HERE / "metrics").glob("*.py")}
    assert declared == on_disk
    for m in bench["per_layer"]:
        mod = harness.metric_module(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == (
            m["unit"], m["layer"], m["moves"], m["source"]), m["name"]


def test_moves_arrows_name_reported_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in cells:
            if harness.reports(m, cell, bench["end_to_end"]):
                assert harness.reports(e2e[m["moves"]], cell), (m, cell)
    for cell in cells:
        ends = [m for m in bench["end_to_end"] if harness.reports(m, cell)]
        assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2
        assert any(harness.reports(m, cell, bench["end_to_end"])
                   for m in bench["per_layer"])


RESNET20 = {"stage_widths": [16, 32, 64], "blocks_per_stage": 3,
            "in_hw": 32, "in_channels": 3, "n_classes": 10,
            "cim": {"weight_bits": 3, "cell_bits": 1, "array_rows": 128}}


def test_counts_by_hand_resnet20():
    convs = counts.cim_convs(RESNET20)
    assert len(convs) == 20
    # 3 splits x (6 convs 16->16 at 32x32 + 13,107,200 MACs in each of
    # stages 1 and 2), x2; the stem 1024*16*27, the FC 64*10, x2
    assert counts.model_ops_per_image(RESNET20) == (
        2 * 3 * (6 * 2_359_296 + 2 * 13_107_200) + 2 * (442_368 + 640))
    assert counts.model_ops_per_image(RESNET20) == 243_107_072
    first = convs[0]                # s0b0.conv1: 3x3, 16 -> 16, 32x32
    assert counts.tiling(first, RESNET20["cim"]) == (2, 14)
    ops, nbytes = counts.conv_launch_cost(first, RESNET20["cim"], 256,
                                          float_planes=False)
    assert ops == 2 * 3 * 256 * 1024 * 16 * 9 * 16
    # codes, int8 planes 3*2*9*14*16, s_p and deq, occupancy, float32 out
    assert nbytes == (256 * 1024 * 16 + 12_096 + 96 * 8 + 96
                      + 256 * 1024 * 16 * 4)
    _, fbytes = counts.conv_launch_cost(first, RESNET20["cim"], 256,
                                        float_planes=True)
    assert fbytes == nbytes + 3 * 12_096 - 96
    proj = [c for c in convs if c.name == "s1b0.proj"][0]
    assert (proj.kh, proj.c_in, proj.c_out, proj.stride, proj.ho) == (
        1, 16, 32, 2, 16)
    assert counts.plane_shape(proj, RESNET20["cim"]) == (3, 1, 1, 1, 128, 32)


@pytest.mark.parametrize("float_planes", [False, True])
def test_k3_bound_lies_between_the_two_terms(float_planes):
    peak = counts.PEAK_FP64_TENSOR if float_planes else counts.PEAK_INT8_OPS
    costs = [counts.conv_launch_cost(c, RESNET20["cim"], 256,
                                     float_planes=float_planes)
             for c in counts.cim_convs(RESNET20)]
    by_ops = sum(o for o, _ in costs) / peak
    by_bytes = sum(b for _, b in costs) / counts.PEAK_HBM_BYTES
    assert by_ops == pytest.approx(2 * 256 * 121_110_528 / peak)
    b = counts.k3_bound_s(RESNET20, 256, float_planes=float_planes)
    assert max(by_ops, by_bytes) <= b <= by_ops + by_bytes


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_and_a_reference_without_the_port():
    for p in HERE.rglob("*.py"):
        tops = set(_imports(p))
        assert not tops & FORBIDDEN, (p, tops & FORBIDDEN)
        if "reference" in p.relative_to(HERE).parts:
            assert "repro_torch" not in tops, p


def test_slice_busy_idle_and_labels():
    dev = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("copy", 5.0, 6.0)]
    host = [(trace.SLICE, 0.0, 10.0), ("bench.dispatch", 0.0, 4.0),
            ("aten::item", 3.5, 3.9), ("bench.readback", 4.0, 10.0),
            ("cudaEventSynchronize", 6.0, 9.5)]
    sl = trace.Slice(dev, host, 0.0, 10.0, units=4)
    assert sl.busy_intervals() == [(1.0, 3.0), (5.0, 6.0)]
    assert sl.busy_s() == 3.0 and sl.window_s == 10.0
    assert sl.idle_gaps() == [(0.0, 1.0), (3.0, 5.0), (6.0, 10.0)]
    assert sl.device_s(lambda n: n.startswith("k")) == 2.5
    br = sl.breakdown()
    assert br["device_ops"][0] == ["k2", 1.5]
    labels = dict((k, v) for k, v in br["idle_gaps"])
    assert labels == {"readback/cudaEventSynchronize": 4.0,
                      "dispatch/none": 3.0}


def test_a_cell_reports_what_its_metrics_name(bench):
    qat = [m["name"] for m in bench["per_layer"]
           if harness.reports(m, "resnet18.qat", bench["end_to_end"])]
    assert "k3_int8_roofline" not in qat
    assert all(m.endswith(".train") or m == "train_mfu" for m in qat)
