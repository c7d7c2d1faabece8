"""Runs one cell of ``BENCHMARK.json`` once and assembles its result line.

Everything specific to a piece lives in a file found by its name:
``BENCHMARK.json`` binds a cell to its configuration file and traffic;
``traffic/<traffic>.json`` holds the traffic's parameters and names the
driver (``drivers/<kind>.py``) that runs it; ``workloads/<cell>.json``
holds the cell's check (how much of the window it compares, and the
limit of each number); ``metrics/<metric>.py`` reads one per-layer
metric from a traced run. A cell reports the end-to-end metrics whose
``workloads`` name it (or that have none), and in a traced run the
per-layer metrics whose ``workloads`` name it, or, without that key,
those whose ``moves`` metric it reports.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import time
from pathlib import Path
from typing import Optional

import torch

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def bench() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(b: dict, name: str) -> dict:
    for w in b["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(b: dict, name: str) -> dict:
    for c in b["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def reports(metric: dict, cell: str, e2e: Optional[list] = None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    names, or, for a per-layer metric without that key (``e2e`` given),
    every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e is None:
        return True
    moved = next(m for m in e2e if m["name"] == metric["moves"])
    return reports(moved, cell)


def metric_module(name: str):
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's files, its seed and window, and the
    clock of the run."""
    name: str
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    config: dict
    traffic: dict
    cell: dict
    t_start: float
    window_t0: Optional[float] = None

    def start_window(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_t0 = time.perf_counter()
        return self.window_t0

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader sees of a traced run."""
    config: dict
    traffic: dict
    slice: object               # trace.Slice
    spans: dict


def context(name: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, traffic_overrides: Optional[dict] = None
            ) -> Context:
    """The cell's context; the float32 precision its configuration states
    (``tf32``) is set for the whole process, as a user would set it."""
    b = bench()
    w = workload(b, name)
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    traffic.update(traffic_overrides or {})
    config = config_of(b, w["config"])
    torch.backends.cudnn.allow_tf32 = config["tf32"]
    torch.backends.cuda.matmul.allow_tf32 = config["tf32"]
    return Context(name=name, seed=seed, seconds=seconds, trace=trace,
                   device=torch.device(device), config=config,
                   traffic=traffic,
                   cell=load_json(HERE / "workloads" / f"{name}.json"),
                   t_start=t_start)


def run(ctx: Context):
    """(result line as a dict, the compared numbers as (name, value,
    limit) rows). Runs the driver, frees the program's state, then the
    check."""
    kind = ctx.traffic["kind"]
    driver = importlib.import_module(f"perfbench.drivers.{kind}")
    out = driver.run(ctx)
    setup_s = ctx.window_t0 - ctx.t_start
    b = bench()
    metrics = {}
    if not ctx.trace:
        for m in b["end_to_end"]:
            if reports(m, ctx.name):
                value = (setup_s if m["name"] == "setup_s"
                         else out["end_to_end"][m["name"]])
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        view = Run(ctx.config, ctx.traffic, out["slice"], out["spans"])
        for m in b["per_layer"]:
            if reports(m, ctx.name, b["end_to_end"]):
                value = metric_module(m["name"]).read(view)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(ctx.device)
                       if ctx.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": None, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if ctx.trace:
        sl = out["slice"]
        device["busy_s"] = sl.busy_s()
        device["window_s"] = sl.window_s
        result["breakdown"] = sl.breakdown()
    check = out.pop("check")
    del out
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check()
    limits = ctx.cell["limits"]
    rows = [(k, numbers[k], limits[k]) for k in limits]
    result["correct"] = all(v <= lim for _, v, lim in rows)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows
