"""Cells driven on the CPU at a small size, for the tests."""
import importlib
import time

from perfbench import harness

#: small traffic for each kind of cell
SMALL = {"eval": dict(batch=8, pool_batches=2, calibration_images=16),
         "qat": dict(batch=8, pool_batches=4, calibration_images=16)}


def context(cell: str, seed: int = 2 ** 31 + 3, config: str = None,
            **cell_file):
    b = harness.bench()
    kind = harness.load_json(
        harness.HERE / "traffic"
        / f"{harness.workload(b, cell)['traffic']}.json")["kind"]
    ctx = harness.context(cell, seed, 0.3, False, "cpu", time.perf_counter(),
                          SMALL[kind])
    if config is not None:
        ctx.config = harness.config_of(b, config)
    ctx.cell.update(cell_file)
    return ctx


def driver(ctx):
    return importlib.import_module(f"perfbench.drivers.{ctx.traffic['kind']}")


def numbers(ctx, **kw):
    out = driver(ctx).run(ctx)
    return out["check"](**kw)
