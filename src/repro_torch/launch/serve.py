"""Serving driver of the port (counterpart of ``repro.launch.serve``):
batched generation with the serving engine, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --reduced --batch 4 --prompt-len 16 --new-tokens 32 [--cim deploy]

It takes the reference launcher's flags and defaults and adds
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions,
for tests). Without a card and without ``--device cpu`` it raises, as
``repro_torch.resolve_device`` does.

``--mesh N`` with N > 1 serves column-parallel: the launcher spawns N
ranks (``launch.mesh.spawn``, a free localhost port), each joins a
process group on ``--dist-backend`` (``nccl``, the default, puts one rank
on each card and raises with fewer cards than ranks; ``gloo`` runs ranks
on the CPU with ``--device cpu``, or ranks that share one card), builds
a ``("model",)`` mesh of N and serves the artifact column-sharded over
it (``engine_from_artifact(..., mesh=)``). Every rank generates the same
tokens; rank 0 prints the ``[serve]`` lines and writes
``--metrics-out``. ``--mesh 1`` serves in this process, unsharded.

``--artifact PATH`` serves a saved ``DeployArtifact``, written by either
package, instead of packing weights initialised from ``--seed``.
``--cim deploy`` packs them with the reference launcher's CIM config (4-bit
weights on 2-bit cells, 8-bit activations, 6-bit partial sums, 128x128
arrays) into an in-memory artifact and serves that; its deploy path runs
the hand-written kernels on the card (the reference's ``use_kernel=False``
picks its XLA path over Pallas, which the port has no counterpart for).

Self-healing serving: ``--drift-col-rate`` / ``--drift-cell-rate`` /
``--drift-read-sigma`` serve a drifting chip (one realization per model
invocation, clocked from ``--drift-t0``; the fields come from a
``core.variation.Sampler`` seeded from ``--seed``, so they are not the
reference's draws: randomness does not cross frameworks), ``--health``
arms the ``DriftMonitor``, and ``--auto-recal`` re-fits the column scales
on hard drift instead of serving the digital fallback.

Telemetry: ``--metrics-out PATH`` writes the engine's ``metrics()`` as
JSON after generation; ``--report-every N`` prints a one-line report to
stderr every N decode steps; ``--adc-sample N`` arms the ADC saturation
collector, folding every Nth kernel call.

whisper: the launcher draws log-mel frames at ``frontend_input_shape``
from ``--seed``, encodes them on the served params (``whisper.encode``)
and puts the states in the engine's cache before ``generate_batch``, as
``examples/serve_whisper_cim.py`` does for the slot engine. The
reference's launcher serves whisper from zero encoder states (ROADMAP
fault 13), so its whisper tokens are those of silent audio.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

#: the drift source's seed offset (the reference folds 0xD81F into its key)
_DRIFT_TAG = 0xD81F


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--cim", default="off",
                    choices=["off", "emulate", "deploy"])
    ap.add_argument("--mesh", type=int, default=1,
                    help="ranks along the 'model' axis: N > 1 spawns N "
                         "ranks that serve the packed planes column-sharded")
    ap.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                    help="collective backend of --mesh N: nccl (one card "
                         "per rank) or gloo (CPU ranks, or ranks sharing "
                         "one card)")
    ap.add_argument("--artifact", default=None,
                    help="path to a packed model DeployArtifact (saved by "
                         "either package) to serve on its pinned backend")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, the prompts, whisper's "
                         "log-mel frames and the drift source (the port's "
                         "own draws: not the reference's)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda; cpu for tests)")
    ap.add_argument("--drift-col-rate", type=float, default=0.0,
                    help="per-request column-gain drift rate "
                         "(core.variation.DriftSchedule.col_rate)")
    ap.add_argument("--drift-cell-rate", type=float, default=0.0,
                    help="per-request per-cell drift rate")
    ap.add_argument("--drift-read-sigma", type=float, default=0.0,
                    help="static read-noise sigma (re-drawn every step)")
    ap.add_argument("--drift-t0", type=int, default=0,
                    help="initial request count on the drift clock")
    ap.add_argument("--health", action="store_true",
                    help="arm the DriftMonitor and print the engine "
                         "health() snapshot after generation")
    ap.add_argument("--auto-recal", action="store_true",
                    help="recalibrate column scales automatically on "
                         "hard drift instead of serving the fallback")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write engine.metrics() (health + throughput + "
                         "metric snapshot) as JSON after generation")
    ap.add_argument("--report-every", type=int, default=0, metavar="N",
                    help="print a one-line metrics report to stderr every "
                         "N decode steps (0 = off)")
    ap.add_argument("--adc-sample", type=int, default=0, metavar="N",
                    help="arm the per-column ADC saturation collector, "
                         "folding every Nth kernel invocation (0 = off)")
    return ap


def launcher_cim():
    """The reference launcher's CIM config (``repro.launch.serve``), the
    QAT-shaped emulate config that ``--cim deploy`` packs."""
    from repro_torch.core.cim_linear import CIMConfig
    return CIMConfig(enabled=True, mode="emulate", weight_bits=4,
                     cell_bits=2, act_bits=8, psum_bits=6, array_rows=128,
                     array_cols=128)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.mesh > 1:
        return _spawn_ranks(args, argv)
    from repro_torch import resolve_device
    return _run(args, resolve_device(args.device), None)


def _spawn_ranks(args, argv) -> int:
    """``--mesh N``: check the flags, then serve on N spawned ranks."""
    import sys

    from repro_torch.launch import mesh as lm
    if args.artifact is None and args.cim != "deploy":
        raise SystemExit("--mesh shards packed digit planes; use it with "
                         "--cim deploy or --artifact")
    import torch
    try:
        lm.check_backend(args.dist_backend, torch.device(args.device),
                         args.mesh)
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"--mesh {args.mesh}: {e}") from None
    lm.spawn(_rank_main, args.mesh,
             (list(sys.argv[1:] if argv is None else argv), lm.free_port()),
             timeout_s=None)
    return 0


def _rank_main(rank: int, argv, port: int) -> None:
    """One rank of ``--mesh N``: join the group, build the mesh, serve."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as lm
    args = _parser().parse_args(argv)
    device = lm.init_rank(rank, args.mesh, port, backend=args.dist_backend,
                          device=args.device)
    try:
        mesh = lm.make_mesh(args.mesh, device=device,
                            backend=args.dist_backend)
        _run(args, device, mesh)
    finally:
        dist.destroy_process_group()


def _run(args, device, mesh) -> int:
    from repro_torch.core.variation import DriftSchedule, Sampler
    from repro_torch.serve.health import DriftMonitor

    drift_kw = {}
    drifting = (args.drift_col_rate or args.drift_cell_rate
                or args.drift_read_sigma)
    if drifting:
        drift_kw["drift_key"] = Sampler(args.seed).for_layer(
            f"drift/{_DRIFT_TAG}")
        drift_kw["drift_schedule"] = DriftSchedule(
            read_sigma=args.drift_read_sigma,
            cell_rate=args.drift_cell_rate,
            col_rate=args.drift_col_rate)
    if args.health or args.auto_recal:
        drift_kw["health"] = DriftMonitor()
        drift_kw["auto_recalibrate"] = args.auto_recal
    if args.report_every:
        drift_kw["report_every"] = args.report_every
    from repro_torch.obs import adc
    if args.adc_sample:
        adc.enable(every_n=args.adc_sample)
    try:
        return _serve(args, device, drift_kw, bool(drifting), mesh)
    finally:
        if args.adc_sample:
            adc.disable()


def _serve(args, device, drift_kw, drifting: bool, mesh) -> int:
    """Build the engine (column-sharded over ``mesh`` when given),
    generate, print the ``[serve]`` lines and write the metrics (rank 0
    of a mesh)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import frontend_input_shape, get_model
    from repro_torch.nn.module import init_params
    from repro_torch.serve.engine import ServingEngine, engine_from_artifact

    cim = launcher_cim() if args.cim != "off" else None
    cfg = get_config(args.arch, reduced=args.reduced, cim=cim)
    common = dict(batch_size=args.batch, max_len=args.max_len,
                  temperature=args.temperature, seed=args.seed,
                  device=device, **drift_kw)
    if args.artifact is not None:
        engine = engine_from_artifact(args.artifact, cfg, mesh=mesh, **common)
    elif args.cim == "deploy":
        # random-init emulate params packed into an in-memory artifact: the
        # same packed bytes and engine path a saved artifact takes
        from repro_torch.api import model_artifact
        model = get_model(cfg)
        params = init_params(model.specs(cfg), args.seed, device=device)
        artifact = model_artifact(params, cim, meta={"arch": args.arch},
                                  device=device)
        del params
        engine = engine_from_artifact(artifact, cfg, mesh=mesh, **common)
    else:
        if drifting:
            raise SystemExit("drift flags act on packed digit planes; use "
                             "them with --cim deploy or --artifact")
        model = get_model(cfg)
        params = init_params(model.specs(cfg), args.seed, device=device)
        engine = ServingEngine(model, cfg, params, **common)
    engine.t = args.drift_t0
    rng = np.random.RandomState(args.seed)
    prompts = rng.randint(0, cfg.vocab, size=(args.batch, args.prompt_len)
                          ).astype(np.int32)
    if "enc_out" in engine.cache:
        # the encoder-decoder decodes against the states of its audio
        from repro_torch.models import whisper
        g = torch.Generator().manual_seed(args.seed)
        frames = (torch.randn(frontend_input_shape(cfg, args.batch),
                              generator=g) * 0.1).to(device)
        engine.cache["enc_out"] = whisper.encode(engine.params, frames,
                                                 engine.cfg)
    t0 = time.time()
    out = engine.generate_batch(prompts, args.new_tokens)
    dt = time.time() - t0
    # every rank folds the metrics (the ADC totals sum over the mesh)
    metrics = engine.metrics() if args.metrics_out else None
    if mesh is not None and mesh.get_rank() != 0:
        return 0
    n_new = out.shape[0] * out.shape[1]
    print(f"[serve] arch={args.arch} mesh={args.mesh} generated {out.shape} "
          f"tokens in {dt:.2f}s ({n_new / dt:.1f} tok/s)")
    print(f"[serve] sample continuation: {out[0][:16].tolist()}")
    h = engine.health()
    print(f"[serve] admission: submitted={h['submitted']} "
          f"retired={h['retired']} queue_depth={h['queue_depth']} "
          f"active_slots={h['active_slots']}/{h['slots']}")
    if args.health or args.auto_recal:
        print(f"[serve] health: {h}")
    if args.metrics_out:
        with open(args.metrics_out, "w", encoding="utf-8") as f:
            json.dump(metrics, f, indent=2, default=str)
        print(f"[serve] metrics -> {args.metrics_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
