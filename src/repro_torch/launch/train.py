"""Training launcher of the port (counterpart of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --steps 100 --batch 8 --seq 128 --cim emulate

It takes the reference launcher's flags and defaults and adds
``--device`` (default ``cuda``; ``cpu`` for tests). Without a card and
without ``--device cpu`` it raises, as ``repro_torch.resolve_device``
does. It wires the fault-tolerant loop: auto-resume from the newest
checkpoint in ``--ckpt-dir``, asynchronous saves every ``--ckpt-every``
steps, the straggler monitor, and ``--crash-at`` failure injection.

``--cim emulate`` trains under the reference launcher's CIM config
(4-bit weights on 2-bit cells, 6-bit partial sums, 128x128 arrays,
column-wise scales: ``--cim-bits``, ``--cim-cell-bits``,
``--cim-psum-bits``). ``--cim deploy`` builds a deploy spec tree, whose
integer digit planes have no gradient: the first step raises TypeError,
as the reference's ``jax.value_and_grad`` does.

Two repairs against the reference launcher (ROADMAP faults 15 and 16):
after a resume the LM stream starts at the resumed step (the reference
replays it from step 0), and whisper and llava get front-end input at
``models.registry.frontend_input_shape`` (raw log-mel frames, images; the
reference feeds stub-embedding zeros, half the frames whisper's stem
expects and no image for llava's patch-embed conv). The front-end input
is zeros, as the reference's. The tok/s of a ``[train]`` line counts the
steps this launch ran (the reference's counts from step 0 after a
resume).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs.base import default_checkpoint_dir


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--cim", default="off",
                    choices=["off", "emulate", "deploy"])
    ap.add_argument("--cim-bits", type=int, default=4)
    ap.add_argument("--cim-cell-bits", type=int, default=2)
    ap.add_argument("--cim-psum-bits", type=int, default=6)
    ap.add_argument("--ckpt-dir", default=default_checkpoint_dir())
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="inject a failure at this step (FT testing)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda; cpu for tests)")
    return ap


def main(argv=None, *, on_metrics=None) -> int:
    """Train as the flags say; print the ``[train]`` lines. ``on_metrics``
    (keyword only, for callers in Python) is called as
    ``on_metrics(step, metrics)`` beside each logged step's line, with
    the metrics on the host."""
    args = _parser().parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.data.pipeline import make_lm_pipeline
    from repro_torch.models.registry import frontend_input_shape, get_model
    from repro_torch.nn.module import init_params
    from repro_torch.runtime.fault_tolerance import (FaultTolerantLoop,
                                                     TrainLoopState)
    from repro_torch.train.trainer import make_train_step

    device = resolve_device(args.device)
    cim = None
    if args.cim != "off":
        cim = CIMConfig(enabled=True, mode=args.cim,
                        weight_bits=args.cim_bits,
                        cell_bits=args.cim_cell_bits,
                        psum_bits=args.cim_psum_bits,
                        array_rows=128, array_cols=128)
    cfg = get_config(args.arch, reduced=args.reduced, cim=cim)
    run = RunConfig(lr=args.lr, total_steps=args.steps,
                    warmup_steps=max(1, args.steps // 10),
                    accum_steps=args.accum, optimizer=args.optimizer,
                    checkpoint_dir=args.ckpt_dir,
                    checkpoint_every=args.ckpt_every, seed=args.seed)
    model = get_model(cfg)
    fshape = frontend_input_shape(cfg, args.batch)

    def make_batches(start_step: int):
        pipe = make_lm_pipeline(vocab=cfg.vocab, seq_len=args.seq,
                                global_batch=args.batch, seed=args.seed,
                                start_step=start_step)
        for raw in pipe:
            batch = {"tokens": torch.as_tensor(raw["tokens"]).to(device)}
            if fshape is not None:
                batch["frontend"] = torch.zeros(fshape, dtype=torch.float32,
                                                device=device)
            yield batch

    init_state_fn, train_step = make_train_step(model, cfg, run)

    def fresh():
        params = init_params(model.specs(cfg), args.seed, device=device)
        return TrainLoopState(params=params, opt_state=init_state_fn(params),
                              step=0)

    loop = FaultTolerantLoop(args.ckpt_dir,
                             checkpoint_every=args.ckpt_every)
    state = loop.resume_or_init(fresh)
    if state.step:
        print(f"[train] resumed from step {state.step}")

    t0 = time.time()
    tokens_per_step = args.batch * args.seq
    first_step = state.step

    def log(step, m):
        dt = time.time() - t0
        print(f"[train] step {step:5d} loss {float(m['loss']):.4f} "
              f"gnorm {float(m['grad_norm']):.3f} lr {float(m['lr']):.2e} "
              f"({(step - first_step) * tokens_per_step / max(dt, 1e-9):.0f}"
              f" tok/s)")
        if on_metrics is not None:
            on_metrics(step, m)

    state = loop.run(state, train_step, make_batches(state.step),
                     total_steps=args.steps, crash_at_step=args.crash_at,
                     log_every=args.log_every, on_metrics=log)
    print(f"[train] done at step {state.step} "
          f"({time.time() - t0:.1f}s, straggler warns="
          f"{loop.straggler.n_warn})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
