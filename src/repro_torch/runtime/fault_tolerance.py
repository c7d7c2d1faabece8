"""Fault-tolerant training loop of the port (counterpart of
``repro.runtime.fault_tolerance``): checkpoint/restart, failure injection,
emergency save on a signal.

``FaultTolerantLoop`` is the per-process part: always-resumable state in
the port's ``checkpoint.CheckpointManager`` (the reference's on-disk
format, with the reference's tree names ``params``, ``opt_state``,
``step`` and ``extra``, so either package resumes the other's
checkpoints), an emergency save on SIGTERM/SIGINT, and a restore onto the
device of the fresh state, or onto a device mesh (``shardings``: each
rank reads its blocks of whatever mesh wrote the checkpoint).

Data-pipeline state is (seed, step), so resumption is exact when the
caller starts the stream at the resumed step
(``data.pipeline.make_lm_pipeline(start_step=...)``).

The failure-injection path (``crash_at_step``) serves the tests: train k
steps, "crash", relaunch, and the result equals an uninterrupted run. The
final state is saved at the end of ``run`` unless its step's checkpoint
was just written (the reference writes it a second time).
Before the injected failure propagates, the checkpoint writes already
handed to the writer thread land, as they would on a host that outlives
the trainer process, so a relaunch in the same process finds them.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import tree_leaves
from repro_torch.checkpoint.ckpt import CheckpointManager

from .straggler import StragglerMonitor

class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class TrainLoopState:
    params: Any
    opt_state: Any
    step: int
    extra: Optional[Dict] = None       # e.g. BN state, EF buffers


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


class FaultTolerantLoop:
    """Wraps (train_step, pipeline) with checkpoint/restore/emergency-save.

    train_step: (params, opt_state, batch) -> (params, opt_state, metrics)
    """

    def __init__(self, ckpt_dir: str, *, checkpoint_every: int = 100,
                 keep_n: int = 3, async_save: bool = True,
                 install_signal_handlers: bool = False):
        self.mgr = CheckpointManager(ckpt_dir, keep_n=keep_n,
                                     async_save=async_save)
        self.checkpoint_every = checkpoint_every
        self.straggler = StragglerMonitor()
        self._restart_requested = False
        self._state: Optional[TrainLoopState] = None
        if install_signal_handlers:
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, self._emergency)

    # -- coordinator hooks -----------------------------------------------------
    def request_restart(self, *_args):
        """Called by straggler policy / external watchdog."""
        self._restart_requested = True

    def _emergency(self, signum, frame):
        if self._state is not None:
            self.mgr.save(self._state.step, self._pack(self._state))
            self.mgr.wait()
        raise SystemExit(128 + signum)

    # -- (de)serialization ------------------------------------------------------
    @staticmethod
    def _pack(st: TrainLoopState) -> Dict:
        out = {"params": st.params, "opt_state": st.opt_state,
               "step": np.asarray(st.step, np.int64)}
        if st.extra is not None:
            out["extra"] = st.extra
        return out

    def resume_or_init(self, init_fn: Callable[[], TrainLoopState],
                       shardings: Any = None, *, mesh=None
                       ) -> TrainLoopState:
        """Restore the latest checkpoint if one exists, onto the device of
        ``init_fn()``'s params, else return that fresh state. With
        ``shardings`` ({"params": ..., "opt_state": ...} placements, as
        ``launch.cells.build_cell`` gives them, on ``mesh`` or the session
        mesh) the params and the optimizer state are restored as this
        rank's blocks, whatever mesh wrote them; ``step`` and ``extra``
        are not placed."""
        latest = self.mgr.latest_step()
        st = init_fn()
        if latest is None:
            return st
        device = next(tree_leaves(st.params)).device
        like = self._pack(st)
        sh = None
        if shardings is not None:
            sh = {k: shardings.get(k) for k in ("params", "opt_state")}
        restored = self.mgr.restore(like, step=latest, shardings=sh,
                                    device=device, mesh=mesh)
        return TrainLoopState(params=restored["params"],
                              opt_state=restored["opt_state"],
                              step=int(restored["step"]),
                              extra=restored.get("extra"))

    # -- the loop ----------------------------------------------------------------
    def run(self, state: TrainLoopState, train_step: Callable,
            batches: Iterator, *, total_steps: int,
            crash_at_step: Optional[int] = None,
            log_every: int = 10,
            on_metrics: Optional[Callable[[int, Dict], None]] = None
            ) -> TrainLoopState:
        self._state = state
        saved = None
        while state.step < total_steps:
            if crash_at_step is not None and state.step == crash_at_step:
                self.mgr.wait()
                raise InjectedFailure(f"injected failure at step {state.step}")
            batch = next(batches)
            self.straggler.step_start()
            params, opt_state, metrics = train_step(
                state.params, state.opt_state, batch)
            metrics["loss"].item()           # wait for the step on the device
            verdict = self.straggler.step_end()
            state = TrainLoopState(params, opt_state, state.step + 1,
                                   state.extra)
            self._state = state
            if verdict == "critical":
                self.request_restart()
            if on_metrics and (state.step % log_every == 0):
                on_metrics(state.step, {k: _host(v)
                                        for k, v in metrics.items()})
            if state.step % self.checkpoint_every == 0:
                self.mgr.save(state.step, self._pack(state))
                saved = state.step
        if saved != state.step:          # the reference saves it again
            self.mgr.save(state.step, self._pack(state))
        self.mgr.wait()
        return state
