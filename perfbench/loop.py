"""The measured window of every driver: a closed loop that keeps ``depth``
units of work (batches, steps) queued on the device and waits for the
oldest before it dispatches more; in a traced run, a profiled slice of
whole units a third of the way in."""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from typing import Callable, List, Optional

from . import trace

#: where the traced slice starts in the window
SLICE_AT = 1 / 3


def _no_span(_name):
    return contextlib.nullcontext()


def closed_loop(dispatch: Callable, wait: Callable, start: int, depth: int,
                *, stop_at: Optional[float] = None,
                count: Optional[int] = None, spans: bool = False,
                dispatch_s: Optional[list] = None,
                on_done: Optional[Callable] = None):
    """Units from ``start``: ``dispatch(i)`` enqueues unit i and returns its
    handle, ``wait(handle)`` returns once it is done. Stops dispatching
    after ``count`` units or once the host clock passes ``stop_at``, then
    drains the queue. Returns (next unit, units done)."""
    span = trace.span if spans else _no_span
    queue = collections.deque()
    i, done = start, 0

    def finish():
        j, handle = queue.popleft()
        with span("wait"):
            wait(handle)
        if on_done is not None:
            on_done(j, handle)

    while True:
        t = time.perf_counter()
        with span("dispatch"):
            queue.append((i, dispatch(i)))
        if dispatch_s is not None:
            dispatch_s.append(time.perf_counter() - t)
        i += 1
        if len(queue) >= depth:
            finish()
            done += 1
        if (count is not None and i - start >= count) or (
                stop_at is not None and time.perf_counter() >= stop_at):
            break
    while queue:
        finish()
        done += 1
    return i, done


@dataclasses.dataclass
class Window:
    units: int                        # units dispatched (and done) in it
    seconds: float
    dispatch_s: List[float]           # host enqueue times outside the slice
    slice: Optional[trace.Slice]


def measure(ctx, dispatch: Callable, wait: Callable, start: int, depth: int,
            *, slice_s: float, unit_size: int = 1,
            on_done: Optional[Callable] = None) -> Window:
    """The window: ``ctx.seconds`` of the closed loop from unit ``start``;
    with ``ctx.trace`` a profiled slice of about ``slice_s`` seconds of
    whole units (each ``unit_size`` items: images, steps) inside it."""
    dispatch_s: List[float] = []
    loop = lambda i, **kw: closed_loop(dispatch, wait, i, depth,
                                       on_done=on_done, **kw)
    t0 = ctx.start_window()
    i, sliced = start, None
    if ctx.trace:
        i, done = loop(i, stop_at=t0 + ctx.seconds * SLICE_AT,
                       dispatch_s=dispatch_s)
        per_unit = (time.perf_counter() - t0) / max(done, 1)
        n = max(3, math.ceil(slice_s / per_unit))
        with trace.profiled() as prof:
            i, _ = loop(i, count=n, spans=True)
        sliced = (prof, n)
    i, _ = loop(i, stop_at=t0 + ctx.seconds, dispatch_s=dispatch_s)
    seconds = time.perf_counter() - t0
    return Window(units=i - start, seconds=seconds, dispatch_s=dispatch_s,
                  slice=None if sliced is None else trace.reduce(
                      sliced[0], sliced[1] * unit_size))
