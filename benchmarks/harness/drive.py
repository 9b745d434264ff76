"""The measured window: a frozen copy of the driver's dispatch discipline
(``pangea_tpu_torch/pipeline/run.py`` ``_run_fast``'s main thread and
drain thread), with the reader, trim, copy-in, writer and fsyncs left out.

The main thread launches the step on each batch in turn, the batches
cycling through a pool already on the card, and puts it on a queue of
DRAIN_DEPTH launched batches; the drain thread takes each in order and
brings its taxon, best and nvalid back with ``.cpu()``. The window opens
at the first launch and closes ``seconds`` later: no batch is launched
after it, and the drain finishes those in flight.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass, field

OUT_KEYS = ("taxon", "best", "nvalid")
DRAIN_DEPTH = 4               # _run_fast's PANGEA_INFLIGHT default
_END = object()


@dataclass
class Batch:
    slot: int                 # the pool's batch
    n_reads: int
    t_disp: float             # host clock at the launch
    t_enq: float = 0.0        # seconds inside the step call
    t_done: float | None = None   # host clock once its outputs are back
    events: tuple | None = None   # CUDA events before and after the step
    step_ms: float | None = None
    out: dict | None = None


@dataclass
class Window:
    t_open: float
    t_close: float
    batches: list = field(default_factory=list)
    device_ms: float | None = None   # first launch's event to the last


def run_window(step, pool: list, packed_len: int, stride: int,
               seconds: float, depth: int = DRAIN_DEPTH,
               events: bool = False, watch=None,
               annotate: bool = False) -> Window:
    """Drive ``step`` for ``seconds`` over ``pool``, a list of (rows
    int32 [n, stride] or [n, 2 * stride] on the device, n). ``watch(slot,
    outputs)`` sees each batch's host outputs in the drain thread.
    ``events``: a CUDA event before and after each step and around the
    window. ``annotate``: name the host phases for the profiler."""
    import torch
    mark = torch.profiler.record_function if annotate else (
        lambda name: contextlib.nullcontext())
    drain_q: queue.Queue = queue.Queue(maxsize=depth)
    errors: list = []

    def drain():
        try:
            while (b := drain_q.get()) is not _END:
                with mark("drain.fetch"):
                    res = {k: b.out[k].cpu().numpy() for k in OUT_KEYS}
                b.t_done = time.perf_counter()
                b.out = None
                if watch is not None:
                    watch(b.slot, res)
        except BaseException as e:  # noqa: BLE001 (raised by the main thread)
            errors.append(e)
            while drain_q.get() is not _END:
                pass

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    drainer = threading.Thread(target=drain, daemon=True)
    drainer.start()
    t_open = time.perf_counter()
    win = Window(t_open, t_open + seconds)
    first = event() if events else None
    last = None
    i = 0
    try:
        while not errors:
            t = time.perf_counter()
            if t >= win.t_close:
                break
            slot = i % len(pool)
            rows, n = pool[slot]
            b = Batch(slot, n, t)
            before = event() if events else None
            with mark("main.step"):
                b.out = step(rows[:, :stride], rows[:, stride:]
                             if rows.shape[1] > stride else None,
                             packed_len=packed_len)
            if events:
                b.events = (before, event())
            b.t_enq = time.perf_counter() - t
            win.batches.append(b)
            with mark("main.queue_put"):
                drain_q.put(b)
            i += 1
    finally:
        if events:
            last = event()
        drain_q.put(_END)
        drainer.join()
    if errors:
        raise errors[0]
    if events:
        torch.cuda.synchronize()
        for b in win.batches:
            b.step_ms = b.events[0].elapsed_time(b.events[1])
            b.events = None
        win.device_ms = first.elapsed_time(last)
    return win
