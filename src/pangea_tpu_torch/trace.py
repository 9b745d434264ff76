"""The port's tracer: host spans, launch records and placement records.

A span is a named interval of host time (``time.perf_counter_ns``) on one
thread, with the span that encloses it and the id of the step it belongs
to. ``dist/mesh.py`` ``MeshStep`` opens ``step``, which starts a new id;
every span inside it shares that id: ``step.extract``, ``step.probe`` and
``step.score`` (``classify/engine.py`` ``classify_reads``, once an index
on the multi-k step, each index's inside its ``step.index<i>``, ``i`` its
position), ``step.merge`` (the all-reduce of a distributed mesh) and
``launch.<launcher>`` (the host blocked in ``kernels/_build.py``
``launch``'s call into the CUDA runtime). A launch record is one such call with
a CUDA event recorded on the launch stream just before and just after it;
when the trace ends, the events are read on the host's clock (an event
recorded on the idle stream at a known host time anchors them).

The tracer is off by default. While off, :func:`span` returns one shared
no-op and ``launch`` tests one flag: no clock read, no allocation, no
event. :func:`collect` turns it on and yields the :class:`Trace` it
collects. While a ``torch.profiler`` records, each span also opens a
``record_function`` of its name, so the profiler's Chrome trace shows it
on the clock of the card's operations (a profiler started without
``profile_all_threads`` keeps only its own thread's).

Three kinds of span keep totals whether or not a trace is collected: the
CLI's phases (``run.parse`` ... ``run.sync``, its ``host_sec``), index
placement (:class:`Placement`: ``place``, ``place.layout``,
``place.copy``, whose seconds, storage reads, the side the relayout ran
on and the rows' form each placement appends to :func:`placements`) and
each index's part of a multi-k step (:class:`IndexSpan`, ``step.index<i>``, totalled
with its calls, probes and sorted lookups in :func:`index_steps`; a
one-index step has no such span).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import Counter, defaultdict

import torch

STEP = "step"
INDEX = "step.index"
LAUNCH = "launch."
PROBE = "step.probe"
GAPS_SHOWN = 10

# Whether a trace is being collected: the one flag a span or a launch
# tests while the tracer is off.
ON = False
_sink = None                  # the Trace being collected
_local = threading.local()    # each thread's stack of open spans
_step_ids = itertools.count(1)
_placements: list = []
_index_steps: dict = {}       # (position, k, w, layout) -> its totals
open_index = None             # the totals of the step.index<i> span open now


class _NoSpan:
    """The span of a tracer that is off: it records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def span(name: str):
    """A span of the collected trace; the shared no-op while none is."""
    return Span(name) if ON else NO_SPAN


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """A named interval of host time on one thread, recorded in the trace
    being collected when it opens. ``totals``, a dict, gains the span's
    nanoseconds under its name whether or not a trace is collected."""
    __slots__ = ("name", "totals", "trace", "parent", "step", "thread",
                 "t0", "t1", "_mark")

    def __init__(self, name: str, totals: dict | None = None):
        self.name = name
        self.totals = totals
        self.trace = self.parent = self.step = self.thread = None
        self._mark = None

    def __enter__(self):
        tr = self.trace = _sink
        if tr is not None:
            stack = _stack()
            parent = self.parent = stack[-1] if stack else None
            self.step = (next(_step_ids) if self.name == STEP
                         else parent.step if parent is not None else None)
            self.thread = threading.get_ident()
            stack.append(self)
            if torch.autograd.profiler._is_profiler_enabled:
                self._mark = torch.profiler.record_function(self.name)
                self._mark.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.trace is not None:
            if self._mark is not None:
                self._mark.__exit__(None, None, None)
            _stack().pop()
            self.trace.spans.append(self)
        if self.totals is not None:
            self.totals[self.name] = (self.totals.get(self.name, 0)
                                      + self.t1 - self.t0)
        return False

    @property
    def ns(self) -> int:
        return self.t1 - self.t0


class Launch:
    """One launcher call: its ``launch.<name>`` span, its device, and the
    device interval between its events, on the host's clock (ns) once the
    trace has ended."""
    __slots__ = ("name", "span", "device", "e0", "e1", "t0", "t1")

    def __init__(self, name, span, device, e0, e1):
        self.name, self.span, self.device = name, span, device
        self.e0, self.e1 = e0, e1
        self.t0 = self.t1 = None


def recorded(name: str, fn):
    """``fn``, a launcher's ctypes function, called between two CUDA events
    on the current stream, inside a ``launch.<name>`` span. The span holds
    the record of the first event too, which stands in for the launch as
    the host's first call into CUDA, so that a wait inside CUDA lands in
    the span."""
    def call(*args):
        tr = _sink
        if tr is None:
            return fn(*args)
        e0 = torch.cuda.Event(enable_timing=True)
        with Span(LAUNCH + name) as sp:
            e0.record()
            err = fn(*args)
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        tr.launches.append(Launch(name, sp, torch.cuda.current_device(), e0,
                                  e1))
        return err
    return call


@contextlib.contextmanager
def collect():
    """Turn the tracer on; yields the :class:`Trace` it collects, whose
    launches are read on the host's clock when the block ends."""
    global ON, _sink
    if ON:
        raise RuntimeError("a trace is already being collected")
    tr = Trace()
    _sink, ON = tr, True
    try:
        yield tr
    finally:
        ON, _sink = False, None
        tr.end()


def on_host(ms: float, anchor_ms: float, anchor_ns: int) -> int:
    """A device time on the host's clock (ns): ``ms`` and ``anchor_ms`` are
    an event's and the anchor's device ms after one reference event, and
    the anchor was recorded on an idle stream at host time
    ``anchor_ns``."""
    return anchor_ns - round((anchor_ms - ms) * 1e6)


def uncovered(intervals) -> list:
    """The gaps (start, end) between the earliest start and the latest end
    of ``intervals`` (start, end) that no interval covers, in order."""
    gaps, reach = [], None
    for s, e in sorted(intervals):
        if reach is not None and s > reach:
            gaps.append((reach, s))
        reach = e if reach is None else max(reach, e)
    return gaps


def innermost(spans, t):
    """The name of the innermost of ``spans`` (nested, one thread's) that
    holds host time ``t``, after that of the ``step.index<i>`` span that
    encloses it on a multi-k step (``step.index1+step.probe``), so that the
    indexes' gaps tell apart; None where none holds ``t``."""
    best = None
    for s in spans:
        if s.t0 <= t < s.t1 and (best is None or s.t0 >= best.t0):
            best = s
    if best is None:
        return None
    up = best.parent
    while up is not None and not up.name.startswith(INDEX):
        up = up.parent
    return best.name if up is None else f"{up.name}+{best.name}"


def _under(sp, name: str) -> bool:
    while sp is not None:
        if sp.name == name:
            return True
        sp = sp.parent
    return False


class Trace:
    """The spans (in the order they ended) and launch records of one
    :func:`collect`."""

    def __init__(self):
        self.spans: list = []
        self.launches: list = []

    def end(self) -> None:
        """Read every launch's events on the host's clock: after a
        synchronize, an event recorded on the idle stream at a known host
        time anchors the device's clock (its few microseconds of record
        latency shift every launch that much earlier)."""
        by_device = defaultdict(list)
        for rec in self.launches:
            if rec.e0 is not None:
                by_device[rec.device].append(rec)
        for device, recs in by_device.items():
            with torch.cuda.device(device):
                torch.cuda.synchronize()
                anchor = torch.cuda.Event(enable_timing=True)
                host = time.perf_counter_ns()
                anchor.record()
                anchor.synchronize()
            ref = recs[0].e0
            a_ms = ref.elapsed_time(anchor)
            for rec in recs:
                rec.t0 = on_host(ref.elapsed_time(rec.e0), a_ms, host)
                rec.t1 = on_host(ref.elapsed_time(rec.e1), a_ms, host)
                rec.e0 = rec.e1 = None

    def totals(self) -> dict:
        """Seconds by span name."""
        ns: Counter = Counter()
        for s in self.spans:
            ns[s.name] += s.ns
        return {k: v * 1e-9 for k, v in ns.items()}

    def self_times(self) -> dict:
        """Seconds by span name, less the time each span's children
        cover."""
        ns: Counter = Counter()
        for s in self.spans:
            ns[s.name] += s.ns
            if s.parent is not None:
                ns[s.parent.name] -= s.ns
        return {k: v * 1e-9 for k, v in ns.items()}

    def summary(self) -> dict:
        """The trace's readings, a step being a ``step`` span: ``steps``,
        ``step_ms`` (host ms a step), ``self_ms`` (self ms a step by span),
        ``launches`` (records by launcher), and, None without launches,
        ``launch_block_ms`` (host ms a step inside ``launch.*`` spans),
        ``launch_gap_ms`` (device ms a step between its first launch's
        start and its last launch's end that no launch covers: the card
        waiting on the host inside the step), ``probe_ms`` (device ms a step
        of the launches made inside ``step.probe``) and ``gaps`` (the
        longest in-step gaps, each [ms, the innermost span of the step's
        thread at its midpoint])."""
        steps = {s.step: s for s in self.spans if s.name == STEP}
        n = len(steps)
        per_step = defaultdict(list)
        for s in self.spans:
            if s.step in steps:
                per_step[s.step].append(s)
        recs = defaultdict(list)
        for rec in self.launches:
            if rec.span.step in steps and rec.t0 is not None:
                recs[rec.span.step].append(rec)
        block = gap = probe = 0
        probed = False
        gaps = []
        for sid, rs in recs.items():
            block += sum(r.span.ns for r in rs)
            under = [r for r in rs if _under(r.span, PROBE)]
            probed = probed or bool(under)
            probe += sum(r.t1 - r.t0 for r in under)
            for g0, g1 in uncovered((r.t0, r.t1) for r in rs):
                gap += g1 - g0
                label = innermost(per_step[sid], (g0 + g1) // 2)
                gaps.append([(g1 - g0) * 1e-6, label or "host.other"])
        gaps.sort(reverse=True)
        launched = bool(recs) and n > 0
        self_s = self.self_times()
        stepped = {s.name for ss in per_step.values() for s in ss}

        def per(ns):
            return ns * 1e-6 / n if launched else None
        return {
            "steps": n,
            "step_ms": (sum(s.ns for s in steps.values()) * 1e-6 / n
                        if n else None),
            "self_ms": {k: v * 1e3 / n for k, v in sorted(self_s.items())
                        if k in stepped},
            "launches": dict(Counter(r.name for r in self.launches)),
            "launch_block_ms": per(block),
            "launch_gap_ms": per(gap),
            "probe_ms": per(probe) if probed else None,
            "gaps": gaps[:GAPS_SHOWN],
            "totals_s": self.totals()}


def read_bytes() -> int | None:
    """Bytes this process has had read from storage (``/proc/self/io``
    ``read_bytes``), or None where that file cannot be read."""
    try:
        with open("/proc/self/io") as fh:
            for line in fh:
                if line.startswith("read_bytes:"):
                    return int(line.split()[1])
    except (OSError, ValueError):
        pass
    return None


class Placement:
    """One index's placement on ``device``, timed whether or not a trace is
    collected: ``place`` around it, :meth:`layout` (``place.layout``: the
    relayout into the device table, wherever it runs: on the host, with
    its stash and the taxonomy's arrays and the page faults of a mapped
    index, or on the card, up to a synchronize) and :meth:`copy`
    (``place.copy``: the copies to the device, up to a synchronize: the
    host's table, or, for a relayout on the card, the stored arrays and
    the taxonomy's), with the bytes read from storage during the
    placement and the form its rows were laid out in (``row_form``:
    "records" for a std table, whose payload lanes the placement put in
    K4's record form; None for q8 and q12). Its :meth:`record` is appended
    to :func:`placements` when it ends."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.ns: dict = {}
        self.read_bytes = None
        self.layout_on = "host"
        self.row_form = None
        self._span = Span("place", self.ns)
        self._read0 = None

    def __enter__(self):
        self._read0 = read_bytes()
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        after = read_bytes()
        if self._read0 is not None and after is not None:
            self.read_bytes = after - self._read0
        if exc[0] is None:
            _placements.append(self.record())
        return False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def layout(self, on: str = "host"):
        """The relayout, run ``on`` "host" or "card"."""
        self.layout_on = on
        with Span("place.layout", self.ns):
            yield
            if on == "card":
                self._sync()

    @contextlib.contextmanager
    def copy(self):
        with Span("place.copy", self.ns):
            yield
            self._sync()

    def record(self) -> dict:
        """{"device": its type, "place", "place.layout", "place.copy":
        seconds, "read_bytes": bytes or None, "layout_on": "host" or
        "card"}, and "row_form": "records" for a std table."""
        rec = {"device": self.device.type,
               **{k: v * 1e-9 for k, v in self.ns.items()},
               "read_bytes": self.read_bytes, "layout_on": self.layout_on}
        if self.row_form is not None:
            rec["row_form"] = self.row_form
        return rec


def placements() -> list:
    """The record of every placement this process has made, in order."""
    return list(_placements)


class IndexSpan(Span):
    """Index ``position``'s part of a multi-k step, its ``step.index<i>``
    span, totalled whether or not a trace is collected: each one counts a
    call of the index (k, w, layout) and adds its nanoseconds to the
    index's record; while it is open, :func:`lookup_taken` counts its
    lookup's probes and path."""
    __slots__ = ("record",)

    def __init__(self, position: int, k: int, w: int, layout: str):
        key = (position, k, w, layout)
        rec = _index_steps.get(key)
        if rec is None:
            rec = _index_steps[key] = {
                "index": position, "k": k, "w": w, "layout": layout,
                "calls": 0, "probes": 0, "sorted": 0}
        rec["calls"] += 1
        super().__init__(f"{INDEX}{position}", rec)
        self.record = rec

    def __enter__(self):
        global open_index
        open_index = self.record
        return super().__enter__()

    def __exit__(self, *exc):
        global open_index
        open_index = None
        return super().__exit__(*exc)


def lookup_taken(probes: int, sorted_lookup: bool) -> None:
    """Count a lookup of ``probes`` probes, sorted or not, in the record of
    the open ``step.index<i>`` span (``classify/engine.py``
    ``probe_tables`` reports each where the deep-table gate decides, while
    one is open)."""
    open_index["probes"] += probes
    open_index["sorted"] += sorted_lookup


def index_steps() -> list:
    """Each index's totals over this process's multi-k steps, in order of
    position: {"index", "k", "w", "layout", "calls", "host_s" (seconds
    inside its span), "probes" (B x R a call, summed), "sorted" (calls
    whose lookup took the sorted path)}. Empty where no multi-k step ran."""
    out = []
    for rec in sorted(_index_steps.values(), key=lambda r: r["index"]):
        name = f"{INDEX}{rec['index']}"
        out.append({**{k: v for k, v in rec.items() if k != name},
                    "host_s": rec.get(name, 0) * 1e-9})
    return out
