"""The port's tracer: spans and counters inside the program, on the clock of
torch.profiler's host events, and torch.profiler traces with the spans
merged in.

    with profiling.span("collect", work=T):   # a span of the program's layers
        ...
    profiling.count("captures/50 experience-mode updates")
    profiling.host(t)                          # a readback, inside a "wait" span

A span records its name, its parent, the generation it belongs to (the
``gen`` of the nearest enclosing span that set one: the id of one unit of
work), its host start and end in ns on ``clock``, its work (updates,
macro-steps, or 1) and ``launch_ns``, the host's time inside graph launches
while it was open (``launched``: a launch blocks while the card's launch
queue is full, so that time is the card's, not the host's).  ``clock`` is the one that stamps torch.profiler's host
events, so a span lies on the same time axis as a device trace.  A span
makes no profiler range: the profiler gives a range that holds kernels a
device-side copy, which a trace would count as device work.

Records stay in memory: every span of the last MAX_GENERATIONS generations,
the last MAX_OUTSIDE spans outside any generation, and for each name the
count, nanoseconds and work of every span closed.  A span costs two clock
reads and a few list and dict operations; it creates no CUDA event and makes
no synchronisation, unless ``sync`` asks for one (the set-up spans, once a
run).  With ``device_timing`` on (``run.py --trace-out``) a span on the card
also records a pair of CUDA events, read once by ``snapshot``.

Counters are named integers.  ``utils.graphs`` counts captures, replays and
the kernel nodes that replays run, by graph name, and the kernels' wrappers
their launches by shape; a replay adds what its capture counted
(``utils.graphs.capture``), and its launch's host time to ``launch_ns``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time

import torch

# the clock of torch.profiler's host events (ns since the epoch)
clock = time.time_ns
# generations whose spans are kept; spans kept outside any generation
MAX_GENERATIONS = 10_000
MAX_OUTSIDE = 10_000


class Span:
    """One span; a context manager that records it when it closes."""

    __slots__ = ("tracer", "id", "name", "parent", "gen", "unit", "work", "attr", "sync",
                 "start_ns", "end_ns", "launch_ns", "events")

    def __init__(self, tracer, name, work, gen, attr, sync):
        self.tracer, self.name, self.work, self.gen = tracer, name, work, gen
        self.attr, self.sync = attr, sync
        self.parent = self.unit = self.events = None
        self.start_ns = self.end_ns = self.launch_ns = 0

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self):
        t = self.tracer
        self.id = t.next_id
        t.next_id += 1
        parent = t.stack[-1] if t.stack else None
        if parent is not None:
            self.parent = parent.id
        if self.gen is not None:
            self.unit = self.id
        elif parent is not None:
            self.gen, self.unit = parent.gen, parent.unit
        if t.device_timing:
            self.events = _event_pair()
        t.stack.append(self)
        self.launch_ns = t.launch_ns        # the total so far; the span's own once closed
        self.start_ns = clock()
        return self

    def __exit__(self, kind, value, tb):
        if kind is None and self.sync is not None and torch.device(self.sync).type == "cuda":
            torch.cuda.synchronize(self.sync)
        if self.events is not None:
            self.events[1].record()
        self.end_ns = clock()
        self.launch_ns = self.tracer.launch_ns - self.launch_ns
        self.tracer.close(self)
        return False


def _event_pair():
    """A started pair of timing events on the current stream, or None off the
    card or inside a capture (an event recorded there would join the graph)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    if torch.cuda.is_current_stream_capturing():
        return None
    pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    pair[0].record()
    return pair


class Tracer:
    """The spans, totals, counters and graph nodes of one process."""

    def __init__(self):
        self.device_timing = False
        self.reset()

    def reset(self):
        self.next_id = 0
        self.stack: list = []
        # spans of each generation by the id of its root span, oldest first
        self.units: "collections.OrderedDict[int, list]" = collections.OrderedDict()
        self.outside: collections.deque = collections.deque(maxlen=MAX_OUTSIDE)
        self.totals: dict = {}          # name -> [spans, ns, work]
        self.counters: dict = {}        # name -> int
        self.launch_ns = 0              # host ns inside graph launches, all told
        self.graphs: dict = {}          # graph name -> {node type: count} of its last capture

    def span(self, name: str, work: int = 0, *, gen=None, attr=None, sync=None) -> Span:
        """A span named ``name`` doing ``work``; ``gen`` opens a generation
        (its spans and theirs belong to it); ``attr`` is a free label (a
        graph's name); ``sync`` a device to synchronise before it closes."""
        return Span(self, name, work, gen, attr, sync)

    def close(self, s: Span):
        self.stack.pop()
        total = self.totals.get(s.name)
        if total is None:
            total = self.totals[s.name] = [0, 0, 0]
        total[0] += 1
        total[1] += s.end_ns - s.start_ns
        total[2] += s.work
        if s.unit is None:
            self.outside.append(s)
            return
        kept = self.units.get(s.unit)
        if kept is None:
            kept = self.units[s.unit] = []
            while len(self.units) > MAX_GENERATIONS:
                self.units.popitem(last=False)
        kept.append(s)

    def count(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    def launched(self, ns: int):
        """Add ``ns`` of host time inside a graph launch (``utils.graphs``)."""
        self.launch_ns += ns

    def spans(self) -> list:
        """Every span kept, by start."""
        out = list(self.outside) + [s for kept in self.units.values() for s in kept]
        return sorted(out, key=lambda s: (s.start_ns, s.id))

    def generations(self) -> list:
        """(root span, its spans) of each generation kept whose root has
        closed, oldest first."""
        out = []
        for unit, kept in self.units.items():
            root = next((s for s in kept if s.id == unit), None)
            if root is not None:
                out.append((root, kept))
        return out

    def seconds(self, name: str) -> float:
        """Host seconds of every span ``name`` ever closed."""
        return self.totals.get(name, (0, 0, 0))[1] * 1e-9

    def snapshot(self) -> dict:
        """Everything recorded, as JSON-ready data; device milliseconds per
        span where device timing recorded events (one synchronisation)."""
        spans = self.spans()
        if any(s.events is not None for s in spans):
            torch.cuda.synchronize()
        rows = []
        for s in spans:
            row = dict(id=s.id, name=s.name, parent=s.parent, gen=s.gen, start_ns=s.start_ns,
                       end_ns=s.end_ns, work=s.work, launch_ns=s.launch_ns)
            if s.attr is not None:
                row["attr"] = s.attr
            if s.events is not None:
                row["device_ms"] = s.events[0].elapsed_time(s.events[1])
            rows.append(row)
        return dict(clock="time.time_ns", spans=rows,
                    totals={k: dict(spans=v[0], seconds=v[1] * 1e-9, work=v[2])
                            for k, v in self.totals.items()},
                    counters=dict(self.counters), graphs=dict(self.graphs))

    def export(self, path: str):
        """Write ``snapshot`` as JSON to ``path``."""
        data = self.snapshot()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(data, f)


# the process's tracer
TRACER = Tracer()


def span(name: str, work: int = 0, *, gen=None, attr=None, sync=None) -> Span:
    """A span of the process's tracer (``Tracer.span``)."""
    return TRACER.span(name, work, gen=gen, attr=attr, sync=sync)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` of the process's tracer."""
    TRACER.count(name, n)


def host(*tensors):
    """The host values of ``tensors`` (a number for a 0-d tensor, a numpy
    array otherwise), read back inside a ``wait`` span: every
    synchronising readback of the generation loop goes through here."""
    with span("wait"):
        out = tuple(t.item() if t.dim() == 0 else t.cpu().numpy() for t in tensors)
    return out[0] if len(tensors) == 1 else out


def merge_spans(path: str, spans):
    """Add ``spans`` to the Chrome trace at ``path`` (one written by
    torch.profiler) as a host track "program spans", on the trace's clock."""
    with open(path) as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds", 0)
    pid, tid = os.getpid(), "program spans"
    events = data.setdefault("traceEvents", [])
    events.append(dict(ph="M", name="thread_name", pid=pid, tid=tid, args=dict(name=tid)))
    for s in spans:
        args = dict(gen=s.gen, work=s.work)
        if s.attr is not None:
            args["attr"] = s.attr
        events.append(dict(ph="X", cat="program_span", name=s.name, pid=pid, tid=tid,
                           ts=(s.start_ns - base) / 1e3, dur=(s.end_ns - s.start_ns) / 1e3,
                           args=args))
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler context over the CPU and, when there is one, the card;
    writes ``<log_dir>/trace.json`` on exit, with the program's spans that
    closed inside the block merged in as a host track on the same clock.  A
    profiler that cannot start leaves the block to run unprofiled."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except RuntimeError:
        prof = None
    t0 = clock()
    try:
        yield prof
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, "trace.json")
            prof.export_chrome_trace(path)
            merge_spans(path, [s for s in TRACER.spans() if s.end_ns >= t0])
