"""What the benchmark records around the program, from outside it: graph
captures (none may fall inside a window), spans of the program's layers by
CUDA events, the hand-written kernels' launches with their shapes, and a
torch.profiler stretch reduced to kernel times, the device's busy share and
its longest idle gaps.

Every wrapper replaces a module attribute that the program looks up at call
time and records around the original; ``Patches.restore`` puts each back.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


class Patches:
    """Module attributes replaced by wrappers, and their originals."""

    def __init__(self):
        self.saved = []

    def wrap(self, module, name: str, make):
        """module.<name> = make(original)."""
        original = getattr(module, name)
        self.saved.append((module, name, original))
        setattr(module, name, make(original))
        return original

    def restore(self):
        for module, name, original in reversed(self.saved):
            setattr(module, name, original)
        self.saved.clear()


class Captures:
    """Counts the ``utils.graphs.capture`` calls made while ``in_window`` is
    set, with their names."""

    def __init__(self, patches: Patches, graphs):
        self.in_window_count = 0
        self.in_window = False
        self.names = []

        def make(capture):
            @functools.wraps(capture)
            def counted(name, *args, **kw):
                if self.in_window:
                    self.in_window_count += 1
                    self.names.append(name)
                return capture(name, *args, **kw)
            return counted

        patches.wrap(graphs, "capture", make)


class Spans:
    """CUDA-event spans around calls of the program's layers, while
    ``active``: per layer, a list of (start event, end event, work count)."""

    def __init__(self, patches: Patches):
        self.patches = patches
        self.active = False
        self.done: dict = {}

    def wrap(self, module, name: str, layer: str, count):
        """Record ``layer`` around module.<name>; ``count(args, kw)`` is the
        work of one call (updates, macro-steps, generations)."""

        def make(fn):
            @functools.wraps(fn)
            def spanned(*args, **kw):
                if not self.active:
                    return fn(*args, **kw)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with torch.profiler.record_function(f"bench:{layer}"):
                    start.record()
                    out = fn(*args, **kw)
                    end.record()
                self.done.setdefault(layer, []).append((start, end, count(args, kw)))
                return out
            return spanned

        self.patches.wrap(module, name, make)

    def take(self):
        """{layer: (milliseconds, work)} of everything recorded since the last
        call (synchronises)."""
        torch.cuda.synchronize()
        out = {layer: (sum(s.elapsed_time(e) for s, e, _ in rows), sum(n for _, _, n in rows))
               for layer, rows in self.done.items()}
        self.done = {}
        return out


class Launches:
    """The hand-written kernels' launches with their shapes, eager or
    replayed: a launch recorded while a graph is captured is added to the
    record again at every replay of that graph.  ``log`` collects while
    ``active``."""

    def __init__(self, patches: Patches, graphs, abcn, mlp):
        self.active = False
        self.log: list = []
        self._capturing = None
        launches = self

        def record(entry):
            if launches._capturing is not None:
                launches._capturing.append(entry)
            elif launches.active:
                launches.log.append(entry)

        def make_abcn(fn):
            @functools.wraps(fn)
            def recorded(u, *args, **kw):
                if u.is_cuda:
                    record(("abcn", u.shape[0], u.shape[1], kw["n_intermediate"]))
                return fn(u, *args, **kw)
            return recorded

        def make_mlp(fn):
            @functools.wraps(fn)
            def recorded(obs, net, *args, **kw):
                if obs.is_cuda:
                    record(("mlp", obs.shape[0], obs.shape[1], net.width, net.act_dim))
                return fn(obs, net, *args, **kw)
            return recorded

        patches.wrap(abcn, "abcn_macro_step", make_abcn)
        patches.wrap(mlp, "mlp_forward", make_mlp)

        def make_graph(cls):
            class RecordedGraph(cls):
                def capture(self, fn):
                    self.bench_launches = []
                    launches._capturing = self.bench_launches
                    try:
                        return super().capture(fn)
                    finally:
                        launches._capturing = None

                def replay(self):
                    super().replay()
                    if launches.active:
                        launches.log.extend(getattr(self, "bench_launches", ()))
            return RecordedGraph

        patches.wrap(graphs, "new_graph", make_graph)

    def take(self):
        out, self.log = self.log, []
        return out


class Profile:
    """One torch.profiler stretch over the CPU and the card."""

    def __init__(self):
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self):
        self.prof.__exit__(None, None, None)

    def summary(self, wall_s: float) -> dict:
        """(Seconds, count) of each device operation by name, the card's busy seconds (the union of its
        kernels, copies and fills), the stretch's length, and the longest idle
        gaps named by the innermost host span running at their start."""
        dev, cpu = [], []
        for e in self.prof.profiler.kineto_results.events():
            start, dur, name = e.start_ns(), e.duration_ns(), e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not name.startswith("bench:"):     # the spans' own device-side ranges
                    dev.append((start, start + dur, name))
            elif dur > 0:
                cpu.append((start, start + dur, name))
        if not dev:
            return dict(kernels={}, busy_s=0.0, window_s=wall_s, gaps=[], ops=[])
        s = np.array([d[0] for d in dev], dtype=np.int64)
        t = np.array([d[1] for d in dev], dtype=np.int64)
        order = np.argsort(s, kind="stable")
        s, t = s[order], t[order]
        reach = np.maximum.accumulate(t)
        new = np.r_[True, s[1:] > reach[:-1]]          # starts after all before it ended
        seg_start = s[new]
        seg_end = np.r_[reach[np.flatnonzero(new)[1:] - 1], reach[-1]]
        busy_ns = int((seg_end - seg_start).sum())
        gaps_ns = seg_start[1:] - seg_end[:-1]
        kernels: dict = {}
        for a, b, name in dev:
            seconds, count = kernels.get(name, (0.0, 0))
            kernels[name] = (seconds + (b - a) * 1e-9, count + 1)
        ops = sorted(((n, v[0]) for n, v in kernels.items()), key=lambda kv: -kv[1])[:10]
        gaps = []
        if len(gaps_ns):
            c0 = np.array([c[0] for c in cpu], dtype=np.int64)
            c1 = np.array([c[1] for c in cpu], dtype=np.int64)
            for i in np.argsort(-gaps_ns)[:10]:
                at = seg_end[i]
                inside = np.flatnonzero((c0 <= at) & (c1 > at))
                label = "host idle"
                if len(inside):
                    spans = [j for j in inside if cpu[j][2].startswith("bench:")]
                    inner = inside[np.argmin(c1[inside] - c0[inside])]
                    outer = cpu[spans[0]][2][6:] if spans else None
                    label = cpu[inner][2] if outer is None else f"{outer}/{cpu[inner][2]}"
                gaps.append([label, float(gaps_ns[i]) * 1e-9])
        self.prof = None
        return dict(kernels=kernels, busy_s=busy_ns * 1e-9, window_s=wall_s, gaps=gaps,
                    ops=[[n, v] for n, v in ops])
