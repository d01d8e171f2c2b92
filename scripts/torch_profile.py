"""Profile one steady generation of a benchmark cell's training run on one
NVIDIA card, and split the card's idle time by the program span that was
open on the host when each idle gap began.

    python3 scripts/torch_profile.py [918|926] [--seed N] [--steady K] [--out DIR]

Runs the port's CLI path, ``run.main(argv, callback=...)``, with the flags of
the cell's configuration and traffic (``benchmark/configs``,
``benchmark/traffic``): 918 is ``burger-marl.train-918``, 926
``ks.train-926``.  Every step is a graph replay, as in the benchmark.  Once a
generation has run the traffic's steady update count without capturing a
graph, K more steady generations run with the tracer's device timing off and
on in turn (the CUDA events that ``--trace-out`` adds to every span), then one
generation runs under torch.profiler (CPU and CUDA activity), then K more
with the profiler stopped (what it leaves behind).  The program's
spans carry host times on the profiler's clock, so each idle gap of the card
in that generation is named by

  * "profiler (CUPTI buffers)": a buffer request or flush of the profiler
    itself was running on the host when the gap began;
  * "inside a graph (<span>)": the gap lies between two device operations of
    one graph launch, made while <span> was open;
  * otherwise the innermost program span open on the host at the gap's start
    ("generation" alone: the loop's own code between its children).

Prints the split, the profiled generation's span against the untraced
generations', the card's busy share in it; for the timed generations their
span, waits, host time inside graph launches (the span's ``launch_ns``) and
the host's other time, with device timing off, on, and after the profiler;
kernels per update and per macro-step (the graph counters), the host cost of
one span with device timing off and on, and writes it all as JSON to
``DIR/torch_profile_<cell>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from marlpde_tpu_torch import run  # noqa: E402
from marlpde_tpu_torch.utils import profiling  # noqa: E402

CELLS = {"918": ("burger-marl", "train-918"), "926": ("ks", "train-926")}
CUPTI_ROW = "profiler (CUPTI buffers)"


def cell_argv(cell: str, seed: int):
    """(the CLI arguments of the cell, its steady update count)."""
    config, traffic = CELLS[cell]
    with open(os.path.join(ROOT, "benchmark", "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "traffic", f"{traffic}.json")) as f:
        tr = json.load(f)
    return (cfg["flags"] + tr["flags"] + ["--NE", "1e15", "--seed", str(seed), "--run", "0"],
            tr["steady_updates"])


def n_captures() -> int:
    return sum(n for k, n in profiling.TRACER.counters.items() if k.startswith("captures/"))


class Done(Exception):
    pass


class Schedule:
    """The run's callback: set-up until a steady generation, then K timed
    generations (device timing off and on in turn), the profiled one, and K
    more with the profiler stopped (what it leaves behind)."""

    def __init__(self, steady_updates: int, k: int):
        self.steady_updates, self.k = steady_updates, k
        self.captures = 0
        self.phase = "setup"
        self.rows = []            # one dict a steady generation
        self.prof = None
        self.profiled = None      # (root span, its spans)
        self.t_callback = None

    def __call__(self, gen, ts, rep, history):
        # a unit boundary as the benchmark takes it: synchronised, at the callback
        torch.cuda.synchronize()
        now = time.perf_counter_ns()
        tracer = profiling.TRACER
        root, spans = tracer.generations()[-1]
        captured = n_captures() != self.captures
        self.captures = n_captures()
        unit_ns = now - self.t_callback if self.t_callback is not None else None
        self.t_callback = now
        by_name: dict = {}
        for sp in spans:
            if sp.parent == root.id or sp.name == "wait":
                by_name[sp.name] = by_name.get(sp.name, 0) + sp.ns
        row = dict(gen=gen, phase=self.phase, timing=tracer.device_timing, captured=captured,
                   generation_ms=root.ns * 1e-6, wait_ms=by_name.get("wait", 0) * 1e-6,
                   launch_ms=root.launch_ns * 1e-6,
                   unit_less_generation_ms=None if unit_ns is None else (unit_ns - root.ns) * 1e-6,
                   spans_ms={k: v * 1e-6 for k, v in by_name.items()})
        if self.phase == "setup":
            print(f"[profile] set-up generation {gen}: {history['updates'][-1]} updates, "
                  f"{root.ns * 1e-9:.3f} s{', captured' if captured else ''}", flush=True)
            if history["updates"][-1] == self.steady_updates and not captured:
                self.phase = "before"
        elif self.phase == "profiled":
            self.prof.__exit__(None, None, None)
            self.profiled = (root, spans)
            self.phase = "after"
            tracer.device_timing = False
            return
        else:
            self.rows.append(row)
        n = sum(r["phase"] == self.phase for r in self.rows)
        if self.phase == "before" and n < self.k:
            tracer.device_timing = n % 2 == 1
        elif self.phase == "before":
            tracer.device_timing = False
            self.phase = "profiled"
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        elif self.phase == "after" and n >= self.k:
            raise Done


def device_ops(prof):
    """The card's kernels, copies and fills as arrays (start ns, end ns, launch
    key), by start; the host's buffer events of the profiler as (start, end)
    pairs; {graph launch key: its host start ns}."""
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() != torch.autograd.DeviceType.CUDA]
    host_names = {e.name() for e in host}
    # a device-side copy of a host range (record_function) is no device work
    dev = [e for e in events
           if e.device_type() == torch.autograd.DeviceType.CUDA and e.name() not in host_names]
    start = np.array([e.start_ns() for e in dev], dtype=np.int64)
    end = start + np.array([e.duration_ns() for e in dev], dtype=np.int64)
    key = np.array([e.linked_correlation_id() or e.correlation_id() for e in dev],
                   dtype=np.int64)
    order = np.argsort(start, kind="stable")
    buffers = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in host
               if "buffer" in e.name().lower() and e.duration_ns() > 0]
    launches = {e.correlation_id(): e.start_ns() for e in host if e.name() == "cudaGraphLaunch"}
    return (start[order], end[order], key[order]), buffers, launches


def span_path(sp, by_id) -> str:
    """``sp``'s name after its parents' below the generation ("a/b")."""
    path = [sp.name]
    while sp.parent in by_id and by_id[sp.parent].name != "generation":
        sp = by_id[sp.parent]
        path.append(sp.name)
    return "/".join(reversed(path))


def span_at(spans, t: int):
    """The path of the innermost span open at ``t``, or None."""
    open_ = [s for s in spans if s.start_ns <= t < s.end_ns]
    if not open_:
        return None
    return span_path(min(open_, key=lambda s: s.ns), {s.id: s for s in spans})


def idle_split(prof, root, spans) -> dict:
    """The card's busy and idle time inside the generation span ``root``, the
    idle time split by rows (the module docstring)."""
    (s, t, key), buffers, launches = device_ops(prof)
    lo, hi = root.start_ns, root.end_ns
    keep = (t > lo) & (s < hi)
    s, t, key = np.maximum(s[keep], lo), np.minimum(t[keep], hi), key[keep]
    if not len(s):
        return dict(wall_ms=(hi - lo) * 1e-6, busy_ms=0.0, idle_ms=(hi - lo) * 1e-6,
                    device_ops=0, rows=[["no device operation", (hi - lo) * 1e-6, 1]])
    reach = np.maximum.accumulate(t)
    new = np.r_[True, s[1:] > reach[:-1]]                  # starts after all before it ended
    first = np.flatnonzero(new)                            # each busy segment's first op
    seg_start = s[first]
    seg_end = np.r_[reach[first[1:] - 1], reach[-1]]
    busy = int((seg_end - seg_start).sum())
    # the gaps: before the first op, between segments, after the last
    gap_a = np.r_[lo, seg_end]
    gap_b = np.r_[seg_start, hi]
    # a gap between two operations of one graph launch lies inside the graph
    inside = np.r_[False, (key[first[1:] - 1] == key[first[1:]])
                   & np.isin(key[first[1:]], list(launches)), False]
    labels = np.array(["outside the generation"] * len(gap_a), dtype=object)
    by_id = {sp.id: sp for sp in spans}
    for sp in sorted(spans, key=lambda x: -x.ns):          # the innermost span last
        labels[(gap_a >= sp.start_ns) & (gap_a < sp.end_ns)] = span_path(sp, by_id)
    for a, b in buffers:
        labels[(gap_a >= a) & (gap_a < b)] = CUPTI_ROW
    launch_span = {k: span_at(spans, v) or "no span" for k, v in launches.items()}
    for i in np.flatnonzero(inside):
        labels[i] = f"inside a graph ({launch_span[int(key[first[i]])]})"
    rows: dict = {}
    for label, a, b in zip(labels, gap_a, gap_b):
        if b > a:
            ns, n = rows.get(label, (0, 0))
            rows[label] = (ns + int(b - a), n + 1)
    idle = sum(ns for ns, _ in rows.values())
    return dict(wall_ms=(hi - lo) * 1e-6, busy_ms=busy * 1e-6, idle_ms=idle * 1e-6,
                device_ops=int(len(s)),
                rows=sorted(([k, ns * 1e-6, n] for k, (ns, n) in rows.items()),
                            key=lambda r: -r[1]))


def kernels_per_unit() -> dict:
    counters = profiling.TRACER.counters
    out = {}
    for name, replays in counters.items():
        if name.startswith("replays/"):
            graph = name[len("replays/"):]
            out[graph] = dict(replays=replays, kernels_per_replay=(
                counters.get(f"kernels/{graph}", 0) / replays),
                nodes=profiling.TRACER.graphs.get(graph, {}))
    return out


def span_cost_ns(device_timing: bool, n: int = 20_000) -> float:
    """Host ns of one empty span of a scratch tracer, with device timing off
    or on (a pair of CUDA events recorded on the current stream)."""
    tracer = profiling.Tracer()
    tracer.device_timing = device_timing
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with tracer.span("probe", 1):
            pass
    out = (time.perf_counter_ns() - t0) / n
    torch.cuda.synchronize()
    return out


def main() -> int:
    p = argparse.ArgumentParser(prog="scripts/torch_profile.py")
    p.add_argument("cell", nargs="?", default="926", choices=sorted(CELLS))
    p.add_argument("--seed", type=int, default=2**31 + 101)
    p.add_argument("--steady", type=int, default=8,
                   help="steady generations timed before the profiled one (device timing "
                        "off and on in turn), and after it")
    p.add_argument("--out", default="chiprun_out/profile")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[profile] {card}; torch {torch.__version__}")
    argv, steady_updates = cell_argv(args.cell, args.seed)
    schedule = Schedule(steady_updates, args.steady)
    out_dir = os.path.abspath(args.out)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            run.main(argv, callback=schedule)
        except Done:
            pass
        finally:
            os.chdir(cwd)
    root, spans = schedule.profiled
    split = idle_split(schedule.prof, root, spans)
    tracer = profiling.TRACER
    tracer.device_timing = True
    with tracer.span("probe"):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracer.snapshot()
    snapshot_s = time.perf_counter() - t0
    rows = [r for r in schedule.rows if not r["captured"]]
    med = lambda xs: statistics.median(xs) if xs else float("nan")

    def summary(select):
        picked = [r for r in rows if select(r)]
        return dict(generations=len(picked),
                    **{k: med([r[k] for r in picked])
                       for k in ("generation_ms", "wait_ms", "launch_ms")},
                    host_other_ms=med([r["generation_ms"] - r["wait_ms"] - r["launch_ms"]
                                       for r in picked]))

    groups = {"before, timing off": lambda r: r["phase"] == "before" and not r["timing"],
              "before, timing on": lambda r: r["phase"] == "before" and r["timing"],
              "after the profiler": lambda r: r["phase"] == "after"}
    result = dict(
        cell=args.cell, card=card, torch=torch.__version__, seed=args.seed,
        profiled_generation_s=root.ns * 1e-9,
        busy_share=split["busy_ms"] / split["wall_ms"], idle_split=split,
        groups={name: summary(f) for name, f in groups.items()},
        rows=schedule.rows, snapshot_s=snapshot_s,
        span_ns={"timing off": span_cost_ns(False), "timing on": span_cost_ns(True)},
        spans_per_generation=len(spans), graphs=kernels_per_unit(),
        setup={k: v["seconds"] for k, v in tracer.snapshot()["totals"].items()
               if k.startswith("setup.") or k == "capture"})
    untraced = result["groups"]["before, timing off"]["generation_ms"]
    print(f"[profile] profiled generation {root.ns * 1e-6:.1f} ms against {untraced:.1f} ms "
          f"untraced; card busy {100 * result['busy_share']:.1f}%, "
          f"{split['device_ops']} device operations")
    print(f"[profile] idle {split['idle_ms']:.2f} ms of {split['wall_ms']:.2f}, by row:")
    for label, ms, n in split["rows"]:
        print(f"[profile]   {ms:9.3f} ms  {100 * ms / split['idle_ms']:5.1f}%  "
              f"{n:7d} gaps  {label}")
    print("[profile] steady generations, medians (ms): generation, waits, inside graph "
          "launches, the rest of the host's")
    for name, g in result["groups"].items():
        print(f"[profile]   {name:20s} x{g['generations']:2d}  {g['generation_ms']:9.2f} "
              f"{g['wait_ms']:9.2f} {g['launch_ms']:9.2f} {g['host_other_ms']:9.2f}")
    for r in schedule.rows:
        print(f"[profile]   gen {r['gen']} {r['phase']} timing={r['timing']} "
              + json.dumps({k: round(v, 3) for k, v in r["spans_ms"].items()})
              + f" launch {r['launch_ms']:.2f} unit-gen {r['unit_less_generation_ms']}")
    off, on = result["span_ns"]["timing off"], result["span_ns"]["timing on"]
    print(f"[profile] one span {off:.0f} ns with device timing off, {on:.0f} ns on; "
          f"{len(spans)} spans a generation, so timing adds {len(spans) * (on - off) * 1e-3:.1f} "
          f"us of host time a generation; snapshot {snapshot_s:.3f} s")
    for graph, g in result["graphs"].items():
        print(f"[profile] graph {graph!r}: {g['replays']} replays, "
              f"{g['kernels_per_replay']:.1f} kernel nodes a replay, nodes {g['nodes']}")
    print(f"[profile] set-up spans (s): {json.dumps(result['setup'])}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"torch_profile_{args.cell}.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
