"""One run of one cell: set-up, the measured window, the traced stretch, the
check after the window, and the result line.

A runner (``runners/<name>.py``) runs the program and calls ``boundary`` at
the end of every unit of work (a training generation, an evaluation) with
what that unit did.  The session opens the window at the boundary the runner
names, closes it at the first boundary at least ``--seconds`` later, and then
lets one more unit run for the check, whose inputs and outputs the wrappers
of ``install`` snapshot.  With ``--trace 1`` it records the layers' spans
over the window, and a torch.profiler stretch of the traffic's
``profile_units`` units after its first unit.
"""

from __future__ import annotations

import math
import sys
import time

import torch

import bench_check
import bench_spec
import bench_trace
import yardstick


# the profiled stretch starts after the window's first unit
PROFILE_AFTER = 1


class StopRun(Exception):
    """Raised from a boundary to end the program's run after the check unit."""


class Session:
    def __init__(self, cell: bench_spec.Cell, args, t0: float, device):
        self.cell, self.args, self.t0, self.device = cell, args, t0, torch.device(device)
        self.traffic, self.config = cell.traffic, cell.config
        self.phase = "setup"
        self.units: list = []           # the window's units: dicts the runner gives
        self.t_start = self.t_prev = self.t_end = None
        self.setup_s = None
        self.memory_peak = None
        self.snap = bench_check.Snapshot()
        self.patches = bench_trace.Patches()
        self.trace = bool(args.trace)
        self.spans = self.launches = self.profile = None
        self.stretch = None             # (first unit, last unit) of the profiled stretch
        self.span_parts = []
        self.stretch_launches = []
        self.stretch_summary = None
        self.stretch_wall = 0.0
        self._update_ts = None

    # -- wrappers ---------------------------------------------------------
    def install(self, trainer, graphs, abcn, mlp, layers):
        """Count captures; snapshot the check unit's stages; with tracing,
        spans around ``layers`` ({name: (module, attribute, count)}) and
        the kernels' launches."""
        self.captures = bench_trace.Captures(self.patches, graphs)
        self._install_check(trainer, graphs)
        if self.trace:
            self.spans = bench_trace.Spans(self.patches)
            for layer, (module, attr, count) in layers.items():
                self.spans.wrap(module, attr, layer, count)
            self.launches = bench_trace.Launches(self.patches, graphs, abcn, mlp)
            self.profile = bench_trace.Profile()

    def _install_check(self, trainer, graphs):
        snap, session = self.snap, self

        def params(ts):
            return [p.detach().clone() for p in ts.net.parameters()]

        def make_collect(fn):
            def collect(env, rl_cfg, ts, generator, batch_size, episode_base=0, **kw):
                if snap.init_params is None:
                    snap.init_params = params(ts)
                if session.phase != "check" or snap.traj is not None:
                    return fn(env, rl_cfg, ts, generator, batch_size, episode_base, **kw)
                snap.collect_params = params(ts)
                snap.obs_stats = bench_check.stats_tuple(ts.obs_stats)
                snap.episode_base = int(episode_base)
                traj, final = fn(env, rl_cfg, ts, generator, batch_size, episode_base, **kw)
                snap.traj = {k: v.detach().clone() for k, v in traj.items()}
                return traj, final
            return collect

        def make_insert(fn):
            def insert(rl_cfg, ts, rep, traj):
                if session.phase != "check" or snap.replay_before is not None:
                    return fn(rl_cfg, ts, rep, traj)
                snap.insert_stats = (bench_check.stats_tuple(ts.obs_stats),
                                     bench_check.stats_tuple(ts.rew_stats))
                snap.insert_n_updates = int(ts.n_updates)
                snap.replay_before = bench_check.replay_clone(rep)
                ts, rep = fn(rl_cfg, ts, rep, traj)
                snap.stats_after = (bench_check.stats_tuple(ts.obs_stats),
                                    bench_check.stats_tuple(ts.rew_stats))
                snap.replay_after = bench_check.replay_clone(rep)
                return ts, rep
            return insert

        def make_updates(fn):
            def updates(rl_cfg, ts, rep, generator, n, *a, **kw):
                if session.phase == "check" and snap.update_params is None and n:
                    snap.update_params = params(ts)
                    snap.update_opt = [{k: v.detach().clone() for k, v in ts.opt.state[p].items()}
                                       for p in ts.net.parameters()]
                    snap.update_beta = float(ts.beta)
                    snap.update_n = int(ts.n_updates)
                    snap.update_generator = generator.get_state()
                    session._update_ts = ts
                out = fn(rl_cfg, ts, rep, generator, n, *a, **kw)
                if session._update_ts is ts:
                    # no graph replay (the CPU): the check follows all n updates
                    snap.update_k = n
                    snap.params_after = params(ts)
                    snap.loss_after = float(out[2].get("loss", math.nan))
                    session._update_ts = None
                return out
            return updates

        def make_replay(fn):
            def replay(graph):
                out = fn(graph)
                ts = session._update_ts
                if ts is not None and graph.name.endswith("-mode updates"):
                    snap.update_k = int(graph.name.split()[0])
                    snap.params_after = params(ts)
                    snap.loss_after = float(out["loss"])
                    session._update_ts = None
                return out
            return replay

        self.patches.wrap(trainer, "collect_episodes", make_collect)
        self.patches.wrap(trainer, "insert_generation", make_insert)
        self.patches.wrap(trainer, "run_updates", make_updates)
        self.patches.wrap(graphs.StepGraph, "replay", make_replay)

    # -- the window -------------------------------------------------------
    def begin(self):
        """Open the window at this boundary."""
        self.sync()
        self.t_start = self.t_prev = time.perf_counter()
        self.setup_s = self.t_start - self.t0
        self.phase = "window"
        self.captures.in_window = True
        if self.trace:
            self.spans.active = True

    def boundary(self, unit: dict):
        """The end of one unit; ``unit`` holds its work (``live`` experiences,
        ``episodes``, ``blowups``, ``flops``).  Returns False while the run
        goes on; raises StopRun after the check unit."""
        if self.phase == "check":
            raise StopRun
        if self.phase != "window":
            return False
        self.sync()
        now = time.perf_counter()
        unit = dict(unit, wall_s=now - self.t_prev, profiled=False)
        self.units.append(unit)
        self.t_prev = now
        if self.trace:
            self._stretch(len(self.units), now)
        if now - self.t_start >= self.args.seconds and self.stretch_done():
            self.t_end = now
            self.memory_peak = (torch.cuda.max_memory_allocated(self.device)
                                if self.device.type == "cuda" else 0)
            self.captures.in_window = False
            if self.trace:
                self.span_parts.append(self.spans.take())
                self.spans.active = False
            self.phase = "check"
        return False

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stretch_done(self) -> bool:
        return not self.trace or (self.stretch is not None and self.stretch[1] is not None)

    def _stretch(self, n_units: int, now: float):
        k = self.traffic["profile_units"]
        if self.stretch is None and n_units == PROFILE_AFTER:
            self.span_parts.append(self.spans.take())
            self.launches.take()
            self.launches.active = True
            self.stretch = (n_units, None)
            self.profile.start()
            self._stretch_t0 = self.t_prev = time.perf_counter()
        elif self.stretch is not None and self.stretch[1] is None and n_units == self.stretch[0] + k:
            self.stretch_wall = now - self._stretch_t0
            self.profile.stop()
            self.launches.active = False
            self.stretch_launches = self.launches.take()
            self.spans.take()                       # the stretch's own spans are not kept
            self.stretch = (self.stretch[0], n_units)
            for u in self.units[self.stretch[0]:n_units]:
                u["profiled"] = True
            self.t_prev = time.perf_counter()       # the profiler's stop is no unit's time

    # -- results ----------------------------------------------------------
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def end_to_end(self) -> dict:
        live = sum(u["live"] for u in self.units)
        values = {"exp_per_s": yardstick.rate(live, self.window_s()), "setup_s": self.setup_s}
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in self.cell.end_to_end}

    def per_layer(self) -> dict:
        plain = [u for u in self.units if not u["profiled"]]
        spans: dict = {}
        for part in self.span_parts:
            for layer, (ms, work) in part.items():
                old = spans.get(layer, (0.0, 0))
                spans[layer] = (old[0] + ms, old[1] + work)
        if self.stretch_summary is None:
            self.stretch_summary = self.profile.summary(self.stretch_wall)
        ctx = dict(cell=self.cell.name, config=self.config, traffic=self.traffic,
                   spans=spans, units=plain, profile=self.stretch_summary,
                   launches=self.stretch_launches)
        out = {}
        for m in self.cell.per_layer:
            value = bench_spec.load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out

    def device_info(self) -> dict:
        out = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                   count=self.cell.chips, memory_peak_bytes=int(self.memory_peak))
        if self.trace:
            out.update(busy_s=self.stretch_summary["busy_s"],
                       window_s=self.stretch_summary["window_s"])
        return out


def checks(values: dict, limits: dict, captures: int) -> dict:
    """{name: {"value", "limit"}} of every number compared; the window's
    graph captures are one of them, with the limit 0."""
    missing = sorted(set(values) - set(limits))
    if missing:
        raise SystemExit(f"[bench] no limit for {missing}")
    out = {name: {"value": values[name], "limit": limits[name]}
           for name in bench_check.NAMES if name in values}
    out["window_captures"] = {"value": captures, "limit": 0}
    return out


def passed(check: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in check.values())


def printable(check: dict) -> dict:
    """Non-finite readings as strings, so that the line stays JSON."""
    return {k: {"value": v["value"] if math.isfinite(v["value"]) else str(v["value"]),
                "limit": v["limit"]} for k, v in check.items()}


def report(check: dict):
    for name, c in check.items():
        print(f"[bench] check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
