"""The readers of the program's own spans and counters (``update_kernels``,
``step_kernels``, ``host_ms``, ``capture_s``, ``env_build_s``) on a
synthetic tracer state: each reads what it names, ``host_ms`` exactly the
window's generations before the profiled stretch, less their waits and
graph launches, and each reads nothing from a program without the tracer."""

from __future__ import annotations

import pytest

import bench_session
import bench_spec
from marlpde_tpu_torch.utils import profiling

NEW = ("update_kernels", "step_kernels", "host_ms", "capture_s", "env_build_s")
UNITS = [{"wall_s": 1.0, "profiled": False}]


class Clock:
    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


@pytest.fixture
def state(monkeypatch):
    tracer = profiling.Tracer()
    clock = Clock()
    monkeypatch.setattr(profiling, "TRACER", tracer)
    monkeypatch.setattr(profiling, "clock", clock)
    return tracer, clock


def read(metric, ctx):
    return bench_spec.load_module("metrics", metric).read(ctx)


def generation(tracer, clock, gen, own_ns, wait_ns, launch_ns):
    """A generation span of ``own_ns`` host time outside ``wait_ns`` of waits
    and ``launch_ns`` inside a graph launch."""
    with tracer.span("generation", gen=gen):
        clock.t += own_ns // 2
        with tracer.span("updates", work=50):
            clock.t += launch_ns
            tracer.launched(launch_ns)
            with tracer.span("wait"):
                clock.t += wait_ns
        clock.t += own_ns - own_ns // 2


def test_host_ms_reads_the_window_units_and_no_other_generation(state):
    """host_ms reads the window's generations before the profiled stretch:
    no set-up, profiled, later or check generation."""
    tracer, clock = state
    # set-up generations 1-2, window 3-8 (4 is the profiled one), check 9
    own = {g: 1_000_000 * g for g in range(1, 10)}
    for g in range(1, 10):
        generation(tracer, clock, g, own[g], wait_ns=7_000_000, launch_ns=40_000_000 * g)
    window = list(range(3, 9))
    start = bench_session.PROFILE_AFTER
    for profiled, before in ((1, window[:start]), (0, window)):
        if profiled:
            assert before == [3]
        n = len(window) - profiled
        ctx = dict(units=[{"wall_s": 0.0, "profiled": False}] * n,
                   traffic=dict(profile_units=profiled))
        assert read("host_ms", ctx) == pytest.approx(
            sum(own[g] for g in before) * 1e-6 / len(before))
    # fewer generations than the window and the check unit: nothing to read
    ctx = dict(units=[{"wall_s": 0.0, "profiled": False}] * 8,
               traffic=dict(profile_units=1))
    assert read("host_ms", ctx) is None


def test_kernel_counts_per_update_and_per_macro_step(state):
    tracer, _ = state
    ctx = dict(units=UNITS, traffic={})
    assert read("update_kernels", ctx) is None and read("step_kernels", ctx) is None
    tracer.counters.update({
        "replays/50 experience-mode updates": 4,
        "kernels/50 experience-mode updates": 4 * 50 * 600,
        "replays/7 experience-mode updates": 1,
        "kernels/7 experience-mode updates": 7 * 600,
        "replays/burger macro-step": 1000, "kernels/burger macro-step": 1000 * 61,
        "captures/burger macro-step": 1, "launches/mlp 8x3x256x1": 3000})
    assert read("update_kernels", ctx) == pytest.approx(600.0)
    assert read("step_kernels", ctx) == pytest.approx(61.0)


def test_set_up_spans(state):
    tracer, clock = state
    ctx = dict(units=UNITS, traffic={})
    assert read("capture_s", ctx) is None and read("env_build_s", ctx) is None
    with tracer.span("setup.env"):
        clock.t += 7_250_000_000
    for ns in (1_500_000_000, 250_000_000):
        with tracer.span("capture", attr="g"):
            clock.t += ns
    assert read("env_build_s", ctx) == pytest.approx(7.25)
    assert read("capture_s", ctx) == pytest.approx(1.75)
    # a run with no window reads nothing
    assert read("env_build_s", dict(units=[])) is None


@pytest.mark.parametrize("metric", NEW)
def test_a_program_without_the_tracer_reads_nothing(monkeypatch, metric):
    monkeypatch.delattr(profiling, "TRACER")
    assert read(metric, dict(units=UNITS, traffic=dict(profile_units=1))) is None
