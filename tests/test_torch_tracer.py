"""The port's tracer (utils/profiling.py) on the CPU: spans, their parents
and generations, the profiler's clock, the record bound, no device events
or profiler ranges with device timing off, the trainer's spans, the graph
counters through the stand-ins, and ``run.py --trace-out``."""

import itertools
import json

import pytest
import torch

import graph_standins as standins
from marlpde_tpu_torch import run
from marlpde_tpu_torch.utils import graphs, profiling

torch.set_num_threads(1)

# a tiny burger-marl run on the CPU: 4 generations, updates from the second,
# a deterministic test every 2 generations and the --diag probe
TINY = ("burger-marl --nagents 4 --specreward --dforce --ic turbulence --NDNS 64 "
        "--dt 0.01 --T 0.1 --episodelength 5 --numenvs 2 --mbsize 8 --rstart 10 "
        "--NE 40 --testfreq 2 --diag --width 16 --run 999").split()
CHILDREN = {"collect", "insert", "updates", "wait", "diag", "test"}


@pytest.fixture
def tracer(monkeypatch):
    t = profiling.Tracer()
    monkeypatch.setattr(profiling, "TRACER", t)
    return t


def test_spans_nest_with_parents_and_generation_ids(tracer):
    with profiling.span("setup.env"):
        pass
    for gen in (1, 2):
        with profiling.span("generation", gen=gen) as root:
            with profiling.span("updates", work=50) as upd:
                with profiling.span("wait") as wait:
                    pass
    outside = list(tracer.outside)
    assert [s.name for s in outside] == ["setup.env"] and outside[0].gen is None
    gens = tracer.generations()
    assert [r.gen for r, _ in gens] == [1, 2]
    root, spans = gens[-1]
    assert {s.name: s.gen for s in spans} == {"generation": 2, "updates": 2, "wait": 2}
    assert (upd.parent, wait.parent, root.parent) == (root.id, upd.id, None)
    assert root.start_ns <= upd.start_ns <= wait.start_ns <= wait.end_ns <= upd.end_ns <= root.end_ns
    assert tracer.totals["updates"][0] == 2 and tracer.totals["updates"][2] == 100
    assert tracer.seconds("wait") == pytest.approx(sum(
        s.ns for _, kept in gens for s in kept if s.name == "wait") * 1e-9)
    assert not tracer.stack


def test_span_encloses_the_profilers_events_of_its_work(tracer):
    """The spans' clock is the one that stamps torch.profiler's host events."""
    x = torch.randn(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("work") as s:
            for _ in range(3):
                x = torch.tanh(x @ x)
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(ops) == 3
    assert all(s.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= s.end_ns
               for e in ops)


def test_no_event_and_no_profiler_range_with_device_timing_off(tracer, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the tracer made a CUDA event or a profiler range")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert not tracer.device_timing
    with profiling.span("generation", gen=1):
        with profiling.span("collect", work=5):
            assert profiling.host(torch.ones(3).sum()) == 3.0
    data = tracer.snapshot()
    assert [r["name"] for r in data["spans"]] == ["generation", "collect", "wait"]
    assert not any("device_ms" in r for r in data["spans"])


def test_records_are_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_GENERATIONS", 3)
    monkeypatch.setattr(profiling, "MAX_OUTSIDE", 4)
    tracer = profiling.Tracer()
    for gen in range(1, 8):
        with tracer.span("generation", gen=gen):
            with tracer.span("collect"):
                pass
        with tracer.span("capture", attr="g"):
            pass
    assert [r.gen for r, _ in tracer.generations()] == [5, 6, 7]
    assert len(tracer.outside) == 4
    # the totals keep every span ever closed
    assert tracer.totals["generation"][0] == tracer.totals["capture"][0] == 7


def test_host_reads_back_inside_a_wait_span(tracer):
    a, b = profiling.host(torch.tensor(2.5), torch.arange(3))
    assert a == 2.5 and b.tolist() == [0, 1, 2]
    assert profiling.host(torch.tensor(7)) == 7
    assert tracer.totals["wait"][0] == 2


def test_train_spans_each_generation_and_the_callback_runs_outside(tracer, monkeypatch,
                                                                  tmp_path):
    """One ``generation`` span a generation, ids 1..4, holding the collection,
    insert, updates, readbacks, probe and tests; the callback runs after the
    generation's span has closed; set-up spans before the first."""
    monkeypatch.chdir(tmp_path)
    calls = []

    def callback(gen, ts, rep, history):
        calls.append((gen, profiling.clock(), list(tracer.stack)))

    _, _, history = run.main(TINY, callback=callback, device="cpu")
    gens = tracer.generations()
    assert [r.gen for r, _ in gens] == [1, 2, 3, 4] == [c[0] for c in calls]
    for (root, spans), (_, at, stack) in zip(gens, calls):
        assert at >= root.end_ns and not stack
        names = {s.name for s in spans} - {"generation"}
        assert {"collect", "insert", "updates", "wait", "diag"} <= names <= CHILDREN
        assert all(s.parent == root.id for s in spans if s.name in ("collect", "updates"))
        work = {s.name: s.work for s in spans}
        assert work["collect"] == 5 and work["updates"] == history["updates"][root.gen - 1]
    assert {s.name for _, spans in gens[1::2] for s in spans} >= {"test"}
    assert [s.name for s in tracer.outside] == ["setup.env", "setup.init", "checkpoint"]
    assert tracer.outside[1].end_ns <= gens[0][0].start_ns <= gens[-1][0].end_ns <= (
        tracer.outside[2].start_ns)
    live = [b - a for a, b in zip([0] + history["experiences"], history["experiences"])]
    assert history["env_steps_per_s"] == pytest.approx(
        [n / (r.ns * 1e-9) for n, (r, _) in zip(live, gens)])


def test_the_program_opens_no_profiler_range(tracer, monkeypatch, tmp_path):
    """Under torch.profiler no host range carries a name of the program's
    spans: a span makes no record_function range, which would also get a
    device-side copy on the card."""
    monkeypatch.chdir(tmp_path)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run.main(TINY, device="cpu")
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    spans = {s.name for s in tracer.spans()}
    assert {"generation", "collect", "updates", "wait"} <= spans
    assert not names & spans


def test_graph_counters_through_the_stand_in(tracer, monkeypatch):
    """A capture counts once by name and its span; every replay adds one
    replay, the graph's kernel nodes (none: the stand-in is no CUDA graph),
    what the step counted by name while it was captured, and its launch's
    host time to the spans open around it."""
    standins.use(monkeypatch, standins.Counted)

    def step():
        profiling.count("launches/mlp 8x3x16x1", 2)

    first, graph = graphs.capture("stand-in step", step, "cpu")
    assert tracer.counters == {"launches/mlp 8x3x16x1": 2, "captures/stand-in step": 1}
    assert graph.named == {"launches/mlp 8x3x16x1": 2} and graph.kernels == 0
    assert tracer.graphs["stand-in step"] == {}
    monkeypatch.setattr(profiling, "clock", itertools.count().__next__)   # ticks at each read
    with profiling.span("generation", gen=1) as root:
        with profiling.span("updates") as inner:
            for _ in range(3):
                graph.replay()
    assert 0 < tracer.launch_ns == inner.launch_ns == root.launch_ns <= inner.ns
    rows = {r["name"]: r for r in tracer.snapshot()["spans"]}
    assert rows["updates"]["launch_ns"] == rows["generation"]["launch_ns"] == 3
    assert tracer.counters == {"launches/mlp 8x3x16x1": 8, "captures/stand-in step": 1,
                               "replays/stand-in step": 3, "kernels/stand-in step": 0}
    assert [(s.name, s.attr) for s in tracer.outside] == [("capture", "stand-in step")]


def test_graph_nodes_are_walked_once_a_name_and_node_total(monkeypatch):
    """A graph's nodes are walked at the first capture of its name with its
    node total; a later capture of both costs one node-total call."""
    totals = {101: 9, 102: 9, 103: 12}
    walks = []
    monkeypatch.setattr(graphs, "_NODES", {})
    monkeypatch.setattr(graphs, "_node_total", totals.get)
    monkeypatch.setattr(graphs, "node_types",
                        lambda raw: walks.append(raw) or {"kernel": totals[raw] - 1, "memcpy": 1})
    assert graphs.nodes("ddp LES step", 101) == {"kernel": 8, "memcpy": 1}
    assert graphs.nodes("ddp LES step", 102) == {"kernel": 8, "memcpy": 1}
    assert graphs.nodes("ddp LES step", 103) == {"kernel": 11, "memcpy": 1}
    assert graphs.nodes("ks macro-step", 102) == {"kernel": 8, "memcpy": 1}
    assert walks == [101, 103, 102]


def test_replayed_stand_in_counts_each_replay_once(tracer, monkeypatch):
    """The stand-in that runs its step at each replay takes the step's own
    counts back, as ``_counts``/``_set_counts`` hold them: a replay adds what
    the capture counted, once."""
    standins.use(monkeypatch, standins.Replayed)
    out = {}

    def step():
        profiling.count("launches/abcn 4x32x10")
        out["x"] = torch.ones(2)
        return out

    _, graph = graphs.capture("replayed step", step, "cpu")
    assert tracer.counters["launches/abcn 4x32x10"] == 1       # the warm-up ran for real
    graph.replay()
    graph.replay()
    assert tracer.counters["launches/abcn 4x32x10"] == 1       # a stand-in capture counts nothing
    assert tracer.counters["replays/replayed step"] == 2


def test_trace_out_writes_every_span_and_counter(monkeypatch, tmp_path):
    """``--trace-out PATH`` starts the tracer afresh with device timing on
    (no events off the card), and writes JSON that holds every span with its
    parent and generation, the totals and the counters."""
    monkeypatch.setattr(profiling, "TRACER", profiling.Tracer())
    monkeypatch.chdir(tmp_path)
    assert run.split_trace_out(["ks", "--trace-out", "a.json", "--NE", "5"]) == (
        "a.json", ["ks", "--NE", "5"])
    path = tmp_path / "out" / "trace.json"
    run.main(TINY + ["--trace-out", str(path)], device="cpu")
    assert not profiling.TRACER.device_timing
    data = json.loads(path.read_text())
    assert data["clock"] == "time.time_ns"
    spans = data["spans"]
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["name"] == "generation"]
    assert [s["gen"] for s in roots] == [1, 2, 3, 4]
    for s in spans:
        if s["parent"] is not None:
            parent = by_id[s["parent"]]
            assert s["gen"] == parent["gen"]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
    totals = data["totals"]
    assert totals["generation"]["spans"] == 4 and totals["setup.env"]["spans"] == 1
    assert totals["updates"]["work"] == sum(s["work"] for s in spans if s["name"] == "updates")
    assert data["counters"] == {} and data["graphs"] == {}
    assert sorted(data) == ["clock", "counters", "graphs", "spans", "totals"]
