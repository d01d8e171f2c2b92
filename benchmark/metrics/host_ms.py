"""host_ms: milliseconds of a generation's host time that is the host's own:
the program's ``generation`` span less its ``wait`` spans (its synchronising
readbacks) and less its time inside graph launches (the span's
``launch_ns``: a launch blocks while the card's launch queue is full), mean
over the window's generations before the profiled stretch (the profiler
leaves the later ones slower on the host).  The last generation the program
closed is the check unit's; the window's are the ones before it, as many as
the window's units and the stretch's."""

import bench_session

LAYER = "generation loop (run -> train.trainer.train)"
UNIT = "ms/gen"
SOURCE = "program_span"
MOVES = "exp_per_s"


def read(ctx):
    from marlpde_tpu_torch.utils import profiling

    tracer = getattr(profiling, "TRACER", None)     # a program without the tracer: nothing
    if tracer is None or not ctx.get("units"):
        return None
    profiled = ctx["traffic"].get("profile_units", 0)
    gens = tracer.generations()
    n = len(ctx["units"]) + profiled
    if len(gens) < n + 1:
        return None
    window = gens[-1 - n:-1]
    before = window[:bench_session.PROFILE_AFTER] if profiled else window
    ns = [root.ns - root.launch_ns - sum(s.ns for s in spans if s.name == "wait")
          for root, spans in before]
    return 1e-6 * sum(ns) / len(ns)
