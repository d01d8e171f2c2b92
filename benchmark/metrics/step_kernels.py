"""step_kernels: kernels a graphed macro-step of the collection runs: the
kernel nodes that the replays of the ``"<env> macro-step"`` graphs ran, over
those replays, from the program's own counters.  The cells run no tests, so
these are the training collection's replays alone."""

LAYER = "collection (envs.rollout.collect_episodes)"
UNIT = "kernels/step"
SOURCE = "program_counter"
MOVES = "exp_per_s"
SUFFIX = " macro-step"


def read(ctx):
    from marlpde_tpu_torch.utils import profiling

    tracer = getattr(profiling, "TRACER", None)     # a program without the tracer: nothing
    if tracer is None or not ctx.get("units"):
        return None

    counters = tracer.counters
    kernels = steps = 0
    for name, replays in counters.items():
        if name.startswith("replays/") and name.endswith(SUFFIX):
            steps += replays
            kernels += counters.get(f"kernels/{name[len('replays/'):]}", 0)
    return kernels / steps if steps else None
