"""update_kernels: kernels a graphed update runs: the kernel nodes that the
replays of the ``"<k> <mode>-mode updates"`` graphs ran, over the updates
those replays ran, from the program's own counters (``utils.graphs`` counts
each captured graph's kernel nodes from the graph itself, and adds them at
every replay)."""

LAYER = "updates (train.trainer.run_updates)"
UNIT = "kernels/update"
SOURCE = "program_counter"
MOVES = "exp_per_s"
SUFFIX = "-mode updates"


def read(ctx):
    from marlpde_tpu_torch.utils import profiling

    tracer = getattr(profiling, "TRACER", None)     # a program without the tracer: nothing
    if tracer is None or not ctx.get("units"):
        return None

    counters = tracer.counters
    kernels = updates = 0
    for name, replays in counters.items():
        if name.startswith("replays/") and name.endswith(SUFFIX):
            graph = name[len("replays/"):]
            updates += replays * int(graph.split()[0])
            kernels += counters.get(f"kernels/{graph}", 0)
    return kernels / updates if updates else None
