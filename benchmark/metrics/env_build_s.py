"""env_build_s: seconds of the program's ``setup.env`` span
(``run.make_workload``: the env's DNS pool, the KS host pool, its constants
on the card, synchronised)."""

LAYER = "env set-up (run.make_workload)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "setup_s"


def read(ctx):
    from marlpde_tpu_torch.utils import profiling

    tracer = getattr(profiling, "TRACER", None)     # a program without the tracer: nothing
    if tracer is None or not ctx.get("units") or "setup.env" not in tracer.totals:
        return None
    return tracer.seconds("setup.env")
