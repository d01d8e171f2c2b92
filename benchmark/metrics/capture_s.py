"""capture_s: seconds of the program's ``capture`` spans (``utils.graphs.capture``:
each graph's warm-up step, its capture and the count of its nodes), all of
them set-up: the check holds the window's captures at 0."""

LAYER = "graphs (utils.graphs.capture)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "setup_s"


def read(ctx):
    from marlpde_tpu_torch.utils import profiling

    tracer = getattr(profiling, "TRACER", None)     # a program without the tracer: nothing
    if tracer is None or not ctx.get("units") or "capture" not in tracer.totals:
        return None
    return tracer.seconds("capture")
