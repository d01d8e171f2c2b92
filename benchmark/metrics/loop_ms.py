"""loop_ms: milliseconds per generation of ``train.trainer.train`` itself
(the readbacks, the --diag probe, the history, checkpoints, the callback):
each unprofiled window generation's wall time less the spans of its
collection, insert and updates."""

LAYER = "generation loop (run -> train.trainer.train)"
UNIT = "ms/gen"
SOURCE = "program_span"
MOVES = "exp_per_s"
CHILDREN = ("collect", "insert", "updates")


def read(ctx):
    units = ctx["units"]
    if not units or "updates" not in ctx["spans"]:
        return None
    wall_ms = 1e3 * sum(u["wall_s"] for u in units)
    children = sum(ctx["spans"].get(c, (0.0, 0))[0] for c in CHILDREN)
    return (wall_ms - children) / len(units)
