"""insert_ms: device milliseconds per generation of
``train.trainer.insert_generation`` (``rl.vracer.observe_episodes``, then
``flat_insert`` or ``rl.replay.add_episodes``), from CUDA events around each
call in the window's unprofiled generations."""

LAYER = "insert (train.trainer.insert_generation)"
UNIT = "ms/gen"
SOURCE = "program_span"
MOVES = "exp_per_s"


def read(ctx):
    ms, gens = ctx["spans"].get("insert", (0.0, 0))
    return ms / gens if gens else None
