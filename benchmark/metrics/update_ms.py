"""update_ms: device milliseconds per update of ``train.trainer.run_updates``
(``rl.vracer.update_experience`` / ``update`` replayed 50 to a graph by
``utils.graphs``), from CUDA events around each call, over the updates that
the window's unprofiled generations ran."""

LAYER = "updates (train.trainer.run_updates)"
UNIT = "ms/update"
SOURCE = "program_span"
MOVES = "exp_per_s"


def read(ctx):
    ms, updates = ctx["spans"].get("updates", (0.0, 0))
    return ms / updates if updates else None
