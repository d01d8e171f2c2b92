"""collect_ms: device milliseconds per macro-step of
``envs.rollout.collect_episodes`` (the reset, then the ``MacroStep`` graph
replays: policy, env step, features, reward), from CUDA events around each
call, over the macro-steps of the window's unprofiled units."""

LAYER = "collection (envs.rollout.collect_episodes)"
UNIT = "ms/step"
SOURCE = "program_span"
MOVES = "exp_per_s"


def read(ctx):
    ms, steps = ctx["spans"].get("collect", (0.0, 0))
    return ms / steps if steps else None
