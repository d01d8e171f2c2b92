"""mfu: the policy network's operations that the algorithm needs
(``yardstick.generation_flops``: acting, the insert's values, each update's
forward and backward and its bootstrap forward), over the unprofiled window
units' wall time, as a share of the card's float32 peak (67 TFLOP/s: the
configuration states float32, and the port runs with TF32 off)."""

import yardstick

LAYER = "whole generation"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "exp_per_s"


def read(ctx):
    units = ctx["units"]
    wall = sum(u["wall_s"] for u in units)
    if not units or not wall:
        return None
    return 100.0 * sum(u["flops"] for u in units) / wall / yardstick.FP32_FLOPS
