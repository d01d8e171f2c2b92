"""idle_share: the share of the profiled stretch in which no kernel, copy or
fill ran on the card (the union of the trace's device operations against the
stretch's wall time)."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "exp_per_s"


def read(ctx):
    p = ctx["profile"]
    if not p["busy_s"] or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
