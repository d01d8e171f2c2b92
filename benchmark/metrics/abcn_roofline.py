"""abcn_roofline: the ABCN macro-step kernel's share of its bound over the
profiled stretch: the bound of every launch at its shapes
(``yardstick.abcn_bound``) over the kernel's device time by name in the
profiler's trace."""

import yardstick

LAYER = "kernels (kernels.abcn, kernels.mlp)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "exp_per_s"
KERNELS = ("abcn_macro_step_kernel",)


def read(ctx):
    calls = [e for e in ctx["launches"] if e[0] == "abcn"]
    found = [v for name, v in ctx["profile"]["kernels"].items()
             if any(k in name for k in KERNELS)]
    seconds, count = sum(v[0] for v in found), sum(v[1] for v in found)
    if not calls or not seconds or count != len(calls):
        return None
    bound = sum(yardstick.abcn_bound(B, N, n) for _, B, N, n in calls)
    return 100.0 * bound / seconds
