"""The benchmark's arithmetic, frozen here so that a change to the program
cannot move the yardstick: the card's peaks, the bound of each hand-written
kernel's call, the policy network's operation count, the window's rate and
the spread of a set of runs.

``abcn_bound``, ``mlp_bound`` and the peaks are copied from chip_smoke.py at
the commit that added the benchmark; they count each input byte once, each
output byte once and the operations from the shapes.
"""

from __future__ import annotations

import statistics

# NVIDIA H100 SXM data sheet, dense, at 700 W
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12


def abcn_bound(B: int, N: int, n_intermediate: int) -> float:
    """Least seconds of one ABCN macro-step call on B envs of N points: the 7
    (B, N) fields and nu read once, the 7 outputs written once and the
    kernel's lane tables ((2 log2 N + 1) N floats, N ints), against two
    radix-2 FFTs of 5 N log2 N float32 operations each and 28 N more per env
    and sub-step."""
    L = N.bit_length() - 1
    nbytes = 4 * (7 * B * N + B) + 4 * 7 * B * N + 4 * ((2 * L + 1) * N + N)
    flops = B * n_intermediate * (10 * N * L + 28 * N)
    return max(nbytes / HBM_BPS, flops / FP32_FLOPS)


def mlp_bound(R: int, obs: int, width: int, act: int) -> float:
    """Least seconds of one policy-MLP call on R rows: the three TF32
    tensor-core products of layer 2 (3xTF32, 2 R W^2 each) against x, the
    weights and the 3 outputs moved once; layer 1 and the heads
    (2 R W (obs + 2 act + 1) float32 operations) take less time on their own
    units."""
    nbytes = 4 * (R * obs + obs * width + width + width * width + width
                  + width * (2 * act + 1) + 2 * act + 1 + R * (2 * act + 1))
    t_ops = max(3 * 2 * R * width * width / TF32_FLOPS,
                2 * R * width * (obs + 2 * act + 1) / FP32_FLOPS)
    return max(nbytes / HBM_BPS, t_ops)


def policy_params(obs: int, width: int, act: int, n_hidden: int = 2) -> int:
    """Parameters of the value-and-policy network: n_hidden tanh layers of
    ``width`` and the value, mean and sigma heads."""
    dims = [obs] + [width] * n_hidden
    trunk = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    return trunk + width * (1 + 2 * act) + (1 + 2 * act)


def generation_flops(P: int, *, envs: int, T: int, agents: int, updates: int,
                     mode: str | None, mini_batch: int = 0, mini_batch_episodes: int = 0,
                     probe_rows: int = 0) -> float:
    """Network operations one training generation needs, counted from the
    shapes: 2 P a row for each forward, 6 P a row for a forward with its
    backward.  Acting: every env, step and agent.  The experience-mode
    insert: the V(s) of every row and the V(s_T) bootstrap of every episode.
    An update: forward and backward over its minibatch rows, and the forward
    of their episodes' final observations (the retrace refresh takes the
    loss forward's outputs).  ``probe_rows``: the --diag probe's forward.
    ``mode`` None counts acting alone (an evaluation)."""
    rows = envs * T * agents
    flops = 2 * P * rows + 2 * P * probe_rows
    if mode == "experience":
        flops += 2 * P * (rows + envs * agents)
        flops += updates * (6 * P * mini_batch * agents + 2 * P * mini_batch * agents)
    elif mode == "episode":
        flops += updates * (6 * P * mini_batch_episodes * T * agents
                            + 2 * P * mini_batch_episodes * agents)
    return float(flops)


def rate(work: float, seconds: float) -> float:
    """All the window's work over all its time."""
    if seconds <= 0:
        raise ValueError(f"rate: a window of {seconds} s")
    return work / seconds


def spread(values) -> float:
    """Distance between the first and third quartile (``statistics.quantiles``
    with n=4) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
