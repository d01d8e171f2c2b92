"""The yardstick's arithmetic on known shapes."""

from __future__ import annotations

import statistics

import pytest

import yardstick


def test_abcn_bound_at_the_flagships_batch():
    # 7 (B, N) fields and nu in, 7 out, the lane tables: bytes bound at B=1024
    B, N = 1024, 32
    nbytes = 4 * (7 * B * N + B) + 4 * 7 * B * N + 4 * ((2 * 5 + 1) * N + N)
    assert yardstick.abcn_bound(B, N, 10) == pytest.approx(nbytes / 3.35e12)
    assert yardstick.abcn_bound(B, N, 10) == pytest.approx(0.549e-6, rel=2e-3)
    # at B=10 the bytes still bound it: operations 10 * (10*32*5 + 28*32) / 67e12
    assert yardstick.abcn_bound(10, 32, 10) > 10 * 10 * (1600 + 896) / 67e12


def test_mlp_bound_narrow_and_wide():
    # obs 3, W 128, one action, R=32768: the three TF32 products bound it
    t = yardstick.mlp_bound(32768, 3, 128, 1)
    assert t == pytest.approx(3 * 2 * 32768 * 128 * 128 / 495e12)
    assert t == pytest.approx(6.51e-6, rel=1e-3)
    # an acting row: bytes
    R, D, W, A = 16, 32, 256, 16
    nbytes = 4 * (R * D + D * W + W + W * W + W + W * (2 * A + 1) + 2 * A + 1 + R * (2 * A + 1))
    assert yardstick.mlp_bound(R, D, W, A) == pytest.approx(nbytes / 3.35e12)


def test_policy_params_and_generation_flops():
    P = yardstick.policy_params(3, 128, 1)
    assert P == (3 * 128 + 128) + (128 * 128 + 128) + 128 * 3 + 3 == 17411
    # the fused flagship: acting 1024 x 500 x 32 rows, 200 updates of 2 episodes
    f = yardstick.generation_flops(P, envs=1024, T=500, agents=32, updates=200, mode="episode",
                                   mini_batch_episodes=2)
    acting = 2 * P * 1024 * 500 * 32
    updates = 200 * (6 * P * 2 * 500 * 32 + 2 * P * 2 * 32)
    assert f == acting + updates
    assert f == pytest.approx(1.24e12, rel=0.02)
    # experience mode adds the insert's forwards and mbsize rows an update
    e = yardstick.generation_flops(P, envs=10, T=500, agents=32, updates=2500,
                                   mode="experience", mini_batch=8, probe_rows=32 * 32)
    assert e == (2 * P * 10 * 500 * 32 + 2 * P * 32 * 32 + 2 * P * (10 * 500 * 32 + 10 * 32)
                 + 2500 * 8 * P * 8 * 32)
    assert yardstick.generation_flops(P, envs=16, T=500, agents=1, updates=0,
                                      mode=None) == 2 * P * 16 * 500


def test_rate_and_spread():
    assert yardstick.rate(5000 * 4, 10.0) == 2000.0
    with pytest.raises(ValueError):
        yardstick.rate(1, 0.0)
    values = [100.0, 101.0, 99.0, 102.0, 98.0, 100.5]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert yardstick.spread(values) == pytest.approx((q3 - q1) / statistics.median(values))
