"""Port parity: the flat experience replay (rl/replay_flat.py) against the JAX
package in float64 — compaction, eviction, the reward and off-policy sums,
the metadata refresh and the whole-episode retrace refresh.

Tolerances: ids, flags and compaction exact; values 1e-12 relative (the same
float64 arithmetic, summed or composed in another order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu.rl import replay_flat as jflat
from marlpde_tpu_torch.rl import replay_flat as tflat
from test_torch_interop import flat_from_jax, flat_to_jax

torch.set_num_threads(1)
RTOL = 1e-12

# live lengths 5, 2, 3; episode 1 ends by blowup (Truncated)
MASKS = np.array([[1, 1, 1, 1, 1], [1, 1, 0, 0, 0], [1, 1, 1, 0, 0]], float)


def _batch(seed, masks=MASKS, na=2, od=3, ad=1):
    rng = np.random.default_rng(seed)
    B, T = masks.shape
    rewards = rng.standard_normal((B, T, na))
    rewards[1, 1, 0] = -np.inf                 # a blowup reward, below any floor
    return dict(obs=rng.standard_normal((B, T, na, od)),
                actions=rng.standard_normal((B, T, na, ad)) * 0.1,
                mu=rng.standard_normal((B, T, na, ad)) * 0.1,
                sigma=rng.uniform(0.5, 1.5, (B, T, na, ad)),
                rewards=rewards, mask=masks.copy(),
                final_obs=rng.standard_normal((B, na, od)),
                truncated=np.arange(B) % 3 == 1,
                sv=rng.standard_normal((B, T, na)), vtg=rng.standard_normal((B, T, na)),
                boot=rng.standard_normal((B, na)) * (np.arange(B) % 3 == 1)[:, None])


def _insert(jrep, trep, b):
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    jrep = jflat.add_episodes(jrep, jb, jb["sv"], jb["vtg"], jb["boot"])
    trep = tflat.add_episodes(trep, tb, tb["sv"], tb["vtg"], tb["boot"])
    return jrep, trep


def _assert_same(trep, jrep, exact=False):
    back = flat_to_jax(trep)
    for f in dataclasses.fields(jflat.FlatReplay):
        a, b = np.asarray(getattr(back, f.name)), np.asarray(getattr(jrep, f.name))
        if exact or a.dtype != np.float64:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, err_msg=f.name)


def _pair(E, Eep, na=2, od=3, ad=1):
    return (jflat.init_flat(E, Eep, na, od, ad, dtype=jnp.float64),
            tflat.init_flat(E, Eep, na, od, ad, dtype=torch.float64))


@pytest.mark.parametrize("E,Eep,n_inserts", [(32, 32, 1), (32, 4, 3), (12, 5, 2)])
def test_add_compacts_and_wraps_like_jax(E, Eep, n_inserts):
    jrep, trep = _pair(E, Eep)
    for i in range(n_inserts):
        jrep, trep = _insert(jrep, trep, _batch(i))
        _assert_same(trep, jrep, exact=True)
    assert trep.cursor == 10 * n_inserts and trep.live == min(10 * n_inserts, E)
    assert tflat.num_experiences(trep) == int(jflat.num_experiences(jrep))
    if n_inserts == 1:
        np.testing.assert_array_equal(trep.ep_first[:10].numpy(), [0] * 5 + [5] * 2 + [7] * 3)
        np.testing.assert_array_equal(trep.ep_last[:10].numpy(), [4] * 5 + [6] * 2 + [9] * 3)


def test_insert_larger_than_the_ring_keeps_the_newest():
    """10 live steps into 8 slots and 3 episodes into 2 ring entries: JAX's
    in-order scatter leaves the newest writes, which the port writes alone."""
    jrep, trep = _pair(8, 2)
    jrep, trep = _insert(jrep, trep, _batch(0))
    _assert_same(trep, jrep, exact=True)
    b = _batch(0)
    # experiences 8, 9 (episode 2's last two steps) overwrote slots 0, 1
    np.testing.assert_array_equal(trep.obs[0].numpy(), b["obs"][2, 1])
    np.testing.assert_array_equal(trep.obs[2].numpy(), b["obs"][0, 2])
    assert trep.live == 8 and trep.cursor - trep.live == 2


@pytest.mark.parametrize("floor", [-np.inf, -1e4])
def test_reward_scale_and_off_policy_fraction(floor):
    jrep, trep = _pair(8, 8)
    b = _batch(3)
    b["rewards"][1, 1, 0] = 0.7 if floor == -np.inf else -np.inf
    jrep, trep = _insert(jrep, trep, b)
    fresh = _batch(4)
    for extra in (False, True):
        kw_j = dict(extra=jnp.asarray(fresh["rewards"]),
                    extra_mask=jnp.asarray(fresh["mask"])) if extra else {}
        kw_t = dict(extra=torch.from_numpy(fresh["rewards"]),
                    extra_mask=torch.from_numpy(fresh["mask"])) if extra else {}
        js, jn = jflat.reward_scale_sums(jrep, floor, **kw_j)
        ts, tn = tflat.reward_scale_sums(trep, floor, **kw_t)
        np.testing.assert_allclose(ts.item(), float(js), rtol=RTOL)
        assert tn.item() == float(jn)
        np.testing.assert_allclose(tflat.reward_scale(trep, floor, **kw_t).item(),
                                   float(jflat.reward_scale(jrep, floor, **kw_j)), rtol=RTOL)
    assert np.isfinite(tflat.reward_scale(trep, -1e4).item())
    # korali's second moment: a constant reward maps to itself
    trep.rewards.fill_(5e-4)
    assert tflat.reward_scale(trep).item() == pytest.approx(5e-4, rel=1e-12)

    assert tflat.off_policy_fraction(trep).item() == 0.0
    trep.off[[0, 3]] = True
    jrep = jrep.replace(off=jrep.off.at[jnp.asarray([0, 3])].set(True))
    frac = tflat.off_policy_fraction(trep)
    assert frac.dtype == torch.float32
    assert frac.item() == float(jflat.off_policy_fraction(jrep)) == np.float32(4 / 16)


def test_sampler_uniform_over_live_ids():
    jrep, trep = _pair(8, 8)
    for i in range(2):                          # cursor 20: live ids 12..19
        jrep, trep = _insert(jrep, trep, _batch(i))
    g = tflat.sample_ids(trep, torch.Generator().manual_seed(0), 8000)
    assert g.dtype == torch.int64 and g.min() == 12 and g.max() == 19
    frac = np.bincount(g.numpy() - 12, minlength=8) / 8000
    assert abs(frac - 1 / 8).max() < 0.03


def test_gather_and_refresh_metadata_with_duplicates():
    jrep, trep = _pair(8, 4)
    jrep, trep = _insert(jrep, trep, _batch(5))
    g = np.array([2, 6, 6, 9, 2])               # duplicates; 6 ends the truncated episode
    jrows = jflat.gather(jrep, jnp.asarray(g))
    trows = tflat.gather(trep, torch.from_numpy(g))
    for k in jrows:
        np.testing.assert_array_equal(trows[k].numpy(), np.asarray(jrows[k]), err_msg=k)
    rng = np.random.default_rng(6)
    V = rng.standard_normal((5, 2))
    rho = rng.uniform(0.2, 3, (5, 2))
    boot = rng.standard_normal((5, 2))
    for dup, first in ((2, 1), (4, 0)):         # every duplicate carries the same value
        V[dup], rho[dup], boot[dup] = V[first], rho[first], boot[first]
    off = (rho < 0.5) | (rho > 2)
    jrep = jflat.refresh_metadata(jrep, jnp.asarray(g), jnp.asarray(V), jnp.asarray(rho),
                                  jnp.asarray(off), jnp.asarray(boot))
    tflat.refresh_metadata(trep, torch.from_numpy(g), torch.from_numpy(V),
                           torch.from_numpy(rho), torch.from_numpy(off), torch.from_numpy(boot))
    _assert_same(trep, jrep, exact=True)


@pytest.mark.parametrize("gamma,scale,floors", [(0.9, 2.0, (-np.inf, -np.inf)),
                                                (1.0, 0.3, (-1e4, -5.0))])
def test_refresh_retrace_matches_jax(gamma, scale, floors):
    """Two inserts into a ring of 16: the oldest episode's head is evicted
    (its window stops at the horizon); the sample holds duplicates, an
    evicted-head episode, a truncated episode's end and a terminal end."""
    jrep, trep = _pair(16, 8)
    for i in range(2):
        jrep, trep = _insert(jrep, trep, _batch(10 + i))
    assert trep.cursor - trep.live == 4         # ids 0..3 evicted: episode 0 lost its head
    rng = np.random.default_rng(7)
    sv = rng.standard_normal(trep.sv.shape)
    rho = rng.uniform(0.3, 2.0, trep.rho.shape)
    jrep = jrep.replace(sv=jnp.asarray(sv), rho=jnp.asarray(rho))
    trep.sv.copy_(torch.from_numpy(sv))
    trep.rho.copy_(torch.from_numpy(rho))
    g = np.array([4, 4, 6, 9, 12, 16, 19, 5])
    jrep2, jnext = jflat.refresh_retrace(jrep, jnp.asarray(g), 5, gamma, scale, *floors)
    trep2, tnext = tflat.refresh_retrace(trep, torch.from_numpy(g), 5, gamma,
                                         torch.tensor(scale, dtype=torch.float64), *floors)
    np.testing.assert_allclose(tnext.numpy(), np.asarray(jnext), rtol=RTOL, atol=1e-15)
    _assert_same(trep2, jrep2)
    # at an episode's end the successor is the bootstrap: V(s_T) for the
    # truncated episode 1 (ids 5..6), 0 for terminal ones
    assert tnext[2].tolist() == trep.boot[1].tolist()
    assert tnext[3].tolist() == [0.0, 0.0]


@pytest.mark.parametrize("T", [1, 2, 5, 8, 13])
def test_affine_prefix_equals_the_sequential_recursion(T):
    rng = np.random.default_rng(T)
    a = torch.from_numpy(rng.uniform(0, 1, (3, T, 2)))
    b = torch.from_numpy(rng.standard_normal((3, T, 2)))
    A, B = tflat._affine_prefix(a, b)
    x0 = torch.from_numpy(rng.standard_normal((3, 2)))
    x = x0
    for k in range(T):
        x = a[:, k] * x + b[:, k]
        np.testing.assert_allclose((A[:, k] * x0 + B[:, k]).numpy(), x.numpy(), rtol=1e-13)
