"""Whole-batch env step for the spectral-reward Burgers closure env (port of
marlpde_tpu/envs/burger_fast.py:25-114).

Same episode semantics as the per-env env (burger_env) for the flagship
configuration (ABCN, spectral reward, dforce, no stochastic forcing or
closures), on the whole (B, N) batch at once, so one ABCN macro-step op call
(kernels/abcn.py) advances every env by one macro-step.  The op launches the
CUDA kernel on CUDA tensors and runs its plain version on CPU tensors.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import torch

from marlpde_tpu_torch.envs import burger_env, features
from marlpde_tpu_torch.kernels import abcn


@dataclasses.dataclass
class FastEnvState:
    u: torch.Tensor           # (B, N)
    u_prev: torch.Tensor      # (B, N) previous sub-step field (dudt feature)
    v_re: torch.Tensor
    v_im: torch.Tensor
    fn_re: torch.Tensor
    fn_im: torch.Tensor
    nu: torch.Tensor          # (B, 1)
    sidx: torch.Tensor        # (B,) int64
    ioutnum: torch.Tensor     # (B,) int64
    ek_sum: torch.Tensor      # (B, N)
    prev_rel_err: torch.Tensor  # (B,)
    done: torch.Tensor        # (B,) bool
    cum_reward: torch.Tensor  # (B, num_agents)


def reset(cfg: burger_env.BurgerEnvConfig, pool, generator, counts):
    """Batched reset; returns (FastEnvState, obs)."""
    st, obs = burger_env.reset(cfg, pool, generator, counts)
    return from_env_state(st), obs


def from_env_state(st: burger_env.BurgerEnvState) -> FastEnvState:
    s = st.solver
    return FastEnvState(
        u=s.u.contiguous(), u_prev=st.u_prev.contiguous(),
        v_re=s.v.real.contiguous(), v_im=s.v.imag.contiguous(),
        fn_re=s.fn_old.real.contiguous(), fn_im=s.fn_old.imag.contiguous(),
        nu=s.nu[:, None].contiguous(), sidx=st.sidx, ioutnum=s.ioutnum,
        ek_sum=st.ek_sum, prev_rel_err=st.prev_rel_err,
        done=st.done, cum_reward=st.cum_reward)


@lru_cache(maxsize=32)
def _consts(cfg: burger_env.BurgerEnvConfig, dtype: torch.dtype, device: torch.device):
    """Device copies of the action basis and the reward's wavenumber columns."""
    basis = torch.as_tensor(burger_env.action_basis(cfg), dtype=dtype, device=device)
    cols = torch.arange(1, cfg.grid_size // 2, device=device)
    return basis, cols


def step(cfg: burger_env.BurgerEnvConfig, pool, state: FastEnvState, actions):
    """Batched macro-step.  actions: (B, num_agents, actions_per_agent).

    Returns (state, obs, reward (B, na), done (B,), info).  Envs already done
    still go through the op; their outputs are discarded by selection."""
    B, N = state.u.shape
    dtype = state.u.dtype
    dx = cfg.les_solver.grid.dx
    g = cfg.grid_size
    basis, cols = _consts(cfg, dtype, state.u.device)
    action_field = actions.reshape(B, -1) @ basis          # (B, N)
    af = torch.fft.fft(action_field, dim=-1)
    u, u_prev, v_re, v_im, fn_re, fn_im, ek_delta = abcn.abcn_macro_step(
        state.u, state.v_re, state.v_im, state.fn_re, state.fn_im, state.nu,
        af.real.contiguous(), af.imag.contiguous(),
        n_intermediate=cfg.n_intermediate, dt=cfg.dt, dx=float(dx))

    ioutnum = state.ioutnum + cfg.n_intermediate
    ek_sum = state.ek_sum + ek_delta
    count = (ioutnum + 1).to(dtype)[:, None]
    sgs_ektt = ek_sum[:, 1: g // 2] / count
    # a frozen env's ioutnum can run past the table; clamp as a JAX gather does
    t_idx = ioutnum.clamp(max=pool.ek_ktt.shape[1] - 1)
    dns_ektt = pool.ek_ktt[state.sidx[:, None], t_idx[:, None], cols[None, :]]
    rel_err = torch.mean(((torch.abs(dns_ektt - sgs_ektt)) / dns_ektt) ** 2, dim=-1)
    reward = ((state.prev_rel_err - rel_err)[:, None]
              * torch.ones((1, cfg.num_agents), dtype=dtype, device=u.device)
              * cfg.reward_factor)

    blown = ~(torch.isfinite(u).all(dim=-1) & torch.isfinite(reward).all(dim=-1))
    reward = torch.where(blown[:, None], torch.full_like(reward, cfg.truncation_penalty),
                         reward)
    macro = ioutnum // cfg.n_intermediate
    done = blown | (macro >= cfg.episode_length) | state.done

    was = state.done

    def keep(new, old):
        # select, never multiply: blown envs hold inf/NaN
        return torch.where(was.reshape((-1,) + (1,) * (new.ndim - 1)), old, new)

    zero = torch.zeros_like(reward)
    new_state = FastEnvState(
        u=keep(u, state.u), u_prev=keep(u_prev, state.u_prev),
        v_re=keep(v_re, state.v_re), v_im=keep(v_im, state.v_im),
        fn_re=keep(fn_re, state.fn_re), fn_im=keep(fn_im, state.fn_im),
        nu=state.nu, sidx=state.sidx,
        ioutnum=keep(ioutnum, state.ioutnum), ek_sum=keep(ek_sum, state.ek_sum),
        prev_rel_err=keep(rel_err, state.prev_rel_err), done=done,
        cum_reward=state.cum_reward + torch.where(was[:, None], zero, reward))
    reward = torch.where(was[:, None], zero, reward)

    v = (torch.complex(new_state.v_re, new_state.v_im) if cfg.version in (3, 4)
         else None)
    obs = features.burger_features(cfg.version, cfg.num_agents, new_state.u,
                                   new_state.u_prev, v, cfg.dt, dx)
    obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
    return new_state, obs, reward, done, dict(blown=blown)
