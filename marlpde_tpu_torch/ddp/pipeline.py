"""Supervised DDP closure subproject: DNS data generation -> spectral
filtering -> ANN closure training -> a-posteriori LES -> transfer learning
(port of marlpde_tpu/ddp/pipeline.py).

Parity targets (reference ddp/):
  * Stochastic_Burgers_DNS.py: L=100, nu=0.02, N=1024, dt=0.01, s=20, ABCN;
    forcing redrawn every s steps with amplitude A=sqrt(2)*1e-2,
    f = sum_k r1*A/sqrt(k*s*dt)*cos(2*pi*k*x/L + 2*pi*r2), k=1..3  (:28-60)
  * helpers.filter_bar: spectral box filter N -> n_sub                (:6-12)
  * helpers.calc_bar:  tau = 0.5*(bar(u^2) - bar(u)^2),
    PI = (tau - roll(tau,1))/dx, dx = L/NY                            (:15-29)
  * Turbulence_train / ddp_train_and_test: MLP n->250x6(swish)->n,
    Adam, mse, normalized in/out                                      (:66-79)
  * a-posteriori rollout: ABCN with the NN subgrid term integrated by
    2nd-order Adams-Bashforth: -fft(dt*(3/2*pi_n - 1/2*pi_{n-1}))     (:120-130)
  * Transfer_Learning.py: freeze trunk, retrain head at a new Re      (:93-102)

Everything runs on the device the data lives on: the DNS generator and the
a-posteriori LES are loops over torch.fft steps, the closure an ``nn.Module``
trained with ``torch.optim.Adam``.  The draws (the IC phase, the forcing
blocks, the shifts, the epoch permutations) come from ``torch.Generator``s
and can be passed in, so the tests give both packages the same ones.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from marlpde_tpu_torch.core import spectral
from marlpde_tpu_torch.device import resolve_device
from marlpde_tpu_torch.rl import networks
from marlpde_tpu_torch.utils import graphs


# --------------------------------------------------------------- data generation

@dataclasses.dataclass(frozen=True)
class DdpConfig:
    L: float = 100.0
    nu: float = 0.02
    N: int = 1024
    dt: float = 0.01
    s: int = 20              # LES/DNS time-step ratio
    n_les: int = 128
    forcing_amp: float = float(np.sqrt(2) * 1e-2)


def _complex(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def generate_dns(cfg: DdpConfig, n_steps: int, generator: Optional[torch.Generator] = None,
                 u0=None, draws=None, dtype=torch.float32, device=None):
    """Stochastic Burgers DNS (ABCN) on ``device`` (None: the card); returns
    (U_DNS (T+1, N), f_store (T+1, N)) with T = (n_steps // s) * s.

    Forcing is redrawn every cfg.s steps (Stochastic_Burgers_DNS.py:50-60).
    ``u0`` (N,) replaces the random-phase sine IC and ``draws`` the
    (n_steps // s, 2, 3) standard normals of the forcing blocks; what is not
    given is drawn from ``generator``, the IC's phase first."""
    device = resolve_device(device)
    N, L, dt = cfg.N, cfg.L, cfg.dt
    x = torch.as_tensor(np.linspace(0.0, L, N, endpoint=False), dtype=dtype, device=device)
    k = np.fft.fftfreq(N, L / (2 * np.pi * N))
    k1 = torch.as_tensor(1j * k, dtype=_complex(dtype), device=device)
    # note k2 = -k^2; C = -0.5*k2*nu*dt
    C = torch.as_tensor(0.5 * (k**2) * cfg.nu * dt, dtype=dtype, device=device)

    if u0 is None:
        phase = torch.randn((), generator=generator, dtype=dtype, device=device) * 2.0 * np.pi
        u0 = torch.sin(2.0 * np.pi * 2.0 * x / L + phase)
    u0 = torch.as_tensor(u0, dtype=dtype, device=device)
    n_blocks = n_steps // cfg.s
    if draws is None:
        draws = torch.randn((n_blocks, 2, 3), generator=generator, dtype=dtype, device=device)
    draws = torch.as_tensor(draws, dtype=dtype, device=device)

    step = _DnsBlock(cfg, x, k1, C, u0, draws)
    for _ in range(draws.shape[0]):
        step.graph()
    return step.U, step.F


class _DnsBlock:
    """One forcing block of ``generate_dns`` in place: block ``b`` (a device
    counter) draws its forcing from ``draws[b]``, runs ``cfg.s`` ABCN steps
    from the carry (u, v, fn_old) and writes their fields and the forcing to
    rows b*s + 1 .. (b+1)*s of U and F (T+1, N), row 0 holding the IC.
    ``graph`` calls it, as a CUDA graph on the card (utils/graphs.py)."""

    def __init__(self, cfg: DdpConfig, x, k1, C, u0, draws):
        self.cfg, self.x, self.k1, self.C, self.draws = cfg, x, k1, C, draws
        rows = draws.shape[0] * cfg.s + 1
        self.U = u0.new_zeros((rows, cfg.N))
        self.F = u0.new_zeros((rows, cfg.N))
        self.U[0] = u0
        self.u, self.v = u0.clone(), spectral.fft(u0)
        self.fn_old = k1 * spectral.fft(0.5 * u0 * u0)
        self.b = torch.zeros((), dtype=torch.int64, device=u0.device)
        self.kk = torch.arange(1, 4, dtype=u0.dtype, device=u0.device)
        self.steps = torch.arange(cfg.s, device=u0.device)
        self.graph = graphs.Step("ddp DNS block", self, u0.device)

    def __call__(self):
        cfg, x, kk, dt, L = self.cfg, self.x, self.kk, self.cfg.dt, self.cfg.L
        r = self.draws.index_select(0, self.b.view(1))[0]
        amp = r[0] * cfg.forcing_amp / torch.sqrt(kk * cfg.s * dt)
        ph = 2.0 * np.pi * kk[:, None] * x[None, :] / L + 2.0 * np.pi * r[1][:, None]
        f = (amp[:, None] * torch.cos(ph)).sum(0)
        fnf = spectral.fft(f)
        u, v, fn_old, us = self.u, self.v, self.fn_old, []
        for _ in range(cfg.s):
            Fn = self.k1 * spectral.fft(0.5 * u * u)
            v = ((1.0 - self.C) * v - 0.5 * dt * (3.0 * Fn - fn_old) + dt * fnf) / (1.0 + self.C)
            u = spectral.irfft_real(v)
            fn_old = Fn
            us.append(u)
        rows = self.b * cfg.s + 1 + self.steps
        self.U.index_copy_(0, rows, torch.stack(us))
        self.F.index_copy_(0, rows, f.expand(cfg.s, cfg.N))
        graphs.copy_((self.u, self.v, self.fn_old), (u, v, fn_old))
        self.b.add_(1)


# ------------------------------------------------------------------- filtering

def filter_bar(u, n_sub):
    """Spectral box filter N -> n_sub grid (ddp/helpers.py:6-12), batched."""
    v = spectral.fft(u)
    return spectral.irfft_real(spectral.restrict_modes(v, n_sub))


def calc_bar(U, F, n_sub, L=100.0):
    """(u_bar, PI, f_bar) per ddp/helpers.py:15-29; leading axes batched."""
    u_bar = filter_bar(U, n_sub)
    f_bar = filter_bar(F, n_sub)
    u2_bar = filter_bar(U * U, n_sub)
    tau = 0.5 * (u2_bar - u_bar * u_bar)
    dx = L / n_sub
    pi = (tau - torch.roll(tau, 1, dims=-1)) / dx
    return u_bar, pi, f_bar


def normalize_data(data):
    """((data - mean) / std, mean, std) over every element; the population
    std (``jnp.std``'s ddof 0)."""
    std = torch.std(data, correction=0)
    mean = torch.mean(data)
    return (data - mean) / std, mean, std


def shift_augment(generator, a, b, shifts=None):
    """Random periodic shift augmentation (ddp/helpers.py:44-50), paired: row
    i of both arrays is rolled left by ``shifts[i]`` (drawn from ``generator``
    in [0, width) where not given)."""
    n, width = a.shape
    if shifts is None:
        shifts = torch.randint(0, width, (n,), generator=generator, device=a.device)
    shifts = torch.as_tensor(shifts, device=a.device)
    idx = (torch.arange(width, device=a.device)[None, :] + shifts[:, None]) % width
    return torch.gather(a, 1, idx), torch.gather(b, 1, idx)


# ------------------------------------------------------------------- ANN model

class ClosureNet(nn.Module):
    """n_in -> 128 -> width x n_hidden (swish) -> n_out
    (ddp_train_and_test.py:66-74).  The first hidden layer is 128 wide
    whatever ``n_out``, as in the JAX module; ``dense[i]`` is flax's
    ``Dense_i``.  Initialisation is flax's (lecun-normal kernels, zero
    biases)."""

    def __init__(self, n_in: int, n_out: int = 128, width: int = 250, n_hidden: int = 6,
                 dtype=torch.float32, device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.n_in, self.n_out, self.width, self.n_hidden = n_in, n_out, width, n_hidden
        dims = [n_in, 128] + [width] * n_hidden + [n_out]
        self.dense = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, a, b, dtype=dtype,
                               device=torch.device("cpu") if device is None else device)
            for a, b in zip(dims[:-1], dims[1:]))
        with torch.no_grad():
            for lin in self.dense:
                lin.bias.zero_()
                networks.lecun_normal_(lin.weight, generator)

    def forward(self, x):
        h = x
        for lin in self.dense[:-1]:
            h = nn.functional.silu(lin(h))
        return self.dense[-1](h)


def params_from_flax(tree):
    """flax ClosureNet params (``Dense_0..Dense_{n+1}``, numpy leaves) -> a
    ``ClosureNet`` state_dict; kernels transposed."""
    p = tree["params"] if "params" in tree else tree
    return networks.dense_state_dict(p, [f"dense.{i}" for i in range(len(p))])


def params_to_flax(net: ClosureNet) -> dict:
    """Inverse of ``params_from_flax``: a flax-layout tree of numpy arrays."""
    return networks.dense_tree(net.dense)


@dataclasses.dataclass
class ClosureModel:
    net: ClosureNet
    mean_in: float
    std_in: float
    mean_out: float
    std_out: float

    @torch.no_grad()
    def predict(self, u_bar):
        z = (u_bar - self.mean_in) / self.std_in
        out = self.net(z)
        return out * self.std_out + self.mean_out


def train_closure(u_bar, pi, generator: Optional[torch.Generator] = None, epochs: int = 100,
                  batch_size: int = 200, lr: float = 1e-3, net: Optional[ClosureNet] = None,
                  trainable_mask: Optional[dict] = None, verbose=False, perms=None):
    """Train the ANN closure u_bar -> PI with Adam/mse
    (Turbulence_train.py:89-108) on the data's device.

    ``net`` gives the starting weights (a copy is trained; the caller's module
    is left as it was); without it a fresh ``ClosureNet`` is drawn from
    ``generator``.  ``trainable_mask`` ({"Dense_i": bool}, ``transfer_mask``)
    enables transfer learning with frozen layers (Transfer_Learning.py:93-102):
    the frozen layers are left out of the optimizer, so they stay bit for bit
    as they were.  Each epoch draws one permutation from ``generator``, or
    takes ``perms[epoch]``."""
    n = u_bar.shape[-1]
    x, mean_in, std_in = normalize_data(u_bar)
    y, mean_out, std_out = normalize_data(pi)
    if net is None:
        net = ClosureNet(n, n_out=n, dtype=u_bar.dtype, device=u_bar.device,
                         generator=generator)
    else:
        net = copy.deepcopy(net)
    trainable = [p for i, lin in enumerate(net.dense)
                 if trainable_mask is None or trainable_mask[f"Dense_{i}"]
                 for p in lin.parameters()]
    opt = graphs.adam(trainable, lr)

    n_samples = x.shape[0]
    step = _Epoch(net, opt, x, y, batch_size, max(n_samples // batch_size, 1))
    for ep in range(epochs):
        step.perm.copy_(torch.randperm(n_samples, generator=generator, device=x.device)
                        if perms is None else torch.as_tensor(perms[ep], device=x.device))
        step.graph()
        if verbose and ep % 10 == 0:
            print(f"[ddp] epoch {ep} loss {float(step.loss):.6f}")

    return ClosureModel(net=net, mean_in=float(mean_in), std_in=float(std_in),
                        mean_out=float(mean_out), std_out=float(std_out))


class _Epoch:
    """One epoch of ``train_closure`` in place: ``steps`` Adam steps on the
    minibatches of ``batch_size`` rows that ``perm`` (refilled before each
    epoch) orders, the last loss in ``loss``.  ``graph`` calls it, as a CUDA
    graph on the card (utils/graphs.py): the JAX package's jitted step under
    its loop."""

    def __init__(self, net, opt, x, y, batch_size: int, steps: int):
        self.net, self.opt, self.x, self.y = net, opt, x, y
        self.batch_size, self.steps = batch_size, steps
        self.perm = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        self.loss = torch.full((), np.inf, dtype=x.dtype, device=x.device)
        self.graph = graphs.Step("ddp closure epoch", self, x.device)

    def __call__(self):
        bs = self.batch_size
        for i in range(self.steps):
            idx = self.perm[i * bs:(i + 1) * bs]
            self.opt.zero_grad(set_to_none=True)
            loss = torch.mean((self.net(self.x[idx]) - self.y[idx]) ** 2)
            loss.backward()
            self.opt.step()
        with torch.no_grad():
            self.loss.copy_(loss)


def transfer_mask(net: ClosureNet, n_frozen: int = 6) -> dict:
    """Trainable-mask for transfer learning: freeze the first ``n_frozen``
    Dense layers, retrain the rest — the reference freezes layers 1-6 of its
    8-layer net and retrains the 7th hidden layer + linear head
    (Transfer_Learning.py:93-102 'trainable = False' rows)."""
    return {f"Dense_{i}": i >= n_frozen for i in range(len(net.dense))}


def head_only_mask(net: ClosureNet) -> dict:
    """Trainable-mask freezing everything except the last Dense layer (a
    stricter variant of transfer_mask; kept for head-probing experiments)."""
    return transfer_mask(net, n_frozen=len(net.dense) - 1)


def apriori_eval(model: ClosureModel, u_bar, pi_true):
    """A-priori evaluation (Turbulence_predict_prior.py): predict PI from
    filtered fields and score against the true SGS term.

    Returns dict(mse, correlation)."""
    pred = model.predict(u_bar).cpu().numpy()
    true = torch.as_tensor(pi_true).cpu().numpy()
    mse = float(np.mean((pred - true) ** 2))
    corr = float(np.corrcoef(pred.ravel(), true.ravel())[0, 1])
    return dict(mse=mse, correlation=corr)


# ------------------------------------------------------------- a-posteriori LES

@torch.no_grad()
def aposteriori_rollout(model: ClosureModel, cfg: DdpConfig, u_init, u_prev,
                        f_bar_seq, n_steps: int):
    """LES with the ANN closure inside the ABCN step (ddp_train_and_test.py:120-130),
    on the fields' device.

    Subgrid term integrated with 2nd-order Adams-Bashforth:
      uRHS -= fft(dt*(3/2*pi_n - 1/2*pi_{n-1})).
    f_bar_seq: (n_steps, n) filtered forcing per LES step.
    Returns uu (n_steps+1, n).
    """
    n = cfg.n_les
    L, nu = cfg.L, cfg.nu
    dt = cfg.s * cfg.dt                          # LES runs at s*dt
    rdtype, device = u_init.dtype, u_init.device
    k = np.fft.fftfreq(n, L / (2 * np.pi * n))
    k1 = torch.as_tensor(1j * k, dtype=_complex(rdtype), device=device)
    D2 = torch.as_tensor(k * k, dtype=rdtype, device=device)
    D2x = torch.as_tensor(1.0 + 0.5 * dt * nu * k * k, dtype=rdtype, device=device)

    step = _LesStep(model, cfg, k1, D2, D2x, u_init, u_prev, f_bar_seq[:n_steps])
    for _ in range(step.f_bar.shape[0]):
        step.graph()
    return step.uu


class _LesStep:
    """One a-posteriori LES step in place: step ``k`` (a device counter)
    advances (u, v, u_old, pi_prev) under the forcing ``f_bar[k]`` and writes
    the new field to row k + 1 of ``uu``.  ``graph`` calls it, as a CUDA
    graph on the card (utils/graphs.py)."""

    def __init__(self, model, cfg: DdpConfig, k1, D2, D2x, u_init, u_prev, f_bar):
        self.model, self.k1, self.D2, self.D2x, self.f_bar = model, k1, D2, D2x, f_bar
        self.dt, self.nu = cfg.s * cfg.dt, cfg.nu          # the LES runs at s*dt
        self.u, self.u_old, self.v = u_init.clone(), u_prev.clone(), spectral.fft(u_init)
        self.pi_prev = model.predict(u_prev)
        self.uu = u_init.new_zeros((f_bar.shape[0] + 1,) + u_init.shape)
        self.uu[0] = u_init
        self.k = torch.zeros((), dtype=torch.int64, device=u_init.device)
        self.graph = graphs.Step("ddp LES step", self, u_init.device)

    def __call__(self):
        dt, nu, k1, u, v = self.dt, self.nu, self.k1, self.u, self.v
        f = self.f_bar.index_select(0, self.k.view(1))[0]
        pi_n = self.model.predict(u)
        F = k1 * spectral.fft(0.5 * u * u)
        F0 = k1 * spectral.fft(0.5 * self.u_old * self.u_old)
        rhs = (-0.5 * dt * (3.0 * F - F0) - 0.5 * dt * nu * (self.D2 * v) + v
               + dt * spectral.fft(f)
               - spectral.fft(dt * (1.5 * pi_n - 0.5 * self.pi_prev)))
        v_new = rhs / self.D2x
        u_new = spectral.irfft_real(v_new)
        self.k.add_(1)
        self.uu.index_copy_(0, self.k.view(1), u_new[None])
        graphs.copy_((self.u, self.v, self.u_old, self.pi_prev), (u_new, v_new, u, pi_n))
