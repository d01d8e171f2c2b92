"""makePlot, the testing stage's comparison figures (port of
marlpde_tpu/analysis/plotting.py:22-27,133-309).

Parity target: python/_model/plotting.py makePlot (:161-433), the 3x6 panel
DNS/uncontrolled/controlled comparison with field snapshots, error traces,
spectra and SGS-term KDEs.  The panel data is numpy and scipy; matplotlib is
imported lazily with the Agg backend.  Where matplotlib is not installed,
``make_plot`` writes the panel data to ``<prefix>_panels.npz`` in place of
the figures and prints one line saying so.  The diffusion, Laplace and movie
plots wait for their envs (ROADMAP items 10.2 and 14).
"""

from __future__ import annotations

import importlib.util

import numpy as np


def _plt():
    """matplotlib.pyplot on the Agg backend, or None where matplotlib is not
    installed."""
    if importlib.util.find_spec("matplotlib") is None:
        return None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _interp_dns(dns_x, dns_tt, dns_uu, x, tt):
    """Cubic interpolation of the DNS field onto (tt, x) — the reference's
    interpolate.interp2d(dns.x, dns.tt, dns.uu, kind='cubic')
    (plotting.py:233-245).  Periodic in x via a wrapped ghost column."""
    from scipy.interpolate import RectBivariateSpline
    xg = np.concatenate([dns_x, [dns_x[0] + (dns_x[-1] - dns_x[0])
                                 + (dns_x[1] - dns_x[0])]])
    ug = np.concatenate([dns_uu, dns_uu[:, :1]], axis=1)
    kt = min(3, len(dns_tt) - 1)
    f = RectBivariateSpline(np.asarray(dns_tt), xg, ug, kx=kt, ky=3)
    tt_c = np.clip(np.asarray(tt), dns_tt[0], dns_tt[-1])
    return f(tt_c, np.asarray(x))


def _align_dns_frames(dns_tt, tt):
    """DNS frame index nearest each LES output time (plotting.py:232 tidx)."""
    dns_tt = np.asarray(dns_tt)
    return np.clip(np.searchsorted(dns_tt, np.asarray(tt) - 1e-12),
                   0, len(dns_tt) - 1)


_ROWS = ("no control", "controlled")


def _kde(sample, grid):
    """Gaussian KDE of ``sample`` evaluated on ``grid``; NaN where the sample
    has no spread (every value equal, as the SGS forcing of a policy that
    acts 0, e.g. an untrained sigma-relative one), for which no bandwidth
    exists: scipy's gaussian_kde, and with it the JAX function, raises."""
    from scipy.stats import gaussian_kde
    sample = np.ravel(sample)
    if np.ptp(sample) == 0:
        return np.full(np.shape(grid), np.nan)
    return gaussian_kde(sample)(grid)


def _panel_data(dns, base, sgs):
    """The numbers the figures show: per row the |error| field against the
    interpolated DNS, the MSE and spectral-error traces; the SGS-term KDEs
    where both dns and sgs carry 'sgs_history'."""
    dns_x, dns_tt, dns_uu = (np.asarray(dns[k]) for k in ("x", "tt", "uu"))
    dns_ek = np.asarray(dns["ek_ktt"])
    N = dns_uu.shape[1]
    g = np.asarray(sgs["uu"]).shape[1]
    data = {}
    for name, d in zip(_ROWS, (base, sgs)):
        tt = np.asarray(d["tt"])
        uu = np.asarray(d["uu"])
        ek = np.asarray(d["ek_ktt"])
        errU = np.abs(uu - _interp_dns(dns_x, dns_tt, dns_uu, np.asarray(d["x"]), tt))
        dk = dns_ek[_align_dns_frames(dns_tt, tt)][:, 1: g // 2]
        errK_t = np.mean((np.abs(dk - ek[:, 1: g // 2]) / dk) ** 2, axis=1)
        data[f"{name}_errU"] = errU
        data[f"{name}_mse_t"] = np.mean(errU**2, axis=1)
        data[f"{name}_errK_t"] = errK_t
        data[f"{name}_errK_cum"] = np.cumsum(errK_t) / np.arange(1, len(errK_t) + 1)
    if "sgs_history" in dns and "sgs_history" in sgs:
        xi = (np.arange(N) % max(N // g, 1)) == 0
        dns_sgs = np.asarray(dns["sgs_history"])[:, xi]
        sgs_hist = np.asarray(sgs["sgs_history"])
        svals = np.linspace(min(dns_sgs.min(), sgs_hist.min()),
                            max(dns_sgs.max(), sgs_hist.max()), 500)
        data["sgs_kde_grid"] = svals
        data["dns_sgs_kde"] = _kde(dns_sgs, svals)
        data["sgs_sgs_kde"] = _kde(sgs_hist, svals)
    return data


def make_plot(dns, base, sgs, file_prefix="compare", spectral=True):
    """The reference's makePlot artifact set (plotting.py:161-433):

      {prefix}_evolution.png   4x4 field snapshots — baseline & controlled
                               solid, DNS dashed (plotting.py:165-190)
      {prefix}.png             3x6 panels — field contour | |err vs cubic-
                               interpolated DNS| contour | instantaneous +
                               cumulative error trace (spectral or MSE) |
                               Ek_ktt spectra at start/mid/end (k^-2 guide on
                               the DNS row) | relative spectrum error at
                               start/mid/end | per-action trajectories
                               (plotting.py:193-336)
      {prefix}_action.png      2x2 — DNS a-priori SGS contour + log-KDE vs
                               controlled SGS-forcing contour + overlaid KDEs
                               (plotting.py:346-407; needs 'sgs_history')
      {prefix}_action_closeup.png  KDE overlay within +-3 sigma (:410-425)

    Where matplotlib is not installed: {prefix}_panels.npz, the returned panel
    data, in place of the figures.

    dns/base/sgs: dicts of numpy arrays with x (N,), tt (T,), uu (T, N),
    ek_ktt (T, g); sgs/base optionally action_fields (T, NA); dns/sgs
    optionally sgs_history (T, N) a-priori/applied SGS terms.  Returns the
    panel data (the JAX function's keys)."""
    data = _panel_data(dns, base, sgs)
    plt = _plt()
    if plt is None:
        np.savez(f"{file_prefix}_panels.npz", **data)
        print(f"[plotting] matplotlib is not installed: wrote the panel data to "
              f"{file_prefix}_panels.npz in place of the figures")
        return data

    colors = ["black", "royalblue", "seagreen"]
    dns_x, dns_tt, dns_uu = (np.asarray(dns[k]) for k in ("x", "tt", "uu"))

    # ---- 4x4 snapshot grid (plotting.py:165-190) ----
    fig2, axs2 = plt.subplots(4, 4, sharex=True, sharey=True, figsize=(15, 15))
    T_les = len(np.asarray(sgs["tt"]))
    for i in range(16):
        tidx_sgs = min(int(i * T_les / 16), T_les - 1)
        tidx_dns = min(int(i * len(dns_tt) / 16), len(dns_tt) - 1)
        ax = axs2[i // 4, i % 4]
        ax.plot(np.asarray(base["x"]), np.asarray(base["uu"])[tidx_sgs], "-",
                color=colors[1])
        ax.plot(np.asarray(sgs["x"]), np.asarray(sgs["uu"])[tidx_sgs], "-",
                color=colors[2])
        ax.plot(dns_x, dns_uu[tidx_dns], "--", color=colors[0])
    fig2.tight_layout()
    fig2.savefig(f"{file_prefix}_evolution.png")
    plt.close(fig2)

    # ---- 3x6 comparison panel (plotting.py:193-336) ----
    fig1, axs1 = plt.subplots(3, 6, figsize=(24, 12))
    N = dns_uu.shape[1]
    g = np.asarray(sgs["uu"]).shape[1]
    k1 = np.arange(N // 2)
    k2 = np.arange(1, g // 2)
    umax = max(dns_uu.max(), np.asarray(base["uu"]).max(), np.asarray(sgs["uu"]).max())
    umin = min(dns_uu.min(), np.asarray(base["uu"]).min(), np.asarray(sgs["uu"]).min())
    ulevels = np.linspace(umin, umax + 1e-12, 50)

    # DNS row: field contour + spectra with the k^-2 guide (plotting.py:219-226)
    axs1[0, 0].contourf(dns_x, dns_tt, dns_uu, ulevels)
    axs1[0, 0].set_ylabel("DNS")
    dns_ek = np.asarray(dns["ek_ktt"])
    for sel, style in ((0, ":"), (len(dns_ek) // 2, "--"), (-1, "-")):
        axs1[0, 3].plot(k1[1:], np.abs(dns_ek[sel][1:N // 2]), style, color=colors[0])
    kg = k1[2:-10] if N > 24 else k1[2:]
    axs1[0, 3].plot(kg, 1e-5 * np.asarray(kg, float) ** (-2.0), "--", linewidth=0.5)
    axs1[0, 3].set_xscale("log")
    axs1[0, 3].set_yscale("log")

    for row, (name, d) in enumerate(zip(_ROWS, (base, sgs)), start=1):
        x, tt, uu = (np.asarray(d[k]) for k in ("x", "tt", "uu"))
        ek = np.asarray(d["ek_ktt"])
        tidx = _align_dns_frames(dns_tt, tt)
        mse_t = data[f"{name}_mse_t"]
        axs1[row, 0].contourf(x, tt, uu, ulevels)
        axs1[row, 0].set_ylabel(name)
        axs1[row, 1].contourf(x, tt, data[f"{name}_errU"], 50)
        inst, cum = ((data[f"{name}_errK_t"], data[f"{name}_errK_cum"]) if spectral
                     else (mse_t, np.cumsum(mse_t) / np.arange(1, len(mse_t) + 1)))
        axs1[row, 2].plot(tt, inst, "r:")
        axs1[row, 2].plot(tt, cum, "r-")
        axs1[row, 2].set_yscale("log")
        for sel, style in ((0, ":"), (len(ek) // 2, "--"), (-1, "-")):
            axs1[row, 3].plot(k2, np.abs(ek[sel][1:g // 2]), style, color=colors[row])
        axs1[row, 3].set_xscale("log")
        axs1[row, 3].set_yscale("log")
        for sel, style in ((0, "r:"), (len(ek) // 2, "r--"), (-1, "r-")):
            rel = np.abs((dns_ek[tidx[sel]][1:g // 2] - ek[sel][1:g // 2])
                         / dns_ek[tidx[sel]][1:g // 2])
            axs1[row, 4].plot(k2, rel, style)
        axs1[row, 4].set_xscale("log")
        axs1[row, 4].set_yscale("log")
        if "action_fields" in d:
            a = np.asarray(d["action_fields"])
            acolors = plt.cm.coolwarm(np.linspace(0, 1, a.shape[1]))
            for i in range(a.shape[1]):
                axs1[row, 5].plot(tt, a[:, i], color=acolors[i])
    fig1.tight_layout()
    fig1.savefig(f"{file_prefix}.png")
    plt.close(fig1)

    # ---- 2x2 SGS-term distribution (plotting.py:346-407) ----
    if "sgs_kde_grid" in data:
        xi = (np.arange(N) % max(N // g, 1)) == 0
        dns_sgs = np.asarray(dns["sgs_history"])[:, xi]
        sgs_hist = np.asarray(sgs["sgs_history"])
        svals, dns_kde, sgs_kde = data["sgs_kde_grid"], data["dns_sgs_kde"], data["sgs_sgs_kde"]
        fig3, axs3 = plt.subplots(2, 2, figsize=(10, 10))
        axs3[0, 0].contourf(np.arange(dns_sgs.shape[1]), dns_tt[:len(dns_sgs)], dns_sgs)
        axs3[0, 1].plot(svals, dns_kde, color=colors[0])
        axs3[0, 1].set_yscale("log")
        axs3[1, 0].contourf(np.asarray(sgs["x"]), np.asarray(sgs["tt"])[:len(sgs_hist)],
                            sgs_hist)
        axs3[1, 1].plot(svals, dns_kde, color=colors[0], linestyle="--")
        axs3[1, 1].plot(svals, sgs_kde, color=colors[2])
        fig3.tight_layout()
        fig3.savefig(f"{file_prefix}_action.png")
        plt.close(fig3)

        # closeup within +-3 sigma of the controlled forcing (plotting.py:410-425)
        mu_, sd = sgs_hist.mean(), sgs_hist.std()
        svals2 = np.linspace(mu_ - 3 * sd, mu_ + 3 * sd, 500)
        fig4, ax4 = plt.subplots(figsize=(10, 10))
        ax4.plot(svals2, _kde(dns_sgs, svals2), color=colors[0], linestyle="--")
        ax4.plot(svals2, _kde(sgs_hist, svals2), color=colors[2])
        ax4.set_yscale("log")
        fig4.tight_layout()
        fig4.savefig(f"{file_prefix}_action_closeup.png")
        plt.close(fig4)
    return data
