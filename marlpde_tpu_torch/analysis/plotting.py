"""Plotting: the reference's analysis figures (port of
marlpde_tpu/analysis/plotting.py).

Parity targets (python/_model/plotting.py):
  * plotField / plotError / plotAvgSpectrum and the two movies  :10-135
  * makePlot — the 3x6 panel DNS/uncontrolled/controlled comparison with
    field snapshots, error traces, spectra and SGS-term KDEs    :161-433
  * makeDiffusionPlot                                           :435
  * plotting_diffusion.py / plotting_laplace.py panels          :13-128 / :13-90
  * plotEpisode.py over the --save-episodes dumps               :24-52
  * the korali.rlview training curves (runs/burger_launcher.sh:72)

Every function takes numpy arrays and returns the numbers its figure shows
(numpy and scipy).  matplotlib is imported lazily with the Agg backend; where
it is not installed, each function writes those numbers to an ``.npz`` in
place of its figures (``<prefix>_panels.npz`` for makePlot, else the
figure's name with ``.npz`` for its extension) and prints one line saying so.
"""

from __future__ import annotations

import glob
import importlib.util
import os

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


def figure_or_data(fname, data):
    """pyplot where matplotlib is installed; else write ``data`` to ``fname``
    with the extension ``.npz``, say so, and return None."""
    plt = _plt()
    if plt is None:
        path = os.path.splitext(fname)[0] + ".npz"
        np.savez(path, **data)
        print(f"[plotting] matplotlib is not installed: wrote the data of {fname} to {path}")
    return plt


def plot_field(x, u, fname="field.png", title=None):
    data = dict(x=np.asarray(x), u=np.asarray(u))
    plt = figure_or_data(fname, data)
    if plt is None:
        return data
    fig, ax = plt.subplots()
    ax.plot(data["x"], data["u"])
    if title:
        ax.set_title(title)
    fig.savefig(fname)
    plt.close(fig)
    return data


def plot_error(x, err, fname="error.png"):
    data = dict(x=np.asarray(x), err=np.asarray(err))
    plt = figure_or_data(fname, data)
    if plt is None:
        return data
    fig, ax = plt.subplots()
    ax.plot(data["x"], data["err"])
    ax.set_yscale("log")
    fig.savefig(fname)
    plt.close(fig)
    return data


def _movie_frames(tt, num_frames):
    tt = np.asarray(tt)
    return tt, np.linspace(0, len(tt) - 1, min(num_frames, len(tt))).astype(int)


def make_movie_field(x_list, uu_list, tt, fname="evolution.gif", num_frames=100,
                     ylim=(-1.0, 2.75), fps=20):
    """Field-evolution movie (makeMovieField, plotting.py:35-67): several
    trajectories overlaid per frame; ``x_list[i]`` is model i's grid,
    ``uu_list[i]`` its (T+1, N) trajectory, ``tt`` the shared times.  Writes
    an animated GIF; returns the frames' times and fields."""
    tt, fidx = _movie_frames(tt, num_frames)
    data = dict(t=tt[fidx], **{f"x{i}": np.asarray(x) for i, x in enumerate(x_list)},
                **{f"uu{i}": np.asarray(uu)[fidx] for i, uu in enumerate(uu_list)})
    plt = figure_or_data(fname, data)
    if plt is None:
        return data
    from matplotlib import animation
    colors = ["royalblue", "coral"]          # plotting.py:38-39
    alphas = [1.0, 0.8]
    fig, ax = plt.subplots()
    lines = [ax.plot([], [], "-", color=colors[i % 2], alpha=alphas[i % 2])[0]
             for i in range(len(uu_list))]
    ax.set_xlim(min(np.min(x) for x in x_list), max(np.max(x) for x in x_list))
    ax.set_ylim(*ylim)                        # plotting.py:55
    txt = ax.text(0.75, 0.9, "", transform=ax.transAxes, fontsize=12)

    def draw(j):
        for i, ln in enumerate(lines):
            ln.set_data(data[f"x{i}"], data[f"uu{i}"][j])
        txt.set_text(f"t={data['t'][j]:.2f}")
        return lines + [txt]

    ani = animation.FuncAnimation(fig, draw, frames=len(fidx), blit=True)
    ani.save(fname, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return data


def make_movie_spectrum(k_list, ek_ktt_list, tt, fname="evolution_spectrum.gif",
                        num_frames=100, ylim=(1e-7, 1.0), fps=20):
    """Spectrum-evolution movie (makeMovieSpectrum, plotting.py:69-104):
    log-log E(k) up to the coarsest model's Nyquist, one frame per time;
    returns the frames' times, wavenumbers and spectra."""
    tt, fidx = _movie_frames(tt, num_frames)
    half = min(np.asarray(ek).shape[-1] for ek in ek_ktt_list) // 2  # :80,88
    data = dict(t=tt[fidx],
                **{f"k{i}": np.abs(np.asarray(k)[1:half]) for i, k in enumerate(k_list)},
                **{f"ek{i}": np.asarray(ek)[fidx, 1:half] for i, ek in enumerate(ek_ktt_list)})
    plt = figure_or_data(fname, data)
    if plt is None:
        return data
    from matplotlib import animation
    colors = ["royalblue", "coral"]
    alphas = [1.0, 0.8]
    fig, ax = plt.subplots()
    lines = [ax.plot([], [], "-", color=colors[i % 2], alpha=alphas[i % 2])[0]
             for i in range(len(ek_ktt_list))]
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlim(1, max(half, 2))
    ax.set_ylim(*ylim)                        # plotting.py:94
    txt = ax.text(0.75, 0.9, "", transform=ax.transAxes, fontsize=12)

    def draw(j):
        for i, ln in enumerate(lines):
            ln.set_data(data[f"k{i}"], data[f"ek{i}"][j])
        txt.set_text(f"t={data['t'][j]:.2f}")
        return lines + [txt]

    ani = animation.FuncAnimation(fig, draw, frames=len(fidx), blit=True)
    ani.save(fname, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return data


def plot_avg_spectrum(ek_ktt_list, labels, fname="spectrum.png"):
    """E(k) of each model, modes 1 .. N/2-1, log-log (plotAvgSpectrum)."""
    data = {f"ek{i}": np.asarray(ek)[1:len(ek) // 2] for i, ek in enumerate(ek_ktt_list)}
    plt = figure_or_data(fname, data)
    if plt is None:
        return data
    fig, ax = plt.subplots()
    for i, lab in enumerate(labels):
        ek = data[f"ek{i}"]
        ax.loglog(np.arange(1, len(ek) + 1), ek, label=lab)
    ax.set_xlabel("k")
    ax.set_ylabel("E(k)")
    ax.legend()
    fig.savefig(fname)
    plt.close(fig)
    return data


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


def make_diffusion_plot(x, tt, uu, solution, fname="diffusion.png"):
    """Evolution vs analytical panels (plotting.py:435, plotting_diffusion.py:13-60):
    6 snapshots, mse(t) against the solution and mass(t)."""
    uu, sol = np.asarray(uu), np.asarray(solution)
    data = dict(snapshots=np.linspace(0, len(uu) - 1, 6, dtype=int),
                mse=np.mean((uu - sol) ** 2, axis=1), mass=np.sum(uu, axis=1))
    plt = figure_or_data(fname, data)
    if plt is None:
        return data
    fig, axs = plt.subplots(1, 3, figsize=(15, 4))
    for i in data["snapshots"]:
        axs[0].plot(x, uu[i], alpha=0.4 + 0.6 * i / len(uu))
    axs[0].set_title("evolution")
    axs[1].plot(tt, data["mse"])
    axs[1].set_yscale("log")
    axs[1].set_title("mse(t)")
    axs[2].plot(tt, data["mass"])
    axs[2].set_title("mass(t)")
    fig.tight_layout()
    fig.savefig(fname)
    plt.close(fig)
    return data


def plot_action_field(x, action_fields, fname="actions.png"):
    """Mean/quantile action fields (plotting_diffusion.py:63-86)."""
    a = np.asarray(action_fields)
    data = dict(mean=a.mean(0), q10=np.quantile(a, 0.1, 0), q90=np.quantile(a, 0.9, 0))
    plt = figure_or_data(fname, data)
    if plt is None:
        return data
    fig, ax = plt.subplots()
    ax.plot(x, data["mean"], label="mean")
    ax.fill_between(x, data["q10"], data["q90"], alpha=0.3)
    ax.legend()
    fig.savefig(fname)
    plt.close(fig)
    return data


def plot_episode_dumps(npz_glob: str, out_prefix: str = "episode", action_range=(-4.0, 4.0)):
    """Post-hoc plots from episode dumps (plotEpisode.py:24-52).

    Loads every npz matching ``npz_glob`` (the trainer's --save-episodes
    output or evaluation dumps), then writes (i) a reward-trajectory quantile
    fan (median + 20/80% band, plotEpisode.py:25-37) and (ii) a KDE of the
    action (SGS-forcing) distribution (plotEpisode.py:40-52).  Returns the
    two written filenames (the ``.npz`` of their data where matplotlib is
    not installed)."""
    files = sorted(glob.glob(npz_glob))
    if not files:
        raise FileNotFoundError(f"[plotting] no episode dumps match {npz_glob}")
    rewards, actions = [], []
    for f in files:
        d = np.load(f)
        rewards.append(np.asarray(d["rewards"]).reshape(
            d["rewards"].shape[0], d["rewards"].shape[1], -1).mean(-1))
        actions.append(np.asarray(d["actions"]).reshape(-1))
    rewards = np.concatenate(rewards, axis=0)      # (episodes, T)
    actions = np.concatenate(actions)
    quant = dict(t=np.arange(rewards.shape[1]), q20=np.quantile(rewards, 0.2, axis=0),
                 q50=np.quantile(rewards, 0.5, axis=0), q80=np.quantile(rewards, 0.8, axis=0))
    svals = np.linspace(action_range[0], action_range[1], 500)
    # a degenerate (e.g. all-zero) dump has no KDE: its figure is a histogram
    kde = dict(grid=svals, kde=_kde(actions, svals), actions=actions)

    fq, fk = f"{out_prefix}_quantiles.png", f"{out_prefix}_action_kde.png"
    plt = figure_or_data(fq, quant)
    if plt is None:
        figure_or_data(fk, kde)
        return f"{out_prefix}_quantiles.npz", f"{out_prefix}_action_kde.npz"
    fig, ax = plt.subplots()
    ax.plot(quant["t"], quant["q50"], color="coral")
    ax.fill_between(quant["t"], quant["q20"], quant["q80"], color="coral", alpha=0.2)
    ax.set_xlabel("macro-step")
    ax.set_ylabel("reward")
    fig.tight_layout()
    fig.savefig(fq)
    plt.close(fig)

    fig, ax = plt.subplots()
    if actions.std() > 0:
        ax.plot(svals, kde["kde"])
        ax.set_yscale("log")
    else:
        ax.hist(actions, bins=50)
    ax.set_xlabel("action")
    fig.tight_layout()
    fig.savefig(fk)
    plt.close(fig)
    return fq, fk


def plot_training_curves(history: dict, fname="training.png"):
    """korali.rlview equivalent: returns/episode-length/REFER beta vs experiences."""
    data = dict(experiences=np.asarray(history["experiences"]),
                mean_return=np.asarray(history["mean_return"]),
                mean_ep_len=np.asarray(history["mean_ep_len"]),
                beta=np.asarray([m.get("beta", np.nan) for m in history["metrics"]]))
    plt = figure_or_data(fname, data)
    if plt is None:
        return data
    fig, axs = plt.subplots(1, 3, figsize=(15, 4))
    for ax, (key, title) in zip(axs, (("mean_return", "mean return"),
                                      ("mean_ep_len", "episode length"),
                                      ("beta", "REFER beta"))):
        ax.plot(data["experiences"], data[key])
        ax.set_title(title)
    axs[0].set_xlabel("experiences")
    fig.tight_layout()
    fig.savefig(fname)
    plt.close(fig)
    return data


def _snapshot_rows(T):
    """The 6 equally spaced frames of a 2x3 evolution panel."""
    return np.array([min(int(i * T / 6), T - 1) for i in range(6)])


def plot_evolution_panels(x, tt, uu, solution=None, fname="evolution.png", second=None):
    """2x3 field-vs-solution snapshot panels (plotting_diffusion.py:13-33
    plotEvolution): 6 equally spaced times, solved field solid, analytical
    solution dashed; ``second`` (T, N) is a further field drawn dashed in
    the field's colour (Laplace's laplacian, plotting_laplace.py:13-32)."""
    uu = np.asarray(uu)
    rows = _snapshot_rows(len(uu))
    data = dict(rows=rows, u=uu[rows])
    if solution is not None:
        data["solution"] = np.asarray(solution)[rows]
    if second is not None:
        data["second"] = np.asarray(second)[rows]
    plt = figure_or_data(fname, data)
    if plt is None:
        return data
    fig, axs = plt.subplots(2, 3, sharex=True, sharey=second is None)
    for i in range(6):
        ax = axs[i // 3, i % 3]
        ax.plot(x, data["u"][i], "-", color="royalblue")
        if solution is not None:
            ax.plot(x, data["solution"][i], "--", color="coral")
        if second is not None:
            ax.plot(x, data["second"][i], "--", color="royalblue", alpha=0.8)
    fig.tight_layout()
    fig.savefig(fname)
    plt.close(fig)
    return data


def plot_action_contour(x, tt, action_fields, fname="actionfield.png"):
    """contourf of the action field over (x, t)
    (plotting_diffusion.py:91-103 plotActionField); a 3-channel field
    (T, na, 3) gives one panel a channel (plotting_laplace.py:34-56)."""
    a = np.asarray(action_fields)
    data = dict(x=np.asarray(x), t=np.asarray(tt), actions=a)
    plt = figure_or_data(fname, data)
    if plt is None:
        return data
    if a.ndim == 3:
        fig, axs = plt.subplots(1, a.shape[2], sharex=True, sharey=True, figsize=(12, 4))
        for c in range(a.shape[2]):
            cf = axs[c].contourf(x, tt, a[:, :, c])
    else:
        fig, ax = plt.subplots(figsize=(6, 6))
        cf = ax.contourf(x, tt, a)
    fig.colorbar(cf)
    fig.tight_layout()
    fig.savefig(fname)
    plt.close(fig)
    return data


def plot_field_contour(x, tt, uu, fname="field.png", levels=None):
    """contourf of u(x, t) (plotting_diffusion.py:105-116 plotDiffusionField —
    which contourf's actionHistory, an apparent bug; the JAX package plots
    the field the name promises, and so does the port)."""
    data = dict(x=np.asarray(x), t=np.asarray(tt), u=np.asarray(uu))
    plt = figure_or_data(fname, data)
    if plt is None:
        return data
    fig, ax = plt.subplots(figsize=(8, 8))
    cf = ax.contourf(x, tt, data["u"], **({} if levels is None else dict(levels=levels)))
    if levels is not None:
        fig.colorbar(cf)
    fig.tight_layout()
    fig.savefig(fname)
    plt.close(fig)
    return data


def plot_action_distribution(actions, fname="actiondist.png"):
    """Distribution of all executed actions (plotting_diffusion.py:118-128
    plotActionDistribution, a violin plot; rendered as KDE + histogram)."""
    a = np.asarray(actions).ravel()
    hist, edges = np.histogram(a, bins=64, density=True)
    data = dict(hist=hist, edges=edges)
    if a.std() > 1e-12:
        data["grid"] = np.linspace(a.min(), a.max(), 400)
        data["kde"] = _kde(a, data["grid"])
    plt = figure_or_data(fname, data)
    if plt is None:
        return data
    fig, ax = plt.subplots()
    ax.hist(a, bins=64, density=True, alpha=0.4, color="royalblue")
    if "kde" in data:
        ax.plot(data["grid"], data["kde"], color="coral")
    ax.set_xlabel("action")
    fig.tight_layout()
    fig.savefig(fname)
    plt.close(fig)
    return data
