"""Training-curve viewer CLI: the korali.rlview equivalent
(runs/burger_launcher.sh:72 `python3 -m korali.rlview --dir ... --out ...`;
port of marlpde_tpu/analysis/rlview.py).

Usage: python -m marlpde_tpu_torch.analysis.rlview --dir _result_burger_0 [--out curves.png]

It reads the ``history.json`` that ``utils/checkpoint.save_train_state``
writes.  Without ``--out`` it prints one JSON stats line per result folder.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="marlpde_tpu_torch.analysis.rlview")
    p.add_argument("--dir", required=True, nargs="+",
                   help="result folder(s) containing history.json")
    p.add_argument("--out", default=None, help="output PNG (default: show stats)")
    args = p.parse_args(argv)

    from marlpde_tpu_torch.analysis import plotting

    histories = []
    for d in args.dir:
        h = os.path.join(d, "history.json")
        if not os.path.exists(h):
            print(f"[rlview] no history.json in {d}", file=sys.stderr)
            continue
        with open(h) as f:
            histories.append((d, json.load(f)))

    if not histories:
        raise SystemExit("[rlview] nothing to plot")

    if args.out:
        if len(histories) == 1:
            plotting.plot_training_curves(histories[0][1], args.out)
        else:
            curves = {f"{key}{i}": h[key] for i, (_, h) in enumerate(histories)
                      for key in ("experiences", "mean_return")}
            plt = plotting.figure_or_data(args.out, curves)
            if plt is not None:
                fig, ax = plt.subplots()
                for d, h in histories:
                    ax.plot(h["experiences"], h["mean_return"], label=d)
                ax.set_xlabel("experiences")
                ax.set_ylabel("mean return")
                ax.legend()
                fig.savefig(args.out)
                plt.close(fig)
        print(f"[rlview] wrote {args.out}")
    else:
        for d, h in histories:
            print(json.dumps(dict(
                dir=d, generations=h["gen"][-1],
                experiences=h["experiences"][-1],
                last_return=h["mean_return"][-1],
                best_return=max(h["mean_return"]))))


if __name__ == "__main__":
    main()
