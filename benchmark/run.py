"""Run one cell of the benchmark of marlpde_tpu_torch once, on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration and a traffic mix; the traffic names the runner that runs the
program.  Set-up (from the start of this process: imports, the kernels'
libraries, the DNS pool, the weights from the seed, the warm-up units and
every graph capture) ends at a unit boundary; the window then runs whole
units until ``--seconds`` have passed; one more unit runs for the check,
which holds its outputs against the plain reference (``bench_check``).

Prints the checks on standard error and, as the last line of standard
output, one JSON object: ``correct``, ``attempted`` and ``failed`` (the
window's episodes and those a blow-up truncated), ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and ``checks``.
Exits non-zero without a result where there is no card, where the card count
is below the cell's, or where JAX or the JAX package was imported.

``--control`` and ``--fault`` are not used by the benchmark's own runs: the
first also judges the control (the reference in TF32 put in the program's
place) against the cell's limits and prints its readings and verdict (the
result's ``control``); the second plants a fault under the timed path
(``bench_faults``), which the run's own ``correct`` judges.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# compared by whole top-level module names: marlpde_tpu_torch is not marlpde_tpu
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "marlpde_tpu"})


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


def parse(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="also judge the control (the reference in TF32) against the limits")
    p.add_argument("--fault", default=None,
                   help="plant a fault under the timed path (bench_faults.NAMES)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    import torch

    import bench_spec

    cell = bench_spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[bench] {cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(1, str(ROOT))
    work = Path(tempfile.mkdtemp(prefix="marlpde_bench_"))
    cwd = os.getcwd()
    try:
        os.chdir(work)
        return run_cell(cell, args, torch.device("cuda", 0))
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


def run_cell(cell, args, device) -> int:
    import bench_check
    import bench_session
    import bench_spec

    session = bench_session.Session(cell, args, T0, device)
    if args.fault:
        import bench_faults
        bench_faults.install(args.fault, session.patches)
    with contextlib.redirect_stdout(sys.stderr):
        bench_spec.load_module("runners", cell.traffic["runner"]).run(session)
        if session.t_end is None:
            print("[bench] the window never closed", file=sys.stderr)
            return 1
        metrics = session.per_layer() if session.trace else session.end_to_end()
        t_ref = time.perf_counter()
        values = bench_check.numbers(cell.config, cell.traffic, session.snap, args.seed, device)
        print(f"[bench] window {session.window_s():.3f} s, {len(session.units)} units; "
              f"reference {time.perf_counter() - t_ref:.3f} s; units' seconds "
              + json.dumps([round(u["wall_s"], 4) for u in session.units]), file=sys.stderr)
        check = bench_session.checks(values, cell.limits, session.captures.in_window_count)
        if session.captures.in_window_count:
            print(f"[bench] graphs captured in the window: {session.captures.names}",
                  file=sys.stderr)
        if args.control:
            control = bench_check.control_snapshot(cell.config, cell.traffic, session.snap,
                                                   args.seed, device)
            readings = bench_check.numbers(cell.config, cell.traffic, control, args.seed, device)
            control_check = bench_session.checks(readings, cell.limits, 0)
            print("[bench] control " + json.dumps(bench_session.printable(control_check)),
                  file=sys.stderr)
            print(f"[bench] control correct {bench_session.passed(control_check)}",
                  file=sys.stderr)
        found = forbidden_modules()
        if found:
            print(f"[bench] the process imported {', '.join(found)}", file=sys.stderr)
            return 3
    result = dict(
        correct=bench_session.passed(check),
        attempted=sum(u["episodes"] for u in session.units),
        failed=sum(u["blowups"] for u in session.units),
        metrics=metrics, device=session.device_info())
    if args.control:
        result["control"] = bench_session.passed(control_check)
    if session.trace:
        result["breakdown"] = dict(device_ops=session.stretch_summary["ops"],
                                   idle_gaps=session.stretch_summary["gaps"])
    result["checks"] = bench_session.printable(check)
    bench_session.report(check)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
