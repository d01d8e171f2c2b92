#!/usr/bin/env bash
# The whole-run acceptance of the port on one card: run 918 (the flags of
# scripts/tpu_flagship_918.sh) or run 926 (scripts/tpu_ks_926.sh) trained to
# the end on python -m marlpde_tpu_torch.run, then --test and --test --best,
# at each seed in turn.  Each run's log, its history.json and a timing line
# go to <out>; the last line of each *_test.log is the --test summary (the
# final deterministic return, and for KS the controlled and uncontrolled
# returns per pool id).  The _result_* folders stay in the repo root.
# A training stage is cut at CAP seconds (1.3-1.5x a whole run on an H100):
# once every episode blows up in its first macro-step, korali's accounting
# adds 10 live steps a generation and the run would not reach --NE in days.
# --test then reads the last checkpoint (written every 25 generations).
# PKG=marlpde_tpu runs the same stages on the JAX package (JAX_PLATFORMS=cpu
# for the CPU; CAP=0 lifts the cut, which is sized for the card).
#   bash scripts/torch_acceptance.sh <out> 918|926 [seed ...]     (default seeds: 42 7)
#   env PKG=marlpde_tpu JAX_PLATFORMS=cpu CAP=0 bash scripts/torch_acceptance.sh <out> 926 7
set -o pipefail
OUT=${1:?usage: $0 <out dir> 918|926 [seed ...]}
RUN=${2:?usage: $0 <out dir> 918|926 [seed ...]}
shift 2
SEEDS=${*:-42 7}
PKG=${PKG:-marlpde_tpu_torch}
mkdir -p "$OUT"
if [ "$PKG" = marlpde_tpu_torch ]; then
    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
    python -c 'from marlpde_tpu_torch.kernels import build; build.build_all(("abcn", "mlp"))'
fi
P="python -m $PKG.run"
case $RUN in
    918) FLAGS="burger-marl --nagents 32 --specreward --dforce --ic turbulence --width 128 --iex 0.1 --rscale cumulative --trust forward"
         TRAIN="--NE 1000000 --numenvs 10 --mbsize 8 --maxupd 2500 --testfreq 10 --testepisodes 8 --diag"
         TEST="--testepisodes 8" RES=_result_burger-marl CAP=${CAP:-660} ;;
    926) FLAGS="ks --N 16 --NA 16 --ndns 16 --sigma-max 5 --iex 0.01"
         TRAIN="--NE 1000000 --numenvs 16 --maxupd 1000 --fused --testfreq 10 --testepisodes 16"
         TEST="--testepisodes 16" RES=_result_ks CAP=${CAP:-300} ;;
    *) echo "usage: $0 <out dir> 918|926 [seed ...]" >&2; exit 2 ;;
esac

stage() {  # stage <log> <command...>: run, then append "<log> rc=<rc> seconds=<s>" to timing.txt
    local log="$1"; shift
    local t0=$SECONDS
    "$@" >"$OUT/$log" 2>&1
    local rc=$?
    echo "$log rc=$rc seconds=$((SECONDS - t0))" | tee -a "$OUT/timing.txt"
    return $rc
}

rc=0
for s in $SEEDS; do
    tag=$((RUN * 1000 + s))
    stage "${RUN}_s$s.log" timeout $CAP $P $FLAGS $TRAIN --seed "$s" --run $tag || rc=1
    cp "${RES}_$tag/history.json" "$OUT/${RUN}_s${s}_history.json"
    stage "${RUN}_s${s}_test.log" $P $FLAGS --seed "$s" --run $tag --test $TEST || rc=1
    stage "${RUN}_s${s}_test_best.log" $P $FLAGS --seed "$s" --run $tag --test --best $TEST || rc=1
done
for f in "$OUT"/"${RUN}"_*_test*.log; do echo "$(basename "$f") $(tail -1 "$f")"; done
exit $rc
