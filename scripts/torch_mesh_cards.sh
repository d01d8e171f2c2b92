#!/usr/bin/env bash
# --mesh across the cards of one host (run from the repo root on a machine
# with 4 cards): the multi-process dry run on 4 ranks, then the run-918 flags
# at 3 envs a rank, 3 generations of 100 updates, at a world of 1 and of 4
# (world 1, 4, 1 for the host's drift).  Each dry-run JSON line (standard
# output) gives every rank's digest, updates and seconds after each
# generation ("wall_time"); the ranks' output, with rank 0's [mesh] backend
# line, goes to <out>/*.err.
#   bash scripts/torch_mesh_cards.sh <out>
set -o pipefail
OUT=${1:?usage: $0 <out dir>}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
F="burger-marl --nagents 32 --specreward --dforce --ic turbulence --width 128 --iex 0.1 --mbsize 8 --maxupd 100 --testepisodes 8 --rscale cumulative --trust forward --diag --mesh"
D="python -m marlpde_tpu_torch.parallel.dryrun"
rc=0
$D --world 4 2>"$OUT/w4_dryrun.err" | tail -1 || rc=1
$D --world 1 --cli $F --numenvs 3 --NE 4500 --rstart 1000 --run 93 2>"$OUT/w1a_cli.err" | tail -1 || rc=1
$D --world 4 --cli $F --numenvs 12 --NE 18000 --rstart 4000 --run 94 2>"$OUT/w4_cli.err" | tail -1 || rc=1
$D --world 1 --cli $F --numenvs 3 --NE 4500 --rstart 1000 --run 95 2>"$OUT/w1b_cli.err" | tail -1 || rc=1
grep -H "\[mesh\]\|OK rank" "$OUT"/*.err
exit $rc
