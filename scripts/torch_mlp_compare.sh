#!/bin/bash
# The MLP kernel of two trees side by side on one card: the parent commit's,
# unpacked by `git archive` into a gitignored folder of the repo, and the
# working tree's, in turns (parent, change, change, parent), each a process of
# its own that builds its tree's kernel (scripts/torch_mlp_compare.py).  Run
# from the root of the working tree, on the machine with the card:
#
#   rm -rf _parent_tree && mkdir _parent_tree && git archive HEAD | tar -x -C _parent_tree
#   bash scripts/torch_mlp_compare.sh _parent_tree chiprun_out/mlp_compare
set -euo pipefail
parent=$(cd "$1" && pwd)
here=$(pwd)
out="$here/$2"
mkdir -p "$out"
run() {
  (cd "$1" && PYTHONPATH="$1" python3 "$here/scripts/torch_mlp_compare.py" --tag "$2" --out "$out")
}
run "$parent" parent_1
run "$here" change_1
run "$here" change_2
run "$parent" parent_2
