#!/bin/bash
# The 8-redetect relock tick of the headline configuration (256 streams of
# 320x240, 96x128 band, bandHist, bucket 8) and the replayed all-CS tick's
# dispatch, timed by tools/torch_bench_parts.py in two checkouts on one card,
# in turns: parent, change, change, parent.
#
#   git archive <parent> | tar -x -C build/parent
#   tools/torch_relock_compare.sh build/parent
#
# The parent runs --parts bucket,dispatch; this checkout also bucket_eager
# (the same tick run eagerly).  Each turn then times the group kernel of its
# checkout and counts the nodes of its warmup()'s graphs
# (tools/torch_group_times.py and tools/torch_graph_nodes.py of this
# checkout, --root the turn's).
# Prints the card's name and power limit first.
set -e
parent=$(cd "$1" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {
  echo "=== $1"
  (cd "$2" && python3 tools/torch_bench_parts.py --parts "$3" 2>&1 \
     | grep -v "^#" | tail -4)
  python3 "$here/tools/torch_group_times.py" --root "$2" 2>&1 | tail -1
  python3 "$here/tools/torch_graph_nodes.py" --root "$2" 2>&1 | tail -1
}
run p1 "$parent" bucket,dispatch
run c1 "$here" bucket,bucket_eager,dispatch
run c2 "$here" bucket,bucket_eager,dispatch
run p2 "$parent" bucket,dispatch
