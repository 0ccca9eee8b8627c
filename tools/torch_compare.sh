#!/bin/bash
# Two checkouts timed on one card in turns: parent, change, change, parent.
# Each turn runs every COMMAND (a bash command line) from this checkout
# with ROOT set to the turn's checkout: the timing scripts of tools/ take
# --root "$ROOT"; a checkout's own script runs as (cd "$ROOT" && ...).
# Each command is a process of its own, which builds ROOT's kernels.
# Prints the card's name and power limit first, then "=== <turn>" before
# each turn's output.
#
#   git archive <parent> | tar -x -C build/parent
#   tools/torch_compare.sh build/parent COMMAND...
#
# The serving program (PERF.md, PR 18):
#   tools/torch_compare.sh build/parent \
#     'python3 tools/torch_sched_times.py --root "$ROOT" 2>&1 | tail -14' \
#     '(cd "$ROOT" && python3 bench_torch.py --ticks 64 --latency-ticks 20 \
#        --no-exact-arm 2>/dev/null | tail -1)'
# The frames read in place and scan_step's modes (PERF.md):
#   tools/torch_compare.sh build/parent \
#     'python3 tools/torch_select_times.py --root "$ROOT" --copy 2>&1 | tail -1' \
#     'python3 tools/torch_sched_times.py --root "$ROOT" 2>&1 | tail -14' \
#     'python3 tools/torch_sched_times.py --root "$ROOT" --big 2>&1 | tail -2'
# The relock tick, the group kernel and the graphs' nodes (PRs 13-15):
#   tools/torch_compare.sh build/parent \
#     '(cd "$ROOT" && python3 tools/torch_bench_parts.py \
#        --parts bucket,bucket_eager,dispatch 2>&1 | grep -v "^#" | tail -4)' \
#     'python3 tools/torch_group_times.py --root "$ROOT" 2>&1 | tail -1' \
#     'python3 tools/torch_graph_nodes.py --root "$ROOT" 2>&1 | tail -1'
# The few escape body and slot_gather (PERF.md §6):
#   tools/torch_compare.sh build/parent \
#     'python3 tools/torch_bucket_times.py --root "$ROOT" 2>&1 | tail -1' \
#     'python3 tools/torch_sched_times.py --root "$ROOT" 2>&1 | tail -1' \
#     'python3 tools/torch_graph_nodes.py --root "$ROOT" 2>&1 | tail -2'
set -e
if [ $# -lt 2 ]; then
  echo "usage: $0 PARENT_CHECKOUT COMMAND..." >&2
  exit 2
fi
parent=$(cd "$1" && pwd)
shift
here=$(cd "$(dirname "$0")/.." && pwd)
cd "$here"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for turn in "p1 $parent" "c1 $here" "c2 $here" "p2 $parent"; do
  name=${turn%% *}
  echo "=== $name"
  for cmd in "$@"; do
    ROOT=${turn#* } bash -c "$cmd"
  done
done
