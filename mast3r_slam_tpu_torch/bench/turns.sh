#!/usr/bin/env bash
# Run chip_smoke.py's phases from several checkouts of the repo in the
# order given, to compare trees in one call on one card (A B B A spreads
# the host's drift over both):
#
#   bash mast3r_slam_tpu_torch/bench/turns.sh OUT PHASES DIR...
#
# Run n's output goes to OUT/<n>-<basename of DIR>.txt. At the end it
# prints every run's main-path frame, event, CLI and phase-time lines; it
# exits 1 if any run failed.
set -u
out=$(realpath -m "$1")
phases=$2
shift 2
mkdir -p "$out"
rc=0
n=0
for dir in "$@"; do
  n=$((n + 1))
  log="$out/$n-$(basename "$dir").txt"
  (cd "$dir" && python3 chip_smoke.py --phases "$phases") >"$log" 2>&1
  r=$?
  echo "run $n $(basename "$dir"): exit $r"
  [ "$r" -eq 0 ] || rc=1
done
grep -HE "^(main path: median|event:|cli main:|phase times)" "$out"/*.txt \
  | cut -c1-400
exit "$rc"
