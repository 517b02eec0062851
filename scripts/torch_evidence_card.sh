#!/usr/bin/env bash
# The port's learning evidence on one CUDA card (scripts/round5_evidence.sh's
# runs), one after the other:
#   - torch_demo_families.py --epochs 6 --n 256: the 18 family runs;
#   - torch_demo_synthetic.py --n 1024 --epochs 12: the flagship's run.
# Each runs under its own timeout with its output in OUT_DIR/<name>.log and
# its exit code at the log's foot; the card's name and power limit go to
# OUT_DIR/card.txt. The runs write their directories under a temporary
# directory (a full-width checkpoint is ~1 GB, and the gated and FAME chains
# read the earlier stage's through --init-from); what comes back to
# OUT_DIR/families/ and OUT_DIR/flagship/ is their JSON and CSV files:
# summary.json, each run's history.json or unimodal_metrics.json and
# fairness reports, the flagship's history and audit exports. The exit code
# is the larger of the two runs'.
#
#   scripts/torch_evidence_card.sh [OUT_DIR]     (default runs/evidence)
set -uo pipefail
cd "$(dirname "$0")/.."
out=${1:-runs/evidence}
mkdir -p "$out"
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"

run() {  # run NAME SECONDS COMMAND...: the command under timeout, its output and rc to OUT_DIR/NAME.log
  local name=$1 secs=$2
  shift 2
  local t0=$SECONDS
  timeout "$secs" "$@" > "$out/$name.log" 2>&1
  local rc=$?
  echo "$name rc=$rc" >> "$out/$name.log"
  echo "$name rc=$rc ($((SECONDS - t0)) s)"
  return $rc
}

keep() {  # keep SRC DST: SRC's JSON and CSV files, two levels deep, to DST
  (cd "$1" && find . -maxdepth 2 -type f \( -name '*.json' -o -name '*.csv' -o -name '*.jsonl' \) -print0 \
    | xargs -0 -r cp --parents -t "$2")
}

run families 3000 python3 scripts/torch_demo_families.py --epochs 6 --n 256 --out "$work/families"
families=$?
mkdir -p "$out/families" && keep "$work/families" "$(realpath "$out/families")"
rm -rf "$work/families"
run flagship 1200 python3 scripts/torch_demo_synthetic.py --n 1024 --epochs 12 --out "$work/flagship"
flagship=$?
mkdir -p "$out/flagship" && keep "$work/flagship" "$(realpath "$out/flagship")"
tail -n 20 "$out/families.log"
tail -n 2 "$out/flagship.log"
exit $((families > flagship ? families : flagship))
