#!/usr/bin/env bash
# The bench scripts' measurements on one CUDA card, in one process tree, so
# that every number comes from the same card:
#   - torch_bench_serve.py on a full-width flagship checkpoint with seeded
#     random weights (chip_smoke.flagship_checkpoint), live at the training
#     batch (16), live at --batch-size 1, and on an artifact exported on the
#     card (`cli predict --export-artifact`). Run from a checkout with no
#     build/kernels/, the first one's warmup_compile_s holds the kernels' nvcc
#     build;
#   - torch_bench.py, the frozen and the fine-tuned leg in turns, 3 times
#     each;
#   - torch_bench_phases.py, both legs;
#   - torch_trace_report.py: step in both legs, step_cached, bert and cxr;
#   - torch_bench_text_cache.py once;
#   - torch_bench_bert.py with the poly GELU (its default), with
#     BENCH_GELU=erf and with BENCH_BERT_INT8=1;
#   - torch_bench_int8.py once.
# Each run's output goes to OUT_DIR/<name>.log; the card's name and power
# limit to OUT_DIR/card.txt.
#
#   scripts/torch_bench_card.sh [OUT_DIR]     (default runs/bench)
set -euo pipefail
cd "$(dirname "$0")/.."
out=${1:-runs/bench}
mkdir -p "$out"
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"

run() {  # run NAME COMMAND...: the command's output to OUT_DIR/NAME.log and its last line here
  local name=$1
  shift
  local t0=$SECONDS
  "$@" > "$out/$name.log" 2>&1 || { echo "$name failed:"; tail -n 30 "$out/$name.log"; exit 1; }
  echo "$name ($((SECONDS - t0)) s): $(tail -n 1 "$out/$name.log")"
}

run checkpoint python3 -c "import sys, chip_smoke as cs; cs.flagship_checkpoint(sys.argv[1])" "$work/ckpt/final"
run serve_live_b16 python3 scripts/torch_bench_serve.py --ckpt "$work/ckpt"
run serve_live_b1 python3 scripts/torch_bench_serve.py --ckpt "$work/ckpt" --batch-size 1
run export python3 -m multimodalrouting_tpu_torch.cli predict --ckpt "$work/ckpt" --export-artifact "$work/art"
run serve_artifact python3 scripts/torch_bench_serve.py --artifact "$work/art"
for i in 1 2 3; do
  run "bench_frozen_$i" env BENCH_FINETUNE=0 python3 scripts/torch_bench.py
  run "bench_finetune_$i" env BENCH_FINETUNE=1 python3 scripts/torch_bench.py
done
run phases_frozen env BENCH_FINETUNE=0 python3 scripts/torch_bench_phases.py
run phases_finetune env BENCH_FINETUNE=1 python3 scripts/torch_bench_phases.py
run trace_step_frozen env BENCH_FINETUNE=0 python3 scripts/torch_trace_report.py step
run trace_step_finetune env BENCH_FINETUNE=1 python3 scripts/torch_trace_report.py step
run trace_step_cached env BENCH_FINETUNE=0 python3 scripts/torch_trace_report.py step_cached
run trace_bert python3 scripts/torch_trace_report.py bert
run trace_cxr python3 scripts/torch_trace_report.py cxr
run text_cache python3 scripts/torch_bench_text_cache.py
run bert_poly python3 scripts/torch_bench_bert.py
run bert_erf env BENCH_GELU=erf python3 scripts/torch_bench_bert.py
run bert_int8 env BENCH_BERT_INT8=1 python3 scripts/torch_bench_bert.py
run int8 python3 scripts/torch_bench_int8.py
