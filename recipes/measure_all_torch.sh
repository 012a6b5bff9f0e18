#!/bin/bash
# The PyTorch port's twin of recipes/measure_all.sh: the same stages, stage
# machinery and resume guard, through quality_torch_cli.py,
# spec_acceptance_torch_cli.py and bench_torch.py with the JAX script's
# arguments, on a CUDA card unless DEVICE says otherwise.  Each stage writes
# $MEAS/<name>.json and is SKIPPED when that file already parses as JSON, so
# a relaunch resumes where the last run stopped.  Stages run one at a time.
#
#   bash recipes/measure_all_torch.sh                   # foreground
#   setsid nohup bash recipes/measure_all_torch.sh \
#       > /tmp/measure_r5_torch.log 2>&1 &
#
# Needs the two-stage checkpoint of recipes/spec_acceptance_torch.sh
# TWO_STAGE=1 WORK=${TMPDIR:-/tmp}/spec830_torch (this script's default WORK):
# $WORK/exp/ckpt_latest (+7 MTP heads).
# DEVICE=cpu passes --device cpu to every command.
#
# Stages:
#   quality        quality_torch_cli, every decode mode (log-mel + MCD table)
#   edit_accept    editing spec acceptance: B=1 + B=8 waves, tau 2/4/8, fp8
#   sweep_greedy_L{8,16,32}  spec-serving lane sweep, tau=8, fp8 + fp8 KV
#   sweep_stoch_L{8,16,32}   same, stochastic sampling T=0.8 (draft T 0.1)
#   train_profile  bench_torch --train-profile cost ladder (B=11)
#   stream_pipe / stream_nopipe  pipelined streaming A/B (burst 24)
#   engine_short / engine_steady engine tau=4 vs 8 (2x vs 8x requests)
set -u
cd "$(dirname "$0")/.."
WORK=${WORK:-${TMPDIR:-/tmp}/spec830_torch}
MEAS=${MEAS:-$WORK/measure_r5}
CKPT=${CKPT:-$WORK/exp/ckpt_latest}
EVAL=${EVAL:-$WORK/corpus/eval}
BINS=${BINS:-2048}
DEVICE_FLAG=${DEVICE:+--device $DEVICE}
mkdir -p "$MEAS"
test -d "$CKPT" || { echo "no checkpoint at $CKPT — run" \
  "recipes/spec_acceptance_torch.sh TWO_STAGE=1 first"; exit 1; }

valid() {
  python - "$1" <<'EOF'
import json, sys
txt = open(sys.argv[1]).read().strip()
if not txt:
    sys.exit(1)
try:
    json.loads(txt)                       # whole-doc JSON (the CLIs)
    sys.exit(0)
except Exception:
    pass
try:
    json.loads(txt.splitlines()[-1])      # last-line JSON (bench.py)
    sys.exit(0)
except Exception:
    sys.exit(1)
EOF
}

FAILED=0
stage() {  # stage NAME TIMEOUT_SECONDS CMD...
  local name=$1 tmo=$2; shift 2
  if [ -f "$MEAS/$name.json" ] && valid "$MEAS/$name.json"; then
    echo "== $name: already done (skip)"
    return 0
  fi
  echo "== $name: running  [$(date -u +%H:%M:%S)]"
  if timeout "$tmo" "$@" > "$MEAS/$name.json.tmp" 2> "$MEAS/$name.log" \
      && valid "$MEAS/$name.json.tmp"; then
    mv "$MEAS/$name.json.tmp" "$MEAS/$name.json"
    echo "== $name: OK  [$(date -u +%H:%M:%S)]"
  else
    echo "== $name: FAILED (see $MEAS/$name.log)  [$(date -u +%H:%M:%S)]"
    FAILED=1
  fi
}

ACC="python spec_acceptance_torch_cli.py --model $CKPT --eval-dir $EVAL
     --codec-bins $BINS $DEVICE_FLAG"

# 1. output-quality table (VERDICT r04 #1): every decode mode scored
#    against ground truth; spec modes bit-exact-checked in the same run
stage quality 10800 \
  python quality_torch_cli.py --model "$CKPT" --eval-dir "$EVAL" \
    --codec-bins "$BINS" --n 8 $DEVICE_FLAG

# 2. editing spec acceptance + speedup at 830M (VERDICT r04 #3)
stage edit_accept 10800 \
  $ACC --edit --taus 2 4 8 --lanes 8 --n 12 --fp8

# 3. spec-serving lane sweep (VERDICT r04 #4): greedy + stochastic
for L in 8 16 32; do
  stage "sweep_greedy_L$L" 7200 \
    $ACC --taus 8 --lanes "$L" --skip-single --skip-engine --fp8 --kv-fp8
done
for L in 8 16 32; do
  stage "sweep_stoch_L$L" 7200 \
    $ACC --taus 8 --lanes "$L" --skip-single --skip-engine --fp8 --kv-fp8 \
      --temperature 0.8 --spec-sampling stochastic \
      --spec-draft-temperature 0.1
done

# 4. training cost-attribution ladder (VERDICT r04 #5)
stage train_profile 7200 \
  python bench_torch.py --train-profile --train-attn chunked --train-remat attn \
    --train-batch 11 $DEVICE_FLAG

# 5. pipelined streaming loop A/B (VERDICT r04 #6)
stage stream_pipe 7200 python bench_torch.py --stream --burst 24 $DEVICE_FLAG
stage stream_nopipe 7200 python bench_torch.py --stream --burst 24 \
  --stream-no-pipeline $DEVICE_FLAG

# 6. engine tau=8 regression isolation (VERDICT r04 #7): short stream
#    (ramp-down included, the historical number) vs ~steady state
stage engine_short 7200 \
  $ACC --taus 4 8 --lanes 8 --skip-single --skip-serving \
    --engine-requests 2 --fp8
stage engine_steady 10800 \
  $ACC --taus 4 8 --lanes 8 --skip-single --skip-serving \
    --engine-requests 8 --fp8

echo "== all stages attempted; failed=$FAILED"
ls -la "$MEAS"
exit $FAILED
