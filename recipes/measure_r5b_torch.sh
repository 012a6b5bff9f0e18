#!/bin/bash
# The PyTorch port's twin of recipes/measure_r5b.sh (run after
# measure_all_torch.sh, in a quiet window: concurrent CPU work moves wall
# clocks).  Same stage machinery and resume guard as measure_all_torch.sh,
# the same checkpoint, DEVICE=cpu for the CPU.
#
#   setsid nohup bash recipes/measure_r5b_torch.sh \
#       > /tmp/measure_r5b_torch.log 2>&1 &
#
# Stages:
#   quality_min4       quality table on utterances >= 4 s (shorter items'
#                      ground-truth continuations make duration_ratio
#                      meaningless)
#   sweep2_greedy_L{8,16,32}  a second take of the greedy lane sweep
#   sweep2_greedy_L8_nokv     the same at 8 lanes WITHOUT --kv-fp8
set -u
cd "$(dirname "$0")/.."
WORK=${WORK:-${TMPDIR:-/tmp}/spec830_torch}
MEAS=${MEAS:-$WORK/measure_r5}
CKPT=${CKPT:-$WORK/exp/ckpt_latest}
EVAL=${EVAL:-$WORK/corpus/eval}
BINS=${BINS:-2048}
DEVICE_FLAG=${DEVICE:+--device $DEVICE}
mkdir -p "$MEAS"

valid() {
  python - "$1" <<'EOF'
import json, sys
txt = open(sys.argv[1]).read().strip()
if not txt:
    sys.exit(1)
try:
    json.loads(txt)
    sys.exit(0)
except Exception:
    pass
try:
    json.loads(txt.splitlines()[-1])
    sys.exit(0)
except Exception:
    sys.exit(1)
EOF
}

FAILED=0
stage() {
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

stage quality_min4 14400 \
  python quality_torch_cli.py --model "$CKPT" --eval-dir "$EVAL" \
    --codec-bins "$BINS" --n 8 --min-sec 4 $DEVICE_FLAG

for L in 8 16 32; do
  stage "sweep2_greedy_L$L" 7200 \
    $ACC --taus 8 --lanes "$L" --skip-single --skip-engine --fp8 --kv-fp8
done

stage sweep2_greedy_L8_nokv 7200 \
  $ACC --taus 8 --lanes 8 --skip-single --skip-engine --fp8

echo "== r5b: all stages attempted; failed=$FAILED"
exit $FAILED
