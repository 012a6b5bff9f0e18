#!/bin/bash
# The PyTorch port's twin of recipes/measure_r5c.sh (run after
# measure_r5b_torch.sh, in a quiet window).  Same stage machinery and
# resume guard as measure_all_torch.sh, the same checkpoint, DEVICE=cpu
# for the CPU.
#
#   setsid nohup bash recipes/measure_r5c_torch.sh \
#       > /tmp/measure_r5c_torch.log 2>&1 &
#
# Stages:
#   train_profile2    the training cost ladder again
#   stream_pipe2 / stream_nopipe2   the pipelined streaming A/B again, both
#                     in one window
#   sweep2_stoch_L{8,16,32}   a second take of the stochastic lane sweep
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

stage train_profile2 7200 \
  python bench_torch.py --train-profile --train-attn chunked --train-remat attn \
    --train-batch 11 $DEVICE_FLAG

stage stream_pipe2 7200 python bench_torch.py --stream --burst 24 $DEVICE_FLAG
stage stream_nopipe2 7200 python bench_torch.py --stream --burst 24 \
  --stream-no-pipeline $DEVICE_FLAG

for L in 8 16 32; do
  stage "sweep2_stoch_L$L" 7200 \
    $ACC --taus 8 --lanes "$L" --skip-single --skip-engine --fp8 --kv-fp8 \
      --temperature 0.8 --spec-sampling stochastic \
      --spec-draft-temperature 0.1
done

echo "== r5c: all stages attempted; failed=$FAILED"
exit $FAILED
