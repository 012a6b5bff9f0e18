#!/bin/bash
# The PyTorch port's twin of recipes/spec_acceptance.sh: measurement of
# REAL speculative-decoding acceptance: procedural corpus -> preprocess ->
# pretrain proc50M (+7 MTP head groups, so tau<=8) -> measure held-out
# tokens/pass + wall-clock speedup across single-stream, lockstep
# serving, and the continuous-batching engine
# (spec_acceptance_torch_cli.py), on a CUDA card unless DEVICE says
# otherwise.
#
# Overridables:
#   WORK=...         work dir           (default ${TMPDIR:-/tmp}/voicecraft_spec_accept_torch)
#   DEVICE=...       cuda (the CLIs' default) or cpu
#   STEPS=...        training steps     (default 6000)
#   PRESET=...       model preset       (default proc50M)
#   N_TRAIN/N_EVAL   corpus sizes       (default 1800/64)
#   TWO_STAGE=1      pretrain the base WITHOUT heads, then graft MTP heads
#                    onto the frozen checkpoint (--mtp-only): the graft
#                    trains ~117M head params of giga830M against the
#                    frozen base.
#   MTP_STEPS=...    graft steps in two-stage mode (default 2500)
set -e
cd "$(dirname "$0")/.."
WORK=${WORK:-${TMPDIR:-/tmp}/voicecraft_spec_accept_torch}
STEPS=${STEPS:-6000}
PRESET=${PRESET:-proc50M}
N_TRAIN=${N_TRAIN:-1800}
N_EVAL=${N_EVAL:-64}
MTP=${MTP:-7}
BINS=${BINS:-2048}
DEVICE_FLAG=${DEVICE:+--device $DEVICE}

mkdir -p "$WORK"
test -f "$WORK/corpus/train/train00000.wav" || \
  python recipes/make_spec_corpus.py "$WORK/corpus" --train "$N_TRAIN" --eval "$N_EVAL"

test -d "$WORK/data/manifest" || \
  python preprocess_torch_cli.py --audio-dir "$WORK/corpus/train" \
    --out-dir "$WORK/data" --random-init --codec-bins "$BINS" \
    --text-backend grapheme $DEVICE_FLAG

if [ -n "$TWO_STAGE" ]; then
  # stage A: base pretrain at full speed (no MTP heads, no mid-run saves)
  python train_torch_cli.py --preset "$PRESET" --exp-dir "$WORK/exp_base" \
    --dataset-dir "$WORK/data" --num-steps "$STEPS" \
    --max-num-tokens "${TOKENS:-8000}" --num-buckets 4 \
    --val-every-n-steps 100000 \
    --train-attn chunked --train-remat attn $DEVICE_FLAG
  # stage B: graft MTP heads onto the frozen base (reference analogue:
  # none — the reference has no speculative decoding)
  python train_torch_cli.py --preset "$PRESET" --exp-dir "$WORK/exp" \
    --dataset-dir "$WORK/data" --num-steps "${MTP_STEPS:-2500}" \
    --max-num-tokens "${TOKENS:-8000}" --num-buckets 4 \
    --n-mtp "$MTP" --mtp-only --init-from "$WORK/exp_base/ckpt_latest" \
    --val-every-n-steps 100000 \
    --train-attn chunked --train-remat attn $DEVICE_FLAG
else
  python train_torch_cli.py --preset "$PRESET" --exp-dir "$WORK/exp" \
    --dataset-dir "$WORK/data" --num-steps "$STEPS" \
    --max-num-tokens "${TOKENS:-12000}" --num-buckets 4 \
    --n-mtp "$MTP" --val-every-n-steps 1000 $DEVICE_FLAG
fi

python spec_acceptance_torch_cli.py --model "$WORK/exp/ckpt_latest" \
  --eval-dir "$WORK/corpus/eval" --codec-bins "$BINS" \
  --taus 2 4 8 --n "${N_SINGLE:-12}" --lanes "${LANES:-8}" $DEVICE_FLAG \
  | tee "$WORK/acceptance.json"
