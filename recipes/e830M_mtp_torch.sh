#!/bin/bash
# The PyTorch port's twin of recipes/e830M_mtp.sh: graft
# multi-token-prediction heads onto a frozen 830M checkpoint and finetune
# ONLY the heads — the enabler for speculative decoding (tts_torch_cli
# --spec, serve_torch_cli --spec, engine spec mode).
#
# The base model's outputs are untouched (--mtp-only freezes everything
# except the MTP heads; the heads train as a detached auxiliary loss), so
# the grafted checkpoint decodes bit-identically without --spec and
# ~acceptance x faster with it.  3 heads -> tau up to 4 tokens/pass.
set -e
DATA=${1:?usage: e830M_mtp.sh <dataset_dir> <base_ckpt_dir> [exp_dir]}
BASE=${2:?usage: e830M_mtp.sh <dataset_dir> <base_ckpt_dir> [exp_dir]}
EXP=${3:-exp/e830M_mtp}
python train_torch_cli.py \
  --preset giga830M \
  --exp-dir "$EXP" \
  --dataset-dir "$DATA" \
  --init-from "$BASE" \
  --n-mtp 3 \
  --mtp-only \
  --optimizer AdamW \
  --lr 5e-4 \
  --num-steps 20000 \
  --max-num-tokens 20000 \
  --num-buckets 6 \
  --drop-long 1 \
  --val-every-n-steps 800 \
  --seed 1 --tb
