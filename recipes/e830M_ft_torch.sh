#!/bin/bash
# 830M finetuning recipe on the PyTorch port (recipes/e830M_ft.sh, the
# reference z_scripts/e830M_ft.sh, on train_torch_cli.py): AdamW lr 1e-5,
# 20k tokens/device, codebook weights [3,1,1,1].
set -e
DATA=${1:?usage: e830M_ft.sh <dataset_dir> [exp_dir]}
EXP=${2:-exp/e830M_ft}
python train_torch_cli.py \
  --preset giga830M \
  --exp-dir "$EXP" \
  --dataset-dir "$DATA" \
  --optimizer AdamW \
  --lr 1e-5 \
  --num-steps 500000 \
  --max-num-tokens 20000 \
  --num-buckets 6 \
  --drop-long 1 \
  --codebook-weight 3 1 1 1 \
  --val-every-n-steps 800 \
  --seed 1 --tb
