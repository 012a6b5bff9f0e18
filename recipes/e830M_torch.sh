#!/bin/bash
# 830M pretraining recipe on the PyTorch port — recipes/e830M.sh (the
# reference z_scripts/e830M.sh) mapped onto train_torch_cli.py, on a CUDA
# card.  Reference: 4 GPUs, ScaledAdam lr 0.05, 50k steps, dynamic
# batching 100k tokens/device, grad-accum 26, codebook weights
# [5,1,0.5,0.1].  Over several cards, run train_torch_cli.py under
# `python -m torch.distributed.run --nproc-per-node N` with --distributed
# (--n-model 2 for 2-way TP).
set -e
DATA=${1:?usage: e830M.sh <dataset_dir> [exp_dir]}
EXP=${2:-exp/e830M}
python train_torch_cli.py \
  --preset giga830M \
  --exp-dir "$EXP" \
  --dataset-dir "$DATA" \
  --optimizer ScaledAdam \
  --lr 0.05 \
  --num-steps 50000 \
  --max-num-tokens 100000 \
  --num-buckets 6 \
  --drop-long 1 \
  --codebook-weight 5 1 0.5 0.1 \
  --val-every-n-steps 800 \
  --train-attn chunked \
  --train-remat attn \
  --seed 1 --tb
# --train-attn chunked: query chunks under checkpoint, the memory of a
# 100k-token batch (PERF.md); drop it for the dense reference numerics
# --train-remat attn: save the pre-out-proj attention result per layer so
# the backward skips the second attention forward
# --tb needs tensorboard (train_torch_cli.py stops with an error without it)
