#!/usr/bin/env python
"""Teacher-forced evaluation on the PyTorch port: loss and top-10 accuracy
of a checkpoint over a manifest split, on a CUDA card by default; the
counterpart of eval_cli.py.

  python eval_torch_cli.py --ckpt exp/ckpt_best --dataset-dir data/ \\
      --split validation
"""

import argparse
import logging

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True,
                    help="trainer checkpoint dir, .pth bundle, HF snapshot "
                         "dir, or preset name with --random-init")
    ap.add_argument("--dataset-dir", required=True)
    ap.add_argument("--split", default="validation")
    ap.add_argument("--max-num-tokens", type=int, default=20000)
    ap.add_argument("--max-batches", type=int, default=200)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--random-init", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no automatic "
                         "fallback to the CPU")
    return ap


def evaluate(model, ds, batcher, seed: int, max_batches: int, device) -> dict:
    """Sums of loss, top10acc and target tokens, and the utterance count,
    over the first ``max_batches`` batches of epoch 0."""
    import torch
    from voicecraft_tpu_torch.data.manifest import collate_train
    from voicecraft_tpu_torch.models.voicecraft import forward_train
    tot = {"loss": 0.0, "top10acc": 0.0, "ntok": 0.0, "utts": 0}
    with torch.no_grad():
        for bi, idxs in enumerate(batcher.epoch_batches(0)[:max_batches]):
            batch = collate_train(ds, idxs, np.random.default_rng((seed, bi)),
                                  device=device)
            if batch is None:
                continue
            out = forward_train(model, batch, seed=None, remat=False)
            tot["loss"] += float(out["loss"])
            tot["top10acc"] += float(out["top10acc"])
            tot["ntok"] += float(out["effective_ntoken"])
            tot["utts"] += batch.x.shape[0]
    return tot


def main():
    args = build_parser().parse_args()
    logging.basicConfig(level=logging.INFO)
    from voicecraft_tpu_torch.config import TrainConfig
    from voicecraft_tpu_torch.data.manifest import DynamicBatcher, ManifestDataset
    from voicecraft_tpu_torch.inference.loader import load_model

    cfg, model, _ = load_model(args.ckpt, args.random_init, device=args.device)
    tcfg = TrainConfig(dataset_dir=args.dataset_dir,
                       max_num_tokens=args.max_num_tokens, seed=args.seed)
    ds = ManifestDataset(cfg, tcfg, args.split)
    batcher = DynamicBatcher(ds.lengths, args.max_num_tokens, seed=args.seed)
    tot = evaluate(model, ds, batcher, args.seed, args.max_batches, args.device)
    ntok = max(tot["ntok"], 1.0)
    logging.info("%s: %d utts, %.0f tokens | loss/token %.4f | top10acc %.4f",
                 args.split, tot["utts"], tot["ntok"], tot["loss"] / ntok,
                 tot["top10acc"] / ntok)


if __name__ == "__main__":
    main()
