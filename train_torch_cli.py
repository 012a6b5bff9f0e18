#!/usr/bin/env python
"""Training on the PyTorch port (voicecraft_tpu_torch), on one CUDA card
by default; the counterpart of train_cli.py.

  python train_torch_cli.py --exp-dir exp/e830M --dataset-dir data/gigaspeech \\
      --preset giga830M --optimizer ScaledAdam --lr 0.05 \\
      --codebook-weight 5 1 0.5 0.1 --train-attn chunked --train-remat attn

On the CPU at test size:

  python train_torch_cli.py --exp-dir /tmp/exp --dataset-dir /tmp/data \\
      --preset tiny_test --device cpu --num-steps 4

On several cards, one process per card under torchrun, over a
(world / n_model) x n_model mesh (data x tensor parallel, ZeRO-1 unless
--no-zero1):

  python -m torch.distributed.run --nproc-per-node 4 train_torch_cli.py \
      --distributed --n-model 2 --exp-dir exp/e830M ...

The run writes <exp-dir>/ckpt_latest (and ckpt_best) with meta_*.json and
vocab.txt beside them; tts_torch_cli.py --model <exp-dir>/ckpt_latest
serves it.  Mid-run, a second call with the same --exp-dir resumes.
"""

import argparse
import dataclasses
import logging
import os


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="giga830M")
    ap.add_argument("--exp-dir", required=True)
    ap.add_argument("--dataset-dir", required=True)
    ap.add_argument("--optimizer", default="ScaledAdam",
                    help="ScaledAdam (with the Eden schedule); any other "
                         "name trains with AdamW")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--num-steps", type=int, default=50000)
    ap.add_argument("--max-num-tokens", type=int, default=100000)
    ap.add_argument("--num-buckets", type=int, default=6)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--codebook-weight", type=float, nargs="*", default=None,
                    help="e.g. 5 1 0.5 0.1")
    ap.add_argument("--drop-long", type=int, default=1)
    ap.add_argument("--val-every-n-steps", type=int, default=800)
    ap.add_argument("--train-attn", default=None, choices=["dense", "chunked"],
                    help="training attention: 'dense' (the segment bias, "
                         "attention-prob dropout) or 'chunked' (query "
                         "chunks, nothing of S x S kept for the backward)")
    ap.add_argument("--train-remat", default=None,
                    choices=["full", "dots", "attn", "attn_ffn1", "none"],
                    help="the layer stack's recompute policy")
    ap.add_argument("--n-mtp", type=int, default=0,
                    help="train N multi-token-prediction head groups")
    ap.add_argument("--init-from", default=None,
                    help="start from a checkpoint (.pth, HF snapshot or a "
                         "trainer checkpoint dir); MTP heads it lacks are "
                         "freshly initialised")
    ap.add_argument("--mtp-only", action="store_true",
                    help="train only the MTP heads (the base stays frozen)")
    ap.add_argument("--tb", action="store_true",
                    help="write tensorboard scalars to --exp-dir (needs the "
                         "tensorboard package)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no automatic "
                         "fallback to the CPU")
    ap.add_argument("--distributed", action="store_true",
                    help="one process per card under torchrun (its RANK, "
                         "WORLD_SIZE and LOCAL_RANK): NCCL on cuda:"
                         "LOCAL_RANK, gloo with --device cpu")
    ap.add_argument("--n-model", type=int, default=1,
                    help="tensor-parallel width: the mesh is (world // "
                         "n_model) x n_model (with --distributed)")
    ap.add_argument("--no-zero1", action="store_true",
                    help="keep the optimizer's moments replicated over the "
                         "mesh's data axis")
    return ap


def init_distributed(ap: argparse.ArgumentParser, args):
    """The process group and mesh of a --distributed run (None without
    it): torchrun's RANK / WORLD_SIZE / LOCAL_RANK, the card set before any
    other CUDA call."""
    if not args.distributed:
        if args.n_model != 1 or args.no_zero1:
            ap.error("--n-model and --no-zero1 shape a mesh: they need "
                     "--distributed (under torchrun)")
        return None
    env = [os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")]
    if None in env:
        ap.error("--distributed reads RANK, WORLD_SIZE and LOCAL_RANK: run "
                 "it under torchrun (python -m torch.distributed.run)")
    rank, world, local = (int(v) for v in env)
    if args.n_model < 1 or world % args.n_model:
        ap.error(f"--n-model {args.n_model} does not divide the world of "
                 f"{world} processes")
    import torch
    import torch.distributed as dist
    from voicecraft_tpu_torch.parallel.mesh import make_mesh
    if args.device == "cpu":
        dist.init_process_group("gloo", rank=rank, world_size=world)
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            ap.error("--device cuda, but no CUDA device is available")
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
        dist.init_process_group("nccl", rank=rank, world_size=world)
    mesh = make_mesh(world // args.n_model, args.n_model, device)
    logging.info("mesh: data=%d model=%d", mesh.n_data, mesh.n_model)
    return mesh


def tensorboard_writer(exp_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise SystemExit("--tb needs the tensorboard package, which is not "
                         f"installed ({e}); run without --tb") from e
    return SummaryWriter(exp_dir)


def main():
    ap = build_parser()
    args = ap.parse_args()
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    mesh = init_distributed(ap, args)

    from voicecraft_tpu_torch.config import PRESETS, TrainConfig
    from voicecraft_tpu_torch.training.trainer import Trainer

    mcfg = PRESETS[args.preset]()
    if args.codebook_weight:
        mcfg = dataclasses.replace(mcfg,
                                   codebook_weight=tuple(args.codebook_weight))
    if args.n_mtp:
        mcfg = dataclasses.replace(mcfg, n_mtp=args.n_mtp)
    if args.train_attn:
        mcfg = dataclasses.replace(mcfg, train_attn=args.train_attn)
    if args.train_remat:
        mcfg = dataclasses.replace(mcfg, train_remat=args.train_remat)
    tcfg = TrainConfig(
        exp_dir=args.exp_dir, dataset_dir=args.dataset_dir,
        optimizer_name=args.optimizer, lr=args.lr, num_steps=args.num_steps,
        max_num_tokens=args.max_num_tokens, num_buckets=args.num_buckets,
        seed=args.seed, drop_long=args.drop_long,
        val_every_n_steps=args.val_every_n_steps, zero1=not args.no_zero1)
    primary = mesh is None or mesh.rank == 0
    tb = tensorboard_writer(args.exp_dir) if args.tb and primary else None
    try:
        Trainer(mcfg, tcfg, mesh=mesh, tb_writer=tb,
                init_from=args.init_from, train_mtp_only=args.mtp_only,
                device=args.device).train()
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
