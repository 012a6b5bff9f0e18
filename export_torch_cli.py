#!/usr/bin/env python
"""Export a checkpoint of the PyTorch port to the reference's formats; the
counterpart of export_cli.py.

  python export_torch_cli.py --ckpt exp/ckpt_best --out giga.pth --format pth
  python export_torch_cli.py --ckpt exp/ckpt_best --out giga_hf --format hf

``--ckpt`` is a trainer checkpoint (``<exp>/ckpt_<tag>``), a ``.pth``
bundle, an HF snapshot directory, or a preset with ``--random-init``.
``--format pth`` writes a ``best_bundle.pth``-style bundle ({"model":
state_dict, "config": Namespace, "phn2num": ...}); ``--format hf`` writes
an HF-hub snapshot directory (config.json, model.safetensors and
vocab.txt), which needs the ``safetensors`` package.  Both hold the
reference's layout, which maps LayerNorm + relu models only; the MTP heads
are dropped.  A checkpoint's stored weights are exported as they are (f32
master weights of a trainer checkpoint); ``--device`` is where a preset's
random weights are drawn (cuda by default).
"""

import argparse
import dataclasses
import json
import logging
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True,
                    help="trainer checkpoint dir, .pth bundle, HF snapshot "
                         "dir, or preset name with --random-init")
    ap.add_argument("--out", required=True)
    ap.add_argument("--format", choices=["pth", "hf"], default="pth")
    ap.add_argument("--random-init", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where a preset's random "
                         "weights are drawn; no automatic fallback")
    return ap


def export(ckpt: str, out: str, fmt: str = "pth", random_init: bool = False,
           device: str = "cuda") -> int:
    """Writes the export; returns the number of tensors."""
    import torch
    from voicecraft_tpu_torch.config import PRESETS
    from voicecraft_tpu_torch.inference.loader import load_model, load_state
    from voicecraft_tpu_torch.utils.convert import to_reference_state_dict

    if fmt == "hf":
        try:
            from safetensors.torch import save_file
        except ImportError as e:
            raise SystemExit("--format hf needs the safetensors package "
                             f"({e}); --format pth needs nothing more") from e
    if ckpt in PRESETS:
        cfg, model, phn2num = load_model(ckpt, random_init, device=device)
        state = model.state_dict()
    else:
        cfg, state, phn2num = load_state(ckpt)
    sd = to_reference_state_dict(state, cfg)
    cfg = dataclasses.replace(cfg, n_mtp=0)     # the MTP heads are dropped
    if fmt == "pth":
        torch.save({"model": sd,
                    "config": argparse.Namespace(**dataclasses.asdict(cfg)),
                    "phn2num": phn2num}, out)
        logging.info("wrote torch bundle %s (%d tensors)", out, len(sd))
        return len(sd)
    os.makedirs(out, exist_ok=True)
    save_file(sd, os.path.join(out, "model.safetensors"))
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    if phn2num:
        with open(os.path.join(out, "vocab.txt"), "w") as f:
            for p, i in sorted(phn2num.items(), key=lambda kv: kv[1]):
                f.write(f"{i} {p}\n")
    logging.info("wrote HF snapshot %s (%d tensors)", out, len(sd))
    return len(sd)


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    export(args.ckpt, args.out, args.format, args.random_init, args.device)


if __name__ == "__main__":
    sys.exit(main())
