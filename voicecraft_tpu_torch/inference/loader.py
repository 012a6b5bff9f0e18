"""Model and codec loading for the port's CLIs and trainer (PyTorch port of
voicecraft_tpu/inference/loader.py).

Model sources: a named preset with random weights (``random_init``, with
config overrides), a reference ``*.pth`` bundle or a local HF-hub snapshot
directory (config.json + model.safetensors or pytorch_model.bin, optional
vocab.txt), both in the reference's layout and so LayerNorm + relu only,
or a checkpoint directory of the port's trainer (``<exp>/ckpt_<tag>``
beside ``<exp>/meta_<tag>.json`` and ``<exp>/vocab.txt``), which carries
any norm family and FFN activation.  Codec sources: an
audiocraft ``.th`` checkpoint or random weights.  Nothing is downloaded.
The compute dtype is the config's (bf16 for the presets) on CUDA, and f32
on the CPU; a trained checkpoint's f32 weights load into a compute-dtype
model.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import torch

from ..config import PRESETS, ModelConfig

from ..data.manifest import load_vocab
from ..models.encodec import EncodecConfig, Encodec
from ..models.voicecraft import VoiceCraft
from ..utils.convert import from_reference_state_dict, load_reference_bundle
from ..utils.convert_encodec import load_audiocraft_checkpoint


def _device_dtype_fix(cfg: ModelConfig, device: torch.device) -> ModelConfig:
    if device.type == "cpu" and cfg.compute_dtype == "bfloat16":
        return dataclasses.replace(cfg, compute_dtype="float32")
    return cfg


# the model's file in a trainer checkpoint directory (training/trainer.py;
# the optimizer's and the step-seed generator's state are in another)
CKPT_MODEL = "model.pt"


def _trainer_meta(ckpt_dir: str) -> str:
    """<exp>/ckpt_<tag> -> <exp>/meta_<tag>.json."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    tag = os.path.basename(ckpt_dir).replace("ckpt_", "", 1)
    return os.path.join(os.path.dirname(ckpt_dir), f"meta_{tag}.json")


def load_state(path: str) -> Tuple[ModelConfig, dict, Optional[Dict[str, int]]]:
    """(cfg, the port's VoiceCraft state_dict as stored, phn2num or None)
    of a checkpoint: a .pth bundle, an HF snapshot directory or a trainer
    checkpoint directory.  The config's compute dtype is as stored."""
    if path.endswith(".pth"):
        return load_reference_bundle(path)
    if os.path.isfile(os.path.join(path, "config.json")):
        with open(os.path.join(path, "config.json")) as f:
            cfg = ModelConfig.from_dict(json.load(f))
        st = os.path.join(path, "model.safetensors")
        if os.path.exists(st):
            from safetensors.torch import load_file
            sd = load_file(st)
        else:
            sd = torch.load(os.path.join(path, "pytorch_model.bin"),
                            map_location="cpu", weights_only=True)
        vfn = os.path.join(path, "vocab.txt")
        phn2num = load_vocab(vfn) if os.path.exists(vfn) else None
        return cfg, from_reference_state_dict(sd, cfg), phn2num
    if os.path.isfile(os.path.join(path, CKPT_MODEL)):
        with open(_trainer_meta(path)) as f:
            cfg = ModelConfig.from_dict(json.load(f)["model_config"])
        state = torch.load(os.path.join(path, CKPT_MODEL), map_location="cpu",
                           weights_only=True)
        vfn = os.path.join(os.path.dirname(os.path.abspath(path)), "vocab.txt")
        phn2num = load_vocab(vfn) if os.path.exists(vfn) else None
        return cfg, state, phn2num
    raise FileNotFoundError(
        f"{path!r} is neither a preset ({', '.join(PRESETS)}), a .pth "
        "bundle, a local snapshot directory with config.json nor a trainer "
        f"checkpoint directory with {CKPT_MODEL}")


def load_model(path_or_preset: str, random_init: bool = False, seed: int = 0,
               device="cuda", overrides: Optional[dict] = None
               ) -> Tuple[ModelConfig, VoiceCraft, Optional[Dict[str, int]]]:
    """Returns (cfg, model on ``device`` in the compute dtype, phn2num or
    None).  A checkpoint's config carries its norm family and FFN
    activation; a preset takes them (or any other field) from
    ``overrides``, e.g. {"norm": "basicnorm", "ffn_activation":
    "doubleswish"}.  Over a mesh every rank loads the whole model (a
    preset from the same seed) and keeps its shard
    (parallel.mesh.shard_params); checkpoints hold the whole state."""
    device = torch.device(device)
    if path_or_preset in PRESETS:
        if not random_init:
            raise ValueError("presets carry no weights: pass random_init "
                             "(--random-init)")
        cfg = _device_dtype_fix(dataclasses.replace(
            PRESETS[path_or_preset](), **(overrides or {})), device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return cfg, VoiceCraft(cfg, device).init_weights(gen).eval(), None
    if overrides:
        raise ValueError("overrides apply to a preset, not to a checkpoint "
                         f"({path_or_preset!r})")
    cfg, state, phn2num = load_state(path_or_preset)
    cfg = _device_dtype_fix(cfg, device)
    model = VoiceCraft(cfg, device)
    model.load_state_dict(state)
    return cfg, model.eval(), phn2num


def load_codec(path: Optional[str], random_init: bool = False, seed: int = 0,
               device="cuda", codebook_size: int = 2048
               ) -> Tuple[EncodecConfig, Encodec]:
    """An audiocraft ``.th`` codec checkpoint at ``path``; without a path,
    the default 4-codebook 16 kHz EnCodec with random weights and
    ``codebook_size`` entries per codebook (give the model's
    audio_vocab_size, so that its codes embed)."""
    device = torch.device(device)
    if path is not None:
        cfg, state = load_audiocraft_checkpoint(path)
        codec = Encodec(cfg, device)
        codec.load_state_dict(state)
        return cfg, codec.eval()
    if not random_init:
        raise ValueError("a codec path is required unless random_init "
                         "(--random-init)")
    cfg = EncodecConfig(codebook_size=codebook_size)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, Encodec(cfg, device).init_weights(gen).eval()
