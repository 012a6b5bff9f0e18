"""Model and codec loading for the port's CLI (PyTorch port of
voicecraft_tpu/inference/loader.py).

Model sources: a named preset with random weights (``random_init``), a
reference ``*.pth`` bundle, or a local HF-hub snapshot directory
(config.json + model.safetensors or pytorch_model.bin, optional
vocab.txt).  Codec sources: an audiocraft ``.th`` checkpoint or random
weights.  Nothing is downloaded.  The compute dtype is the config's (bf16
for the presets) on CUDA, and f32 on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import torch

from ..config import PRESETS, ModelConfig

from ..models.encodec import EncodecConfig, Encodec
from ..models.voicecraft import VoiceCraft
from ..utils.convert import from_reference_state_dict, load_reference_bundle
from ..utils.convert_encodec import load_audiocraft_checkpoint


def _device_dtype_fix(cfg: ModelConfig, device: torch.device) -> ModelConfig:
    if device.type == "cpu" and cfg.compute_dtype == "bfloat16":
        return dataclasses.replace(cfg, compute_dtype="float32")
    return cfg


def _load_vocab(path: str) -> Dict[str, int]:
    """vocab.txt lines are '<id> <phn>'."""
    phn2num = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) == 2:
                phn2num[parts[1]] = int(parts[0])
    return phn2num


def _build(cfg: ModelConfig, state: dict, device: torch.device) -> VoiceCraft:
    model = VoiceCraft(cfg, device)
    model.load_state_dict(state)
    return model.eval()


def load_model(path_or_preset: str, random_init: bool = False, seed: int = 0,
               device="cuda") -> Tuple[ModelConfig, VoiceCraft,
                                       Optional[Dict[str, int]]]:
    """Returns (cfg, model on ``device``, phn2num or None)."""
    device = torch.device(device)
    if path_or_preset in PRESETS:
        if not random_init:
            raise ValueError("presets carry no weights: pass random_init "
                             "(--random-init)")
        cfg = _device_dtype_fix(PRESETS[path_or_preset](), device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return cfg, VoiceCraft(cfg, device).init_weights(gen).eval(), None
    if path_or_preset.endswith(".pth"):
        cfg, state, phn2num = load_reference_bundle(path_or_preset)
        cfg = _device_dtype_fix(cfg, device)
        return cfg, _build(cfg, state, device), phn2num
    if os.path.isfile(os.path.join(path_or_preset, "config.json")):
        with open(os.path.join(path_or_preset, "config.json")) as f:
            cfg = _device_dtype_fix(ModelConfig.from_dict(json.load(f)), device)
        st = os.path.join(path_or_preset, "model.safetensors")
        if os.path.exists(st):
            from safetensors.torch import load_file
            sd = load_file(st)
        else:
            sd = torch.load(os.path.join(path_or_preset, "pytorch_model.bin"),
                            map_location="cpu", weights_only=True)
        vfn = os.path.join(path_or_preset, "vocab.txt")
        phn2num = _load_vocab(vfn) if os.path.exists(vfn) else None
        return cfg, _build(cfg, from_reference_state_dict(sd, cfg), device), phn2num
    raise FileNotFoundError(
        f"{path_or_preset!r} is neither a preset ({', '.join(PRESETS)}), a "
        ".pth bundle nor a local snapshot directory with config.json")


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
