"""Audiocraft EnCodec checkpoints into the port's codec (PyTorch port of
voicecraft_tpu/utils/convert_encodec.py).

The reference loads its codec (``encodec_4cb2048_giga.th``) through
audiocraft's ``CompressionSolver.model_from_checkpoint``.  This reads that
torch checkpoint directly: it folds weight norm (g * v / ||v||, in f32
numpy as the JAX package does, so both packages hold the same bits), maps
the SEANet sequential indices onto ``models/encodec.py:Encodec``'s module
names (the conv layouts are PyTorch's on both sides), and takes the
architecture from the embedded ``xp.cfg`` when there is one.

Weight-norm keys may be old-style (``weight_g`` / ``weight_v``) or
parametrize-style (``parametrizations.weight.original0/1``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..models.encodec import EncodecConfig

State = Dict[str, torch.Tensor]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def _fold_weight_norm(sd: dict, prefix: str) -> np.ndarray:
    """The conv weight at ``prefix`` (e.g. 'encoder.model.0.conv.conv')."""
    if prefix + ".weight" in sd:
        return _np(sd[prefix + ".weight"])
    if prefix + ".weight_g" in sd:
        g = _np(sd[prefix + ".weight_g"])
        v = _np(sd[prefix + ".weight_v"])
    elif prefix + ".parametrizations.weight.original0" in sd:
        g = _np(sd[prefix + ".parametrizations.weight.original0"])
        v = _np(sd[prefix + ".parametrizations.weight.original1"])
    else:
        raise KeyError(prefix)
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def config_from_xp_cfg(xp_cfg) -> EncodecConfig:
    """EncodecConfig from an audiocraft checkpoint's ``xp.cfg`` (a dict or
    an attribute tree); missing entries take the giga codec's values."""
    def get(path, default):
        node = xp_cfg
        for part in path.split("."):
            if node is None:
                return default
            node = node.get(part) if hasattr(node, "get") else getattr(node, part, None)
        return default if node is None else node

    return EncodecConfig(
        channels=int(get("channels", 1)),
        dimension=int(get("seanet.dimension", 128)),
        n_filters=int(get("seanet.n_filters", 64)),
        ratios=tuple(get("seanet.ratios", [8, 5, 4, 2])),
        n_residual_layers=int(get("seanet.n_residual_layers", 1)),
        lstm=int(get("seanet.lstm", 2)),
        kernel_size=int(get("seanet.kernel_size", 7)),
        last_kernel_size=int(get("seanet.last_kernel_size", 7)),
        residual_kernel_size=int(get("seanet.residual_kernel_size", 3)),
        dilation_base=int(get("seanet.dilation_base", 2)),
        compress=int(get("seanet.compress", 2)),
        causal=bool(get("seanet.causal", True)),
        pad_mode=str(get("seanet.pad_mode", "reflect")),
        true_skip=bool(get("seanet.true_skip", True)),
        n_q=int(get("rvq.n_q", 4)),
        codebook_size=int(get("rvq.bins", 2048)),
        sample_rate=int(get("sample_rate", 16000)),
    )


def from_audiocraft_state_dict(sd: dict, cfg: EncodecConfig) -> State:
    """An audiocraft EncodecModel state_dict -> the port's Encodec state."""
    st: State = {}
    n_stages = len(cfg.ratios)
    R = cfg.n_residual_layers
    per_stage = R + 2                       # blocks + ELU + conv

    def conv(ours: str, theirs: str) -> None:
        st[ours + ".weight"] = torch.from_numpy(_fold_weight_norm(sd, theirs))
        st[ours + ".bias"] = torch.from_numpy(_np(sd[theirs + ".bias"]))

    def resnet(ours: str, theirs: str) -> None:
        # SEANetResnetBlock.block = [act, conv, act, conv]: indices 1, 3
        conv(ours + ".conv1", theirs + ".block.1.conv.conv")
        conv(ours + ".conv2", theirs + ".block.3.conv.conv")
        if not cfg.true_skip:
            conv(ours + ".shortcut", theirs + ".shortcut.conv.conv")

    def lstm(ours: str, theirs: str) -> None:
        for i in range(cfg.lstm):
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                st[f"{ours}.lstm.{name}_l{i}"] = torch.from_numpy(
                    _np(sd[f"{theirs}.{name}_l{i}"]))

    # ---- encoder: init conv, stages, LSTM, ELU, final conv ----
    conv("encoder.init", "encoder.model.0.conv.conv")
    for s in range(n_stages):
        base = 1 + s * per_stage
        for j in range(R):
            resnet(f"encoder.stages.{s}.blocks.{j}", f"encoder.model.{base + j}")
        conv(f"encoder.stages.{s}.down", f"encoder.model.{base + R + 1}.conv.conv")
    lstm_idx = 1 + n_stages * per_stage
    if cfg.lstm:
        lstm("encoder.lstm", f"encoder.model.{lstm_idx}.lstm")
    conv("encoder.final", f"encoder.model.{lstm_idx + 2}.conv.conv")

    # ---- decoder: init conv, LSTM, stages, ELU, final conv ----
    conv("decoder.init", "decoder.model.0.conv.conv")
    if cfg.lstm:
        lstm("decoder.lstm", "decoder.model.1.lstm")
    for s in range(n_stages):
        base = 2 + s * per_stage
        conv(f"decoder.stages.{s}.up", f"decoder.model.{base + 1}.convtr.convtr")
        for j in range(R):
            resnet(f"decoder.stages.{s}.blocks.{j}",
                   f"decoder.model.{base + 2 + j}")
    conv("decoder.final", f"decoder.model.{2 + n_stages * per_stage + 1}.conv.conv")

    st["codebooks"] = torch.from_numpy(np.stack(
        [_np(sd[f"quantizer.vq.layers.{q}._codebook.embed"])
         for q in range(cfg.n_q)], axis=0))
    return st


def load_audiocraft_checkpoint(path: str) -> Tuple[EncodecConfig, State]:
    """An audiocraft compression checkpoint (.th) -> (cfg, state).
    Unpickles with ``weights_only=False`` (the checkpoint embeds its
    ``xp.cfg``): load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    xp_cfg = ckpt.get("xp.cfg")
    sd = ckpt.get("best_state", ckpt)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    cfg = config_from_xp_cfg(xp_cfg) if xp_cfg is not None else EncodecConfig()
    return cfg, from_audiocraft_state_dict(sd, cfg)
