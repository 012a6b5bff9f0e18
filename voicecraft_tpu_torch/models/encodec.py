"""EnCodec neural audio codec (PyTorch port of voicecraft_tpu/models/encodec.py,
the non-streaming codec): SEANet conv encoder/decoder with a 2-layer LSTM,
and residual vector quantization.

Activations inside are [B, C, T] (PyTorch's conv layout); the public
``encode`` takes a wav [B, T] and returns codes [B, n_q, T'], and
``decode`` the reverse, as the JAX package does.  The convs use the
streamable padding of audiocraft (reflect padding guarded for short inputs,
extra right padding so the last window is full).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class EncodecConfig:
    channels: int = 1
    dimension: int = 128
    n_filters: int = 64
    ratios: Tuple[int, ...] = (8, 5, 4, 2)   # decoder order; encoder reverses
    n_residual_layers: int = 1
    lstm: int = 2
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_base: int = 2
    compress: int = 2
    causal: bool = True
    pad_mode: str = "reflect"     # non-causal symmetric padding mode
    true_skip: bool = True
    n_q: int = 4
    codebook_size: int = 2048
    sample_rate: int = 16000

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.ratios))

    @property
    def frame_rate(self) -> float:
        return self.sample_rate / self.hop_length


def _extra_padding(length: int, kernel_eff: int, stride: int,
                   padding_total: int) -> int:
    """Right padding so the last window is full."""
    n_frames = (length - kernel_eff + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (kernel_eff - padding_total)
    return max(ideal - length, 0)


def _pad1d(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Pad the time axis of [B, C, T].  Reflect pads zero-extend first when
    T <= max_pad, then trim, as audiocraft's pad1d does."""
    if mode != "reflect":
        return F.pad(x, (left, right))
    T = x.shape[-1]
    max_pad = max(left, right)
    if T <= max_pad:
        x = F.pad(x, (0, max_pad - T + 1))
    out = F.pad(x, (left, right), mode="reflect")
    if T <= max_pad:
        out = out[..., :left + T + right]
    return out


def _param(*shape: int, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device), requires_grad=False)


class SConv1d(nn.Module):
    """Streamable Conv1d; weight [Cout, Cin, K]."""

    def __init__(self, cin: int, cout: int, k: int, cfg: EncodecConfig,
                 device, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.weight = _param(cout, cin, k, device=device)
        self.bias = _param(cout, device=device)
        self.stride, self.dilation = stride, dilation
        self.causal, self.pad_mode = cfg.causal, cfg.pad_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        K = self.weight.shape[-1]
        kernel_eff = (K - 1) * self.dilation + 1
        padding_total = kernel_eff - self.stride
        extra = _extra_padding(x.shape[-1], kernel_eff, self.stride,
                               padding_total)
        if self.causal:
            x = _pad1d(x, padding_total, extra, self.pad_mode)
        else:
            right = padding_total // 2
            x = _pad1d(x, padding_total - right, right + extra, self.pad_mode)
        return F.conv1d(x, self.weight, self.bias, stride=self.stride,
                        dilation=self.dilation)


class SConvTranspose1d(nn.Module):
    """Streamable ConvTranspose1d (trim_right_ratio 1); weight [Cin, Cout, K]."""

    def __init__(self, cin: int, cout: int, k: int, cfg: EncodecConfig,
                 device, stride: int):
        super().__init__()
        self.weight = _param(cin, cout, k, device=device)
        self.bias = _param(cout, device=device)
        self.stride, self.causal = stride, cfg.causal

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x, self.weight, self.bias, stride=self.stride)
        padding_total = self.weight.shape[-1] - self.stride
        right = padding_total if self.causal else padding_total // 2
        left = padding_total - right
        return y[..., left:y.shape[-1] - right]


class SLSTM(nn.Module):
    """Multi-layer LSTM over the time axis plus the SEANet skip."""

    def __init__(self, dim: int, num_layers: int, device):
        super().__init__()
        # built on the meta device so construction draws no random numbers;
        # init_weights fills the parameters
        self.lstm = nn.LSTM(dim, dim, num_layers, batch_first=True,
                            device="meta").to_empty(device=device)
        for p in self.lstm.parameters():
            p.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, _ = self.lstm(x.transpose(1, 2))
        return y.transpose(1, 2) + x


class ResnetBlock(nn.Module):
    """[ELU, conv k3 dil d (C -> C/compress), ELU, conv k1 (-> C)] + skip."""

    def __init__(self, dim: int, cfg: EncodecConfig, dilation: int, device):
        super().__init__()
        hidden = dim // cfg.compress
        self.conv1 = SConv1d(dim, hidden, cfg.residual_kernel_size, cfg, device,
                             dilation=dilation)
        self.conv2 = SConv1d(hidden, dim, 1, cfg, device)
        self.shortcut = (None if cfg.true_skip
                         else SConv1d(dim, dim, 1, cfg, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(F.elu(self.conv1(F.elu(x))))
        return x + h if self.shortcut is None else self.shortcut(x) + h


class EncoderStage(nn.Module):
    def __init__(self, dim: int, ratio: int, cfg: EncodecConfig, device):
        super().__init__()
        self.blocks = nn.ModuleList(
            ResnetBlock(dim, cfg, cfg.dilation_base ** j, device)
            for j in range(cfg.n_residual_layers))
        self.down = SConv1d(dim, dim * 2, ratio * 2, cfg, device, stride=ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return self.down(F.elu(x))


class DecoderStage(nn.Module):
    def __init__(self, dim: int, ratio: int, cfg: EncodecConfig, device):
        super().__init__()
        self.up = SConvTranspose1d(dim, dim // 2, ratio * 2, cfg, device, ratio)
        self.blocks = nn.ModuleList(
            ResnetBlock(dim // 2, cfg, cfg.dilation_base ** j, device)
            for j in range(cfg.n_residual_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.up(F.elu(x))
        for blk in self.blocks:
            x = blk(x)
        return x


class SEANetEncoder(nn.Module):
    def __init__(self, cfg: EncodecConfig, device):
        super().__init__()
        nf = cfg.n_filters
        self.init = SConv1d(cfg.channels, nf, cfg.kernel_size, cfg, device)
        self.stages = nn.ModuleList(
            EncoderStage(nf * 2 ** s, ratio, cfg, device)
            for s, ratio in enumerate(reversed(cfg.ratios)))
        dim = nf * 2 ** len(cfg.ratios)
        self.lstm = SLSTM(dim, cfg.lstm, device) if cfg.lstm else None
        self.final = SConv1d(dim, cfg.dimension, cfg.last_kernel_size, cfg, device)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """wav [B, channels, T] -> latent frames [B, dimension, T']."""
        x = self.init(wav)
        for stage in self.stages:
            x = stage(x)
        if self.lstm is not None:
            x = self.lstm(x)
        return self.final(F.elu(x))


class SEANetDecoder(nn.Module):
    def __init__(self, cfg: EncodecConfig, device):
        super().__init__()
        nf = cfg.n_filters
        dim = nf * 2 ** len(cfg.ratios)
        self.init = SConv1d(cfg.dimension, dim, cfg.kernel_size, cfg, device)
        self.lstm = SLSTM(dim, cfg.lstm, device) if cfg.lstm else None
        self.stages = nn.ModuleList(
            DecoderStage(dim // 2 ** s, ratio, cfg, device)
            for s, ratio in enumerate(cfg.ratios))
        self.final = SConv1d(nf, cfg.channels, cfg.last_kernel_size, cfg, device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """latent frames [B, dimension, T'] -> wav [B, channels, T'*hop]."""
        x = self.init(z)
        if self.lstm is not None:
            x = self.lstm(x)
        for stage in self.stages:
            x = stage(x)
        return self.final(F.elu(x))


def rvq_encode(codebooks: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """codebooks [n_q, N, D], z [B, T, D] -> codes [B, n_q, T]: each stage
    takes the nearest entry to the remaining residual."""
    residual = z.float()
    codes = []
    for cb in codebooks.float():
        d2 = ((residual ** 2).sum(-1, keepdim=True)
              - 2.0 * residual @ cb.T + (cb ** 2).sum(-1))
        idx = d2.argmin(-1)                                    # [B, T]
        residual = residual - cb[idx]
        codes.append(idx)
    return torch.stack(codes, dim=1)


def rvq_decode(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, n_q, T] -> z [B, T, D], the sum of codebook vectors.  A code
    outside [0, N) (a special token of the language model, which random
    weights can emit) adds a zero vector; the JAX package's gather yields
    NaN there."""
    N = codebooks.shape[1]
    valid = (codes >= 0) & (codes < N)
    safe = torch.where(valid, codes, 0)
    z = 0
    for q, cb in enumerate(codebooks.float()):
        z = z + cb[safe[:, q]] * valid[:, q, :, None]
    return z


class Encodec(nn.Module):
    def __init__(self, cfg: EncodecConfig, device):
        super().__init__()
        self.cfg = cfg
        self.encoder = SEANetEncoder(cfg, device)
        self.decoder = SEANetDecoder(cfg, device)
        self.codebooks = _param(cfg.n_q, cfg.codebook_size, cfg.dimension,
                                device=device)

    @property
    def device(self) -> torch.device:
        return self.codebooks.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Encodec":
        """Random weights with the distributions of the JAX package's
        ``init_encodec``: convs uniform(+-1/sqrt(Cin*K)) (transposed convs
        with Cin their input channels), LSTM uniform(+-1/sqrt(dim)),
        codebooks N(0, 1)."""
        for m in self.modules():
            if isinstance(m, (SConv1d, SConvTranspose1d)):
                cin = m.weight.shape[0 if isinstance(m, SConvTranspose1d) else 1]
                bound = (cin * m.weight.shape[-1]) ** -0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.LSTM):
                bound = m.hidden_size ** -0.5
                for p in m.parameters():
                    p.uniform_(-bound, bound, generator=generator)
        self.codebooks.normal_(generator=generator)
        return self

    @torch.inference_mode()
    def encode(self, wav: torch.Tensor) -> torch.Tensor:
        """wav [B, T] or [B, channels, T] -> codes [B, n_q, ceil(T / hop)]."""
        if wav.dim() == 2:
            wav = wav[:, None]
        z = self.encoder(wav.float())
        return rvq_encode(self.codebooks, z.transpose(1, 2))

    @torch.inference_mode()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, n_q, T] -> wav [B, T * hop]."""
        z = rvq_decode(self.codebooks, codes)
        return self.decoder(z.transpose(1, 2))[:, 0]


def encode_bucketed(codec: Encodec, wav: np.ndarray,
                    bucket_samples: int = 4 * 16000) -> np.ndarray:
    """wav [B, T] numpy -> codes [B, n_q, ceil(T/hop)] numpy.  The wav is
    zero-padded to a multiple of the bucket; the codec is causal, so the
    padding cannot change the frames kept."""
    assert codec.cfg.causal, "bucketed encode requires a causal codec"
    T = wav.shape[-1]
    pad_T = max(-(-T // bucket_samples) * bucket_samples, bucket_samples)
    padded = np.zeros(wav.shape[:-1] + (pad_T,), np.float32)
    padded[..., :T] = wav
    codes = codec.encode(torch.from_numpy(padded).to(codec.device))
    return codes.cpu().numpy().astype(np.int32)[..., :-(-T // codec.cfg.hop_length)]


def decode_bucketed(codec: Encodec, codes: np.ndarray,
                    bucket_frames: int = 200) -> np.ndarray:
    """codes [B, n_q, T] numpy -> wav [B, T*hop] numpy (codes zero-padded to
    a multiple of the bucket; causal, so the samples kept are unchanged)."""
    assert codec.cfg.causal, "bucketed decode requires a causal codec"
    T = codes.shape[-1]
    pad_T = max(-(-T // bucket_frames) * bucket_frames, bucket_frames)
    padded = np.zeros(codes.shape[:-1] + (pad_T,), np.int64)
    padded[..., :T] = codes
    wav = codec.decode(torch.from_numpy(padded).to(codec.device))
    return wav.cpu().numpy()[..., :T * codec.cfg.hop_length]
