"""EnCodec neural audio codec (PyTorch port of voicecraft_tpu/models/encodec.py,
with its exact streaming decode): SEANet conv encoder/decoder with a 2-layer
LSTM, and residual vector quantization.

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


# ==============================================================================
# exact incremental (streaming) decode
# ==============================================================================
#
# The decoder stack is causal end to end, so a chunk of frames decodes with
# O(chunk) work by carrying per-layer state instead of re-decoding the whole
# prefix:
#   * stride-1 causal convs carry their last (kernel_eff - 1) input samples;
#   * the LSTM carries (h, c) per layer (nn.LSTM's hx);
#   * transposed convs carry the (K - stride)-sample output tail
#     (overlap-add; the bias added once, on emission).
# The one non-causal wrinkle is the reflect LEFT pad at the sequence start:
# the first output samples depend on inputs 1..pad, so the FIRST chunk must
# carry at least kernel_size frames (STREAM_MIN_FIRST); the first call runs
# the normal causal-padded conv and captures carries, later calls run VALID
# convs over [carry ; chunk].  Activations are [B, C, T], as in the modules.

STREAM_MIN_FIRST = 7     # kernel_size of the decoder's init conv


def _sconv(conv: SConv1d, x: torch.Tensor, carry: torch.Tensor, first: bool):
    """Streaming stride-1 causal conv: exactly x.shape[-1] outputs, and the
    new carry."""
    ke = (conv.weight.shape[-1] - 1) * conv.dilation + 1
    if first:
        y, xc = conv(x), x
    else:
        xc = torch.cat([carry, x], dim=-1)
        y = F.conv1d(xc, conv.weight, conv.bias, dilation=conv.dilation)
    return y, (xc[..., xc.shape[-1] - (ke - 1):] if ke > 1 else carry)


def _sconvtr(convtr: SConvTranspose1d, x: torch.Tensor, tail: torch.Tensor):
    """Streaming causal ConvTranspose1d (trim_right_ratio 1): overlap-add.
    Emits x.shape[-1] * stride samples; carries the (K - stride)-sample tail
    WITHOUT bias."""
    stride, K = convtr.stride, convtr.weight.shape[-1]
    y = F.conv_transpose1d(x, convtr.weight, None, stride=stride)
    y = torch.cat([y[..., :K - stride] + tail, y[..., K - stride:]], dim=-1)
    m = x.shape[-1] * stride
    return y[..., :m] + convtr.bias[:, None], y[..., m:]


def _slstm(slstm: SLSTM, x: torch.Tensor, carry, first: bool):
    """Streaming SLSTM: the LSTM continues from ``carry`` = (h, c), each
    [layers, B, H] (zeros on the first chunk)."""
    y, hc = slstm.lstm(x.transpose(1, 2), None if first else carry)
    return y.transpose(1, 2) + x, hc


def _sresnet(blk: ResnetBlock, x: torch.Tensor, st: dict, first: bool):
    h, c1 = _sconv(blk.conv1, F.elu(x), st["conv1"], first)
    h, c2 = _sconv(blk.conv2, F.elu(h), st["conv2"], first)
    new_st = {"conv1": c1, "conv2": c2}
    if blk.shortcut is None:
        return x + h, new_st
    s, new_st["shortcut"] = _sconv(blk.shortcut, x, st["shortcut"], first)
    return s + h, new_st


def stream_decode_init(codec: "Encodec", B: int = 1) -> dict:
    """Zero-initialised per-layer streaming state of the decoder."""
    dec, dev = codec.decoder, codec.device

    def conv_carry(conv: SConv1d):
        ke = (conv.weight.shape[-1] - 1) * conv.dilation + 1
        return torch.zeros((B, conv.weight.shape[1], ke - 1), device=dev)

    def res_st(blk: ResnetBlock):
        st = {"conv1": conv_carry(blk.conv1), "conv2": conv_carry(blk.conv2)}
        if blk.shortcut is not None:
            st["shortcut"] = conv_carry(blk.shortcut)
        return st

    stages = [{"up": torch.zeros((B, stage.up.weight.shape[1],
                                  stage.up.weight.shape[-1] - stage.up.stride),
                                 device=dev),
               "blocks": [res_st(blk) for blk in stage.blocks]}
              for stage in dec.stages]
    lstm = None
    if dec.lstm is not None:
        m = dec.lstm.lstm
        z = torch.zeros((m.num_layers, B, m.hidden_size), device=dev)
        lstm = (z, z.clone())
    return {"init": conv_carry(dec.init), "lstm": lstm, "stages": stages,
            "final": conv_carry(dec.final)}


def decode_frames_stream(decoder: SEANetDecoder, z: torch.Tensor, st: dict,
                         first: bool):
    """Streaming SEANetDecoder.forward: z [B, dimension, m] -> (wav [B,
    channels, m * hop], new state).  With ``first`` the carries in ``st``
    are ignored (the sequence-start reflect pad is used instead) and fresh
    ones captured; m must then be >= STREAM_MIN_FIRST."""
    x, c_init = _sconv(decoder.init, z, st["init"], first)
    c_lstm = None
    if decoder.lstm is not None:
        x, c_lstm = _slstm(decoder.lstm, x, st["lstm"], first)
    stages = []
    for stage, sst in zip(decoder.stages, st["stages"]):
        x, tail = _sconvtr(stage.up, F.elu(x), sst["up"])
        blocks = []
        for blk, bst in zip(stage.blocks, sst["blocks"]):
            x, cb = _sresnet(blk, x, bst, first)
            blocks.append(cb)
        stages.append({"up": tail, "blocks": blocks})
    x, c_fin = _sconv(decoder.final, F.elu(x), st["final"], first)
    return x, {"init": c_init, "lstm": c_lstm, "stages": stages,
               "final": c_fin}


class StreamingDecoder:
    """Exact incremental codes -> wav decoder (host driver).

    ``feed(frames [n_q, m])`` returns the newly settled samples: every
    sample of the stream so far beyond what earlier feeds returned, equal
    (up to f32 summation order) to the same positions of ``Encodec.decode``
    of the whole sequence.  Work per feed is O(m + chunk): full
    ``chunk_frames`` blocks advance the carried state; a trailing partial
    block is decoded off a CLONED state (zero-padded to the chunk; strict
    causality keeps the emitted prefix exact) and decoded again once enough
    frames arrive.  Before STREAM_MIN_FIRST frames exist nothing is emitted
    (the sequence-start reflect pad needs them); ``flush`` decodes such a
    short utterance in one shot and makes the stream terminal.
    """

    def __init__(self, codec: "Encodec", chunk_frames: int = 16):
        assert codec.cfg.causal, "streaming decode requires a causal codec"
        assert chunk_frames >= STREAM_MIN_FIRST
        self.codec = codec
        self.chunk = chunk_frames
        self.pending = np.zeros((codec.cfg.n_q, 0), np.int64)
        self.state = None              # carries for frames consumed so far
        self.state_frames = 0          # frames consumed into self.state
        self.emitted = 0               # samples returned so far (global)
        self.flushed = False           # flush() makes the stream terminal

    @torch.inference_mode()
    def _run(self, frames: np.ndarray, persist: bool) -> np.ndarray:
        """Decode ``frames`` [n_q, chunk] on top of self.state."""
        first = self.state is None
        codec = self.codec
        st = stream_decode_init(codec) if first else self.state
        codes = torch.from_numpy(frames[None]).to(codec.device)
        z = rvq_decode(codec.codebooks, codes).transpose(1, 2)
        wav, st = decode_frames_stream(codec.decoder, z, st, first)
        if persist:
            self.state = st
            self.state_frames += frames.shape[1]
        return wav[0, 0].float().cpu().numpy()

    def feed(self, new_frames: np.ndarray) -> np.ndarray:
        if self.flushed:
            # the flush of a sub-minimum stream decoded its prefix with the
            # sequence-START reflect pad; later frames would change those
            # samples, so the stream is terminal
            raise RuntimeError("StreamingDecoder.feed() after flush(): "
                               "the stream is terminal")
        hop = self.codec.cfg.hop_length
        if new_frames.shape[1]:
            self.pending = np.concatenate(
                [self.pending, np.asarray(new_frames, np.int64)], axis=1)
        out = []

        def emit(wav, start_frame):
            # drop the samples an earlier partial-block run returned
            lo = self.emitted - start_frame * hop
            if lo < wav.shape[0]:
                out.append(wav[max(lo, 0):])
                self.emitted = start_frame * hop + wav.shape[0]

        while self.pending.shape[1] >= self.chunk:
            start = self.state_frames
            wav = self._run(self.pending[:, :self.chunk], persist=True)
            self.pending = self.pending[:, self.chunk:]
            emit(wav, start)
        r = self.pending.shape[1]
        if r and (self.state is not None
                  or self.state_frames + r >= STREAM_MIN_FIRST):
            padded = np.zeros((self.codec.cfg.n_q, self.chunk), np.int64)
            padded[:, :r] = self.pending
            emit(self._run(padded, persist=False)[:r * hop], self.state_frames)
        if not out:
            return np.zeros((0,), np.float32)
        return np.concatenate(out).astype(np.float32)

    def flush(self) -> np.ndarray:
        """Emit anything still held back and make the stream terminal
        (idempotent; a later feed() raises).  Only a whole utterance under
        STREAM_MIN_FIRST frames is held back; it is decoded in one shot."""
        r = self.pending.shape[1]
        hold = (not self.flushed and self.state is None
                and 0 < r < STREAM_MIN_FIRST)
        self.flushed = True
        if hold:
            held, self.pending = self.pending, self.pending[:, :0]
            wav = self.codec.decode(torch.from_numpy(held[None]).to(
                self.codec.device))[0]
            self.emitted = r * self.codec.cfg.hop_length
            return wav.float().cpu().numpy()
        return np.zeros((0,), np.float32)
