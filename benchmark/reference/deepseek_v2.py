"""Plain float32 reference of VoiceCraft with DeepSeek-V2's decoder (the
DeepSeek-V2-Lite configuration: arXiv:2405.04434 and its config.json), for
deciding whether what the port served is right.

Written from the published description and independent of the program:
plain ``torch`` operations, float32 with TF32 off, one whole sequence at a
time, no cache, no kernels, no batching, the attention unabsorbed and its
own routing.  It reads a configuration file's numbers and a state keyed as
the port's checkpoints are, and imports nothing of the port (VoiceCraft's
front end and heads come from the VoiceCraft reference beside this file).
On the card it keeps the state as given (bf16) and upcasts one layer at a
time: a float32 copy of the whole model would not fit.

The front end is VoiceCraft's (reference/voicecraft.py): text tokens
embedded plus alpha_text times a sine table, the audio in the delayed
codebook layout, each column the sum of its K codebooks' embeddings plus
alpha_audio times the sine table; after the stack, K heads Linear -> exact
GELU -> Linear.  The stack over [text ; audio], position p at index p of
that unpadded sequence (h the layer's input; H heads, dn / dr / dv the
query-key dims without and with rotary positions and the value dim, r the
latent rank):

    a = RMSNorm_1(h);  q = a W_q -> [H, dn + dr]: q_nope, q_pe
    [c ; k_pe] = a W_kva -> r + dr;  c <- RMSNorm_kv(c)
    [k_nope ; v] = c W_kvb -> [H, dn + dv]
    q_pe and k_pe (one for all heads): pair (2i, 2i + 1) rotated by the
        angle p f_i
    o = softmax(s [q_nope ; q_pe] . [k_nope ; k_pe]^T, causal) v;
        h += o W_o
    h += FFN(RMSNorm_2(h)): W_down(silu(x W_gate) * x W_up) in the first
        first_k_dense_replace layers; after them
        sum_{j in top k of p} p_j E_j(x) + E_shared(x), p = softmax(x
        W_router), not renormalised, E a SwiGLU of moe_intermediate_size
        (the shared experts one SwiGLU of n_shared_experts times it)
    then a final RMSNorm.  RMSNorm: x / sqrt(mean(x^2) + eps) times a gain.

YaRN: f_i = f_inter,i r_i + f_extra,i (1 - r_i) with f_extra,i =
theta^(-2i / dr), f_inter,i = f_extra,i / factor, r_i = clamp((i - lo) /
(hi - lo), 0, 1), lo = floor(dr ln(orig / (beta_fast 2 pi)) / (2 ln
theta)), hi = ceil(the same at beta_slow); cos and sin times mscale /
mscale_all_dim's ratio (1 here); s = (dn + dr)^(-1/2) (0.1 mscale_all_dim
ln factor + 1)^2, 0.11472 for DeepSeek-V2-Lite.

The experts are computed expert by expert over the rows that chose each;
the weights are the f32 softmax's.  ``weights="fp8"`` rounds every decoder
matrix (the router and the experts included) and the heads as the
VoiceCraft reference does (e4m3, one scale per output column): the
control.  The slab the port serves from is bf16, so only ``kv="exact"``.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

_spec = importlib.util.spec_from_file_location(
    "bench_reference_voicecraft_base", Path(__file__).with_name("voicecraft.py"))
_vc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_vc)

F32 = torch.float32
exact_f32 = _vc.exact_f32
round_matrix = _vc.round_matrix
delayed = _vc.delayed


def rope_frequencies(cfg: dict) -> np.ndarray:
    """f_i [dr / 2], float64 (the header's YaRN formula)."""
    dr, theta = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    extra = theta ** (-np.arange(0, dr, 2, dtype=np.float64) / dr)
    factor = cfg["yarn_factor"]
    if factor <= 1:
        return extra
    orig = cfg["yarn_original_max_position_embeddings"]
    at = lambda beta: dr * math.log(orig / (beta * 2 * math.pi)) / (
        2 * math.log(theta))
    lo = max(math.floor(at(cfg["yarn_beta_fast"])), 0)
    hi = min(math.ceil(at(cfg["yarn_beta_slow"])), dr - 1)
    r = np.clip((np.arange(dr // 2) - lo) / max(hi - lo, 1e-3), 0.0, 1.0)
    return extra / factor * r + extra * (1.0 - r)


def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def attention_scale(cfg: dict) -> float:
    m = mscale(cfg["yarn_factor"], cfg["yarn_mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def rotated(x: torch.Tensor, pos: torch.Tensor, freqs: torch.Tensor,
            m: float) -> torch.Tensor:
    """x [N, ..., dr]: pair (2i, 2i + 1) of row n turned by pos[n] f_i, as
    a complex product."""
    ang = pos.double()[:, None] * freqs[None, :]                   # [N, dr/2]
    turn = torch.polar(torch.full_like(ang, m), ang)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (ang.shape[1],)
    z = torch.view_as_complex(x.double().reshape(*x.shape[:-1], -1, 2)
                              .contiguous())
    return torch.view_as_real(z * turn.view(shape)).flatten(-2).to(F32)


def rms(h: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return h / torch.sqrt(h.square().mean(-1, keepdim=True) + eps) * g


def swiglu(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
           ) -> torch.Tensor:
    """W_down(silu(x W_gate) * x W_up), w1 = [W_gate | W_up] [D, 2 I]."""
    I = w2.shape[0]
    h = x @ w1
    return (torch.nn.functional.silu(h[:, :I]) * h[:, I:]) @ w2


class Reference:
    """The reference model of one configuration with one set of weights,
    float32 on ``device`` (matrices upcast a layer at a time)."""

    def __init__(self, cfg: dict, state: Dict[str, torch.Tensor], device,
                 weights: str = "exact", acts: str = "exact"):
        if acts != "exact":
            raise ValueError(f"no activation rounding {acts!r} here")
        self.cfg, self.weights, self.device = cfg, weights, device
        self.state = {k: v.to(device) for k, v in state.items()}
        self.K, self.H = cfg["n_codebooks"], cfg["nhead"]
        self.empty = cfg["audio_vocab_size"]
        self.freqs = torch.from_numpy(rope_frequencies(cfg)).to(device)
        self.m = (mscale(cfg["yarn_factor"], cfg["yarn_mscale"])
                  / mscale(cfg["yarn_factor"], cfg["yarn_mscale_all_dim"]))
        self.s = attention_scale(cfg)
        self.pe = _vc.sine_table(4096, cfg["d_model"]).to(device)

    def _f(self, key: str) -> torch.Tensor:
        return self.state[key].to(F32)

    def _w(self, key: str) -> torch.Tensor:
        return round_matrix(self.state[key], self.weights)

    def tts_columns(self, prompt: torch.Tensor, rows: torch.Tensor
                    ) -> torch.Tensor:
        """The audio columns a TTS decode sees: the delayed prompt [K, T]
        cut after its column T, then the served rows [n, K]."""
        T = prompt.shape[1]
        return torch.cat([delayed(prompt, self.empty)[:, :T + 1], rows.T], 1)

    def _attention(self, p: str, h: torch.Tensor) -> torch.Tensor:
        cfg, H = self.cfg, self.H
        N = h.shape[0]
        r, dn = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
        eps = cfg["rms_norm_eps"]
        pos = torch.arange(N, device=h.device)
        a = rms(h, self._f(p + "ln1_g"), eps)
        q = (a @ self._w(p + "wq")).view(N, H, -1)
        kva = a @ self._w(p + "wkv_a")
        c = rms(kva[:, :r], self._f(p + "kv_ln_g"), eps)
        k_pe = rotated(kva[:, r:], pos, self.freqs, self.m)        # [N, dr]
        kv = (c @ self._w(p + "wkv_b")).view(N, H, -1)
        q = torch.cat([q[..., :dn], rotated(q[..., dn:], pos, self.freqs,
                                            self.m)], -1)
        k = torch.cat([kv[..., :dn], k_pe[:, None].expand(N, H, -1)], -1)
        v = kv[..., dn:]
        s = torch.einsum("nhd,mhd->hnm", q, k) * self.s
        causal = pos[None, :] <= pos[:, None]
        p_ = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
        o = torch.einsum("hnm,mhd->nhd", p_, v).reshape(N, -1)
        return o @ self._w(p + "wo")

    def _ffn(self, p: str, li: int, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if li < cfg["first_k_dense_replace"]:
            return swiglu(x, self._w(p + "w1"), self._w(p + "w2"))
        probs = torch.softmax(x @ self._w(p + "router"), -1)
        top_p, top_e = probs.topk(cfg["num_experts_per_tok"], -1)
        w1, w2 = self._w(p + "experts_w1"), self._w(p + "experts_w2")
        out = swiglu(x, self._w(p + "shared_w1"), self._w(p + "shared_w2"))
        for e in range(cfg["n_routed_experts"]):
            rows, slot = torch.nonzero(top_e == e, as_tuple=True)
            if rows.numel():
                out[rows] += top_p[rows, slot, None] * swiglu(x[rows], w1[e],
                                                              w2[e])
        return out

    @torch.no_grad()
    def logits(self, x: torch.Tensor, cols: torch.Tensor, kv: str = "exact",
               decode_from: Optional[int] = None,
               out_from: int = 0) -> torch.Tensor:
        """f32 logits [S - out_from, K, V + n_special] at the audio columns
        ``out_from`` .. S - 1 of text ``x`` [Lx] and audio ``cols`` [K, S]
        (``decode_from`` is where decoding began; a bf16 latent slab leaves
        nothing to round, so only ``kv="exact"``)."""
        if kv != "exact":
            raise ValueError(f"no slab rounding {kv!r} for a latent slab")
        cfg = self.cfg
        Lx, S = x.shape[0], cols.shape[1]
        hx = self._f("text_emb")[x] + self._f("alpha_text") * self.pe[:Lx]
        emb = self._f("audio_emb")
        hy = emb[0][cols[0]]
        for q in range(1, self.K):
            hy = hy + emb[q][cols[q]]
        h = torch.cat([hx, hy + self._f("alpha_audio") * self.pe[:S]], 0)
        eps = cfg["rms_norm_eps"]
        for li in range(cfg["num_decoder_layers"]):
            p = f"decoder.layers.{li}."
            h = h + self._attention(p, h)
            h = h + self._ffn(p, li, rms(h, self._f(p + "ln2_g"), eps))
        h = rms(h[Lx + out_from:], self._f("decoder.final_ln_g"), eps)
        h1 = torch.nn.functional.gelu(
            torch.einsum("nd,kdf->knf", h, self._w("heads.w1"))
            + self._f("heads.b1")[:, None])
        out = (torch.einsum("knf,kfc->knc", h1, self._w("heads.w2"))
               + self._f("heads.b2")[:, None])
        return out.transpose(0, 1)                       # [S', K, card]
