"""Plain float32 reference of VoiceCraft with Kimi Linear's decoder (the
Kimi-Linear-48B-A3B configuration: arXiv:2510.26692 and its config.json),
for deciding whether what the port served is right.

Written from the published description and independent of the program:
plain ``torch`` operations, float32 with TF32 off, one whole sequence at a
time, no cache, no kernels, no batching, the recurrence token by token,
the latent attention unabsorbed and its own routing.  It reads a
configuration file's numbers and a state keyed as the port's checkpoints
are, and imports nothing of the port (VoiceCraft's front end and heads
come from the VoiceCraft reference beside this file).  On the card it
keeps the state as given (bf16) and upcasts one layer at a time: a float32
copy of the whole model would not fit.

The front end is VoiceCraft's (reference/voicecraft.py).  The stack over
[text ; audio], the unpadded sequence of N tokens (h the layer's input):

  a KDA layer (the layers ``kda_layers`` lists, 1-indexed; H heads of dk =
  dv dims, a short convolution of width W):
    a = RMSNorm_1(h)
    [q ; k ; v] = SiLU(conv(a W_qkv)): conv[t] = sum_j w[:, j] x[t - W + 1
        + j], x[t] = 0 before the first token
    q, k per head: x / sqrt(sum x^2 + 1e-6)
    g = -exp(A_log[h]) softplus(a W_fa W_fb + dt_bias);  beta = sigmoid(a W_b)
    per head, S = 0 before the first token, for t = 0 .. N - 1:
        S = (I - beta_t k_t k_t^T) Diag(exp g_t) S + beta_t k_t v_t^T
        o_t = S^T q_t dk^-1/2
    h += (RMSNorm_head(o) * sigmoid(a W_ga W_gb + b_gb)) W_o

  a latent-attention layer (no rotary positions, mla_use_nope):
    a = RMSNorm_1(h);  q = a W_q -> [H, dn + dr]
    [c ; k_pe] = a W_kva -> r + dr;  c <- RMSNorm_kv(c)
    [k_nope ; v] = c W_kvb -> [H, dn + dv];  k = [k_nope ; k_pe]
    o = softmax((dn + dr)^-1/2 q . k^T, causal) v;  h += o W_o

  then h += FFN(RMSNorm_2(h)): W_down(silu(x W_gate) * x W_up) in the first
  first_k_dense_replace layers; after them
      sum_{j in top k of s + b} w_j E_j(x) + E_shared(x),
      s = sigmoid(x W_router) over the router's published E_router
      experts, b the correction bias, w_j = scale s_j / (sum_top-k s +
      1e-20), E a SwiGLU of moe_intermediate_size;
  and a final RMSNorm.  RMSNorm: x / sqrt(mean(x^2) + eps) times a gain.

An expert share: the state holds the first n_routed_experts of the
router's E_router experts (one chip's share of an expert-parallel
deployment).  The router routes over all E_router; a pair routed to an
expert not held adds nothing, exactly as on a chip that holds only these.
The experts are computed expert by expert over the rows that chose each.

``weights="fp8"`` rounds every decoder matrix (the router, the experts and
the convolutions' taps included) and the heads as the VoiceCraft
reference does (e4m3, one scale per output column): the control.  The
slab the port serves from is bf16 and its KDA state f32, so only
``kv="exact"``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, Optional

import torch

_spec = importlib.util.spec_from_file_location(
    "bench_reference_voicecraft_base", Path(__file__).with_name("voicecraft.py"))
_vc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_vc)

F32 = torch.float32
exact_f32 = _vc.exact_f32
round_matrix = _vc.round_matrix
delayed = _vc.delayed


def rms(h: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return h / torch.sqrt(h.square().mean(-1, keepdim=True) + eps) * g


def l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(x.square().sum(-1, keepdim=True) + 1e-6)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
           ) -> torch.Tensor:
    """W_down(silu(x W_gate) * x W_up), w1 = [W_gate | W_up] [D, 2 I]."""
    I = w2.shape[0]
    h = x @ w1
    return (torch.nn.functional.silu(h[:, :I]) * h[:, I:]) @ w2


def delta_rule(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               g: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """o [N, H, dv] of the gated delta rule over N tokens from a zero
    state, per head: S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} +
    beta_t k_t v_t^T, o_t = S_t^T q_t dk^-1/2.  q, k, g [N, H, dk]; v [N,
    H, dv]; beta [N, H]."""
    N, H, dk = q.shape
    S = torch.zeros((H, dk, v.shape[-1]), dtype=F32, device=q.device)
    eye = torch.eye(dk, dtype=F32, device=q.device)
    out = []
    for t in range(N):
        b = beta[t][:, None, None]
        kt = k[t][:, :, None]                                     # [H,dk,1]
        S = ((eye - b * kt @ kt.transpose(1, 2))
             @ (torch.exp(g[t])[:, :, None] * S) + b * kt @ v[t][:, None, :])
        out.append((S.transpose(1, 2) @ q[t][:, :, None])[..., 0])
    return torch.stack(out) * dk ** -0.5


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
        self.kda = set(cfg["kda_layers"])
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

    def _kda(self, p: str, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        N = h.shape[0]
        H, dk = cfg["kda_num_heads"], cfg["kda_head_dim"]
        eps = cfg["rms_norm_eps"]
        a = rms(h, self._f(p + "ln1_g"), eps)
        x = a @ self._w(p + "w_qkv")                              # [N, 3HK]
        w = self._w(p + "conv_w")                                 # [3HK, W]
        W = w.shape[1]
        xs = torch.cat([torch.zeros((W - 1, x.shape[1]), dtype=F32,
                                    device=x.device), x])
        conv = sum(xs[j:j + N] * w[:, j] for j in range(W))
        q, k, v = torch.nn.functional.silu(conv).view(N, 3, H, dk).unbind(1)
        f = (a @ self._w(p + "w_fa")) @ self._w(p + "w_fb")
        g = (-torch.exp(self._f(p + "A_log"))[:, None]
             * torch.nn.functional.softplus(f + self._f(p + "dt_bias"))
             .view(N, H, dk))
        beta = torch.sigmoid(a @ self._w(p + "w_b"))
        o = delta_rule(l2(q), l2(k), v, g, beta)                 # [N,H,dv]
        gate = torch.sigmoid((a @ self._w(p + "w_ga")) @ self._w(p + "w_gb")
                             + self._f(p + "b_gb")).view(N, H, dk)
        y = rms(o, self._f(p + "o_norm_g"), eps) * gate
        return y.reshape(N, -1) @ self._w(p + "wo")

    def _attention(self, p: str, h: torch.Tensor) -> torch.Tensor:
        cfg, H = self.cfg, self.H
        N = h.shape[0]
        r, dn = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
        eps = cfg["rms_norm_eps"]
        a = rms(h, self._f(p + "ln1_g"), eps)
        q = (a @ self._w(p + "wq")).view(N, H, -1)
        kva = a @ self._w(p + "wkv_a")
        c = rms(kva[:, :r], self._f(p + "kv_ln_g"), eps)
        kv = (c @ self._w(p + "wkv_b")).view(N, H, -1)
        k = torch.cat([kv[..., :dn], kva[:, None, r:].expand(N, H, -1)], -1)
        v = kv[..., dn:]
        s = torch.einsum("nhd,mhd->hnm", q, k) * q.shape[-1] ** -0.5
        pos = torch.arange(N, device=h.device)
        causal = pos[None, :] <= pos[:, None]
        p_ = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
        o = torch.einsum("hnm,mhd->nhd", p_, v).reshape(N, -1)
        return o @ self._w(p + "wo")

    def _ffn(self, p: str, li: int, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if li < cfg["first_k_dense_replace"]:
            return swiglu(x, self._w(p + "w1"), self._w(p + "w2"))
        s = torch.sigmoid(x @ self._w(p + "router"))          # [N, E_router]
        top_e = (s + self._f(p + "router_bias")).topk(
            cfg["num_experts_per_tok"], -1)[1]
        top_s = s.gather(-1, top_e)
        top_w = (cfg["routed_scaling_factor"] * top_s
                 / (top_s.sum(-1, keepdim=True) + 1e-20))
        w1, w2 = self._w(p + "experts_w1"), self._w(p + "experts_w2")
        out = swiglu(x, self._w(p + "shared_w1"), self._w(p + "shared_w2"))
        for e in range(cfg["n_routed_experts"]):
            rows, slot = torch.nonzero(top_e == e, as_tuple=True)
            if rows.numel():
                out[rows] += top_w[rows, slot, None] * swiglu(x[rows], w1[e],
                                                              w2[e])
        return out

    @torch.no_grad()
    def logits(self, x: torch.Tensor, cols: torch.Tensor, kv: str = "exact",
               decode_from: Optional[int] = None,
               out_from: int = 0) -> torch.Tensor:
        """f32 logits [S - out_from, K, V + n_special] at the audio columns
        ``out_from`` .. S - 1 of text ``x`` [Lx] and audio ``cols`` [K, S]
        (``decode_from`` is where decoding began; a bf16 latent slab and an
        f32 KDA state leave nothing to round, so only ``kv="exact"``)."""
        if kv != "exact":
            raise ValueError(f"no cache rounding {kv!r} for this block")
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
            attend = self._kda if li + 1 in self.kda else self._attention
            h = h + attend(p, h)
            h = h + self._ffn(p, li, rms(h, self._f(p + "ln2_g"), eps))
        h = rms(h[Lx + out_from:], self._f("decoder.final_ln_g"), eps)
        h1 = torch.nn.functional.gelu(
            torch.einsum("nd,kdf->knf", h, self._w("heads.w1"))
            + self._f("heads.b1")[:, None])
        out = (torch.einsum("knf,kfc->knc", h1, self._w("heads.w2"))
               + self._f("heads.b2")[:, None])
        return out.transpose(0, 1)                       # [S', K, card]
