"""Plain float32 reference of the VoiceCraft decoder (arXiv:2403.16973), for
deciding whether what the port served is right.

Written from the published description and independent of the program:
plain ``torch`` operations, float32 with TF32 off, one whole sequence at a
time, no cache, no kernels, no batching.  It reads a configuration file's
numbers and a state keyed as the port's checkpoints are, and imports
nothing of the port.

The model: text tokens embedded plus alpha_text times a sine table; the
audio in the delayed codebook layout (codebook q's token t at column
1 + t + q, the empty token elsewhere), each column the sum of its K
codebooks' embeddings (a mask-embedding where a column is a span's
placeholder) plus alpha_audio times the sine table from position 0; one
causal pre-norm stack over [text ; audio] (LayerNorm eps 1e-5, 16 heads,
relu FFN), a final LayerNorm, and K heads Linear -> exact GELU -> Linear.

What the program derives from the same inputs is worked out again here:
``weights="fp8"`` rounds every decoder and head matrix as a weight-only
e4m3 copy with one scale per output column (the column's absmax over 448,
stored as bf16); ``kv="fp8"`` rounds the keys and values that a decode
step reads from a slab to e4m3, while a prefill reads its own keys and
values unrounded and a step its own.  The controls, which are no program
path: ``weights="int4"`` rounds the matrices to 4-bit integers, one scale
per column; ``acts="fp8"`` keeps every activation (the residual stream,
the norms' outputs, q, k, v, the attention probabilities, the FFN's and
the heads' hidden layers) in e4m3, one scale a tensor.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

F32 = torch.float32
E4M3 = torch.float8_e4m3fn
MATRICES = ("wq", "wk", "wv", "wo", "w1", "w2")


def exact_f32() -> None:
    """No TF32 anywhere: float32 products are float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def sine_table(n: int, dim: int) -> torch.Tensor:
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64)
                 * -(math.log(10000.0) / dim))
    pe = np.zeros((n, dim))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe.astype(np.float32))


def round_matrix(w: torch.Tensor, mode: str) -> torch.Tensor:
    """w [..., in, out] rounded per output column: "exact" (as is), "fp8"
    (e4m3 with the column absmax / 448 as scale, applied as bf16) or
    "int4" (integers in [-8, 7], column absmax / 7)."""
    w = w.to(F32)
    if mode == "exact":
        return w
    absmax = w.abs().amax(dim=-2, keepdim=True)
    if mode == "fp8":
        scale = torch.clamp(absmax / 448.0, min=1e-12)
        return (w / scale).to(E4M3).to(F32) * scale.to(torch.bfloat16).to(F32)
    if mode == "int4":
        scale = torch.clamp(absmax / 7.0, min=1e-12)
        return torch.clamp(torch.round(w / scale), -8, 7) * scale
    raise ValueError(f"unknown weight rounding {mode!r}")


def delayed(codes: torch.Tensor, empty: int) -> torch.Tensor:
    """[K, T] -> [K, T + K]: codebook q's token t at column 1 + t + q."""
    K, T = codes.shape
    out = torch.full((K, T + K), empty, dtype=torch.long, device=codes.device)
    for q in range(K):
        out[q, 1 + q:1 + q + T] = codes[q]
    return out


class Reference:
    """The reference model of one configuration with one set of weights,
    float32 on ``device``."""

    def __init__(self, cfg: dict, state: Dict[str, torch.Tensor], device,
                 weights: str = "exact", acts: str = "exact"):
        self.cfg, self.acts = cfg, acts
        self.K = cfg["n_codebooks"]
        self.H = cfg["nhead"]
        self.V = cfg["audio_vocab_size"]
        self.empty = cfg["audio_vocab_size"]
        get = lambda k: state[k].to(device=device, dtype=F32)
        self.text_emb, self.audio_emb = get("text_emb"), get("audio_emb")
        self.alpha_text, self.alpha_audio = get("alpha_text"), get("alpha_audio")
        self.layers = []
        for i in range(cfg["num_decoder_layers"]):
            p = f"decoder.layers.{i}."
            lay = {k: get(p + k) for k in ("ln1_g", "ln1_b", "bq", "bk", "bv",
                                           "bo", "ln2_g", "ln2_b", "b1", "b2")}
            for k in MATRICES:
                lay[k] = round_matrix(state[p + k].to(device), weights)
            self.layers.append(lay)
        self.final_g = get("decoder.final_ln_g")
        self.final_b = get("decoder.final_ln_b")
        self.hw1 = round_matrix(state["heads.w1"].to(device), weights)
        self.hw2 = round_matrix(state["heads.w2"].to(device), weights)
        self.hb1, self.hb2 = get("heads.b1"), get("heads.b2")
        self.pe = sine_table(4096, cfg["d_model"]).to(device)

    def tts_columns(self, prompt: torch.Tensor, rows: torch.Tensor
                    ) -> torch.Tensor:
        """The audio columns a TTS decode sees: the delayed prompt [K, T]
        cut after its column T, then the served rows [n, K]."""
        T = prompt.shape[1]
        return torch.cat([delayed(prompt, self.empty)[:, :T + 1], rows.T], 1)

    def _norm(self, h, g, b):
        return torch.nn.functional.layer_norm(h, (h.shape[-1],), g, b, 1e-5)

    @torch.no_grad()
    def logits(self, x: torch.Tensor, cols: torch.Tensor, kv: str = "exact",
               decode_from: Optional[int] = None,
               out_from: int = 0) -> torch.Tensor:
        """f32 logits [S - out_from, K, V + n_special] at the audio columns
        ``out_from`` .. S - 1 of text ``x`` [Lx] and audio ``cols`` [K, S].
        With ``kv="fp8"`` the audio columns from
        ``decode_from`` on are decode steps: they read every earlier key
        and value rounded to e4m3, their own unrounded."""
        Lx, S = x.shape[0], cols.shape[1]
        N = Lx + S
        hx = self.text_emb[x] + self.alpha_text * self.pe[:Lx]
        hy = self.audio_emb[0][cols[0]]
        for q in range(1, self.K):
            hy = hy + self.audio_emb[q][cols[q]]
        hy = hy + self.alpha_audio * self.pe[:S]
        r = _e4m3 if self.acts == "fp8" else (lambda t: t)
        h = r(torch.cat([hx, hy], 0))                            # [N, D]
        D = h.shape[1]
        Dh = D // self.H
        idx = torch.arange(N, device=h.device)
        causal = idx[None, :] <= idx[:, None]
        use8 = None
        if kv == "fp8":
            step = idx >= Lx + (S if decode_from is None else decode_from)
            use8 = (step[:, None] & (idx[None, :] < idx[:, None]))
        heads = lambda t: r(t).view(N, self.H, Dh).transpose(0, 1)
        for lay in self.layers:
            a = r(self._norm(h, lay["ln1_g"], lay["ln1_b"]))
            q = heads(a @ lay["wq"] + lay["bq"])
            k = heads(a @ lay["wk"] + lay["bk"])
            v = heads(a @ lay["wv"] + lay["bv"])
            s = (q @ k.transpose(1, 2)) / math.sqrt(Dh)
            if use8 is not None:
                k8, v8 = k.to(E4M3).to(F32), v.to(E4M3).to(F32)
                s = torch.where(use8, (q @ k8.transpose(1, 2)) / math.sqrt(Dh), s)
            p = r(torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1))
            if use8 is None:
                o = p @ v
            else:
                o = torch.where(use8, 0.0, p) @ v + torch.where(use8, p, 0.0) @ v8
            h = r(h + r(o.transpose(0, 1).reshape(N, D)) @ lay["wo"] + lay["bo"])
            a = r(self._norm(h, lay["ln2_g"], lay["ln2_b"]))
            h = r(h + r(torch.relu(a @ lay["w1"] + lay["b1"])) @ lay["w2"]
                  + lay["b2"])
        h = r(self._norm(h[Lx + out_from:], self.final_g, self.final_b))
        h1 = r(torch.nn.functional.gelu(
            torch.einsum("nd,kdf->knf", h, self.hw1) + self.hb1[:, None]))
        out = torch.einsum("knf,kfc->knc", h1, self.hw2) + self.hb2[:, None]
        return out.transpose(0, 1)                       # [S', K, card]


# ==============================================================================
# training: the loss, its gradients and the optimizer's first updates
# ==============================================================================

def fold_seed(seed: int, *path: int) -> int:
    """The seed of a dropout site: a 63-bit draw of numpy's SeedSequence
    over (seed, *path), as the configuration's training states it."""
    state = np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def keep_mask(shape, rate: float, seed: int, device) -> torch.Tensor:
    """Inverted dropout's keep mask at a site: uniforms of the site's whole
    tensor from a generator seeded with the site's seed, below 1 - rate."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def _e4m3(t: torch.Tensor) -> torch.Tensor:
    """t rounded to e4m3 with one scale (its absmax over 448)."""
    s = torch.clamp(t.abs().amax() / 448.0, min=1e-12)
    return (t / s).to(E4M3).to(F32) * s


class _Round8(torch.autograd.Function):
    """An activation kept in e4m3, its gradient likewise."""

    @staticmethod
    def forward(ctx, t):
        return _e4m3(t)

    @staticmethod
    def backward(ctx, g):
        return _e4m3(g)


class _Fp8Matmul(torch.autograd.Function):
    """x @ w with every operand of the product and of its two backward
    products rounded to e4m3 (one scale a tensor), sums in f32: a product
    computed in fp8."""

    @staticmethod
    def forward(ctx, x, w):
        x8, w8 = _e4m3(x), _e4m3(w)
        ctx.save_for_backward(x8, w8)
        return x8 @ w8

    @staticmethod
    def backward(ctx, g):
        x8, w8 = ctx.saved_tensors
        g8 = _e4m3(g)
        gx = g8 @ w8.transpose(-1, -2)
        gw = (x8.reshape(-1, x8.shape[-1]).transpose(0, 1)
              @ g8.reshape(-1, g8.shape[-1]))
        return gx, gw


class TrainReference:
    """The training loss of a padded batch and its gradients, float32 (or,
    ``precision="fp8"``, the control: every product's operands, the
    residual stream, q, k, v and the attention probabilities kept in e4m3,
    forward and backward), over blocks of rows so that it fits, with the
    dropout masks of the whole batch; and ScaledAdam's first updates (Eden's schedule),
    before its first size update (every 4th step) and its first clipping
    (after 600 steps).  Parameters are f32 tensors keyed as the port's
    checkpoints; a decoder parameter's optimizer leaf is its stack over
    the layers."""

    def __init__(self, cfg: dict, state: Dict[str, torch.Tensor], device,
                 codebook_weight, precision: str = "f32"):
        self.cfg, self.device = cfg, device
        self.p = {k: v.to(device=device, dtype=F32).clone().requires_grad_(True)
                  for k, v in state.items()}
        self.w = torch.tensor(codebook_weight, dtype=F32, device=device)
        self.fp8 = precision == "fp8"
        self.pe = sine_table(4096, cfg["d_model"]).to(device)
        self.opt = None

    def _lin(self, x, w, b):
        return (_Fp8Matmul.apply(x, w) if self.fp8 else x @ w) + b

    def _r(self, t):
        """An activation as the precision keeps it: as is in f32, rounded
        to e4m3 (and its gradient too) in fp8."""
        return _Round8.apply(t) if self.fp8 else t

    def _masks(self, batch: dict, seed: int) -> dict:
        cfg, dev = self.cfg, self.device
        B, Sx = batch["x"].shape
        Sy = batch["y_tokens"].shape[-1]
        D, Fd, S = cfg["d_model"], 4 * cfg["d_model"], Sx + Sy
        site = lambda i: fold_seed(seed, i)
        m = {"x0": keep_mask((B, Sx, D), cfg["text_embedding_dropout"], site(0), dev),
             "x1": keep_mask((B, Sx, D), cfg["text_positional_embedding_dropout"],
                             site(1), dev),
             "y": keep_mask((B, Sy, D), cfg["audio_positional_embedding_dropout"],
                            site(2), dev)}
        r = cfg["trm_dropout"]
        for li in range(cfg["num_decoder_layers"]):
            ls = fold_seed(site(3), li)
            m[f"{li}.1"] = keep_mask((B, S, D), r, fold_seed(ls, 1), dev)
            m[f"{li}.2"] = keep_mask((B, S, Fd), r, fold_seed(ls, 2), dev)
            m[f"{li}.3"] = keep_mask((B, S, D), r, fold_seed(ls, 3), dev)
        return m

    def _drop(self, x, keep, rate):
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    def _rows_loss(self, batch: dict, rows: slice, masks: dict) -> torch.Tensor:
        cfg, p = self.cfg, self.p
        x = batch["x"][rows].long()
        xl, yl = batch["x_lens"][rows].long(), batch["y_lens"][rows].long()
        yt = batch["y_tokens"][rows].long()
        mi = batch["mask_emb_idx"][rows].long()
        valid = batch["target_valid"][rows]
        Bb, Sx = x.shape
        K, Sy = yt.shape[1], yt.shape[2]
        S, D, H = Sx + Sy, cfg["d_model"], cfg["nhead"]
        Dh = D // H
        rt = cfg["text_embedding_dropout"]
        xe = self._drop(p["text_emb"][x], masks["x0"][rows], rt)
        xe = self._drop(xe + p["alpha_text"] * self.pe[:Sx], masks["x1"][rows],
                        cfg["text_positional_embedding_dropout"])
        ye = p["audio_emb"][0][yt[:, 0]]
        for q in range(1, K):
            ye = ye + p["audio_emb"][q][yt[:, q]]
        ye = torch.where((mi >= 0)[..., None], p["mask_emb"][mi.clamp(min=0)], ye)
        ye = self._drop(ye + p["alpha_audio"] * self.pe[:Sy], masks["y"][rows],
                        cfg["audio_positional_embedding_dropout"])
        h = self._r(torch.cat([xe, ye], 1))                         # [b, S, D]
        j = torch.arange(S, device=h.device)
        key_ok = torch.where(j[None] < Sx, j[None] < xl[:, None],
                             j[None] < Sx + yl[:, None])            # [b, S]
        allowed = (j[None, :] <= j[:, None])[None] & key_ok[:, None, :]
        r = cfg["trm_dropout"]
        norm = lambda t, g, b: torch.nn.functional.layer_norm(t, (D,), g, b, 1e-5)
        for li in range(cfg["num_decoder_layers"]):
            pre = f"decoder.layers.{li}."
            w = lambda n: p[pre + n]
            a = norm(h, w("ln1_g"), w("ln1_b"))
            heads = lambda t: t.view(Bb, S, H, Dh).transpose(1, 2)
            q_ = self._r(heads(self._lin(a, w("wq"), w("bq"))))
            k_ = self._r(heads(self._lin(a, w("wk"), w("bk"))))
            v_ = self._r(heads(self._lin(a, w("wv"), w("bv"))))
            s = (q_ @ k_.transpose(-1, -2)) / math.sqrt(Dh)
            s = s.masked_fill(~allowed[:, None], float("-inf"))
            o = (self._r(torch.softmax(s, -1)) @ v_).transpose(1, 2).reshape(
                Bb, S, D)
            h = self._r(h + self._drop(self._lin(o, w("wo"), w("bo")),
                                       masks[f"{li}.1"][rows], r))
            a = norm(h, w("ln2_g"), w("ln2_b"))
            f = torch.relu(self._lin(a, w("w1"), w("b1")))
            f = self._lin(self._drop(f, masks[f"{li}.2"][rows], r), w("w2"), w("b2"))
            h = self._r(h + self._drop(f, masks[f"{li}.3"][rows], r))
        hy = norm(h[:, Sx:], p["decoder.final_ln_g"], p["decoder.final_ln_b"])
        loss = hy.new_zeros(())
        tgt = torch.cat([yt[..., 1:], torch.zeros_like(yt[..., :1])], -1)
        for q in range(K):
            h1 = torch.nn.functional.gelu(
                self._lin(hy, p["heads.w1"][q], p["heads.b1"][q]))
            lg = self._lin(h1, p["heads.w2"][q], p["heads.b2"][q])  # [b,Sy,c]
            ce = -torch.log_softmax(lg, -1).gather(-1, tgt[:, q, :, None])[..., 0]
            loss = loss + self.w[q] * (ce * valid[:, q]).sum()
        return loss

    def loss_and_grads(self, batch: dict, seed: int, rows_per_block: int = 4,
                       stripes: int = 1) -> float:
        """The step's loss (the sum over codebooks of weight times the CE
        summed over valid targets), its gradients left in each parameter's
        ``.grad``.  ``stripes`` > 1: the batch in that many stripes of
        consecutive rows, each with its own dropout seed."""
        for t in self.p.values():
            t.grad = None
        B = batch["x"].shape[0]
        total = 0.0
        per = B // stripes
        for i in range(stripes):
            part = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            masks = self._masks(part, seed if stripes == 1
                                else fold_seed(seed, i))
            for r0 in range(0, per, rows_per_block):
                loss = self._rows_loss(part, slice(r0, min(per, r0 + rows_per_block)),
                                       masks)
                loss.backward()
                total += float(loss.detach())
            del masks
        return total

    # ---- ScaledAdam's first steps ------------------------------------------

    def leaves(self):
        """Optimizer leaves: (names...) per leaf, a decoder parameter's
        stacked over the layers."""
        out: Dict[str, list] = {}
        for k in self.p:
            key = k
            if k.startswith("decoder.layers."):
                key = "decoder.layers." + k.split(".", 3)[3]
            out.setdefault(key, []).append(k)
        return list(out.values())

    @torch.no_grad()
    def adam_step(self, step: int, lr: float, betas=(0.9, 0.95),
                  eps: float = 1e-8, scalar_lr_scale: float = 0.1,
                  param_min_rms: float = 1e-5, scalar_max: float = 10.0,
                  size_update_period: int = 4) -> None:
        """One ScaledAdam update (icefall's, arXiv:2303.13135's optimizer)
        from the gradients in ``.grad``: each leaf steps by Adam's direction
        times its rms (measured when the optimizer was made); a leaf of one
        element (the alphas) by Adam's direction times lr * scalar_lr_scale,
        clamped first.  Only the steps before the first size update."""
        if step % size_update_period == size_update_period - 1:
            raise ValueError("the reference covers only the steps before "
                             "ScaledAdam's first size update")
        b1, b2 = betas
        if self.opt is None:
            self.opt = {"rms": {}, "delta": {}, "eas": {}}
            for names in self.leaves():
                if len(names) == 1 and self.p[names[0]].numel() == 1:
                    continue
                sq = sum(float(self.p[n].detach().double().square().sum())
                         for n in names)
                cnt = sum(self.p[n].numel() for n in names)
                for n in names:
                    self.opt["rms"][n] = math.sqrt(sq / cnt)
        bc2 = 1.0 - b2 ** (step + 1)
        for n, t in self.p.items():
            g = t.grad if t.grad is not None else torch.zeros_like(t)
            eas = self.opt["eas"].get(n, torch.zeros_like(t)) * b2 + (1 - b2) * g * g
            delta = self.opt["delta"].get(n, torch.zeros_like(t)) * b1
            if n in self.opt["rms"]:
                denom = (eas / bc2 if bc2 < 0.99 else eas).sqrt() + eps
                alpha = -lr * (1 - b1) * max(self.opt["rms"][n], param_min_rms)
                delta = delta + g / denom * alpha
                t.add_(delta)
            else:
                denom = (eas / bc2).sqrt() + eps
                delta = delta + g / denom * (-lr * scalar_lr_scale * (1 - b1))
                t.copy_(t.clamp(-scalar_max, scalar_max) + delta)
            self.opt["eas"][n], self.opt["delta"][n] = eas, delta


def eden_lr(step: int, base: float, lr_batches: float, lr_epochs: float,
            warmup_batches: float, pseudo_epoch_size: int) -> float:
    """Eden's learning rate (icefall): base * ((step^2 + B^2) / B^2)^-1/4 *
    ((epoch^2 + E^2) / E^2)^-1/4, epoch = step // pseudo_epoch_size + 1,
    times a warmup linear from 0.5 to 1 over ``warmup_batches``."""
    epoch = math.floor(step / pseudo_epoch_size) + 1.0
    f = (((step ** 2 + lr_batches ** 2) / lr_batches ** 2) ** -0.25
         * ((epoch ** 2 + lr_epochs ** 2) / lr_epochs ** 2) ** -0.25)
    warm = 1.0 if step >= warmup_batches else \
        0.5 + 0.5 * step / max(warmup_batches, 1.0)
    return base * f * warm
