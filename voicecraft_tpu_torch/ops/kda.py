"""The recurrence of Kimi Delta Attention (KDA, models/kimi_linear.py): the
CUDA kernel of csrc/kda_recurrent.cu and its plain version.

Per lane and head, a state S [dk, dv] in f32 and, for each of the lane's
tokens in order, with q and k L2-normalised, g <= 0 the per-channel log
decay and beta in (0, 1):

    S <- S * exp(g)[:, None]          (decay each key channel's row)
    u  = beta (v - S^T k)             (the delta rule's correction)
    S <- S + k u^T
    o  = S^T q dk^-1/2                (the read-out)

Every step in f32, in that order: those are the rounding points, which the
kernel keeps.  A call advances B lanes by T >= 1 tokens each: lane b takes
its first ``lens[b]`` tokens (all T where ``lens`` is None), reading its
state from ``state`` and writing it back in place; the outputs of the
tokens after them are 0.  T = 1 is a decode step; a refill's prefill
passes a lane's real tokens packed, so text padding never enters the
state.

``kda_recurrent`` takes the plain version for CPU tensors; for CUDA
tensors it launches the kernel or raises.  There is no fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _native

KDA_HEAD_DIMS = (16, 32, 64, 128)


def kda_recurrent_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, beta: torch.Tensor,
                        state: torch.Tensor,
                        lens: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel's function in plain PyTorch, token by token: the
    header's four steps in f32 for every lane, a lane's state kept where
    the token lies past its length."""
    B, T, H, dk = q.shape
    scale = dk ** -0.5
    S = state.float()
    qf, kf, vf = q.float(), k.float(), v.float()
    decay = g.float().exp()
    out = torch.zeros((B, T, H, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for t in range(T):
        Sd = S * decay[:, t, :, :, None]
        u = beta[:, t, :, None].float() * (
            vf[:, t] - (Sd * kf[:, t, :, :, None]).sum(2))
        Sn = Sd + kf[:, t, :, :, None] * u[:, :, None, :]
        o = (Sn * qf[:, t, :, :, None]).sum(2) * scale
        if lens is None:
            S, out[:, t] = Sn, o
        else:
            live = (t < lens)[:, None, None]
            S = torch.where(live[..., None], Sn, S)
            out[:, t] = torch.where(live, o, 0.0)
    state.copy_(S)
    return out


def kda_recurrent(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor, beta: torch.Tensor, state: torch.Tensor,
                  lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Advance ``state`` [B, H, dk, dv] (f32, in place) by the tokens of
    q / k [B, T, H, dk] (bf16 or f32, L2-normalised), v [B, T, H, dv] (q's
    dtype), g [B, T, H, dk] (f32 log decay) and beta [B, T, H] (f32); lens
    [B] int64 or None.  Returns o [B, T, H, dv] f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    name = "kda_recurrent"
    if (k.shape != q.shape or g.shape != q.shape or v.shape[:3] != (B, T, H)
            or beta.shape != (B, T, H) or state.shape != (B, H, dk, dv)):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, g "
                         f"{tuple(g.shape)}, beta {tuple(beta.shape)}, state "
                         f"{tuple(state.shape)}")
    if state.dtype != torch.float32 or g.dtype != torch.float32 or \
            beta.dtype != torch.float32:
        raise TypeError(f"{name}: state, g and beta must be f32, got "
                        f"{state.dtype}, {g.dtype}, {beta.dtype}")
    if lens is not None and (lens.dtype != torch.int64 or lens.shape != (B,)):
        raise ValueError(f"{name}: lens must be int64 [B]")
    if q.device.type == "cpu":
        return kda_recurrent_plain(q, k, v, g, beta, state, lens)
    tensors = [q, k, v, g, beta, state] + ([] if lens is None else [lens])
    _native.require_cuda(name, *tensors)
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q / k / v must share one dtype of f32 or "
                        f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if dk not in KDA_HEAD_DIMS or dv % 32:
        raise ValueError(f"{name}: dk {dk} not in {KDA_HEAD_DIMS} or dv {dv} "
                         "not a multiple of 32")
    out = torch.empty((B, T, H, dv), dtype=torch.float32, device=q.device)
    err = _native.lib().vc_kda_recurrent(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        beta.data_ptr(), state.data_ptr(),
        None if lens is None else lens.data_ptr(), out.data_ptr(), B, T, H,
        dk, dv, dk ** -0.5, _native.DTYPE_CODES[q.dtype],
        _native.stream(q))
    _native.check(err, name)
    _native.count_launch(name)
    return out
