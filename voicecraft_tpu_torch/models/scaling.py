"""The icefall "scaling" toolbox (PyTorch port of
voicecraft_tpu/models/scaling.py).

The reference vendors icefall's toolbox (reference
models/modules/scaling.py): gradient-steering regularisers
(ActivationBalancer, Whiten, MaxEig), BasicNorm, DoubleSwish with a cached
derivative, scaled inits, the spectral-regularised linear and small
autograd utilities.  The VoiceCraft configs select BasicNorm / DoubleSwish
and their balanced forms through ``ModelConfig.norm`` /
``ffn_activation`` (models/transformer.py).

Each ``jax.custom_vjp`` of the JAX package is a ``torch.autograd.Function``
here, with the same forward and the same backward.  The regularisers are
deterministic (the expected gain every step, not the reference's
count-decayed probability over gain/prob), and they cost nothing when no
gradient is taken: the wrappers then return the input untouched.  The
randomised utilities take an explicit ``torch.Generator`` on the input's
device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


def _grad_needed(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


# ---------------------------------------------------------------------------
# softmax with an output-only residual (reference scaling.py:288-322)
# ---------------------------------------------------------------------------

class _Softmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ans = torch.softmax(x.float(), dim=dim).to(x.dtype)
        ctx.save_for_backward(ans)
        ctx.dim = dim
        return ans

    @staticmethod
    def backward(ctx, g):
        (ans,) = ctx.saved_tensors
        gf, af = g.float(), ans.float()
        xg = af * (gf - (gf * af).sum(dim=ctx.dim, keepdim=True))
        return xg.to(ans.dtype), None


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax accumulated in f32 whose backward keeps only the output:
    grad = ans * (g - sum(g * ans))."""
    return _Softmax.apply(x, dim)


# ---------------------------------------------------------------------------
# DoubleSwish (reference scaling.py:1161-1242)
# ---------------------------------------------------------------------------

class _DoubleSwish(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        xf = x.float()
        s = torch.sigmoid(xf - 1.0)
        y = xf * s
        # the derivative y * (1 - s) + s, cached in bfloat16 as the JAX
        # package's VJP caches it
        ctx.save_for_backward((y * (1.0 - s) + s).to(torch.bfloat16))
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (deriv,) = ctx.saved_tensors
        return (g.float() * deriv.float()).to(g.dtype)


def double_swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x - 1).  Differentiated, the forward runs in f32 and the
    derivative is cached in bfloat16; otherwise it runs in x's dtype."""
    if _grad_needed(x):
        return _DoubleSwish.apply(x)
    return x * torch.sigmoid(x - 1.0)


# ---------------------------------------------------------------------------
# BasicNorm (reference scaling.py:366-429)
# ---------------------------------------------------------------------------

def basic_norm(x: torch.Tensor, log_eps: torch.Tensor, channel_dim: int = -1,
               train: bool = False) -> torch.Tensor:
    """y = x * (mean(x^2, channel) + ballast)^-0.5, statistics in f32.

    Eval: ballast = exp(log_eps).  ``train``: the expected ballast of the
    reference's stochastic eps repair (w.p. 0.25 log_eps clamped into
    [-3, 3]), 0.75 * exp(log_eps) + 0.25 * exp(clip(log_eps, -3, 3)): the
    two forms agree for log_eps in range and differ below -3, as at the
    transformer's init log(1e-5)."""
    xf = x.float()
    ms = (xf * xf).mean(dim=channel_dim, keepdim=True)
    le = log_eps.float()
    if train:
        ballast = 0.75 * le.exp() + 0.25 * le.clamp(-3.0, 3.0).exp()
    else:
        ballast = le.exp()
    return (xf * torch.rsqrt(ms + ballast)).to(x.dtype)


def basic_norm_init(eps: float = 0.25, dtype=torch.float32,
                    device="cpu") -> dict:
    """{"log_eps": log(eps)} as a 0-d tensor (the library default 0.25; the
    transformer's norms use 1e-5)."""
    return {"log_eps": torch.tensor(math.log(eps), dtype=dtype, device=device)}


def clamp_log_eps(log_eps: torch.Tensor, eps_min: float = -3.0,
                  eps_max: float = 3.0) -> torch.Tensor:
    """Hard projection of log_eps into range.  The training path does not
    use it (basic_norm's ``train`` form replaces it); kept for recipes that
    want the projection."""
    return log_eps.clamp(eps_min, eps_max)


# ---------------------------------------------------------------------------
# ActivationBalancer (reference scaling.py:41-144, 644-767)
# ---------------------------------------------------------------------------

class BalancerConfig(NamedTuple):
    """Hyperparameters of :func:`activation_balancer` (the reference
    ActivationBalancer's defaults)."""
    channel_dim: int = -1
    min_positive: float = 0.05
    max_positive: float = 0.95
    max_factor: float = 0.04
    sign_gain_factor: float = 0.01
    scale_gain_factor: float = 0.02
    min_abs: float = 0.2
    max_abs: float = 100.0


def _channel_axes(ndim: int, channel_dim: int):
    channel_dim %= ndim
    return channel_dim, tuple(d for d in range(ndim) if d != channel_dim)


def _broadcast_channel(v: torch.Tensor, ndim: int, channel_dim: int):
    shape = [1] * ndim
    shape[channel_dim] = v.shape[0]
    return v.reshape(shape)


def _balancer_factors(x: torch.Tensor, cfg: BalancerConfig):
    """Per-channel sign and scale factors (reference _compute_sign_factor /
    _compute_scale_factor) with the expected gains; sign None when the
    sign constraint is off."""
    channel_dim, axes = _channel_axes(x.ndim, cfg.channel_dim)
    xf = x.float()
    sign_factor = None
    if cfg.min_positive != 0.0 or cfg.max_positive != 1.0:
        prop_pos = (xf > 0).float().mean(dim=axes)
        f1 = f2 = 0.0
        if cfg.min_positive != 0.0:
            f1 = ((cfg.min_positive - prop_pos)
                  * (cfg.sign_gain_factor / cfg.min_positive)
                  ).clamp(0.0, cfg.max_factor)
        if cfg.max_positive != 1.0:
            f2 = ((prop_pos - cfg.max_positive)
                  * (cfg.sign_gain_factor / (1.0 - cfg.max_positive))
                  ).clamp(0.0, cfg.max_factor)
        sign_factor = f1 - f2
    x_abs_mean = xf.abs().mean(dim=axes)
    below = 0.0
    if cfg.min_abs != 0.0:
        below = ((cfg.min_abs - x_abs_mean)
                 * (cfg.scale_gain_factor / cfg.min_abs)
                 ).clamp(0.0, cfg.max_factor)
    above = ((x_abs_mean - cfg.max_abs) * (cfg.scale_gain_factor / cfg.max_abs)
             ).clamp(0.0, cfg.max_factor)
    return sign_factor, below - above, channel_dim


class _ActivationBalancer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg):
        sign_factor, scale_factor, channel_dim = _balancer_factors(x, cfg)
        ctx.channel_dim = channel_dim
        ctx.has_sign = sign_factor is not None
        saved = [x > 0, scale_factor]
        if ctx.has_sign:
            saved.append(sign_factor)
        ctx.save_for_backward(*saved)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        xgt0, scale_factor, *sign = ctx.saved_tensors
        cd = ctx.channel_dim
        factor = (_broadcast_channel(scale_factor, g.ndim, cd)
                  * (xgt0.float() - 0.5))
        if ctx.has_sign:
            factor = factor + _broadcast_channel(sign[0], g.ndim, cd)
        gf = g.float()
        return (gf - gf.abs() * factor).to(g.dtype), None


def activation_balancer(x: torch.Tensor,
                        cfg: BalancerConfig = BalancerConfig()) -> torch.Tensor:
    """Identity forward; the backward steers each channel toward a sign
    proportion in [min_positive, max_positive] and a mean |x| in [min_abs,
    max_abs]:  grad -= |grad| * (sign_factor + scale_factor * ((x>0) -
    0.5)).  Free when no gradient is taken."""
    if not _grad_needed(x):
        return x
    return _ActivationBalancer.apply(x, cfg)


def balanced_double_swish(x: torch.Tensor, d_model: Optional[int] = None,
                          channel_dim: int = -1,
                          max_abs: float = 10.0) -> torch.Tensor:
    """ActivationBalancer -> DoubleSwish (reference BalancedDoubleSwish).
    ``d_model`` is accepted for the reference's signature only."""
    cfg = BalancerConfig(channel_dim=channel_dim, max_abs=max_abs)
    return double_swish(activation_balancer(x, cfg))


def balanced_basic_norm(x: torch.Tensor, log_eps: torch.Tensor,
                        channel_dim: int = -1,
                        train: bool = False) -> torch.Tensor:
    """ActivationBalancer(min_positive 0.45, max_positive 0.55, max_abs 6)
    -> BasicNorm (reference transformer.py BalancedBasicNorm)."""
    cfg = BalancerConfig(channel_dim=channel_dim, min_positive=0.45,
                         max_positive=0.55, max_abs=6.0)
    return basic_norm(activation_balancer(x, cfg), log_eps, channel_dim,
                      train=train)


# ---------------------------------------------------------------------------
# penalize_abs_values_gt / with_loss (reference scaling.py:769-794, 970-987)
# ---------------------------------------------------------------------------

class _PenalizeAbsValuesGt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, limit, penalty):
        ctx.save_for_backward(torch.sign(x) * (x.abs() > limit).to(x.dtype))
        ctx.penalty = penalty
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (signed_over,) = ctx.saved_tensors
        return g + ctx.penalty * signed_over.to(g.dtype), None, None


def penalize_abs_values_gt(x: torch.Tensor, limit: float,
                           penalty: float) -> torch.Tensor:
    """Identity forward; adds penalty * d/dx sum(relu(|x| - limit)) to the
    gradient."""
    if not _grad_needed(x):
        return x
    return _PenalizeAbsValuesGt.apply(x, limit, penalty)


class _WithLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        ctx.y_shape, ctx.y_dtype = y.shape, y.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, torch.ones(ctx.y_shape, dtype=ctx.y_dtype, device=g.device)


def with_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Returns x, and differentiates as if y.sum() had been added to the
    loss (reference WithLoss)."""
    return _WithLoss.apply(x, y)


# ---------------------------------------------------------------------------
# Whitening penalty (reference scaling.py:797-967)
# ---------------------------------------------------------------------------

def whitening_metric(x: torch.Tensor, num_groups: int = 1) -> torch.Tensor:
    """>= 1; equal to 1 iff the centered per-group covariance is a multiple
    of I with the same trace in every group (reference _whitening_metric)."""
    xf = x.float().reshape(-1, x.shape[-1])
    num_frames, num_channels = xf.shape
    assert num_channels % num_groups == 0
    cpg = num_channels // num_groups
    xg = xf.reshape(num_frames, num_groups, cpg).transpose(0, 1)
    xg = xg - xg.mean(dim=1, keepdim=True)
    covar = xg.transpose(1, 2) @ xg                       # [G, C/G, C/G]
    mean_diag = torch.diagonal(covar, dim1=1, dim2=2).mean()
    covarsq_mean_diag = (covar ** 2).sum() / (num_groups * cpg)
    return covarsq_mean_diag / (mean_diag ** 2 + 1.0e-20)


def _penalty_grad(fn, x: torch.Tensor) -> torch.Tensor:
    """d fn(x) / dx in f32, taken inside a backward on a detached copy."""
    with torch.enable_grad():
        xd = x.detach().float().requires_grad_(True)
        (grad,) = torch.autograd.grad(fn(xd), xd)
    return grad


class _Whiten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, num_groups, whitening_limit, grad_scale):
        ctx.save_for_backward(x)
        ctx.args = (num_groups, whitening_limit, grad_scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        num_groups, limit, grad_scale = ctx.args
        pg = _penalty_grad(
            lambda xd: F.relu(whitening_metric(xd, num_groups) - limit), x)
        gf = g.float()
        scale = grad_scale * (torch.linalg.vector_norm(gf)
                              / (torch.linalg.vector_norm(pg) + 1.0e-20))
        return (gf + pg * scale).to(g.dtype), None, None, None


def whiten(x: torch.Tensor, num_groups: int = 1, whitening_limit: float = 2.0,
           grad_scale: float = 0.02) -> torch.Tensor:
    """Identity forward; the backward adds the gradient of relu(
    whitening_metric(x) - limit), scaled to ``grad_scale`` of the incoming
    gradient's norm (reference Whiten)."""
    if not _grad_needed(x):
        return x
    return _Whiten.apply(x, num_groups, whitening_limit, grad_scale)


# ---------------------------------------------------------------------------
# MaxEig (reference scaling.py:325-363, 1007-1159)
# ---------------------------------------------------------------------------

class MaxEigConfig(NamedTuple):
    """The reference MaxEig's defaults."""
    channel_dim: int = -1
    max_var_per_eig: float = 0.2
    scale: float = 0.01


def max_eig_init(num_channels: int, device="cpu") -> torch.Tensor:
    """The initial power-iteration direction: arange, normalised (draws
    nothing from a generator)."""
    d = torch.arange(num_channels, dtype=torch.float32, device=device)
    return d / torch.linalg.vector_norm(d)


def _find_direction_coeffs(x2d: torch.Tensor, prev_direction: torch.Tensor):
    coeffs = (x2d * prev_direction).sum(dim=1, keepdim=True) + 1.0e-10
    cur = (x2d * coeffs).sum(dim=0) / ((coeffs ** 2).sum() + 1.0e-20)
    return cur, coeffs


def _rows(x: torch.Tensor, channel_dim: int) -> torch.Tensor:
    """x with its channel axis last, as rows [N, C], centered."""
    x2 = torch.movedim(x, channel_dim, -1).reshape(-1, x.shape[channel_dim])
    return x2 - x2.mean(dim=0)


class _MaxEigPenalty(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coeffs, direction, active, cfg):
        ctx.save_for_backward(x, coeffs, direction, active)
        ctx.cfg = cfg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        x, coeffs, direction, active = ctx.saved_tensors
        channel_dim = ctx.cfg.channel_dim % x.ndim

        def variance_proportion(xd):
            x2 = _rows(xd, channel_dim)
            x_var = (x2 ** 2).mean()
            resid = x2 - coeffs * direction
            return (x_var - (resid ** 2).mean()) / (x_var + 1.0e-20)

        pg = _penalty_grad(variance_proportion, x)
        gf = g.float()
        extra = (pg * ctx.cfg.scale * torch.linalg.vector_norm(gf)
                 / (torch.linalg.vector_norm(pg) + 1.0e-20))
        return (gf + extra * active).to(g.dtype), None, None, None, None


def max_eig(x: torch.Tensor, direction: torch.Tensor,
            cfg: MaxEigConfig = MaxEigConfig()
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Discourages any one direction of activation space from holding more
    than ``max_var_per_eig`` of the variance (reference MaxEig).  The
    power-iteration ``direction`` is state: pass the current one
    (:func:`max_eig_init`) and carry the returned one.  The penalty
    gradient applies whenever the constraint is active.

    Returns (x, new_direction)."""
    channel_dim = cfg.channel_dim % x.ndim
    with torch.no_grad():
        x2 = _rows(x.detach().float(), channel_dim)
        new_direction, coeffs = _find_direction_coeffs(x2, direction)
        x_var = (x2 ** 2).mean()
        resid_var = ((x2 - coeffs * new_direction) ** 2).mean()
        proportion = (x_var - resid_var) / (x_var + 1.0e-20)
        # nonzero even for x == 0, and kept when not finite (reference
        # scaling.py:1090-1093, 1117-1129)
        blended = 0.1 * direction + new_direction
        blended = blended / torch.linalg.vector_norm(blended)
        out_direction = torch.where(torch.isfinite(blended.sum()), blended,
                                    direction)
        active = (proportion >= cfg.max_var_per_eig).float()
    if not _grad_needed(x):
        return x, out_direction
    return (_MaxEigPenalty.apply(x, coeffs, new_direction, active, cfg),
            out_direction)


# ---------------------------------------------------------------------------
# Scaled inits (reference scaling.py:432-487)
# ---------------------------------------------------------------------------

def _uniform(generator, shape, lo, hi, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device).uniform_(
        lo, hi, generator=generator)


def scaled_linear_init(generator: torch.Generator, in_features: int,
                       out_features: int, initial_scale: float = 1.0,
                       bias: bool = True, dtype=torch.float32) -> dict:
    """nn.Linear's init with the weight scaled by ``initial_scale`` and the
    bias drawn from U(-0.1 s, 0.1 s) (reference ScaledLinear).  Weight
    [in, out] (y = x @ w + b), on the generator's device."""
    dev = generator.device
    bound = 1.0 / math.sqrt(in_features)
    w = _uniform(generator, (in_features, out_features), -bound, bound, dtype,
                 dev) * initial_scale
    if not bias:
        return {"w": w}
    return {"w": w, "b": _uniform(generator, (out_features,),
                                  -0.1 * initial_scale, 0.1 * initial_scale,
                                  dtype, dev)}


def scaled_conv1d_init(generator: torch.Generator, in_channels: int,
                       out_channels: int, kernel_size: int = 3,
                       initial_scale: float = 1.0, bias: bool = True,
                       dtype=torch.float32) -> dict:
    """nn.Conv1d's init scaled by ``initial_scale`` (reference
    ScaledConv1d).  Weight [width, in, out]."""
    dev = generator.device
    bound = 1.0 / math.sqrt(in_channels * kernel_size)
    w = _uniform(generator, (kernel_size, in_channels, out_channels), -bound,
                 bound, dtype, dev) * initial_scale
    if not bias:
        return {"w": w}
    return {"w": w, "b": _uniform(generator, (out_channels,),
                                  -0.1 * initial_scale, 0.1 * initial_scale,
                                  dtype, dev)}


# ---------------------------------------------------------------------------
# SRLinear, the spectral-regularised linear (reference scaling.py:556-618)
# ---------------------------------------------------------------------------

def sr_linear_init(generator: torch.Generator, in_features: int,
                   out_features: int, bias: bool = True,
                   dtype=torch.float32) -> dict:
    """Parameters and power-iteration state of :func:`sr_linear_apply`
    (arXiv 2303.06296): ``w`` [in, out], learnable ``sigma`` [1], ``b``,
    and ``u`` [in], a buffer to keep out of the optimizer."""
    dev = generator.device
    bound = 1.0 / math.sqrt(in_features)
    w = _uniform(generator, (in_features, out_features), -bound, bound, dtype,
                 dev)
    u = torch.randn((in_features,), generator=generator, dtype=torch.float32,
                    device=dev)
    p = {"w": w, "sigma": torch.ones((1,), dtype=dtype, device=dev),
         "u": u / torch.linalg.vector_norm(u)}
    if bias:
        p["b"] = _uniform(generator, (out_features,), -bound, bound, dtype, dev)
    return p


def sr_linear_apply(p: dict, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One power-iteration step and the spectrally normalised product.
    Returns (y, new_u); store new_u back into p["u"].  sigma differentiates
    through w (the method's regularising force); u does not."""
    w = p["w"].float()                                   # [in, out]
    with torch.no_grad():
        v = w.T @ p["u"]
        v = v / torch.linalg.vector_norm(v)
        new_u = w @ v
        new_u = new_u / torch.linalg.vector_norm(new_u)
    sigma = torch.einsum("c,dc,d->", v, w, new_u)
    weight = (p["sigma"].float() / sigma) * w
    y = x.float() @ weight
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype), new_u


# ---------------------------------------------------------------------------
# Randomised utilities (reference scaling.py:186-286)
# ---------------------------------------------------------------------------

def random_clamp(generator: torch.Generator, x: torch.Tensor,
                 min: Optional[float] = None, max: Optional[float] = None,
                 prob: float = 0.5, reflect: float = 0.0) -> torch.Tensor:
    """Each element clamped to [min, max] with probability ``prob``
    (reference RandomClampFunction); the gradient flows through the
    elements the clamp left as they were, times (1 + reflect)."""
    clamped = x if min is None and max is None else x.clamp(min=min, max=max)
    mask = torch.rand(x.shape, generator=generator, device=x.device) < prob
    ans = torch.where(mask, clamped, x)
    is_same = (ans == x).to(x.dtype).detach()
    ans = x * is_same + (ans - x * is_same).detach()
    if reflect != 0.0:
        ans = ans * (1.0 + reflect) - x * reflect
    return ans


def random_cast(generator: torch.Generator, x: torch.Tensor,
                dtype=torch.bfloat16) -> torch.Tensor:
    """Expectation-preserving stochastic rounding of f32 to bfloat16:
    uniform noise below bit 16 of the f32 pattern, then truncation
    (reference random_cast_to_half, retargeted to bf16).  Other dtypes
    round to nearest."""
    if dtype != torch.bfloat16:
        return x.to(dtype)
    bits = x.float().view(torch.int32)
    noise = torch.randint(0, 1 << 16, x.shape, generator=generator,
                          dtype=torch.int32, device=x.device)
    rounded = (bits + noise) & -65536                    # & 0xFFFF0000
    return rounded.view(torch.float32).to(dtype)
