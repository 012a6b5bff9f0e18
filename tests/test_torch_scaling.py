"""The port's icefall toolbox (voicecraft_tpu_torch/models/scaling.py)
against the JAX package's (voicecraft_tpu/models/scaling.py): every
function's forward and, through a cotangent drawn from the same seed, its
gradient (each torch.autograd.Function against its jax.custom_vjp), in f32
on the CPU within rtol 1e-5 / atol 1e-6.  The random-draw functions cannot
share JAX's threefry keys, so they are held to their properties, as
tests/test_scaling.py holds the JAX ones: the init scale and bounds, the
clamp mask and its gradient, random_cast's expectation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.models import scaling as J
from voicecraft_tpu_torch.models import scaling as S

RTOL, ATOL = 1e-5, 1e-6


def _rand(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            + shift).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _vjp_pair(jfn, tfn, *arrays, seed=99):
    """(JAX outputs, JAX grads, port outputs, port grads) of fn(*arrays)
    under the same cotangent of the first output."""
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    jout0 = jout[0] if isinstance(jout, tuple) else jout
    g = _rand(seed, *jout0.shape)
    cot = (jnp.asarray(g),) + tuple(jnp.zeros_like(o) for o in jout[1:]) \
        if isinstance(jout, tuple) else jnp.asarray(g)
    jgrads = vjp(cot)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tout = tfn(*ts)
    tout0 = tout[0] if isinstance(tout, tuple) else tout
    tout0.backward(torch.from_numpy(g))
    return jout, jgrads, tout, [t.grad for t in ts]


def _check(jfn, tfn, *arrays):
    jout, jg, tout, tg = _vjp_pair(jfn, tfn, *arrays)
    for a, b in zip(tout if isinstance(tout, tuple) else (tout,),
                    jout if isinstance(jout, tuple) else (jout,)):
        _close(a, b)
    for a, b in zip(tg, jg):
        _close(a if a is not None else torch.zeros(np.shape(b)), b)


def test_softmax_forward_and_grad():
    x = _rand(0, 3, 5, 17, scale=3.0)
    for dim in (-1, 1):
        _check(lambda v: J.softmax(v, dim), lambda v: S.softmax(v, dim), x)


def test_double_swish_forward_and_bf16_cached_grad():
    x = np.linspace(-8, 8, 1025, dtype=np.float32).reshape(5, 205)
    _check(J.double_swish, S.double_swish, x)
    # the cached derivative is bf16, not the exact f32 one: the gradient
    # differs from the exact derivative by bf16 rounding, as JAX's does
    xt = torch.tensor(x, requires_grad=True)
    S.double_swish(xt).sum().backward()
    s = torch.sigmoid(torch.tensor(x) - 1)
    exact = torch.tensor(x) * s * (1 - s) + s
    assert not torch.equal(xt.grad, exact)
    torch.testing.assert_close(xt.grad, exact.bfloat16().float(), rtol=0,
                               atol=0)
    # without a gradient the forward is the plain x * sigmoid(x - 1)
    with torch.no_grad():
        _close(S.double_swish(torch.tensor(x)), J.double_swish(jnp.asarray(x)))


def test_double_swish_bf16_input():
    x = _rand(1, 4, 64, scale=3.0)
    jx = jnp.asarray(x, jnp.bfloat16)
    jout, vjp = jax.vjp(J.double_swish, jx)
    g = _rand(2, 4, 64)
    (jg,) = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = torch.tensor(x).bfloat16().requires_grad_(True)
    out = S.double_swish(xt)
    out.backward(torch.tensor(g).bfloat16())
    assert out.dtype == xt.grad.dtype == torch.bfloat16
    _close(out, np.asarray(jout, np.float32), rtol=0, atol=0)
    _close(xt.grad, np.asarray(jg, np.float32), rtol=0, atol=0)


@pytest.mark.parametrize("log_eps", [np.log(1e-5), -1.0, 4.0])
@pytest.mark.parametrize("train", [False, True])
def test_basic_norm_forward_and_grads(log_eps, train):
    x = _rand(3, 2, 7, 32, scale=2.0)
    le = np.asarray(log_eps, np.float32)
    _check(lambda v, e: J.basic_norm(v, e, train=train),
           lambda v, e: S.basic_norm(v, e, train=train), x, le)


def test_basic_norm_train_form_differs_at_init():
    x = torch.tensor(_rand(4, 4, 16))
    le = torch.tensor(np.log(1e-5), dtype=torch.float32)
    ev, tr = S.basic_norm(x, le), S.basic_norm(x, le, train=True)
    ms = x.square().mean(-1, keepdim=True)
    torch.testing.assert_close(ev, x / (ms + 1e-5).sqrt())
    torch.testing.assert_close(
        tr, x / (ms + 0.75e-5 + 0.25 * np.exp(-3.0)).sqrt())
    assert not torch.allclose(ev, tr)


def test_basic_norm_init_and_clamp():
    assert S.basic_norm_init()["log_eps"].item() == pytest.approx(
        float(J.basic_norm_init()["log_eps"]), rel=1e-7)
    assert S.basic_norm_init(1e-5)["log_eps"].item() == pytest.approx(
        float(J.basic_norm_init(1e-5)["log_eps"]), rel=1e-7)
    v = np.asarray([-11.5, -3.0, 0.2, 5.0], np.float32)
    _close(S.clamp_log_eps(torch.tensor(v)), J.clamp_log_eps(jnp.asarray(v)))


BALANCERS = [S.BalancerConfig(),
             S.BalancerConfig(min_positive=0.45, max_positive=0.55,
                              max_abs=6.0),
             S.BalancerConfig(channel_dim=1, min_positive=0.0,
                              max_positive=1.0, min_abs=0.0, max_abs=0.5)]


@pytest.mark.parametrize("i", range(len(BALANCERS)))
def test_activation_balancer_grad(i):
    cfg = BALANCERS[i]
    jcfg = J.BalancerConfig(*cfg)
    # channels of different sign balance and magnitude, so the factors bind
    x = _rand(5, 6, 24, 8) * np.linspace(0.01, 30.0, 8, dtype=np.float32)
    x = x + np.linspace(-2, 2, 8, dtype=np.float32)
    if cfg.channel_dim == 1:
        x = np.ascontiguousarray(x.transpose(0, 2, 1))
    _check(lambda v: J.activation_balancer(v, jcfg),
           lambda v: S.activation_balancer(v, cfg), x)


def test_balanced_double_swish_and_basic_norm_grads():
    x = _rand(6, 4, 9, 16, scale=4.0, shift=0.5)
    _check(J.balanced_double_swish, S.balanced_double_swish, x)
    le = np.asarray(np.log(1e-5), np.float32)
    for train in (False, True):
        _check(lambda v, e: J.balanced_basic_norm(v, e, train=train),
               lambda v, e: S.balanced_basic_norm(v, e, train=train), x, le)


def test_identity_forwards_without_grad():
    x = torch.tensor(_rand(7, 3, 8))
    assert S.activation_balancer(x) is x
    assert S.penalize_abs_values_gt(x, 1.0, 0.1) is x
    assert S.whiten(x) is x


def test_penalize_abs_values_gt_and_with_loss():
    x = _rand(8, 5, 12, scale=3.0)
    _check(lambda v: J.penalize_abs_values_gt(v, 2.0, 0.3),
           lambda v: S.penalize_abs_values_gt(v, 2.0, 0.3), x)
    y = _rand(9, 4)
    _check(J.with_loss, S.with_loss, x, y)


def _correlated(seed, n=64, c=12):
    base = _rand(seed, n, 1) * 4.0
    return (base * np.linspace(1, 2, c, dtype=np.float32)
            + _rand(seed + 1, n, c) * 0.3).astype(np.float32)


@pytest.mark.parametrize("groups", [1, 3])
def test_whitening_metric_and_whiten_grad(groups):
    for x in (_correlated(10), _rand(11, 64, 12)):
        _close(S.whitening_metric(torch.tensor(x), groups),
               J.whitening_metric(jnp.asarray(x), groups))
        # limit 2: active on the correlated input, not on the white one
        _check(lambda v: J.whiten(v, groups, 2.0, 0.02),
               lambda v: S.whiten(v, groups, 2.0, 0.02), x)


@pytest.mark.parametrize("channel_dim", [-1, 1])
def test_max_eig_direction_and_grad(channel_dim):
    cfg = S.MaxEigConfig(channel_dim=channel_dim)
    jcfg = J.MaxEigConfig(*cfg)
    for x in (_correlated(12).reshape(4, 16, 12), _rand(13, 4, 16, 12)):
        if channel_dim == 1:
            x = np.ascontiguousarray(x.transpose(0, 2, 1))
        d0 = S.max_eig_init(12)
        _close(d0, J.max_eig_init(12))
        _check(lambda v: J.max_eig(v, jnp.asarray(d0.numpy()), jcfg),
               lambda v: S.max_eig(v, d0, cfg), x)


def test_scaled_inits():
    g = lambda: torch.Generator().manual_seed(0)
    p1 = S.scaled_linear_init(g(), 64, 32, initial_scale=1.0)
    p2 = S.scaled_linear_init(g(), 64, 32, initial_scale=0.25)
    torch.testing.assert_close(p2["w"], p1["w"] * 0.25)
    assert p1["w"].shape == (64, 32) and p1["b"].shape == (32,)
    assert p1["w"].abs().max() <= 64 ** -0.5
    assert p2["b"].abs().max() <= 0.1 * 0.25 + 1e-7
    assert set(S.scaled_linear_init(g(), 4, 3, bias=False)) == {"w"}
    c = S.scaled_conv1d_init(g(), 8, 16, kernel_size=3, initial_scale=0.5)
    assert c["w"].shape == (3, 8, 16) and c["b"].shape == (16,)
    assert c["w"].abs().max() <= 0.5 / np.sqrt(24) + 1e-7


def test_sr_linear_forward_state_and_grads():
    p = S.sr_linear_init(torch.Generator().manual_seed(1), 10, 7)
    assert set(p) == {"w", "b", "sigma", "u"}
    assert p["u"].norm().item() == pytest.approx(1.0, rel=1e-6)
    x = _rand(14, 4, 10)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}

    def jfn(w, sigma, b, xx):
        return J.sr_linear_apply(dict(jp, w=w, sigma=sigma, b=b), xx)

    def tfn(w, sigma, b, xx):
        return S.sr_linear_apply(dict(p, w=w, sigma=sigma, b=b), xx)
    _check(jfn, tfn, p["w"].numpy(), p["sigma"].numpy(), p["b"].numpy(), x)


def test_random_clamp():
    x = torch.linspace(-3, 3, 1001, requires_grad=True)
    gen = torch.Generator().manual_seed(1)
    y = S.random_clamp(gen, x, min=-1.0, max=1.0, prob=1.0)
    torch.testing.assert_close(y, x.detach().clamp(-1, 1))
    y.sum().backward()
    torch.testing.assert_close(x.grad, (x.detach().abs() <= 1.0).float())
    # prob 0 is the identity; a half-probability clamp clamps about half
    # of the elements out of range, each to its bound
    torch.testing.assert_close(S.random_clamp(gen, x, -1.0, 1.0, prob=0.0), x)
    big = torch.full((20000,), 5.0)
    z = S.random_clamp(gen, big, max=1.0, prob=0.5)
    assert set(z.unique().tolist()) == {1.0, 5.0}
    assert abs((z == 1.0).float().mean().item() - 0.5) < 0.02
    # reflect: ans (1 + r) - x r, the gradient (1 + r) on kept elements
    x2 = torch.tensor([0.5, 3.0], requires_grad=True)
    S.random_clamp(gen, x2, max=1.0, prob=1.0, reflect=0.25).sum().backward()
    torch.testing.assert_close(x2.grad, torch.tensor([1.0, -0.25]))


def test_random_cast_preserves_expectation():
    big = torch.full((200_000,), 1.0 + 1.0 / 512.0)   # halfway between bf16s
    cast = S.random_cast(torch.Generator().manual_seed(2), big)
    assert cast.dtype == torch.bfloat16
    assert set(cast.float().unique().tolist()) == {1.0, 1.0 + 1.0 / 128.0}
    assert abs(cast.float().mean().item() - (1.0 + 1 / 512)) < 1e-4
    neg = S.random_cast(torch.Generator().manual_seed(3), -big)
    assert abs(neg.float().mean().item() + (1.0 + 1 / 512)) < 1e-4
    exact = torch.tensor([1.0, -2.5, 0.0])
    torch.testing.assert_close(
        S.random_cast(torch.Generator().manual_seed(4), exact).float(), exact)
    torch.testing.assert_close(S.random_cast(None, exact, torch.float16),
                               exact.half())
