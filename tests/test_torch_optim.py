"""The port's optimizers and schedules (voicecraft_tpu_torch/training/
optim.py) against the JAX package's (voicecraft_tpu/training/optim.py) and
optax, on one seeded gradient sequence.  ScaledAdam's parameters agree
with JAX's within rel 1e-5 (plus 1e-7 of the leaf's largest |value|) after
every step.  AdamW's agree with optax's within 1e-5 of the distance the
learning rates allowed so far (sum of lr; optax's jitted f32 update sits
~20 ulps from the exact one), and with a float64 AdamW within 1e-6 of it,
each plus rel 1e-6 (the parameter's own f32 rounding).
The schedules agree within rel 1e-6."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from voicecraft_tpu.training import optim as jopt
from voicecraft_tpu_torch.training import optim as topt

CLIP_PERIOD = 8          # clipping_update_period: the threshold refreshes
STEPS = 3 * CLIP_PERIOD  # at steps 8 and 16, and clips after step 8


def _leaves(seed=0):
    """A scalar, a vector, two matrices, one leaf past param_max_rms and one
    under param_min_rms, in the order of JAX's (sorted) tree."""
    rng = np.random.default_rng(seed)
    return {
        "a_scalar": np.array(0.7, np.float32),
        "b_vector": rng.normal(size=(7,)).astype(np.float32),
        "c_matrix": (0.2 * rng.normal(size=(6, 5))).astype(np.float32),
        "d_big": (5.0 * rng.normal(size=(4, 3))).astype(np.float32),
        "e_tiny": (1e-7 * rng.normal(size=(3, 2))).astype(np.float32),
        "f_stack": (0.05 * rng.normal(size=(2, 3, 4))).astype(np.float32),
    }


def _grads(params, step):
    """Seeded gradients; every 5th step a spike, so the clip engages."""
    rng = np.random.default_rng(1000 + step)
    spike = 20.0 if step % 5 == 4 else 1.0
    return {k: np.asarray(spike * rng.normal(size=v.shape), np.float32)
            for k, v in params.items()}


def _run(j_tx, make_port, steps=STEPS):
    """Both optimizers over the gradient sequence; yields (step, port
    params, JAX params) after every step."""
    p0 = _leaves()
    jp = jax.tree.map(jnp.asarray, p0)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = make_port(list(tp.values()))
    state = j_tx.init(jp)
    update = jax.jit(j_tx.update)
    for step in range(steps):
        g = _grads(p0, step)
        updates, state = update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        yield step, tp, jp, opt


def _assert_params_close(step, tp, jp):
    for k, p in tp.items():
        want = np.asarray(jp[k])
        np.testing.assert_allclose(
            p.detach().numpy(), want, rtol=1e-5,
            atol=1e-7 * max(np.abs(want).max(), 1e-30), err_msg=f"{k} @ {step}")


def test_eden_and_linear_schedules_match_jax():
    eden = [(0.05, 3000, 4, 500.0, 3000), (0.02, 50, 2, 0.0, 10),
            (0.1, 10, 1, 7.0, 4)]
    for args in eden:
        j, t = jopt.eden_schedule(*args), topt.eden_schedule(*args)
        for step in list(range(0, 40)) + [499, 500, 2999, 3000, 12345]:
            np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6)
    for args in [(0.01, 1000, 10.0), (1e-3, 50, 0.0), (0.1, 20, 25.0)]:
        j, t = jopt.linear_warmup_decay(*args), topt.linear_warmup_decay(*args)
        for step in list(range(0, 60)) + [999, 1000, 1200]:
            np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6,
                                       atol=1e-12)


@pytest.mark.parametrize("clipping_scale", [2.0, None])
def test_scaled_adam_matches_jax(clipping_scale):
    """Over three clipping periods (threshold refreshes, clipped scale
    gradients, size updates every 4 steps, the bc2 < 0.99 switch)."""
    lr = (0.05, 10, 2, 5.0, 12)
    kw = dict(betas=(0.9, 0.95), clipping_scale=clipping_scale,
              clipping_update_period=CLIP_PERIOD)
    j_tx = jopt.scaled_adam(lr=jopt.eden_schedule(*lr), **kw)
    clipped = False
    for step, tp, jp, opt in _run(
            j_tx, lambda ps: topt.ScaledAdam(ps, lr=topt.eden_schedule(*lr),
                                             **kw)):
        _assert_params_close(step, tp, jp)
        if clipping_scale and step >= CLIP_PERIOD:
            clipped |= bool(opt.model_norm_threshold
                            < opt.model_norms[step % CLIP_PERIOD])
    assert clipped or clipping_scale is None
    assert opt.count == STEPS


def test_scaled_adam_state_round_trip():
    """A state_dict taken mid-run and loaded into a fresh optimizer (over
    copies of the parameters) continues bit for bit."""
    lr = (0.05, 10, 2, 5.0, 12)
    kw = dict(clipping_update_period=CLIP_PERIOD)
    j_tx = jopt.scaled_adam(lr=jopt.eden_schedule(*lr), **kw)
    make = lambda ps: topt.ScaledAdam(ps, lr=topt.eden_schedule(*lr), **kw)
    run = _run(j_tx, make, steps=STEPS)
    for step, tp, _, opt in run:
        if step == CLIP_PERIOD + 1:
            break
    saved = copy.deepcopy(opt.state_dict())
    clone = {k: p.detach().clone().requires_grad_() for k, p in tp.items()}
    opt2 = make(list(clone.values()))
    opt2.load_state_dict(saved)
    for step in range(CLIP_PERIOD + 2, STEPS):
        g = _grads(_leaves(), step)
        for ps, o in ((tp, opt), (clone, opt2)):
            for k, p in ps.items():
                p.grad = torch.from_numpy(g[k])
            o.step()
    for k in tp:
        assert torch.equal(tp[k], clone[k]), k


@pytest.mark.parametrize("schedule", ["constant", "linear"])
def test_adamw_matches_optax(schedule):
    if schedule == "constant":
        j_lr, t_lr = 1e-2, 1e-2
    else:
        j_lr = jopt.linear_warmup_decay(0.02, 30, 5.0)
        t_lr = topt.linear_warmup_decay(0.02, 30, 5.0)
    j_tx = jopt.adamw_reference(j_lr, weight_decay=0.1)
    lr = t_lr if callable(t_lr) else (lambda _: t_lr)
    exact = {k: v.astype(np.float64) for k, v in _leaves().items()}
    m = {k: np.zeros_like(v) for k, v in exact.items()}
    v = {k: np.zeros_like(x) for k, x in exact.items()}
    travel = 0.0
    for step, tp, jp, _ in _run(
            j_tx, lambda ps: topt.AdamW(ps, t_lr, weight_decay=0.1), steps=12):
        travel += lr(step)
        g = _grads(_leaves(), step)
        for k, p in tp.items():
            gk = g[k].astype(np.float64)
            m[k] = 0.9 * m[k] + 0.1 * gk
            v[k] = 0.999 * v[k] + 0.001 * gk * gk
            mh, vh = m[k] / (1 - 0.9 ** (step + 1)), v[k] / (1 - 0.999 ** (step + 1))
            exact[k] = exact[k] - lr(step) * (mh / (np.sqrt(vh) + 1e-8)
                                              + 0.1 * exact[k])
            got = p.detach().numpy()
            np.testing.assert_allclose(got, np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-5 * travel + 1e-12,
                                       err_msg=f"{k} @ {step} vs optax")
            np.testing.assert_allclose(got, exact[k], rtol=1e-6,
                                       atol=1e-6 * travel + 1e-12,
                                       err_msg=f"{k} @ {step} vs float64")
