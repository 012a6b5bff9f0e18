"""The port's train step (voicecraft_tpu_torch/training/step.py) against
the JAX package's make_train_step, and its accumulation, padding,
normalisation and NaN-skip semantics, in f32 on the CPU at tiny_test width.

Parameters after each step agree with JAX's within rel 1e-5 of each
element plus 1e-5 of the tensor's largest |value| (an element passing near
zero); the key biases, whose gradient is zero in exact arithmetic (f32
noise on both sides, which the optimizer's normalisation turns into steps
of lr x 0.1 x param_min_rms), within 1e-6.  The port's ScaledAdam sees the
JAX package's leaves: each decoder parameter stacked over the layers
(training/optim.py:stacked_leaves)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.training.optim import eden_schedule as jax_eden
from voicecraft_tpu.training.optim import scaled_adam
from voicecraft_tpu.training.step import make_train_step as jax_make_step
from voicecraft_tpu_torch.models.voicecraft import forward_train
from voicecraft_tpu_torch.training.optim import (ScaledAdam, eden_schedule,
                                                 stacked_leaves)
from voicecraft_tpu_torch.training.step import (make_train_step,
                                                make_train_step_two_phase)
from voicecraft_tpu_torch.training.trainer import _pad_batch
from tests.test_torch_spec import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_train_helpers import (assert_grad_dicts_close,
                                       assert_grads_close, batch_arrays,
                                       configs, jax_batch, jax_params,
                                       jax_state, port_model, torch_batch)

LR = (0.05, 10, 2, 2.0, 12)        # an Eden schedule that warms up in 2 steps


def _step_setup(n_mtp=0, grad_accum=1, normalize=False, **kw):
    jcfg, tcfg = configs(n_mtp, **kw)
    params = jax_params(jcfg)
    model = port_model(tcfg, params)
    opt = ScaledAdam(stacked_leaves(model), lr=eden_schedule(*LR),
                     clipping_update_period=4)
    step = make_train_step(model, opt, grad_accum=grad_accum,
                           normalize_loss=normalize)
    return jcfg, tcfg, params, model, opt, step


def _assert_params_match(model, want: dict, step: int):
    for name, p in model.named_parameters():
        w = want[name]
        got = p.detach()
        if name.endswith(".bk"):
            assert (got - w).abs().max() <= 1e-6, (name, step)
            continue
        torch.testing.assert_close(got, w, rtol=1e-5,
                                   atol=1e-5 * w.abs().max().item(),
                                   msg=f"{name} after step {step}")


@pytest.mark.parametrize("n_mtp,grad_accum", [(0, 1), (3, 2)],
                         ids=["plain", "mtp-accum2"])
def test_train_step_matches_jax(n_mtp, grad_accum):
    """Three ScaledAdam steps on three batches: the parameters and every
    metric of JAX's step."""
    jcfg, tcfg, params, model, _, step = _step_setup(n_mtp, grad_accum,
                                                     train_attn="chunked")
    tx = scaled_adam(lr=jax_eden(*LR), clipping_update_period=4)
    jstep = jax_make_step(jcfg, tx, remat=True, grad_accum=grad_accum)
    jp = jax.tree.map(jnp.copy, params)
    js = tx.init(jp)
    for i in range(3):
        arrays = batch_arrays(tcfg, seed=10 + i, B=4)
        jp, js, jm = jstep(jp, js, jax_batch(arrays), jax.random.PRNGKey(i))
        m = step(torch_batch(arrays), seed=i)
        assert set(m) == set(jm)
        for k, v in jm.items():
            np.testing.assert_allclose(np.asarray(m[k], np.float64),
                                       np.asarray(v, np.float64), rtol=1e-5,
                                       err_msg=k)
        _assert_params_match(model, jax_state(jp, tcfg), i)


def _grads(model, batch, seed=None):
    for p in model.parameters():
        p.grad = None
    out = forward_train(model, batch, seed=seed)
    out["loss"].backward()
    return out, {n: p.grad.clone() for n, p in model.named_parameters()}


def test_grad_accum_sums_stripe_grads():
    """grad_accum=2: the step's gradients are the sum of the two stripes'
    (rows 0-1 and 2-3), each stripe with its own dropout seed."""
    _, tcfg, _, model, opt, step = _step_setup(
        grad_accum=2, trm_dropout=0.1, text_embedding_dropout=0.1)
    batch = torch_batch(batch_arrays(tcfg, seed=3, B=4))
    ref = copy.deepcopy(model)
    m = step(batch, seed=5)
    got = {n: p.grad for n, p in model.named_parameters()}
    from voicecraft_tpu_torch.models.transformer import fold_seed
    outs, sums = [], None
    for i in range(2):
        half = type(batch)(*(t[2 * i:2 * i + 2] for t in batch))
        out, g = _grads(ref, half, fold_seed(5, i))
        outs.append(out)
        sums = g if sums is None else {n: sums[n] + g[n] for n in g}
    assert_grad_dicts_close(got, sums)
    assert m["loss"].item() == pytest.approx(
        sum(o["loss"].item() for o in outs), rel=1e-6)
    assert int(m["effective_ntoken"]) == sum(int(o["effective_ntoken"])
                                             for o in outs)


def test_padded_rows_contribute_nothing():
    _, tcfg, _, model, _, _ = _step_setup()
    batch = torch_batch(batch_arrays(tcfg, seed=4, B=3))
    out, g = _grads(model, batch)
    padded = _pad_batch(batch, 6)
    assert padded.x.shape[0] == 6 and not padded.target_valid[3:].any()
    out6, g6 = _grads(model, padded)
    assert out6["loss"].item() == pytest.approx(out["loss"].item(), rel=1e-6)
    assert int(out6["effective_ntoken"]) == int(out["effective_ntoken"])
    assert_grad_dicts_close(g6, g)


def test_normalize_loss_divides_grads_by_ntok():
    _, tcfg, _, model, opt, step = _step_setup(normalize=True)
    batch = torch_batch(batch_arrays(tcfg, seed=6, B=2))
    ref = copy.deepcopy(model)
    m = step(batch, seed=None)
    out, raw = _grads(ref, batch)
    ntok = int(out["effective_ntoken"])
    assert int(m["effective_ntoken"]) == ntok > 1
    assert m["loss"].item() == pytest.approx(out["loss"].item(), rel=1e-6)
    assert_grads_close(model, {n: g / ntok for n, g in raw.items()})


def test_nan_batch_skips_the_update():
    """A batch whose loss is NaN (a NaN positional row, a buffer and no
    parameter) leaves every parameter and the optimizer's state
    bit-identical, and reports is_nan."""
    _, tcfg, _, model, opt, step = _step_setup()
    batch = torch_batch(batch_arrays(tcfg, seed=7, B=2))
    step(batch, seed=1)                            # a state that is not fresh
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = copy.deepcopy(opt.state_dict())
    pe = model.pe.clone()
    model.pe[3] = float("nan")
    m = step(batch, seed=2)
    assert m["is_nan"] == 1.0 and not np.isfinite(m["loss"].item())
    for n, p in model.named_parameters():
        assert torch.equal(p, params[n]), n
    new = opt.state_dict()
    assert new["count"] == state["count"] == 1
    assert torch.equal(new["model_norms"], state["model_norms"])
    for a, b in zip(new["leaves"], state["leaves"]):
        for k in a:
            for x, y in zip(*((v if isinstance(v, list) else [v])
                              for v in (a[k], b[k]))):
                assert torch.equal(x, y), k
    model.pe.copy_(pe)
    assert step(batch, seed=3)["is_nan"] == 0.0


def test_two_phase_step_equals_step():
    _, tcfg, params, model, _, step = _step_setup(3)
    model2 = port_model(tcfg, params)
    opt2 = ScaledAdam(stacked_leaves(model2), lr=eden_schedule(*LR),
                      clipping_update_period=4)
    step2 = make_train_step_two_phase(model2, opt2)
    for i in range(2):
        batch = torch_batch(batch_arrays(tcfg, seed=20 + i, B=2))
        m1, m2 = step(batch, seed=i), step2(batch, seed=i)
        for k in m1:
            assert np.array_equal(np.asarray(m1[k]), np.asarray(m2[k])), k
    for (n, p), p2 in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(p, p2), n
