"""The port's training forward (models/voicecraft.py:forward_train, the
stack's apply_stack with its recompute policies, ops/flash_attention.py:
chunked_attention and the dense mha with dropout) against the JAX package's
forward_train and jax.grad, in f32 on the CPU at tiny_test width.

Tolerances: loss, top10acc, top10acc_by_codebook, effective_ntoken,
mtp_loss and mtp_top1acc within rel 1e-5; every parameter's gradient
within 1e-4 x that tensor's largest |gradient| (tests/torch_train_helpers.py:
assert_grads_close); the recompute policies and dropout under recompute
give bit-identical gradients."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from voicecraft_tpu.models.voicecraft import forward_train as jax_forward_train
from voicecraft_tpu_torch.models.voicecraft import forward_train
from voicecraft_tpu_torch.models.transformer import REMAT_POLICIES
from voicecraft_tpu_torch.ops.attention import dropout
from tests.test_torch_spec import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_train_helpers import (assert_grads_close, batch_arrays,
                                       configs, jax_batch, jax_params,
                                       jax_state, port_model, torch_batch)

WEIGHTS = (5.0, 1.0, 0.5, 0.1)
DROPOUTS = dict(text_embedding_dropout=0.1,
                text_positional_embedding_dropout=0.1,
                audio_positional_embedding_dropout=0.1, trm_dropout=0.1)
METRICS = ("loss", "top10acc", "top10acc_by_codebook", "effective_ntoken")

# (train_attn, codebook_weight, n_mtp, mtp_detach)
CASES = {
    "dense": ("dense", None, 0, 1),
    "chunked-weighted": ("chunked", WEIGHTS, 0, 1),
    "dense-weighted-mtp-detach": ("dense", WEIGHTS, 3, 1),
    "chunked-mtp-attached": ("chunked", None, 3, 0),
}


@pytest.fixture(scope="module")
def arrays():
    return batch_arrays(configs()[1], seed=0, B=3)


def _configs(case):
    attn, w, n_mtp, detach = CASES[case]
    return configs(n_mtp, train_attn=attn, codebook_weight=w,
                   mtp_detach=detach)


@pytest.fixture(scope="module")
def jax_results(arrays):
    """JAX's loss, metrics and gradients per case (one jit each)."""
    out = {}
    for case in CASES:
        jcfg, _ = _configs(case)
        params = jax_params(jcfg)

        def loss_fn(p, jcfg=jcfg):
            o = jax_forward_train(p, jcfg, jax_batch(arrays), rng=None,
                                  remat=True)
            return o["loss"], o
        (_, o), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        out[case] = (params, jax.tree.map(np.asarray, o), g)
    return out


def _port_forward(tcfg, params, arrays, seed=None, remat=True):
    model = port_model(tcfg, params)
    out = forward_train(model, torch_batch(arrays), seed=seed, remat=remat)
    out["loss"].backward()
    return model, out


@pytest.mark.parametrize("case", list(CASES))
def test_forward_train_matches_jax(case, arrays, jax_results):
    jcfg, tcfg = _configs(case)
    params, want, jgrads = jax_results[case]
    model, got = _port_forward(tcfg, params, arrays)
    keys = METRICS + (("mtp_loss", "mtp_top1acc") if tcfg.n_mtp else ())
    assert set(got) == set(want)
    for k in keys:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k],
                                   rtol=1e-5, err_msg=k)
    assert got["loss"].item() > 0 and got["effective_ntoken"].item() > 0
    assert_grads_close(model, jax_state(jgrads, tcfg))
    if tcfg.n_mtp:
        # the MTP heads train; with mtp_detach the base sees none of their loss
        assert all(p.grad.abs().max() > 0
                   for p in model.mtp_heads.parameters())


def test_mtp_detach_keeps_base_grads(arrays):
    """mtp_detach=1: the base model's gradients equal those of the main
    loss alone."""
    _, tcfg = configs(3, mtp_detach=1)
    jcfg0, tcfg0 = configs(0)
    params = jax_params(dataclasses.replace(jcfg0, n_mtp=3))
    with_mtp, _ = _port_forward(tcfg, params, arrays)
    base = {k: v for k, v in params.items() if k != "mtp_heads"}
    without, _ = _port_forward(tcfg0, base, arrays)
    grads = dict(without.named_parameters())
    for name, p in with_mtp.named_parameters():
        if not name.startswith("mtp_heads."):
            torch.testing.assert_close(p.grad, grads[name].grad, rtol=0, atol=0)


@pytest.mark.parametrize("weights", [None, WEIGHTS])
def test_chunked_equals_dense(arrays, weights):
    _, dense_cfg = configs(train_attn="dense", codebook_weight=weights)
    params = jax_params(configs()[0])
    dense, d = _port_forward(dense_cfg, params, arrays)
    chunked, c = _port_forward(
        dataclasses.replace(dense_cfg, train_attn="chunked"), params, arrays)
    for k in METRICS:
        np.testing.assert_allclose(c[k].detach().numpy(),
                                   d[k].detach().numpy(), rtol=1e-5)
    assert_grads_close(chunked, {n: p.grad for n, p in dense.named_parameters()})


@pytest.mark.parametrize("chunk", [7, 32, 256])
def test_chunked_attention_chunks_match_jax(chunk):
    """chunked_attention over several query chunks (later chunks' causal
    offset, a ragged last chunk at 7 and 32) against the JAX package's
    chunked_attention (which shrinks its chunk to a divisor of S): the
    output and the gradients of q, k and v for one random cotangent,
    within 1e-5 of each tensor's largest |value|."""
    from voicecraft_tpu.ops.flash_attention import (
        chunked_attention as jax_chunked)
    from voicecraft_tpu_torch.ops.flash_attention import chunked_attention
    rng = np.random.default_rng(chunk)
    B, S, D, H, x_pad = 2, 100, 32, 4, 24
    q, k, v, ct = (rng.standard_normal((B, S, D), dtype=np.float32)
                   for _ in range(4))
    x_lens = np.array([24, 11], np.int32)
    y_lens = np.array([76, 40], np.int32)

    def jax_fn(q, k, v):
        return jax_chunked(q, k, v, x_lens, y_lens, x_pad, H, chunk=chunk)
    want, vjp = jax.vjp(jax_fn, q, k, v)
    want_grads = vjp(ct)

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = chunked_attention(tq, tk, tv, torch.tensor(x_lens),
                            torch.tensor(y_lens), x_pad, H, chunk=chunk)
    got.backward(torch.tensor(ct))
    for g, w in zip((got, tq.grad, tk.grad, tv.grad),
                    (want,) + tuple(want_grads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def _grads(tcfg, params, arrays, seed, remat=True):
    model, out = _port_forward(tcfg, params, arrays, seed=seed, remat=remat)
    return out["loss"].item(), {n: p.grad.clone()
                                for n, p in model.named_parameters()}


@pytest.mark.parametrize("attn", ["dense", "chunked"])
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no-dropout", "dropout"])
def test_remat_policies_give_equal_grads(arrays, attn, rate):
    """Every recompute policy against none, bit for bit, with dropout off
    and on (the same seed): a dropout mask drawn in a checkpointed region
    comes out the same when the backward recomputes it."""
    drops = {k: rate for k in DROPOUTS}
    _, tcfg = configs(3, train_attn=attn, mtp_detach=0, **drops)
    params = jax_params(configs(3)[0])
    ref_loss, ref = _grads(tcfg, params, arrays, seed=7, remat=False)
    for policy in REMAT_POLICIES:
        loss, got = _grads(dataclasses.replace(tcfg, train_remat=policy),
                           params, arrays, seed=7)
        assert loss == ref_loss, policy
        for name, g in got.items():
            assert torch.equal(g, ref[name]), (policy, name)


def test_dropout_keep_rate_and_scale():
    x = torch.ones(400, 2500)
    y = dropout(x, 0.1, seed=3)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 2e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(dropout(x, 0.1, seed=3), y)        # seeded
    assert not torch.equal(dropout(x, 0.1, seed=4), y)
    assert dropout(x, 0.1, seed=None) is x                 # eval
    assert dropout(x, 0.0, seed=3) is x


def test_dropout_changes_training_and_eval_ignores_it(arrays):
    """Dropout on: the seed changes the loss; with no seed the forward
    equals the forward of the same weights with every rate at 0."""
    _, plain = configs()
    noisy = dataclasses.replace(plain, **DROPOUTS)
    params = jax_params(configs()[0])
    model = port_model(noisy, params)
    with torch.no_grad():
        ev = forward_train(model, torch_batch(arrays), seed=None)
        s1 = forward_train(model, torch_batch(arrays), seed=1)
        s2 = forward_train(model, torch_batch(arrays), seed=2)
        ref = forward_train(port_model(plain, params), torch_batch(arrays),
                            seed=1)
    for k in METRICS:
        assert torch.equal(ev[k], ref[k]), k
    assert s1["loss"] != s2["loss"] and s1["loss"] != ev["loss"]
