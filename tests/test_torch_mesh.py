"""The port's mesh (voicecraft_tpu_torch/parallel/mesh.py) against the JAX
package's (voicecraft_tpu/parallel/mesh.py), on the CPU at tiny_test in f32.

In process: the placement of every parameter (every norm family, the MTP
heads) equals JAX's ``param_pspecs``; ``_extend_with_data`` and
``batch_pspec`` are JAX's; ZeRO-1 of a state it does not support is None.
Over 4 gloo processes (tests/torch_mesh_helpers.py, spawned once), against
JAX's steps on conftest's 8-device CPU mesh: shard -> gather bit for bit;
forward_train's loss (1e-5 relative) and gradients (1e-4) at 2 x 2, and
with dropout on the model ranks in step; 3
ScaledAdam steps with ZeRO-1 at 4 x 1 and 2 x 2 (1e-5, but for the few
elements whose gradient sums to within rounding of zero: see FLIP_SHARE),
the two-phase step and train_mtp_only; ZeRO-1 against replicated moments
in the port (bit for bit), its state gathered and re-loaded.
"""


import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from __graft_entry__ import _synthetic_batch
from voicecraft_tpu.models.voicecraft import forward_train as jax_forward
from voicecraft_tpu.models.voicecraft import init_params
from voicecraft_tpu.parallel import mesh as jmesh
from voicecraft_tpu.training.optim import scaled_adam
from voicecraft_tpu.training.step import (make_train_step,
                                          make_train_step_two_phase)
from voicecraft_tpu_torch.models.transformer import FFN_KEYS
from voicecraft_tpu_torch.models.voicecraft import VoiceCraft
from voicecraft_tpu_torch.parallel import mesh as pm
from voicecraft_tpu_torch.training.optim import (AdamW, ScaledAdam, _jax_path,
                                                 stacked_leaves)
from torch_mesh_helpers import Spawned, numpy_state, train_worker
from torch_train_helpers import assert_grad_dicts_close, configs, jax_state

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs conftest's 8 CPU devices")

STEPS = 3


def _strip(spec) -> tuple:
    s = tuple(spec)
    while s and s[-1] is None:
        s = s[:-1]
    return s


@pytest.mark.parametrize("norm,act", [
    ("layernorm", "relu"), ("basicnorm", "doubleswish"),
    ("balancedbasicnorm", "gelu"), ("identity", "balanceddoubleswish")])
def test_param_placement_matches_jax(norm, act):
    """Every parameter's placement, the MTP heads' too, equals the JAX
    package's param_pspecs at its tree path (the stacked layer axis of a
    decoder or MTP leaf dropped)."""
    jcfg, tcfg = configs(n_mtp=2, norm=norm, ffn_activation=act)
    specs = {"/".join(str(getattr(k, "key", k)) for k in path): _strip(spec)
             for path, spec in jax.tree_util.tree_flatten_with_path(
                 jmesh.param_pspecs(init_params(jcfg, jax.random.PRNGKey(0))),
                 is_leaf=lambda x: isinstance(x, P))[0]}
    model = VoiceCraft(tcfg, "cpu")
    port = pm.param_pspecs(model)
    assert {_jax_path(n, FFN_KEYS[act])[0] for n in port} == set(specs)
    for name, spec in port.items():
        path, _ = _jax_path(name, FFN_KEYS[act])
        want = specs[path]
        if name.startswith(("decoder.layers.", "mtp_heads.")):
            want = want[1:]            # the stacked axis
        assert _strip(spec) == want, (name, spec, want)


def test_extend_with_data_and_batch_pspec_match_jax():
    for spec, shape, dp in (((None, None, "model"), (16, 2048, 2048), 4),
                            (("model", None), (8192, 2048), 4),
                            ((), (3,), 4), ((), (), 2),
                            ((None, "model"), (4, 1024), 2),
                            ((None, None), (2, 6), 4)):
        assert pm._extend_with_data(spec, shape, dp) == tuple(
            jmesh._extend_with_data(P(*spec), shape, dp)), (spec, shape)
    for nd in (1, 2, 4):
        assert pm.batch_pspec(nd) == tuple(jmesh.batch_pspec(nd))


def test_zero1_unsupported_state_returns_none():
    """As JAX's: an optimizer ZeRO-1 does not know, or a data axis of 1."""
    model = VoiceCraft(configs()[1], "cpu", trainable=True)
    params = [p for p in model.parameters() if p.requires_grad]
    four = type("M", (), {"n_data": 4})()
    assert pm.zero1_opt_shardings(model, torch.optim.SGD(params, lr=0.1),
                                  four) is None
    one = type("M", (), {"n_data": 1})()
    assert pm.zero1_opt_shardings(model, ScaledAdam(stacked_leaves(model),
                                                    lr=0.05), one) is None
    lays = pm.zero1_opt_shardings(model, AdamW(
        params, 0.01, groups=stacked_leaves(model)), four)
    assert lays is not None and any(l.data_axis is not None for l in lays)


# ---- over 4 gloo processes, against JAX's mesh ---------------------------------------

def _jax_run(jcfg, params, batch, mesh, zero1=True, two_phase=False,
             mtp_only=False):
    """STEPS JAX ScaledAdam steps on ``mesh`` (tests/test_zero1.py's
    layout); mtp_only masks every leaf but the MTP heads, as the trainer
    does.  Returns (params, losses)."""
    tx, labels = scaled_adam(lr=0.05), None
    if mtp_only:
        labels = {k: jax.tree.map(
            lambda _: "train" if k == "mtp_heads" else "freeze", v)
            for k, v in params.items()}
        tx = optax.multi_transform({"train": tx,
                                    "freeze": optax.set_to_zero()}, labels)
    params = jmesh.shard_params(params, mesh)
    param_sh = jmesh.param_shardings(params, mesh)
    batch = jmesh.shard_batch(batch, mesh)
    opt_state = jax.jit(tx.init)(params)
    opt_sh = None
    if zero1:
        opt_sh = jmesh.zero1_opt_shardings(params, opt_state, mesh,
                                           labels=labels)
        opt_state = jax.device_put(opt_state, opt_sh)
    make = make_train_step_two_phase if two_phase else make_train_step
    step = make(jcfg, tx, param_shardings=param_sh, opt_shardings=opt_sh)
    losses = []
    for i in range(STEPS):
        params, opt_state, m = step(params, opt_state, batch,
                                    jax.random.PRNGKey(100 + i))
        losses.append(float(np.asarray(m["loss"])))
    return params, losses


@pytest.fixture(scope="module")
def runs():
    """The port's scenarios over 4 gloo processes (started first) and JAX's
    on its CPU mesh meanwhile."""
    jcfg, tcfg = configs()
    params = init_params(jcfg, jax.random.PRNGKey(0))
    jcfg_m, tcfg_m = configs(n_mtp=2)
    params_m = init_params(jcfg_m, jax.random.PRNGKey(0))
    batch = _synthetic_batch(jcfg, B=8, Sx=16, y_len=40, seed=5)
    arrays = tuple(np.asarray(a) for a in batch)
    state = numpy_state(jax_state(params, tcfg))
    handle = Spawned(4, train_worker, state,
                     numpy_state(jax_state(params_m, tcfg_m)), arrays)

    try:
        want = _jax_side(jcfg, tcfg, jcfg_m, tcfg_m, batch)
    except BaseException:
        handle.kill()
        raise
    ranks = handle.results()
    return ranks[0], want, state, ranks


def _jax_side(jcfg, tcfg, jcfg_m, tcfg_m, batch):
    """JAX's loss, gradients and trajectories (its steps donate their
    parameters: each run starts from a fresh init)."""
    params = lambda c: init_params(c, jax.random.PRNGKey(0))
    want = {}
    m22, m41 = jmesh.make_mesh(2, 2), jmesh.make_mesh(4, 1)

    def loss_fn(p, b):
        out = jax_forward(p, jcfg, b, rng=None, remat=False)
        return out["loss"], out
    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jmesh.shard_params(params(jcfg), m22), jmesh.shard_batch(batch, m22))
    want["loss"] = float(loss)
    want["effective_ntoken"] = float(out["effective_ntoken"])
    want["grads"] = jax_state(grads, tcfg)
    for name, mesh, kw in (("4x1 zero1", m41, {}), ("2x2 zero1", m22, {}),
                           ("2x2 two-phase", m22, {"two_phase": True})):
        p, losses = _jax_run(jcfg, params(jcfg), batch, mesh, **kw)
        want[name] = dict(losses=losses, params=jax_state(p, tcfg))
    p, losses = _jax_run(jcfg_m, params(jcfg_m), batch, m41, mtp_only=True)
    want["mtp_only"] = dict(losses=losses, params=jax_state(p, tcfg_m))
    return want


# ScaledAdam's first updates are g / sqrt(g^2): where a gradient's sum lies
# within its rounding of zero, the two meshes' summation orders can flip
# its sign, and the element's STEPS updates of lr (1 - beta1) rms apart by
# up to twice their size.  Such elements, at most FLIP_SHARE of a tensor,
# are held within that (at most FLIP_SHARE of all elements); all others
# within the stated tolerance.
FLIP_SHARE, LR, BETA1 = 1e-3, 0.05, 0.9


def _assert_params_close(got: dict, want: dict, atol: float, rtol: float):
    off, n = 0, 0
    for k, w in want.items():
        g, w = got[k], w.numpy()
        off += int((~np.isclose(g, w, rtol=rtol, atol=atol)).sum())
        n += w.size
        rms = max(float(np.sqrt(np.mean(np.square(w)))), 1e-5)
        flip = 2 * STEPS * LR * (1 - BETA1) * rms
        np.testing.assert_allclose(g, w, rtol=0, atol=max(flip, atol),
                                   err_msg=k)
    assert off <= FLIP_SHARE * n, (off, n)


def test_shard_then_gather_is_bit_equal(runs):
    port = runs[0]
    assert port["round_trip"]


def test_tp_loss_and_grads_match_jax(runs):
    """forward_train at 2 x 2 (each data rank's rows, heads and FFN columns
    over 'model'): the global loss within 1e-5 and the gradients, summed
    over 'data' and gathered over 'model', within 1e-4 of JAX's."""
    port, want = runs[:2]
    assert port["effective_ntoken"] == want["effective_ntoken"]
    assert abs(port["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert_grad_dicts_close({k: torch.from_numpy(v)
                             for k, v in port["grads"].items()},
                            want["grads"], rtol=1e-4)


@pytest.mark.parametrize("name", ["4x1 zero1", "2x2 zero1"])
def test_zero1_trajectory_matches_jax(runs, name):
    port, want = runs[:2]
    np.testing.assert_allclose(port[name]["losses"], want[name]["losses"],
                               rtol=1e-5)
    _assert_params_close(port[name]["params"], want[name]["params"],
                         atol=1e-5, rtol=1e-5)


def test_zero1_matches_replicated(runs):
    """The same 3 steps at 2 x 2 with the moments sharded over 'data' and
    replicated: both layouts sum the gradients through one reduce-scatter
    and every per-leaf sum from the same pieces in rank order, so the
    losses, the parameters and the gathered moments are bit for bit
    alike, as the JAX package's (tests/test_zero1.py)."""
    port = runs[0]
    a, b = port["2x2 zero1"], port["2x2 replicated"]
    np.testing.assert_array_equal(a["losses"], b["losses"])
    assert a["params"].keys() == b["params"].keys()
    for k, v in b["params"].items():
        np.testing.assert_array_equal(a["params"][k], v, err_msg=k)
    assert len(a["moments"]) == len(b["moments"])
    for x, y in zip(a["moments"], b["moments"]):
        np.testing.assert_array_equal(x, y)


def test_two_phase_step_matches_jax(runs):
    """The port's two-phase step is its fused one (an eager step computes
    every gradient before the update): the 2 x 2 ZeRO-1 trajectory against
    JAX's two-phase step."""
    port, want = runs[:2]
    np.testing.assert_allclose(port["2x2 zero1"]["losses"],
                               want["2x2 two-phase"]["losses"], rtol=1e-5)
    _assert_params_close(port["2x2 zero1"]["params"],
                         want["2x2 two-phase"]["params"], atol=1e-5,
                         rtol=1e-5)


def test_zero1_state_reloads(runs):
    """The ZeRO-1 state gathered (mesh-independent) loads into a fresh
    sharded optimizer and gathers back bit for bit."""
    port = runs[0]
    assert port["reload"]


def test_mtp_only_with_zero1_matches_jax(runs):
    """train_mtp_only at 4 x 1: ZeRO-1 shards the trained heads' moments;
    the base stays bit for bit, the heads follow JAX's masked ScaledAdam."""
    port, want = runs[:2]
    res = port["mtp_only"]
    assert any(a is not None for a in res["sharded"])
    np.testing.assert_allclose(res["losses"], want["mtp_only"]["losses"],
                               rtol=1e-5)
    _assert_params_close(res["params"], want["mtp_only"]["params"],
                         atol=1e-5, rtol=1e-5)


def test_dropout_keeps_model_ranks_in_step(runs):
    """With dropout on at 2 x 2, ranks 0 and 1 (one data row's model
    ranks) draw the same residual masks: a finite global loss, and the
    replicated parameters' gradients bit for bit alike on both."""
    ranks = runs[3]
    a, b = ranks[0]["dropout"], ranks[1]["dropout"]
    assert np.isfinite(a["loss"]) and a["loss"] == b["loss"]
    assert a["grads"].keys() == b["grads"].keys() and a["grads"]
    for k, g in a["grads"].items():
        np.testing.assert_array_equal(g, b["grads"][k], err_msg=k)
