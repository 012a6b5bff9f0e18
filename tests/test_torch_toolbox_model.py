"""Models built with the icefall toolbox (ModelConfig.norm /
ffn_activation): the port against the JAX package on the same weights, in
f32 on the CPU at tiny_test width, for the JAX test's three pairs
(tests/test_scaling.py) and the identity norm.

Tolerances: forward_train's loss within rel 1e-5 and every gradient within
1e-4 of that tensor's largest |gradient| (torch_train_helpers.
assert_grads_close), in the eval form (no dropout key) and the train form
(a key, dropout rates 0: BasicNorm's expected ballast); prefill and decode
hidden states within 2e-4; greedy TTS under the tie-aware rule (equal up to
the first step whose top-2 logit margin is under 1e-3); a serving wave and
an engine run equal to JAX's (both f32); ScaledAdam's parameters within
rel 1e-5 and its state within rel 1e-5 (plus 1e-6 of the leaf's largest
|value|, for the f32 rounding of elements near zero) after 3 steps."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test as jax_tiny
from voicecraft_tpu.data import spans as jspans
from voicecraft_tpu.inference import engine as jeng
from voicecraft_tpu.inference import serving as jsv
from voicecraft_tpu.inference import tts as jtts
from voicecraft_tpu.models import transformer as jtrm
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu.models.voicecraft import forward_train as jax_forward_train
from voicecraft_tpu.ops.attention import NEG_INF as J_NEG_INF
from voicecraft_tpu.training import optim as jopt
from voicecraft_tpu.utils.quantize import quantize_decoder_fp8 as jax_fp8
from voicecraft_tpu_torch.config import tiny_test
from voicecraft_tpu_torch.data import spans
from voicecraft_tpu_torch.inference import engine as eng_mod
from voicecraft_tpu_torch.inference import serving as sv
from voicecraft_tpu_torch.inference import tts
from voicecraft_tpu_torch.models import transformer as trm
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.models.voicecraft import forward_train
from voicecraft_tpu_torch.ops.attention import mha
from voicecraft_tpu_torch.training import optim as topt
from voicecraft_tpu_torch.training.step import make_train_step
from voicecraft_tpu_torch.utils.convert import from_jax_params
from voicecraft_tpu_torch.utils.quantize import quantize_decoder_fp8
from tests.test_torch_spec import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_train_helpers import (assert_grad_dicts_close, batch_arrays,
                                       configs, jax_batch, jax_state,
                                       port_model, torch_batch)

PAIRS = [("basicnorm", "doubleswish"),
         ("balancedbasicnorm", "balanceddoubleswish"),
         ("layernorm", "gelu"), ("identity", "relu")]
IDS = ["-".join(p) for p in PAIRS]
NO_DROPOUT = dict(text_embedding_dropout=0.0,
                  text_positional_embedding_dropout=0.0,
                  audio_positional_embedding_dropout=0.0, trm_dropout=0.0)
TIE_MARGIN = 1e-3
TOL = dict(rtol=2e-4, atol=2e-4)
GREEDY = dict(top_k=1, silence_tokens=(5, 7))


def _inference_pair(norm, act, seed=7, **kw):
    """(JAX params, the port's f32 inference model) on the same weights."""
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32", norm=norm,
                              ffn_activation=act, **kw)
    jcfg = dataclasses.replace(jax_tiny(), compute_dtype="float32", norm=norm,
                               ffn_activation=act, **kw)
    params = jvc.init_params(jcfg, jax.random.PRNGKey(seed))
    model = vc.VoiceCraft(cfg, "cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          cfg))
    return jcfg, params, model.eval()


@pytest.fixture(scope="module", params=PAIRS, ids=IDS)
def pair(request):
    return _inference_pair(*request.param)


# ---- parameters -----------------------------------------------------------------

@pytest.mark.parametrize("norm,act", PAIRS, ids=IDS)
def test_from_jax_params_carries_every_family(norm, act):
    jcfg, params, model = _inference_pair(norm, act)
    tree = jax.tree.map(np.asarray, params)
    st = from_jax_params(tree, model.cfg)
    assert set(st) == set(model.state_dict()) - {"pe"}
    for k, v in st.items():
        torch.testing.assert_close(model.state_dict()[k], v.float(), rtol=0,
                                   atol=0, msg=k)
    lay, fin = tree["decoder"]["layers"], tree["decoder"]["final_ln"]
    for site in ("ln1", "ln2"):
        for key, v in lay[site].items():
            for i in range(jcfg.num_decoder_layers):
                np.testing.assert_array_equal(
                    getattr(model.decoder.layers[i], f"{site}_{key}").numpy(),
                    v[i])
    for key, v in fin.items():
        np.testing.assert_array_equal(
            getattr(model.decoder, f"final_ln_{key}").numpy(), v)
    if norm == "identity":
        assert lay["ln1"] == {} and not any(
            n.startswith("layers.0.ln1") for n, _ in
            model.decoder.named_parameters())
        assert model.decoder.norm_kinds["final_ln"] == "layernorm"
    # an FFN projection of another activation is refused
    other = "relu" if act != "relu" else "gelu"
    with pytest.raises(ValueError, match="ffn_activation"):
        from_jax_params(tree, dataclasses.replace(model.cfg,
                                                  ffn_activation=other))


def test_norm_family_init_matches_jax():
    """log_eps = log(1e-5) (not the library's 0.25); the identity stack's
    pre-FFN norm is balancedbasicnorm and its final norm layernorm."""
    for norm in ("basicnorm", "balancedbasicnorm", "identity"):
        cfg = dataclasses.replace(tiny_test(), norm=norm)
        m = vc.VoiceCraft(cfg, "cpu").init_weights(
            torch.Generator().manual_seed(0))
        jl = jtrm.init_layer(jax.random.PRNGKey(0), 16, 32, norm=norm)
        layer = m.decoder.layers[0]
        for site in ("ln1", "ln2"):
            assert set(jl[site]) == {
                n[4:] for n, _ in layer.named_parameters()
                if n.startswith(site)}
            for k, v in jl[site].items():
                assert getattr(layer, f"{site}_{k}").item() == pytest.approx(
                    float(v), rel=1e-6)
        js = jtrm.init_stack(jax.random.PRNGKey(0), 2, 16, 32, norm=norm)
        assert set(js["final_ln"]) == {
            n[len("final_ln_"):] for n, _ in m.decoder.named_parameters()
            if n.startswith("final_ln_")}


@pytest.mark.parametrize("norm,act", list(itertools.product(
    trm.NORM_PARAMS, trm.FFN_ACTS)))
def test_every_family_builds_trains_and_decodes(norm, act):
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32", norm=norm,
                              ffn_activation=act)
    model = vc.VoiceCraft(cfg, "cpu", trainable=True).init_weights(
        torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = topt.ScaledAdam(topt.stacked_leaves(model), lr=0.05)
    m = make_train_step(model, opt)(torch_batch(batch_arrays(cfg, B=2)),
                                    seed=1)
    assert np.isfinite(m["loss"].item()) and not m["is_nan"]
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p, before[n])]
    assert "decoder.layers.0.w1" in moved
    assert all(n in moved for n in before if "log_eps" in n)
    model.requires_grad_(False).eval()
    rng = np.random.default_rng(0)
    x = rng.integers(0, cfg.text_vocab_size, 8).astype(np.int32)
    y = rng.integers(0, cfg.audio_vocab_size, (4, 20)).astype(np.int32)
    full, gen = tts.inference_tts(model, x, y, vc.SamplingConfig(**GREEDY),
                                  gen_max=24)
    np.testing.assert_array_equal(full[:, :20], y)
    assert gen.shape[0] == 4
    if act != "relu":
        with pytest.raises(ValueError, match="relu"):
            tts.inference_tts(model, x, y, vc.SamplingConfig(**GREEDY),
                              gen_max=24, fused_ffn=True)


# ---- training forward -------------------------------------------------------------

@pytest.mark.parametrize("form", ["eval", "train"])
@pytest.mark.parametrize("norm,act", PAIRS, ids=IDS)
def test_forward_train_matches_jax(norm, act, form):
    """Eval form: no dropout key (remat "full").  Train form: a key with
    the dropout rates 0, so only the norms change (remat "dots": the
    balancer and DoubleSwish Functions under selective checkpointing)."""
    remat = "full" if form == "eval" else "dots"
    jcfg, tcfg = configs(norm=norm, ffn_activation=act, train_remat=remat,
                         **NO_DROPOUT)
    params = jvc.init_params(jcfg, jax.random.PRNGKey(0))
    arrays = batch_arrays(tcfg, seed=0, B=3)
    rng = jax.random.PRNGKey(5) if form == "train" else None

    def loss_fn(p):
        o = jax_forward_train(p, jcfg, jax_batch(arrays), rng=rng, remat=True)
        return o["loss"], o
    (_, jo), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = port_model(tcfg, params)
    out = forward_train(model, torch_batch(arrays),
                        seed=3 if form == "train" else None)
    out["loss"].backward()
    for k in ("loss", "top10acc", "effective_ntoken"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jo[k]),
                                   rtol=1e-5, err_msg=k)
    want = jax_state(g, tcfg)
    got = {n: p.grad for n, p in model.named_parameters()}
    # the key biases' gradient is zero in exact arithmetic (a shift shared
    # by a query's logits); both sides hold f32 noise there, which the
    # identity norm's unnormalised inputs make larger than the floor
    bk = [n for n in want if n.endswith(".bk")]
    top = max(v.abs().max().item() for v in want.values())
    for n in bk:
        assert max(got[n].abs().max().item(),
                   want.pop(n).abs().max().item()) <= 1e-5 * top, n
    assert_grad_dicts_close({n: got[n] for n in want}, want)
    if norm != "layernorm" and form == "train":
        # at init log_eps = log(1e-5) < -3: the two forms differ
        ev = forward_train(port_model(tcfg, params), torch_batch(arrays))
        assert abs(ev["loss"].item() - out["loss"].item()) > 1e-4



# ---- prefill and decode -------------------------------------------------------------

def test_prefill_and_decode_match_jax(pair):
    """Prefill (dense, causal with per-lane key padding) then three
    decode_step_fast steps: hidden states and the slab."""
    jcfg, params, model = pair
    cfg = model.cfg
    L, H, Dh, D = cfg.num_decoder_layers, cfg.nhead, cfg.head_dim, cfg.d_model
    B, S, s_max, x_pad, xl = 2, 40, 48, 16, [9, 13]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    jj = np.arange(S)
    allowed = ((jj[None, :] <= jj[:, None])[None]
               & ((jj[None] < np.asarray(xl)[:, None]) | (jj[None] >= x_pad)
                  )[:, None, :])
    bias = np.where(allowed, 0.0, J_NEG_INF).astype(np.float32)[:, None]
    jcache = jtrm.init_kv_cache(L, B, s_max, H, Dh, jnp.float32)
    jh, jcache = jtrm.prefill(params["decoder"], jnp.asarray(x),
                              jnp.asarray(bias), jcache, H)
    cache = trm.init_kv_cache(L, B, s_max, H, Dh, torch.float32, "cpu")
    tb = torch.from_numpy(bias)
    with torch.inference_mode():
        h, cache = trm.prefill(model.decoder, torch.from_numpy(x),
                               lambda q, k, v: mha(q, k, v, tb, H), cache)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), **TOL)
    for pos in range(S, S + 3):
        x_t = rng.standard_normal((B, 1, D)).astype(np.float32)
        jh, jcache = jtrm.decode_step_fast(params["decoder"], jnp.asarray(x_t),
                                           jcache, jnp.asarray(pos), H,
                                           x_len=jnp.asarray(11), x_pad=x_pad)
        with torch.inference_mode():
            h, cache = trm.decode_step_fast(
                model.decoder, torch.from_numpy(x_t), cache, torch.tensor(pos),
                x_len=torch.tensor(11), x_pad=x_pad)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), **TOL)


def test_greedy_tts_matches_jax_tie_aware(pair, monkeypatch):
    jcfg, params, model = pair
    cfg = model.cfg
    rng = np.random.default_rng(3)
    x = rng.integers(0, cfg.text_vocab_size, 8).astype(np.int32)
    y = rng.integers(0, cfg.audio_vocab_size, (4, 25)).astype(np.int32)
    step_logits = []
    orig = vc.sample

    def recording_sample(generator, logits, *a, **kw):
        step_logits.append(logits.numpy().copy())
        return orig(generator, logits, *a, **kw)
    monkeypatch.setattr(vc, "sample", recording_sample)
    got, _ = tts.run_decode(model, is_tts=True, x_tokens=x,
                            prefix=spans.compose_tts_prefix(y, cfg),
                            n_spans=1, scfg=vc.SamplingConfig(**GREEDY),
                            gen_max=96, return_raw=True)
    monkeypatch.setattr(vc, "sample", orig)
    want, _ = jtts.run_decode(params, jcfg, is_tts=True, x_tokens=x,
                              prefix=jspans.compose_tts_prefix(y, jcfg),
                              queue_mask_ids=[], n_spans=1,
                              scfg=jvc.SamplingConfig(**GREEDY), gen_max=96,
                              return_raw=True)
    matched = 0
    for j in range(min(len(got), len(want))):
        if np.array_equal(got[j], want[j]):
            matched += 1
            continue
        top2 = np.sort(step_logits[j], axis=-1)[:, -2:]
        margin = float(np.min(top2[:, 1] - top2[:, 0]))
        assert margin < TIE_MARGIN, f"divergence at step {j}, margin {margin}"
        break
    else:
        assert len(got) == len(want)
    assert matched >= 10, f"only {matched} steps matched before divergence"


def _requests(cfg, n=3, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.text_vocab_size, 8 + 3 * b).astype(np.int32),
             rng.integers(0, cfg.audio_vocab_size,
                          (cfg.n_codebooks, 15 + 7 * b)).astype(np.int32))
            for b in range(n)]


def test_serving_wave_matches_jax(pair):
    jcfg, params, model = pair
    reqs = _requests(model.cfg)
    got = sv.serve_tts_batch(model, reqs, vc.SamplingConfig(**GREEDY), seed=0)
    want = jsv.serve_tts_batch(params, jcfg, reqs,
                               jvc.SamplingConfig(**GREEDY), seed=0)
    for b, ((full, gen), (jfull, jgen)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gen, jgen, err_msg=f"lane {b}")
        np.testing.assert_array_equal(full, jfull, err_msg=f"lane {b}")


def test_engine_matches_jax(pair):
    """Three requests over two lanes (a refill), bursts of 16."""
    jcfg, params, model = pair
    reqs = _requests(model.cfg, seed=6)
    geom = dict(lanes=2, x_pad=32, y_pad=64, gen_max=128, burst=16, seed=0)
    eng = eng_mod.ContinuousBatcher(model, scfg=vc.SamplingConfig(**GREEDY),
                                    **geom)
    ids = [eng.submit(x, y) for x, y in reqs]
    res = eng.run()
    jeng_ = jeng.ContinuousBatcher(params, jcfg,
                                   scfg=jvc.SamplingConfig(**GREEDY), **geom)
    jids = [jeng_.submit(x, y) for x, y in reqs]
    jres = jeng_.run()
    assert eng.stats["refills"] >= 1
    for i, j in zip(ids, jids):
        np.testing.assert_array_equal(res[i][1], jres[j][1])
        np.testing.assert_array_equal(res[i][0], jres[j][0])


def test_fp8_decoder_of_a_doubleswish_model_matches_jax():
    """quantize_decoder_fp8 of a basicnorm + doubleswish model: the fp8
    tree carries across bit for bit, and its decode step (the unfused FFN
    on fp8 weights) matches JAX's."""
    jcfg, params, model = _inference_pair("basicnorm", "doubleswish")
    cfg = model.cfg
    jq = jax_fp8(params, pack_qkv=True)
    assert "lin1_dsw" in jq["decoder"]["layers"]["ffn"]
    q = quantize_decoder_fp8(model, pack_qkv=True)
    st = from_jax_params(jax.tree.map(np.asarray, jq), cfg)
    for k, v in q.state_dict().items():
        if k in st:
            assert torch.equal(v.view(torch.uint8) if v.dtype ==
                               torch.float8_e4m3fn else v,
                               st[k].view(torch.uint8) if st[k].dtype ==
                               torch.float8_e4m3fn else st[k].to(v.dtype)), k
    L, H, Dh, D = cfg.num_decoder_layers, cfg.nhead, cfg.head_dim, cfg.d_model
    rng = np.random.default_rng(2)
    cache = (rng.standard_normal((L, 2, 1, 48, H, Dh)) * 0.5).astype(np.float32)
    x_t = rng.standard_normal((1, 1, D)).astype(np.float32)
    jh, jc = jtrm.decode_step_fast(jq["decoder"], jnp.asarray(x_t),
                                   jnp.asarray(cache), jnp.asarray(37), H,
                                   x_len=jnp.asarray(9), x_pad=16)
    with torch.inference_mode():
        h, c = trm.decode_step_fast(q.decoder, torch.from_numpy(x_t),
                                    torch.from_numpy(cache.copy()),
                                    torch.tensor(37), x_len=torch.tensor(9),
                                    x_pad=16)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)
    with pytest.raises(ValueError, match="relu"):
        trm.decode_step_fast(q.decoder, torch.from_numpy(x_t),
                             torch.from_numpy(cache.copy()), torch.tensor(37),
                             fused_ffn=True)


# ---- ScaledAdam ---------------------------------------------------------------------

@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("norm,act", PAIRS[:2], ids=IDS[:2])
def test_scaled_adam_matches_jax(norm, act, layers):
    """Three steps on seeded gradients: each per-layer log_eps is one leaf
    of L elements (the scalar path only when L = 1), the final norm's a
    true scalar; parameters and every leaf's state as JAX's."""
    jcfg, tcfg = configs(norm=norm, ffn_activation=act,
                         num_decoder_layers=layers)
    params = jvc.init_params(jcfg, jax.random.PRNGKey(0))
    model = port_model(tcfg, params)
    lr = (0.05, 10, 2, 2.0, 12)
    opt = topt.ScaledAdam(topt.stacked_leaves(model),
                          lr=topt.eden_schedule(*lr), clipping_update_period=2)
    tx = jopt.scaled_adam(lr=jopt.eden_schedule(*lr), clipping_update_period=2)
    jp, js, update = params, tx.init(params), jax.jit(tx.update)
    flat, treedef = jax.tree.flatten(params)
    for step in range(3):
        rng = np.random.default_rng(100 + step)
        g = jax.tree.unflatten(treedef, [
            jnp.asarray(rng.normal(size=np.shape(p)) * (3.0 if step == 1
                                                        else 1.0), jnp.float32)
            for p in flat])
        upd, js = update(g, js, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)
        for name, gv in jax_state(g, tcfg).items():
            dict(model.named_parameters())[name].grad = gv.clone()
        opt.step()
        want = jax_state(jp, tcfg)
        for name, p in model.named_parameters():
            torch.testing.assert_close(p.detach(), want[name], rtol=1e-5,
                                       atol=1e-6, msg=f"{name} @ {step}")
    jleaves = js.leaves
    assert len(jleaves) == len(opt.leaves)
    for (path, _), jl, tl, grp in zip(
            jax.tree_util.tree_flatten_with_path(params)[0], jleaves,
            opt.leaves, opt.groups):
        scalar = np.size(jax.tree.leaves(jl.delta)[0]) == 1
        assert topt.ScaledAdam._scalar(grp) == scalar, path
        for key in ("delta", "exp_avg_sq"):
            got = torch.stack([t.reshape(grp[0].shape) for t in tl[key]])
            want = np.asarray(getattr(jl, key))
            np.testing.assert_allclose(
                got.reshape(want.shape).numpy(), want, rtol=1e-5,
                atol=1e-6 * np.abs(want).max(), err_msg=f"{path} {key}")
        np.testing.assert_allclose(tl["param_rms"].numpy().reshape(-1),
                                   np.asarray(jl.param_rms).reshape(-1),
                                   rtol=1e-5, err_msg=str(path))
    names = [n for n, _ in model.named_parameters()]
    assert ("decoder.final_ln_log_eps" in names
            or "decoder.final_ln_log_eps_bal" in names)


@pytest.mark.parametrize("norm", ["layernorm", "basicnorm"])
def test_adaptive_layer_norm_matches_jax(norm):
    """AdaptiveLayerNorm (reference transformer.py:84-115): weight *
    norm(x) + bias, (weight, bias) from a projection of the embedding."""
    m = trm.adaptive_layer_norm_init(torch.Generator().manual_seed(2), 16,
                                     norm=norm)
    p = {"project": {"w": jnp.asarray(m.project_w.numpy()),
                     "b": jnp.asarray(m.project_b.numpy())},
         "norm": {k: jnp.asarray(getattr(m, f"norm_{k}").numpy())
                  for k in trm.NORM_PARAMS[norm]}}
    assert set(p["norm"]) == set(jtrm.adaptive_layer_norm_init(
        jax.random.PRNGKey(0), 16, norm=norm)["norm"])
    rng = np.random.default_rng(13)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    emb = rng.normal(size=(3, 5, 16)).astype(np.float32)
    want = jtrm.adaptive_layer_norm(p, jnp.asarray(x), jnp.asarray(emb))
    got = trm.adaptive_layer_norm(m, torch.from_numpy(x), torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
