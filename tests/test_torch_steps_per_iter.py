"""steps_per_iter in the port's decode loop (make_decode_loop, run_decode,
inference_tts), on the CPU in f32: k gated steps between host syncs give
the k = 1 loop's output token for token (TTS greedy and sampled, a
two-span edit whose transition lands mid-group, an edit capped by its
budget), and k = 4 matches the JAX package's k = 4 under the tie-aware
rule; param_count equals the JAX package's."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test as jtiny_test
from voicecraft_tpu.config import tiny_test_mtp as jtiny_test_mtp
from voicecraft_tpu.data import spans as jspans
from voicecraft_tpu.inference import tts as jtts
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu_torch import config
from voicecraft_tpu_torch.data import spans
from voicecraft_tpu_torch.inference import tts
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.utils.convert import from_jax_params

TIE_MARGIN = 1e-3
# added to codebook 0's eog logit: spans of these random weights then end
# by eog (as in test_torch_editing.py), so an edit crosses its transitions
EOG_BIAS = 0.05
GREEDY = vc.SamplingConfig(temperature=0.0, silence_tokens=())
SAMPLED = vc.SamplingConfig(top_k=10, top_p=0.9, temperature=1.0,
                            stop_repetition=3, silence_tokens=(5, 7))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return dataclasses.replace(config.tiny_test(), compute_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    model = vc.VoiceCraft(cfg, "cpu").init_weights(
        torch.Generator().manual_seed(42)).eval()
    x = np.random.default_rng(0).integers(
        0, cfg.text_vocab_size, 12).astype(np.int32)
    y = np.random.default_rng(1).integers(
        0, cfg.audio_vocab_size, (cfg.n_codebooks, 30)).astype(np.int32)
    return cfg, model, x, y


@pytest.fixture
def eog_biased(setup):
    model = setup[1]
    with torch.no_grad():
        model.heads.b2[0, model.cfg.eog] += EOG_BIAS
    yield setup
    with torch.no_grad():
        model.heads.b2[0, model.cfg.eog] -= EOG_BIAS


@pytest.mark.parametrize("scfg", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_tts_identical_across_k(setup, scfg):
    cfg, model, x, y = setup
    st1 = {}
    full1, gen1 = tts.inference_tts(model, x, y, scfg, seed=7, stats=st1,
                                    steps_per_iter=1)
    assert gen1.shape[1] > 0
    for k in (2, 4):
        stk = {}
        fullk, genk = tts.inference_tts(model, x, y, scfg, seed=7, stats=stk,
                                        steps_per_iter=k)
        np.testing.assert_array_equal(gen1, genk)
        np.testing.assert_array_equal(full1, fullk)
        # every forward counted: k = 1's plus at most k - 1 idle ones
        assert st1["steps"] <= stk["steps"] < st1["steps"] + k
        assert stk["steps"] % k == 0 and stk["feeds"] == st1["feeds"] == 0


def test_two_span_edit_identical_across_k(eog_biased):
    """A transition's two feed steps inside a group of 3."""
    cfg, model, x, y = eog_biased
    prefix, queue_ids = spans.compose_edit_prefix(y, [(5, 12), (20, 25)], cfg)
    outs, stats = {}, {}
    for k in (1, 3):
        stats[k] = {}
        outs[k] = tts.run_decode(model, is_tts=False, x_tokens=x,
                                 prefix=prefix, queue_mask_ids=queue_ids,
                                 n_spans=2, scfg=SAMPLED, seed=1,
                                 steps_per_iter=k, return_raw=True,
                                 stats=stats[k])
    rows, span_of = outs[1]
    n0 = int((span_of == 0).sum())
    assert n0 % 3 != 0 and (span_of == 1).sum() > 0, "transition at a group edge"
    for a, b in zip(outs[1], outs[3]):
        np.testing.assert_array_equal(a, b)
    assert stats[1]["spans_done"] == stats[3]["spans_done"] == 2
    assert stats[1]["feeds"] == stats[3]["feeds"] == 2


@pytest.mark.parametrize("gen_max", [23, 37])
def test_budget_capped_edit_identical_across_k(eog_biased, gen_max):
    """Three spans under a budget that ends the decode mid-edit: the same
    rows, span indices and spans started at every k."""
    cfg, model, x, y = eog_biased
    intervals = [(3, 7), (12, 16), (22, 26)]
    prefix, queue_ids = spans.compose_edit_prefix(y, intervals, cfg)
    x_pad, y_pad = 32, 64
    xt, yt, mi, qm = tts.pad_inputs(cfg, x, prefix, x_pad, y_pad, "cpu",
                                    queue_ids)
    res = {}
    for k in (1, 3, 4):
        loop = vc.make_decode_loop(cfg, is_tts=False, x_pad=x_pad,
                                   y_pad=y_pad, gen_max=gen_max, scfg=SAMPLED,
                                   steps_per_iter=k)
        res[k] = loop(model, xt, len(x), yt, prefix.length, mi, qm, 3,
                      torch.Generator().manual_seed(5))
    assert res[1].gen_cnt == gen_max        # the budget ended the decode
    assert res[1].gen_buf.shape == (gen_max, cfg.n_codebooks)
    for k in (3, 4):
        r = res[k]
        assert (r.gen_cnt, r.spans_done) == (res[1].gen_cnt,
                                             res[1].spans_done)
        assert r.forwards - r.idle == res[1].forwards and r.idle < k
        assert torch.equal(r.gen_buf, res[1].gen_buf)
        assert torch.equal(r.span_buf, res[1].span_buf)


def test_idle_steps_at_a_full_slab(setup):
    """A slab with no slack (prefix_len == y_pad, max_spans 1) and a budget
    that ends mid-group: the idle steps write at the slot past the last one
    (clamped into the slab) and the rows equal k = 1's."""
    cfg, model, x, y = setup
    prefix = spans.compose_tts_prefix(y, cfg)
    x_pad, y_pad, gen_max = 32, prefix.length, 22
    xt, yt, mi, qm = tts.pad_inputs(cfg, x, prefix, x_pad, y_pad, "cpu")
    res = {}
    for k in (1, 3, 4):
        loop = vc.make_decode_loop(cfg, is_tts=True, x_pad=x_pad, y_pad=y_pad,
                                   gen_max=gen_max, scfg=SAMPLED, max_spans=1,
                                   bench_mode=True, steps_per_iter=k)
        res[k] = loop(model, xt, len(x), yt, prefix.length, mi, qm[:1], 1,
                      torch.Generator().manual_seed(3))
    assert res[1].gen_cnt == gen_max and res[1].idle == 0
    for k in (3, 4):
        assert res[k].gen_cnt == gen_max and res[k].idle == (-gen_max) % k
        assert torch.equal(res[k].gen_buf, res[1].gen_buf)


def test_max_spans_bounds_the_edit(setup):
    cfg, model, x, y = setup
    loop = vc.make_decode_loop(cfg, is_tts=False, x_pad=32, y_pad=64,
                               gen_max=16, scfg=GREEDY, max_spans=2)
    prefix, queue_ids = spans.compose_edit_prefix(
        y, [(3, 7), (12, 16), (22, 26)], cfg)
    xt, yt, mi, qm = tts.pad_inputs(cfg, x, prefix, 32, 64, "cpu", queue_ids)
    with pytest.raises(ValueError, match="max_spans"):
        loop(model, xt, len(x), yt, prefix.length, mi, qm, 3, None)
    with pytest.raises(ValueError, match="steps_per_iter"):
        vc.make_decode_loop(cfg, is_tts=True, x_pad=32, y_pad=64, gen_max=16,
                            scfg=GREEDY, steps_per_iter=0)


def test_k4_matches_jax_k4_tie_aware(monkeypatch):
    """Greedy TTS, both packages at steps_per_iter=4 on the same weights:
    rows equal until the first draw whose top-2 margin (the port's
    adjusted logits) is under TIE_MARGIN."""
    jcfg = dataclasses.replace(jtiny_test(), compute_dtype="float32")
    cfg = _cfg()
    params = jvc.init_params(jcfg, jax.random.PRNGKey(0))
    model = vc.VoiceCraft(cfg, "cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          cfg))
    rng = np.random.default_rng(3)
    x = rng.integers(0, cfg.text_vocab_size, 8).astype(np.int32)
    y = rng.integers(0, cfg.audio_vocab_size, (4, 25)).astype(np.int32)
    step_logits = []
    orig = vc.sample

    def recording(generator, logits, *a, **kw):
        step_logits.append(logits.numpy().copy())
        return orig(generator, logits, *a, **kw)

    monkeypatch.setattr(vc, "sample", recording)
    got, _ = tts.run_decode(model.eval(), is_tts=True, x_tokens=x,
                            prefix=spans.compose_tts_prefix(y, cfg),
                            n_spans=1, scfg=GREEDY, gen_max=128,
                            return_raw=True, steps_per_iter=4)
    monkeypatch.setattr(vc, "sample", orig)
    want, _ = jtts.run_decode(
        params, jcfg, is_tts=True, x_tokens=x,
        prefix=jspans.compose_tts_prefix(y, jcfg), queue_mask_ids=[],
        n_spans=1, scfg=jvc.SamplingConfig(temperature=0.0, silence_tokens=()),
        gen_max=128, return_raw=True, steps_per_iter=4)
    assert len(got) <= len(step_logits) < len(got) + 4
    for j in range(min(len(got), len(want))):
        if not np.array_equal(got[j], want[j]):
            top2 = np.sort(step_logits[j], axis=-1)[:, -2:]
            margin = float(np.min(top2[:, 1] - top2[:, 0]))
            assert margin < TIE_MARGIN, f"divergence at row {j}, margin {margin}"
            assert j >= 10, f"only {j} rows matched"
            break
    else:
        assert len(got) == len(want) > 0


@pytest.mark.parametrize("preset", ["tiny_test", "tiny_test_mtp"])
def test_param_count_matches_jax(preset):
    jcfg = {"tiny_test": jtiny_test, "tiny_test_mtp": jtiny_test_mtp}[preset]()
    model = vc.VoiceCraft(config.PRESETS[preset](), "cpu")
    want = jvc.param_count(jvc.init_params(jcfg, jax.random.PRNGKey(0)))
    assert vc.param_count(model) == want
