"""Verified speculative multi-span editing in the port (make_spec_edit_loop,
inference_edit(spec=)) against the port's plain editing loop and the JAX
package's speculative editing loop, on the CPU.  tiny_test_mtp in f32 with
codebook 0's eog bias raised so that greedy spans end after 8-16 samples
and the runs cross span transitions (feed passes)."""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from voicecraft_tpu import config as jconfig
from voicecraft_tpu.data import spans as jspans
from voicecraft_tpu.inference import tts as jtts
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu_torch.data import spans
from voicecraft_tpu_torch.inference import editing, tts
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.utils.convert import from_jax_params

from tests.test_torch_spec import (  # noqa: F401  (one_torch_thread: autouse)
    TIE_MARGIN, recording_sample, one_torch_thread)

EOG_BIAS = 0.05
INTERVALS = [(4, 9), (16, 22), (30, 35)]    # masked frames of a 40-frame y
GREEDY = dict(temperature=0.0, silence_tokens=(5, 7))
SAMPLED = dict(top_k=10, top_p=0.9, temperature=1.0, silence_tokens=(5, 7))
TAU_JAX = 4


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(jconfig.tiny_test_mtp(), compute_dtype="float32")
    params = jax.tree.map(np.asarray, jvc.init_params(cfg, jax.random.PRNGKey(0)))
    b2 = params["heads"]["b2"].copy()
    b2[0, cfg.eog] += EOG_BIAS
    params["heads"]["b2"] = b2
    model = vc.VoiceCraft(cfg, "cpu")
    model.load_state_dict(from_jax_params(params, cfg))
    rng = np.random.default_rng(3)
    x = rng.integers(0, 40, 20).astype(np.int32)
    y = rng.integers(0, 120, (4, 40)).astype(np.int32)
    return cfg, params, model.eval(), x, y


def _kept_frames_verbatim(res, y, intervals, span_frames):
    starts = [s for s, _ in intervals]
    ends = [e for _, e in intervals]
    off = 0
    for j, (lo, hi) in enumerate(zip([0] + ends, starts + [y.shape[1]])):
        np.testing.assert_array_equal(res[:, off:off + hi - lo], y[:, lo:hi])
        off += hi - lo + (span_frames[j] if j < len(span_frames) else 0)
    assert off == res.shape[1]


@pytest.mark.parametrize("tau", [2, 4])
@pytest.mark.parametrize("n_spans", [1, 2, 3])
def test_spec_edit_greedy_equals_plain_loop(setup, n_spans, tau):
    cfg, _, model, x, y = setup
    ivs = INTERVALS[:n_spans]
    scfg = vc.SamplingConfig(**GREEDY)
    plain_stats, spec_stats = {}, {}
    plain = editing.inference_edit(model, x, y, ivs, scfg, seed=3,
                                   stats=plain_stats)
    spec = editing.inference_edit(model, x, y, ivs, scfg, seed=3, spec=tau,
                                  stats=spec_stats)
    np.testing.assert_array_equal(spec, plain)
    assert spec_stats["span_frames"] == plain_stats["span_frames"]
    assert spec_stats["spans_done"] == plain_stats["spans_done"] == n_spans
    assert min(spec_stats["span_frames"]) > 0
    # one feed pass per span transition, one forward fewer than the plain
    # loop's two feed steps
    assert spec_stats["feeds"] == n_spans - 1
    assert plain_stats["feeds"] == 2 * (n_spans - 1)
    _kept_frames_verbatim(spec, y, ivs, spec_stats["span_frames"])


@pytest.mark.parametrize("n_spans", [2, 3])
def test_spec_edit_greedy_matches_jax_spec_tie_aware(setup, monkeypatch,
                                                     n_spans):
    """The port's speculative rows (equal to its plain loop's) against the
    JAX package's speculative rows, until the first near-tie of the plain
    loop's draws (a row of span j was drawn at call row + 2j: the plain
    loop draws on its two feed steps too)."""
    cfg, params, model, x, y = setup
    ivs = INTERVALS[:n_spans]
    prefix, q = spans.compose_edit_prefix(y, ivs, cfg)
    common = dict(is_tts=False, x_tokens=x, queue_mask_ids=q, n_spans=n_spans,
                  seed=3, return_raw=True)
    logits = recording_sample(monkeypatch)
    plain = tts.run_decode(model, prefix=prefix, scfg=vc.SamplingConfig(**GREEDY),
                           **common)
    monkeypatch.undo()
    g, gs = tts.run_decode(model, prefix=prefix, scfg=vc.SamplingConfig(**GREEDY),
                           spec=TAU_JAX, **common)
    np.testing.assert_array_equal(g, plain[0])
    np.testing.assert_array_equal(gs, plain[1])
    jprefix, jq = jspans.compose_edit_prefix(y, ivs, cfg)
    w, ws = jtts.run_decode(params, cfg, is_tts=False, x_tokens=x, prefix=jprefix,
                            queue_mask_ids=jq, n_spans=n_spans,
                            scfg=jvc.SamplingConfig(**GREEDY), seed=3,
                            return_raw=True, spec=TAU_JAX)
    for j in range(min(len(g), len(w))):
        if not (np.array_equal(g[j], w[j]) and gs[j] == ws[j]):
            top2 = np.sort(logits[j + 2 * int(gs[j])], axis=-1)[:, -2:]
            margin = float(np.min(top2[:, 1] - top2[:, 0]))
            assert margin < TIE_MARGIN, f"divergence at row {j}, margin {margin}"
            assert gs[j] >= 1, "no span transition before the divergence"
            break
    else:
        assert len(g) == len(w) and gs.max() == n_spans - 1


def test_spec_edit_sampled_invariant_to_tau(setup):
    cfg, _, model, x, y = setup
    scfg = vc.SamplingConfig(**SAMPLED)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        o2, o4 = (editing.inference_edit(model, x, y, INTERVALS, scfg, seed=3,
                                         spec=tau) for tau in (2, 4))
    np.testing.assert_array_equal(o2, o4)


def test_stochastic_spec_edit_runs_multispan(setup):
    """Stochastic verification with the span machinery: the run completes
    with the unedited frames in place, deterministically; at temperature 0
    it falls back to exact verification and equals the plain loop."""
    cfg, _, model, x, y = setup
    scfg = vc.SamplingConfig(**SAMPLED, spec_sampling="stochastic")
    stats = {}
    out = editing.inference_edit(model, x, y, INTERVALS, scfg, seed=3, spec=3,
                                 stats=stats)
    assert stats["spans_done"] == 3
    _kept_frames_verbatim(out, y, INTERVALS, stats["span_frames"])
    np.testing.assert_array_equal(
        out, editing.inference_edit(model, x, y, INTERVALS, scfg, seed=3, spec=3))
    g = vc.SamplingConfig(**GREEDY, spec_sampling="stochastic")
    np.testing.assert_array_equal(
        editing.inference_edit(model, x, y, INTERVALS, g, seed=3, spec=3),
        editing.inference_edit(model, x, y, INTERVALS, g, seed=3))


def test_spec_edit_refusals(setup):
    cfg, _, model, x, y = setup
    bare = vc.VoiceCraft(dataclasses.replace(cfg, n_mtp=0), "cpu").init_weights(
        torch.Generator().manual_seed(0))
    scfg = vc.SamplingConfig(**GREEDY)
    with pytest.raises(ValueError, match="mtp_heads"):
        editing.inference_edit(bare, x, y, INTERVALS[:1], scfg, spec=4)
    with pytest.raises(ValueError, match="n_mtp"):
        editing.inference_edit(model, x, y, INTERVALS[:1], scfg, spec=5)
    with pytest.raises(ValueError, match="unfused FFN"):
        editing.inference_edit(model, x, y, INTERVALS[:1], scfg, spec=2,
                               fused_ffn=True)
    with pytest.raises(ValueError, match="n_draft >= 2"):
        vc.make_spec_edit_loop(cfg, x_pad=32, y_pad=64, gen_max=128, scfg=scfg,
                               n_draft=1)
    prefix = spans.compose_tts_prefix(y, cfg)
    with pytest.raises(ValueError, match="inference_tts_spec"):
        tts.run_decode(model, is_tts=True, x_tokens=x, prefix=prefix, n_spans=1,
                       scfg=scfg, spec=4)
