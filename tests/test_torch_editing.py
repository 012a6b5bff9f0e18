"""Multi-span speech editing in the port against the JAX package, on the CPU:
the editing prefix, the greedy multi-span decode (token-equal under the
tie-aware rule, across span transitions), ``inference_edit``, the word-diff
and alignment helpers, the energy aligner, and ``edit_torch_cli.py`` end to
end.  Both packages run tiny_test in f32 on the same weights; the JAX
decode loop is compiled for two geometries only (default and special_first
layouts, both x_pad 32, y_pad 64, gen_max 128)."""

import csv
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from voicecraft_tpu import align as jalign
from voicecraft_tpu import config as jconfig
from voicecraft_tpu.data import spans as jspans
from voicecraft_tpu.inference import editing as jediting
from voicecraft_tpu.inference import tts as jtts
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu_torch import align, config
from voicecraft_tpu_torch.data import spans
from voicecraft_tpu_torch.inference import editing, tts
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.utils.audio import load_audio, read_wav
from voicecraft_tpu_torch.utils.convert import from_jax_params

REPO = Path(__file__).resolve().parents[1]
DEMO_WAV = REPO / "demo" / "demo.wav"
DEMO_CSV = REPO / "demo" / "demo_alignment.csv"
DEMO_TEXT = "the sound of birds over the river at dawn"
TIE_MARGIN = 1e-3
# added to codebook 0's eog logit (heads.b2) in both packages: greedy spans
# of these random weights then end after 8-16 samples (9/15 and 9/16/8),
# so the matched window crosses span transitions
EOG_BIAS = 0.05
GEN_MAX = 128
INTERVALS = [(4, 9), (16, 22), (30, 35)]    # masked frames of a 40-frame y
LAYOUTS = {"default": {},
           "eos_reduced_eog": dict(eos=131, n_special=4, reduced_eog=1),
           "special_first": dict(special_first=1)}
SIL = (5, 7)


def _cfgs(layout):
    kw = dict(LAYOUTS[layout], compute_dtype="float32")
    return (dataclasses.replace(config.tiny_test(), **kw),
            dataclasses.replace(jconfig.tiny_test(), **kw))


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 40, 20).astype(np.int32)
    # codes below 125, so that special_first's shift stays inside the vocab
    y = rng.integers(0, 120, (4, 40)).astype(np.int32)
    return x, y


@pytest.mark.parametrize("n_spans", [1, 2, 3])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_compose_edit_prefix_matches_jax(layout, n_spans):
    cfg, jcfg = _cfgs(layout)
    _, y = _inputs()
    got, got_q = spans.compose_edit_prefix(y, INTERVALS[:n_spans], cfg)
    want, want_q = jspans.compose_edit_prefix(y, INTERVALS[:n_spans], jcfg)
    assert got.length == want.length == got.tokens.shape[1]
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.mask_emb_idx, want.mask_emb_idx)
    np.testing.assert_array_equal(got.real, want.real)
    assert got_q == want_q and len(got_q) == n_spans


@pytest.fixture(scope="module")
def models():
    """layout -> (port model, JAX params, port cfg, JAX cfg), one set of
    weights with codebook 0's eog bias raised by EOG_BIAS."""
    _, jcfg = _cfgs("default")
    params = jax.tree.map(np.asarray, jvc.init_params(jcfg, jax.random.PRNGKey(0)))
    b2 = params["heads"]["b2"].copy()
    b2[0, jcfg.eog] += EOG_BIAS
    params["heads"]["b2"] = b2
    out = {}
    for layout in ("default", "special_first"):
        cfg, jcfg = _cfgs(layout)
        model = vc.VoiceCraft(cfg, "cpu")
        model.load_state_dict(from_jax_params(params, jcfg))
        out[layout] = (model, params, cfg, jcfg)
    return out


def _scfgs():
    return (vc.SamplingConfig(temperature=0.0, silence_tokens=SIL),
            jvc.SamplingConfig(temperature=0.0, silence_tokens=SIL))


def _decode_both(models, layout, monkeypatch, y, n_spans):
    """Greedy raw decode of both packages: ((gen_buf, span_buf) of the port,
    of JAX, and the port's adjusted logits at every draw, feeds included)."""
    model, params, cfg, jcfg = models[layout]
    scfg, jscfg = _scfgs()
    x, _ = _inputs()
    if cfg.special_first:
        y = y + cfg.n_special
    iv = INTERVALS[:n_spans]
    prefix, q = spans.compose_edit_prefix(y, iv, cfg)
    step_logits = []
    orig = vc.sample

    def recording_sample(generator, logits, *a, **kw):
        step_logits.append(logits.numpy().copy())
        return orig(generator, logits, *a, **kw)

    monkeypatch.setattr(vc, "sample", recording_sample)
    stats = {}
    got = tts.run_decode(model, is_tts=False, x_tokens=x, prefix=prefix,
                         queue_mask_ids=q, n_spans=n_spans, scfg=scfg,
                         gen_max=GEN_MAX, return_raw=True, stats=stats)
    monkeypatch.setattr(vc, "sample", orig)
    jprefix, jq = jspans.compose_edit_prefix(y, iv, jcfg)
    want = jtts.run_decode(params, jcfg, is_tts=False, x_tokens=x,
                           prefix=jprefix, queue_mask_ids=jq, n_spans=n_spans,
                           scfg=jscfg, gen_max=GEN_MAX, return_raw=True)
    assert len(step_logits) == stats["steps"]
    assert stats["feeds"] == 2 * (stats["spans_done"] - 1)
    assert stats["steps"] == len(got[0]) + stats["feeds"]
    return got, want, step_logits


def _tie_aware_match(got, want, step_logits):
    """Rows equal (samples and span index) up to the first row whose draw
    had a top-2 margin under TIE_MARGIN.  A row of span j was drawn at call
    row + 2j: each span transition inserts two feed steps, which draw too.
    Returns (rows matched, whether the comparison ran to the end, the
    highest span index among the matched rows)."""
    (g, gs), (w, ws) = got, want
    matched, top_span = 0, 0
    for j in range(min(len(g), len(w))):
        if np.array_equal(g[j], w[j]) and gs[j] == ws[j]:
            matched += 1
            top_span = int(gs[j])
            continue
        top2 = np.sort(step_logits[j + 2 * int(gs[j])], axis=-1)[:, -2:]
        margin = float(np.min(top2[:, 1] - top2[:, 0]))
        assert margin < TIE_MARGIN, f"divergence at row {j}, margin {margin}"
        return matched, False, top_span
    assert len(g) == len(w)
    return matched, True, top_span


@pytest.mark.parametrize("n_spans", [2, 3])
def test_greedy_multispan_decode_matches_jax_tie_aware(models, monkeypatch,
                                                       n_spans):
    _, y = _inputs()
    got, want, step_logits = _decode_both(models, "default", monkeypatch, y,
                                          n_spans)
    matched, whole, top_span = _tie_aware_match(got, want, step_logits)
    assert top_span >= 1, "no span transition inside the matched window"
    assert matched >= 10, f"only {matched} rows matched before divergence"
    if whole:
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].max() == n_spans - 1


def _kept_frames_verbatim(res, y, intervals, span_frames):
    """Each kept interval of y sits in res at its offset after the
    generated spans before it."""
    starts = [s for s, _ in intervals]
    ends = [e for _, e in intervals]
    off = 0
    for j, (lo, hi) in enumerate(zip([0] + ends, starts + [y.shape[1]])):
        np.testing.assert_array_equal(res[:, off:off + hi - lo], y[:, lo:hi])
        off += hi - lo + (span_frames[j] if j < len(span_frames) else 0)
    assert off == res.shape[1]


@pytest.mark.parametrize("layout", ["default", "special_first"])
def test_inference_edit_matches_jax(models, monkeypatch, layout):
    model, params, cfg, jcfg = models[layout]
    x, y = _inputs()
    got, want, step_logits = _decode_both(models, layout, monkeypatch, y, 2)
    matched, whole, top_span = _tie_aware_match(got, want, step_logits)
    assert whole and top_span == 1, (matched, top_span)
    scfg, jscfg = _scfgs()
    stats = {}
    res = editing.inference_edit(model, x, y, INTERVALS[1::-1], scfg,
                                 gen_max=GEN_MAX, stats=stats)
    jres = jediting.inference_edit(params, jcfg, x, y, INTERVALS[:2], jscfg,
                                   gen_max=GEN_MAX)
    np.testing.assert_array_equal(res, jres)
    assert stats["spans_done"] == 2 and len(stats["span_frames"]) == 2
    assert res.shape[1] == (y.shape[1] - sum(e - s for s, e in INTERVALS[:2])
                            + sum(stats["span_frames"]))
    _kept_frames_verbatim(res, y, INTERVALS[:2], stats["span_frames"])


def test_edit_decode_refuses_more_spans_than_the_slab_holds(models):
    model, _, cfg, _ = models["default"]
    x, y = _inputs()
    iv = [(2, 4), (8, 10), (14, 16), (20, 22)]
    with pytest.raises(ValueError, match="max_n_spans"):
        editing.inference_edit(model, x, y, iv, _scfgs()[0], gen_max=GEN_MAX)


# ---- word diff, alignment rows, boundaries ------------------------------------

def _demo_rows():
    with open(DEMO_CSV) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("edit_type,new", [
    ("substitution", "the sound of waves over the river at dawn"),
    ("substitution", "the sound of many birds over the sea at dawn"),
    ("insertion", "the sound of small birds over the river at dawn"),
    ("insertion", "the sound of birds flying low over the river at dawn"),
    ("deletion", "the sound of birds the river at dawn"),
    ("deletion", "the of birds over the river at dawn"),
])
def test_get_span_and_mask_interval_match_jax(edit_type, new):
    rows = _demo_rows()
    got = editing.get_span(DEMO_TEXT, new, edit_type)
    assert got == jediting.get_span(DEMO_TEXT, new, edit_type)
    sec = editing.get_mask_interval(rows, tuple(got[0]), edit_type)
    assert sec == jediting.get_mask_interval(rows, tuple(got[0]), edit_type)
    assert sec[0] <= sec[1]


def test_get_span_refuses_like_jax():
    for mod in (editing, jediting):
        with pytest.raises(RuntimeError, match="editType unknown"):
            mod.get_span("a b", "a c", "swap")
        with pytest.raises(AssertionError):
            mod.get_span("a b", "a b c", "deletion")


@pytest.mark.parametrize("n,f0,f1", [(100, 0.3, 0.6), (50, 0.0, 1.0),
                                     (10, 0.4, 0.6), (216, 0.25, 0.75)])
def test_fractional_edit_span_matches_jax(n, f0, f1):
    assert (editing.fractional_edit_span(n, f0, f1)
            == jediting.fractional_edit_span(n, f0, f1))


@pytest.mark.parametrize("cut,margin,tol", [(1.0, 0.04, 1.0), (2.3, 0.04, 1.0),
                                            (2.3, 0.2, 0.1), (4.0, 0.04, 1.0),
                                            (5.0, 0.04, 1.0), (0.0, 0.5, 1.0)])
def test_find_closest_word_boundary_matches_jax(cut, margin, tol):
    rows = [(r["Begin"], r["End"]) for r in _demo_rows()]
    assert (tts.find_closest_word_boundary(rows, cut, margin, tol)
            == jtts.find_closest_word_boundary(rows, cut, margin, tol))


# ---- the energy aligner -----------------------------------------------------

def test_energy_align_matches_jax_on_demo():
    wav = load_audio(str(DEMO_WAV), 16000)
    np.testing.assert_allclose(align.frame_energy_db(wav, 16000),
                               jalign.frame_energy_db(wav, 16000), atol=1e-6)
    np.testing.assert_allclose(np.asarray(align.voiced_segments(wav, 16000)),
                               np.asarray(jalign.voiced_segments(wav, 16000)),
                               atol=1e-6)
    for words, weights in ((DEMO_TEXT.split(), None),
                           (DEMO_TEXT.split(), [3, 4, 2, 4, 3, 2, 4, 2, 3])):
        got = align.energy_align(wav, 16000, words, weights)
        want = jalign.energy_align(wav, 16000, words, weights)
        assert [r["Label"] for r in got] == [r["Label"] for r in want]
        for key in ("Begin", "End"):
            np.testing.assert_allclose([r[key] for r in got],
                                       [r[key] for r in want], atol=1e-6)
    got = align.align_words(wav, 16000, DEMO_TEXT)
    assert got == jalign.align_words(wav, 16000, DEMO_TEXT)
    assert len(got) == 9 and all(r["Source"] == "energy" for r in got)


def test_widen_margins_for_aligner_matches_jax():
    wav = load_audio(str(DEMO_WAV), 16000)
    energy_rows = align.align_words(wav, 16000, DEMO_TEXT)
    mfa_rows = _demo_rows()
    for rows in (energy_rows, mfa_rows):
        for left, right in ((0.08, 0.08), (0.2, 0.05), (0.1, 0.12)):
            assert (align.widen_margins_for_aligner(rows, left, right)
                    == jalign.widen_margins_for_aligner(rows, left, right))
    assert align.widen_margins_for_aligner(energy_rows, 0.08, 0.08)[2]


# ---- edit_torch_cli.py --------------------------------------------------------

@pytest.mark.parametrize("aligner", ["mfa_csv", "energy"])
def test_edit_cli_writes_finite_wav(tmp_path, aligner):
    out = tmp_path / "edited.wav"
    cmd = [sys.executable, str(REPO / "edit_torch_cli.py"), "--model",
           "tiny_test", "--random-init", "--device", "cpu", "--text-backend",
           "grapheme", "--wav", str(DEMO_WAV), "--orig-transcript", DEMO_TEXT,
           "--target-transcript", "the sound of waves over the river at dawn",
           "--edit-type", "substitution", "--top-k", "15",
           "--silence-tokens", "5", "7", "--out", str(out)]
    if aligner == "mfa_csv":
        csv_path = tmp_path / "alignment.csv"
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Begin", "End", "Label", "Type"])
            for r in _demo_rows():
                w.writerow([r["Begin"], r["End"], r["Label"], "words"])
                w.writerow([r["Begin"], r["End"], "AH0", "phones"])
        cmd += ["--mfa-csv", str(csv_path)]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    wav, sr = read_wav(str(out))
    assert sr == 16000 and wav.shape[1] > 16000
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0
    assert ("widening edit margins" in res.stderr) == (aligner == "energy")
