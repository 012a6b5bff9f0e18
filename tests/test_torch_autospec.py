"""The port's adaptive speculation policy (inference/autospec.py) against the
JAX package's: the same arms under the same observations, resolve_spec_arg
on port models with and without MTP heads, and tts_batch_torch_cli.py
--spec auto on the CPU."""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test
from voicecraft_tpu.inference import autospec as jas
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu_torch.inference import autospec as tas
from voicecraft_tpu_torch.models import voicecraft as vc

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops: one thread each (see test_torch_spec.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drive(policy, rates, waves, first=None):
    """``waves`` rounds of next_mode() then observe(): arm a's frames/s
    from rates(wave, a); ``first`` (arm -> fps) poisons each arm's first
    sample.  Returns the modes and the final snapshot."""
    modes, seen = [], set()
    for w in range(waves):
        m = policy.next_mode()
        fps = rates(w, m)
        if first is not None and m not in seen:
            fps = first[m]
        seen.add(m)
        policy.observe(m, frames=int(fps), seconds=1.0,
                       tok_per_pass=3.0 if m else None)
        modes.append(m)
    return modes, policy.snapshot()


SCENARIOS = {
    # probe rotation (deepest arm first), then exploit
    "probe_then_exploit": (dict(tau=8, probe_waves=2, reprobe_every=100),
                           lambda w, m: 200 if m else 100, 14, None),
    # the first sample of each arm is a warm-up and is shed
    "shed_first_sample": (dict(tau=2, probe_waves=2, window=4),
                          lambda w, m: 1000 if m else 700, 10,
                          {0: 5, 2: 1}),
    # the world flips mid-run and reprobes move the serving arm
    "reprobe_flip": (dict(tau=4, probe_waves=1, reprobe_every=3, window=2),
                     lambda w, m: (300 if m else 100) if w < 6
                     else (100 if m else 500), 30, None),
    # three arms: the middle one wins, then a regime change
    "multi_arm": (dict(taus=[4, 8], probe_waves=1, reprobe_every=3,
                       window=2),
                  lambda w, m: ({0: 100, 4: 300, 8: 200} if w < 10
                                else {0: 500, 4: 50, 8: 40})[m], 40, None),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_matches_jax(name):
    kw, rates, waves, first = SCENARIOS[name]
    got = _drive(tas.AutoSpecPolicy(**kw), rates, waves, first)
    want = _drive(jas.AutoSpecPolicy(**kw), rates, waves, first)
    assert got == want
    assert len(set(got[0])) > 1      # more than one arm was served


def test_observe_validation():
    p = tas.AutoSpecPolicy(tau=4)
    with pytest.raises(ValueError):
        p.observe(3, 10, 1.0)
    p.observe(4, 0, 1.0)          # an empty wave: ignored
    p.observe(4, 10, 0.0)
    assert p.snapshot()["n_spec"] == 0


@pytest.mark.parametrize("value", ["0", "6", 6, "auto", "auto:3",
                                   "auto:2,4,8", "auto:99"])
def test_resolve_spec_arg_on_port_models(value):
    """The arms come from the port model's MTP head groups, as JAX's come
    from its params; a model without heads resolves auto to plain."""
    for n_mtp in (0, 3, 7):
        cfg = dataclasses.replace(tiny_test(), n_mtp=n_mtp)
        model = vc.VoiceCraft(cfg, "meta")
        params = jvc.init_params(cfg, jax.random.PRNGKey(0))
        tau, pol = tas.resolve_spec_arg(value, model)
        jtau, jpol = jas.resolve_spec_arg(value, params)
        assert tau == jtau, (value, n_mtp)
        assert (pol is None) == (jpol is None)
        if pol is not None:
            assert pol.taus == jpol.taus and pol.arms == jpol.arms


# ---- tts_batch_torch_cli.py --spec auto -------------------------------------

ROWS = [("demo.wav", "a.wav", "the sound of the mill", 0.6),
        ("demo.wav", "b.wav", "the sound of a hill", 0.9),
        ("demo.wav", "c", "the sound of the sea", 1.2)]
SAMPLING = ["--top-k", "15", "--silence-tokens", "5", "7"]


def _cli(tmp_path, model, *extra):
    import tts_batch_torch_cli
    path = tmp_path / "m.tsv"
    lines = ["audio\tname\ttext\tend\tx\tstart"]
    lines += [f"{a}\t{n}\t{t}\t{e}\t-\t8" for a, n, t, e in ROWS]
    path.write_text("\n".join(lines) + "\n")
    return tts_batch_torch_cli.main([
        "--model", model, "--random-init", "--device", "cpu",
        "--text-backend", "grapheme", "--manifest", str(path),
        "--audio-root", str(REPO / "demo"), "--output-dir",
        str(tmp_path / "out"), "--lanes", "1", *SAMPLING, *extra])


def _requests(model_name):
    from voicecraft_tpu_torch.data.phonemes import (build_vocab,
                                                    make_text_tokenizer,
                                                    phones_to_ids)
    from voicecraft_tpu_torch.inference.loader import load_codec, load_model
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.utils import audio as au
    cfg, model, _ = load_model(model_name, True, 1, "cpu")
    _, codec = load_codec(None, True, 1, "cpu",
                          codebook_size=cfg.audio_vocab_size)
    tok = make_text_tokenizer("en-us", "grapheme")
    phones = [tok.phonemize(t) for _, _, t, _ in ROWS]
    vocab = build_vocab(phones[:1])
    wav = au.load_audio(str(REPO / "demo" / "demo.wav"), 16000)
    return model, [(np.asarray(phones_to_ids(p, vocab), np.int32),
                    ec.encode_bucketed(codec, wav[:, :int(round(e * 16000))])[0])
                   for p, (_, _, _, e) in zip(phones, ROWS)]


def test_tts_batch_cli_spec_auto(tmp_path):
    """Three one-row waves with 3 MTP head groups: the bandit's probe phase
    serves them at tau 4, plain, tau 4 (arms {0, 4}, deepest first), and
    each row equals serve_tts_batch at that mode."""
    from voicecraft_tpu_torch.inference.serving import serve_tts_batch
    got = _cli(tmp_path, "tiny_test_mtp", "--spec", "auto")
    model, reqs = _requests("tiny_test_mtp")
    scfg = vc.SamplingConfig(top_k=15, top_p=0.8, temperature=1.0,
                             stop_repetition=-1, silence_tokens=(5, 7))
    for (full, gen), req, mode in zip(got, reqs, (4, 0, 4)):
        (wf, wg), = serve_tts_batch(model, [req], scfg, seed=1, spec=mode)
        np.testing.assert_array_equal(gen, wg)
        np.testing.assert_array_equal(full, wf)


def test_tts_batch_cli_spec_auto_without_heads(tmp_path, caplog):
    """A model without MTP heads decodes plain under --spec auto: each
    lone row as inference_tts, as without --spec."""
    from voicecraft_tpu_torch.inference.tts import inference_tts
    got = _cli(tmp_path, "tiny_test", "--spec", "auto:2,4")
    model, reqs = _requests("tiny_test")
    scfg = vc.SamplingConfig(top_k=15, top_p=0.8, temperature=1.0,
                             stop_repetition=-1, silence_tokens=(5, 7))
    assert "no MTP heads" in caplog.text
    assert len(got) == 3
    for (full, gen), req in zip(got, reqs):
        wf, wg = inference_tts(model, *req, scfg, seed=1)
        np.testing.assert_array_equal(gen, wg)
        np.testing.assert_array_equal(full, wf)
