"""Streaming TTS in the port (models/encodec.py StreamingDecoder,
inference/streaming.py) against the JAX package and the port's one-shot
decode, on the CPU in f32: the incremental codec decode over random feed
sizes, the short-utterance flush, stream_tts's frames and audio, the
pipeline toggle, the non-streamed engine, cancellation, a streaming lane
beside a plain one, and streaming over the speculative engine."""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test
from voicecraft_tpu.inference import streaming as jst
from voicecraft_tpu.models import encodec as jec
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu_torch.inference.engine import ContinuousBatcher
from voicecraft_tpu_torch.inference.streaming import (frames_from_rows,
                                                      stream_tts)
from voicecraft_tpu_torch.models import encodec as ec
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.utils.convert import (codec_from_jax_params,
                                                from_jax_params)

TOL = 1e-5
SAMPLED = dict(top_k=10, top_p=0.9, silence_tokens=(5, 7))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops: one thread each (see test_torch_spec.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(cfg, seed=42):
    params = jvc.init_params(cfg, jax.random.PRNGKey(seed))
    model = vc.VoiceCraft(cfg, "cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          cfg))
    return params, model.eval()


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32")
    params, model = _model(cfg)
    jcfg = jec.EncodecConfig(n_filters=8, dimension=16, n_q=cfg.n_codebooks,
                             codebook_size=cfg.audio_vocab_size)
    cparams = jec.init_encodec(jcfg, jax.random.PRNGKey(0))
    codec = ec.Encodec(ec.EncodecConfig(
        n_filters=8, dimension=16, n_q=cfg.n_codebooks,
        codebook_size=cfg.audio_vocab_size), "cpu")
    codec.load_state_dict(codec_from_jax_params(
        jax.tree.map(np.asarray, cparams), codec.cfg))
    rng = np.random.default_rng(0)
    x = rng.integers(0, cfg.text_vocab_size, 12).astype(np.int32)
    y = rng.integers(0, cfg.audio_vocab_size,
                     (cfg.n_codebooks, 30)).astype(np.int32)
    return cfg, params, model, jcfg, cparams, codec.eval(), x, y


def _one_shot(codec, codes):
    return codec.decode(torch.from_numpy(codes[None]).long())[0].numpy()


def _feed_all(dec, codes, sizes):
    T, out, pos = codes.shape[1], [], 0
    for m in sizes + [T]:              # a trailing T feeds any remainder
        m = min(m, T - pos)
        if m <= 0:
            break
        out.append(dec.feed(codes[:, pos:pos + m]))
        pos += m
    out.append(dec.flush())
    return np.concatenate(out)


@pytest.mark.parametrize("sizes", [[3, 2, 4, 30, 1, 17, 16, 64], [16] * 8,
                                   [137], [5, 132]])
def test_streaming_decoder_matches_jax_and_one_shot(setup, sizes):
    """Feeds of any size (sub-chunk dribbles, a tiny first feed, chunk
    multiples, one shot) give the one-shot decode and the JAX streaming
    decoder's samples within 1e-5."""
    *_, jcfg, cparams, codec, _, _ = setup
    codes = np.random.default_rng(7).integers(
        0, jcfg.codebook_size, (jcfg.n_q, 137)).astype(np.int32)
    got = _feed_all(ec.StreamingDecoder(codec, chunk_frames=16), codes, sizes)
    want = _feed_all(jec.StreamingDecoder(cparams, jcfg, chunk_frames=16),
                     codes, sizes)
    full = _one_shot(codec, codes)
    assert got.shape == want.shape == full.shape == (137 * 320,)
    np.testing.assert_allclose(got, full, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_streaming_decoder_flush_short_utterance(setup):
    """Fewer than STREAM_MIN_FIRST frames emit only on flush: the one-shot
    decode of exactly those frames (and the JAX decoder's flush)."""
    *_, jcfg, cparams, codec, _, _ = setup
    codes = np.random.default_rng(8).integers(
        0, jcfg.codebook_size, (jcfg.n_q, 4)).astype(np.int32)
    dec = ec.StreamingDecoder(codec)
    assert dec.feed(codes).shape == (0,)
    audio = dec.flush()
    np.testing.assert_allclose(audio, _one_shot(codec, codes), rtol=0,
                               atol=TOL)
    jdec = jec.StreamingDecoder(cparams, jcfg)
    jdec.feed(codes)
    np.testing.assert_allclose(audio, jdec.flush(), rtol=0, atol=TOL)


def test_streaming_decoder_flush_is_terminal(setup):
    """flush() is idempotent; a feed() after it raises, on the held-back
    path and on the normal one."""
    *_, jcfg, _, codec, _, _ = setup
    rng = np.random.default_rng(9)
    codes = rng.integers(0, jcfg.codebook_size, (jcfg.n_q, 4))
    dec = ec.StreamingDecoder(codec)
    dec.feed(codes)
    assert dec.flush().shape == (4 * codec.cfg.hop_length,)
    assert dec.flush().shape == (0,)
    with pytest.raises(RuntimeError):
        dec.feed(codes)
    dec2 = ec.StreamingDecoder(codec, chunk_frames=16)
    dec2.feed(rng.integers(0, jcfg.codebook_size, (jcfg.n_q, 32)))
    dec2.flush()
    with pytest.raises(RuntimeError):
        dec2.feed(codes)


def test_streamed_frames_and_audio_are_exact(setup):
    """The streamed frames concatenate to gen exactly, the streamed audio
    is the one-shot decode of gen (within 1e-5), t_decode rides the last
    chunk, and stats report the whole run."""
    cfg, _, model, *_, codec, x, y = setup
    scfg = vc.SamplingConfig(**SAMPLED)
    stats = {}
    chunks = list(stream_tts(model, x, y, scfg, seed=3, burst=16,
                             codec=codec, stats=stats))
    assert len(chunks) >= 3
    gen = chunks[-1]["gen"]
    np.testing.assert_array_equal(
        np.concatenate([c["frames"] for c in chunks], axis=1), gen)
    assert chunks[-1]["t_decode"] > 0
    audio = np.concatenate([c["audio"] for c in chunks])
    full = ec.decode_bucketed(codec, gen[None])[0]
    assert audio.shape == full.shape
    np.testing.assert_allclose(audio, full, rtol=0, atol=TOL)
    assert stats == {"frames": gen.shape[1],
                     "t_decode": chunks[-1]["t_decode"], "cancelled": False}


def test_streaming_pipeline_on_off_identical(setup):
    cfg, _, model, *_, x, y = setup
    scfg = vc.SamplingConfig(**SAMPLED)
    piped = list(stream_tts(model, x, y, scfg, seed=3, burst=16))
    sync = list(stream_tts(model, x, y, scfg, seed=3, burst=16,
                           pipeline=False))
    np.testing.assert_array_equal(piped[-1]["gen"], sync[-1]["gen"])
    np.testing.assert_array_equal(piped[-1]["full"], sync[-1]["full"])
    np.testing.assert_array_equal(
        np.concatenate([c["frames"] for c in piped], axis=1),
        np.concatenate([c["frames"] for c in sync], axis=1))


def test_streaming_matches_non_streamed_engine_and_jax(setup):
    """Per-burst readbacks do not perturb the decode: the streamed request
    equals a plain engine run of the same geometry; greedy, it equals the
    JAX package's stream (both f32)."""
    cfg, params, model, *_, x, y = setup
    scfg = vc.SamplingConfig(**SAMPLED)
    chunks = list(stream_tts(model, x, y, scfg, seed=3, burst=16))
    eng = ContinuousBatcher(model, lanes=1, x_pad=32, y_pad=64, gen_max=128,
                            burst=16, scfg=scfg, seed=3)
    rid = eng.submit(x, y)
    full, gen = eng.run()[rid]
    np.testing.assert_array_equal(chunks[-1]["gen"], gen)
    np.testing.assert_array_equal(chunks[-1]["full"], full)
    greedy = dict(top_k=1, silence_tokens=(5, 7))
    got = list(stream_tts(model, x, y, vc.SamplingConfig(**greedy), seed=3,
                          burst=16))[-1]
    want = list(jst.stream_tts(params, cfg, x, y, jvc.SamplingConfig(
        **greedy), seed=3, burst=16))[-1]
    np.testing.assert_array_equal(got["gen"], want["gen"])
    np.testing.assert_array_equal(got["full"], want["full"])


def test_cancelled_stream_ends_producer_and_reports(setup):
    """Closing the generator after the first chunk cancels the engine at
    its next burst: the producer thread ends, and stats report the frames
    handed over and the producer's time, for the autospec bandit."""
    cfg, _, model, *_, x, y = setup
    scfg = vc.SamplingConfig(**SAMPLED)
    full_run = list(stream_tts(model, x, y, scfg, seed=3, burst=16))
    n_threads = threading.active_count()
    stats = {}
    it = stream_tts(model, x, y, scfg, seed=3, burst=16, stats=stats)
    first = next(it)
    it.close()
    assert threading.active_count() == n_threads
    assert stats["cancelled"] and stats["t_decode"] > 0
    assert first["frames"].shape[1] <= stats["frames"]
    assert stats["frames"] < full_run[-1]["gen"].shape[1]


def test_streaming_alongside_batch_lanes(setup):
    """A streaming request beside a plain one: both finish, and the last
    streamed rows are a prefix of the streamer's own result."""
    cfg, _, model, *_, x, y = setup
    eng = ContinuousBatcher(model, lanes=2, x_pad=32, y_pad=64, gen_max=128,
                            burst=16, scfg=vc.SamplingConfig(**SAMPLED),
                            seed=3)
    got = []
    rid_s = eng.submit(x, y, on_rows=got.append)
    rid_p = eng.submit(x[::-1].copy(), y[:, ::-1].copy())
    res = eng.run()
    assert rid_s in res and rid_p in res and len(got) >= 2
    last = frames_from_rows(got[-1], cfg)
    np.testing.assert_array_equal(last, res[rid_s][1][:, :last.shape[1]])
    first = frames_from_rows(got[0], cfg)
    np.testing.assert_array_equal(first, last[:, :first.shape[1]])


def test_streaming_with_speculative_engine(setup):
    """Greedy chunks over the speculative engine concatenate to the plain
    stream's tokens."""
    cfg0, *_, x, y = setup
    cfg = dataclasses.replace(cfg0, n_mtp=2)
    _, model = _model(cfg)
    g = vc.SamplingConfig(temperature=0.0, silence_tokens=())
    plain = list(stream_tts(model, x, y, g, seed=3, burst=16))
    spec = list(stream_tts(model, x, y, g, seed=3, burst=16, spec=3))
    np.testing.assert_array_equal(spec[-1]["gen"], plain[-1]["gen"])
    np.testing.assert_array_equal(
        np.concatenate([c["frames"] for c in spec], axis=1), spec[-1]["gen"])
