"""Lane-sharded and tensor-parallel serving in the port
(inference/serving.py, engine.py, streaming.py with ``mesh=``) over 4 gloo
processes at 2 x 2 (tests/torch_mesh_helpers.py, spawned once), on the CPU
at tiny_test with 3 MTP head groups in f32.  Greedy lanes of
serve_tts_batch and serve_edit_batch, plain and speculative, equal the JAX
package's serving on conftest's make_mesh(2, 2) and the port's
one-process wave (f32 on both sides: the tie-aware rule in its strict
form); sampled lanes equal the one-process wave's (a lane keeps its wave
index as its noise key); the engine's requests and a stream equal their
single streams, and a stream closed on rank 0 stops all four ranks at one
burst; a weight-only fp8 decoder is refused over model = 2, as
the JAX package cannot place its scales there."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test
from voicecraft_tpu.inference import serving as jsv
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu.parallel import mesh as jmesh
from voicecraft_tpu_torch.inference import serving as sv
from voicecraft_tpu_torch.inference.tts import inference_tts
from voicecraft_tpu_torch.models import voicecraft as vc
from torch_mesh_helpers import (GREEDY, SAMPLED, Spawned, model_from,
                                numpy_state, serving_worker, tiny)
from torch_train_helpers import jax_state

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs conftest's 8 CPU devices")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops: one thread each (see test_torch_spec.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(cfg, seed, n, frames, text):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.text_vocab_size, text + 3 * b
                          ).astype(np.int32),
             rng.integers(0, cfg.audio_vocab_size,
                          (cfg.n_codebooks, frames + 7 * b)).astype(np.int32))
            for b in range(n)]


@pytest.fixture(scope="module")
def setup():
    """The weights (JAX's init, seed 7), 4 TTS and 4 edit requests (1-3
    spans), 4 engine requests; the port's 2 x 2 runs start first, JAX's
    mesh waves and the port's one-process ones run meanwhile."""
    jcfg = dataclasses.replace(tiny_test(), compute_dtype="float32", n_mtp=3)
    params = jvc.init_params(jcfg, jax.random.PRNGKey(7))
    state = numpy_state(jax_state(params, tiny(n_mtp=3)))
    tts_reqs = _requests(jcfg, 4, 4, 15, 8)
    edit_reqs = [(x, y, iv) for (x, y), iv in zip(
        _requests(jcfg, 3, 4, 40, 9),
        [[(5, 9)], [(4, 8), (16, 22)], [(3, 7), (14, 18), (27, 33)],
         [(10, 20)]])]
    engine_reqs = _requests(jcfg, 6, 4, 12, 6)
    handle = Spawned(4, serving_worker, state, tts_reqs, edit_reqs,
                     engine_reqs)
    try:
        mesh = jmesh.make_mesh(2, 2)
        sharded = jmesh.shard_params(params, mesh)
        g = jvc.SamplingConfig(**GREEDY)
        want = {"tts": [o[1] for o in jsv.serve_tts_batch(
                    sharded, jcfg, tts_reqs, g, seed=0, mesh=mesh)],
                "edit": jsv.serve_edit_batch(sharded, jcfg, edit_reqs, g,
                                             seed=0, mesh=mesh)}
        model = model_from(state, tiny(n_mtp=3), trainable=False)
        stats = {}
        one = {"tts": [o[1] for o in sv.serve_tts_batch(
                   model, tts_reqs, vc.SamplingConfig(**GREEDY), seed=0,
                   stats=stats)],
               "tts_sampled": [o[1] for o in sv.serve_tts_batch(
                   model, tts_reqs, vc.SamplingConfig(**SAMPLED),
                   seeds=[3, 4, 5, 6])],
               "edit": sv.serve_edit_batch(
                   model, edit_reqs, vc.SamplingConfig(**GREEDY), seed=0),
               "single": [inference_tts(model, x, y,
                                        vc.SamplingConfig(**GREEDY),
                                        seed=0)[1]
                          for x, y in engine_reqs]}
        one["tts_steps"] = stats["steps"]
    except BaseException:
        handle.kill()
        raise
    return handle.results(), want, one


def _equal(got, want, what):
    assert len(got) == len(want), what
    for b, (a, w) in enumerate(zip(got, want)):
        assert a.shape == w.shape, (what, b, a.shape, w.shape)
        np.testing.assert_array_equal(a, w, err_msg=f"{what} lane {b}")


def test_every_rank_holds_the_whole_wave(setup):
    ranks, _, _ = setup
    assert all(r["heads"] == 2 for r in ranks)       # 4 heads over model 2
    for key in ("tts", "tts_spec", "edit", "edit_spec"):
        for r in ranks[1:]:
            _equal(r[key], ranks[0][key], f"rank vs rank 0, {key}")


def test_tts_lanes_equal_jax_mesh_and_one_process(setup):
    ranks, want, one = setup
    _equal(ranks[0]["tts"], want["tts"], "2x2 vs JAX make_mesh(2, 2)")
    _equal(ranks[0]["tts"], one["tts"], "2x2 vs the one-process wave")
    # the longest data row's steps: the one-process wave's
    assert ranks[0]["tts_steps"] == one["tts_steps"]


def test_spec_tts_lanes_equal_plain(setup):
    """Speculative serving at tau 4 over the mesh: greedy lanes equal the
    plain ones (JAX's mesh wave)."""
    ranks, want, _ = setup
    _equal(ranks[0]["tts_spec"], want["tts"], "2x2 spec vs JAX plain")


def test_sampled_lanes_equal_one_process(setup):
    ranks, _, one = setup
    _equal(ranks[0]["tts_sampled"], one["tts_sampled"],
           "2x2 sampled vs the one-process wave")


def test_edit_lanes_equal_jax_mesh_and_one_process(setup):
    ranks, want, one = setup
    _equal(ranks[0]["edit"], want["edit"], "2x2 edit vs JAX")
    _equal(ranks[0]["edit"], one["edit"], "2x2 edit vs one process")
    _equal(ranks[0]["edit_spec"], want["edit"], "2x2 spec edit vs JAX plain")


def test_engine_requests_equal_single_streams(setup):
    """The engine at 2 x 2, one lane a data rank: 4 requests (refills on
    both ranks), each its single stream; a stream over the mesh too."""
    ranks, _, one = setup
    st = ranks[0]["engine_stats"]
    assert st["waves"] == 1 and st["refills"] >= 2
    _equal(ranks[0]["engine"], one["single"], "engine 2x2 vs single stream")
    frames, gen = ranks[0]["stream"]
    np.testing.assert_array_equal(frames, gen)
    np.testing.assert_array_equal(gen, one["single"][-1])


def test_fp8_decoder_refused_over_model(setup):
    ranks, _, _ = setup
    assert "fp8" in ranks[0]["fp8_refused"]


def test_closed_stream_stops_every_rank(setup):
    """Rank 0's consumer closes the stream after its first chunk: the
    flag reaches its model peer (rank 1, which shares no data gather with
    it) and the other data row, and all four ranks stop at the same burst,
    within one burst (8) of the close, with no last chunk on the ranks
    that drained."""
    ranks, _, _ = setup
    closed = [r["closed"] for r in ranks]
    for c in closed:
        assert c["stats"]["cancelled"] and c["first"] == closed[0]["first"]
        assert c["stats"]["frames"] == closed[0]["stats"]["frames"]
    assert all(c["frames"] == c["stats"]["frames"] and not c["last"]
               for c in closed[1:])
    assert closed[0]["stats"]["frames"] <= closed[0]["first"] + 8
    assert closed[0]["stats"]["frames"] < ranks[0]["stream"][1].shape[1]
