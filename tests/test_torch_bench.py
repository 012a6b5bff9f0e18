"""bench_torch.py, the port's twin of bench.py, and the synthetic training
batch it trains on, on the CPU: the batch equals the JAX package's array
for array, bench_torch.py takes bench.py's flags with bench.py's defaults
(read from bench.py's source), and each mode runs at tiny_test and prints
bench.py's metric name and unit for its flags."""

import ast
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bench_torch
from __graft_entry__ import _synthetic_batch
from voicecraft_tpu.config import tiny_test as jtiny_test
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu_torch import config
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.training.synthetic import synthetic_batch

REPO = Path(__file__).resolve().parents[1]
ABSENT = {"--platform", "--unroll"}     # JAX-only: a backend, XLA's unroll
SMALL = ["--preset", "tiny_test", "--device", "cpu", "--iters", "1",
         "--frames", "40", "--prompt-frames", "20", "--phones", "12",
         "--burst", "16", "--train-batch", "2"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_batch_matches_jax(seed):
    cfg = config.tiny_test()
    got = synthetic_batch(cfg, B=3, Sx=16, y_len=48, seed=seed, device="cpu")
    want = _synthetic_batch(jtiny_test(), B=3, Sx=16, y_len=48, seed=seed)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got.y_tokens.shape[2] % 64 == 0


def test_forward_train_ntoken_matches_jax():
    cfg = dataclasses.replace(config.tiny_test(), compute_dtype="float32")
    jcfg = dataclasses.replace(jtiny_test(), compute_dtype="float32")
    batch = synthetic_batch(cfg, B=2, Sx=16, y_len=48, seed=1, device="cpu")
    model = vc.VoiceCraft(cfg, "cpu").init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = vc.forward_train(model, batch, remat=False)
    params = jvc.init_params(jcfg, jax.random.PRNGKey(0))
    want = jvc.forward_train(params, jcfg,
                             _synthetic_batch(jcfg, B=2, Sx=16, y_len=48, seed=1),
                             rng=None, remat=False)
    assert int(got["effective_ntoken"]) == int(want["effective_ntoken"]) > 0
    assert np.isfinite(float(got["loss"]))


def _bench_py_flags():
    """{flag: default} of every add_argument in bench.py's source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                default = ast.literal_eval(kw["default"])
            else:
                action = kw.get("action")
                default = (False if action is not None
                           and ast.literal_eval(action) == "store_true" else None)
            flags[node.args[0].value] = default
    return flags


def test_parser_takes_bench_py_flags():
    want = _bench_py_flags()
    assert len(want) > 25 and ABSENT <= set(want)
    actions = {a.option_strings[0]: a for a in bench_torch.build_parser()._actions}
    got = {k: a.default for k, a in actions.items() if k != "-h"}
    assert set(got) == (set(want) - ABSENT) | {"--device"}
    for flag in set(want) - ABSENT:
        assert got[flag] == want[flag], flag
    assert got["--device"] == "cuda"


def test_cuda_default_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(SystemExit, match="--device cpu"):
        bench_torch.main(["--preset", "tiny_test"])


MODES = {
    "single": ([], "tts_serving_rtf_830m_b32", "x_realtime_per_chip"),
    "bf16": (["--bf16"], "tts_rtf_830m_bf16", "x_realtime"),
    "bf16_k4": (["--bf16", "--steps-per-iter", "4"], "tts_rtf_830m_bf16",
                "x_realtime"),
    "fused_ffn": (["--bf16", "--fused-ffn"], "tts_rtf_830m_bf16", "x_realtime"),
    "spec": (["--spec", "3"], "tts_spec_rtf_830m_tau3", "x_realtime"),
    "serve": (["--serve", "4", "--kv-fp8"], "tts_serving_rtf_830m_b4",
              "x_realtime_per_chip"),
    "serve_spec": (["--serve", "2", "--spec", "2", "--spec-accept"],
                   "tts_serving_rtf_830m_b2_spec2_ceiling",
                   "x_realtime_per_chip"),
    "edit_serve": (["--edit-serve", "3"], "edit_serving_rtf_830m_b3",
                   "x_realtime_per_chip"),
    "engine": (["--engine", "2"], "tts_engine_rtf_830m_l2",
               "x_realtime_per_chip"),
    "engine_steady": (["--engine", "2", "--steady", "--frames", "16"],
                      "tts_engine_rtf_830m_l2_steady", "x_realtime_per_chip"),
    "stream": (["--stream"], "tts_stream_first_audio_ms_burst16", "ms"),
    "stream_nocodec": (["--stream", "--stream-no-codec",
                        "--stream-no-pipeline"],
                       "tts_stream_first_audio_ms_burst16_nocodec_nopipe",
                       "ms"),
    "train": (["--train"], "train_tokens_per_sec_tiny_test",
              "codec_tokens/s/chip"),
    "train_profile": (["--train-profile", "--train-remat", "attn"],
                      "train_profile_tiny_test_attn", None),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_prints_bench_py_metric(mode, capsys, monkeypatch):
    flags, metric, unit = MODES[mode]
    probes, gemm_probes = [], bench_torch._gemm_probes
    monkeypatch.setattr(bench_torch, "_gemm_probes",
                        lambda *a: probes.append(gemm_probes(*a)) or probes[-1])
    results = bench_torch.main(SMALL + flags)
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert last == results[-1] and last["metric"] == metric
    if unit is None:                          # the train-profile fields
        assert last["B"] == 2 and last["tokens_per_step"] > 0
        # the probe's rate before the line rounds it to 0.1 TFLOP/s (a CPU
        # thread shared with other tests may fall under 0.05)
        (_, tflops, _), = probes
        assert tflops > 0 and last["gemm_probe_tflops"] == round(tflops, 1)
        assert last["gemm_probe_fp8_tflops"] is None   # the card's only
        assert {"t_fwd_s", "t_grads_s", "t_update_s", "t_step_s",
                "achieved_tflops", "frac_fwd", "frac_ideal_bwd",
                "frac_remat_sched", "frac_update"} <= set(last)
    else:
        assert set(last) >= {"metric", "value", "unit", "vs_baseline"}
        assert last["unit"] == unit and last["value"] > 0
    if mode == "single":                      # bench.py's default: two lines
        first = json.loads(lines[0])
        assert first["metric"] == "tts_rtf_830m"
        assert last["single_stream_rtf"] == first["value"]


def test_spec_accept_reports_tau_tokens_a_pass(capsys):
    bench_torch.main(SMALL + ["--spec", "2", "--spec-accept"])
    err = capsys.readouterr().err
    assert "accept=forced" in err and "2.00 tok/pass" in err
