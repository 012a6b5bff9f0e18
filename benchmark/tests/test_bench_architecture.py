"""Architecture modules (``architectures/<name>.py``): the VoiceCraft module
gives the weights and counts that the three cells were measured with,
pinned here; and a configuration of another architecture is new files
only, found by the name in its configuration, with no file of the harness
changed."""

import hashlib
import json
import shutil

import pytest
import torch

from bench_helpers import tiny_config
from harness import common, counts, runner
from harness.weights import make_state

PINS = common.load_json(common.BENCH_DIR / "tests" / "state_pins.json")


def _config(name):
    return common.load_json(common.BENCH_DIR / "configs" / f"{name}.json")


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(
        t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    ).hexdigest()


@pytest.mark.parametrize("name", ["giga830M", "giga830M_TTSEnhanced"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_state_is_pinned(name, dtype):
    """Same keys in the same order, dtypes, shapes and bytes as the
    weights the cells were measured with (tiny_config sizes, the CPU)."""
    cfg = _config(name)
    cfg = {**cfg, **tiny_config(cfg)}
    st = make_state(cfg, PINS["seed"], "cpu", dtype)
    pins = PINS["state"][name][str(dtype).split(".")[1]]
    assert list(st) == list(pins)
    for k, t in st.items():
        assert [str(t.dtype).split(".")[1], list(t.shape), _digest(t)] \
            == pins[k], k


TTS = _config("giga830M_TTSEnhanced")
TRAIN = {**_config("giga830M"), **common.load_json(
    common.BENCH_DIR / "traffic" / "train_recipe.json")["model_overrides"]}

# (config, function, arguments, the value the cells were measured with)
COUNT_PINS = [
    (TTS, "layer_matmul_params", (), 50331648),
    (TTS, "head_matmul_params", (), 16793600),
    (TTS, "decode_token_flops", (1,), 1644331008.0),
    (TTS, "decode_token_flops", (181,), 1667923968.0),
    (TTS, "decode_token_flops", (1300.5,), 1814659072.0),
    (TTS, "decode_span_flops", (181, 128), 214559621120.0),
    (TTS, "decode_span_flops", (412, 384), 661747924992.0),
    (TTS, "decode_span_flops", (300, 0), 0.0),
    (TTS, "prefill_flops", (181,), 293713379328.0),
    (TTS, "prefill_flops", (1023,), 1716342784000.0),
    (TTS, "fused_ffn_bytes", (1, 2, 2), 67137536),
    (TTS, "fused_ffn_bytes", (32, 1, 2), 33857536),
    (TTS, "fused_ffn_bytes", (8, 2, 4), 67280896),
    (TRAIN, "layer_matmul_params", (), 50331648),
    (TRAIN, "head_matmul_params", (), 16789504),
    (TRAIN, "decode_token_flops", (500,), 1709727744.0),
    (TRAIN, "prefill_flops", (412,), 674757369856.0),
    (TRAIN, "train_step_flops", (8, 272, 1000), 52521551265792.0),
    (TRAIN, "train_step_flops", (2, 27, 100), 1253826428928.0),
    (TRAIN, "train_step_flops", (5, 140, 640), 19765375795200.0),
]


@pytest.mark.parametrize("cfg,fn,args,value", COUNT_PINS,
                         ids=[f"{'train' if c is TRAIN else 'tts'}-{f}-{a}"
                              for c, f, a, _ in COUNT_PINS])
def test_counts_are_pinned(cfg, fn, args, value):
    got = getattr(counts, fn)(cfg, *args)
    assert got == value and type(got) is type(value)


# An architecture of its own: VoiceCraft's block with a gated FFN, w1
# renamed w_up and a new family w_gate beside it, and its own counts.
GATED = '''
import importlib.util

_spec = importlib.util.spec_from_file_location("vc_base", {base!r})
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)


def make_state(cfg, seed, device, matrix_dtype):
    st = _base.make_state(cfg, seed, device, matrix_dtype)
    for k in [k for k in st if k.endswith(".w1")]:
        w = st.pop(k)
        st[k[:-2] + "w_up"] = w
        st[k[:-2] + "w_gate"] = -w
    return st


def layer_matmul_params(cfg):
    D = cfg["d_model"]
    return 4 * D * D + 3 * D * 4 * D


head_matmul_params = _base.head_matmul_params


def decode_token_flops(cfg, keys):
    L, D = cfg["num_decoder_layers"], cfg["d_model"]
    return (2.0 * (L * layer_matmul_params(cfg) + head_matmul_params(cfg))
            + L * 4.0 * D * keys)


def prefill_flops(cfg, tokens):
    return tokens * decode_token_flops(cfg, (tokens + 1) / 2.0)
'''


def _bench_root(tmp_path, architecture):
    """A benchmark root with the repository's files and one configuration
    and cell added as files: ``configs/gated.json`` naming
    ``architecture``, and the cell ``gated.single``."""
    bench = tmp_path / "benchmark"
    for d in ("configs", "traffic", "architectures"):
        shutil.copytree(common.BENCH_DIR / d, bench / d)
    (bench / "architectures" / "gated.py").write_text(GATED.format(
        base=str(common.BENCH_DIR / "architectures" / "voicecraft.py")))
    (bench / "configs" / "gated.json").write_text(json.dumps(
        {**TTS, "architecture": architecture}))
    spec = common.load_json(common.REPO_DIR / "BENCHMARK.json")
    spec["configs"].append({"name": "gated", "source": "x",
                            "file": "benchmark/configs/gated.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "gated.single", "config": "gated",
                              "traffic": "tts_closed", "chips": 1,
                              "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path / "BENCHMARK.json"


def test_an_architecture_is_files_only(tmp_path):
    """The configuration's ``architecture`` names a module under the root
    its cell was read from; the weights (through ``Context.state``) and
    the counts are that module's, and the repository's configurations
    keep VoiceCraft's."""
    cell = common.load_cell("gated.single", _bench_root(tmp_path, "gated"))
    ctx = runner.Context(cell, 31415926535, 1.0, False, device="cpu",
                         config_overrides=tiny_config(cell.config))
    st = ctx.state()
    cfg = ctx.cfg
    base = make_state({**TTS, **tiny_config(TTS)}, 31415926535, "cpu",
                      torch.float32)
    assert "decoder.layers.0.w1" not in st
    assert torch.equal(st["decoder.layers.1.w_up"], base["decoder.layers.1.w1"])
    assert torch.equal(st["decoder.layers.1.w_gate"],
                       -base["decoder.layers.1.w1"])
    assert set(st) - {k for k in st if ".w_" in k} == set(base) - {
        k for k in base if k.endswith(".w1")}

    L, D = cfg["num_decoder_layers"], cfg["d_model"]
    per_layer = 4 * D * D + 3 * D * 4 * D
    one = 2.0 * (L * per_layer + counts.head_matmul_params(cfg)) \
        + L * 4.0 * D * 100
    assert counts.layer_matmul_params(cfg) == per_layer
    assert counts.decode_token_flops(cfg, 100) == one
    assert counts.decode_token_flops(cfg, 100) > \
        counts.decode_token_flops({**TTS, **tiny_config(TTS)}, 100)
    assert counts.prefill_flops(cfg, 199) == 199 * one
    assert counts.decode_span_flops(cfg, 90, 21) == 21 * one
    # the repository's own cell, read beside it, is still VoiceCraft's
    tts = common.load_cell("tts830e.single").config
    assert counts.layer_matmul_params(tts) == 50331648


def test_a_missing_architecture_fails_at_once(tmp_path):
    with pytest.raises(FileNotFoundError, match="architectures/nothere.py"):
        common.load_cell("gated.single", _bench_root(tmp_path, "nothere"))
