"""Weights into the port (utils/convert.py), held exactly against the JAX
package's parameter trees, and the port's import rules: it runs without
JAX, and its package calls no ready-made attention or compiler."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test
from voicecraft_tpu.models import encodec as jec
from voicecraft_tpu.models.voicecraft import init_params
from voicecraft_tpu.utils.convert import to_reference_state_dict
from voicecraft_tpu.utils.quantize import _quantize_matrix
from voicecraft_tpu_torch.models.encodec import Encodec, EncodecConfig
from voicecraft_tpu_torch.models.voicecraft import VoiceCraft
from voicecraft_tpu_torch.utils.convert import (codec_from_jax_params,
                                                from_jax_params,
                                                from_reference_state_dict,
                                                to_torch)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "voicecraft_tpu_torch"


def _cfg():
    return dataclasses.replace(tiny_test(), compute_dtype="float32")


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, init_params(_cfg(), jax.random.PRNGKey(0)))


def _eq(t, a):
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(a))


def test_from_jax_params_exact(jax_params):
    cfg = _cfg()
    model = VoiceCraft(cfg, "cpu")
    model.load_state_dict(from_jax_params(jax_params, cfg))
    p = jax_params
    _eq(model.text_emb, p["text_emb"]["weight"])
    _eq(model.audio_emb, p["audio_emb"])
    _eq(model.mask_emb, p["mask_emb"])
    _eq(model.alpha_text, p["alpha_text"])
    _eq(model.alpha_audio, p["alpha_audio"])
    for name in ("w1", "b1", "w2", "b2"):
        _eq(getattr(model.heads, name), p["heads"][name])
    lay = p["decoder"]["layers"]
    for i, layer in enumerate(model.decoder.layers):
        for ours, theirs in (("ln1_g", lay["ln1"]["g"]), ("ln1_b", lay["ln1"]["b"]),
                             ("wq", lay["attn"]["wq"]), ("wk", lay["attn"]["wk"]),
                             ("wv", lay["attn"]["wv"]), ("bq", lay["attn"]["bq"]),
                             ("bk", lay["attn"]["bk"]), ("bv", lay["attn"]["bv"]),
                             ("wo", lay["attn"]["out"]["w"]),
                             ("bo", lay["attn"]["out"]["b"]),
                             ("ln2_g", lay["ln2"]["g"]), ("ln2_b", lay["ln2"]["b"]),
                             ("w1", lay["ffn"]["lin1"]["w"]),
                             ("b1", lay["ffn"]["lin1"]["b"]),
                             ("w2", lay["ffn"]["lin2"]["w"]),
                             ("b2", lay["ffn"]["lin2"]["b"])):
            _eq(getattr(layer, ours), theirs[i])
    _eq(model.decoder.final_ln_g, p["decoder"]["final_ln"]["g"])
    _eq(model.decoder.final_ln_b, p["decoder"]["final_ln"]["b"])


def test_reference_state_dict_matches_jax_route(jax_params):
    """JAX params -> reference .pth layout -> port equals JAX params -> port."""
    cfg = _cfg()
    direct = from_jax_params(jax_params, cfg)
    via_ref = from_reference_state_dict(to_reference_state_dict(jax_params, cfg),
                                        cfg)
    assert direct.keys() == via_ref.keys()
    for k in direct:
        np.testing.assert_array_equal(via_ref[k].numpy(), direct[k].numpy(),
                                      err_msg=k)


def test_codec_from_jax_params_exact():
    tree = jax.tree.map(np.asarray,
                        jec.init_encodec(jec.EncodecConfig(), jax.random.PRNGKey(1)))
    codec = Encodec(EncodecConfig(), "cpu")
    codec.load_state_dict(codec_from_jax_params(tree, EncodecConfig()))  # strict
    enc, dec = tree["encoder"], tree["decoder"]
    _eq(codec.encoder.init.weight, enc["init"]["w"].transpose(2, 1, 0))
    _eq(codec.encoder.stages[2].blocks[0].conv1.weight,
        enc["stages"][2]["blocks"][0]["conv1"]["w"].transpose(2, 1, 0))
    _eq(codec.encoder.stages[3].down.bias, enc["stages"][3]["down"]["b"])
    _eq(codec.decoder.stages[1].up.weight,
        dec["stages"][1]["up"]["w"].transpose(2, 1, 0))
    _eq(codec.decoder.lstm.lstm.weight_hh_l1, dec["lstm"]["layers"][1]["w_hh"])
    _eq(codec.encoder.lstm.lstm.bias_ih_l0, enc["lstm"]["layers"][0]["b_ih"])
    _eq(codec.decoder.final.weight, dec["final"]["w"].transpose(2, 1, 0))
    _eq(codec.codebooks, tree["codebooks"])


def test_fp8_and_bf16_arrays_cross_bit_exact():
    w = jnp.asarray(np.random.default_rng(0).normal(size=(32, 48)), jnp.float32)
    q = _quantize_matrix(w)
    t = to_torch(q["q"])
    assert t.dtype == torch.float8_e4m3fn
    _eq(t.float(), np.asarray(q["q"].astype(jnp.float32)))
    s = to_torch(q["scale"])
    assert s.dtype == torch.bfloat16
    _eq(s.float(), np.asarray(q["scale"].astype(jnp.float32)))


def test_port_imports_without_jax():
    """Every module of the port, its CLIs, bench_torch.py and chip_smoke.py
    import with JAX and the JAX package unavailable (the machine with the
    card has no JAX, and the port stands alone), and without transformers
    and datasets, which only the Whisper and --hf-dataset paths import,
    when they run."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['voicecraft_tpu'] = None\n"
        "sys.modules['transformers'] = None\n"
        "sys.modules['datasets'] = None\n"
        "import voicecraft_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names + ['tts_torch_cli', 'edit_torch_cli', 'chip_smoke',\n"
        "                  'tts_batch_torch_cli', 'realedit_torch_cli',\n"
        "                  'serve_torch_cli', 'train_torch_cli',\n"
        "                  'eval_torch_cli', 'preprocess_torch_cli',\n"
        "                  'export_torch_cli', 'quality_torch_cli',\n"
        "                  'spec_acceptance_torch_cli', 'bench_torch']:\n"
        "    importlib.import_module(n)\n"
        "for n in ('models.voicecraft', 'inference.editing', 'align',\n"
        "          'utils.convert_encodec', 'utils.transcribe',\n"
        "          'utils.quantize', 'inference.spec_common',\n"
        "          'inference.serving', 'inference.engine',\n"
        "          'inference.streaming', 'inference.autospec', 'app',\n"
        "          'utils.text_norm', 'native', 'data.manifest',\n"
        "          'training.optim', 'training.step', 'training.trainer',\n"
        "          'utils.profiling', 'utils.tracing', 'models.scaling',\n"
        "          'ops.pattern_providers', 'utils.quality',\n"
        "          'training.synthetic'):\n"
        "    assert 'voicecraft_tpu_torch.' + n in names, n\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 32


@pytest.mark.parametrize("banned", ["import jax", "from jax",
                                    "from voicecraft_tpu.",
                                    "from voicecraft_tpu import",
                                    "import voicecraft_tpu.",
                                    "scaled_dot_product_attention",
                                    "torch.compile"])
def test_port_source_has_no(banned):
    """Neither the port nor its scripts (which import inside main()), its
    recipe twins and its notebook twins name JAX, the JAX package, a
    library attention or the compiler.  chip_smoke.py names the library
    attention once, as the yardstick it times (library_ms) beside the
    attention kernel."""
    files = [*PORT.rglob("*.py"), *REPO.glob("recipes/*_torch.sh"),
             *REPO.glob("notebooks/*_torch.ipynb"), REPO / "tts_torch_cli.py",
             REPO / "edit_torch_cli.py", REPO / "tts_batch_torch_cli.py",
             REPO / "realedit_torch_cli.py", REPO / "serve_torch_cli.py",
             REPO / "train_torch_cli.py", REPO / "eval_torch_cli.py",
             REPO / "preprocess_torch_cli.py", REPO / "export_torch_cli.py",
             REPO / "quality_torch_cli.py",
             REPO / "spec_acceptance_torch_cli.py", REPO / "chip_smoke.py",
             REPO / "bench_torch.py"]
    hits = []
    for p in files:
        lines = [ln for ln in p.read_text().splitlines() if banned in ln]
        if (p.name == "chip_smoke.py" and banned == "scaled_dot_product_attention"
                and len(lines) == 1 and "library_ms" in lines[0]):
            continue
        if lines:
            hits.append(str(p.relative_to(REPO)))
    assert not hits, hits
