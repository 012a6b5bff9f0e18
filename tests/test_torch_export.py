"""Checkpoint export of the port (utils/convert.py:to_reference_state_dict,
export_torch_cli.py) against the JAX package's (utils/convert.py,
export_cli.py), on the CPU at tiny_test width: the reference state_dict
equal to JAX's key for key and array for array; a pth and an hf export of
a trainer checkpoint of the port reload (through load_model, and the pth
through the JAX package's loader) with the same weights and logits, bit
for bit; toolbox models are refused with the norm's name."""

import dataclasses
import importlib.util
import json

import jax
import numpy as np
import pytest
import torch

from voicecraft_tpu.utils.convert import load_reference_bundle as jax_load
from voicecraft_tpu.utils.convert import \
    to_reference_state_dict as jax_to_reference
from voicecraft_tpu_torch.config import TrainConfig
from voicecraft_tpu_torch.inference.loader import load_model
from voicecraft_tpu_torch.models import transformer as trm
from voicecraft_tpu_torch.models.voicecraft import VoiceCraft, apply_heads
from voicecraft_tpu_torch.ops.attention import mha, segment_padding_bias
from voicecraft_tpu_torch.training.trainer import Trainer
from voicecraft_tpu_torch.utils.convert import (from_jax_params,
                                                from_reference_state_dict,
                                                to_reference_state_dict)
from tests.test_torch_spec import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_train_helpers import configs, jax_params, make_dataset

import export_torch_cli


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A trainer checkpoint of the port (tiny_test with MTP heads, 2 steps)."""
    root = str(tmp_path_factory.mktemp("data"))
    exp = tmp_path_factory.mktemp("exp")
    cfg = configs(n_mtp=2)[1]
    make_dataset(root, cfg)
    tcfg = TrainConfig(dataset_dir=root, exp_dir=str(exp),
                       max_num_tokens=1200, num_buckets=3, num_steps=2,
                       audio_min_length=2.0, audio_max_length=8.0,
                       text_min_length=2, val_every_n_steps=100,
                       print_every_n_steps=5, lr=0.02, seed=1)
    Trainer(cfg, tcfg, device="cpu").train(max_steps=2)
    return str(exp / "ckpt_latest")


def _logits(model):
    """Logits after one dense prefill of fixed random embeddings."""
    D, H = model.cfg.d_model, model.cfg.nhead
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 40, D)).astype(np.float32)).to(model.dtype)
    bias = segment_padding_bias(40, 16, torch.tensor([11]), torch.tensor([24]))
    cache = trm.init_kv_cache(model.cfg.num_decoder_layers, 1, 40, H,
                              model.cfg.head_dim, model.dtype, "cpu")
    with torch.inference_mode():
        h, _ = trm.prefill(model.decoder, x, lambda q, k, v: mha(q, k, v, bias,
                                                                 H), cache)
        return apply_heads(model.heads, h[0])


def _assert_same_model(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sb) <= set(sa)
    for k, v in sb.items():
        assert torch.equal(sa[k], v), k
    assert torch.equal(_logits(a), _logits(b))


def test_to_reference_state_dict_equals_jax():
    jcfg, tcfg = configs()
    params = jax_params(jcfg, seed=3)
    want = jax_to_reference(params, jcfg)
    model = VoiceCraft(tcfg, "cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          tcfg))
    got = to_reference_state_dict(model.state_dict(), tcfg)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # and back: the inverse reproduces the port's state
    back = from_reference_state_dict(got, tcfg)
    for k, v in back.items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_pth_export_of_a_trainer_checkpoint_reloads(trained, tmp_path):
    out = str(tmp_path / "bundle.pth")
    export_torch_cli.main(["--ckpt", trained, "--out", out, "--device",
                           "cpu"])
    cfg0, model0, vocab0 = load_model(trained, device="cpu")
    cfg1, model1, vocab1 = load_model(out, device="cpu")
    assert vocab1 == vocab0 and vocab0
    # the MTP heads are dropped, and the exported config says so
    assert cfg0.n_mtp == 2 and cfg1 == dataclasses.replace(cfg0, n_mtp=0)
    _assert_same_model(model0, model1)
    # the JAX package reads the same bundle: the same weights
    jcfg, jparams, jvocab = jax_load(out)
    assert jvocab == vocab0
    st = from_jax_params(jax.tree.map(np.asarray, jparams), cfg1)
    for k, v in st.items():
        assert torch.equal(model1.state_dict()[k], v.to(torch.float32)), k


@pytest.mark.skipif(importlib.util.find_spec("safetensors") is None,
                    reason="safetensors cannot be imported")
def test_hf_export_round_trip(trained, tmp_path):
    out = str(tmp_path / "hf")
    export_torch_cli.main(["--ckpt", trained, "--out", out, "--format", "hf",
                           "--device", "cpu"])
    _, model0, vocab0 = load_model(trained, device="cpu")
    _, model1, vocab1 = load_model(out, device="cpu")
    assert vocab1 == vocab0
    _assert_same_model(model0, model1)


def test_random_init_preset_export(tmp_path):
    out = str(tmp_path / "tiny.pth")
    export_torch_cli.main(["--ckpt", "tiny_test", "--random-init",
                           "--out", out, "--device", "cpu"])
    _, want, _ = load_model("tiny_test", random_init=True, device="cpu")
    _, got, vocab = load_model(out, device="cpu")
    assert vocab is None
    _assert_same_model(want, got)


@pytest.mark.parametrize("norm,act", [("basicnorm", "doubleswish"),
                                      ("identity", "relu"),
                                      ("layernorm", "gelu")])
def test_toolbox_models_are_refused(norm, act, tmp_path):
    """The reference layout maps LayerNorm + relu only: the conversions and
    the CLI raise ValueError naming the norm (or the activation)."""
    cfg = dataclasses.replace(configs()[1], norm=norm, ffn_activation=act)
    _, model, _ = load_model("tiny_test_mtp", random_init=True, device="cpu",
                             overrides=dict(n_mtp=0, norm=norm,
                                            ffn_activation=act))
    name = norm if norm != "layernorm" else act
    with pytest.raises(ValueError, match=name):
        to_reference_state_dict(model.state_dict(), cfg)
    with pytest.raises(ValueError, match=name):
        from_reference_state_dict({}, cfg)
    # a trainer checkpoint of the toolbox model
    (tmp_path / "ckpt_x").mkdir()
    torch.save(model.state_dict(), tmp_path / "ckpt_x" / "model.pt")
    (tmp_path / "meta_x.json").write_text(json.dumps(
        {"model_config": dataclasses.asdict(model.cfg)}))
    _, reloaded, _ = load_model(str(tmp_path / "ckpt_x"), device="cpu")
    assert reloaded.decoder.norm_kinds == model.decoder.norm_kinds
    with pytest.raises(ValueError, match=name):
        export_torch_cli.main(["--ckpt", str(tmp_path / "ckpt_x"), "--out",
                               str(tmp_path / "x.pth"), "--device", "cpu"])
    assert not (tmp_path / "x.pth").exists()


def test_hf_export_names_safetensors_when_missing(monkeypatch, tmp_path):
    import builtins
    real = builtins.__import__

    def no_safetensors(name, *a, **kw):
        if name.startswith("safetensors"):
            raise ImportError("No module named 'safetensors'")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_safetensors)
    with pytest.raises(SystemExit, match="safetensors"):
        export_torch_cli.main(["--ckpt", "tiny_test", "--random-init",
                               "--out", str(tmp_path / "hf"), "--format", "hf",
                               "--device", "cpu"])
    assert not (tmp_path / "hf").exists()
