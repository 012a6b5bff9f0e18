"""Shared pieces of the port's training tests (tests/test_torch_train_*.py,
test_torch_optim.py, test_torch_trainer.py): batches composed on the host
from numpy seeds, the JAX package's f32 parameters carried into the port's
trainable model, gradient comparison, and a tiny on-disk dataset."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from voicecraft_tpu.config import tiny_test_mtp as jax_tiny_mtp
from voicecraft_tpu.models.voicecraft import TrainBatch as JaxTrainBatch
from voicecraft_tpu.models.voicecraft import init_params
from voicecraft_tpu_torch.config import tiny_test_mtp
from voicecraft_tpu_torch.data import spans
from voicecraft_tpu_torch.data.manifest import write_manifest_tree
from voicecraft_tpu_torch.models.voicecraft import TrainBatch, VoiceCraft
from voicecraft_tpu_torch.utils.convert import from_jax_params


def configs(n_mtp: int = 0, **kw):
    """(JAX config, port config), f32 compute, tiny_test widths."""
    kw = dict(compute_dtype="float32", n_mtp=n_mtp, **kw)
    return (dataclasses.replace(jax_tiny_mtp(), **kw),
            dataclasses.replace(tiny_test_mtp(), **kw))


def batch_arrays(cfg, seed: int = 0, B: int = 3, Sx: int = 16,
                 frames=(40, 90)):
    """A composed batch as numpy arrays (x, x_lens, y_tokens, y_lens,
    mask_emb_idx, target_valid): random codes and text from ``seed``, the
    spans sampled and composed by data/spans.py, padded to a multiple of 64
    columns."""
    rng = np.random.default_rng(seed)
    K = cfg.n_codebooks
    xs, comps = [], []
    for _ in range(B):
        T = int(rng.integers(*frames))
        y = rng.integers(0, cfg.audio_vocab_size, (K, T)).astype(np.int32)
        mi, nmi = spans.sample_mask_intervals(rng, T, cfg)
        comps.append(spans.compose_sequence(y, mi, nmi, cfg, rng))
        xs.append(rng.integers(0, cfg.text_vocab_size,
                               int(rng.integers(5, Sx + 1))).astype(np.int32))
    Sy = -(-max(c.length for c in comps) // 64) * 64
    x = np.full((B, Sx), cfg.text_pad_token, np.int32)
    y_tok = np.full((B, K, Sy), cfg.audio_pad_token, np.int32)
    midx = np.full((B, Sy), -1, np.int32)
    tval = np.zeros((B, K, Sy), bool)
    x_lens, y_lens = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for b, (xx, c) in enumerate(zip(xs, comps)):
        x[b, :len(xx)], x_lens[b] = xx, len(xx)
        y_tok[b, :, :c.length], y_lens[b] = c.tokens, c.length
        midx[b, :c.length] = c.mask_emb_idx
        tval[b, :, :c.length] = spans.target_valid_from_real(c.real)
    return x, x_lens, y_tok, y_lens, midx, tval


def jax_batch(arrays) -> JaxTrainBatch:
    return JaxTrainBatch(*map(jax.numpy.asarray, arrays))


def torch_batch(arrays) -> TrainBatch:
    return TrainBatch(*(torch.from_numpy(np.array(a)) for a in arrays))


def jax_params(jcfg, seed: int = 0) -> dict:
    return init_params(jcfg, jax.random.PRNGKey(seed))


def port_model(tcfg, params) -> VoiceCraft:
    """The port's trainable f32 model holding the JAX tree's weights."""
    model = VoiceCraft(tcfg, "cpu", trainable=True)
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          tcfg))
    return model


def jax_state(tree, tcfg) -> dict:
    """A JAX tree shaped like the parameters (params or grads) as the
    port's state_dict, f32."""
    return {k: v.float() for k, v in
            from_jax_params(jax.tree.map(np.asarray, tree), tcfg).items()}


def assert_grads_close(model, want: dict, rtol: float = 1e-4,
                       floor: float = 1e-4) -> None:
    """Every parameter's gradient of ``model`` (None counts as zero) against
    ``want`` (a state_dict of gradients), by :func:`assert_grad_dicts_close`."""
    assert_grad_dicts_close(
        {n: p.grad if p.grad is not None else torch.zeros_like(p)
         for n, p in model.named_parameters()}, want, rtol, floor)


def assert_grad_dicts_close(got: dict, want: dict, rtol: float = 1e-4,
                            floor: float = 1e-4) -> None:
    """Each gradient within rtol x max(that tensor's largest |want|, floor x
    the largest |want| of all).  The floor serves the key biases, whose
    gradient is zero in exact arithmetic (the softmax does not see a shift
    shared by a query's logits), so both sides hold f32 noise there."""
    top = max(v.abs().max().item() for v in want.values())
    bad = []
    for name, w in want.items():
        scale = max(w.abs().max().item(), floor * top)
        err = (got[name].float() - w.float()).abs().max().item()
        if not err <= rtol * scale:
            bad.append((name, err, scale))
    assert not bad, bad


def make_dataset(root: str, cfg, n_items: int = 24, seed: int = 0,
                 frames=(110, 320), phones=(12, 30), writer=write_manifest_tree):
    """A train split of ``n_items`` random utterances and a validation split
    of the first 6, written by ``writer`` (either package's
    write_manifest_tree)."""
    rng = np.random.default_rng(seed)
    names = [f"ph{i}" for i in range(cfg.text_vocab_size)]
    items = []
    for i in range(n_items):
        T = int(rng.integers(*frames))
        L = int(rng.integers(*phones))
        items.append({
            "id": f"utt{i:03d}",
            "phones": [names[int(rng.integers(0, len(names)))]
                       for _ in range(L)],
            "codes": rng.integers(0, cfg.audio_vocab_size,
                                  (cfg.n_codebooks, T)).tolist()})
    writer(root, items, cfg, "train")
    writer(root, items[:6], cfg, "validation")
    return items
