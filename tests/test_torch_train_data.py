"""The port's training data path against the JAX package's: span sampling
and composition (voicecraft_tpu_torch/data/spans.py), the manifest dataset,
the dynamic batcher and the collate (data/manifest.py), and the native code
reader (native/) against its pure-Python twin.  Every comparison is exact:
the same numpy seeds give the same arrays."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

from voicecraft_tpu.config import TrainConfig as JaxTrainConfig
from voicecraft_tpu.config import tiny_test as jax_tiny
from voicecraft_tpu.data import manifest as jman
from voicecraft_tpu.data import spans as jspans
from voicecraft_tpu_torch import native
from voicecraft_tpu_torch.config import TrainConfig, tiny_test
from voicecraft_tpu_torch.data import manifest as tman
from voicecraft_tpu_torch.data import spans as tspans
from tests.torch_train_helpers import make_dataset


@pytest.mark.parametrize("dist", ["uniform", "poisson1", "poisson3"])
@pytest.mark.parametrize("shuffle", [0, 1])
def test_spans_match_jax(dist, shuffle):
    """sample_mask_intervals, compose_sequence (mask ids shuffled by the
    same rng when shuffle_mask_embedding) and target_valid_from_real over a
    seeded sweep of lengths."""
    kw = dict(mask_sample_dist=dist, shuffle_mask_embedding=shuffle,
              mask_len_max=120, min_gap=3)
    jc = dataclasses.replace(jax_tiny(), **kw)
    tc = dataclasses.replace(tiny_test(), **kw)
    for i, T in enumerate(range(6, 600, 7)):
        y = np.random.default_rng(i).integers(0, 128, (4, T)).astype(np.int32)
        jr, tr = np.random.default_rng(100 + i), np.random.default_rng(100 + i)
        jmi, jnmi = jspans.sample_mask_intervals(jr, T, jc)
        tmi, tnmi = tspans.sample_mask_intervals(tr, T, tc)
        assert (tmi, tnmi) == (jmi, jnmi), T
        jcs = jspans.compose_sequence(y, jmi, jnmi, jc, jr)
        tcs = tspans.compose_sequence(y, tmi, tnmi, tc, tr)
        assert tcs.length == jcs.length
        for name in ("tokens", "mask_emb_idx", "real"):
            np.testing.assert_array_equal(getattr(tcs, name),
                                          getattr(jcs, name))
        np.testing.assert_array_equal(tspans.target_valid_from_real(tcs.real),
                                      jspans.target_valid_from_real(jcs.real))
        assert tr.integers(1 << 30) == jr.integers(1 << 30)  # same draws


def _tcfgs(root, **kw):
    kw = dict(dataset_dir=root, max_num_tokens=1200, num_buckets=3,
              audio_min_length=2.0, audio_max_length=5.0, text_max_length=20,
              text_min_length=2, drop_long=0, seed=1, **kw)
    return JaxTrainConfig(**kw), TrainConfig(**kw)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same items written by each package's write_manifest_tree; some
    longer than audio_max_length and text_max_length, so that loads crop."""
    roots = []
    for name, writer in (("jax", jman.write_manifest_tree),
                         ("port", tman.write_manifest_tree)):
        root = str(tmp_path_factory.mktemp(name))
        make_dataset(root, tiny_test(), n_items=24, frames=(90, 420),
                     phones=(6, 40), writer=writer)
        roots.append(root)
    return roots


def test_manifest_trees_are_identical(trees):
    cmp = filecmp.dircmp(*trees)
    stack = [cmp]
    while stack:
        c = stack.pop()
        assert not (c.left_only or c.right_only or c.diff_files), c.report()
        _, mismatch, errors = filecmp.cmpfiles(c.left, c.right, c.common_files,
                                               shallow=False)
        assert not (mismatch or errors), (mismatch, errors)
        stack.extend(c.subdirs.values())


@pytest.mark.parametrize("split", ["train", "validation"])
def test_dataset_items_match_jax(trees, split):
    jt, tt = _tcfgs(trees[1])
    jds = jman.ManifestDataset(jax_tiny(), jt, split)
    tds = tman.ManifestDataset(tiny_test(), tt, split)
    assert tds.lengths == jds.lengths and tds.data == jds.data
    assert tds.phn2num == jds.phn2num
    cropped = 0
    for i in range(len(jds)):
        ji = jds.load_item(i, np.random.default_rng(i))
        ti = tds.load_item(i, np.random.default_rng(i))
        assert (ji is None) == (ti is None), i
        if ji is not None:
            np.testing.assert_array_equal(ti[0], ji[0])
            np.testing.assert_array_equal(ti[1], ji[1])
            cropped += ti[1].shape[1] < tds.lengths[i]
    assert split == "validation" or cropped > 0


def test_out_of_vocabulary_codes_raise(tmp_path):
    """A code past the model's audio vocabulary fails loudly in both."""
    root = str(tmp_path)
    item = {"id": "u0", "phones": ["a"] * 12,
            "codes": [[130] * 150 for _ in range(4)]}
    tman.write_manifest_tree(root, [item], tiny_test())
    jt, tt = _tcfgs(root)
    for ds in (jman.ManifestDataset(jax_tiny(), jt),
               tman.ManifestDataset(tiny_test(), tt)):
        with pytest.raises(ValueError, match="audio_vocab_size"):
            ds.load_item(0, np.random.default_rng(0))


@pytest.mark.parametrize("hosts", [1, 2])
def test_batcher_matches_jax(hosts):
    lengths = np.random.default_rng(0).integers(100, 1000, 300).tolist()
    np.testing.assert_array_equal(tman.lognorm_boundaries(20000, 6),
                                  jman.lognorm_boundaries(20000, 6))
    for host in range(hosts):
        kw = dict(num_buckets=6, seed=3, num_hosts=hosts, host=host)
        jb = jman.DynamicBatcher(lengths, 4000, **kw)
        tb = tman.DynamicBatcher(lengths, 4000, **kw)
        assert tb.bucket_lens == jb.bucket_lens
        for epoch in range(3):
            assert tb.epoch_batches(epoch) == jb.epoch_batches(epoch)


def test_collate_matches_jax(trees):
    """Every batch of two epochs, with the trainer's host rng per batch:
    the port's TrainBatch tensors equal JAX's arrays."""
    jt, tt = _tcfgs(trees[1])
    jds = jman.ManifestDataset(jax_tiny(), jt)
    tds = tman.ManifestDataset(tiny_test(), tt)
    batcher = tman.DynamicBatcher(tds.lengths, 1200, num_buckets=3, seed=1)
    n = 0
    for epoch in range(2):
        for bi, idxs in enumerate(batcher.epoch_batches(epoch)):
            key = (1, epoch, bi, 0)
            jb = jman.collate_train(jds, idxs, np.random.default_rng(key))
            tb = tman.collate_train(tds, idxs, np.random.default_rng(key),
                                    device="cpu")
            assert (jb is None) == (tb is None)
            if tb is None:
                continue
            for name, want in jb._asdict().items():
                got = getattr(tb, name)
                assert got.device.type == "cpu"
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=name)
            n += 1
    assert n >= 4


def test_native_and_python_readers_agree(tmp_path, trees):
    """The g++-built reader (into the ignored build/ tree) and the Python
    reader give identical arrays, one file at a time and in a batch, and
    both refuse short and malformed files."""
    assert native.get_lib() is not None
    assert "build" in native.lib_path().parts
    code_dir = os.path.join(trees[1], "encodec_16khz_4codebooks")
    paths = sorted(os.path.join(code_dir, f) for f in os.listdir(code_dir))
    bad = tmp_path / "bad.txt"
    bad.write_text("1 2 3\n4 x 6\n7 8 9\n1 2 3\n")
    short = tmp_path / "short.txt"
    short.write_text("1 2 3\n4 5 6\n")
    ragged = tmp_path / "ragged.txt"
    ragged.write_text("1 2 3 4\n5 6\n7 8 9\n1 2 3\n")
    paths += [str(bad), str(short), str(ragged)]
    batch = native.load_codes_batch(paths, 4)
    for p, b in zip(paths, batch):
        want = native.py_load_codes(p, 4)
        got = native.load_codes(p, 4)
        if want is None:
            assert got is None and b is None, p
        else:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(b, want)
    assert batch[-1].shape == (4, 2)       # the shortest row sets T
    assert batch[-2] is None and batch[-3] is None
