"""Training dataset, token-budget dynamic batching and static-shape collate
(PyTorch port of voicecraft_tpu/data/manifest.py).

The reference's on-disk format (data/gigaspeech.py):
  <dataset_dir>/<manifest_name>/{train,validation,test}.txt   TSV, last col = frames
  <dataset_dir>/vocab.txt                                      "<id> <phn>" lines
  <dataset_dir>/<phn_folder_name>/<id>.txt                     one line of phones
  <dataset_dir>/<encodec_folder_name>/<id>.txt                 K lines of codes

The batcher has the semantics of the reference's
DistributedDynamicBatchSampler (steps/trainer_utils.py:408-628):
lognormal-quantile bucket boundaries scaled to the token budget, greedy
bucket filling over a permutation seeded by seed + epoch, a shuffled batch
order, a host-strided split, and mid-epoch resume by skipping batches.
Composition is numpy on the host; ``collate_train`` pads each batch to its
own bucket shape (the composed length rounded up to a multiple of 64) and
hands the device a ``TrainBatch`` of torch tensors.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..models.voicecraft import TrainBatch
from ..native import load_codes
from . import spans

SYMBOL_SET = {"<SIL>", "<MUSIC>", "<NOISE>", "<OTHER>"}  # gigaspeech.py:36


def load_vocab(path: str) -> Dict[str, int]:
    """vocab.txt lines are '<id> <phn>'."""
    phn2num = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) == 2:
                phn2num[parts[1]] = int(parts[0])
    return phn2num


@dataclass
class ManifestDataset:
    """Lazy manifest-backed dataset (reference data/gigaspeech.py:8-129)."""

    mcfg: ModelConfig
    tcfg: TrainConfig
    split: str = "train"

    def __post_init__(self):
        t = self.tcfg
        manifest_fn = os.path.join(t.dataset_dir, t.manifest_name,
                                   self.split + ".txt")
        with open(manifest_fn) as f:
            rows = [ln.strip().split("\t") for ln in f if ln.strip()]
        self.data, self.lengths = [], []
        min_frames = self.mcfg.encodec_sr * t.audio_min_length
        max_frames = self.mcfg.encodec_sr * t.audio_max_length
        for r in rows:
            n = int(r[-1])
            if n < min_frames:
                continue
            if t.drop_long and n > max_frames:
                continue
            self.data.append(r)
            self.lengths.append(n)
        self.phn2num = load_vocab(os.path.join(t.dataset_dir, "vocab.txt"))

    def __len__(self):
        return len(self.data)

    def load_item(self, index: int, rng: np.random.Generator
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(x [Lx] int32, y [K, T] int32), or None where the item cannot be
        read or is too short after cropping.  Raises on a code outside the
        model's audio vocabulary (a codec that does not fit the model)."""
        m, t = self.mcfg, self.tcfg
        item = self.data[index]
        pf = os.path.join(t.dataset_dir, t.phn_folder_name, item[1] + ".txt")
        ef = os.path.join(t.dataset_dir, t.encodec_folder_name, item[1] + ".txt")
        try:
            with open(pf) as p:
                phns = p.read().strip().splitlines()
            if len(phns) != 1:
                return None
            x = [self.phn2num[w] for w in phns[0].split(" ")
                 if w not in SYMBOL_SET]
        except (OSError, KeyError):
            return None
        y = load_codes(ef, m.n_codebooks)
        if y is None:
            return None
        if int(y.max()) >= m.audio_vocab_size:
            raise ValueError(
                f"{ef}: codec code {int(y.max())} >= model audio_vocab_size "
                f"{m.audio_vocab_size} — the dataset was encoded with an "
                f"incompatible codec for this model config")
        if m.special_first:
            y = y + m.n_special
        x = np.asarray(x, np.int32)

        # crop policy (reference gigaspeech.py:88-121)
        max_len = int(t.audio_max_length * m.encodec_sr)
        orig_y_len = y.shape[1]
        audio_start = 0
        if y.shape[1] > max_len:
            audio_start = int(rng.integers(0, y.shape[1] - max_len))
            y = y[:, audio_start:audio_start + max_len]
        if audio_start > 0 and len(x) > t.text_max_length:
            x = x[int(len(x) * audio_start / orig_y_len):]
        if len(x) > t.text_max_length:
            start = int(rng.integers(0, len(x) - t.text_max_length + 1))
            x = x[start:start + t.text_max_length]
        if len(x) < int(t.text_min_length):
            return None
        if y.shape[1] < m.encodec_sr * t.audio_min_length:
            return None
        return x, y


# ---- dynamic batching (reference steps/trainer_utils.py:408-628) ------------------

def lognorm_boundaries(max_batch_length: int, num_buckets: int) -> np.ndarray:
    """Lognormal-quantile bucket boundaries (reference
    trainer_utils.py:408-437)."""
    from scipy.stats import lognorm
    num_boundaries = num_buckets + 1
    latent = np.linspace(1 / num_boundaries,
                         num_buckets / num_boundaries, num_buckets)
    q = lognorm.ppf(latent, 1)
    return np.sort(q * max_batch_length / q[-1])


@dataclass
class DynamicBatcher:
    """Deterministic token-budget batcher with a host-strided split."""

    lengths: Sequence[int]
    max_num_tokens: int
    num_buckets: int = 6
    seed: int = 1
    num_hosts: int = 1
    host: int = 0
    max_batch_ex: int = 128
    drop_last: bool = False

    def __post_init__(self):
        self.boundaries = lognorm_boundaries(self.max_num_tokens,
                                             self.num_buckets)
        self.bucket_lens = [max(1, int(self.max_num_tokens / b))
                            for b in self.boundaries]

    def epoch_batches(self, epoch: int) -> List[List[int]]:
        """This host's batches of an epoch: the same list on every host,
        then this host's stride (every host gets as many batches)."""
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(len(self.lengths))
        batches: List[List[int]] = []
        buckets: List[List[int]] = [[] for _ in range(len(self.bucket_lens) + 1)]
        for idx in order:
            b = int(np.searchsorted(self.boundaries, self.lengths[idx]))
            buckets[b].append(int(idx))
            cap = (self.bucket_lens[b] if b < len(self.bucket_lens)
                   else self.bucket_lens[-1])
            if len(buckets[b]) >= min(cap, self.max_batch_ex):
                batches.append(buckets[b])
                buckets[b] = []
        if not self.drop_last:
            batches.extend(b for b in buckets if b)
        perm = np.random.default_rng(self.seed + epoch + 1).permutation(len(batches))
        batches = [batches[i] for i in perm]
        mine = batches[self.host::self.num_hosts]
        if self.num_hosts > 1:
            mine = mine[:len(batches) // self.num_hosts]
        return mine


# ---- static-shape collate ------------------------------------------------------------

def _ceil(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def collate_train(dataset: ManifestDataset, indices: Sequence[int],
                  rng: np.random.Generator, pad_multiple: int = 64,
                  device="cuda") -> Optional[TrainBatch]:
    """Load, sample spans, compose and pad in numpy; returns a TrainBatch
    of torch tensors on ``device`` (None where no item of the batch
    loads)."""
    m, t = dataset.mcfg, dataset.tcfg
    K = m.n_codebooks
    xs, comps = [], []
    for i in indices:
        item = dataset.load_item(i, rng)
        if item is None:
            continue  # dropped, as the reference's collate drops it
        x, y = item
        mi, nmi = spans.sample_mask_intervals(rng, y.shape[1], m)
        comps.append(spans.compose_sequence(y, mi, nmi, m, rng))
        xs.append(x)
    if not xs:
        return None
    B = len(xs)
    Sx = (t.text_max_length if t.pad_x
          else _ceil(max(len(x) for x in xs), 16))
    Sy = _ceil(max(c.length for c in comps), pad_multiple)

    x_arr = np.full((B, Sx), m.text_pad_token, np.int32)
    x_lens = np.zeros((B,), np.int32)
    y_tok = np.full((B, K, Sy), m.audio_pad_token, np.int32)
    y_lens = np.zeros((B,), np.int32)
    midx = np.full((B, Sy), -1, np.int32)
    tval = np.zeros((B, K, Sy), bool)
    for b, (x, c) in enumerate(zip(xs, comps)):
        L = min(len(x), Sx)
        x_arr[b, :L] = x[:L]
        x_lens[b] = L
        y_tok[b, :, :c.length] = c.tokens
        y_lens[b] = c.length
        midx[b, :c.length] = c.mask_emb_idx
        tval[b, :, :c.length] = spans.target_valid_from_real(c.real)
    return TrainBatch(*(torch.from_numpy(a).to(device)
                        for a in (x_arr, x_lens, y_tok, y_lens, midx, tval)))


def write_manifest_tree(root: str, items: List[dict], mcfg: ModelConfig,
                        split: str = "train") -> None:
    """Write a dataset tree in the reference's format (the preprocessing
    CLI's output).  items: [{'id', 'phones': [str], 'codes': [K][T] int}];
    a second split's phones join the vocabulary the first one wrote."""
    os.makedirs(os.path.join(root, "manifest"), exist_ok=True)
    os.makedirs(os.path.join(root, "phonemes"), exist_ok=True)
    os.makedirs(os.path.join(root, "encodec_16khz_4codebooks"), exist_ok=True)
    vocab_fn = os.path.join(root, "vocab.txt")
    vocab: Dict[str, int] = {}
    if os.path.exists(vocab_fn):
        vocab = load_vocab(vocab_fn)
    for it in items:
        for p in it["phones"]:
            vocab.setdefault(p, len(vocab))
    with open(vocab_fn, "w") as f:
        for p, i in sorted(vocab.items(), key=lambda kv: kv[1]):
            f.write(f"{i} {p}\n")
    with open(os.path.join(root, "manifest", split + ".txt"), "w") as f:
        for it in items:
            T = len(it["codes"][0])
            f.write(f"0\t{it['id']}\t{T}\n")
    for it in items:
        with open(os.path.join(root, "phonemes", it["id"] + ".txt"), "w") as f:
            f.write(" ".join(it["phones"]))
        with open(os.path.join(root, "encodec_16khz_4codebooks",
                               it["id"] + ".txt"), "w") as f:
            for row in it["codes"]:
                f.write(" ".join(str(int(v)) for v in row) + "\n")
