"""Faults planted underneath a run's timed path, to show that the check
catches them: the tests at tiny size and ``tools/readings.py --fault`` at a
cell's own size.  Each returns the (module, name, replacement) to patch."""

from __future__ import annotations


def altered_token(vocab: int):
    """ops.sampling.sample with codebook 1's regular codes shifted by one:
    a token altered where it is produced."""
    import torch
    import voicecraft_tpu_torch.models.voicecraft as vc
    real = vc.sample

    def sample(*args, **kw):
        out = real(*args, **kw)
        bad = torch.where(out < vocab, (out + 1) % vocab, out)
        return torch.cat([out[..., :1], bad[..., 1:2], out[..., 2:]], -1)
    return vc, "sample", sample


def state_unchanged(vocab: int = 0):
    """The optimizer's step returns the state it was given."""
    import voicecraft_tpu_torch.training.optim as optim
    return optim.ScaledAdam, "step", lambda self: None


def half_batch(vocab: int = 0):
    """forward_train on the first half of the rows, its loss scaled to the
    whole batch: half of the batch left out, the mean taken over the rest."""
    import voicecraft_tpu_torch.training.step as step
    real = step.forward_train

    def forward_train(model, batch, *a, **kw):
        half = type(batch)(*(t[:max(1, t.shape[0] // 2)] for t in batch))
        out = real(model, half, *a, **kw)
        out["loss"] = out["loss"] * batch.x.shape[0] / half.x.shape[0]
        return out
    return step, "forward_train", forward_train


FAULTS = {"altered_token": altered_token, "state_unchanged": state_unchanged,
          "half_batch": half_batch}
