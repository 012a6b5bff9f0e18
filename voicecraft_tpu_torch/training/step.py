"""The training step: forward, loss, gradients and the optimizer's update
(PyTorch port of voicecraft_tpu/training/step.py).

bf16 compute needs no loss scaling.  A batch whose loss is not finite skips
the update wholesale: the parameters and the optimizer's state stay as they
were, and ``metrics['is_nan']`` is 1 (the reference's NaN guard,
steps/trainer.py:98-109).

On a model sharded over a mesh (parallel/mesh.py) each rank steps on its
data rank's rows: forward_train's loss and metrics are those of the global
batch, and the gradients are SUMMED over 'data' (ScaledAdam differentiates
the un-normalised loss; every other optimizer loss / the global
effective_ntoken) by the optimizer, which runs over the mesh (``shard``:
ZeRO-1's reduce-scatter in both layouts).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.transformer import fold_seed
from ..models.voicecraft import TrainBatch, VoiceCraft, forward_train


def make_train_step(model: VoiceCraft, optimizer, remat: bool = True,
                    grad_accum: int = 1, normalize_loss: bool = False):
    """Returns step(batch, seed) -> metrics, which updates the model's
    trainable parameters and ``optimizer`` in place.

    ``grad_accum`` > 1 splits the batch into that many stripes of
    consecutive rows (the batch size must divide; the trainer pads with
    fully-masked rows), each with its own dropout seed derived from
    ``seed``, and SUMS their gradients, as the reference's raw-sum backward
    for ScaledAdam does (steps/trainer.py:87-141).  ``normalize_loss``
    differentiates loss / effective_ntoken instead (the reference's
    objective for every other optimizer).  The metrics carry the raw loss
    either way, as 0-d / [K] / [n_mtp] tensors, and is_nan as a float."""
    params = [p for p in model.parameters() if p.requires_grad]
    mtp = getattr(model, "mtp_heads", None) is not None
    mesh = model.mesh
    if (mesh is not None and mesh.n_data > 1
            and getattr(optimizer, "mesh", None) is not mesh):
        raise ValueError("the model is sharded over a mesh with data > 1: "
                         "shard the optimizer over the same mesh (it sums "
                         "the gradients over 'data')")

    def backward(batch: TrainBatch, seed: Optional[int]) -> dict:
        out = forward_train(model, batch, seed=seed, remat=remat)
        obj = out["loss"]
        if normalize_loss:
            obj = obj / out["effective_ntoken"].clamp(min=1).to(obj.dtype)
        obj.backward()
        return {k: v.detach() for k, v in out.items()}

    def step(batch: TrainBatch, seed: Optional[int]) -> dict:
        for p in params:
            p.grad = None
        if grad_accum <= 1:
            out = backward(batch, seed)
        else:
            B = batch.x.shape[0]
            if B % grad_accum:
                raise ValueError(f"batch of {B} rows does not split into "
                                 f"{grad_accum} stripes")
            mb = B // grad_accum
            outs = [backward(TrainBatch(*(t[i * mb:(i + 1) * mb] for t in batch)),
                             fold_seed(seed, i))
                    for i in range(grad_accum)]
            out = {k: sum(o[k] for o in outs) for k in outs[0]}
            if mtp:
                out["mtp_top1acc"] = out["mtp_top1acc"] / grad_accum
        ok = bool(torch.isfinite(out["loss"]))
        if ok:
            optimizer.step()
        keys = ["loss", "top10acc", "top10acc_by_codebook", "effective_ntoken"]
        metrics = {k: out[k] for k in keys + ["mtp_loss", "mtp_top1acc"]
                   if k in out}
        metrics["is_nan"] = 0.0 if ok else 1.0
        return metrics

    return step


def make_train_step_two_phase(model: VoiceCraft, optimizer,
                              remat: bool = True, grad_accum: int = 1,
                              normalize_loss: bool = False):
    """The JAX package's memory-lean step, which runs the gradients and the
    update as two executables so that activations and the optimizer's
    temporaries never coexist.  An eager PyTorch step already computes every
    gradient before the update, and frees the activations on the way: this
    is :func:`make_train_step`, kept under the JAX package's name."""
    return make_train_step(model, optimizer, remat=remat,
                           grad_accum=grad_accum, normalize_loss=normalize_loss)
