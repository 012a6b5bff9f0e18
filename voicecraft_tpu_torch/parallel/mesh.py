"""A 2-D (data, model) mesh of processes for lane-sharded and tensor-parallel
serving and dp x tp training with ZeRO-1 (PyTorch port of
voicecraft_tpu/parallel/mesh.py).

JAX's mesh is one controller with GSPMD: arrays are sharded and XLA inserts
the collectives.  This mesh is SPMD: one process per card, each holding its
shard of the parameters and of the batch, with ``torch.distributed``
(NCCL on the card, gloo on the CPU) and explicit collectives:

* rank = d * n_model + m, the layout of JAX's ``reshape(n_data, n_model)``;
  one process group per data row (its n_model ranks: the 'model' axis) and
  one per model column (its n_data ranks: the 'data' axis);
* megatron-style tensor parallelism over 'model': q/k/v, the first FFN
  projection and the heads' first layer are column-parallel (each rank
  holds nhead / n_model heads and ffn_dim / n_model columns), the attention
  output, the second FFN projection and the heads' second layer
  row-parallel, each followed by ONE all-reduce over 'model' and then its
  bias, added once (:func:`copy_to_model` / :func:`reduce_model`);
* the text, audio and mask embeddings are sharded along D over 'model' and
  all-gathered after the lookup (:func:`gather_model`);
* lanes and training rows are sharded over 'data': each rank's local batch
  is its shard, and the training gradients are summed over 'data';
* ZeRO-1: the optimizer's moments are sharded over 'data' along the axis
  :func:`_extend_with_data` picks, as the JAX package shards them
  (:func:`zero1_opt_shardings`).

An axis of size 1 has no process group and no collective, so a 1 x 1 mesh
computes exactly what the model computes without one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import block_of

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(eq=False)
class Mesh:
    """This process's place in an (n_data, n_model) mesh: its coordinates,
    the process groups of its two axes (None for an axis of size 1) and its
    device.  ``shape`` reads as JAX's ``mesh.shape``."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def rank(self) -> int:
        return self.data_rank * self.n_model + self.model_rank

    def __deepcopy__(self, memo):
        # process groups do not copy; a copied model shares its mesh
        return self


def make_mesh(n_data: int, n_model: int, device=None) -> Mesh:
    """The mesh over the initialised default process group, whose world must
    be n_data * n_model.  Every rank must call it (``new_group`` is
    collective): rank d * n_model + m gets coordinates (d, m).  ``device``
    defaults to the current CUDA device under NCCL, else the CPU."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} ranks; the world has {world}")
    d, m = divmod(dist.get_rank(), n_model)
    data_group = model_group = None
    # every rank creates every group, in the same order
    if n_model > 1:
        for dd in range(n_data):
            g = dist.new_group([dd * n_model + mm for mm in range(n_model)])
            if dd == d:
                model_group = g
    if n_data > 1:
        for mm in range(n_model):
            g = dist.new_group([dd * n_model + mm for dd in range(n_data)])
            if mm == m:
                data_group = g
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(n_data, n_model, d, m, data_group, model_group,
                torch.device(device))


def _model_split(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.n_model > 1


def _data_split(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.n_data > 1


# ---- collectives over 'model' (megatron's f and g) ---------------------------------

class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over 'model' (the
    input of a column-parallel block: each rank's heads contribute part of
    its gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.model_group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over 'model' forward (the partial products of a row-parallel
    block); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


# the flat collectives (their newer names where this torch has them)
_all_gather_flat = getattr(dist, "all_gather_single",
                           dist.all_gather_into_tensor)
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single",
                               dist.reduce_scatter_tensor)


def _all_gather_last(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """The n ranks' x concatenated along the last axis."""
    out = x.new_empty((n * x.numel(),))
    _all_gather_flat(out, x.reshape(-1), group=group)
    return torch.cat(out.view((n,) + tuple(x.shape)).unbind(0), dim=-1)


class _GatherFromModel(torch.autograd.Function):
    """All-gather along the last axis over 'model' forward; the backward
    keeps this rank's slice (the gathered activation is replicated over
    'model', and so is its gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return _all_gather_last(x, mesh.n_model, mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        w, m = ctx.width, ctx.mesh.model_rank
        return g[..., m * w:(m + 1) * w].contiguous(), None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Megatron's f: identity forward, gradient all-reduced over 'model'."""
    return _CopyToModel.apply(x, mesh) if _model_split(mesh) else x


def reduce_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Megatron's g: the sum over 'model' forward, identity backward.  The
    partial products are summed in their own dtype (NCCL rounds each sum
    to it)."""
    return (_ReduceFromModel.apply(x, mesh.model_group) if _model_split(mesh)
            else x)


def gather_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """x [..., w] of each model rank -> [..., n_model * w], in rank order."""
    return _GatherFromModel.apply(x, mesh) if _model_split(mesh) else x


def gather_table_cols(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """A lookup ``x`` [..., D / n_model] of a D-sharded embedding ``table``
    (tagged ``table.mesh`` by :func:`shard_params`) all-gathered to
    [..., D]; any other table's lookup as it is."""
    return gather_model(x, getattr(table, "mesh", None))


# ---- collectives over 'data' ---------------------------------------------------------

def reduce_data(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum over 'data' (a loss or a count of the global batch), with an
    identity backward: each rank's gradient is that of its own rows, and
    the step sums the gradients over 'data'."""
    return (_ReduceFromModel.apply(x, mesh.data_group) if _data_split(mesh)
            else x)


def all_reduce_data_(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """In-place sum of ``t`` over 'data'."""
    if _data_split(mesh):
        dist.all_reduce(t, group=mesh.data_group)
    return t


def all_reduce_model_(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """In-place sum of ``t`` over 'model'."""
    if _model_split(mesh):
        dist.all_reduce(t, group=mesh.model_group)
    return t


def reduce_scatter_data(t: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    """The sum of ``t`` over 'data', of which this rank keeps slice
    ``data_rank`` of ``n_data`` along ``axis``."""
    n = mesh.n_data
    src = t.movedim(axis, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _reduce_scatter_flat(out, src, group=mesh.data_group)
    return out.movedim(0, axis)


def all_gather_data(t: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    """The data ranks' slices ``t`` concatenated along ``axis``."""
    src = t.movedim(axis, 0).contiguous()
    out = src.new_empty((src.shape[0] * mesh.n_data,) + tuple(src.shape[1:]))
    _all_gather_flat(out, src, group=mesh.data_group)
    return out.movedim(0, axis)


def gather_objects(obj, mesh: Optional[Mesh]) -> list:
    """[obj of data rank 0, ..., of data rank n_data - 1] (picklable host
    objects; one call on every rank)."""
    if not _data_split(mesh):
        return [obj]
    out = [None] * mesh.n_data
    dist.all_gather_object(out, obj, group=mesh.data_group)
    return out


def data_slice(n: int, mesh: Optional[Mesh]) -> slice:
    """This data rank's rows of a global leading axis of n (n % n_data ==
    0, as JAX's ``batch_pspec`` sharding needs)."""
    if mesh is None:
        return slice(0, n)
    if n % mesh.n_data:
        raise ValueError(f"{n} rows do not shard over data={mesh.n_data}")
    w = n // mesh.n_data
    return slice(mesh.data_rank * w, (mesh.data_rank + 1) * w)


# ---- parameter placement -------------------------------------------------------------

# the decoder layer's parameters by the port's name: column-parallel
# projections shard their output columns, row-parallel ones their input rows
_LAYER_SPECS = {
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    "wqkv": (None, "model"), "bqkv": ("model",),
    "wo": ("model", None), "bo": (),
    "w1": (None, "model"), "b1": ("model",),
    "w2": ("model", None), "b2": (),
}
_TOP_SPECS = {
    "text_emb": (None, "model"),
    "audio_emb": (None, None, "model"),
    "mask_emb": (None, "model"),
    "heads.w1": (None, None, "model"),             # [K, D, half]
    "heads.b1": (None, "model"),
    "heads.w2": (None, "model", None),             # [K, half, card]
    "heads.b2": (),
}


def param_spec(name: str) -> Spec:
    """The placement of the port's parameter ``name`` (the JAX package's
    ``param_pspecs`` rule at its tree path, without the stacked layer
    axis): a tuple with "model" at the sharded axis, () when replicated.
    Alphas, every norm's parameters, the row-parallel biases, the MTP heads
    and anything unrecognised are replicated."""
    parts = name.split(".")
    leaf = parts[-1]
    if "alpha" in name or leaf.startswith(("ln1_", "ln2_")) \
            or name.startswith("decoder.final_ln_"):
        return ()
    if parts[:2] == ["decoder", "layers"] and len(parts) == 4:
        return _LAYER_SPECS.get(leaf, ())
    if parts[:2] == ["decoder", "layers"] and len(parts) == 5:
        return _LAYER_SPECS.get(parts[3], ())      # an fp8 weight's q / scale
    return _TOP_SPECS.get(name, ())


def param_pspecs(model: torch.nn.Module) -> Dict[str, Spec]:
    """{name: spec} for every parameter and buffer of ``model``'s state."""
    return {name: param_spec(name) for name in model.state_dict()}


def _model_axis(spec: Spec) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def _slice(t: torch.Tensor, axis: int, i: int, n: int) -> torch.Tensor:
    w = t.shape[axis] // n
    return t.narrow(axis, i * w, w)


def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Keep this rank's slice of every model-sharded parameter of a model
    that holds the full state (every rank builds it identically), in place;
    the decoder then runs nhead / n_model local heads.  Records the mesh on
    the model, its decoder, layers and heads, and on the D-sharded
    embedding tables.  Returns the model.

    A weight-only fp8 decoder (utils/quantize.py) is refused under
    n_model > 1, as the JAX package cannot place its per-column scales
    [L, 1, D] under the row-parallel spec."""
    from ..utils.quantize import FP8Weight
    if getattr(model, "mesh", None) is not None:
        raise ValueError("the model is already sharded")
    n = mesh.n_model
    if n > 1:
        if block_of(model.cfg) != "voicecraft":
            raise ValueError(f"a 'model' split is not implemented for block "
                             f"{block_of(model.cfg)!r} (VoiceCraft's block "
                             "only)")
        if any(isinstance(m, FP8Weight) for m in model.modules()):
            raise ValueError("a weight-only fp8 decoder cannot be sharded "
                             "over model > 1 (the JAX package places its "
                             "per-column scales under the row-parallel "
                             "spec, which it cannot shard)")
        cfg = model.cfg
        for what, size in (("nhead", cfg.nhead), ("ffn_dim", cfg.ffn_dim),
                           ("d_model", cfg.d_model),
                           ("audio_vocab_size // 2",
                            cfg.audio_vocab_size // 2)):
            if size % n:
                raise ValueError(f"{what} {size} does not shard over "
                                 f"model={n}")
        with torch.no_grad():
            for name, p in model.named_parameters():
                axis = _model_axis(param_spec(name))
                if axis is not None:
                    p.data = _slice(p.data, axis, mesh.model_rank, n).clone()
        model.decoder.nhead = cfg.nhead // n
    model.mesh = mesh
    model.decoder.mesh = mesh
    for layer in model.decoder.layers:
        layer.mesh = mesh
    model.heads.mesh = mesh
    for table in (model.text_emb, model.audio_emb, model.mask_emb):
        table.mesh = mesh
    return model


def gather_params(model: torch.nn.Module,
                  state: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """The full state_dict of a sharded model (every rank calls it; every
    rank gets it): the inverse of :func:`shard_params`.  ``state``: a dict
    of the model's parameter names to tensors of their local shapes (its
    gradients, say) to gather instead.  An unsharded model's as it is."""
    mesh = getattr(model, "mesh", None)
    state = model.state_dict() if state is None else state
    if not _model_split(mesh):
        return state
    out = {}
    for name, t in state.items():
        axis = _model_axis(param_spec(name))
        out[name] = t if axis is None else _gather_axis(
            t, axis, mesh.n_model, mesh.model_group)
    return out


def shard_state(state: Dict[str, torch.Tensor], mesh: Mesh
                ) -> Dict[str, torch.Tensor]:
    """A full state_dict (:func:`gather_params`'s, or a checkpoint's) as
    this rank's shards, to load into a model sharded over ``mesh``."""
    if not _model_split(mesh):
        return dict(state)
    out = {}
    for name, t in state.items():
        axis = _model_axis(param_spec(name))
        out[name] = t if axis is None else _slice(
            t, axis, mesh.model_rank, mesh.n_model).clone()
    return out


def _gather_axis(t: torch.Tensor, axis: int, n: int, group) -> torch.Tensor:
    return _all_gather_last(t.movedim(axis, -1), n, group).movedim(-1, axis)


def batch_pspec(leaf_ndim: int) -> Spec:
    """The leading batch dimension sharded over 'data'."""
    return ("data",) + (None,) * (leaf_ndim - 1)


def shard_batch(batch, mesh: Mesh):
    """A rank's local batch is its shard of the global one (SPMD: JAX's
    multi-process branch); moved to the mesh's device.  ``batch`` is a
    NamedTuple of tensors (models.voicecraft.TrainBatch)."""
    return type(batch)(*(t.to(mesh.device) for t in batch))


# ---- ZeRO-1: optimizer state sharded over 'data' --------------------------------------

def _extend_with_data(spec: Spec, shape, dp: int) -> Spec:
    """Shard the first free (None) axis divisible by ``dp`` over 'data'.

    Keeps any existing 'model' placements (so the elementwise optimizer math
    never reshards the TP axis); leaves too small or indivisible stay as-is.
    """
    s = tuple(spec) + (None,) * (len(shape) - len(spec))
    for i, (ax, dim) in enumerate(zip(s, shape)):
        if ax is None and dim % dp == 0 and dim >= dp:
            return s[:i] + ("data",) + s[i + 1:]
    return s


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """The placement of one optimizer leaf, in the JAX package's leaf
    coordinates: a decoder parameter (or MTP head parameter) stacked over
    its layers (groups) [L, ...], or one tensor.  ``spec`` holds "model"
    and, under ZeRO-1, "data" at the axes they shard."""
    spec: Spec
    stacked: bool

    @property
    def model_axis(self) -> Optional[int]:
        return _model_axis(self.spec)

    @property
    def data_axis(self) -> Optional[int]:
        return self.spec.index("data") if "data" in self.spec else None


def _stacked(name: str) -> bool:
    return name.startswith(("decoder.layers.", "mtp_heads."))


def leaf_layouts(model: torch.nn.Module,
                 groups: Sequence[Sequence[torch.Tensor]]) -> List[LeafLayout]:
    """The tensor-parallel layout of each optimizer leaf (a group of
    tensors of ``model``, training/optim.py:stacked_leaves), no 'data'."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = []
    for g in groups:
        name = names[id(g[0])]
        spec = param_spec(name)
        stacked = _stacked(name)
        out.append(LeafLayout(((None,) + spec) if stacked else spec, stacked))
    return out


def zero1_opt_shardings(model: torch.nn.Module, optimizer, mesh: Mesh
                        ) -> Optional[List[LeafLayout]]:
    """ZeRO-1 layout of ``optimizer``'s leaves, or None if unsupported.

    The big param-shaped moments (ScaledAdam's ``delta`` / ``exp_avg_sq``,
    AdamW's ``exp_avg`` / ``exp_avg_sq``, ~8 bytes/param f32) are sharded
    over the mesh's 'data' axis: each data rank owns the
    :func:`_extend_with_data` slice of each leaf (the JAX package's choice
    of axis, on its stacked leaf shapes), reduce-scatters the gradients
    onto it, updates it and all-gathers the update.  Same bytes on the wire
    as DDP, 1/dp the optimizer memory per card.

    Supports the port's ScaledAdam and AdamW, over all parameters or the
    trained subset (``train_mtp_only``: the optimizer holds only the MTP
    heads).  Anything else, or a mesh with data = 1, returns None (the
    caller keeps the replicated layout)."""
    from ..training.optim import AdamW, ScaledAdam
    dp = mesh.n_data
    if dp <= 1 or not isinstance(optimizer, (ScaledAdam, AdamW)):
        return None
    return with_data_axes(leaf_layouts(model, optimizer.groups),
                          optimizer.groups, dp)


def with_data_axes(layouts: Sequence[LeafLayout],
                   groups: Sequence[Sequence[torch.Tensor]], dp: int
                   ) -> List[LeafLayout]:
    """Each leaf's layout with 'data' at the axis ZeRO-1 shards over ``dp``
    data ranks (:func:`_extend_with_data` on its stacked shape; the 'model'
    axis holds local widths, which it skips); a layout that has a 'data'
    axis already stays as it is.  The optimizers sum over these pieces in
    both layouts, so that ZeRO-1 changes no bit."""
    out = []
    for layout, g in zip(layouts, groups):
        if layout.data_axis is None:
            shape = ((len(g),) + tuple(g[0].shape)) if layout.stacked \
                else tuple(g[0].shape)
            layout = LeafLayout(_extend_with_data(layout.spec, shape, dp),
                                layout.stacked)
        out.append(layout)
    return out


# ---- a leaf's pieces under ZeRO-1 ----------------------------------------------------

def _tensor_axis(layout: LeafLayout, axis: int) -> int:
    """A leaf axis as an axis of each of its tensors."""
    return axis - 1 if layout.stacked else axis


def owned_pieces(layout: LeafLayout, tensors: Sequence[torch.Tensor],
                 mesh: Optional[Mesh], rank: Optional[int] = None
                 ) -> List[torch.Tensor]:
    """Data rank ``rank``'s (default: this rank's) pieces of a leaf's
    tensors: all of them when the leaf is not sharded over 'data'; layers
    [r n / dp, (r + 1) n / dp) of n when its layer axis is; else slice r of
    each tensor along the sharded axis (views)."""
    a = layout.data_axis
    if a is None or not _data_split(mesh):
        return list(tensors)
    r, dp = mesh.data_rank if rank is None else rank, mesh.n_data
    if layout.stacked and a == 0:
        w = len(tensors) // dp
        return list(tensors[r * w:(r + 1) * w])
    return [_slice(t, _tensor_axis(layout, a), r, dp) for t in tensors]


def scatter_grads(layout: LeafLayout, grads: Sequence[torch.Tensor],
                  mesh: Mesh) -> List[torch.Tensor]:
    """A leaf's gradients summed over 'data', as this rank's pieces
    (:func:`owned_pieces`): reduce-scattered onto a data-sharded leaf,
    all-reduced (in place) on any other."""
    a = layout.data_axis
    if a is None:
        return [all_reduce_data_(g, mesh) for g in grads]
    if layout.stacked and a == 0:
        return list(reduce_scatter_data(torch.stack(list(grads)), mesh,
                                        0).unbind(0))
    return [reduce_scatter_data(g, mesh, _tensor_axis(layout, a))
            for g in grads]


def sum_grads(layout: LeafLayout, grads: Sequence[torch.Tensor],
              mesh: Mesh) -> List[torch.Tensor]:
    """A leaf's gradients summed over 'data', whole: :func:`scatter_grads`'
    reduce-scatter, then its pieces all-gathered, so that a replicated
    layout holds bit for bit the sums that ZeRO-1's pieces hold."""
    return gather_pieces(layout, scatter_grads(layout, grads, mesh), mesh)


def stack_ranks(t: torch.Tensor, mesh: Mesh,
                axis: Optional[str] = None) -> torch.Tensor:
    """``t`` of every rank of the mesh's ``axis`` ("data", "model", or None:
    every rank, d * n_model + m) stacked in rank order along a new leading
    axis."""
    n, group = {"data": (mesh.n_data, mesh.data_group),
                "model": (mesh.n_model, mesh.model_group),
                None: (mesh.n_data * mesh.n_model, None)}[axis]
    if n == 1:
        return t[None]
    out = t.new_empty((n * t.numel(),))
    _all_gather_flat(out, t.reshape(-1).contiguous(), group=group)
    return out.view((n,) + tuple(t.shape))


def gather_pieces(layout: LeafLayout, pieces: Sequence[torch.Tensor],
                  mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """Every data rank's pieces of a leaf, whole (:func:`owned_pieces`'s
    inverse)."""
    a = layout.data_axis
    if a is None or not _data_split(mesh):
        return list(pieces)
    if layout.stacked and a == 0:
        return list(all_gather_data(torch.stack(list(pieces)), mesh,
                                    0).unbind(0))
    return [all_gather_data(p, mesh, _tensor_axis(layout, a)) for p in pieces]


def gather_model_pieces(layout: LeafLayout, tensors: Sequence[torch.Tensor],
                        mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """A leaf's tensors gathered over 'model' (its global shapes)."""
    a = layout.model_axis
    if a is None or not _model_split(mesh):
        return list(tensors)
    return [_gather_axis(t, _tensor_axis(layout, a), mesh.n_model,
                         mesh.model_group) for t in tensors]


def slice_model_pieces(layout: LeafLayout, tensors: Sequence[torch.Tensor],
                       mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """A leaf's global tensors as this model rank's slices (copies)."""
    a = layout.model_axis
    if a is None or not _model_split(mesh):
        return list(tensors)
    return [_slice(t, _tensor_axis(layout, a), mesh.model_rank,
                   mesh.n_model).clone() for t in tensors]
