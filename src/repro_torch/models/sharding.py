"""Logical-axis -> mesh specs (MaxText-style), their DTensor placements,
and the collective plan of a sharded training step.

Parameters, caches and activations carry *logical* axis names ("embed",
"mlp", "heads", "vocab", "experts", ...).  A rule set maps each logical
axis to zero or more mesh axes; `tree_pspecs` applies the rules to a
whole tree of axis tuples, skipping mesh axes that do not divide the
dimension (so the same rules work for every architecture).  This is the
JAX package's `models/sharding.py`, with two differences:

  * a spec is a `Spec`, a tuple with one entry per dimension: None, one
    mesh-axis name, or a tuple of names (major first), as the entries of
    jax's `PartitionSpec`;
  * the mesh sizes are passed explicitly (the JAX package passes them
    through a module global that `tree_pspecs` sets), and
    `ParallelCtx.mesh` is a `torch.distributed` `DeviceMesh` or a plain
    name -> size mapping, so specs for a production mesh are computed
    with no ranks at all.

`Sharding` pairs a mesh with a spec (the counterpart of jax's
`NamedSharding`) and gives its DTensor placements.  `local_shard`,
`distribute` and `to_local` move a tensor between its full form and a
rank's block without a collective where none is needed; `gather_dim`,
`reduce_scatter_dim`, `all_reduce` and `fan_out` are the explicit
collectives of the sharded layers.  Each has a backward, under one rule
(`full`'s docstring): a value the same on every rank of an axis carries
the whole gradient there, so the sharded train step differentiates the
rank's own computation and sums only where ranks saw different data.

Default layout (single pod 16x16, multi-pod 2x16x16):
    batch   -> ("pod", "data")     tensor axes -> "model"
    fsdp: the "embed" axis of *weights* is sharded over "data" (2D weight
    sharding, ZeRO-3 style).

`CollectiveOp` / `step_collective_ops` derive the ordered collectives a
sharded train step issues from the architecture config alone; the
collective workloads (`workloads/collective.py`) need them, and they
need neither a mesh nor torch.  The pipeline x expert x ZeRO-1 step
is `models.pipeline_step`'s.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any

import torch

from .. import tree as T


class Spec(tuple):
    """A partition spec: one entry per dimension, each None (replicated),
    a mesh-axis name, or a tuple of mesh-axis names (major first)."""


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry, as a tuple (major first)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh` or of a name -> size mapping."""
    if isinstance(mesh, Mapping):
        return {k: int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: Any                         # DeviceMesh, or {axis name: size}
    batch_axes: tuple = ("data",)     # ("pod", "data") multi-pod
    model_axis: str = "model"
    fsdp_axes: tuple = ("data",)      # weight "embed" dim sharding
    # rules: logical axis -> tuple of mesh axes (applied if divisible)
    extra_rules: Any = None

    def rules(self, *, for_weights: bool) -> dict:
        r = {
            "batch": tuple(self.batch_axes),
            "vocab": (self.model_axis,),
            "heads": (self.model_axis,),
            "kv": (self.model_axis,),
            "mlp": (self.model_axis,),
            "experts": (self.model_axis,),
            "qkv": (),
            "layers": (),
            "seq": (),
            "embed": tuple(self.fsdp_axes) if for_weights else (),
        }
        if self.extra_rules:
            r.update(self.extra_rules)
        return r

    @property
    def mesh_shape(self) -> dict:
        return mesh_shape(self.mesh)

    def axis_size(self, names) -> int:
        sizes = self.mesh_shape
        return math.prod(sizes[nm] for nm in names)


def _spec_for(axes: tuple, shape: tuple, rules: dict, sizes: dict) -> Spec:
    """The spec of one array, dropping mesh axes that do not divide."""
    parts = []
    used = set()
    for dim, ax in enumerate(axes):
        if ax is None or ax not in rules:
            parts.append(None)
            continue
        mesh_axes = tuple(a for a in rules[ax] if a not in used)
        size = math.prod(sizes[a] for a in mesh_axes)
        if mesh_axes and shape[dim] % size == 0:
            parts.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
            used.update(mesh_axes)
        else:
            # try a prefix of the mesh axes that divides
            ok = None
            for k in range(len(mesh_axes) - 1, 0, -1):
                sub = mesh_axes[:k]
                if shape[dim] % math.prod(sizes[a] for a in sub) == 0:
                    ok = sub
                    break
            if ok:
                parts.append(ok if len(ok) > 1 else ok[0])
                used.update(ok)
            else:
                parts.append(None)
    return Spec(parts)


def is_axes_leaf(x) -> bool:
    """A logical-axes tuple (a leaf of an axes tree)."""
    return isinstance(x, tuple) and len(x) > 0 and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_pspecs(axes_tree, shape_tree, ctx: ParallelCtx,
                for_weights: bool = True):
    """Map a tree of logical-axis tuples + shapes (tensors, meta tensors
    or anything with `.shape`) to a tree of `Spec`s."""
    rules = ctx.rules(for_weights=for_weights)
    sizes = ctx.mesh_shape
    shapes = T.leaves(shape_tree)
    axes = T.leaves(axes_tree, is_leaf=is_axes_leaf)
    if len(shapes) != len(axes):
        raise ValueError(f"{len(axes)} axes tuples for {len(shapes)} arrays")
    return T.unflatten(axes_tree, [
        _spec_for(tuple(a), tuple(s.shape), rules, sizes)
        for a, s in zip(axes, shapes)], is_leaf=is_axes_leaf)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and a spec: how one tensor lies across the ranks."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)

    def shard_shape(self, shape) -> tuple:
        """The shape of one rank's block of a tensor of `shape`."""
        sizes = mesh_shape(self.mesh)
        return tuple(n // math.prod(sizes[a] for a in entry_axes(e))
                     for n, e in zip(shape, self.spec))


def is_sharding(x) -> bool:
    return isinstance(x, Sharding)


def tree_shardings(axes_tree, shape_tree, ctx: ParallelCtx,
                   for_weights: bool = True):
    return T.tree_map(lambda s: Sharding(ctx.mesh, s),
                      tree_pspecs(axes_tree, shape_tree, ctx, for_weights),
                      is_leaf=lambda x: isinstance(x, Spec))


def batch_spec(ctx: ParallelCtx, batch_size: int, ndim: int) -> Spec:
    """Spec for a [B, ...] array: shard batch if divisible, else replicate."""
    bsz_axes = tuple(ctx.batch_axes)
    if batch_size % ctx.axis_size(bsz_axes) == 0:
        return Spec((bsz_axes if len(bsz_axes) > 1 else bsz_axes[0],)
                    + (None,) * (ndim - 1))
    # try prefix
    for k in range(len(bsz_axes) - 1, 0, -1):
        if batch_size % ctx.axis_size(bsz_axes[:k]) == 0:
            sub = bsz_axes[:k]
            return Spec((sub if len(sub) > 1 else sub[0],)
                        + (None,) * (ndim - 1))
    return Spec((None,) * ndim)


def kv_split(cfg, ctx: ParallelCtx) -> bool:
    """Whether the attention caches shard their kv heads over the model
    axis (they tile it), rather than their sequence."""
    return cfg.attn_kind == "gqa" and \
        cfg.n_kv_heads % ctx.mesh_shape[ctx.model_axis] == 0


def cache_ctx(cfg, ctx: ParallelCtx) -> ParallelCtx:
    """`ctx` with the decode caches' rules: kv-head sharding where the kv
    heads tile the model axis, else sequence sharding (the distributed
    decode attention)."""
    if kv_split(cfg, ctx):
        extra = {"seq": (), "kv": (ctx.model_axis,)}
    else:
        extra = {"seq": (ctx.model_axis,), "kv": ()}
    return dataclasses.replace(ctx, extra_rules=extra)


# =====================================================================
# specs on a DeviceMesh: placements, local blocks, collectives
# =====================================================================

def placements(mesh, spec) -> list:
    """DTensor placements of `spec` on `mesh` (a DeviceMesh), one per mesh
    dimension.  A tensor dimension split over several mesh axes must name
    them in the mesh's order (DTensor splits major mesh dimension first,
    as jax does); any other order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dimension {dim} is split over "
                             f"{axes}, against the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def _block_index(mesh, axes) -> tuple:
    """(this rank's block index, block count) along the mesh axes `axes`
    (major first)."""
    sizes = mesh_shape(mesh)
    idx, n = 0, 1
    for a in axes:
        idx, n = idx * sizes[a] + mesh.get_local_rank(a), n * sizes[a]
    return idx, n


def local_shard(full: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of `full` laid out by `spec` (a slice, no
    collective); a block smaller than `full` is copied, so that the full
    tensor's memory can be freed."""
    out = full
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        idx, n = _block_index(mesh, axes)
        if full.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(full.shape)} does "
                             f"not split {n} ways")
        step = full.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    return out.clone() if out.numel() < full.numel() else out


def distribute(t: torch.Tensor, mesh, spec):
    """`t` as a DTensor laid out by `spec`: a full tensor is cut to this
    rank's block (every rank holds the same full tensor; no collective),
    a DTensor is redistributed."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements(mesh, spec))
    return DTensor.from_local(local_shard(t, mesh, spec), mesh,
                              placements(mesh, spec), run_check=False)


def to_local(t: torch.Tensor, mesh, spec, partial=()) -> torch.Tensor:
    """This rank's block of `t` laid out by `spec`: a DTensor is
    redistributed (collectives only where its layout differs), a plain
    tensor is taken as the full tensor, the same on every rank.  Under
    autograd, the block's gradient is summed over the mesh axes `partial`
    on which the block is whole (those whose ranks used it on different
    data) and taken as it is elsewhere, then laid out as `t`.  A DTensor
    is redistributed one mesh axis at a time, the minor axis first (as
    `gather_dim` gathers), so a leaf split over "data" and "model" is
    gathered over "model", then whole over "data"."""
    from torch.distributed.tensor import DTensor, Partial
    if isinstance(t, DTensor):
        pl = placements(mesh, spec)
        cur = list(t.placements)
        for i in reversed(range(1, len(pl))):    # minor mesh axis first
            if cur[i] != pl[i]:
                cur[i] = pl[i]
                t = t.redistribute(mesh, cur)
        # the last step always redistributes: its backward lays a
        # summed (Partial) gradient out as t is, where t already lay so
        t = t.redistribute(mesh, pl)
        # the gradient: summed over `partial` where the block is whole
        return t.to_local(grad_placements=[
            Partial() if n in partial and p.is_replicate() else p
            for n, p in zip(mesh.mesh_dim_names, pl)])
    return local_shard(t, mesh, spec)


def local_block(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block (without autograd, the tensor itself, so
    in-place updates reach the DTensor); any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def full(t: torch.Tensor, partial=()) -> torch.Tensor:
    """The full tensor of a DTensor (an all-gather where it is split); a
    plain tensor as it is.

    The gradient follows the rule of every collective here: a value the
    same on every rank of a mesh axis carries, on each rank, the whole
    gradient of the ranks' common computation; a value that differs
    between the ranks carries its own part.  So the full tensor's
    gradient is summed over the mesh axes `partial`, those on which the
    ranks used it on different data (the batch axes; the model axis
    under sequence parallelism), and taken as it is over the others, on
    which the ranks computed the same thing (summing there would multiply
    it by the axis size); then it is laid out as `t`: a reduce-scatter
    over a partial axis `t` is split on, an all-reduce over one it is
    whole on, a slice over another."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    return to_local(t, mesh, Spec((None,) * t.ndim), partial)


def _grad_on(t) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _all_gather(t, mesh, axes, dim):
    import torch.distributed as dist
    for a in reversed(axes):                       # minor axis first
        n = mesh_shape(mesh)[a]
        if n == 1:
            continue
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=mesh.get_group(a))
        t = out.movedim(0, dim)
    return t


def _reduce_scatter(t, mesh, axes, dim):
    import torch.distributed as dist
    for a in axes:                                 # major axis first
        n = mesh_shape(mesh)[a]
        if n == 1:
            continue
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=mesh.get_group(a))
        t = out.movedim(0, dim)
    return t


def _block(t, mesh, axes, dim):
    idx, n = _block_index(mesh, axes)
    step = t.shape[dim] // n
    return t.narrow(dim, idx * step, step)


def _sum_over(t, mesh, axes):
    import torch.distributed as dist
    t = t.clone()
    for a in axes:
        if mesh_shape(mesh)[a] > 1:
            dist.all_reduce(t, group=mesh.get_group(a))
    return t


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim, same):
        ctx.args = (mesh, axes, dim, same)
        return _all_gather(t, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, same = ctx.args
        g = _block(g, mesh, axes, dim) if same else \
            _reduce_scatter(g, mesh, axes, dim)
        return g.contiguous(), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _reduce_scatter(t, mesh, (axis,), dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return _all_gather(g, mesh, (axis,), dim), None, None, None


def _all_reduce_(t, mesh, axes, op: str = "sum"):
    """In-place all-reduce over each of `axes`, issued even over an axis
    of size 1."""
    import torch.distributed as dist
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for a in axes:
        dist.all_reduce(t, op=red, group=mesh.get_group(a))
    return t


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return _all_reduce_(t.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _FanOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.args = (mesh, axes)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, *ctx.args), None, None


class _Local(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.args = (mesh, (axis,), dim)
        return _block(t, mesh, (axis,), dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


def gather_dim(t: torch.Tensor, mesh, axes, dim: int,
               same: bool = False) -> torch.Tensor:
    """All-gather `t` along `dim` over the mesh axes `axes` (one name or
    a tuple, major first): the blocks of the ranks in rank order along
    those axes.  Over an axis of size 1 it is the identity and issues
    nothing.  Backward (the rule of `full`): with `same`, the ranks of
    `axes` go on to compute the same thing from the gathered tensor, so
    each keeps its block of the gradient; else each computed its own part
    (attention's keys and values under sequence parallelism), and the
    gradients are reduce-scattered."""
    axes = tuple(a for a in entry_axes(axes) if mesh_shape(mesh)[a] > 1)
    if axes and _grad_on(t):
        return _Gather.apply(t, mesh, axes, dim, same)
    return _all_gather(t, mesh, axes, dim)


def reduce_scatter_dim(t: torch.Tensor, mesh, axis: str,
                       dim: int) -> torch.Tensor:
    """Sum `t` over the mesh axis `axis` and keep this rank's block along
    `dim` (jax's tiled `psum_scatter`).  Over an axis of size 1 it is the
    identity and issues nothing.  Backward: the blocks' gradients are
    all-gathered."""
    if mesh_shape(mesh)[axis] > 1 and _grad_on(t):
        return _ReduceScatter.apply(t, mesh, axis, dim)
    return _reduce_scatter(t, mesh, (axis,), dim)


def all_reduce(t, mesh, axes, op: str = "sum"):
    """All-reduce of `t` over each of `axes` ("sum" or "max"), issued even
    over an axis of size 1, as the `psum` / `pmax` of the reference's
    `shard_map` bodies.  Without autograd it is in place and returns `t`;
    under autograd ("sum" only) it returns a new tensor, and its
    backward passes the gradient through: the sum is the same on every
    rank of `axes` and each uses it alike (the rule of `full`), so each
    rank's part enters it with the whole gradient."""
    axes = entry_axes(axes)
    if _grad_on(t):
        if op != "sum":
            raise NotImplementedError(f"all_reduce({op!r}) has no backward")
        return _AllReduce.apply(t, mesh, axes)
    return _all_reduce_(t, mesh, axes, op)


def fan_out(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """`t`, the same on every rank of the mesh axes `axes`, entering work
    split over them (each rank its experts, or its slice of d_ff): the
    identity, whose backward sums the ranks' partial gradients (an
    all-reduce over the axes of more than one rank), so that `t` carries
    the whole gradient on each (Megatron's "f")."""
    axes = entry_axes(axes)
    if _grad_on(t) and any(mesh_shape(mesh)[a] > 1 for a in axes):
        return _FanOut.apply(t, mesh, axes)
    return t


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """Activations whose sequence (dimension 1) is split over the mesh
    axis `axis` (sequence parallelism): `gather` all-gathers a dimension
    (`same` as `gather_dim`'s), `local` cuts this rank's block of it;
    under autograd `local`'s backward all-gathers the blocks' gradients
    (the tensor it cuts is the same on every rank)."""
    mesh: Any
    axis: str

    def gather(self, t: torch.Tensor, dim: int = 1,
               same: bool = False) -> torch.Tensor:
        return gather_dim(t, self.mesh, self.axis, dim, same)

    def local(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        if mesh_shape(self.mesh)[self.axis] > 1 and _grad_on(t):
            return _Local.apply(t, self.mesh, self.axis, dim)
        return _block(t, self.mesh, (self.axis,), dim)


# =====================================================================
# collective plan of a sharded training step (workload bridge, §9)
# =====================================================================

@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective a sharded train step issues, as traffic demand.

    phase groups ops that overlap in time (the workload engine turns
    each phase into one flow matrix); axis names the mesh axis whose
    groups communicate; bytes_per_chip is the payload each participant
    contributes.
    """
    phase: str                  # fsdp_gather | fwd_tp | moe_a2a | ...
    kind: str                   # all_reduce | all_gather | ...
    axis: str                   # mesh axis ("data" | "model")
    bytes_per_chip: float


def step_collective_ops(config, mesh_shape: dict, seq_len: int = 2048,
                        global_batch: int = 32, dtype_bytes: int = 2,
                        ) -> list[CollectiveOp]:
    """The ordered collectives of one training step under the JAX
    package's sharding rules (tensor axes -> "model", ZeRO-3 weight
    "embed" -> "data"), sized from the architecture config alone: per
    step
      1. all-gather the data-sharded weights        (fsdp_gather, data)
      2. 2 activation all-reduces per layer forward (fwd_tp, model)
      3. MoE token all-to-all, if experts exist     (moe_a2a, model)
      4. 2 activation all-reduces per layer backward (bwd_tp, model)
      5. reduce-scatter the gradients               (grad_reduce, data)
    `config` is duck-typed (any object with ModelConfig's size fields).
    """
    tm = int(mesh_shape.get("model", 1))
    dm = int(mesh_shape.get("data", 1))
    b_local = max(global_batch // max(dm, 1), 1)
    d = config.d_model
    hd = config.head_dim or d // config.n_heads
    attn = d * config.n_heads * hd + 2 * d * config.n_kv_heads * hd \
        + config.n_heads * hd * d
    dense_mlp = 3 * d * config.d_ff
    n_moe = config.n_layers // max(config.moe_every, 1) \
        if config.n_experts else 0
    mlp = (config.n_layers - n_moe) * dense_mlp \
        + n_moe * config.n_experts * dense_mlp
    params_tp = (config.n_layers * attn + mlp + 2 * config.vocab * d) / tm
    act = float(b_local) * seq_len * d * dtype_bytes

    # bytes_per_chip is always the FULL buffer size per participant;
    # ring-schedule (k-1)/k factors are applied downstream by
    # `collectives.collective_flow`, matching IciModel.collective_time_s
    ops: list[CollectiveOp] = []
    params_bytes = params_tp * dtype_bytes
    if dm > 1:
        ops.append(CollectiveOp("fsdp_gather", "all_gather", "data",
                                params_bytes))
    if tm > 1:
        ops.append(CollectiveOp("fwd_tp", "all_reduce", "model",
                                2 * config.n_layers * act))
        if n_moe:
            ops.append(CollectiveOp("moe_a2a", "all_to_all", "model",
                                    n_moe * act * max(config.top_k, 1)))
        ops.append(CollectiveOp("bwd_tp", "all_reduce", "model",
                                2 * config.n_layers * act))
    if dm > 1:
        ops.append(CollectiveOp("grad_reduce", "reduce_scatter", "data",
                                params_bytes))
    if not ops:   # unsharded mesh: the step still syncs grads pairwise
        ops.append(CollectiveOp("grad_reduce", "all_reduce", "data",
                                params_bytes))
    return ops
