"""Multi-pod dry-run: run every (arch x shape) cell's step once on a fake
production mesh and count what one chip of it would do.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \
        --shape train_4k [--multi-pod] [--out build/dryrun]

The counterpart of the JAX package's `launch/dryrun.py`, which compiles
each cell for 256 (512) forced host devices and reads XLA's cost and
memory analyses.  Here rank 0 of a fake process group of 256 (512) ranks
(`torch.testing._internal.distributed.fake_pg`: every collective returns
at once) builds `Model(cfg, ctx)` on the 16 x 16 (2 x 16 x 16) mesh with
its parameters, optimizer state, caches and batch as fake CPU tensors
(`FakeTensorMode`: shapes, no storage), laid out by `param_shardings`,
`cache_specs` and `batch_specs`, and runs the cell's step once: train
(forward, backward and AdamW, `microbatches` parts), prefill or decode.
Prefill and decode hold bf16 weights, as the reference's do.  Three
counters watch the step:

  * `flops_per_chip`: `torch.utils.flop_counter.FlopCounterMode` (the
    products: mm, bmm, ...; every op runs on the rank's local blocks);
  * `collectives`: every collective's output bytes and count by the
    reference's five kinds (`all-reduce`, `all-gather`, `reduce-scatter`,
    `all-to-all`, `collective-permute`), as its `parse_collectives` sums
    the output shapes of the partitioned HLO; `raw_static.u1.
    collectives_by_axis` splits them by mesh axis;
  * `peak_bytes_per_chip`: the peak of the bytes of the storages the step
    allocates, alive at once (the counterpart of XLA's temp size: the
    arguments are not in it).  `argument_bytes_per_chip` are the local
    blocks of the step's arguments (parameters, optimizer state, caches,
    the batch's block); `output_bytes_per_chip` those of its results (a
    train step updates the parameters and the optimizer state in place
    and returns the loss and the grad norm: all of them count).

The record has exactly the keys of the reference's `run_cell`.  The port
runs the layers in true order, so nothing is extrapolated: `scan_reps`
is reported, `unroll2_s` is 0 and `raw_static`'s `u1` and `u2` hold the
same counts (the reference's formula then gives the counts themselves);
`lower_s` is the set-up, `compile_s` the counted step.  A quantity with
no eager counterpart is the reference's own default, -1:
`bytes_accessed_per_chip` (XLA's fusion-aware byte count).

Differences by design from the reference's partitioned HLO and from
`models.sharding.step_collective_ops` (its plan of a train step):

  * dense leaves are gathered whole at each use (FSDP-style, over
    "data" and "model"), where GSPMD shards the heads and d_ff over
    "model": every dense leaf is all-gathered per use (the embedding
    twice: lookup and head), and under `remat="full"` once more in the
    backward pass, per microbatch; the plan has one data-axis gather of
    the parameters per step;
  * so a dense layer runs whole on every model rank: no activation
    all-reduces over "model" (the plan's `fwd_tp` / `bwd_tp`); the
    model-axis collectives are the weight gathers, the MoE bodies' and
    distributed decode's reductions, and the grad norm's;
  * each gradient is reduce-scattered over the batch axes per use, where
    the plan reduce-scatters the parameters' bytes once per step; a leaf
    whole over "data" (the decode layout's, qk norms) is all-reduced;
  * decode all-gathers the Mamba2 state and conv window and the cross
    (k, v) of an encoder-decoder every step (their caches are not kept
    on their blocks), and the logits are gathered over the batch axes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import tree as T
from ..configs import SHAPES, canon, cells, get_config
from ..models import Model
from ..models import layers as L
from ..models.model import DecodeDims
from ..optim import adamw_init
from . import steps as St
from .mesh import make_production_mesh

# the collectives the port issues (c10d ops, and the functional ones
# DTensor issues) -> the reference's kind
_KIND_OF = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "_allgather_base_": "all-gather", "all_gather_into_tensor": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_NOT_COLLECTIVES = ("wait_tensor",)

# per-arch microbatch tuning, the reference's: fewer microbatches -> fewer
# FSDP weight gathers per step, as long as the activation peak fits
MICROBATCH_DEFAULTS = {"starcoder2_3b": 1, "gemma3_1b": 2}


def _fake_world(size: int) -> None:
    """A fake process group of `size` ranks (this process is rank 0)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _local_bytes(tree) -> int:
    """The bytes of the local blocks of a tree's tensors."""
    from torch.distributed.tensor import DTensor
    n = 0
    for t in T.leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
    return n


class StepCounter(TorchDispatchMode):
    """Tallies collectives (count and output bytes by kind and mesh axis)
    and the bytes of the storages allocated under it that are alive at
    once (current and peak).  DTensor ops pass through (NotImplemented),
    so it sees the local ops and collectives they issue.  `axis_of`:
    process group name -> mesh axis name."""

    def __init__(self, axis_of: dict):
        from torch.utils.weak import WeakIdKeyDictionary
        super().__init__()
        self.axis_of = axis_of
        self.by_axis: dict = {}
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        tensors = [t for t in torch.utils._pytree.tree_leaves(out)
                   if isinstance(t, torch.Tensor)]
        name = func._overloadpacket.__name__
        if func.namespace in ("c10d", "_c10d_functional") \
                and name not in _NOT_COLLECTIVES:
            row = self.by_axis.setdefault(
                (_KIND_OF[name], self._axis(list(args) +
                                            list(kwargs.values()))),
                {"count": 0, "bytes": 0})
            row["count"] += 1
            row["bytes"] += sum(t.numel() * t.element_size()
                                for t in tensors)
        for t in tensors:
            st = t.untyped_storage()
            if st not in self._seen:
                self._seen[st] = n = st.nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, n)
        return out

    def _free(self, n: int) -> None:
        self.live -= n

    def _axis(self, args) -> str:
        """The mesh axis of a collective's group: a functional
        collective names it, a c10d op holds it boxed."""
        import torch.distributed as dist
        for a in args:
            if isinstance(a, torch.ScriptObject):
                a = dist.ProcessGroup.unbox(a).group_name
            if isinstance(a, str) and a in self.axis_of:
                return self.axis_of[a]
        raise ValueError("a collective on a group outside the mesh")

    def collectives(self) -> dict:
        """{kind: {count, bytes}} over every axis."""
        out = {}
        for (kind, _), row in self.by_axis.items():
            d = out.setdefault(kind, {"count": 0, "bytes": 0})
            d["count"] += row["count"]
            d["bytes"] += row["bytes"]
        return out


def _fake_dtensors(shapes, shardings, dtype_of):
    """Fake DTensors laid out by `shardings`: each rank's block, empty."""
    from torch.distributed.tensor import DTensor
    from ..models import sharding as SH
    return T.unflatten(shapes, [
        DTensor.from_local(torch.empty(sh.shard_shape(t.shape),
                                       dtype=dtype_of(t.dtype)),
                           sh.mesh, sh.placements, run_check=False)
        for t, sh in zip(T.leaves(shapes),
                         T.leaves(shardings, is_leaf=SH.is_sharding))])


def _batch_block_bytes(b_shapes, b_shard) -> int:
    return sum(math.prod(b_shard[k].shard_shape(v.shape)) * v.element_size()
               for k, v in b_shapes.items())


def count_cell(arch: str, shape_name: str, multi_pod: bool,
               microbatches: int = 1, remat: str | None = None) -> dict:
    """Run the cell's step once on the fake mesh under the counters:
    {flops, peak_bytes, argument_bytes, output_bytes, by_axis, setup_s,
    step_s, counter}."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    t0 = time.perf_counter()
    cfg = get_config(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = SHAPES[shape_name]
    mode = shape["mode"]
    _fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    ctx = St.build_ctx(mesh)
    axis_of = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    model = Model(cfg, ctx)
    model._draw(L.META)
    serving = mode in ("prefill", "decode")
    # the mesh's rank table is a real tensor: let it in
    with FakeTensorMode(allow_non_fake_inputs=True):
        p_shapes, p_shard = St.param_shardings(model, ctx, serving_mode=mode)
        params = _fake_dtensors(
            p_shapes, p_shard, lambda dt: torch.bfloat16
            if serving and dt == torch.float32 else dt)
        model.load_param_tree(params)
        b_shapes, b_shard = St.batch_specs(model.cfg, shape, ctx)
        batch = {k: torch.empty(v.shape, dtype=v.dtype)
                 for k, v in b_shapes.items()}
        args_bytes = _local_bytes(params) + _batch_block_bytes(b_shapes,
                                                               b_shard)
        if mode == "train":
            opt = adamw_init(model.param_tree())
            args_bytes += _local_bytes(opt)
            step = St.make_train_step(model, St.TrainConfig(
                microbatches=microbatches))
            run = lambda: step(opt, batch)              # noqa: E731
        elif mode == "prefill":
            run = lambda: model.prefill(batch["tokens"],  # noqa: E731
                                        batch.get("frames"))
        else:
            dims = DecodeDims(batch=shape["global_batch"],
                              seq=shape["seq_len"])
            caches = model.init_cache(dims)
            args_bytes += _local_bytes(caches)
            run = lambda: model.decode_step(  # noqa: E731
                caches, batch["tokens"], shape["seq_len"] // 2)
        t1 = time.perf_counter()
        counter = StepCounter(axis_of)
        with FlopCounterMode(display=False) as flops, counter:
            out = run()
        t2 = time.perf_counter()
        out_bytes = _local_bytes(out)
        if mode == "train":
            out_bytes += _local_bytes(model.param_tree()) + _local_bytes(opt)
    return dict(flops=float(flops.get_total_flops()), peak_bytes=counter.peak,
                argument_bytes=args_bytes, output_bytes=out_bytes,
                by_axis=counter.by_axis, collectives=counter.collectives(),
                setup_s=t1 - t0, step_s=t2 - t1)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             microbatches: int = 1, remat: str | None = None) -> dict:
    """Count one cell and write `<out_dir>/<tag>.json` with the keys of
    the reference's `run_cell`; a failure is written as its record
    (ok False, the error and its traceback), as the reference does."""
    arch = canon(arch)
    tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
    rec = dict(arch=arch, shape=shape_name,
               mesh="2x16x16" if multi_pod else "16x16", tag=tag)
    k = (MICROBATCH_DEFAULTS.get(arch, microbatches)
         if SHAPES[shape_name]["mode"] == "train" else 1)
    try:
        c = count_cell(arch, shape_name, multi_pod, microbatches=k,
                       remat=remat)
        coll = c["collectives"]
        u1 = dict(flops=c["flops"], bytes_accessed=-1.0,
                  peak_bytes=c["peak_bytes"],
                  argument_bytes=c["argument_bytes"],
                  output_bytes=c["output_bytes"], collectives=coll,
                  collective_bytes=sum(v["bytes"] for v in coll.values()),
                  collectives_by_axis={f"{kind}@{axis}": row for (kind, axis),
                                       row in sorted(c["by_axis"].items())})
        rec.update(
            ok=True, microbatches=k, scan_reps=get_config(arch).pattern()[1],
            lower_s=round(c["setup_s"], 1), compile_s=round(c["step_s"], 1),
            unroll2_s=0.0, flops_per_chip=c["flops"],
            bytes_accessed_per_chip=-1.0,
            peak_bytes_per_chip=c["peak_bytes"],
            argument_bytes_per_chip=c["argument_bytes"],
            output_bytes_per_chip=c["output_bytes"], collectives=coll,
            collective_bytes_per_chip=u1["collective_bytes"],
            raw_static=dict(u1=u1, u2={kk: u1[kk] for kk in
                                       ("flops", "bytes_accessed")}))
        print(f"[dryrun] {tag}: OK  step={rec['compile_s']}s "
              f"flops/chip={rec['flops_per_chip']:.3e} "
              f"peak={rec['peak_bytes_per_chip']/2**30:.2f}GiB "
              f"coll={rec['collective_bytes_per_chip']/2**20:.1f}MiB")
    except Exception as e:  # noqa: BLE001  (written to the cell's record)
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] {tag}: FAIL {type(e).__name__}: {str(e)[:200]}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.join("build", "dryrun"))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--remat", default=None)
    args = ap.parse_args(argv)

    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    if args.all:
        todo = [(a, s, mp) for (a, s) in cells() for mp in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape are required without --all")
        todo = [(args.arch, args.shape, mp) for mp in meshes]

    n_ok = 0
    for arch, shape, mp in todo:
        tag = f"{canon(arch)}__{shape}__{'pod2' if mp else 'pod1'}"
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("ok"):
                    print(f"[dryrun] {tag}: cached OK")
                    n_ok += 1
                    continue
        rec = run_cell(arch, shape, mp, args.out,
                       microbatches=args.microbatches, remat=args.remat)
        n_ok += bool(rec.get("ok"))
    print(f"[dryrun] {n_ok}/{len(todo)} cells OK")


if __name__ == "__main__":
    main()
