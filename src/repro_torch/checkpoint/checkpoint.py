"""Crash-safe checkpointing with asynchronous writes (no external deps).

Layout, the JAX package's (`repro/checkpoint/checkpoint.py`):
    <dir>/step_<N>/manifest.json     tree structure, shapes, dtypes
    <dir>/step_<N>/<leaf_id>.npy     one file per leaf, keyed by process
                                     index (`<name>__p<pidx>.npy`)

A leaf's name is its path in the tree as `jax.tree_util.keystr` writes
it, with every character outside [A-Za-z0-9_.-] replaced by "_", so a
checkpoint of the same plain nested dict reads in either package.

  * atomic commit: writes go to step_<N>.tmp<pidx>, renamed only after
    the manifest is fsync'ed; a directory that is not exactly
    step_<8 digits> or holds no manifest is never trusted;
  * async save: the tensors are copied to host numpy before the writer
    thread starts, so training may go on changing them in place;
  * restore: each leaf is read as a full tensor and placed on `device`;
  * elastic restore: with `placements` (a tree of `sharding.Sharding`,
    possibly on a mesh other than the one that saved), each rank keeps
    its block of each leaf as a DTensor, so restarting on another mesh
    shape is a no-op for the caller.  A DTensor leaf is saved whole:
    every rank gathers it (a collective), and one process writes
    (`AsyncCheckpointer`: rank 0 of the process group);
  * retention: keep the most recent `keep` checkpoints.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from .. import tree as T

_STEP_DIR = re.compile(r"step_(\d{8})")


def _flatten_with_names(tree):
    pairs = T.leaves_with_paths(tree)
    return ([re.sub(r"[^A-Za-z0-9_.\-]", "_", T.keystr(path))
             for path, _ in pairs], [leaf for _, leaf in pairs])


def _to_numpy(leaf) -> np.ndarray:
    """`leaf` (a tensor, numpy array or number) as a numpy array; a tensor
    is copied to the host, so that training, which changes its tensors in
    place, does not reach the copy (a CPU tensor's `.numpy()` would share
    its memory).  A DTensor is gathered whole first (every rank of its
    mesh must call)."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree, keep: int = 3,
                    process_index: int = 0) -> str:
    """Synchronous atomic save.  Returns the committed directory."""
    pidx = process_index
    names, leaves = _flatten_with_names(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp{pidx}"
    os.makedirs(tmp, exist_ok=True)
    meta = {"step": step, "treedef": repr(T.tree_map(lambda _: "*", tree)),
            "leaves": {}}
    for name, leaf in zip(names, leaves):
        arr = _to_numpy(leaf)
        fn = f"{name}__p{pidx}.npy"
        np.save(os.path.join(tmp, fn), arr)
        meta["leaves"][name] = {"file": fn, "shape": list(arr.shape),
                                "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        _merge_into(tmp, final)
    else:
        os.replace(tmp, final)
    _prune(ckpt_dir, keep)
    return final


def _merge_into(tmp, final):
    for fn in os.listdir(tmp):
        os.replace(os.path.join(tmp, fn), os.path.join(final, fn))
    shutil.rmtree(tmp, ignore_errors=True)


def _committed(ckpt_dir: str) -> list:
    """Steps of the committed checkpoints (a manifest in a step_<N>
    directory), ascending."""
    steps = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_DIR.fullmatch(d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def _prune(ckpt_dir: str, keep: int):
    for s in _committed(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _committed(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, target_tree, device=None,
                       placements=None):
    """Read checkpoint `step` into the structure of `target_tree` (whose
    leaves only name the files): a tree of tensors on `device` (the CPU
    when None).  With `placements`, a matching tree of
    `sharding.Sharding` (on a mesh that may differ from the one that
    saved), each leaf becomes a DTensor holding this rank's block, cut on
    `device` (None: the mesh's device) from the full array every rank
    reads; no collective.  A leaf missing from the manifest raises
    KeyError."""
    from ..models import sharding as SH
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    names, _ = _flatten_with_names(target_tree)
    with open(os.path.join(d, "manifest.json")) as f:
        meta = json.load(f)
    shards = (T.leaves(placements, is_leaf=SH.is_sharding)
              if placements is not None else [None] * len(names))
    if len(shards) != len(names):
        raise ValueError(f"{len(shards)} placements for {len(names)} leaves")
    out = []
    for name, sh in zip(names, shards):
        info = meta["leaves"][name]
        arr = torch.from_numpy(np.load(os.path.join(d, info["file"])))
        if sh is None:
            out.append(arr.to(device or "cpu"))
        else:
            dev = device or sh.mesh.device_type
            out.append(SH.distribute(arr.to(dev), sh.mesh, sh.spec))
    return T.unflatten(target_tree, out)


def is_writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of an initialised
    process group, or a process without one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


class AsyncCheckpointer:
    """Snapshot the state to host memory synchronously (every rank: a
    DTensor leaf is gathered), write it on a background thread (rank 0
    only)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, tree):
        self.wait()
        host_tree = T.tree_map(_to_numpy, tree)
        if not is_writer():
            return

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree,
                                keep=self.keep)
            except Exception as e:  # noqa: BLE001  (raised by wait())
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
