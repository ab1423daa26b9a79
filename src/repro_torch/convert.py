"""Carry inputs across from the JAX package.

The simulator has no weights: what the JAX package hands it is a
`SimSpec` of routing tables, channel maps, depths and traffic rows, all
numpy.  `spec_from_reference` takes such a spec as a plain dict
(`dataclasses.asdict(repro_spec)`) and returns the port's `SimSpec`, so
both simulators can be fed the very same inputs;
`sched_from_reference` does the same for a compiled phase schedule
(`SchedSpec`).
`params_from_reference` does the same for the LM stack's weights, and
`opt_state_from_reference` for its AdamW state.  All read only plain
dicts (or named tuples) and numpy arrays, and need nothing of the JAX
package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import tree as T
from .core.simulator import SchedSpec, SimSpec
from .models.model import Model

def _from_fields(cls, fields: dict, int_fields: tuple,
                 optional: tuple = ()):
    """`cls` from a dict of its fields: integer fields stay ints, array
    fields become numpy arrays of their own dtype; a missing or unknown
    field raises."""
    names = [f.name for f in dataclasses.fields(cls)]
    unknown = set(fields) - set(names)
    missing = set(names) - set(fields) - set(optional)
    if unknown or missing:
        raise ValueError(f"not a {cls.__name__}: unknown fields "
                         f"{sorted(unknown)}, missing fields "
                         f"{sorted(missing)}")
    out = {}
    for k, v in fields.items():
        if k in int_fields:
            out[k] = int(v)
        else:
            out[k] = None if v is None else np.asarray(v)
    return cls(**out)


def spec_from_reference(fields: dict) -> SimSpec:
    """Port `SimSpec` from the fields of a reference `SimSpec`."""
    return _from_fields(SimSpec, fields, ("n", "p", "c", "d"), ("prod",))


def sched_from_reference(fields: dict) -> SchedSpec:
    """Port `SchedSpec` from the fields of a reference `SchedSpec`
    (`dataclasses.asdict` of a compiled phase schedule)."""
    return _from_fields(SchedSpec, fields, ("k", "n", "total"))


def params_from_reference(params: dict, cfg, ctx=None) -> "Model":
    """Port `Model` (on the CPU) holding the JAX package's parameters; with
    `ctx`, the sharded `Model(cfg, ctx)` holding this rank's blocks, laid
    out as `launch.steps.param_shardings(model, ctx)` says (the train
    layout).

    `params` is the reference's *unboxed* parameter tree as numpy arrays
    (`unbox(Model.init(key))[0]` mapped through `np.asarray`): `embed`,
    `final_norm`, `blocks[slot][group][name]` stacked along a leading
    n_rep axis, and `tail[i][group][name]`; an encoder-decoder adds
    `enc_blocks[group][name]`, one dict stacked along n_enc_layers, and
    `enc_norm`.  Block leaves are unstacked into true layer order (layer
    `rep * len(pattern) + slot`, then the tail), encoder leaves into
    `enc_layers`.  Every group the reference has is carried over as it
    is (`attn` of MLA, `xattn` / `ln_x`, `moe.{router,wi,wg,wo}` in the
    virtual-split layout).  A missing or unknown leaf, or a shape that
    differs, raises."""
    model = Model(cfg, ctx)._draw(torch.Generator().manual_seed(0))
    pat, n_rep, _ = cfg.pattern()
    flat = {}
    for key, val in params.items():
        if key == "enc_blocks":
            for path, arr in _leaves(val):
                for i in range(np.shape(arr)[0]):
                    flat[f"enc_layers.{i}.{path}"] = np.asarray(arr)[i]
        elif key == "blocks":
            for slot, blk in enumerate(val):
                for path, arr in _leaves(blk):
                    for rep in range(np.shape(arr)[0]):
                        flat[f"layers.{rep * len(pat) + slot}.{path}"] = \
                            np.asarray(arr)[rep]
        elif key == "tail":
            for i, blk in enumerate(val):
                for path, arr in _leaves(blk):
                    flat[f"layers.{n_rep * len(pat) + i}.{path}"] = arr
        else:
            for path, arr in _leaves(val):
                flat[f"{key}.{path}" if path else key] = arr
    state = model.state_dict()
    unknown = sorted(set(flat) - set(state))
    missing = sorted(set(state) - set(flat))
    if unknown or missing:
        raise ValueError(f"parameter tree does not fit {cfg.name}: unknown "
                         f"leaves {unknown}, missing leaves {missing}")
    with torch.no_grad():
        for name, t in state.items():
            arr = np.asarray(flat[name])
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    if ctx is not None:
        from .launch.steps import param_shardings
        model.place(param_shardings(model, ctx)[1])
    return model


def opt_state_from_reference(state, cfg) -> dict:
    """The port's AdamW state `{step, m, v}` (on the CPU) from the JAX
    package's `AdamWState` as numpy arrays (the named tuple, or a dict of
    its fields): `m` and `v` are parameter-shaped trees, stacked per
    pattern slot as the parameters are, and come out as float32 trees
    shaped like `Model.param_tree()`, layers in true order.  A tree that
    does not fit raises as `params_from_reference` does."""
    fields = state._asdict() if hasattr(state, "_asdict") else dict(state)

    def tree(moments):
        return T.tree_map(lambda p: p.detach(),
                          params_from_reference(moments, cfg).param_tree())

    return {"step": torch.tensor(int(np.asarray(fields["step"])),
                                 dtype=torch.int32),
            "m": tree(fields["m"]), "v": tree(fields["v"])}


def reference_tree(tree, cfg, stack=torch.stack, is_leaf=None) -> dict:
    """A port tree shaped like `Model.param_tree()` (parameters, or AdamW
    moments) in the JAX package's layout: `blocks[slot]` stacked over the
    pattern's repetitions, `tail[i]`, and for an encoder-decoder
    `enc_blocks` stacked over the encoder's layers.  Its leaves are
    named as the reference names them, so a checkpoint of it reads in
    either package (`convert.params_from_reference` takes it back as
    numpy).  `stack` joins the leaves of one slot's layers (a tensor
    stack; for an axes or spec tree, with `is_leaf`, the leading
    "layers" axis or None)."""
    pat, n_rep, tail = cfg.pattern()
    layers = tree["layers"]

    def stack_group(group):
        return T.unflatten(group[0], [stack(ts) for ts in zip(
            *(T.leaves(g, is_leaf) for g in group))], is_leaf)

    out = {k: v for k, v in tree.items() if k not in ("layers",
                                                      "enc_layers")}
    out["blocks"] = [stack_group(layers[slot:n_rep * len(pat):len(pat)])
                     for slot in range(len(pat))]
    out["tail"] = list(layers[n_rep * len(pat):])
    if "enc_layers" in tree:
        out["enc_blocks"] = stack_group(tree["enc_layers"])
    return out


def _leaves(tree, prefix=""):
    """(dotted path, leaf) of a nested dict; a leaf at the root has the
    empty path."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
