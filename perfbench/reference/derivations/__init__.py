"""The reference's derivations of a training step's collectives, one
file each, chosen by name.

A configuration's `step` may name `"derivation": "<name>"` (default
`tp_fsdp`); the reference's `collective_workload` then takes the step's
ops from `perfbench/reference/derivations/<name>.py`.  A derivation
module defines

  step_collective_ops(config, mesh_shape, *, seq_len, global_batch,
                      dtype_bytes, **step) -> [CollectiveOp, ...]

where `config` carries the mapped size fields of
`perfbench.grid.model_sizes` and every key of the configuration's
`model` under its published name, and `step` every other key of the
configuration's `step`; and it may define

  op_flow(topo, mesh_shape, op) -> [N, N] byte-flow matrix

for groups or flow shapes that `collectives.mesh_axis_groups` and
`collective_flow` do not give (the default maps `op.axis` onto the
placement and `op.kind` onto its ring or all-to-all flow).  A name with
no file is an error: there is no fallback.  The program never sees the
name.
"""
from __future__ import annotations

import importlib
import re
from pathlib import Path

#: the derivation of a step that names none
DEFAULT = "tp_fsdp"
_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def name_of(step: dict) -> str:
    """The derivation a configuration's `step` names."""
    return step.get("derivation", DEFAULT)


def load(name: str):
    """The derivation module `name`, from a `<name>.py` in this
    package's directories; raises naming the path where there is none."""
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"step.derivation {name!r} is not a module name")
    paths = [Path(d) / f"{name}.py" for d in __path__]
    if not any(p.is_file() for p in paths):
        raise FileNotFoundError(
            f"step.derivation {name!r}: no file "
            f"{' or '.join(str(p) for p in paths)}")
    mod = importlib.import_module(f"{__name__}.{name}")
    if not callable(getattr(mod, "step_collective_ops", None)):
        raise TypeError(f"derivation {name!r} ({mod.__file__}) defines no "
                        f"step_collective_ops")
    return mod
