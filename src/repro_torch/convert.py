"""Carry a simulator input across from the JAX package.

The simulator has no weights: what the JAX package hands it is a
`SimSpec` of routing tables, channel maps, depths and traffic rows, all
numpy.  `spec_from_reference` takes such a spec as a plain dict
(`dataclasses.asdict(repro_spec)`) and returns the port's `SimSpec`, so
both simulators can be fed the very same inputs.  It reads only the
dict, and needs nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .core.simulator import SimSpec

_INT_FIELDS = ("n", "p", "c", "d")


def spec_from_reference(fields: dict) -> SimSpec:
    """Port `SimSpec` from the fields of a reference `SimSpec`.

    Integer fields stay ints, array fields become numpy arrays of their
    own dtype; a missing or unknown field raises."""
    names = [f.name for f in dataclasses.fields(SimSpec)]
    unknown = set(fields) - set(names)
    missing = set(names) - set(fields) - {"prod"}
    if unknown or missing:
        raise ValueError(f"not a SimSpec: unknown fields {sorted(unknown)}, "
                         f"missing fields {sorted(missing)}")
    out = {}
    for k, v in fields.items():
        if k in _INT_FIELDS:
            out[k] = int(v)
        else:
            out[k] = None if v is None else np.asarray(v)
    return SimSpec(**out)
