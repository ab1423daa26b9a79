"""Fault-variant enumeration (DESIGN.md §14).

The port's copy of `repro.faults.enumerate`.

The analysis CLI certifies not just each pristine topology but its
fault-degraded variants: `iter_fault_variants` yields labelled
`(label, FaultSet)` pairs for every k up to `kmax`, per sampler kind
and seed — the grid the certification tests sweep (Table III x
substrate x fault masks k<=2).  Unsurvivable draws (a FaultError from
the sampler: the topology cannot lose k links/chiplets and stay
connected) are skipped, not raised — certification cares about the
variants that can actually be served.
"""
from __future__ import annotations

from typing import Iterator

from ..core.topology import Topology

from .faultset import FaultError, FaultSet
from .samplers import sample_faults


def iter_fault_variants(topo: Topology, kmax: int,
                        kinds: tuple = ("random",),
                        seeds: tuple = (0,),
                        include_pristine: bool = True,
                        ) -> Iterator[tuple[str, FaultSet | None]]:
    """Yield (label, fault_set) for the degradation grid of one topology.

    label is "pristine" or "<kind>:k<k>:s<seed>"; fault_set is None for
    the pristine entry (no mask to apply).  Draws that the sampler
    rejects as unsurvivable are silently skipped — fewer variants, not
    an error.
    """
    if kmax < 0:
        raise ValueError(f"kmax must be >= 0, got {kmax}")
    if include_pristine:
        yield "pristine", None
    for kind in kinds:
        for k in range(1, kmax + 1):
            for seed in seeds:
                try:
                    fs = sample_faults(topo, k, kind=kind, seed=seed)
                except FaultError:
                    continue
                yield f"{kind}:k{k}:s{seed}", fs


def apply_variant(topo: Topology, fault_set: FaultSet | None) -> Topology:
    """The degraded topology for one variant (identity for pristine)."""
    return topo if fault_set is None else fault_set.apply(topo)
