"""Topology-aware collective cost model — the paper -> framework bridge.

The port of `repro.core.collectives` (numpy; `build_ici_model(use_sim=
True)` runs the port's experiment API on `device`).

On a chiplet-based accelerator, the ICI topology determines the effective
bandwidth available to the collectives a sharded training step issues.
This module converts the paper's saturation-throughput results into
per-collective time estimates, so the roofline analyzer can report the
collective term *under each ICI topology* (`--ici-topology ...`).

Model: the effective all-to-all bandwidth per chiplet is the topology's
absolute saturation throughput T_a under uniform traffic (this bakes in
diameter, radix->wire-budget, link length->data rate, and congestion).
Ring-schedule lower bounds (Chan et al.) then give:

    all_reduce(S)       = 2 * S * (N-1)/N / B_eff
    all_gather(S)       =     S * (N-1)/N / B_eff
    reduce_scatter(S)   =     S * (N-1)/N / B_eff
    all_to_all(S)       =     S * (N-1)/N / B_eff   (uniform-traffic B_eff
                                                     already includes the
                                                     bisection penalty)

plus a latency term  diameter * hop_latency * log2(N) for software
pipelining depth.  S is the full buffer size in bytes per chiplet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .topology import Topology


# =====================================================================
# collective -> flow-matrix mapping onto chiplet placements (DESIGN.md §9)
# =====================================================================

def raster_order(topo: Topology) -> np.ndarray:
    """Chiplet ids in row-major physical order (y-major, x-fastest) —
    the canonical chiplet <-> mesh-coordinate assignment."""
    return np.lexsort((topo.pos[:, 0], topo.pos[:, 1]))


def mesh_coords(topo: Topology, mesh_shape: dict) -> dict[str, np.ndarray]:
    """Per-axis mesh coordinate of every chiplet.

    Chiplets are assigned mesh coordinates row-major over the raster
    order with the LAST mesh axis fastest — so for {"data": D, "model":
    T} the model groups are physically contiguous runs of T chiplets
    along x, the placement a real deployment would choose for its
    highest-traffic axis.
    """
    n = topo.n
    sizes = [int(s) for s in mesh_shape.values()]
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {mesh_shape} has {np.prod(sizes)} slots "
                         f"for {n} chiplets")
    rank = np.empty(n, dtype=np.int64)
    rank[raster_order(topo)] = np.arange(n)
    coords, rem = {}, rank
    for name, size in reversed(list(mesh_shape.items())):
        coords[name] = rem % size
        rem = rem // size
    return coords


def mesh_axis_groups(topo: Topology, mesh_shape: dict, axis: str
                     ) -> list[list[int]]:
    """Communication groups of one mesh axis: chiplets that share every
    *other* axis coordinate, ordered by their own coordinate along
    `axis` (= the ring order used for ring collectives)."""
    coords = mesh_coords(topo, mesh_shape)
    if axis not in coords:
        raise KeyError(f"axis {axis!r} not in mesh {list(mesh_shape)}")
    others = [coords[a] for a in mesh_shape if a != axis]
    key = np.zeros(topo.n, dtype=np.int64)
    for o in others:
        key = key * (int(o.max()) + 1) + o
    groups: dict[int, list[int]] = {}
    for node in np.argsort(coords[axis] + key * topo.n, kind="stable"):
        groups.setdefault(int(key[node]), []).append(int(node))
    return list(groups.values())


# flow factor: bytes each member sends to its ring successor (ring
# schedules, Chan et al.) or to each peer (all-to-all), per payload byte
_RING_FACTOR = {"all_reduce": lambda k: 2.0 * (k - 1) / k,
                "all_gather": lambda k: (k - 1) / k,
                "reduce_scatter": lambda k: (k - 1) / k,
                "collective_permute": lambda k: 1.0}


def collective_flow(n: int, kind: str, groups, bytes_per_chip: float
                    ) -> np.ndarray:
    """[N, N] byte-flow matrix of one collective over chiplet groups.

    Ring collectives put their whole payload on the group's ring edges
    (successor in group order); all-to-all spreads it over every pair.
    """
    m = np.zeros((n, n))
    for g in groups:
        k = len(g)
        if k < 2:
            continue
        if kind == "all_to_all":
            share = bytes_per_chip / k
            for i in g:
                for j in g:
                    if i != j:
                        m[i, j] += share
        elif kind in _RING_FACTOR:
            share = bytes_per_chip * _RING_FACTOR[kind](k)
            for idx, i in enumerate(g):
                m[i, g[(idx + 1) % k]] += share
        else:
            raise KeyError(f"unknown collective kind {kind!r}")
    return m
