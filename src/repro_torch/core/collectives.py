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
import functools

import numpy as np

from . import linkmodel as lm
from . import costmodel, traffic
from .routing import build_routing
from .topology import Topology, build


@dataclasses.dataclass
class IciModel:
    topology: str
    n: int
    substrate: str
    b_eff_gbps: float          # per-chiplet effective bandwidth
    diameter: int
    hop_latency_ns: float

    def collective_time_s(self, kind: str, bytes_per_chip: float) -> float:
        n = self.n
        factor = {"all_reduce": 2.0, "all_gather": 1.0,
                  "reduce_scatter": 1.0, "all_to_all": 1.0,
                  "collective_permute": 1.0 / max(n - 1, 1)}[kind]
        bw_bytes = self.b_eff_gbps * 1e9 / 8.0
        bw_term = factor * bytes_per_chip * (n - 1) / max(n, 1) / bw_bytes
        lat_term = (self.diameter * self.hop_latency_ns * 1e-9 *
                    np.log2(max(n, 2)))
        return float(bw_term + lat_term)


@functools.lru_cache(maxsize=64)
def build_ici_model(topology: str = "folded_hexa_torus", n: int = 64,
                    substrate: str = "organic",
                    use_sim: bool = False, device=None) -> IciModel:
    """use_sim=True derives B_eff from the cycle-accurate simulator via
    the batched sweep engine instead of the analytic channel-load bound
    (slower but congestion-aware; see DESIGN.md §6), on `device` (None:
    the CUDA card; "cpu" for the CPU).  The analytic model runs on the
    host whatever `device` says."""
    topo = build(topology, n, substrate=substrate)
    r = build_routing(topo)
    u = traffic.uniform(topo)
    t_r = r.saturation_rate(u)           # analytic channel-load bound
    if use_sim:
        from .. import experiments as X
        frame = X.run(X.Experiment(
            [X.Scenario(topology, n, substrate)], name="ici_model"),
            device=device)
        t_r = frame.case_result(0)["sim_saturation"]
    t_a = costmodel.absolute_throughput_gbps(topo, t_r)
    hop_ns = float(lm.ROUTER_LATENCY_NS + 2 * lm.PHY_LATENCY_NS +
                   np.mean(lm.wire_latency_ns(topo.link_lengths_mm(),
                                              substrate)))
    return IciModel(topology=topology, n=n, substrate=substrate,
                    b_eff_gbps=t_a, diameter=topo.diameter,
                    hop_latency_ns=hop_ns)


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


def mesh_axis_groups(topo: Topology, mesh_shape: dict, axis
                     ) -> list[list]:
    """Communication groups of one mesh axis: chiplets that share every
    *other* axis coordinate, ordered by their own coordinate along
    `axis` (= the ring order used for ring collectives).

    `axis` may be a tuple of axes (major first): a group is then the
    chiplets that share every axis outside the tuple, nested one list
    level per axis, e.g. [node][local] for ("node", "local").  Ring
    collectives run over it in row-major order (last axis fastest).
    """
    coords = mesh_coords(topo, mesh_shape)
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in axes:
        if a not in coords:
            raise KeyError(f"axis {a!r} not in mesh {list(mesh_shape)}")
    others = [coords[a] for a in mesh_shape if a not in axes]
    key = np.zeros(topo.n, dtype=np.int64)
    for o in others:
        key = key * (int(o.max()) + 1) + o
    pos = np.zeros(topo.n, dtype=np.int64)
    for a in axes:
        pos = pos * int(mesh_shape[a]) + coords[a]
    groups: dict[int, list[int]] = {}
    for node in np.argsort(pos + key * topo.n, kind="stable"):
        groups.setdefault(int(key[node]), []).append(int(node))
    if isinstance(axis, str):
        return list(groups.values())
    shape = [int(mesh_shape[a]) for a in axes]
    return [np.reshape(g, shape).tolist() for g in groups.values()]


# flow factor: bytes each member sends to its ring successor (ring
# schedules, Chan et al.) or to each peer (all-to-all), per payload byte
_RING_FACTOR = {"all_reduce": lambda k: 2.0 * (k - 1) / k,
                "all_gather": lambda k: (k - 1) / k,
                "reduce_scatter": lambda k: (k - 1) / k,
                "collective_permute": lambda k: 1.0}
#: unwrapped sends along a group: member i to i + 1, or i + 1 to i
_SENDS = ("send_next", "send_prev")
#: two-stage expert dispatch and its reverse, over [node][local] groups
_TWO_STAGE = ("dispatch", "combine")


def _two_stage(m: np.ndarray, nodes, bytes_per_chip, shares) -> None:
    """Add one group's two-stage dispatch to `m`: each chiplet sends
    `inter` of its payload to the chiplet of its own `local` index in
    every other node, and `intra` of it to every other chiplet of its
    own node (the forwarding there, counted at the sender's row)."""
    inter, intra = shares
    for gi, node in enumerate(nodes):
        for li, src in enumerate(node):
            for gj, other in enumerate(nodes):
                if gj != gi:
                    m[src, other[li]] += bytes_per_chip * inter
            for lj, dst in enumerate(node):
                if lj != li:
                    m[src, dst] += bytes_per_chip * intra


def collective_flow(n: int, kind: str, groups, bytes_per_chip: float,
                    shares: tuple = ()) -> np.ndarray:
    """[N, N] byte-flow matrix of one collective over chiplet groups.

    Ring collectives put their whole payload on the group's ring edges
    (successor in group order); all-to-all spreads it over every pair.
    `send_next` / `send_prev` send the whole payload one member on /
    back along the group, without wrapping (a pipeline's stage
    boundaries).  `dispatch` takes groups nested [node][local] and
    `shares` = (inter, intra), the payload's shares to each other node
    and to each other chiplet of the node (`_two_stage`); `combine` is
    its transpose, the answers coming back the same way.
    """
    m = np.zeros((n, n))
    if kind in _TWO_STAGE:
        for g in groups:
            _two_stage(m, g, bytes_per_chip, shares)
        return np.ascontiguousarray(m.T) if kind == "combine" else m
    for g in groups:
        g = np.ravel(g).tolist()        # a nested group: row-major
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
        elif kind in _SENDS:
            src, dst = (g[:-1], g[1:]) if kind == "send_next" \
                else (g[1:], g[:-1])
            for i, j in zip(src, dst):
                m[i, j] += bytes_per_chip
        else:
            raise KeyError(f"unknown collective kind {kind!r}")
    return m


def compare_topologies(bytes_per_chip: float, kind: str = "all_reduce",
                       n: int = 64, substrate: str = "organic",
                       names=("mesh", "hexamesh", "folded_torus",
                              "folded_hexa_torus")) -> dict[str, float]:
    """Collective time (s) under each ICI topology — used by §Roofline."""
    return {name: build_ici_model(name, n, substrate)
            .collective_time_s(kind, bytes_per_chip) for name in names}
