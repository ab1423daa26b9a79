"""`FaultSet`: failed links / failed chiplets lowered onto `Topology`.

The port's copy of `repro.faults.faultset` (numpy/scipy only).

The paper evaluates pristine topologies only; at the chiplet counts its
design principles target (hundreds per package, HexaMesh arXiv
2211.13989) link and chiplet failures are a certainty.  The fault model
here is *fail-stop*: a dead link carries no flits in either direction, a
dead chiplet loses all of its links and neither injects nor receives
traffic.  A degraded topology is just the same `Topology` with a masked
edge list — routing is rebuilt automatically because
`routing.routing_for` keys on the structural hash, and the degraded
structure hashes differently (DESIGN.md §12).

Failure semantics:

  * `apply(topo)` returns the degraded `Topology` (the empty fault set
    returns `topo` itself, so the zero-fault path is bitwise identical
    to never having constructed a `FaultSet` at all);
  * survivors must stay connected: a fault set that splits the
    *surviving* chiplets into islands raises `DisconnectedFaultError`
    with the component sizes — serving traffic through a partitioned
    package is not graceful degradation, it is an outage, and silently
    simulating one island would misreport the curve;
  * dead chiplets may legitimately end up isolated (that is what dying
    means); they are excluded from the connectivity requirement and
    from traffic (`mask_traffic` / `mask_schedule` zero their rows and
    columns and renormalize the survivors' destination rows).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from ..core.topology import Topology


class FaultError(ValueError):
    """A fault set that cannot be applied to the given topology."""


class DisconnectedFaultError(FaultError):
    """The fault set splits the surviving chiplets into islands."""


def _canon_links(links) -> tuple:
    out = set()
    for link in links:
        a, b = int(link[0]), int(link[1])
        if a == b:
            raise FaultError(f"fault link ({a}, {b}) is a self-loop")
        out.add((min(a, b), max(a, b)))
    return tuple(sorted(out))


@dataclasses.dataclass(frozen=True)
class FaultSet:
    """An immutable set of failed links and failed chiplets.

    `links` are undirected (u, v) pairs (canonicalized and deduped);
    `chiplets` are node ids.  The set is topology-independent until
    `apply(topo)` checks it against a concrete edge list.
    """
    links: tuple = ()
    chiplets: tuple = ()
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "links", _canon_links(self.links))
        object.__setattr__(
            self, "chiplets",
            tuple(sorted({int(c) for c in self.chiplets})))
        if not self.name:
            object.__setattr__(self, "name", self.describe())

    # ---- introspection -------------------------------------------------
    @property
    def empty(self) -> bool:
        return not self.links and not self.chiplets

    @property
    def n_links(self) -> int:
        return len(self.links)

    @property
    def n_chiplets(self) -> int:
        return len(self.chiplets)

    def describe(self) -> str:
        if not self.links and not self.chiplets:
            return "none"
        parts = []
        if self.links:
            parts.append("L" + ",".join(f"{a}-{b}" for a, b in self.links))
        if self.chiplets:
            parts.append("C" + ",".join(str(c) for c in self.chiplets))
        return "+".join(parts)

    # ---- lowering onto a Topology --------------------------------------
    def dead_link_mask(self, topo: Topology) -> np.ndarray:
        """[E] bool — True where `topo.edges` dies under this fault set.

        Every failed link must name an existing edge; a typo'd pair is
        an error, not a no-op (the caller believes they degraded the
        topology)."""
        e = np.sort(np.asarray(topo.edges, np.int64), axis=1)
        have = {(int(a), int(b)) for a, b in e}
        missing = [lk for lk in self.links if lk not in have]
        if missing:
            raise FaultError(
                f"{topo.name}: fault links {missing} are not links of "
                f"this topology (N={topo.n}, {len(e)} edges)")
        bad = [c for c in self.chiplets if not 0 <= c < topo.n]
        if bad:
            raise FaultError(f"{topo.name}: fault chiplets {bad} out of "
                             f"range for N={topo.n}")
        mask = np.zeros(len(e), dtype=bool)
        if self.links:
            dead = set(self.links)
            mask |= np.fromiter(((int(a), int(b)) in dead for a, b in e),
                                dtype=bool, count=len(e))
        if self.chiplets:
            dc = np.asarray(self.chiplets)
            mask |= np.isin(e[:, 0], dc) | np.isin(e[:, 1], dc)
        return mask

    def alive(self, n: int) -> np.ndarray:
        """[N] bool — surviving chiplets."""
        up = np.ones(n, dtype=bool)
        if self.chiplets:
            up[np.asarray(self.chiplets)] = False
        return up

    def apply(self, topo: Topology) -> Topology:
        """The degraded `Topology`: dead links and dead chiplets' links
        removed, same nodes/positions/name.  Empty fault set returns
        `topo` unchanged (same object — the zero-fault path shares the
        pristine routing cache entry bitwise).  Raises
        `DisconnectedFaultError` if the survivors are partitioned."""
        if self.empty:
            return topo
        mask = self.dead_link_mask(topo)
        edges = np.asarray(topo.edges)[~mask]
        check_survivors_connected(topo.n, edges, self.alive(topo.n),
                                  name=f"{topo.name}[{self.name}]")
        return dataclasses.replace(topo, edges=edges)

    # ---- traffic masking -----------------------------------------------
    def mask_traffic(self, traffic: np.ndarray) -> np.ndarray:
        """Zero rows/columns of dead chiplets, renormalize survivor rows.

        No dead chiplets -> the input array is returned unchanged (the
        zero-fault path stays bitwise identical).  A survivor whose
        whole row pointed at dead chiplets simply stops injecting (row
        stays zero), matching the simulator's inert-source handling.
        """
        if not self.chiplets:
            return traffic
        tm = np.asarray(traffic, np.float64).copy()
        up = self.alive(tm.shape[0])
        tm[~up, :] = 0.0
        tm[:, ~up] = 0.0
        rows = tm.sum(axis=1, keepdims=True)
        np.divide(tm, rows, out=tm, where=rows > 0)
        return tm

    def mask_schedule(self, schedule):
        """A copy of a `workloads.Schedule` with every phase's traffic
        masked (no dead chiplets -> the schedule is returned as is)."""
        if not self.chiplets:
            return schedule
        phases = [dataclasses.replace(p, traffic=self.mask_traffic(
            np.asarray(p.traffic, np.float64))) for p in schedule.phases]
        return dataclasses.replace(schedule, phases=phases)


def check_survivors_connected(n: int, edges: np.ndarray,
                              alive: np.ndarray, name: str = "topology"):
    """Raise `DisconnectedFaultError` unless the surviving chiplets form
    one connected component of the degraded edge list."""
    n_alive = int(alive.sum())
    if n_alive == 0:
        raise DisconnectedFaultError(f"{name}: every chiplet is dead")
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    adj = sp.csr_matrix(
        (np.ones(2 * len(e)),
         (np.concatenate([e[:, 0], e[:, 1]]),
          np.concatenate([e[:, 1], e[:, 0]]))), shape=(n, n))
    ncomp, labels = csgraph.connected_components(adj)
    comp = labels[alive]
    sizes = np.bincount(comp)
    sizes = sorted((int(s) for s in sizes if s > 0), reverse=True)
    if len(sizes) > 1:
        raise DisconnectedFaultError(
            f"{name}: fault set disconnects the surviving chiplets "
            f"into {len(sizes)} islands of sizes {sizes}; a partitioned "
            f"package cannot serve traffic — choose a survivable fault "
            f"set (see faults.sample_faults(..., require_connected=True))")


def surviving_connected(topo: Topology, fs: FaultSet) -> bool:
    """True iff `fs.apply(topo)` would succeed (no exception control
    flow — the samplers probe many candidate sets)."""
    try:
        mask = fs.dead_link_mask(topo)
    except FaultError:
        return False
    edges = np.asarray(topo.edges)[~mask]
    try:
        check_survivors_connected(topo.n, edges, fs.alive(topo.n))
    except DisconnectedFaultError:
        return False
    return True
