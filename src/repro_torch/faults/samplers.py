"""Seeded fault-draw samplers (DESIGN.md §12).

The port's copy of `repro.faults.samplers`: the same seeded
`np.random.default_rng` streams, so the same draws.

Three link-fault distributions cover the failure modes that matter for
a degradation curve, plus a chiplet-fault draw:

  * `random_link_faults` — independent uniform link failures (the
    baseline reliability model: solder/bump opens scattered over the
    package);
  * `correlated_link_faults` — a spatial *blast*: one epicenter link
    plus its nearest neighbours by physical midpoint distance (a warped
    substrate region, a delaminated corner — glass's failure mode is
    spatially correlated, not i.i.d.);
  * `adversarial_link_faults` — greedy worst-link: repeatedly kill the
    most-loaded surviving link under the routed traffic (the lower
    envelope of the degradation curve; what an adversary — or Murphy —
    takes first);
  * `random_chiplet_faults` — whole-chiplet fail-stop draws.

All samplers are deterministic in (topology, k, seed) and, by default,
survivable: candidates whose removal would partition the surviving
chiplets are skipped (greedy over a seeded permutation), so the
returned `FaultSet.apply` always succeeds.  If fewer than k survivable
faults exist the sampler raises rather than silently degrading less
than asked.
"""
from __future__ import annotations

import numpy as np

from ..core.topology import Topology

from .faultset import FaultError, FaultSet, surviving_connected

# stable per-kind seed-stream tags (process-independent, unlike hash())
_KIND_RAND, _KIND_BLAST, _KIND_CHIP = 0xFA01, 0xFA02, 0xFA03


def _sorted_edges(topo: Topology) -> np.ndarray:
    return np.sort(np.asarray(topo.edges, np.int64), axis=1)


def _greedy_links(topo: Topology, k: int, order: np.ndarray,
                  require_connected: bool, label: str) -> FaultSet:
    """First k links of `order` whose cumulative removal keeps the
    survivors connected (or simply the first k)."""
    e = _sorted_edges(topo)
    chosen: list = []
    for idx in order:
        if len(chosen) == k:
            break
        cand = chosen + [tuple(int(x) for x in e[idx])]
        if require_connected and not surviving_connected(
                topo, FaultSet(links=tuple(cand))):
            continue
        chosen = cand
    if len(chosen) < k:
        raise FaultError(
            f"{topo.name}: only {len(chosen)} of {k} requested link "
            f"faults are survivable (E={len(e)}); the topology cannot "
            f"lose that many links and stay connected")
    return FaultSet(links=tuple(chosen), name=label)


def random_link_faults(topo: Topology, k: int, seed: int = 0,
                       require_connected: bool = True) -> FaultSet:
    """k links drawn uniformly (seeded permutation; greedy-survivable)."""
    if k == 0:
        return FaultSet(name=f"rand:k0:s{seed}")
    rng = np.random.default_rng([_KIND_RAND, topo.n, k, seed])
    order = rng.permutation(len(topo.edges))
    return _greedy_links(topo, k, order, require_connected,
                         f"rand:k{k}:s{seed}")


def correlated_link_faults(topo: Topology, k: int, seed: int = 0,
                           require_connected: bool = True) -> FaultSet:
    """A spatially-correlated blast of k links.

    The seeded draw picks an epicenter link; candidates are then
    ordered by physical midpoint distance to it, so the fault set is a
    contiguous damaged region of the substrate."""
    if k == 0:
        return FaultSet(name=f"blast:k0:s{seed}")
    rng = np.random.default_rng([_KIND_BLAST, topo.n, k, seed])
    e = _sorted_edges(topo)
    pmm = topo.pos_mm()
    mid = 0.5 * (pmm[e[:, 0]] + pmm[e[:, 1]])
    epi = int(rng.integers(0, len(e)))
    d = np.sqrt(((mid - mid[epi]) ** 2).sum(-1))
    order = np.lexsort((np.arange(len(e)), d))      # stable: distance, id
    return _greedy_links(topo, k, order, require_connected,
                         f"blast:k{k}:s{seed}")


def adversarial_link_faults(topo: Topology, k: int,
                            traffic: np.ndarray | None = None,
                            require_connected: bool = True) -> FaultSet:
    """Greedy worst-link faults: at each step kill the surviving link
    carrying the highest routed channel load (ties broken by edge id),
    re-routing the degraded topology between steps.  Deterministic —
    no seed — and the pessimistic envelope of the degradation curve."""
    from ..core.routing import routing_for
    from ..core import traffic as TR

    if traffic is None:
        traffic = TR.uniform(topo)
    chosen: list = []
    for _ in range(k):
        fs = FaultSet(links=tuple(chosen))
        degraded = fs.apply(topo)
        r = routing_for(degraded)
        loads, _, _ = r.paths_channel_loads(np.asarray(traffic, np.float64))
        # fold directed-channel loads onto undirected links
        e = _sorted_edges(degraded)
        key = {(int(a), int(b)): i for i, (a, b) in enumerate(e)}
        link_load = np.zeros(len(e))
        for c in range(len(loads)):
            a, b = int(r.ch_src[c]), int(r.ch_dst[c])
            link_load[key[(min(a, b), max(a, b))]] += loads[c]
        order = np.lexsort((np.arange(len(e)), -link_load))
        placed = False
        for idx in order:
            cand = chosen + [tuple(int(x) for x in e[idx])]
            if require_connected and not surviving_connected(
                    topo, FaultSet(links=tuple(cand))):
                continue
            chosen, placed = cand, True
            break
        if not placed:
            raise FaultError(
                f"{topo.name}: only {len(chosen)} of {k} adversarial "
                f"link faults are survivable")
    return FaultSet(links=tuple(chosen), name=f"worst:k{k}")


def random_chiplet_faults(topo: Topology, k: int, seed: int = 0,
                          require_connected: bool = True) -> FaultSet:
    """k whole-chiplet fail-stop faults (seeded; greedy-survivable among
    the *remaining* chiplets)."""
    if k == 0:
        return FaultSet(name=f"chip:k0:s{seed}")
    rng = np.random.default_rng([_KIND_CHIP, topo.n, k, seed])
    order = rng.permutation(topo.n)
    chosen: list = []
    for node in order:
        if len(chosen) == k:
            break
        cand = chosen + [int(node)]
        if require_connected and not surviving_connected(
                topo, FaultSet(chiplets=tuple(cand))):
            continue
        chosen = cand
    if len(chosen) < k:
        raise FaultError(
            f"{topo.name}: only {len(chosen)} of {k} requested chiplet "
            f"faults are survivable")
    return FaultSet(chiplets=tuple(chosen), name=f"chip:k{k}:s{seed}")


#: named fault-draw registry, mirroring `traffic.PATTERNS`
SAMPLERS = {
    "random": random_link_faults,
    "correlated": correlated_link_faults,
    "adversarial": adversarial_link_faults,
    "chiplets": random_chiplet_faults,
}


def sample_faults(topo: Topology, k: int, kind: str = "random",
                  seed: int = 0, require_connected: bool = True,
                  **kw) -> FaultSet:
    """Front door: draw a k-fault `FaultSet` of the named kind."""
    if kind not in SAMPLERS:
        raise KeyError(f"unknown fault kind {kind!r}; choose from "
                       f"{sorted(SAMPLERS)}")
    fn = SAMPLERS[kind]
    if kind == "adversarial":
        return fn(topo, k, require_connected=require_connected, **kw)
    return fn(topo, k, seed=seed, require_connected=require_connected,
              **kw)
