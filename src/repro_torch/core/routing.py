"""Deadlock-free shortest-path routing on arbitrary ICI topologies.

This is the paper's §V-B recipe: a custom routing algorithm based on
Dijkstra's algorithm, incorporating the turn model [34], a simple
cycle-breaking algorithm [35], and a dual-graph construction [36]:

  1. **Cycle breaking / turn prohibition** — nodes are BFS-labelled from a
     central root; a directed channel u->v is *up* if it decreases the
     (depth, id) label.  Turns *down->up* are prohibited (up*/down*
     ordering), which makes the channel-dependency graph acyclic and hence
     the routing deadlock-free on any connected topology.
  2. **Dual graph** — vertices are directed channels (plus one virtual
     ejection vertex per node); edges are the *allowed* turns.
  3. **Dijkstra** — run from every destination's ejection vertex over the
     reversed dual graph; the routing table then maps
     (destination, current node, input channel) -> output port by greedy
     descent on the dual-graph distance.

The module also provides the *analytic* channel-load throughput bound used
as a fast cross-check of the cycle-accurate simulator: for a traffic
matrix P (rows sum to 1), the expected per-channel load at unit injection
is  load_e = sum_{s,d} P[s,d] * [e on path(s,d)]  and the saturation
injection rate is  min(1, 1/max_e load_e)  flits/node/cycle.

The port's own copy of `repro.core.routing` (numpy/scipy only), equal
to it table for table (tests/test_torch_core.py), with certification
(`routing_for(certify=True)`, `analysis.routing_verify`).
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from ..obs.metrics import metrics
from ..obs.trace import trace as _span

from .topology import CUSTOM_GENERATORS, Topology, build
from . import linkmodel as lm


@dataclasses.dataclass
class Routing:
    topo: Topology
    # directed channels
    ch_src: np.ndarray          # [C] source node of channel
    ch_dst: np.ndarray          # [C] destination node
    ch_len_mm: np.ndarray       # [C] physical length
    ch_out_port: np.ndarray     # [C] output-port index at src
    ch_in_port: np.ndarray      # [C] input-port index at dst
    out_ch: np.ndarray          # [N, P] channel id per output port (-1 pad)
    in_ch: np.ndarray           # [N, P] channel id per input port (-1 pad)
    n_ports: np.ndarray         # [N] real (non-virtual) port count
    # routing table: [dst, node, in_port(+1 for injection)] -> out port
    # value == EJECT means deliver locally; -1 means unused/unreachable.
    table: np.ndarray
    prohibited_turns: int
    total_turns: int

    EJECT: int = -2

    #: verification certificate (`analysis.routing_verify
    #: .RoutingCertificate`), attached by `routing_for(certify=True)`
    #: and cached with the routing; None until certified.
    cert: object = None

    #: productive-ports mask [N_dst, N, P] (minimal-adaptive routing,
    #: DESIGN.md §15), computed lazily by `productive_ports` and cached
    #: with the routing; None until first requested.
    prod: object = None

    @property
    def n_channels(self) -> int:
        return len(self.ch_src)

    @property
    def max_ports(self) -> int:
        return self.out_ch.shape[1]

    # -- path following ------------------------------------------------
    def paths_channel_loads(self, traffic: np.ndarray,
                            max_hops: int | None = None):
        """Follow the routing table for all (s, d) pairs simultaneously.

        traffic: [N, N] matrix, rows sum to 1 (diagonal ignored).
        Returns (loads[C], hops[N, N], lat_cycles[N, N]).  Each call
        counts one `routing.walks` in `obs.metrics`.
        """
        metrics.inc("routing.walks")
        topo, n = self.topo, self.topo.n
        if max_hops is None:
            max_hops = 4 * topo.n  # safe upper bound; loops would exceed it
        hop_cy = lm.hop_latency_cycles(self.ch_len_mm, topo.substrate)

        s_idx, d_idx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        s_idx, d_idx = s_idx.ravel(), d_idx.ravel()
        w = traffic[s_idx, d_idx]
        # follow only pairs that carry traffic: on fault-degraded
        # topologies (repro.faults) pairs involving dead chiplets are
        # unreachable by construction, and their masked weight is 0 —
        # routing them would false-alarm the dead-end check.  Zero-
        # weight pairs contribute 0 to every weighted consumer (loads,
        # avg hops, zero-load latency) either way.
        alive = (s_idx != d_idx) & (w > 0)
        cur = s_idx.copy()
        in_port = np.full(n * n, self.max_ports, dtype=np.int32)  # injection
        loads = np.zeros(self.n_channels)
        hops = np.zeros(n * n, dtype=np.int32)
        lat = np.zeros(n * n, dtype=np.float64)

        for _ in range(max_hops):
            if not alive.any():
                break
            out_port = self.table[d_idx[alive], cur[alive], in_port[alive]]
            if (out_port < 0).any():
                bad = np.where(out_port < 0)[0]
                raise RuntimeError(
                    f"routing table dead end for "
                    f"{(s_idx[alive][bad[0]], d_idx[alive][bad[0]])}")
            ch = self.out_ch[cur[alive], out_port]
            np.add.at(loads, ch, w[alive])
            hops[alive] += 1
            lat[alive] += hop_cy[ch]
            cur_new = self.ch_dst[ch]
            in_port_new = self.ch_in_port[ch]
            cur[alive] = cur_new
            in_port[alive] = in_port_new
            arrived = cur == d_idx
            alive = alive & ~arrived
        if alive.any():
            raise RuntimeError("routing did not converge (livelock?)")
        return loads, hops.reshape(n, n), lat.reshape(n, n)

    def saturation_rate(self, traffic: np.ndarray) -> float:
        """Analytic saturation injection rate (flits/node/cycle)."""
        loads, _, _ = self.paths_channel_loads(traffic)
        return saturation_from_loads(loads, traffic)

    def restricted_hops(self) -> np.ndarray:
        u = np.ones((self.topo.n, self.topo.n))
        np.fill_diagonal(u, 0.0)
        rs = u.sum(1, keepdims=True)
        _, hops, _ = self.paths_channel_loads(u / np.maximum(rs, 1))
        return hops


def saturation_from_loads(loads: np.ndarray, traffic: np.ndarray) -> float:
    """Saturation injection rate from a walk's channel loads: the
    busiest channel's or node's ejection bound, at most 1."""
    max_load = loads.max()
    # ejection bottleneck: a node cannot absorb more than 1 flit/cycle
    ej_load = traffic.sum(axis=0).max()
    return float(min(1.0 / max(max_load, 1e-12),
                     1.0 / max(ej_load, 1e-12), 1.0))


def build_routing(topo: Topology, root: int | None = None,
                  sweep_roots: bool = False,
                  include_orderings: bool = False) -> Routing:
    """Build deadlock-free routing.

    Default (root=None): BFS up*/down* from the central chiplet — ONE
    uniform policy for every topology, mirroring the paper's §V-B setup
    (their comparison holds the routing methodology fixed).

    sweep_roots=True tries several spanning-tree roots and keeps the one
    with the highest uniform saturation; include_orderings=True also
    tries coordinate-lexicographic channel orderings.  Both lift
    individual topologies substantially (EXPERIMENTS.md §I7) but amount
    to per-topology routing tuning, so they are opt-in diagnostics, not
    the default evaluation.
    """
    if root is None and not sweep_roots:
        return _build_routing_rooted(topo, _central_node(topo))
    if root is None:
        n = topo.n
        center = _central_node(topo)
        candidates: list = sorted({0, center, n // 2, n // 4, n - 1})
        builds = [lambda c=c: _build_routing_rooted(topo, c)
                  for c in candidates]
        if include_orderings:
            xy = np.lexsort((topo.pos[:, 0], topo.pos[:, 1]))
            yx = np.lexsort((topo.pos[:, 1], topo.pos[:, 0]))
            lab_xy = np.empty(n)
            lab_xy[xy] = np.arange(n)
            lab_yx = np.empty(n)
            lab_yx[yx] = np.arange(n)
            builds += [lambda lab=lab: _build_routing_rooted(topo, 0,
                                                             labels=lab)
                       for lab in (lab_xy, lab_yx)]
        best, best_rate = None, -1.0
        u = np.ones((n, n))
        np.fill_diagonal(u, 0.0)
        u /= np.maximum(u.sum(1, keepdims=True), 1)
        for make in builds:
            try:
                r = make()
                rate = r.saturation_rate(u)     # raises on dead ends
            except RuntimeError:
                continue   # ordering invalid for this topology — skip
            if rate > best_rate:
                best, best_rate = r, rate
        assert best is not None, "no valid routing found"
        return best
    return _build_routing_rooted(topo, root)


def _central_node(topo: Topology) -> int:
    """Most-central chiplet with at least one live link.  On pristine
    topologies every node has links, so this is exactly the old
    geometric-centre rule; on fault-degraded topologies (repro.faults)
    a dead chiplet may sit isolated at the centre, and rooting the
    up*/down* BFS there would label every survivor unreachable (all
    channels 'down' -> no turn prohibited -> deadlock)."""
    d2 = ((topo.pos - topo.pos.mean(0)) ** 2).sum(-1)
    deg = topo.degrees()
    if (deg > 0).any():
        d2 = np.where(deg > 0, d2, np.inf)
    return int(np.argmin(d2))


def _build_routing_rooted(topo: Topology, root: int,
                          labels: np.ndarray | None = None) -> Routing:
    n, edges = topo.n, topo.edges
    # ---- directed channels and port maps -------------------------------
    ch_src = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int32)
    ch_dst = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int32)
    pmm = topo.pos_mm()
    ch_len = np.sqrt(((pmm[ch_src] - pmm[ch_dst]) ** 2).sum(-1))
    C = len(ch_src)

    order = np.lexsort((ch_dst, ch_src))
    # per-node port indices (output side)
    ch_out_port = np.zeros(C, dtype=np.int32)
    out_counts = np.zeros(n, dtype=np.int32)
    for c in order:
        ch_out_port[c] = out_counts[ch_src[c]]
        out_counts[ch_src[c]] += 1
    in_counts = np.zeros(n, dtype=np.int32)
    ch_in_port = np.zeros(C, dtype=np.int32)
    order_in = np.lexsort((ch_src, ch_dst))
    for c in order_in:
        ch_in_port[c] = in_counts[ch_dst[c]]
        in_counts[ch_dst[c]] += 1
    P = int(max(out_counts.max(), in_counts.max()))
    out_ch = np.full((n, P), -1, dtype=np.int32)
    in_ch = np.full((n, P), -1, dtype=np.int32)
    out_ch[ch_src, ch_out_port] = np.arange(C)
    in_ch[ch_dst, ch_in_port] = np.arange(C)

    # ---- up/down labels (cycle breaking) --------------------------------
    adj = topo.adjacency()
    if labels is None:
        depth = csgraph.shortest_path(adj, unweighted=True, indices=root)
        label = depth * n + np.arange(n)       # (depth, id) lexicographic
    else:
        label = np.asarray(labels, dtype=np.float64)
    ch_is_up = label[ch_dst] < label[ch_src]

    # ---- dual graph ------------------------------------------------------
    # vertices: channels [0, C), ejection vertices [C, C+n)
    rows, cols, wts = [], [], []
    n_turns = n_prohibited = 0
    for c1 in range(C):
        v = ch_dst[c1]
        for p in range(P):
            c2 = out_ch[v, p]
            if c2 < 0:
                continue
            if ch_dst[c2] == ch_src[c1]:
                continue                        # no u-turns
            n_turns += 1
            if (not ch_is_up[c1]) and ch_is_up[c2]:
                n_prohibited += 1               # down -> up prohibited
                continue
            rows.append(c1), cols.append(c2), wts.append(1.0)
    for c in range(C):                          # channel -> ejection at dst
        rows.append(c), cols.append(C + ch_dst[c]), wts.append(0.0)
    dual = sp.csr_matrix((wts, (rows, cols)), shape=(C + n, C + n))

    # distance from every channel to every destination's ejection vertex:
    # Dijkstra on the reversed dual graph, sources = ejection vertices.
    dist = csgraph.dijkstra(dual.T, indices=np.arange(C, C + n))  # [n, C+n]
    dist = dist[:, :C]                          # to-dst distance per channel

    # ---- routing table ---------------------------------------------------
    # table[d, u, in_port]: in_port == P means freshly injected at u.
    table = np.full((n, n, P + 1), -1, dtype=np.int16)
    big = np.inf
    for d in range(n):
        cand = np.where(out_ch >= 0, 1.0 + dist[d][np.maximum(out_ch, 0)],
                        big)                    # [n, P]
        # injected packets: all turns allowed
        inj_port = np.argmin(cand, axis=1)
        ok = cand[np.arange(n), inj_port] < big
        table[d, :, P] = np.where(ok, inj_port, -1)
    # arrived-via-channel entries: restrict to allowed turns
    allowed = (dual[:C, :C].toarray() > 0)      # [C, C] allowed turns
    for c1 in range(C):
        v = ch_dst[c1]
        costs = np.full((n, P), big)
        for p in range(P):
            c2 = out_ch[v, p]
            if c2 >= 0 and allowed[c1, c2]:
                costs[:, p] = 1.0 + dist[:, c2]
        p_best = np.argmin(costs, axis=1)       # [n] best port per dst
        valid = costs[np.arange(n), p_best] < big
        table[:, v, ch_in_port[c1]] = np.where(valid, p_best, -1)
    for d in range(n):
        table[d, d, :] = Routing.EJECT

    return Routing(topo=topo, ch_src=ch_src, ch_dst=ch_dst, ch_len_mm=ch_len,
                   ch_out_port=ch_out_port, ch_in_port=ch_in_port,
                   out_ch=out_ch, in_ch=in_ch, n_ports=out_counts,
                   table=table, prohibited_turns=n_prohibited,
                   total_turns=n_turns)


def productive_ports(r: Routing) -> np.ndarray:
    """[N_dst, N, P] bool: escape-safe minimal next hops (DESIGN.md §15).

    `prod[d, u, p]` is True when forwarding a flit for destination d out
    of node u's port p is both

      * **minimal** — the channel at (u, p) leads to a neighbour w with
        `hops(w, d) + 1 == hops(u, d)` (unweighted shortest-path
        distances on the live adjacency; disconnected pairs are never
        minimal), and
      * **escape-safe** — after the hop the flit can still drain through
        the escape class: either `w == d` (next stop is ejection) or the
        static up*/down* table has a route from w's arrival in-port,
        `table[d, w, ch_in_port] >= 0`.  The escape table is indexed by
        the *arrival in-port*, whose turn restrictions keep the escape
        channel-dependency graph acyclic — re-looking-up the injection
        column at intermediate hops could retake a prohibited down->up
        turn and deadlock.

    This is the adaptive routing function of the Duato-style VC split in
    `core.simulator` (VC 0 = escape, VCs 1.. = adaptive): any subset of
    these choices keeps every buffered flit one table lookup away from a
    deadlock-free drain.  Rows at the destination itself are False (the
    table ejects).  The mask is cached on `r.prod`.
    """
    if r.prod is not None:
        return r.prod
    n, P = r.topo.n, r.max_ports
    prod = np.zeros((n, n, P), dtype=bool)
    if r.n_channels:
        hops = csgraph.shortest_path(r.topo.adjacency(), unweighted=True)
        u, w = r.ch_src, r.ch_dst
        hw, hu = hops[w], hops[u]                     # [C, N] per dst
        minimal = np.isfinite(hw) & (hw + 1 == hu)
        esc = (w[:, None] == np.arange(n)[None, :]) | \
            (r.table[:, w, r.ch_in_port].T >= 0)
        prod[:, u, r.ch_out_port] = (minimal & esc).T
        prod[np.arange(n), np.arange(n), :] = False
    r.prod = prod
    return prod


# ---------------------------------------------------------------------
# routing cache — keyed on structural hash, never on names
# ---------------------------------------------------------------------
# The cache identity is what routing depends on: the structural hash
# (nodes + edges + positions) plus substrate and chiplet area, which set
# link lengths and hop latencies.  Names are labels only: two
# topologies may share a name and differ in structure.

_ROUTING_CACHE: dict[tuple, Routing] = {}
_ROUTING_CACHE_MAX = int(os.environ.get("REPRO_ROUTING_CACHE_MAX", "4096"))
_ROUTING_CACHE_STATS = dict(hits=0, misses=0, evictions=0)


def routing_for(topo: Topology, certify: bool = False) -> Routing:
    """Build-and-cache the deadlock-free routing for a topology.

    Routing construction (Dijkstra over the dual graph) dominates
    analytic evaluation time, so a structure is only ever routed once
    per process — regardless of what it is named.

    certify=True additionally runs the exhaustive static verifier
    (`analysis.routing_verify`) and attaches the resulting
    `RoutingCertificate` as `r.cert`.  The certificate lives with the
    cached routing, so a structure is certified at most once per
    process; it raises nothing — inspect `r.cert.ok` / diagnostics.
    """
    key = (topo.structural_hash(), topo.substrate,
           float(topo.chiplet_area_mm2))
    hit = _ROUTING_CACHE.pop(key, None)
    if hit is not None:
        _ROUTING_CACHE[key] = hit          # LRU: move to the back
        _ROUTING_CACHE_STATS["hits"] += 1
        if certify and hit.cert is None:
            hit.cert = _certify(hit)
        return hit
    _ROUTING_CACHE_STATS["misses"] += 1
    with _span("routing.build", cat="routing", topology=topo.name,
               n=topo.n, substrate=topo.substrate):
        r = build_routing(topo)
    if certify:
        r.cert = _certify(r)
    _ROUTING_CACHE[key] = r
    while len(_ROUTING_CACHE) > _ROUTING_CACHE_MAX:
        _ROUTING_CACHE.pop(next(iter(_ROUTING_CACHE)))
        _ROUTING_CACHE_STATS["evictions"] += 1
    return r


def _certify(r: Routing):
    from ..analysis.routing_verify import certify_routing
    with _span("routing.certify", cat="routing", topology=r.topo.name,
               n=r.topo.n, substrate=r.topo.substrate):
        return certify_routing(r)


def routing_cache_info() -> dict:
    """Routing-cache introspection: size/max plus monotonic
    hit/miss/eviction counters (they survive `routing_cache_clear`)."""
    return dict(size=len(_ROUTING_CACHE), max_size=_ROUTING_CACHE_MAX,
                **_ROUTING_CACHE_STATS)


def routing_cache_clear() -> None:
    _ROUTING_CACHE.clear()


@functools.lru_cache(maxsize=4096)
def _cached_build(name: str, n: int, substrate: str, area: float,
                  roles: str, hex_region: bool) -> Topology:
    return build(name, n, substrate=substrate, chiplet_area_mm2=area,
                 roles_scheme=roles, hex_region=hex_region)


def cached_routing(name: str, n: int, substrate: str = "organic",
                   area: float = 74.0, roles: str = "homogeneous",
                   hex_region: bool = False) -> tuple[Topology, Routing]:
    """Build-and-cache (topology, routing) for one *named* evaluation
    cell.  Topology construction is memoized per name cell (cheap,
    needed for registered generators whose output may change between
    registrations — the build is re-validated, not the cache, in that
    case); the expensive routing is cached by `routing_for` on the
    structural hash, so same-named cells with different structures can
    no longer collide."""
    if name in CUSTOM_GENERATORS:
        # registered generators can be re-registered: never serve a
        # memoized build for them, rebuild (cheap) and let routing_for
        # key on the structure.
        topo = build(name, n, substrate=substrate, chiplet_area_mm2=area,
                     roles_scheme=roles, hex_region=hex_region)
    else:
        topo = _cached_build(name, n, substrate, area, roles, hex_region)
    return topo, routing_for(topo)


def dependency_graph_is_acyclic(r: Routing) -> bool:
    """Deprecated: use `repro_torch.analysis.routing_verify` instead.

    This predicate answers yes/no with no witness; the verifier's
    `check_acyclic` returns the actual channel-dependency cycle (as an
    RT001 diagnostic) and `certify_routing` bundles it with the
    reachability and table-well-formedness checks.  Kept as a shim over
    the same vectorized dependency-edge extraction so existing callers
    keep working."""
    import warnings

    from ..analysis.routing_verify import (dependency_edges,
                                           find_cdg_cycle)
    warnings.warn(
        "dependency_graph_is_acyclic is deprecated; use "
        "repro_torch.analysis.routing_verify.certify_routing (or "
        "routing_for(topo, certify=True)) for a witness-producing "
        "certificate", DeprecationWarning, stacklevel=2)
    return not find_cdg_cycle(dependency_edges(r), r.n_channels)
