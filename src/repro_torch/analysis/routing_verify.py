"""Exhaustive routing verification (DESIGN.md §14).

The paper's deadlock-freedom argument (up*/down* turn prohibition makes
the channel-dependency graph acyclic) was previously spot-checked: a
bool-only `dependency_graph_is_acyclic` sampled by tests.  This module
*certifies* each shipped routing artifact exhaustively and produces a
witness for every violation:

  * **RT001 cdg-cycle** — the *used* channel-dependency graph (an edge
    c1 -> c2 whenever some destination's table entry can chain channel
    c1 into channel c2) must be acyclic.  The witness is the actual
    cycle as a channel list with (src -> dst) node decoding.
  * **RT002 unreachable-pair / RT004 routing-loop** — following the
    table from every (src, dst) pair that the topology connects must
    deliver within a hop bound.  Exhaustive over all N^2 pairs — not
    weighted by a traffic matrix, so zero-traffic pairs are checked
    too (the analytic path-follower skips them).  On fault-degraded
    topologies, pairs involving isolated (dead) chiplets are exempt by
    construction: reachability is required exactly within connected
    components of the surviving structure.
  * **RT003 undeclared-channel** — every non-negative table entry must
    name an output port that carries a declared channel (`out_ch >= 0`
    and within the node's real port count).
  * **RT005 escape-unsafe** — Duato escape condition for the
    minimal-adaptive mode (DESIGN.md §15): every adaptive choice in the
    productive-ports mask must (a) be strictly minimal, (b) name a
    declared channel, and (c) leave the flit in a state — (next node,
    arrival in-port) — from which the escape table (VC 0, the static
    up*/down* table) still delivers to the destination; and the CDG
    restricted to the escape class must stay acyclic.  Witnesses are
    the concrete (dst, node, port) choice that breaks, or the escape-
    class cycle.

`certify_routing` bundles the checks into a `RoutingCertificate`
that `routing.routing_for(topo, certify=True)` caches alongside the
routing, so a structure is certified at most once per process.

The port's copy of `repro.analysis.routing_verify` (numpy and scipy
only): the same checks, certificates and witnesses.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from .diagnostics import Diagnostic, Report, diag


@dataclasses.dataclass(frozen=True)
class RoutingCertificate:
    """Outcome of exhaustive verification of one routing artifact."""
    target: str                 # "name/nN/substrate" label
    acyclic: bool               # CDG is a DAG
    complete: bool              # every connected pair delivered
    declared: bool              # every table entry names a real channel
    n_channels: int
    n_dep_edges: int            # used channel-dependency edges
    n_pairs_checked: int
    max_hops_seen: int
    escape_safe: bool = True    # RT005: adaptive choices keep an escape
    n_adaptive_choices: int = 0  # productive-ports entries verified
    diagnostics: tuple = ()     # the violations (empty == certified)

    @property
    def ok(self) -> bool:
        return self.acyclic and self.complete and self.declared \
            and self.escape_safe


def _target(r) -> str:
    t = r.topo
    return f"{t.name}/n{t.n}/{t.substrate}"


def dependency_edges(r) -> np.ndarray:
    """[M, 2] used channel-dependency edges, derived from the table.

    An edge (c1, c2) means: a packet that arrived over channel c1 can,
    for some destination, be forwarded onto channel c2.  Vectorized
    over (destination, channel) — exhaustive, unlike sampling paths.
    """
    n, C, P = r.topo.n, r.n_channels, r.max_ports
    if C == 0:
        return np.zeros((0, 2), dtype=np.int64)
    d_idx, c_idx = np.meshgrid(np.arange(n), np.arange(C), indexing="ij")
    d_idx, c_idx = d_idx.ravel(), c_idx.ravel()
    v = r.ch_dst[c_idx]                          # node the flit sits at
    p = r.table[d_idx, v, r.ch_in_port[c_idx]].astype(np.int64)
    fwd = p >= 0                                 # not EJECT/-1
    c2 = r.out_ch[v[fwd], np.clip(p[fwd], 0, P - 1)]
    ok = c2 >= 0
    pairs = np.stack([c_idx[fwd][ok], c2[ok]], axis=1)
    return np.unique(pairs, axis=0)


def find_cdg_cycle(edges: np.ndarray, n_channels: int) -> list[int]:
    """A concrete cycle in the dependency graph, or [] if acyclic.

    Iterative DFS with colouring (no recursion limit, no networkx
    dependency on the hot path); returns the cycle as an ordered
    channel list [c0, c1, ..., ck] with an implied edge ck -> c0.
    """
    if len(edges) == 0:
        return []
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    e = edges[order]
    starts = np.searchsorted(e[:, 0], np.arange(n_channels + 1))
    colour = np.zeros(n_channels, dtype=np.int8)   # 0 new 1 open 2 done
    for root in range(n_channels):
        if colour[root]:
            continue
        stack = [(root, int(starts[root]))]
        colour[root] = 1
        path = [root]
        while stack:
            u, i = stack[-1]
            if i >= starts[u + 1]:
                stack.pop()
                path.pop()
                colour[u] = 2
                continue
            stack[-1] = (u, i + 1)
            w = int(e[i, 1])
            if colour[w] == 1:                      # back edge: cycle
                return path[path.index(w):]
            if colour[w] == 0:
                colour[w] = 1
                stack.append((w, int(starts[w])))
                path.append(w)
    return []


def _decode_cycle(r, cycle: list[int]) -> list[tuple]:
    """Channel ids -> (channel, src_node, dst_node) triples."""
    return [(int(c), int(r.ch_src[c]), int(r.ch_dst[c])) for c in cycle]


def check_acyclic(r) -> list[Diagnostic]:
    """RT001 with the actual cycle as witness (empty list == acyclic)."""
    edges = dependency_edges(r)
    cycle = find_cdg_cycle(edges, r.n_channels)
    if not cycle:
        return []
    hops = " -> ".join(f"{s}->{d}" for _, s, d in _decode_cycle(r, cycle))
    return [diag(
        "RT001",
        f"channel-dependency cycle of length {len(cycle)}: {hops} "
        f"(deadlock possible)",
        target=_target(r), cycle=[int(c) for c in cycle],
        cycle_nodes=_decode_cycle(r, cycle), n_dep_edges=len(edges))]


def check_table_channels(r) -> list[Diagnostic]:
    """RT003: every table entry must name a declared output channel."""
    n, P = r.topo.n, r.max_ports
    p = r.table.astype(np.int64)                    # [dst, node, in_port]
    node = np.arange(n)[None, :, None]
    used = p >= 0
    out_of_range = used & (p > P - 1)
    undeclared = used & ~out_of_range & \
        (r.out_ch[node, np.clip(p, 0, P - 1)] < 0)
    bad = out_of_range | undeclared
    if not bad.any():
        return []
    d_, u_, ip_ = np.argwhere(bad)[0]
    return [diag(
        "RT003",
        f"table[dst={d_}, node={u_}, in_port={ip_}] = port "
        f"{int(p[d_, u_, ip_])} has no declared channel at node {u_} "
        f"(out_ch == -1)",
        target=_target(r), n_bad=int(bad.sum()),
        entry=(int(d_), int(u_), int(ip_)),
        port=int(p[d_, u_, ip_]))]


def _required_pairs(r) -> np.ndarray:
    """[N, N] bool: pairs the surviving structure connects (s != d).

    Dead chiplets on fault-degraded topologies have no live links and
    sit in singleton components — no pair involving them is required.
    """
    t = r.topo
    e = np.asarray(t.edges)
    if len(e) == 0:
        return np.zeros((t.n, t.n), dtype=bool)
    data = np.ones(len(e) * 2)
    ij = np.concatenate([e, e[:, ::-1]])
    adj = sp.csr_matrix((data, (ij[:, 0], ij[:, 1])), shape=(t.n, t.n))
    _, comp = csgraph.connected_components(adj)
    deg = np.asarray(adj.sum(axis=1)).ravel()
    live = deg > 0
    same = (comp[:, None] == comp[None, :]) & np.outer(live, live)
    np.fill_diagonal(same, False)
    return same


def check_reachability(r, max_hops: int | None = None
                       ) -> tuple[list[Diagnostic], int, int]:
    """RT002/RT004: follow the table for EVERY connected (s, d) pair.

    Returns (diagnostics, n_pairs_checked, max_hops_seen).  Unlike
    `Routing.paths_channel_loads` this ignores traffic weights (zero-
    traffic pairs are verified too) and reports a witness instead of
    raising.
    """
    t = r.topo
    n, P = t.n, r.max_ports
    req = _required_pairs(r)
    s_idx, d_idx = np.nonzero(req)
    n_pairs = len(s_idx)
    if n_pairs == 0:
        return [], 0, 0
    if max_hops is None:
        max_hops = 4 * n
    cur = s_idx.astype(np.int64).copy()
    in_port = np.full(n_pairs, P, dtype=np.int64)   # injection column
    alive = np.ones(n_pairs, dtype=bool)
    hops = np.zeros(n_pairs, dtype=np.int64)
    out: list[Diagnostic] = []
    for _ in range(max_hops):
        if not alive.any():
            break
        p = r.table[d_idx[alive], cur[alive], in_port[alive]].astype(
            np.int64)
        dead = p == -1
        if dead.any():
            j = np.flatnonzero(alive)[np.argmax(dead)]
            out.append(diag(
                "RT002",
                f"no route for pair ({int(s_idx[j])} -> {int(d_idx[j])}):"
                f" table dead end at node {int(cur[j])}, in_port "
                f"{int(in_port[j])} after {int(hops[j])} hop(s)",
                target=_target(r),
                pair=(int(s_idx[j]), int(d_idx[j])),
                stuck_at=int(cur[j]), in_port=int(in_port[j]),
                n_dead_pairs=int(dead.sum())))
            keep = ~dead
            idx = np.flatnonzero(alive)
            alive[idx[dead]] = False
            if not keep.any():
                continue
            p = p[keep]
        ch = r.out_ch[cur[alive], np.clip(p, 0, P - 1)]
        step_ok = (p >= 0) & (ch >= 0)
        # undeclared channels already covered by RT003; drop those pairs
        idx = np.flatnonzero(alive)
        alive[idx[~step_ok]] = False
        if not step_ok.any():
            continue
        ch = ch[step_ok]
        idx = idx[step_ok]
        cur[idx] = r.ch_dst[ch]
        in_port[idx] = r.ch_in_port[ch]
        hops[idx] += 1
        arrived = cur[idx] == d_idx[idx]
        alive[idx[arrived]] = False
    if alive.any():
        j = int(np.flatnonzero(alive)[0])
        out.append(diag(
            "RT004",
            f"pair ({int(s_idx[j])} -> {int(d_idx[j])}) still in flight "
            f"after {max_hops} hops (livelock); currently at node "
            f"{int(cur[j])}",
            target=_target(r), pair=(int(s_idx[j]), int(d_idx[j])),
            at_node=int(cur[j]), n_looping=int(alive.sum()),
            hop_bound=max_hops))
    return out, n_pairs, int(hops.max()) if n_pairs else 0


def check_escape(r, max_hops: int | None = None
                 ) -> tuple[list[Diagnostic], int]:
    """RT005: Duato escape condition for minimal-adaptive routing.

    Verifies, exhaustively over every entry of the productive-ports
    mask (`routing.productive_ports`, DESIGN.md §15):

      * **minimality** — the port's downstream node is strictly one hop
        closer to the destination (the adaptive class never lengthens a
        path, so hop-count livelock is impossible);
      * **declared channel** — the port carries a real channel;
      * **escape deliverability** — from the post-hop state (next node
        w, arrival in-port q), following the *escape* table (the static
        up*/down* class, VC 0) delivers to the destination within the
        hop bound.  This is the in-port-indexed state the simulator's
        escape fallback actually consults, so certifying it certifies
        the exact drain every buffered adaptive flit falls back to.

    Plus the escape-class CDG acyclicity: the escape class routes by
    the same static table, so its dependency graph is
    `dependency_edges(r)` — a cycle there breaks the Duato argument
    even if every individual choice can still reach an escape entry.

    Returns (diagnostics, n_adaptive_choices).
    """
    from ..core.routing import productive_ports

    t = r.topo
    n, P = t.n, r.max_ports
    out: list[Diagnostic] = []
    prod = productive_ports(r)
    d_idx, u_idx, p_idx = np.nonzero(prod)
    n_choices = len(d_idx)
    if n_choices == 0:
        return out, 0

    # (a) minimality of every masked port
    hops = csgraph.shortest_path(t.adjacency(), unweighted=True)
    ch = r.out_ch[u_idx, p_idx].astype(np.int64)
    undeclared = ch < 0
    if undeclared.any():
        j = int(np.argmax(undeclared))
        out.append(diag(
            "RT005",
            f"productive port (dst={int(d_idx[j])}, node={int(u_idx[j])},"
            f" port={int(p_idx[j])}) has no declared channel",
            target=_target(r), n_bad=int(undeclared.sum()),
            choice=(int(d_idx[j]), int(u_idx[j]), int(p_idx[j]))))
    ok = ~undeclared
    w = np.where(ok, r.ch_dst[np.clip(ch, 0, max(r.n_channels - 1, 0))],
                 0)
    hw = hops[w, d_idx]
    hu = hops[u_idx, d_idx]
    non_min = ok & ~(np.isfinite(hw) & np.isfinite(hu) & (hw + 1 == hu))
    if non_min.any():
        j = int(np.argmax(non_min))
        out.append(diag(
            "RT005",
            f"productive port (dst={int(d_idx[j])}, node={int(u_idx[j])},"
            f" port={int(p_idx[j])}) is not minimal: next node "
            f"{int(w[j])} is {hw[j]:.0f} hop(s) from the destination, "
            f"node {int(u_idx[j])} is {hu[j]:.0f}",
            target=_target(r), n_bad=int(non_min.sum()),
            choice=(int(d_idx[j]), int(u_idx[j]), int(p_idx[j])),
            next_node=int(w[j])))
    ok &= ~non_min

    # (c) escape deliverability from every post-hop (w, q, dst) state
    if max_hops is None:
        max_hops = 4 * n
    live = ok & (w != d_idx)            # arrival at dst needs no escape
    idx0 = np.flatnonzero(live)
    cur = w[idx0].copy()
    q = r.ch_in_port[ch[idx0]].astype(np.int64)
    dst = d_idx[idx0]
    alive = np.ones(len(idx0), dtype=bool)
    for _ in range(max_hops):
        if not alive.any():
            break
        p = r.table[dst[alive], cur[alive], q[alive]].astype(np.int64)
        c2 = r.out_ch[cur[alive], np.clip(p, 0, P - 1)]
        step_ok = (p >= 0) & (c2 >= 0)
        idx = np.flatnonzero(alive)
        if (~step_ok).any():            # dead end: escape lost
            j = int(idx0[idx[np.argmax(~step_ok)]])
            out.append(diag(
                "RT005",
                f"adaptive choice (dst={int(d_idx[j])}, "
                f"node={int(u_idx[j])}, port={int(p_idx[j])}) loses its "
                f"escape: static table dead-ends at node "
                f"{int(cur[idx[np.argmax(~step_ok)]])} before reaching "
                f"the destination",
                target=_target(r),
                choice=(int(d_idx[j]), int(u_idx[j]), int(p_idx[j])),
                n_bad=int((~step_ok).sum())))
            alive[idx[~step_ok]] = False
            if not step_ok.any():
                continue
        idx = idx[step_ok]
        c2 = c2[step_ok]
        cur[idx] = r.ch_dst[c2]
        q[idx] = r.ch_in_port[c2]
        alive[idx[cur[idx] == dst[idx]]] = False
    if alive.any():
        j = int(idx0[np.flatnonzero(alive)[0]])
        out.append(diag(
            "RT005",
            f"adaptive choice (dst={int(d_idx[j])}, node={int(u_idx[j])},"
            f" port={int(p_idx[j])}): escape path still in flight after "
            f"{max_hops} hops (escape livelock)",
            target=_target(r),
            choice=(int(d_idx[j]), int(u_idx[j]), int(p_idx[j])),
            n_looping=int(alive.sum()), hop_bound=max_hops))

    # escape-class CDG acyclicity (same table => same dependency edges)
    edges = dependency_edges(r)
    cycle = find_cdg_cycle(edges, r.n_channels)
    if cycle:
        hop_s = " -> ".join(f"{s}->{d}"
                            for _, s, d in _decode_cycle(r, cycle))
        out.append(diag(
            "RT005",
            f"escape-class channel-dependency cycle of length "
            f"{len(cycle)}: {hop_s} (the escape drain can deadlock)",
            target=_target(r), cycle=[int(c) for c in cycle],
            cycle_nodes=_decode_cycle(r, cycle)))
    return out, n_choices


def certify_routing(r) -> RoutingCertificate:
    """Run all exhaustive checks and bundle the certificate."""
    cyc = check_acyclic(r)
    decl = check_table_channels(r)
    reach, n_pairs, max_hops = check_reachability(r)
    esc, n_choices = check_escape(r)
    edges = dependency_edges(r)
    return RoutingCertificate(
        target=_target(r),
        acyclic=not cyc,
        complete=not any(d.code in ("RT002", "RT004") for d in reach),
        declared=not decl,
        n_channels=r.n_channels, n_dep_edges=len(edges),
        n_pairs_checked=n_pairs, max_hops_seen=max_hops,
        escape_safe=not esc, n_adaptive_choices=n_choices,
        diagnostics=tuple(cyc + decl + reach + esc))


def verify_routing(r, report: Report | None = None) -> RoutingCertificate:
    """Certify `r`, appending its diagnostics to `report` if given."""
    cert = certify_routing(r)
    if report is not None:
        report.record("routing", cert.target)
        report.extend(cert.diagnostics)
    return cert
