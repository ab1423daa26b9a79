"""ICI topology generators — all 17 topologies of paper Table III.

The port's own copy of `repro.core.topology` (numpy/scipy only), kept
equal to it field by field (tests/test_torch_core.py), with its registry
of custom generators (`register_topology`) for the synthesis engine.

Every generator returns a `Topology`: chiplet centre positions (pitch
units), an undirected edge list, and derived properties (radix, diameter,
link lengths in mm, link-range).

The *folded* topologies are built with a single primitive, `fold_chain`:
given the ordered chain of chiplets along one topological axis, the folded
ring connects every chiplet to the one **two positions away** plus the two
end pairs — i.e. the classic folded-torus interleaving expressed directly
in physical order.  Every folded link has link-range exactly one
(Principle 2), and each axis contributes ring (not path) distances, which
halves the per-axis diameter (Principle 1):

    chain  a-b-c-d-e-f      (path, diameter 5)
    folded a-c-e ... f-d-b  (ring a,c,e,f,d,b: diameter 3)

* FoldedTorus       = fold rows + fold columns of a Mesh          (radix 4)
* FoldedHexaTorus   = fold all three axes of a HexaMesh           (radix 6)
* FoldedOctaTorus   = fold rows, columns and both diagonal axes
                      of an OctaMesh                               (radix 8)

Baselines whose original papers target different substrates
(DoubleButterfly, ButterDonut, ClusCross, Kite, SID-Mesh) are
reconstructed from their published descriptions and Table III's
radix/diameter/link-range; the paper itself adapts them ("we adapt them to
our setting"), so bit-exactness with the originals is not expected —
structural properties are validated in tests/test_topology.py.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from . import placement as pl
from .linkmodel import CHIPLET_AREA_MM2


def link_range_from_pitch(dist_pitch) -> np.ndarray:
    """The paper's §III-B link-range convention, shared by
    `Topology.link_ranges` and the synthesis design space
    (`synth.space.candidate_pairs`): round(centre distance in pitch
    units) - 1, floored at 0 — one copy, so generation and the
    feasibility filter can never disagree on the budget."""
    return np.maximum(np.rint(np.asarray(dist_pitch)).astype(int) - 1, 0)


@dataclasses.dataclass
class Topology:
    name: str
    n: int
    pos: np.ndarray            # [N, 2] centres, pitch units
    edges: np.ndarray          # [E, 2] undirected, int32
    substrate: str
    chiplet_area_mm2: float
    roles: np.ndarray | None = None   # 'C'/'M'/'I' per chiplet

    # ---- geometry ----------------------------------------------------
    @property
    def pitch_mm(self) -> float:
        return pl.pitch_mm(self.chiplet_area_mm2, self.substrate)

    @property
    def side_mm(self) -> float:
        return pl.chiplet_side_mm(self.chiplet_area_mm2)

    def pos_mm(self) -> np.ndarray:
        return self.pos * self.pitch_mm

    def link_lengths_mm(self) -> np.ndarray:
        """Centre-to-centre link lengths in mm (Fig. 2 gray band uses the
        same convention: a range-1 straight link spans ~2 pitches)."""
        p = self.pos_mm()
        d = p[self.edges[:, 0]] - p[self.edges[:, 1]]
        return np.sqrt((d ** 2).sum(-1))

    def max_link_length_mm(self) -> float:
        return float(self.link_lengths_mm().max()) if len(self.edges) else 0.0

    def link_ranges(self) -> np.ndarray:
        """Number of intermediate chiplets a link stretches across
        (paper §III-B definition; adjacency -> 0)."""
        return link_range_from_pitch(self.link_lengths_mm()
                                     / self.pitch_mm)

    # ---- graph properties ---------------------------------------------
    def adjacency(self) -> sp.csr_matrix:
        e = self.edges
        data = np.ones(len(e) * 2)
        ij = np.concatenate([e, e[:, ::-1]])
        return sp.csr_matrix((data, (ij[:, 0], ij[:, 1])),
                             shape=(self.n, self.n))

    def degrees(self) -> np.ndarray:
        return np.asarray(self.adjacency().sum(axis=1)).ravel().astype(int)

    @property
    def radix(self) -> int:
        return int(self.degrees().max())

    def hop_matrix(self) -> np.ndarray:
        return csgraph.shortest_path(self.adjacency(), method="D",
                                     unweighted=True)

    @property
    def diameter(self) -> int:
        h = self.hop_matrix()
        if np.isinf(h).any():
            raise ValueError(f"{self.name}: graph is disconnected")
        return int(h.max())

    @property
    def avg_hops(self) -> float:
        h = self.hop_matrix()
        return float(h.sum() / (self.n * (self.n - 1)))

    def is_connected(self) -> bool:
        ncomp, _ = csgraph.connected_components(self.adjacency())
        return ncomp == 1

    def structural_hash(self) -> str:
        """Stable hash of the topology *structure and geometry* — node
        count, canonical undirected edge set, and centre positions
        (quantized to 1e-6 pitch).  Two topologies with equal hashes
        route identically for a given (substrate, area), so this is the
        cache identity for `routing.routing_for` — names are labels,
        not identities (synthesized topologies may share or reuse
        names)."""
        e = np.sort(np.asarray(self.edges, np.int64), axis=1)
        e = e[np.lexsort((e[:, 1], e[:, 0]))]
        q = np.rint(np.asarray(self.pos, np.float64) * 1e6).astype(np.int64)
        h = hashlib.sha256()
        h.update(np.int64(self.n).tobytes())
        h.update(e.tobytes())
        h.update(q.tobytes())
        return h.hexdigest()


# =====================================================================
# helpers
# =====================================================================

def _dedupe(edges: list[tuple[int, int]]) -> np.ndarray:
    es = {(min(a, b), max(a, b)) for a, b in edges if a != b}
    return np.array(sorted(es), dtype=np.int32)


def validate_edges(n: int, edges: np.ndarray, name: str = "topology",
                   require_connected: bool = True) -> np.ndarray:
    """Validate a raw undirected edge list against graph invariants.

    `make_topology` takes arbitrary edge lists, so the invariants the
    hand-written generators maintain by construction are enforced here
    with clear errors: indices in range, no self-loops, no duplicate undirected
    edges, and (by default) a single connected component.  Returns the
    edges as a canonical int32 [E, 2] array.
    """
    e = np.asarray(edges, dtype=np.int64)
    if e.size == 0:
        e = e.reshape(0, 2)
    if e.ndim != 2 or e.shape[1] != 2:
        raise ValueError(f"{name}: edges must be [E, 2], got {e.shape}")
    if e.size and (e.min() < 0 or e.max() >= n):
        bad = e[(e[:, 0] < 0) | (e[:, 0] >= n)
                | (e[:, 1] < 0) | (e[:, 1] >= n)][0]
        raise ValueError(f"{name}: edge {tuple(int(x) for x in bad)} "
                         f"out of range for N={n}")
    loops = e[e[:, 0] == e[:, 1]]
    if len(loops):
        raise ValueError(f"{name}: self-loop at node {int(loops[0, 0])}")
    und = np.sort(e, axis=1)
    uniq, counts = np.unique(und, axis=0, return_counts=True)
    if (counts > 1).any():
        dup = uniq[counts > 1][0]
        raise ValueError(f"{name}: duplicate edge {tuple(int(x) for x in dup)}")
    if require_connected:
        if len(e) < n - 1:
            raise ValueError(f"{name}: disconnected graph "
                             f"({len(e)} edges < N-1={n - 1})")
        data = np.ones(len(e) * 2)
        ij = np.concatenate([e, e[:, ::-1]])
        adj = sp.csr_matrix((data, (ij[:, 0], ij[:, 1])), shape=(n, n))
        ncomp, _ = csgraph.connected_components(adj)
        if ncomp != 1:
            raise ValueError(f"{name}: disconnected graph "
                             f"({ncomp} components)")
    return np.asarray(und[np.lexsort((und[:, 1], und[:, 0]))],
                      dtype=np.int32)


def make_topology(name: str, pos: np.ndarray, edges: np.ndarray,
                  substrate: str = "organic",
                  chiplet_area_mm2: float = CHIPLET_AREA_MM2,
                  roles_scheme: str = "homogeneous") -> Topology:
    """Build a validated `Topology` from raw position/edge arrays.

    This is the front door for *custom* topologies: the same validation
    as `build`, with positions given directly instead of via a
    generator.
    """
    pos = np.asarray(pos, dtype=np.float64)
    n = len(pos)
    if pos.ndim != 2 or pos.shape[1] != 2:
        raise ValueError(f"{name}: pos must be [N, 2], got {pos.shape}")
    edges = validate_edges(n, edges, name=name)
    topo = Topology(name=name, n=n, pos=pos, edges=edges,
                    substrate=substrate,
                    chiplet_area_mm2=chiplet_area_mm2)
    topo.roles = pl.assign_roles(pos, roles_scheme)
    return topo


def fold_chain(chain: list[int]) -> list[tuple[int, int]]:
    """Folded-ring links for one physical chain (see module docstring)."""
    k = len(chain)
    if k < 2:
        return []
    if k == 2:
        return [(chain[0], chain[1])]
    edges = [(chain[j], chain[j + 2]) for j in range(k - 2)]
    edges.append((chain[0], chain[1]))
    edges.append((chain[k - 2], chain[k - 1]))
    return edges


def _grid_chains_rows(rows, cols):
    return [[i * cols + j for j in range(cols)] for i in range(rows)]


def _grid_chains_cols(rows, cols):
    return [[i * cols + j for i in range(rows)] for j in range(cols)]


def _diag_chains(rows, cols, slope):
    """Diagonal chains on a rectangular grid; slope=+1 is down-right."""
    chains = []
    starts = [(0, j) for j in range(cols)]
    starts += [(i, 0 if slope > 0 else cols - 1) for i in range(1, rows)]
    for (i0, j0) in starts:
        chain, i, j = [], i0, j0
        while 0 <= i < rows and 0 <= j < cols:
            chain.append(i * cols + j)
            i, j = i + 1, j + slope
        if len(chain) >= 2:
            chains.append(chain)
    return chains


def _brick_next(i, j, direction):
    """Successor in a brick-wall diagonal walk.  direction: 'dr'/'dl'."""
    if direction == "dr":
        return (i + 1, j) if i % 2 == 0 else (i + 1, j + 1)
    return (i + 1, j - 1) if i % 2 == 0 else (i + 1, j)


def _brick_chains(rows, cols, direction):
    """Maximal diagonal chains of a brick-wall lattice."""
    def prev(i, j):
        # invert _brick_next
        if direction == "dr":
            return (i - 1, j) if (i - 1) % 2 == 0 else (i - 1, j - 1)
        return (i - 1, j + 1) if (i - 1) % 2 == 0 else (i - 1, j)

    chains = []
    for i0 in range(rows):
        for j0 in range(cols):
            pi, pj = prev(i0, j0)
            if 0 <= pi < rows and 0 <= pj < cols:
                continue  # not a chain head
            chain, i, j = [], i0, j0
            while 0 <= i < rows and 0 <= j < cols:
                chain.append(i * cols + j)
                i, j = _brick_next(i, j, direction)
            if len(chain) >= 2:
                chains.append(chain)
    return chains


# =====================================================================
# generators (rectangular-grid placement)
# =====================================================================

def _grid_topo(name, n, edges_fn, brick=False, **kw):
    rows, cols = pl.grid_dims(n)
    pos = pl.grid_positions(rows, cols, brick=brick)
    edges = edges_fn(rows, cols)
    return name, pos, _dedupe(edges)


def _mesh_edges(rows, cols):
    e = []
    for ch in _grid_chains_rows(rows, cols) + _grid_chains_cols(rows, cols):
        e += list(zip(ch[:-1], ch[1:]))
    return e


def gen_mesh(n, **kw):
    return _grid_topo("mesh", n, _mesh_edges)


def gen_torus(n, **kw):
    def edges(rows, cols):
        e = _mesh_edges(rows, cols)
        for ch in _grid_chains_rows(rows, cols) + _grid_chains_cols(rows, cols):
            if len(ch) > 2:
                e.append((ch[0], ch[-1]))
        return e
    return _grid_topo("torus", n, edges)


def gen_folded_torus(n, **kw):
    def edges(rows, cols):
        e = []
        for ch in _grid_chains_rows(rows, cols) + _grid_chains_cols(rows, cols):
            e += fold_chain(ch)
        return e
    return _grid_topo("folded_torus", n, edges)


def gen_octamesh(n, **kw):
    def edges(rows, cols):
        e = _mesh_edges(rows, cols)
        for slope in (+1, -1):
            for ch in _diag_chains(rows, cols, slope):
                e += list(zip(ch[:-1], ch[1:]))
        return e
    return _grid_topo("octamesh", n, edges)


def gen_folded_octa_torus(n, **kw):
    def edges(rows, cols):
        e = []
        for ch in _grid_chains_rows(rows, cols) + _grid_chains_cols(rows, cols):
            e += fold_chain(ch)
        for slope in (+1, -1):
            for ch in _diag_chains(rows, cols, slope):
                e += fold_chain(ch)
        return e
    return _grid_topo("folded_octa_torus", n, edges)


# ---- hex family (brick-wall placement) -------------------------------

def _hexa_edges(rows, cols):
    e = []
    for ch in _grid_chains_rows(rows, cols):
        e += list(zip(ch[:-1], ch[1:]))
    for d in ("dr", "dl"):
        for ch in _brick_chains(rows, cols, d):
            e += list(zip(ch[:-1], ch[1:]))
    return e


def gen_hexamesh(n, hex_region=False, **kw):
    if hex_region:
        return _hex_region_topo("hexamesh", n, folded=False)
    return _grid_topo("hexamesh", n, _hexa_edges, brick=True)


def gen_folded_hexa_torus(n, hex_region=False, **kw):
    if hex_region:
        return _hex_region_topo("folded_hexa_torus", n, folded=True)

    def edges(rows, cols):
        e = []
        for ch in _grid_chains_rows(rows, cols):
            e += fold_chain(ch)
        for d in ("dr", "dl"):
            for ch in _brick_chains(rows, cols, d):
                e += fold_chain(ch)
        return e
    return _grid_topo("folded_hexa_torus", n, edges, brick=True)


def _hex_region_topo(name, n, folded):
    """Hex-spiral region variant (validates Table III formulas at perfect
    hex counts N = 3R^2+3R+1)."""
    pos = pl.hex_spiral_positions(n)
    # identify the three axes by direction between unit-distance neighbours
    key = {tuple(np.round(p * 2).astype(int)): i for i, p in enumerate(pos)}

    def axis_chains(step):
        chains, seen = [], set()
        for idx in range(n):
            p = pos[idx]
            prev = tuple(np.round((p - step) * 2).astype(int))
            if prev in key:
                continue
            chain, cur = [], tuple(np.round(p * 2).astype(int))
            while cur in key:
                chain.append(key[cur])
                cur = (cur[0] + int(round(step[0] * 2)),
                       cur[1] + int(round(step[1] * 2)))
            if len(chain) >= 2:
                chains.append(chain)
        return chains

    steps = [np.array([1.0, 0.0]), np.array([0.5, 1.0]), np.array([-0.5, 1.0])]
    e = []
    for s in steps:
        for ch in axis_chains(s):
            e += fold_chain(ch) if folded else list(zip(ch[:-1], ch[1:]))
    return name, pos, _dedupe(e)


# ---- interposer-baseline reconstructions ------------------------------

def gen_double_butterfly(n, **kw):
    def edges(rows, cols):
        e = []
        for ch in _grid_chains_cols(rows, cols):
            e += list(zip(ch[:-1], ch[1:]))
        for i in range(rows):
            stride = max(cols // 2, 1) if i % 2 == 0 else max(cols // 4, 1)
            for j in range(cols - stride):
                e.append((i * cols + j, i * cols + j + stride))
            # short pair links, staggered per row so stride classes mix
            off = i % 2
            for j in range(off, cols - 1, 2):
                e.append((i * cols + j, i * cols + j + 1))
        return e
    return _grid_topo("double_butterfly", n, edges)


def gen_butterdonut(n, **kw):
    def edges(rows, cols):
        name_, pos_, e = gen_double_butterfly(rows * cols)
        e = [tuple(x) for x in e]
        half = max(cols // 2, 1)
        for i in range(1, rows, 2):    # donut links: half-row spans on the
            if cols > 2:               # rows that only have c/4 strides
                e.append((i * cols, i * cols + half))
                e.append((i * cols + cols - 1 - half, i * cols + cols - 1))
        return e
    return _grid_topo("butterdonut", n, edges)


def _cluscross_edges(rows, cols, version):
    """ClusCross reconstruction: 2x2 clusters wired as rings; one inter-
    cluster link per node forming a cluster-level mesh, except that each
    cluster's eastbound link is replaced by a long *cross* link — to the
    row-mirrored cluster (V1) or to the cluster half a row away (V2)."""
    e = []
    cr, cc = rows // 2, cols // 2     # cluster grid
    def corners(I, J):
        # [TL, TR, BL, BR]
        return [(2 * I) * cols + 2 * J, (2 * I) * cols + 2 * J + 1,
                (2 * I + 1) * cols + 2 * J, (2 * I + 1) * cols + 2 * J + 1]
    for I in range(cr):
        for J in range(cc):
            tl, tr, bl, br = corners(I, J)
            e += [(tl, tr), (tr, br), (br, bl), (bl, tl)]   # intra ring
            if I > 0:                      # north: TL -> BL of cluster above
                e.append((tl, corners(I - 1, J)[2]))
            if J > 0:                      # west:  BL -> BR of left cluster
                e.append((bl, corners(I, J - 1)[3]))
            # east cross link from TR
            J2 = (cc - 1 - J) if version == 1 else (J + cc // 2) % cc
            if J2 != J:
                e.append((tr, corners(I, J2)[0]))
    return e


def gen_cluscross_v1(n, **kw):
    return _grid_topo("cluscross_v1", n,
                      lambda r, c: _cluscross_edges(r, c, 1))


def gen_cluscross_v2(n, **kw):
    return _grid_topo("cluscross_v2", n,
                      lambda r, c: _cluscross_edges(r, c, 2))


def _kite_diag_edges(rows, cols):
    e = []
    for i in range(rows - 1):
        for j in range(cols):
            jj = j + 1 if j % 2 == 0 else j - 1
            if 0 <= jj < cols:
                e.append((i * cols + j, (i + 1) * cols + jj))
    return e


def gen_kite_small(n, **kw):
    def edges(rows, cols):
        e = []
        for ch in _grid_chains_rows(rows, cols):
            e += list(zip(ch[:-1], ch[1:]))
        e += _kite_diag_edges(rows, cols)
        return e
    return _grid_topo("kite_small", n, edges)


def gen_kite_medium(n, **kw):
    def edges(rows, cols):
        e = []
        for i, ch in enumerate(_grid_chains_rows(rows, cols)):
            e += (fold_chain(ch) if i % 2 == 1 else
                  list(zip(ch[:-1], ch[1:])))
        e += _kite_diag_edges(rows, cols)
        return e
    return _grid_topo("kite_medium", n, edges)


def gen_kite_large(n, **kw):
    def edges(rows, cols):
        e = []
        for ch in _grid_chains_rows(rows, cols):
            e += fold_chain(ch)
        e += _kite_diag_edges(rows, cols)
        return e
    return _grid_topo("kite_large", n, edges)


def gen_sid_mesh(n, **kw):
    def edges(rows, cols):
        e = []
        for slope in (+1, -1):
            for ch in _diag_chains(rows, cols, slope):
                e += list(zip(ch[:-1], ch[1:]))
        # orthogonal boundary links join the two diagonal sublattices
        for j in range(cols - 1):
            e.append((j, j + 1))
            e.append(((rows - 1) * cols + j, (rows - 1) * cols + j + 1))
        for i in range(rows - 1):
            e.append((i * cols, (i + 1) * cols))
            e.append((i * cols + cols - 1, (i + 1) * cols + cols - 1))
        return e
    return _grid_topo("sid_mesh", n, edges)


def gen_hypercube(n, **kw):
    k = int(round(math.log2(n)))
    if 2 ** k != n:
        raise ValueError(f"hypercube needs a power-of-two N, got {n}")
    rows, cols = pl.grid_dims(n)
    kr, kc = int(round(math.log2(rows))), int(round(math.log2(cols)))
    gray = lambda x: x ^ (x >> 1)
    # gray-code placement minimizes physical length of dimension links
    coord = np.zeros((n, 2))
    inv_gray_r = {gray(i): i for i in range(rows)}
    inv_gray_c = {gray(i): i for i in range(cols)}
    for v in range(n):
        hi, lo = v >> kc, v & (cols - 1)
        coord[v] = (inv_gray_c[lo] if lo in inv_gray_c else lo,
                    inv_gray_r[hi] if hi in inv_gray_r else hi)
    e = [(v, v ^ (1 << b)) for v in range(n) for b in range(k) if v < v ^ (1 << b)]
    return "hypercube", coord, _dedupe(e)


def gen_flattened_butterfly(n, **kw):
    def edges(rows, cols):
        e = []
        for ch in _grid_chains_rows(rows, cols) + _grid_chains_cols(rows, cols):
            for a in range(len(ch)):
                for b in range(a + 1, len(ch)):
                    e.append((ch[a], ch[b]))
        return e
    return _grid_topo("flattened_butterfly", n, edges)


def gen_honeycomb_mesh(n, **kw):
    def edges(rows, cols):
        e = []
        for ch in _grid_chains_rows(rows, cols):
            e += list(zip(ch[:-1], ch[1:]))
        for i in range(rows - 1):
            for j in range(cols):
                if (i + j) % 2 == 0:
                    e.append((i * cols + j, (i + 1) * cols + j))
        return e
    return _grid_topo("honeycomb_mesh", n, edges)


def gen_honeycomb_torus(n, **kw):
    def edges(rows, cols):
        e = []
        for ch in _grid_chains_rows(rows, cols):
            e += list(zip(ch[:-1], ch[1:]))
            if cols > 2:
                e.append((ch[0], ch[-1]))
        for i in range(rows - 1):
            for j in range(cols):
                if (i + j) % 2 == 0:
                    e.append((i * cols + j, (i + 1) * cols + j))
        for j in range(cols):            # vertical wraps keep degree 3
            if (rows - 1 + j) % 2 == 0 and rows > 2:
                e.append(((rows - 1) * cols + j, j))
        return e
    return _grid_topo("honeycomb_torus", n, edges)


# =====================================================================
# registry
# =====================================================================

GENERATORS: dict[str, Callable] = {
    "mesh": gen_mesh,
    "torus": gen_torus,
    "folded_torus": gen_folded_torus,
    "hexamesh": gen_hexamesh,
    "folded_hexa_torus": gen_folded_hexa_torus,
    "octamesh": gen_octamesh,
    "folded_octa_torus": gen_folded_octa_torus,
    "double_butterfly": gen_double_butterfly,
    "butterdonut": gen_butterdonut,
    "cluscross_v1": gen_cluscross_v1,
    "cluscross_v2": gen_cluscross_v2,
    "kite_small": gen_kite_small,
    "kite_medium": gen_kite_medium,
    "kite_large": gen_kite_large,
    "sid_mesh": gen_sid_mesh,
    "hypercube": gen_hypercube,
    "flattened_butterfly": gen_flattened_butterfly,
    "honeycomb_mesh": gen_honeycomb_mesh,
    "honeycomb_torus": gen_honeycomb_torus,
}

# topologies whose generators require power-of-two / even-grid N
N_CONSTRAINTS = {
    "hypercube": lambda n: (n & (n - 1)) == 0,
    "cluscross_v1": lambda n: all(d % 2 == 0 for d in pl.grid_dims(n)),
    "cluscross_v2": lambda n: all(d % 2 == 0 for d in pl.grid_dims(n)),
}

def valid_n(name: str, n: int) -> bool:
    """Does `name`'s generator accept this chiplet count?  (True for
    names without an entry in `N_CONSTRAINTS` — including custom
    generators, which validate at build time.)"""
    rule = N_CONSTRAINTS.get(name)
    return rule is None or bool(rule(n))


def nearest_valid_n(name: str, n: int) -> int:
    """Largest supported N' <= n for a constrained generator (falls
    back to the smallest supported N' > n when nothing below fits).
    Used by sweep CLIs so `--all-builtin -n 36` can still exercise
    e.g. the hypercube at 32 instead of skipping it."""
    if valid_n(name, n):
        return n
    for cand in range(n - 1, 1, -1):
        if valid_n(name, cand):
            return cand
    for cand in range(n + 1, 4 * n + 2):
        if valid_n(name, cand):
            return cand
    raise ValueError(f"{name}: no supported N near {n}")


#: user/synth-registered generators, consulted by `build` after the
#: built-in table.  A custom generator is `gen(n, **kw)` returning either
#: a `(name, pos, edges)` triple (the built-in convention) or a full
#: `Topology` (re-stamped with the requested substrate/area/roles).
CUSTOM_GENERATORS: dict[str, Callable] = {}


def register_topology(name: str, generator: Callable,
                      overwrite: bool = False) -> None:
    """Register a custom topology generator under `name` for `build`.

    Registered names live alongside the paper's Table-III registry: the
    experiment planner, `cached_routing` and benchmarks resolve them
    transparently.  Routing caching keys on the *structural hash* of
    what the generator emits, so re-registering a name with a different
    structure cannot serve stale routing (see routing.routing_for).
    """
    if name in GENERATORS:
        raise ValueError(f"{name!r} is a built-in Table-III topology; "
                         "pick a different name")
    if name in CUSTOM_GENERATORS and not overwrite:
        raise ValueError(f"{name!r} already registered; pass "
                         "overwrite=True to replace it")
    if not callable(generator):
        raise TypeError(f"generator for {name!r} must be callable")
    CUSTOM_GENERATORS[name] = generator


def unregister_topology(name: str) -> None:
    CUSTOM_GENERATORS.pop(name, None)


def build(name: str, n: int, substrate: str = "organic",
          chiplet_area_mm2: float = CHIPLET_AREA_MM2,
          roles_scheme: str = "homogeneous", hex_region: bool = False,
          ) -> Topology:
    if name in GENERATORS:
        if not valid_n(name, n):
            raise ValueError(f"{name} does not support N={n}")
        kw = {"hex_region": hex_region} if name in (
            "hexamesh", "folded_hexa_torus") else {}
        name_, pos, edges = GENERATORS[name](n, **kw)
    elif name in CUSTOM_GENERATORS:
        out = CUSTOM_GENERATORS[name](n)
        if isinstance(out, Topology):
            if out.n != n:
                raise ValueError(f"{name}: generator returned N={out.n}, "
                                 f"requested N={n}")
            name_, pos, edges = out.name, out.pos, out.edges
        else:
            name_, pos, edges = out
    else:
        raise KeyError(f"unknown topology {name!r}; choose from "
                       f"{sorted(GENERATORS)} or register_topology() it")
    if len(pos) != n:
        raise ValueError(f"{name_}: generator emitted {len(pos)} "
                         f"positions, requested N={n}")
    edges = validate_edges(len(pos), edges, name=name_)
    topo = Topology(name=name_, n=n, pos=np.asarray(pos, np.float64),
                    edges=edges,
                    substrate=substrate, chiplet_area_mm2=chiplet_area_mm2)
    topo.roles = pl.assign_roles(topo.pos, roles_scheme)
    return topo
