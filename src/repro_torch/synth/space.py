"""Parametric topology design space (DESIGN.md §11).

Three candidate families, all emitting first-class validated
`Topology` objects over the existing placement rasters:

  * **fold-mask variants** — the generalization the paper's Table III
    is a few points of: every physical chain family of a raster (grid
    rows/columns, grid diagonals, brick-wall rows/diagonals) gets an
    independent wiring mode from {path, ring, folded}.  Mesh is
    all-path, Torus all-ring, FoldedTorus all-folded on the grid;
    HexaMesh is all-path and FoldedHexaTorus all-folded on the brick
    raster — and the space contains every mixed variant in between
    (e.g. folded rows + path columns).
  * **degree-bounded random geometric graphs** — a random spanning
    tree plus random extra edges over the pairs within a link-range
    budget, the unstructured half of the space (PlaceIT-style
    generation without the placement search).
  * **perturbation moves** — add / remove / rewire one edge of an
    existing candidate, the neighbourhood the evolutionary driver
    (`search`) walks.

Randomness is seeded through Threefry keys at the driver level
(`key_seeds`, on `prng`: the reference's `jax.random` keys, recomputed
in numpy); the graph construction itself runs on numpy Generators fed
those seeds, in the reference's order of calls, so candidates are
reproducible, resumable and equal to the reference's edge for edge.
"""
from __future__ import annotations

import itertools

import numpy as np

from ..core import placement as pl
from ..core.linkmodel import CHIPLET_AREA_MM2
from ..core.topology import (Topology, fold_chain, link_range_from_pitch,
                             make_topology, _brick_chains, _diag_chains,
                             _grid_chains_cols, _grid_chains_rows)
from . import prng

#: per-axis wiring modes; single-letter codes name the variants
AXIS_MODES = ("path", "ring", "folded")
_MODE_CODE = {"path": "p", "ring": "r", "folded": "f"}


def key_seeds(key, n: int) -> np.ndarray:
    """Derive `n` independent int32 seeds from a Threefry key (`prng`).

    The search driver threads keys (fold_in per generation); numpy
    Generators do the graph work on the derived seeds.  Equal to the
    reference's `jax.random.randint(key, (n,), 0, int32 max)`.
    """
    return prng.randint(key, n, 0, np.iinfo(np.int32).max)


def _axis_edges(chain: list[int], mode: str) -> list[tuple[int, int]]:
    """Wire one physical chain as a path, a ring, or a folded ring."""
    if mode == "path":
        return list(zip(chain[:-1], chain[1:]))
    if mode == "ring":
        e = list(zip(chain[:-1], chain[1:]))
        if len(chain) > 2:
            e.append((chain[0], chain[-1]))
        return e
    if mode == "folded":
        return fold_chain(chain)
    raise ValueError(f"unknown axis mode {mode!r}; choose from {AXIS_MODES}")


#: family -> (placement kwargs, ordered chain-group builders)
_FAMILIES = {
    "grid": ((False,), (
        lambda r, c: _grid_chains_rows(r, c),
        lambda r, c: _grid_chains_cols(r, c))),
    "grid_diag": ((False,), (
        lambda r, c: _grid_chains_rows(r, c),
        lambda r, c: _grid_chains_cols(r, c),
        lambda r, c: _diag_chains(r, c, +1) + _diag_chains(r, c, -1))),
    "brick": ((True,), (
        lambda r, c: _grid_chains_rows(r, c),
        lambda r, c: _brick_chains(r, c, "dr"),
        lambda r, c: _brick_chains(r, c, "dl"))),
}


def fold_mask_topology(n: int, family: str, modes: tuple,
                       substrate: str = "organic",
                       area: float = CHIPLET_AREA_MM2) -> Topology:
    """One fold-mask variant: `modes[i]` wires the family's i-th chain
    group.  Raises ValueError if the combination is disconnected."""
    if family not in _FAMILIES:
        raise KeyError(f"unknown family {family!r}; "
                       f"choose from {sorted(_FAMILIES)}")
    (brick,), groups = _FAMILIES[family]
    if len(modes) != len(groups):
        raise ValueError(f"{family} has {len(groups)} chain groups, "
                         f"got {len(modes)} modes")
    rows, cols = pl.grid_dims(n)
    pos = pl.grid_positions(rows, cols, brick=brick)
    edges: list = []
    for mode, group in zip(modes, groups):
        for chain in group(rows, cols):
            edges += _axis_edges(chain, mode)
    # dedupe before validation (axis groups can share end links)
    edges = sorted({(min(a, b), max(a, b)) for a, b in edges if a != b})
    name = f"fm_{family}_" + "".join(_MODE_CODE[m] for m in modes)
    return make_topology(name, pos, edges, substrate=substrate,
                         chiplet_area_mm2=area)


def fold_mask_variants(n: int,
                       families: tuple = ("grid", "brick", "grid_diag"),
                       substrate: str = "organic",
                       area: float = CHIPLET_AREA_MM2) -> list[Topology]:
    """Enumerate every per-axis mode assignment of the given families.

    Disconnected combinations (none on the standard rasters, but
    possible at degenerate dims) are skipped, not raised."""
    out = []
    for family in families:
        _, groups = _FAMILIES[family]
        for modes in itertools.product(AXIS_MODES, repeat=len(groups)):
            try:
                out.append(fold_mask_topology(n, family, modes,
                                              substrate=substrate,
                                              area=area))
            except ValueError:
                continue
    return out


# ---------------------------------------------------------------------
# degree-bounded random geometric graphs
# ---------------------------------------------------------------------

def _range_matrix(pos: np.ndarray) -> np.ndarray:
    """Pairwise link-range over raster positions (pitch units) — the
    one `topology.link_range_from_pitch` convention, so generated
    candidates and the feasibility filter agree on the budget."""
    d = np.sqrt(((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1))
    return link_range_from_pitch(d)


def candidate_pairs(pos: np.ndarray, max_range: int) -> np.ndarray:
    """[M, 2] node pairs (i < j) whose link-range is within budget."""
    rng = _range_matrix(pos)
    i, j = np.triu_indices(len(pos), k=1)
    ok = rng[i, j] <= max_range
    return np.stack([i[ok], j[ok]], axis=1)


def random_geometric(n: int, seed: int, family: str = "grid",
                     max_degree: int = 6, max_range: int = 1,
                     extra_frac: float | None = None,
                     substrate: str = "organic",
                     area: float = CHIPLET_AREA_MM2,
                     name: str | None = None,
                     max_tries: int = 8) -> Topology | None:
    """Random connected degree-bounded graph over a placement raster.

    A shuffled Kruskal pass builds a spanning tree from the pairs
    within `max_range` (respecting `max_degree`); a second pass adds
    random extra edges until `extra_frac` of the remaining degree
    budget is spent (drawn U[0.2, 0.9] when None).  Returns None when
    `max_tries` shuffles cannot connect the raster under the degree
    bound (only plausible for tiny max_degree).
    """
    rows, cols = pl.grid_dims(n)
    pos = pl.grid_positions(rows, cols, brick=(family == "brick"))
    pairs = candidate_pairs(pos, max_range)
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        order = rng.permutation(len(pairs))
        deg = np.zeros(n, dtype=int)
        parent = np.arange(n)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        tree, extra = [], []
        for idx in order:
            a, b = pairs[idx]
            if deg[a] >= max_degree or deg[b] >= max_degree:
                continue
            ra, rb = find(a), find(b)
            if ra == rb:
                extra.append((int(a), int(b)))
                continue
            parent[ra] = rb
            deg[a] += 1
            deg[b] += 1
            tree.append((int(a), int(b)))
        if len(tree) != n - 1:
            continue                     # unlucky shuffle; retry
        frac = float(rng.uniform(0.2, 0.9)) if extra_frac is None \
            else extra_frac
        budget = int(frac * (max_degree * n // 2 - (n - 1)))
        edges = list(tree)
        for a, b in extra:
            if budget <= 0:
                break
            if deg[a] >= max_degree or deg[b] >= max_degree:
                continue
            deg[a] += 1
            deg[b] += 1
            edges.append((a, b))
            budget -= 1
        label = name or f"rg_{family}_{seed & 0xffffffff:08x}"
        return make_topology(label, pos, edges, substrate=substrate,
                             chiplet_area_mm2=area)
    return None


# ---------------------------------------------------------------------
# perturbation moves (the evolutionary neighbourhood)
# ---------------------------------------------------------------------

def perturb(topo: Topology, seed: int, max_degree: int = 6,
            max_range: int = 1, n_moves: int = 1,
            name: str | None = None,
            max_tries: int = 16) -> Topology | None:
    """Apply `n_moves` random add/remove/rewire edge moves.

    Every move preserves the invariants the feasibility filter and
    `make_topology` enforce: connectivity, the degree bound, and the
    link-range budget.  Returns None if no valid move sequence is
    found in `max_tries` attempts (e.g. a tree with a saturated degree
    budget).
    """
    rng = np.random.default_rng(seed)
    pairs = {(int(a), int(b)) for a, b in candidate_pairs(topo.pos,
                                                          max_range)}
    base = {(min(int(a), int(b)), max(int(a), int(b)))
            for a, b in topo.edges}
    n = topo.n
    for _ in range(max_tries):
        edges = set(base)
        deg = np.zeros(n, dtype=int)
        for a, b in edges:
            deg[a] += 1
            deg[b] += 1
        ok = True
        for _m in range(n_moves):
            op = rng.choice(("add", "remove", "rewire"))
            if not _one_move(edges, deg, pairs, rng, op, max_degree, n):
                ok = False
                break
        if not ok or edges == base:
            continue
        label = name or f"{topo.name}~{seed & 0xffff:04x}"
        try:
            return make_topology(label, topo.pos, sorted(edges),
                                 substrate=topo.substrate,
                                 chiplet_area_mm2=topo.chiplet_area_mm2)
        except ValueError:
            continue                     # move disconnected the graph
    return None


def _removable(edges: set, n: int) -> list:
    """Edges whose removal keeps the graph connected (not bridges)."""
    out = []
    for e in edges:
        rest = edges - {e}
        if _connected(rest, n):
            out.append(e)
    return out


def _connected(edges: set, n: int) -> bool:
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    comp = n
    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
            comp -= 1
    return comp == 1


def _one_move(edges: set, deg: np.ndarray, pairs: set, rng, op: str,
              max_degree: int, n: int) -> bool:
    """Mutate (edges, deg) in place with one move; False if impossible."""
    if op in ("remove", "rewire"):
        cand = _removable(edges, n)
        if not cand:
            return False
        e = cand[rng.integers(len(cand))]
        edges.discard(e)
        deg[e[0]] -= 1
        deg[e[1]] -= 1
        if op == "remove":
            return True
    addable = [p for p in pairs
               if p not in edges
               and deg[p[0]] < max_degree and deg[p[1]] < max_degree]
    if not addable:
        return False
    e = addable[rng.integers(len(addable))]
    edges.add(e)
    deg[e[0]] += 1
    deg[e[1]] += 1
    return True
