"""Traffic patterns (paper §V-C/D/E).

All patterns return an [N, N] matrix whose row i is the probability
distribution of destinations for packets injected at node i (rows of inert
sources are all-zero).  Heterogeneous variants implement the paper's 50/50
core-to-core + core-to-memory mix (§V-C) and the C/M/I cache-coherence
placement used with traces (§V-E).

The port's own copy of `repro.core.traffic`: the static patterns and
the trace-region profiles the workloads and Fig. 10 read.
"""
from __future__ import annotations

import numpy as np

from .topology import Topology


def _normalize(m: np.ndarray) -> np.ndarray:
    np.fill_diagonal(m, 0.0)
    rows = m.sum(axis=1, keepdims=True)
    out = np.divide(m, rows, out=np.zeros_like(m), where=rows > 0)
    return out


def uniform(topo: Topology) -> np.ndarray:
    n = topo.n
    return _normalize(np.ones((n, n)))


def random_permutation(topo: Topology, seed: int = 0) -> np.ndarray:
    """Each source sends all traffic to one random distinct destination.

    The mapping is a proper *derangement*: rejection-sample a uniform
    one, falling back to a cyclic shift of a random order (always
    fixed-point-free) if none of the draws lands.  The seed code instead
    patched fixed points with pairwise swaps — a repair whose swap
    partner `j` can itself end up mapped back to `i`, reintroducing a
    fixed point that `_normalize` then silently turns into an inert
    all-zero source row (regression: tests/test_traffic_properties.py
    seed sweep).
    """
    n = topo.n
    if n < 2:
        return np.zeros((n, n))
    rng = np.random.default_rng(seed)
    for _ in range(8):
        perm = rng.permutation(n)
        if not np.any(perm == np.arange(n)):
            break
    else:
        # cyclic-shift fallback: order[i] -> order[i+1] is a single
        # n-cycle, hence a derangement for any n >= 2
        order = rng.permutation(n)
        perm = np.empty(n, dtype=np.int64)
        perm[order] = np.roll(order, -1)
    m = np.zeros((n, n))
    m[np.arange(n), perm] = 1.0
    return _normalize(m)


def tornado(topo: Topology) -> np.ndarray:
    """Half-machine offset along the x dimension (adversarial for rings)."""
    n = topo.n
    order = np.lexsort((topo.pos[:, 0], topo.pos[:, 1]))  # row-major ranks
    rank = np.empty(n, dtype=int)
    rank[order] = np.arange(n)
    m = np.zeros((n, n))
    shift = n // 2
    for i in range(n):
        target_rank = (rank[i] + shift) % n
        m[i, order[target_rank]] = 1.0
    return _normalize(m)


def neighbor(topo: Topology) -> np.ndarray:
    """Each source spreads traffic uniformly over its physical neighbours
    (chiplets within 1.75 pitch — the adjacent ring)."""
    n = topo.n
    d = np.sqrt(((topo.pos[:, None, :] - topo.pos[None, :, :]) ** 2).sum(-1))
    m = ((d > 0) & (d <= 1.75)).astype(float)
    # isolated fallbacks: nearest node
    for i in range(n):
        if m[i].sum() == 0:
            j = np.argsort(d[i])[1]
            m[i, j] = 1.0
    return _normalize(m)


def hetero_mix(topo: Topology, frac_mem: float = 0.5) -> np.ndarray:
    """50/50 core-to-core + core-to-memory (paper §V-C, Fig. 6).

    Compute chiplets send `1-frac_mem` uniformly to other compute chiplets
    and `frac_mem` uniformly to memory chiplets; memory chiplets reply
    uniformly to compute chiplets (read responses).
    """
    roles = topo.roles
    n = topo.n
    is_c = roles == "C"
    is_m = roles == "M"
    if is_m.sum() == 0:
        return uniform(topo)
    m = np.zeros((n, n))
    m[np.ix_(is_c, is_c)] = (1 - frac_mem) / max(is_c.sum() - 1, 1)
    m[np.ix_(is_c, is_m)] = frac_mem / is_m.sum()
    m[np.ix_(is_m, is_c)] = 1.0 / is_c.sum()
    return _normalize(m)


def coherence_cmi(topo: Topology) -> np.ndarray:
    """Cache-coherence-style flows for the trace experiment (§V-E):
    L1 (compute) <-> L2 (memory) <-> main memory (IO)."""
    roles = topo.roles
    n = topo.n
    is_c, is_m, is_i = roles == "C", roles == "M", roles == "I"
    if is_m.sum() == 0 or is_i.sum() == 0:
        return hetero_mix(topo)
    m = np.zeros((n, n))
    m[np.ix_(is_c, is_m)] = 0.8 / is_m.sum()     # L1 -> L2
    m[np.ix_(is_c, is_c)] = 0.2 / max(is_c.sum() - 1, 1)  # C2C coherence
    m[np.ix_(is_m, is_c)] = 0.7 / is_c.sum()     # L2 fills
    m[np.ix_(is_m, is_i)] = 0.3 / is_i.sum()     # L2 -> memory
    m[np.ix_(is_i, is_m)] = 1.0 / is_m.sum()     # memory -> L2
    return _normalize(m)


PATTERNS = {
    "uniform": uniform,
    "permutation": random_permutation,
    "tornado": tornado,
    "neighbor": neighbor,
    "hetero_mix": hetero_mix,
    "coherence_cmi": coherence_cmi,
}


# --------------------------------------------------------------------------
# Synthetic Netrace-like traces (§V-E).  Real PARSEC Netrace files are not
# available offline; these dependency-light traces have the same region
# structure: per-region packet intensity and flow mix between C/M/I
# chiplets, modelled after blackscholes (compute-heavy, low traffic) and
# fluidanimate (memory-heavy bursts).
# --------------------------------------------------------------------------

TRACE_PROFILES = {
    # per-region (intensity multiplier, mem_fraction) pairs; 5 regions each
    "blackscholes": [(0.15, 0.6), (0.35, 0.55), (0.25, 0.5), (0.4, 0.6),
                     (0.2, 0.5)],
    "fluidanimate": [(0.5, 0.7), (0.8, 0.75), (0.65, 0.7), (0.9, 0.8),
                     (0.55, 0.65)],
}


def region_traffic(topo: Topology, mem_frac: float) -> np.ndarray:
    """Traffic matrix of one trace region: coherence flows blended with a
    memory mix of the region's intensity (shared by
    `trace_region_traffic` and `repro_torch.workloads.traces`)."""
    base = coherence_cmi(topo)
    mix = hetero_mix(topo, frac_mem=mem_frac)
    return _normalize(0.5 * base + 0.5 * mix)


def trace_region_traffic(topo: Topology, profile: str, region: int):
    """Return (traffic matrix, relative intensity) for one trace region."""
    intensity, mem_frac = TRACE_PROFILES[profile][region]
    return region_traffic(topo, mem_frac), intensity
