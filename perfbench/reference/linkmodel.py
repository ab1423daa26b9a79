"""Link data-rate and latency models (paper §II-B, Fig. 2, Table IV).

The paper bases the rate(length) relationship on transmission-line
simulations by Kim [21] (Fig. 2).  The exact simulated curve is not
published as data; we reconstruct a piecewise-linear curve through the
anchor points the paper states explicitly:

  * organic substrates: decline begins ~10 mm; range-1 links (which span
    17.5–24.7 mm center-to-center for 74 mm^2 chiplets) run at 89–97 % of
    the max rate; range-2 links (26.3–37.2 mm) drop to 47 % worst case.
  * glass substrates: decline begins ~20 mm; range-1 links run at
    99–100 %; range-2 links drop to 66 % worst case.
  * both: no link may exceed 70 mm (rate -> 0), which is what zeroes the
    throughput of Torus / ClusCross / HoneycombTorus / FlattenedButterfly
    at large N (paper §V-C).
  * passive silicon interposers: rate drops significantly past 4 mm.

All lengths in mm, rates as a fraction of MAX_RATE_GBPS per wire.
"""
from __future__ import annotations

import numpy as np

# Maximum per-wire data rate at zero length.  UCIe on a standard (organic)
# package commonly runs 16 GT/s per wire; the absolute value only scales
# absolute throughput T_a, relative topology comparisons are invariant.
MAX_RATE_GBPS = 16.0

# C4 bumps usable for D2D signalling sit in rows along the chiplet
# perimeter (RapidChiplet's PHY placement model); the full under-die bump
# field is dominated by power/ground and core I/O.  Four signal rows
# calibrates the absolute T_a and the Table-II power-at-saturation deltas
# to the paper's magnitudes (~2 % of chiplet power, not ~20 %).
PERIMETER_SIGNAL_ROWS = 4

# Hard cutoff from the paper: "some links surpass the maximum permissible
# length of 70 mm" -> throughput drops to zero.
MAX_LINK_LENGTH_MM = 70.0

# (length_mm, fraction_of_max_rate) anchors.
_CURVES = {
    "organic": [(0.0, 1.00), (10.0, 1.00), (17.5, 0.97), (24.7, 0.89),
                (31.0, 0.68), (37.2, 0.47), (50.0, 0.25), (70.0, 0.08)],
    "glass":   [(0.0, 1.00), (20.0, 1.00), (24.7, 0.99), (31.0, 0.83),
                (37.2, 0.66), (50.0, 0.38), (70.0, 0.12)],
    "passive_interposer": [(0.0, 1.00), (4.0, 1.00), (6.0, 0.60),
                           (8.0, 0.30), (10.0, 0.12), (12.0, 0.02),
                           (15.0, 0.0)],
}

# Table IV parameters, keyed by substrate.
SUBSTRATE_PARAMS = {
    "organic": dict(chiplet_spacing_mm=0.150, bump_pitch_um=50.0,
                    dielectric_constant=3.1),
    "glass":   dict(chiplet_spacing_mm=0.100, bump_pitch_um=35.0,
                    dielectric_constant=3.3),
}

# Shared Table IV parameters.
CHIPLET_AREA_MM2 = 74.0          # A_c   [26]
PHY_AREA_MM2 = 0.88              # A_p   [27]
CHIPLET_POWER_W = 25.0           # P_c   assumption
ENERGY_PER_BIT_PJ = 0.3          # E_bit [2]
PHY_LATENCY_NS = 2.0             # L_p   [27]
ROUTER_LATENCY_NS = 3.0          # L_r   assumption
FRAC_BUMPS_POWER = 0.50          # f_pb  [5]
FRAC_BUMPS_IO = 0.20             # f_io  assumption
CORES_PER_CHIPLET = 8            # N_c   [26]
NON_DATA_WIRES = 12              # N_w   [27]
SPEED_OF_LIGHT_MM_PER_NS = 299.792458  # c


def rate_fraction(length_mm, substrate: str):
    """Fraction of MAX_RATE_GBPS achievable at a given link length (Fig. 2).

    Vectorized over `length_mm`.  Returns 0 beyond MAX_LINK_LENGTH_MM
    (70 mm) for substrates, and beyond the curve end for interposers.
    """
    curve = _CURVES[substrate]
    xs = np.array([p[0] for p in curve])
    ys = np.array([p[1] for p in curve])
    length = np.asarray(length_mm, dtype=np.float64)
    frac = np.interp(length, xs, ys, left=1.0, right=0.0)
    if substrate != "passive_interposer":
        frac = np.where(length > MAX_LINK_LENGTH_MM, 0.0, frac)
    return frac


def rate_gbps(length_mm, substrate: str):
    """Absolute per-wire data rate in Gbit/s for a link of given length."""
    return MAX_RATE_GBPS * rate_fraction(length_mm, substrate)


def wire_latency_ns(length_mm, substrate: str):
    """Transmission-line propagation latency: L * sqrt(eps_r) / c (§V-B2)."""
    eps_r = SUBSTRATE_PARAMS[substrate]["dielectric_constant"]
    return np.asarray(length_mm) * np.sqrt(eps_r) / SPEED_OF_LIGHT_MM_PER_NS


def hop_latency_cycles(length_mm, substrate: str, cycle_ns: float = 1.0):
    """Cycles consumed by one chiplet-to-chiplet hop (§V-B2).

    router (L_r) + tx PHY (L_p) + wire + rx PHY (L_p); the wire latency is
    rounded up to a full cycle as in the paper.
    """
    wire = np.ceil(wire_latency_ns(np.asarray(length_mm), substrate)
                   / cycle_ns)
    cycles = (wire + (ROUTER_LATENCY_NS + 2.0 * PHY_LATENCY_NS) / cycle_ns
              ).astype(np.int64)
    return int(cycles) if np.ndim(length_mm) == 0 else cycles


def bumps_per_chiplet(chiplet_area_mm2: float, substrate: str) -> int:
    """Full-area C4 bump array under the chiplet at the substrate pitch."""
    side_mm = np.sqrt(chiplet_area_mm2)
    pitch_mm = SUBSTRATE_PARAMS[substrate]["bump_pitch_um"] / 1000.0
    per_side = int(np.floor(side_mm / pitch_mm))
    return per_side * per_side


def data_wires_per_link(radix: int, substrate: str,
                        chiplet_area_mm2: float = CHIPLET_AREA_MM2) -> int:
    """Data wires available to one D2D link (§III-C).

    PHY bumps live in PERIMETER_SIGNAL_ROWS rows along the chiplet edge;
    50 % of the budget goes to power, 20 % to off-chip I/O; the rest is
    split across the R links, and each link pays N_w = 12 non-data wires
    (UCIe).  This is the mechanism behind Principle 3: per-link bandwidth
    shrinks as the radix grows.
    """
    side_mm = np.sqrt(chiplet_area_mm2)
    pitch_mm = SUBSTRATE_PARAMS[substrate]["bump_pitch_um"] / 1000.0
    per_row = int(np.floor(side_mm / pitch_mm))
    budget = PERIMETER_SIGNAL_ROWS * 4 * per_row \
        * (1.0 - FRAC_BUMPS_POWER - FRAC_BUMPS_IO)
    per_link = int(np.floor(budget / max(radix, 1))) - NON_DATA_WIRES
    return max(per_link, 0)
