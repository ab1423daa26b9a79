"""Throughput / latency / area / power cost models (paper §V-B).

Implements the paper's evaluation formulas:

  * absolute per-chiplet throughput
        T_a = T_r * n_data_wires(R) * rate(L_hat)            [bit/s]
    where T_r is the relative (BookSim) saturation throughput in
    flits/node/cycle, n_data_wires divides the post-power post-IO bump
    budget by the radix and subtracts the 12 UCIe non-data wires, and
    rate() is the Fig.-2 curve at the topology's maximum link length,
  * total chiplet area  A = A_c + R * A_p                     (§V-B3)
  * power          P = N * P_c + E_bit * total_link_bits/s    (§V-B4)
    evaluated at saturation throughput: every delivered bit crosses
    avg_hops links.
"""
from __future__ import annotations

import dataclasses

from . import linkmodel as lm
from .topology import Topology


@dataclasses.dataclass
class CostReport:
    name: str
    n: int
    radix: int
    rel_throughput: float          # T_r   [flits/node/cycle]
    abs_throughput_gbps: float     # T_a   [Gbit/s per chiplet]
    avg_latency_ns: float
    area_mm2: float                # per chiplet, incl. PHYs
    phy_area_fraction: float
    power_w: float                 # whole system at saturation
    max_link_mm: float


def data_wires(topo: Topology) -> int:
    return lm.data_wires_per_link(topo.radix, topo.substrate,
                                  topo.chiplet_area_mm2)


def absolute_throughput_gbps(topo: Topology, rel_throughput: float) -> float:
    l_hat = topo.max_link_length_mm()
    wires = data_wires(topo)
    return float(rel_throughput * wires *
                 lm.rate_gbps(l_hat, topo.substrate))


def wire_cost_mm(topo: Topology) -> float:
    """Substrate wiring-resource proxy (Principle 3): total wire length
    routed through the substrate — per-link wires (data plus the 12
    UCIe non-data wires) times centre-to-centre link length, summed
    over all links.  One of the three Pareto objectives the synthesis
    engine (repro.synth) optimizes; unit is wire-mm."""
    wires = data_wires(topo) + lm.NON_DATA_WIRES
    return float(topo.link_lengths_mm().sum() * wires)


def chiplet_area_mm2(topo: Topology) -> float:
    return topo.chiplet_area_mm2 + topo.radix * lm.PHY_AREA_MM2


def phy_area_fraction(topo: Topology) -> float:
    a = chiplet_area_mm2(topo)
    return topo.radix * lm.PHY_AREA_MM2 / a


def system_power_w(topo: Topology, abs_thr_gbps: float,
                   avg_hops: float) -> float:
    """N * P_c + E_bit * (bits/s through all links) at saturation."""
    bits_per_s = abs_thr_gbps * 1e9 * topo.n * avg_hops
    return topo.n * lm.CHIPLET_POWER_W + \
        bits_per_s * lm.ENERGY_PER_BIT_PJ * 1e-12


def report(topo: Topology, rel_throughput: float, avg_hops: float,
           avg_latency_cycles: float) -> CostReport:
    t_a = absolute_throughput_gbps(topo, rel_throughput)
    return CostReport(
        name=topo.name, n=topo.n, radix=topo.radix,
        rel_throughput=rel_throughput,
        abs_throughput_gbps=t_a,
        avg_latency_ns=avg_latency_cycles,  # cycle time = 1 ns (§V-B2)
        area_mm2=chiplet_area_mm2(topo),
        phy_area_fraction=phy_area_fraction(topo),
        power_w=system_power_w(topo, t_a, avg_hops),
        max_link_mm=topo.max_link_length_mm())
