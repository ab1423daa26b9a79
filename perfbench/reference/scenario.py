"""The plain reference of one scenario: build it from its definition and
simulate it alone.

From a `perfbench.grid.ScenarioDef` this works out again everything the
program derives: the topology and its up*/down* routing, the traffic
matrix or the phase schedule (fitted to the measured cycles), the
`SimSpec`, the analytic saturation bound and the rate grid.  It then
simulates the one spec, unpadded, with the plain allocator
(`netstep_ref`), and derives the tidy row's values as the experiment
frame does.  Nothing of the program is imported.
"""
from __future__ import annotations

import numpy as np

from ..grid import ScenarioDef, SimSettings, model_sizes, step_kwargs
from . import costmodel as cm
from . import simulator as sim
from . import synthetic, traffic as TR
from . import derivations
from .collective import collective_workload
from .mixed import mixed_tenant_workload
from .routing import build_routing
from .topology import build

#: the result keys both sides must agree on, as integers (counters)
COUNTER_KEYS = ("delivered", "offered_n", "accepted_n", "lat_sum",
                "delivered_ph", "offered_ph", "accepted_ph", "lat_sum_ph",
                "phase_cycles", "link_busy", "link_stall", "link_occ_sum",
                "inj_node", "eject_node", "lat_hist", "link_busy_w",
                "link_stall_w", "link_occ_w", "inj_node_w", "eject_node_w",
                "window_cycles")
#: result keys derived in floating point from the counters
DERIVED_KEYS = ("rate", "throughput", "latency", "offered", "accepted",
                "throughput_ph", "latency_ph", "offered_rate_ph",
                "link_util", "link_util_w")
#: tidy-row values of the experiment frame
ROW_KEYS = ("analytic_saturation", "sim_saturation", "rel_throughput",
            "abs_throughput_gbps", "latency_ns", "avg_hops",
            "chiplet_area_mm2", "phy_area_frac", "power_w", "max_link_mm",
            "radix", "link_util_p95", "link_util_max", "link_gini")


def gini(x) -> float:
    """Gini coefficient of a non-negative load vector (the frame's)."""
    x = np.sort(np.asarray(x, np.float64))
    n = x.size
    tot = x.sum()
    if n == 0 or tot <= 0:
        return 0.0
    ranks = np.arange(1, n + 1)
    return float((2.0 * (ranks * x).sum() - (n + 1) * tot) / (n * tot))


def _schedule(d: ScenarioDef, topo, meas: int):
    """(static matrix | None, fitted schedule | None) of a definition."""
    t = d.traffic
    kind = t["kind"]
    if kind == "pattern":
        return TR.PATTERNS[t["name"]](topo), None
    if kind == "trace_region":
        return TR.trace_region_traffic(topo, t["profile"],
                                       int(t["region"]))[0], None
    if kind == "synthetic":
        fn = {"hotspot_drift": synthetic.hotspot_drift,
              "phase_alternating": synthetic.phase_alternating,
              "bursty_uniform": synthetic.bursty_uniform}[t["name"]]
        sched = fn(topo, **t.get("args", {}))
    elif kind in ("collective", "mixed_tenant"):
        kw = dict(step_kwargs(t["step"]), derivation=derivations.load(
            derivations.name_of(t["step"])))
        if kind == "collective":
            sched = collective_workload(model_sizes(t["model"]), topo, **kw)
        else:
            sched = mixed_tenant_workload(
                model_sizes(t["model"]), topo,
                serve_pattern=t.get("serve_pattern", "uniform"),
                serve_frac=float(t.get("serve_frac", 0.3)), **kw)
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    return None, sched.fit(meas)


def build_scenario(d: ScenarioDef, s: SimSettings) -> dict:
    """Topology, routing, traffic, spec, schedule and rates of `d`."""
    topo = build(d.topology, d.n, substrate=d.substrate,
                 chiplet_area_mm2=d.area, roles_scheme=d.roles)
    routing = build_routing(topo)
    tm, sched = _schedule(d, topo, s.cycles - s.warmup)
    if sched is not None:
        tm = sched.mean_traffic()
    analytic = routing.saturation_rate(tm)
    rates = sim.saturation_rate_grid(
        analytic, s.n_rates, headroom=sim.routing_headroom(d.routing))
    return dict(topo=topo, routing=routing, traffic=tm, schedule=sched,
                analytic=float(analytic), spec=sim.make_spec(routing, tm),
                sched_spec=sched.compile() if sched is not None else None,
                rates=np.asarray(rates, np.float64))


def sim_config(s: SimSettings, seed: int, routing: str,
               inject_dtype: str = "float32") -> sim.SimConfig:
    return sim.SimConfig(n_vcs=s.n_vcs, buf_depth=s.buf_depth,
                         cycles=s.cycles, warmup=s.warmup, seed=seed,
                         telemetry=s.telemetry, routing=routing,
                         telemetry_windows=s.telemetry_windows,
                         inject_dtype=inject_dtype)


def row_values(built: dict, res: dict) -> dict:
    """The tidy row's values of a simulated scenario (the frame's)."""
    k = int(np.argmax(res["throughput"]))
    t_r = float(res["throughput"][k])
    lat = float(res["latency"][k])
    row = dict(sim_saturation=t_r)
    if "link_util" in res:
        util = np.asarray(res["link_util"][k], np.float64)
        if util.size:
            row.update(link_util_p95=round(float(np.percentile(util, 95)),
                                           6),
                       link_util_max=round(float(util.max()), 6),
                       link_gini=round(gini(util), 6))
    tm = built["traffic"]
    _, hops, _ = built["routing"].paths_channel_loads(tm)
    w = tm / max(tm.sum(), 1e-12)
    avg_hops = float((hops * w).sum())
    rep = cm.report(built["topo"], t_r, avg_hops, lat)
    row.update(analytic_saturation=built["analytic"],
               rel_throughput=rep.rel_throughput,
               abs_throughput_gbps=rep.abs_throughput_gbps,
               latency_ns=rep.avg_latency_ns, avg_hops=avg_hops,
               chiplet_area_mm2=rep.area_mm2,
               phy_area_frac=rep.phy_area_fraction, power_w=rep.power_w,
               max_link_mm=rep.max_link_mm, radix=rep.radix)
    return row


def simulate(d: ScenarioDef, s: SimSettings, seed: int, device,
             inject_dtype: str = "float32") -> tuple:
    """(result dict, tidy row values) of scenario `d` simulated alone
    with the simulator seed `seed` on `device`."""
    built = build_scenario(d, s)
    cfg = sim_config(s, seed, d.routing, inject_dtype)
    sched = [built["sched_spec"]] if built["sched_spec"] is not None \
        else None
    res = sim.run_batch([built["spec"]], built["rates"][None, :], cfg,
                        device=device, schedules=sched)[0]
    return res, row_values(built, res)
