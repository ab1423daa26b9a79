"""Flight-recorder post-processing: telemetry tensors -> tidy link rows.

`SimConfig(telemetry=True)` makes `run_batch` return per-directed-
channel counter arrays (DESIGN.md §13).  This module renders them as
tidy rows — one row per directed channel of the *simulated* structure,
plus one `status="dead"` row per direction of every fault-masked link —
so the load distribution that explains the paper's results (folding
spreads channel load; Mesh/Torus concentrate it) is a first-class,
versioned artifact instead of an aggregate.

Row discipline:

  * sacrificial and padded lanes never appear: `run_batch` slices the
    counter tensors to the spec's own channel/node counts before they
    reach this module;
  * a degraded scenario reports its surviving channels from the
    *degraded* routing (they carry the traffic) and its dead links from
    the fault set — explicitly failed links, plus every base-topology
    link incident to a dead chiplet;
  * `util` is busy cycles / measured cycles in [0, 1]; `occ_mean` is
    the mean number of buffered flits at the channel's downstream input
    port over the measured window;
  * `occ_escape` / `occ_adaptive` split `occ_mean` by VC class
    (DESIGN.md §15): VC 0 is the deadlock-free escape drain, VCs 1..V-1
    are the adaptive class — under `routing="static"` the adaptive
    column still reports the static occupancy of those lanes.

The port's copy of `repro.obs.flight` (numpy only): the same rows, in
the same column order, for the same counters.
"""
from __future__ import annotations

import numpy as np

#: stable tidy-row column order for per-link rows (scenario tags append)
LINK_COLUMNS = (
    "experiment", "topology", "n", "substrate", "traffic", "faults",
    "status", "rate", "channel", "src", "dst", "len_mm", "depth_cycles",
    "busy", "util", "stalls", "occ_mean", "occ_escape", "occ_adaptive",
)


def _base_topology(scenario):
    """The pristine topology a degraded scenario was derived from, or
    None when it cannot be rebuilt (exotic generator callables)."""
    from ..core import topology as T
    t = scenario.topology
    try:
        if isinstance(t, str):
            return T.build(t, scenario.n,
                           substrate=scenario.resolved_substrate,
                           chiplet_area_mm2=scenario.resolved_area,
                           roles_scheme=scenario.roles)
        if isinstance(t, T.Topology):
            return t
        src = t(scenario.n)
        if isinstance(src, T.Topology):
            return src
        name, pos, edges = src
        return T.make_topology(name, pos, edges)
    except Exception:                     # noqa: BLE001 — best effort
        return None


def dead_links(scenario) -> list[tuple[int, int]]:
    """Undirected (u, v) pairs masked out by the scenario's fault set:
    the explicitly failed links plus every base-topology link incident
    to a dead chiplet.  Pristine scenarios have none."""
    if not getattr(scenario, "degraded", False):
        return []
    fs = scenario.faults
    dead = set(fs.links)
    if fs.chiplets:
        base = _base_topology(scenario)
        if base is not None:
            dc = set(fs.chiplets)
            for a, b in np.sort(np.asarray(base.edges, np.int64), axis=1):
                if int(a) in dc or int(b) in dc:
                    dead.add((int(a), int(b)))
    return sorted(dead)


def link_rows(planned, res: dict, meas: int, *, experiment: str = "",
              rate_index: int | None = None) -> list[dict]:
    """Tidy per-link rows for one executed scenario.

    planned: an `experiments.plan.PlannedScenario` (duck-typed:
    needs `.scenario`, `.routing`, `.spec`); res: its engine result
    dict carrying the `simulator.TELEMETRY_KEYS`; meas: measured cycles
    (`cfg.cycles - cfg.warmup`).  rate_index picks the offered-rate row
    (default: the saturation plateau, argmax delivered throughput —
    the same row the tidy scenario metrics report).
    """
    if "link_busy" not in res:
        raise ValueError(
            "result carries no telemetry — run with "
            "SimConfig(telemetry=True) to record the flight data")
    s = planned.scenario
    routing = planned.routing
    k = int(np.argmax(res["throughput"])) if rate_index is None \
        else int(rate_index)
    rate = float(res["rate"][k])
    busy = np.asarray(res["link_busy"][k])          # [c]
    stall = np.asarray(res["link_stall"][k])        # [c]
    occ = np.asarray(res["link_occ_sum"][k])        # [c, V]
    util = busy / float(max(meas, 1))
    occ_mean = occ.sum(axis=1) / float(max(meas, 1))
    occ_esc = occ[:, 0] / float(max(meas, 1))
    occ_ad = occ[:, 1:].sum(axis=1) / float(max(meas, 1))
    depth = planned.spec.ch_depth if planned.spec is not None else None
    tags = dict(s.tags)

    def row(**kw):
        r = dict.fromkeys(LINK_COLUMNS)
        r.update(experiment=experiment, topology=s.topology_name, n=s.n,
                 substrate=s.resolved_substrate, traffic=s.traffic_name,
                 faults=s.fault_name, rate=rate, **kw)
        r.update(tags)
        return r

    rows = [row(status="ok", channel=c,
                src=int(routing.ch_src[c]), dst=int(routing.ch_dst[c]),
                len_mm=round(float(routing.ch_len_mm[c]), 3),
                depth_cycles=int(depth[c]) if depth is not None else None,
                busy=int(busy[c]), util=round(float(util[c]), 6),
                stalls=int(stall[c]),
                occ_mean=round(float(occ_mean[c]), 4),
                occ_escape=round(float(occ_esc[c]), 4),
                occ_adaptive=round(float(occ_ad[c]), 4))
            for c in range(len(busy))]
    for u, v in dead_links(s):
        for a, b in ((u, v), (v, u)):
            rows.append(row(status="dead", channel=-1, src=a, dst=b,
                            busy=0, util=0.0, stalls=0, occ_mean=0.0,
                            occ_escape=0.0, occ_adaptive=0.0))
    return rows


#: stable tidy-row column order for per-(window, link) rows
WINDOW_COLUMNS = (
    "experiment", "topology", "n", "substrate", "traffic", "faults",
    "rate", "window", "t_start", "t_end", "cycles", "channel", "src",
    "dst", "busy", "util", "stalls", "occ_mean", "occ_escape",
    "occ_adaptive",
)


def window_rows(planned, res: dict, *, experiment: str = "",
                rate_index: int | None = None) -> list[dict]:
    """Tidy per-(time-window, link) rows for one executed scenario.

    Same duck-typed inputs as `link_rows`, but the result must carry
    the windowed counters (`SimConfig(telemetry_windows=W)`,
    DESIGN.md §16).  One row per (window, directed channel); `t_start`/
    `t_end` are measured-window cycle offsets (warmup excluded), so a
    drift schedule's hotspot migration reads directly off consecutive
    windows of the same channel.  Utilisation and occupancy normalize
    by each window's own cycle count — windows need not divide the
    measured span evenly.
    """
    if "link_busy_w" not in res:
        raise ValueError(
            "result carries no windowed telemetry — run with "
            "SimConfig(telemetry=True, telemetry_windows=W)")
    s = planned.scenario
    routing = planned.routing
    k = int(np.argmax(res["throughput"])) if rate_index is None \
        else int(rate_index)
    rate = float(res["rate"][k])
    busy = np.asarray(res["link_busy_w"][k])        # [W, c]
    stall = np.asarray(res["link_stall_w"][k])      # [W, c]
    occ = np.asarray(res["link_occ_w"][k])          # [W, c, V]
    wc = np.asarray(res["window_cycles"])           # [W]
    edges = np.concatenate([[0], np.cumsum(wc)])
    tags = dict(s.tags)
    rows = []
    for w in range(len(wc)):
        cyc = float(max(int(wc[w]), 1))
        for c in range(busy.shape[1]):
            r = dict.fromkeys(WINDOW_COLUMNS)
            r.update(experiment=experiment, topology=s.topology_name,
                     n=s.n, substrate=s.resolved_substrate,
                     traffic=s.traffic_name, faults=s.fault_name,
                     rate=rate, window=w, t_start=int(edges[w]),
                     t_end=int(edges[w + 1]), cycles=int(wc[w]),
                     channel=c, src=int(routing.ch_src[c]),
                     dst=int(routing.ch_dst[c]), busy=int(busy[w, c]),
                     util=round(float(busy[w, c]) / cyc, 6),
                     stalls=int(stall[w, c]),
                     occ_mean=round(float(occ[w, c].sum()) / cyc, 4),
                     occ_escape=round(float(occ[w, c, 0]) / cyc, 4),
                     occ_adaptive=round(
                         float(occ[w, c, 1:].sum()) / cyc, 4))
            r.update(tags)
            rows.append(r)
    return rows
