"""Typed experiment results (DESIGN.md §10): the `ResultFrame`.

One tidy row per scenario — identity fields (topology, n, substrate,
traffic, ...), a status ("ok" / "invalid" / "failed"), the analytic and
simulated saturation, and the paper's §V-B cost-model derivations
(absolute Gb/s through the substrate wires, latency in ns, PHY area,
power) — in the experiment's scenario order, plus the raw per-scenario
engine result dicts for anything a tidy row can't hold (full rate
sweeps, per-phase counters).

The tidy columns are stable and versioned: `to_csv` / `to_json` write
through `repro_torch.experiments.io`, which stamps every artifact with
`schema_version`.  The port's copy of `repro.experiments.frame`: the
same columns and the same values for the same results, the
flight-recorder columns and views included.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import costmodel as cm

from . import io as xio
from .plan import PlannedScenario
from .scenario import Experiment, Scenario

#: stable tidy-row column order (scenario tags append after these)
COLUMNS = (
    "experiment", "backend", "status", "topology", "n", "substrate",
    "roles", "area_mm2", "traffic", "kind", "rates", "routing",
    "faults", "failed_links", "failed_chiplets",
    "analytic_saturation", "sim_saturation", "rel_throughput",
    "abs_throughput_gbps", "latency_ns", "avg_hops", "chiplet_area_mm2",
    "phy_area_frac", "power_w", "max_link_mm", "radix",
    "link_util_p95", "link_util_max", "link_gini",
    "pad_fill_state", "pad_fill_chan", "pad_fill_phase",
    "error", "diag_code",
)


def _identity_row(exp: Experiment, s: Scenario, status: str,
                  error: str = "", diag_code: str = "") -> dict:
    row = dict.fromkeys(COLUMNS)
    fs = s.faults if s.degraded else None
    row.update(experiment=exp.name, backend=exp.backend, status=status,
               topology=s.topology_name, n=s.n,
               substrate=s.resolved_substrate, roles=s.roles,
               area_mm2=s.resolved_area, traffic=s.traffic_name,
               kind=s.kind, rates=s.rates.describe(),
               routing=s.effective_routing(exp.cfg),
               faults=s.fault_name,
               failed_links=fs.n_links if fs else 0,
               failed_chiplets=fs.n_chiplets if fs else 0, error=error,
               diag_code=diag_code)
    row.update(dict(s.tags))
    return row


def scenario_row(exp: Experiment, ps: PlannedScenario,
                 res: dict | None) -> dict:
    """Tidy row for one executed scenario (res=None: analytic backend).

    The scenario's relative saturation (simulated plateau, or the
    analytic channel-load bound) and latency (simulated, or the
    zero-load latency) feed the §V-B cost model at the traffic's
    average hop count; the planner's routing walk gave the hop count
    and the zero-load latency, so the row walks no path itself.
    """
    row = _identity_row(exp, ps.scenario, "ok")
    if res is not None:
        k = int(np.argmax(res["throughput"]))
        t_r = float(res["throughput"][k])
        lat = float(res["latency"][k])
        row["sim_saturation"] = t_r
        if "pad_fill" in res:            # pad-waste accounting (§16)
            pf = res["pad_fill"]
            row.update(pad_fill_state=round(float(pf["state"]), 4),
                       pad_fill_chan=round(float(pf["chan"]), 4),
                       pad_fill_phase=round(float(pf["phase"]), 4))
        if "link_util" in res:           # flight recorder was on
            from ..obs.report import gini
            util = np.asarray(res["link_util"][k], np.float64)
            if util.size:
                row.update(
                    link_util_p95=round(
                        float(np.percentile(util, 95)), 6),
                    link_util_max=round(float(util.max()), 6),
                    link_gini=round(gini(util), 6))
    else:
        t_r = ps.analytic
        lat = ps.zero_load_cycles
    rep = cm.report(ps.topo, t_r, ps.avg_hops, lat)
    row.update(analytic_saturation=ps.analytic,
               rel_throughput=rep.rel_throughput,
               abs_throughput_gbps=rep.abs_throughput_gbps,
               latency_ns=rep.avg_latency_ns, avg_hops=ps.avg_hops,
               chiplet_area_mm2=rep.area_mm2,
               phy_area_frac=rep.phy_area_fraction, power_w=rep.power_w,
               max_link_mm=rep.max_link_mm, radix=rep.radix)
    return row


@dataclasses.dataclass
class ResultFrame:
    """Execution results in experiment order (one slot per scenario)."""
    experiment: Experiment
    rows: list                       # tidy dict per scenario
    results: list                    # raw engine dict | None per scenario
    planned: list                    # PlannedScenario | None per scenario
    errors: list                     # [(scenario index, message)]

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    @property
    def columns(self) -> tuple:
        extra = [k for r in self.rows for k in r if k not in COLUMNS]
        seen: dict = {}
        for k in extra:
            seen.setdefault(k, None)
        return COLUMNS + tuple(seen)

    def ok(self) -> list:
        return [r for r in self.rows if r["status"] == "ok"]

    def select(self, **eq) -> list:
        """Tidy rows matching all field==value constraints."""
        return [r for r in self.rows
                if all(r.get(k) == v for k, v in eq.items())]

    def best(self, metric: str = "abs_throughput_gbps", **eq) -> dict:
        rows = [r for r in (self.select(**eq) if eq else self.rows)
                if r["status"] == "ok" and r.get(metric) is not None]
        if not rows:
            raise ValueError(f"no ok rows match {eq} with {metric!r}")
        return max(rows, key=lambda r: r[metric])

    # ---- legacy-shaped per-scenario views -----------------------------
    def case_result(self, i: int) -> dict | None:
        """Scenario i as the reference's `SweepEngine.evaluate_cases`
        gives a case (None where it did not run)."""
        ps, res = self.planned[i], self.results[i]
        if ps is None or res is None:
            return None
        k = int(np.argmax(res["throughput"]))
        return dict(case=ps.scenario,
                    sim_saturation=float(res["throughput"][k]),
                    analytic_saturation=ps.analytic,
                    latency_at_sat=float(res["latency"][k]), sweep=res)

    def workload_result(self, i: int) -> dict | None:
        """`case_result` with the reference's
        `evaluate_workload_cases` keys for a workload scenario."""
        out = self.case_result(i)
        ps = self.planned[i]
        if out is None or ps.schedule is None:
            return out
        res = self.results[i]
        k = int(np.argmax(res["throughput"]))
        out.update(workload=ps.schedule.name,
                   phase_labels=[p.label or str(j) for j, p in
                                 enumerate(ps.schedule.phases)],
                   throughput_ph=res["throughput_ph"][k],
                   latency_ph=res["latency_ph"][k],
                   offered_rate_ph=res["offered_rate_ph"][k],
                   phase_cycles=res["phase_cycles"])
        return out

    # ---- flight-recorder views (DESIGN.md §13) ------------------------
    def link_rows(self, i: int, rate_index: int | None = None) -> list:
        """Tidy per-link telemetry rows for scenario i (requires the
        experiment to have run with `SimConfig(telemetry=True)`)."""
        from ..obs.flight import link_rows as _rows
        ps, res = self.planned[i], self.results[i]
        if ps is None or res is None:
            return []
        cfg = self.experiment.cfg
        return _rows(ps, res, cfg.cycles - cfg.warmup,
                     experiment=self.experiment.name,
                     rate_index=rate_index)

    def all_link_rows(self, rate_index: int | None = None) -> list:
        """Per-link rows for every ok scenario, in scenario order."""
        out: list = []
        for i in range(len(self.rows)):
            out.extend(self.link_rows(i, rate_index=rate_index))
        return out

    def to_link_csv(self, path: str,
                    rate_index: int | None = None) -> None:
        """Write the per-link heatmap CSV (schema v3) for this frame."""
        from ..obs.flight import LINK_COLUMNS
        rows = self.all_link_rows(rate_index=rate_index)
        extra = [k for r in rows for k in r if k not in LINK_COLUMNS]
        seen: dict = {}
        for k in extra:
            seen.setdefault(k, None)
        xio.write_csv(path, rows, columns=list(LINK_COLUMNS) + list(seen))

    # ---- windowed-telemetry views (DESIGN.md §16) ---------------------
    def window_rows(self, i: int, rate_index: int | None = None) -> list:
        """Tidy per-(time-window, link) rows for scenario i (requires
        `SimConfig(telemetry=True, telemetry_windows=W)`)."""
        from ..obs.flight import window_rows as _rows
        ps, res = self.planned[i], self.results[i]
        if ps is None or res is None:
            return []
        return _rows(ps, res, experiment=self.experiment.name,
                     rate_index=rate_index)

    def all_window_rows(self, rate_index: int | None = None) -> list:
        """Per-(window, link) rows for every ok scenario, in order."""
        out: list = []
        for i in range(len(self.rows)):
            out.extend(self.window_rows(i, rate_index=rate_index))
        return out

    def to_window_csv(self, path: str,
                      rate_index: int | None = None) -> None:
        """Write the time-heatmap CSV (per window x link) for this
        frame — the artifact that shows hotspot drift over time."""
        from ..obs.flight import WINDOW_COLUMNS
        rows = self.all_window_rows(rate_index=rate_index)
        extra = [k for r in rows for k in r if k not in WINDOW_COLUMNS]
        seen: dict = {}
        for k in extra:
            seen.setdefault(k, None)
        xio.write_csv(path, rows,
                      columns=list(WINDOW_COLUMNS) + list(seen))

    # ---- versioned writers --------------------------------------------
    def to_csv(self, path: str, include_failures: bool = False) -> None:
        rows = self.rows if include_failures else self.ok()
        xio.write_csv(path, rows, columns=self.columns)

    def to_json(self, path: str, include_failures: bool = False) -> None:
        rows = self.rows if include_failures else self.ok()
        xio.write_json(path, rows, meta=dict(
            experiment=self.experiment.name,
            backend=self.experiment.backend,
            n_scenarios=len(self.experiment),
            columns=list(self.columns)))
