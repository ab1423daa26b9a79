"""Link-load reports (DESIGN.md §13): heatmap rows -> distribution stats.

The paper's central argument is about load *distribution* — folding
spreads channel load where Mesh/Torus concentrate it — so the summary
a heatmap CSV needs is exactly the distribution shape: percentiles of
per-channel utilization plus a Gini imbalance index per topology cell.
Gini 0 = perfectly balanced channels, ->1 = all load on few channels;
a flatter (lower-Gini) distribution at equal throughput is the
mechanism behind every FoldedHexaTorus win in results/*.csv.

The port's copy of `repro.obs.report` (numpy only): the same summary
rows and the same CSV bytes.
"""
from __future__ import annotations

import numpy as np

#: identity fields that define one summary cell
GROUP_KEYS = ("experiment", "topology", "n", "substrate", "traffic",
              "faults")

SUMMARY_COLUMNS = GROUP_KEYS + (
    "rate", "n_links", "n_dead", "busy_total", "stall_total",
    "util_mean", "util_p50", "util_p95", "util_max", "gini",
)


def gini(x) -> float:
    """Gini coefficient of a non-negative load vector (0 = balanced)."""
    x = np.sort(np.asarray(x, np.float64))
    n = x.size
    tot = x.sum()
    if n == 0 or tot <= 0:
        return 0.0
    # mean absolute difference via the sorted-rank identity
    ranks = np.arange(1, n + 1)
    return float((2.0 * (ranks * x).sum() - (n + 1) * tot) / (n * tot))


def link_load_summary(rows) -> list[dict]:
    """One distribution-stats row per (topology, n, substrate, traffic,
    faults) cell of tidy per-link rows (`obs.flight.link_rows`).  Dead
    rows count toward `n_dead` only; percentiles and Gini are over the
    surviving channels' utilization."""
    groups: dict[tuple, list[dict]] = {}
    for r in rows:
        groups.setdefault(tuple(r.get(k) for k in GROUP_KEYS),
                          []).append(r)
    out = []
    for key, grp in groups.items():
        ok = [r for r in grp if r["status"] == "ok"]
        util = np.asarray([r["util"] for r in ok], np.float64)
        row = dict(zip(GROUP_KEYS, key))
        row.update(
            rate=ok[0]["rate"] if ok else None,
            n_links=len(ok),
            n_dead=sum(1 for r in grp if r["status"] == "dead"),
            busy_total=int(sum(r["busy"] for r in ok)),
            stall_total=int(sum(r["stalls"] for r in ok)),
            util_mean=round(float(util.mean()), 6) if ok else 0.0,
            util_p50=round(float(np.percentile(util, 50)), 6)
            if ok else 0.0,
            util_p95=round(float(np.percentile(util, 95)), 6)
            if ok else 0.0,
            util_max=round(float(util.max()), 6) if ok else 0.0,
            gini=round(gini(util), 6))
        out.append(row)
    return out


def write_link_reports(heatmap_path: str, summary_path: str,
                       rows) -> list[dict]:
    """Write the per-link heatmap CSV and its distribution summary CSV
    through the versioned writers; returns the summary rows."""
    from ..experiments import io as xio   # deferred: import cycle
    from .flight import LINK_COLUMNS
    extra = [k for r in rows for k in r if k not in LINK_COLUMNS]
    seen: dict = {}
    for k in extra:
        seen.setdefault(k, None)
    xio.write_csv(heatmap_path, rows,
                  columns=list(LINK_COLUMNS) + list(seen))
    summary = link_load_summary(rows)
    xio.write_csv(summary_path, summary, columns=list(SUMMARY_COLUMNS))
    return summary


WINDOW_SUMMARY_COLUMNS = GROUP_KEYS + (
    "rate", "window", "t_start", "t_end", "cycles", "n_links",
    "busy_total", "stall_total", "util_mean", "util_p95", "util_max",
    "gini", "occ_escape_mean", "occ_adaptive_mean",
)


def window_summary(rows) -> list[dict]:
    """One distribution-stats row per (cell, time window) of tidy
    per-(window, link) rows (`obs.flight.window_rows`) — the time-
    resolved version of `link_load_summary`.  Reading `gini` down a
    cell's windows shows imbalance evolving (a `hotspot_drift` schedule
    makes it oscillate as the hotspot moves); `occ_escape_mean` vs
    `occ_adaptive_mean` shows when adaptive VCs absorb the load spike
    (DESIGN.md §16)."""
    groups: dict[tuple, list[dict]] = {}
    for r in rows:
        key = tuple(r.get(k) for k in GROUP_KEYS) + (r["window"],)
        groups.setdefault(key, []).append(r)
    out = []
    for key, grp in sorted(groups.items(),
                           key=lambda kv: tuple(map(str, kv[0]))):
        util = np.asarray([r["util"] for r in grp], np.float64)
        row = dict(zip(GROUP_KEYS, key[:-1]))
        row.update(
            rate=grp[0]["rate"], window=key[-1],
            t_start=grp[0]["t_start"], t_end=grp[0]["t_end"],
            cycles=grp[0]["cycles"], n_links=len(grp),
            busy_total=int(sum(r["busy"] for r in grp)),
            stall_total=int(sum(r["stalls"] for r in grp)),
            util_mean=round(float(util.mean()), 6),
            util_p95=round(float(np.percentile(util, 95)), 6),
            util_max=round(float(util.max()), 6),
            gini=round(gini(util), 6),
            occ_escape_mean=round(float(np.mean(
                [r["occ_escape"] for r in grp])), 4),
            occ_adaptive_mean=round(float(np.mean(
                [r["occ_adaptive"] for r in grp])), 4))
        out.append(row)
    return out


def write_window_reports(heatmap_path: str, summary_path: str,
                         rows) -> list[dict]:
    """Write the per-(window, link) time-heatmap CSV and its per-window
    distribution summary CSV; returns the summary rows."""
    from ..experiments import io as xio   # deferred: import cycle
    from .flight import WINDOW_COLUMNS
    extra = [k for r in rows for k in r if k not in WINDOW_COLUMNS]
    seen: dict = {}
    for k in extra:
        seen.setdefault(k, None)
    xio.write_csv(heatmap_path, rows,
                  columns=list(WINDOW_COLUMNS) + list(seen))
    summary = window_summary(rows)
    xio.write_csv(summary_path, summary,
                  columns=list(WINDOW_SUMMARY_COLUMNS))
    return summary
