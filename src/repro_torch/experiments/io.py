"""Versioned result writers (DESIGN.md §10): one CSV/JSON code path.

The port's copy of `repro.experiments.io`: the same `SCHEMA_VERSION`
and the same bytes for the same rows.  The `ResultFrame` writers and
`repro_torch.figures` funnel through here, so every artifact shares one
column discipline:

  * a `schema_version` column (first) stamps the row format — bump
    `SCHEMA_VERSION` on any breaking change to how rows are derived;
  * column order is stable: either the caller's explicit `columns`, or
    first-seen order across all rows (so adding a field to later rows
    cannot silently reshuffle a header);
  * missing values are written as empty cells, not `"None"`.

"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

#: bump on any breaking change to result-row derivation or layout
#: v2: fault columns (faults, failed_links, failed_chiplets) joined the
#: stable tidy-row layout (DESIGN.md §12)
#: v3: flight-recorder telemetry (DESIGN.md §13) — tidy rows gain
#: link_util_p95 / link_util_max / link_gini, and per-link heatmap
#: artifacts (obs.flight.LINK_COLUMNS, obs.report.SUMMARY_COLUMNS)
#: share this stamp
#: v4: static-analysis diagnostics (DESIGN.md §14) — tidy rows gain a
#: machine-readable `diag_code` column (DP006/FT001 skips, EX001 failed
#: chunks), synth rows carry rejection codes, and `Report.to_json`
#: diagnostics artifacts share this stamp
#: v5: adaptive routing (DESIGN.md §15) — tidy rows gain a `routing`
#: column (effective mode per scenario), per-link heatmap rows gain
#: `occ_escape` / `occ_adaptive` (escape-vs-adaptive VC-class occupancy)
#: v6: performance observability (DESIGN.md §16) — tidy rows gain
#: pad-waste columns (`pad_fill_state` / `pad_fill_chan` /
#: `pad_fill_phase`), windowed-telemetry time-heatmap artifacts
#: (obs.flight.WINDOW_COLUMNS, obs.report.WINDOW_SUMMARY_COLUMNS) share
#: this stamp, and sweep_speedup.csv splits warm host vs device time.
#: (BENCH_<name>.json files carry their own `bench_schema_version`.)
SCHEMA_VERSION = 6


def stable_columns(rows: Sequence[dict],
                   columns: Sequence[str] | None = None) -> list:
    """schema_version + explicit columns, or first-seen union order."""
    if columns is None:
        seen: dict = {}
        for r in rows:
            for k in r:
                seen.setdefault(k, None)
        columns = list(seen)
    cols = [c for c in columns if c != "schema_version"]
    return ["schema_version"] + cols


def _cell(value) -> str:
    if value is None:
        return ""
    if isinstance(value, (np.floating, np.integer)):
        value = value.item()
    s = str(value)
    if any(c in s for c in ',"\n\r'):      # RFC-4180 quoting
        s = '"' + s.replace('"', '""') + '"'
    return s


def write_csv(path: str, rows: Sequence[dict],
              columns: Sequence[str] | None = None) -> list:
    """Write tidy rows with a stable, versioned header; returns the
    column order used.  Falsy rows (None placeholders) are dropped."""
    rows = [r for r in rows if r]
    if not rows:
        return []
    cols = stable_columns(rows, columns)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for r in rows:
            f.write(",".join(_cell(r.get(c, SCHEMA_VERSION
                                         if c == "schema_version" else
                                         None))
                             for c in cols) + "\n")
    print(f"[io] wrote {path} ({len(rows)} rows, schema v{SCHEMA_VERSION})")
    return cols


def write_json(path: str, rows: Sequence[dict],
               meta: dict | None = None) -> None:
    """Write rows as a versioned JSON document: {schema_version, meta
    fields, rows}.  numpy scalars/arrays are converted to plain JSON."""
    def default(o):
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
        return str(o)

    doc = dict(schema_version=SCHEMA_VERSION, **(meta or {}),
               rows=[r for r in rows if r])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=default)
    print(f"[io] wrote {path} ({len(doc['rows'])} rows, "
          f"schema v{SCHEMA_VERSION})")


def read_json(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema_version") != SCHEMA_VERSION:
        raise ValueError(f"{path}: schema_version "
                         f"{doc.get('schema_version')!r} != "
                         f"{SCHEMA_VERSION} (regenerate the artifact)")
    return doc
