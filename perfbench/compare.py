"""The comparison that decides `correct`: the program's answers against
the plain reference's, entry by entry.

Counters are integers and the injection randomness is a bit-exact
hash, so every counter must be equal, and the values derived from them
in floating point (rates, throughput, latency, link utilisation and the
tidy row's cost-model values) must be equal bit for bit too.  Each
number compared counts the entries that differ; its limit is 0.
"""
from __future__ import annotations

import numpy as np

from .reference.scenario import COUNTER_KEYS, DERIVED_KEYS, ROW_KEYS

#: the numbers compared and their limits (an exact comparison: 0)
LIMITS = {"counters_differing": 0, "values_differing": 0,
          "scenarios_failed": 0}


def _differing(got, want) -> int:
    """Entries of `got` that differ from `want` (all of them when the
    shapes differ or `got` is missing)."""
    want = np.asarray(want)
    if got is None:
        return int(want.size) or 1
    got = np.asarray(got)
    if got.shape != want.shape:
        return int(max(got.size, want.size, 1))
    if want.dtype.kind == "f" or got.dtype.kind == "f":
        eq = (got == want) | (np.isnan(got.astype(np.float64))
                              & np.isnan(want.astype(np.float64)))
        return int((~eq).sum())
    return int((got != want).sum())


def compare(got: dict, got_row: dict, want: dict, want_row: dict) -> dict:
    """{"counters_differing": c, "values_differing": v} for one
    scenario: `got` / `got_row` the program's result dict and tidy row,
    `want` / `want_row` the reference's."""
    counters = sum(_differing(got.get(k), want[k])
                   for k in COUNTER_KEYS if k in want)
    counters += sum(int(np.asarray(got[k]).size)
                    for k in COUNTER_KEYS if k in got and k not in want)
    values = sum(_differing(got.get(k), want[k])
                 for k in DERIVED_KEYS if k in want)
    values += sum(_differing(got_row.get(k), want_row[k])
                  for k in ROW_KEYS if k in want_row)
    return {"counters_differing": counters, "values_differing": values}


def total(readings) -> dict:
    """Sum per-scenario readings into one reading per number."""
    out = {k: 0 for k in ("counters_differing", "values_differing")}
    for r in readings:
        for k in out:
            out[k] += r[k]
    return out
