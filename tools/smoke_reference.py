"""Compute the JAX reference table of `chip_smoke.py`'s `experiments`
phase.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/smoke_reference.py

Builds the phase's Experiment (`chip_smoke.experiment_scenarios`: 15
scenarios at N = 256, organic, `SaturationGrid(8)`) with the JAX
package's classes, runs it through `repro.experiments.run` under
`SimConfig(cycles=2000, warmup=700, alloc="jnp")`, and prints one JSON
object: per scenario, in order, the label, the raw counters over the
rate grid and the tidy row's values at the saturating rate.
`chip_smoke.py` holds the port's run of the same Experiment on the card
to this table (its `REFERENCE_EXPERIMENTS`), bit for bit.  Takes about
five minutes on an 8-core CPU.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402  (stdlib only at import)
import repro.experiments as X  # noqa: E402
import repro.faults as F  # noqa: E402
import repro.workloads as W  # noqa: E402
from repro.core import topology as T  # noqa: E402
from repro.core.simulator import SimConfig  # noqa: E402


def table(frame) -> list:
    """The reference entries of a frame, in scenario order."""
    rows = []
    for row, res in zip(frame.rows, frame.results):
        k = int(np.argmax(res["throughput"]))
        ent = dict(label=f"{row['topology']}/{row['traffic']}/"
                         f"{row['faults']}",
                   delivered=res["delivered"].tolist(),
                   lat_sum=res["lat_sum"].tolist(),
                   sim_saturation=row["sim_saturation"],
                   abs_throughput_gbps=row["abs_throughput_gbps"],
                   latency_ns=row["latency_ns"])
        if "delivered_ph" in res:
            ent["delivered_ph"] = res["delivered_ph"][k].tolist()
        rows.append(ent)
    return rows


def main() -> int:
    t0 = time.perf_counter()
    cfg = SimConfig(cycles=chip_smoke.EXP_CYCLES,
                    warmup=chip_smoke.EXP_WARMUP, alloc="jnp")
    exp = X.Experiment(chip_smoke.experiment_scenarios(X, W, F, T),
                       cfg=cfg, name="chip_smoke", backend="sim")
    frame = X.run(exp, on_error="raise",
                  progress=lambda done, total, key: print(
                      f"{done}/{total} {key} "
                      f"{time.perf_counter() - t0:.0f}s",
                      file=sys.stderr, flush=True))
    assert all(r["status"] == "ok" for r in frame.rows)
    print(json.dumps(dict(table=table(frame),
                          seconds=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
