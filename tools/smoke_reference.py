"""Compute the JAX reference tables of `chip_smoke.py`'s `experiments`
and `collectives` phases.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/smoke_reference.py \
        [experiments|collectives]

`experiments` builds that phase's Experiment
(`chip_smoke.experiment_scenarios`: 15 scenarios at N = 256, organic,
`SaturationGrid(8)`) with the JAX package's classes; `collectives` builds
`chip_smoke.collective_scenarios` (20 scenarios at N = 64: the training
collectives of qwen3-1.7b and qwen3-moe-235b-a22b and a mixed tenant)
and also evaluates `repro.core.collectives.build_ici_model(..., 64,
"organic", use_sim=True)` on chip_smoke's `ICI_TOPOLOGIES`.  Each
Experiment runs through `repro.experiments.run` under
`SimConfig(cycles=2000, warmup=700, alloc="jnp")`.  Prints one JSON
object per table: per scenario, in order, the label, the raw counters
over the rate grid and the tidy row's values at the saturating rate.
`chip_smoke.py` holds the port's runs of the same Experiments on the
card to these tables (its `REFERENCE_EXPERIMENTS` and
`REFERENCE_COLLECTIVES`), bit for bit.  Without an argument, both
tables; the first takes about five minutes on an 8-core CPU, the second
about as long.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402  (stdlib only at import)
import repro.configs as C  # noqa: E402
import repro.experiments as X  # noqa: E402
import repro.faults as F  # noqa: E402
import repro.workloads as W  # noqa: E402
from repro.core import topology as T  # noqa: E402
from repro.core.collectives import build_ici_model  # noqa: E402
from repro.core.simulator import SimConfig  # noqa: E402

RAW = ("delivered", "offered_n", "accepted_n", "lat_sum")


def table(frame, raw=("delivered", "lat_sum"), substrate=False) -> list:
    """The reference entries of a frame, in scenario order."""
    rows = []
    for row, res in zip(frame.rows, frame.results):
        k = int(np.argmax(res["throughput"]))
        parts = [row["topology"]] + ([row["substrate"]] if substrate
                                     else []) + [row["traffic"],
                                                 row["faults"]]
        ent = dict(label="/".join(parts))
        ent.update({key: res[key].tolist() for key in raw})
        ent.update(sim_saturation=row["sim_saturation"],
                   abs_throughput_gbps=row["abs_throughput_gbps"],
                   latency_ns=row["latency_ns"])
        if "delivered_ph" in res:
            ent["delivered_ph"] = res["delivered_ph"][k].tolist()
        rows.append(ent)
    return rows


def run(scenarios, name):
    t0 = time.perf_counter()
    cfg = SimConfig(cycles=chip_smoke.EXP_CYCLES,
                    warmup=chip_smoke.EXP_WARMUP, alloc="jnp")
    frame = X.run(X.Experiment(scenarios, cfg=cfg, name=name,
                               backend="sim"), on_error="raise",
                  progress=lambda done, total, key: print(
                      f"{name} {done}/{total} {key} "
                      f"{time.perf_counter() - t0:.0f}s",
                      file=sys.stderr, flush=True))
    assert all(r["status"] == "ok" for r in frame.rows)
    return frame


def main(argv=None) -> int:
    which = (argv or sys.argv[1:]) or ["experiments", "collectives"]
    if "experiments" in which:
        t0 = time.perf_counter()
        frame = run(chip_smoke.experiment_scenarios(X, W, F, T),
                    "chip_smoke")
        print(json.dumps(dict(table=table(frame),
                              seconds=time.perf_counter() - t0)),
              flush=True)
    if "collectives" in which:
        t0 = time.perf_counter()
        frame = run(chip_smoke.collective_scenarios(X, W, C),
                    "chip_smoke_collectives")
        ici = {}
        for name in chip_smoke.ICI_TOPOLOGIES:
            m = build_ici_model(name, chip_smoke.COLL_N, "organic",
                                use_sim=True)
            ici[name] = dict(b_eff_gbps=m.b_eff_gbps,
                             all_reduce_s=m.collective_time_s(
                                 "all_reduce", chip_smoke.ICI_BYTES))
        print(json.dumps(dict(table=table(frame, RAW, substrate=True),
                              ici=ici, seconds=time.perf_counter() - t0)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
