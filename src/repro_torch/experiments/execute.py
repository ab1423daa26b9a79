"""Experiment executor (DESIGN.md §10): Plan -> batched runs -> frame.

The port's copy of `repro.experiments.execute`.  `run` and `execute`
take a `device` (None: the CUDA card, raising without one; "cpu" runs
on the CPU), which picks the engine (`engine_for(cfg, device)`).

Runs each plan bucket through the shared `SweepEngine` — static buckets
via `run_specs`, workload buckets via `run_workloads`, analytic buckets
without any simulation — and assembles a `ResultFrame` with one row per
scenario in experiment order.

Scale/robustness knobs:

  * `chunk_size` streams a bucket in chunks of that many scenarios
    instead of one monolithic batch — bounds device memory for huge
    grids and gives `progress` callbacks something to report between
    runs;
  * `on_error="skip"` isolates partial failures: a chunk that raises
    marks only its own scenarios `status="failed"` (with the error
    message in the row), logs an `execute.chunk_failed` metrics event
    with the skip reason (`obs.metrics`), and the rest of the
    experiment completes;
  * engines are shared per (`SimConfig`, device) (`engine_for`), so
    every experiment and deprecation shim in a process shares one
    engine and its stats.

Observability (DESIGN.md §13): execution is span-traced (an
`experiment.execute` span over per-chunk `execute.chunk` spans, which
nest over the engine's `sweep.group` and the simulator's `sim.dispatch`
/ `sim.cycles` / `sim.wait` spans, each followed by an `execute.rows`
span over the chunk's result rows), and the progress callback can opt
into per-chunk timing: a 4-parameter callback `progress(done, total,
key, info)` receives an `info` dict with `elapsed_s`, `compiled` (always
0: the port compiles nothing per shape), `scenarios` and `status`; the
3-parameter `progress(done, total, key)` form works too.
"""
from __future__ import annotations

import inspect
import time
from typing import Callable

import numpy as np

from ..core.simulator import SimConfig
from ..device import resolve_device
from ..obs.metrics import metrics
from ..obs.trace import trace
from ..sweep.engine import SweepEngine

from .frame import ResultFrame, _identity_row, scenario_row
from .plan import Bucket, Plan, plan as make_plan
from .scenario import Experiment

_ENGINES: dict[tuple, SweepEngine] = {}


def engine_for(cfg: SimConfig = SimConfig(), device=None) -> SweepEngine:
    """Process-wide engine per (SimConfig, device); device None is the
    CUDA card, and raises without one (even for the analytic backend,
    which simulates nothing: no entry point moves to the CPU unasked)."""
    resolve_device(device)
    key = (cfg, None if device is None else str(device))
    if key not in _ENGINES:
        _ENGINES[key] = SweepEngine(cfg=cfg, device=device)
    return _ENGINES[key]


def _chunks(items: list, size: int | None):
    if not size or size >= len(items):
        yield items
        return
    for i in range(0, len(items), size):
        yield items[i:i + size]


def _progress_arity(cb) -> int:
    """How many positional args `cb` accepts (legacy callbacks take 3:
    done, total, key; observability-aware ones take 4: ..., info)."""
    try:
        params = [p for p in inspect.signature(cb).parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY,
                                p.POSITIONAL_OR_KEYWORD)]
        var = any(p.kind == p.VAR_POSITIONAL
                  for p in inspect.signature(cb).parameters.values())
        return 4 if var or len(params) >= 4 else 3
    except (TypeError, ValueError):      # builtins / C callables
        return 3


def _run_chunk(engine: SweepEngine, bucket: Bucket, chunk: list,
               single_program: bool = False) -> list:
    """One engine call for `chunk`; returns raw result dicts in order."""
    if bucket.key.kind == "analytic":
        return [None] * len(chunk)
    rates = np.stack([ps.rates for ps in chunk]).astype(np.float32)
    specs = [ps.spec for ps in chunk]
    # per-scenario routing overrides (Scenario.routing, DESIGN.md §15):
    # the bucket key carries the effective mode, so one engine serves
    # both — only the SimConfig handed to run_batch changes
    cfg = engine.cfg if bucket.key.routing == engine.cfg.routing \
        else engine.cfg._replace(routing=bucket.key.routing)
    if bucket.key.kind == "workload":
        return engine.run_workloads(specs, [ps.sched_spec for ps in chunk],
                                    rates, single_program=single_program,
                                    cfg=cfg)
    return engine.run_specs(specs, rates, single_program=single_program,
                            cfg=cfg)


def execute(pl: Plan, engine: SweepEngine | None = None,
            chunk_size: int | None = None,
            progress: Callable[[int, int, object], None] | None = None,
            on_error: str = "raise", device=None) -> ResultFrame:
    """Run a plan and return the `ResultFrame` (scenario order).
    Without an `engine`, runs on `device` (None: the card)."""
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be 'raise' or 'skip', "
                         f"got {on_error!r}")
    exp = pl.experiment
    engine = engine or engine_for(exp.cfg, device)
    n = len(exp.scenarios)
    results: list = [None] * n
    planned: list = [None] * n
    rows: list = [None] * n
    errors: list = []
    for i, reason in pl.skipped:
        rows[i] = _identity_row(exp, exp.scenarios[i], "invalid", reason,
                                diag_code=pl.skip_codes.get(i, ""))
    total, done = pl.n_planned, 0
    arity = _progress_arity(progress) if progress is not None else 0
    with trace("experiment.execute", cat="experiments",
               experiment=exp.name, scenarios=n,
               buckets=len(pl.buckets)):
        for bucket in pl.buckets:
            for chunk in _chunks(bucket.items, chunk_size):
                t0 = time.perf_counter()
                status = "ok"
                with trace("execute.chunk", cat="experiments",
                           kind=bucket.key.kind,
                           scenarios=len(chunk)) as sp:
                    try:
                        out = _run_chunk(engine, bucket, chunk,
                                         single_program=pl.single_program)
                    except Exception as e:   # noqa: BLE001 — isolate chunk
                        if on_error == "raise":
                            raise
                        status = "failed"
                        msg = f"{type(e).__name__}: {e}"
                        sp.set(error=msg)
                        # a skipped chunk is never silent: the skip
                        # reason lands in the metrics event log too
                        metrics.event(
                            "execute.chunk_failed", experiment=exp.name,
                            reason=msg, scenarios=len(chunk),
                            bucket=str(bucket.key),
                            indices=[ps.index for ps in chunk])
                        for ps in chunk:
                            planned[ps.index] = ps
                            errors.append((ps.index, msg))
                            rows[ps.index] = _identity_row(
                                exp, ps.scenario, "failed", msg,
                                diag_code="EX001")
                        out = None
                if out is not None:
                    with trace("execute.rows", cat="experiments",
                               scenarios=len(chunk)):
                        for ps, res in zip(chunk, out):
                            planned[ps.index] = ps
                            results[ps.index] = res
                            rows[ps.index] = scenario_row(exp, ps, res)
                done += len(chunk)
                if progress is not None:
                    if arity >= 4:
                        info = dict(
                            elapsed_s=time.perf_counter() - t0,
                            compiled=0, scenarios=len(chunk),
                            status=status)
                        progress(done, total, bucket.key, info)
                    else:
                        progress(done, total, bucket.key)
    return ResultFrame(experiment=exp, rows=rows, results=results,
                       planned=planned, errors=errors)


def run(experiment: Experiment, engine: SweepEngine | None = None,
        chunk_size: int | None = None,
        progress: Callable[[int, int, object], None] | None = None,
        on_error: str = "raise",
        single_program: bool = False, device=None) -> ResultFrame:
    """The one front door: plan + execute in one call.

        frame = repro_torch.experiments.run(Experiment([...], cfg=...))

    Runs on `device` (None: the CUDA card; "cpu" for the CPU) unless an
    `engine` is given.  See `plan()` to inspect bucketing (and
    `single_program`) first, `execute()` for the streaming/failure
    knobs.
    """
    engine = engine or engine_for(experiment.cfg, device)
    return execute(make_plan(experiment, engine,
                             single_program=single_program),
                   engine=engine, chunk_size=chunk_size,
                   progress=progress, on_error=on_error)
