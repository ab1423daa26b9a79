"""Driver of the simulator cells: a scenario grid through the port's
experiment API (`repro_torch.experiments`), as `python -m
repro_torch.figures --sim` runs one.

Set-up: import the port, plan the grid once (`experiments.plan`:
topologies, routing tables, specs, schedules, rate grids), then warm
each planned group's shape for a few cycles through the same path (the
first run in a checkout builds the `netstep` kernel there).

Window: the planned groups, in plan order and wrapping around, each
through `experiments.execute` with the next simulator seed drawn from
`--seed`; it ends at the first whole pass over the planned groups that
closes after `--seconds`, so every run's window holds the same mix of
group shapes.  Every group ends with its counters read back to the host.

Traced run (`--trace 1`): the program's spans are on in the window.
After it each group shape runs twice more under `torch.profiler`, for
PROFILE_SHORT and PROFILE_LONG measured cycles, so that their
difference counts the launches of steady cycles; then the window's
first group runs once more, whole and with its own seed, under the
profiler, for the device's busy and idle time over a group as the
window runs it.

Check: once the window has closed and the peak memory is read, a sample
of the window's scenarios, drawn from `--seed`, is worked out again by
the plain reference (`perfbench.reference`) and compared entry by entry
(`perfbench.compare`).
"""
from __future__ import annotations

import gc
import os
import re
import resource
import sys
import time
from functools import partial

import numpy as np

from .. import compare as C
from .. import grid as G
from .. import profiling as P
from .. import roofline as RL

#: cycles of the warm-up run of each group shape (4 of them warm-up)
WARM_CYCLES, WARM_WARMUP = 16, 4
#: the profiled passes: warm-up cycles, then short / long measured ones
PROFILE_WARMUP, PROFILE_SHORT, PROFILE_LONG = 10, 10, 60
#: characters of a device op's name kept in the breakdown
OP_NAME_CHARS = 96
#: scenarios the reference checks per run
CHECK_SCENARIOS = 2


def host_load() -> tuple:
    """(1-minute load average, the issuing thread's involuntary context
    switches so far): other work on the host shows in both."""
    return (os.getloadavg()[0],
            resource.getrusage(resource.RUSAGE_THREAD).ru_nivcsw)


def group_seed(seed: int, i: int) -> int:
    """The simulator seed of the window's group i, drawn from --seed."""
    ss = np.random.SeedSequence([seed % 2 ** 64, i])
    return int(ss.generate_state(1, np.uint32)[0])


def _region_matrix(topo, profile, region):
    from repro_torch.core import traffic as TR
    return TR.trace_region_traffic(topo, profile, region)[0]


def program_traffic(d: G.ScenarioDef):
    """The program's traffic object for a definition."""
    import repro_torch.experiments as X
    import repro_torch.workloads as W
    t = d.traffic
    kind = t["kind"]
    if kind == "pattern":
        return t["name"]
    if kind == "trace_region":
        return X.CustomTraffic(f"{t['profile']}:r{t['region']}",
                               partial(_region_matrix, profile=t["profile"],
                                       region=int(t["region"])))
    if kind == "synthetic":
        return W.Workload(t["name"], partial(getattr(W, t["name"]),
                                             **t.get("args", {})))
    model = G.model_sizes(t["model"])
    kw = G.step_kwargs(t["step"])
    if kind == "collective":
        return W.collective_workloads([model], **kw)[0]
    return W.mixed_tenant(model, t.get("serve_pattern", "uniform"),
                          float(t.get("serve_frac", 0.3)), **kw)


def sim_config(s: G.SimSettings, seed: int = 0):
    from repro_torch.core.simulator import SimConfig
    return SimConfig(n_vcs=s.n_vcs, buf_depth=s.buf_depth, cycles=s.cycles,
                     warmup=s.warmup, seed=seed, telemetry=s.telemetry,
                     routing=s.routing,
                     telemetry_windows=s.telemetry_windows)


def experiment(defs: list, s: G.SimSettings, name: str):
    import repro_torch.experiments as X
    scen = [X.Scenario(d.topology, d.n, d.substrate, program_traffic(d),
                       area=d.area, roles=d.roles,
                       rates=X.SaturationGrid(s.n_rates))
            for d in defs]
    return X.Experiment(scen, cfg=sim_config(s), name=name)


def run_group(pl, bucket, cfg, device):
    """One planned group through the executor, with its own SimConfig."""
    import repro_torch.experiments as X
    one = X.Plan(experiment=pl.experiment, buckets=[bucket], skipped=[],
                 single_program=pl.single_program)
    return X.execute(one, engine=X.engine_for(cfg, device),
                     on_error="skip")


def _sync(torch, device):
    if device is None or str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _tracer():
    """The port's span collector (`repro_torch.obs.trace`)."""
    import importlib
    return importlib.import_module("repro_torch.obs.trace")


def _spans():
    return _tracer().get_spans()


_SHAPE = re.compile(r"n=(\d+), p=(\d+), c=(\d+), d=(\d+)")


def _group_shapes(spans, n_vcs: int) -> list:
    """[B, N, PI, V] of the allocation in each `sweep.group` span."""
    out = []
    for sp in spans:
        if sp.name != "sweep.group":
            continue
        n, p, _, _ = map(int, _SHAPE.search(sp.args["shape"]).groups())
        rows = int(sp.args["s_pad"]) * int(sp.args["r_pad"])
        out.append((rows, n, p + 1, n_vcs))
    return out


def _launched() -> int:
    """The program's own count of `netstep` launches, which tells a
    session that dropped device events (0 without that counter)."""
    try:
        from repro_torch.kernels.netstep.ops import netstep
    except ImportError:
        return 0
    return getattr(netstep, "launches", 0)


def profile_groups(torch, pl, cfg, device, seed: int) -> dict:
    """The traced stretch: every group shape for PROFILE_SHORT and then
    PROFILE_LONG measured cycles under the profiler; then the window's
    first group, whole, with its seed."""
    TR = _tracer()

    def passes(measured):
        c = cfg._replace(cycles=PROFILE_WARMUP + measured,
                         warmup=PROFILE_WARMUP)
        for b in pl.buckets:
            with TR.trace("bench.profile", cat="bench", cycles=c.cycles):
                run_group(pl, b, c, device)
        _sync(torch, device)

    def whole_group():
        run_group(pl, pl.buckets[0], cfg._replace(seed=group_seed(seed, 0)),
                  device)
        _sync(torch, device)

    short = P.session(torch, lambda: passes(PROFILE_SHORT),
                      kernel="netstep", launched=_launched)
    TR.clear_trace()
    long = P.session(torch, lambda: passes(PROFILE_LONG),
                     kernel="netstep", launched=_launched)
    spans = _spans()
    TR.clear_trace()
    group = P.session(torch, whole_group, kernel="netstep",
                      launched=_launched)
    return dict(short=short, long=long, spans=spans,
                shapes=_group_shapes(spans, cfg.n_vcs),
                measured_diff=PROFILE_LONG - PROFILE_SHORT,
                groups=len(pl.buckets), group=group, group_spans=_spans())


def _profile_summary(prof: dict) -> dict:
    """What the per-layer readers take from the profiled stretch."""
    short, long, group = prof["short"], prof["long"], prof["group"]
    if long is None or group is None:
        return {}
    out = dict(busy_s=group["busy_s"], wall_s=group["wall_s"],
               rows_busy_s=group["rows_busy_s"],
               intervals=len(group["intervals_ns"]), marks=group["marks"],
               group_launches=group["launches"])
    if short is not None:
        # the long pass less the short one: steady measured cycles only,
        # without each group's fixed work (stacking, uploads, rows)
        cycles = prof["groups"] * prof["measured_diff"]
        out["launches_per_cycle"] = (long["launches"]
                                     - short["launches"]) / cycles
    ns = [(t, c) for k, t, c in long["rows"] if "netstep" in k]
    if ns and prof["shapes"]:
        bound_ms = sum(RL.netstep_bound(sh, RL.netstep_bytes(sh))[0]
                       for sh in prof["shapes"]) / len(prof["shapes"])
        dev_s = sum(t for t, _ in ns)
        launches = sum(c for _, c in ns)
        out.update(netstep_bound_ms=bound_ms,
                   netstep_device_ms=1e3 * dev_s / launches)
    spans = [(sp.name, sp.ts, sp.dur) for sp in prof["group_spans"]]
    out["breakdown"] = dict(
        device_ops=sorted(([k[:OP_NAME_CHARS], t]
                           for k, t, _ in group["rows"]),
                          key=lambda kv: -kv[1])[:10],
        idle_gaps=P.idle_gaps(group, spans))
    return out


def check(window: list, defs: list, s: G.SimSettings, seed: int,
          n_check: int, device) -> tuple:
    """Compare a seeded sample of the window's scenarios with the plain
    reference; returns (summed readings, the sample's labels)."""
    from ..reference import scenario as REF
    pairs = [(g, ps) for g in window for ps in g["items"]]
    rng = np.random.default_rng([seed % 2 ** 64, 1])
    pick = rng.choice(len(pairs), size=min(n_check, len(pairs)),
                      replace=False)
    readings, labels = [], []
    for k in sorted(int(i) for i in pick):
        g, (idx, res, row) = pairs[k]
        d = defs[idx]
        want, want_row = REF.simulate(d, s, g["seed"], device or "cuda")
        # a scenario whose chunk failed has no result: all of it differs
        readings.append(C.compare(res or {}, row or {}, want, want_row))
        labels.append(f"{d.label}@group{g['i']}")
    return C.total(readings), labels


def run(*, cell: dict, config: dict, mix: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float) -> dict:
    import torch
    import repro_torch.experiments as X
    TR = _tracer()

    s = G.settings(config, mix)
    defs = G.scenario_defs(config, mix)
    exp = experiment(defs, s, cell["name"])
    cfg = exp.cfg
    t0 = time.perf_counter()
    pl = X.plan(exp, X.engine_for(cfg, device),
                single_program=s.single_program)
    plan_s = time.perf_counter() - t0
    if pl.skipped:
        raise RuntimeError(f"the plan skipped scenarios: {pl.skipped}")
    warm = cfg._replace(cycles=WARM_CYCLES, warmup=WARM_WARMUP)
    for b in pl.buckets:
        run_group(pl, b, warm, device)
    _sync(torch, device)
    # set-up's objects out of the collector's way: a collection in the
    # window scans only what the window makes
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    if trace:
        TR.clear_trace()
        TR.enable_tracing()
    load0, csw0 = host_load()
    window, i = [], 0
    w0 = time.perf_counter()
    while True:
        b = pl.buckets[i % len(pl.buckets)]
        gs = group_seed(seed, i)
        g0 = time.perf_counter()
        frame = run_group(pl, b, cfg._replace(seed=gs), device)
        g1 = time.perf_counter()
        window.append(dict(
            i=i, bucket=i % len(pl.buckets), seed=gs, seconds=g1 - g0,
            items=[(ps.index, frame.results[ps.index],
                    frame.rows[ps.index]) for ps in b.items],
            failed=sum(frame.rows[ps.index]["status"] != "ok"
                       for ps in b.items),
            dims=[(ps.spec.n, ps.spec.p, ps.spec.c, ps.spec.d)
                  for ps in b.items]))
        i += 1
        if i % len(pl.buckets) == 0 and g1 - w0 >= seconds:
            break
    _sync(torch, device)
    window_s = time.perf_counter() - w0
    load1, csw1 = host_load()
    window_spans = _spans() if trace else []
    on_card = device is None or str(device).startswith("cuda")
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    prof, p0 = {}, time.perf_counter()
    if trace:
        TR.clear_trace()
        if on_card:         # the profiler's device time exists only there
            prof = _profile_summary(profile_groups(torch, pl, cfg, device,
                                                   seed))
        TR.disable_tracing()
        TR.clear_trace()
    prof_s = time.perf_counter() - p0

    del frame
    if on_card:
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    reading, labels = check(window, defs, s, seed, CHECK_SCENARIOS, device)
    check_s = time.perf_counter() - c0
    attempted = sum(len(g["items"]) for g in window)
    failed = sum(g["failed"] for g in window)
    print(f"perfbench: {len(window)} groups in {window_s:.3f} s "
          f"({', '.join('%.3f' % g['seconds'] for g in window)}); "
          f"checked {', '.join(labels)} in {check_s:.1f} s",
          file=sys.stderr)
    print(f"perfbench: host load average {load0:.2f} -> {load1:.2f}, "
          f"{csw1 - csw0} involuntary switches of the issuing thread in "
          f"the window, {os.cpu_count()} cpus", file=sys.stderr)

    if prof:
        print(f"perfbench: profiled group {prof['wall_s']:.3f} s, busy "
              f"{prof['busy_s']:.3f} s (rows {prof['rows_busy_s']:.3f} s), "
              f"{prof['group_launches']} launches, {prof['intervals']} "
              f"device intervals, {prof['marks']} clock marks; profiling "
              f"took {prof_s:.1f} s", file=sys.stderr)
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name() if on_card else "cpu",
               count=1, memory_peak_bytes=int(peak))
    if trace and prof:
        dev.update(busy_s=prof["busy_s"], window_s=prof["wall_s"])
    checks = {k: {"value": v, "limit": C.LIMITS[k]}
              for k, v in reading.items()}
    checks["scenarios_failed"] = {"value": failed,
                                  "limit": C.LIMITS["scenarios_failed"]}
    return dict(
        setup_s=setup_s, plan_s=plan_s, window_s=window_s,
        window=[{k: v for k, v in g.items() if k != "items"}
                for g in window],
        n_rates=s.n_rates, cycles=s.cycles, n_vcs=s.n_vcs,
        buf_depth=s.buf_depth, spans=window_spans, profile=prof,
        breakdown=prof.get("breakdown"),
        attempted=attempted, failed=failed, device=dev, checks=checks)
