"""The cycle loop's spans (`repro_torch.obs.trace`) on the CPU at N = 16.

`run_batch` records one `sim.cycles` span per chunk of 256 cycles inside
its `sim.dispatch` span, with the chunk's cycles, measured cycles, loop
mode and allocator calls; the executor names each chunk's result rows
(`execute.rows`) and the planner each scenario's traffic and spec
(`plan.traffic`, `plan.spec`).  Tracing changes no counter, and with
tracing off the loop records nothing and reads no clock.
"""
import importlib
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.experiments as X  # noqa: E402
import repro_torch.workloads as W  # noqa: E402
from repro_torch.core import simulator as PS  # noqa: E402
from repro_torch.core import topology as PT, traffic as PTR  # noqa: E402
from repro_torch.core.routing import build_routing  # noqa: E402

TR = importlib.import_module("repro_torch.obs.trace")

RATES = np.array([0.1, 0.4], np.float32)
#: three chunks: all warm-up, part warm-up, a short tail
BASE = dict(cycles=560, warmup=300)
MODES = {
    "static": dict(),
    "workload": dict(),
    "adaptive": dict(routing="adaptive"),
    "recorder": dict(telemetry=True, telemetry_windows=2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops on one CPU thread, as in the other simulator tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracing_restored():
    """Each test starts and ends with tracing off and no spans."""
    TR.disable_tracing()
    TR.clear_trace()
    yield
    TR.disable_tracing()
    TR.clear_trace()


def _batch(mode: str):
    """(specs, rates, cfg, schedules) of one small batch in `mode`."""
    specs, scheds = [], []
    for name in ("mesh", "folded_hexa_torus"):
        r = build_routing(PT.build(name, 16))
        specs.append(PS.make_spec(r, PTR.uniform(r.topo)))
        scheds.append(W.hotspot_drift(r.topo, n_phases=3,
                                      dwell=90).compile())
    cfg = PS.SimConfig(**BASE, **MODES[mode])
    return specs, RATES, cfg, scheds if mode == "workload" else None


def _run(mode: str, traced: bool):
    """(results, spans) of the batch with tracing on or off."""
    specs, rates, cfg, scheds = _batch(mode)
    TR.clear_trace()
    if traced:
        TR.enable_tracing()
    try:
        out = PS.run_batch(specs, rates, cfg, schedules=scheds,
                           device="cpu")
    finally:
        TR.disable_tracing()
    spans = TR.get_spans()
    TR.clear_trace()
    return out, spans, cfg


@pytest.fixture(scope="module", params=list(MODES))
def runs(request):
    mode = request.param
    off, off_spans, cfg = _run(mode, traced=False)
    on, on_spans, _ = _run(mode, traced=True)
    return dict(mode=mode, cfg=cfg, off=off, off_spans=off_spans, on=on,
                on_spans=on_spans)


def _named(spans, name):
    return [sp for sp in spans if sp.name == name]


def _inside(inner, outer) -> bool:
    return outer.ts <= inner.ts and \
        inner.ts + inner.dur <= outer.ts + outer.dur


def test_one_cycles_span_per_chunk(runs):
    cfg = runs["cfg"]
    chunks = _named(runs["on_spans"], "sim.cycles")
    assert len(chunks) == math.ceil(cfg.cycles / PS._BITS_CHUNK) == 3
    chunks.sort(key=lambda sp: sp.args["t0"])
    assert [sp.args["t0"] for sp in chunks] == [0, 256, 512]
    assert sum(sp.args["cycles"] for sp in chunks) == cfg.cycles
    assert [sp.args["measured"] for sp in chunks] == [0, 212, 48]
    assert sum(sp.args["measured"] for sp in chunks) == \
        cfg.cycles - cfg.warmup
    mode = runs["mode"]
    for sp in chunks:
        assert sp.cat == "sim"
        assert sp.args["mode"] == ("workload" if mode == "workload"
                                   else "static")
        assert sp.args["adaptive"] is (mode == "adaptive")
        assert sp.args["recorder"] is (mode == "recorder")


def test_cycles_spans_lie_inside_dispatch(runs):
    (dispatch,) = _named(runs["on_spans"], "sim.dispatch")
    (wait,) = _named(runs["on_spans"], "sim.wait")
    chunks = _named(runs["on_spans"], "sim.cycles")
    assert all(_inside(sp, dispatch) for sp in chunks)
    assert not any(_inside(sp, wait) for sp in chunks)


def test_alloc_calls_sum_to_cycles(runs):
    chunks = _named(runs["on_spans"], "sim.cycles")
    assert sum(sp.args["alloc_calls"] for sp in chunks) == \
        runs["cfg"].cycles


def test_nothing_recorded_with_tracing_off(runs):
    assert runs["off_spans"] == []


def test_tracing_changes_no_counter(runs):
    """Every array of every result (raw, per-phase and recorder counters
    and the values derived from them) is bit for bit the same."""
    for a, b in zip(runs["off"], runs["on"]):
        assert a.keys() == b.keys()
        for k, v in a.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == b[k].dtype, k
                np.testing.assert_array_equal(v, b[k], err_msg=k)
            else:
                assert v == b[k], k
    if runs["mode"] == "workload":
        assert "delivered_ph" in runs["on"][0]
    if runs["mode"] == "recorder":
        assert "link_busy_w" in runs["on"][0]


def test_loop_reads_no_clock_with_tracing_off(monkeypatch):
    """With tracing off the loop opens no span: a clock that raises is
    never called, and with tracing on the spans call it."""
    def no_clock():
        raise AssertionError("the cycle loop read the clock")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    specs, rates, cfg, _ = _batch("static")
    out = PS.run_batch(specs, rates, cfg._replace(cycles=40, warmup=10),
                       device="cpu")
    assert out[0]["delivered"].shape == (2,)
    TR.enable_tracing()
    with pytest.raises(AssertionError, match="read the clock"):
        PS.run_batch(specs, rates, cfg._replace(cycles=40, warmup=10),
                     device="cpu")


def test_executor_and_planner_spans():
    """`execute.rows` follows each chunk's run inside `experiment.execute`;
    `plan.traffic` and `plan.spec` name each scenario inside
    `experiment.plan`."""
    exp = X.Experiment(
        [X.Scenario(name, 16, rates=X.SaturationGrid(2))
         for name in ("mesh", "folded_hexa_torus", "hypercube")],
        cfg=PS.SimConfig(cycles=40, warmup=10), name="trace_test")
    TR.enable_tracing()
    X.run(exp, device="cpu", chunk_size=2)
    TR.disable_tracing()
    spans = TR.get_spans()
    (execute,) = _named(spans, "experiment.execute")
    (plan,) = _named(spans, "experiment.plan")
    chunks = _named(spans, "execute.chunk")
    rows = _named(spans, "execute.rows")
    assert len(rows) == len(chunks) >= 2
    assert all(_inside(r, execute) for r in rows)
    for c in chunks:
        # each chunk's rows follow its run, outside the chunk span
        after = [r for r in rows if r.ts >= c.ts + c.dur]
        assert after and after[0].args["scenarios"] == c.args["scenarios"]
    assert sum(r.args["scenarios"] for r in rows) == 3
    for name in ("plan.traffic", "plan.spec"):
        sps = _named(spans, name)
        assert [(sp.args["topology"], sp.args["n"]) for sp in sps] == \
            [(s.topology_name, 16) for s in exp.scenarios]
        assert all(_inside(sp, plan) for sp in sps)
    assert len(_named(spans, "sim.cycles")) == len(
        _named(spans, "sim.dispatch"))
