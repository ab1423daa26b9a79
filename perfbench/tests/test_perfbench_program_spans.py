"""The readers of the program's cycle-loop spans: their arithmetic on
hand-made span lists, nothing where the program records no `sim.cycles`
span, and one traced run of a tiny cell on the CPU that reports both."""
from __future__ import annotations

import pytest

from perfbench_tiny import REPO, cells, run_cell, tiny_root

from perfbench.run import load_reader

NAMES = ("loop.host_us_per_cycle", "group.outside_loop_pct")


def _span(name, dur, **args):
    from repro_torch.obs.trace import Span
    return Span(name=name, cat="sim", ts=0, dur=dur, args=args)


def _read(name, spans):
    return load_reader(REPO, name).read({"spans": spans})


def _window():
    """Two groups: 300 cycles in 2 chunks, then 256 in 1."""
    return [
        _span("sweep.group", 9_000_000, s_live=1, s_pad=2, r_live=3,
              r_pad=4),
        _span("sim.cycles", 512_000_000, cycles=256, alloc_calls=256,
              alloc_ns=7_680_000),
        _span("sim.cycles", 88_000_000, cycles=44, alloc_calls=44,
              alloc_ns=1_320_000),
        _span("experiment.execute", 650_000_000),
        _span("sim.cycles", 500_000_000, cycles=256, alloc_calls=256,
              alloc_ns=10_240_000),
        _span("experiment.execute", 550_000_000),
    ]


def test_host_us_per_cycle_is_loop_time_over_cycles():
    assert _read("loop.host_us_per_cycle", _window()) == \
        pytest.approx(1_100_000 / 556)


def test_outside_loop_pct_is_executor_time_outside_the_loop():
    assert _read("group.outside_loop_pct", _window()) == \
        pytest.approx(100 * (1 - 1_100 / 1_200))


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_cycles_spans(name):
    """A program without the loop's spans (or a window with no spans)
    gives no reading, and the reader raises nothing."""
    old = [sp for sp in _window() if sp.name != "sim.cycles"]
    assert _read(name, old) is None
    assert _read(name, []) is None


def test_calls_without_phase_times_give_nothing():
    """Chunks recorded with the loop's clock off still give the host's
    time per cycle."""
    spans = [_span("sim.cycles", 5_000, cycles=10)]
    assert _read("loop.host_us_per_cycle", spans) == pytest.approx(0.5)


def test_traced_tiny_run_reports_the_loop_metrics(capsys, tmp_path,
                                                  monkeypatch):
    """A traced run on the CPU reports both metrics, and the loop's
    time it reads lies within the window's executor time."""
    from perfbench.drivers import sim
    recs = []
    run = sim.run

    def keep(**kw):
        recs.append(run(**kw))
        return recs[-1]

    monkeypatch.setattr(sim, "run", keep)
    root = tiny_root(tmp_path)
    rc, line, err = run_cell(capsys, root, cells()[0], trace=1, seed=23)
    assert rc == 0, err
    assert line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NAMES) <= set(got)
    spans = recs[0]["spans"]
    cycles = sum(sp.args["cycles"] for sp in spans
                 if sp.name == "sim.cycles")
    execute_us = sum(sp.dur for sp in spans
                     if sp.name == "experiment.execute") / 1e3
    assert cycles > 0
    assert got["loop.host_us_per_cycle"] * cycles <= execute_us
    assert 0 < got["group.outside_loop_pct"] < 100
    assert line["metrics"]["loop.host_us_per_cycle"]["unit"] == "us"
