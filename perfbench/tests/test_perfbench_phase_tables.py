"""The reader of a workload group's phase-table spans: its arithmetic on
hand-made span lists, nothing where the program records no
`sim.phase_tables` span, and traced tiny runs of the workload cells on
the CPU that report it."""
from __future__ import annotations

import pytest

from perfbench_tiny import REPO, bench, run_cell, tiny_root

from perfbench.run import load_reader

NAME = "group.phase_tables_pct"


def _span(name, dur, **args):
    from repro_torch.obs.trace import Span
    return Span(name=name, cat="sim", ts=0, dur=dur, args=args)


def _read(spans):
    return load_reader(REPO, NAME).read({"spans": spans})


def _window():
    """Two workload groups: each stacks its schedules and uploads its
    tables once."""
    return [
        _span("sim.phase_tables", 3_000_000, k=8, k_pad=8, n_pad=256,
              bytes=8_650_752),
        _span("sim.phase_tables", 5_000_000, k=8, k_pad=8, n_pad=256,
              bytes=10_000_000),
        _span("sim.cycles", 40_000_000, cycles=256),
        _span("experiment.execute", 60_000_000),
        _span("sim.phase_tables", 2_000_000, k=5, k_pad=8, n_pad=256,
              bytes=8_650_752),
        _span("experiment.execute", 40_000_000),
    ]


def test_share_is_phase_table_time_over_executor_time():
    assert _read(_window()) == pytest.approx(100 * 10 / 100)


@pytest.mark.parametrize("drop", ["sim.phase_tables",
                                  "experiment.execute"])
def test_nothing_without_the_spans(drop):
    """A static cell, or a program without the span, gives no reading,
    and the reader raises nothing."""
    assert _read([sp for sp in _window() if sp.name != drop]) is None
    assert _read([]) is None


def _listed() -> list:
    m = {m["name"]: m for m in bench()["per_layer"]}[NAME]
    return m["workloads"]


def test_listed_on_the_workload_cells_alone():
    cells = {w["name"]: w for w in bench()["workloads"]}
    assert _listed() == ["collectives-n64-organic.moe-train-step",
                         "deepseek-v3-n256-organic.moe-train-step"]
    for name in _listed():
        assert cells[name]["traffic"] == "moe-train-step"


@pytest.mark.parametrize("cell", _listed())
def test_traced_tiny_run_reports_the_share(capsys, tmp_path, monkeypatch,
                                           cell):
    """A traced run of a workload cell on the CPU reports the share, in
    (0, 100], and its spans carry their attributes."""
    from perfbench.drivers import sim
    recs = []
    run = sim.run

    def keep(**kw):
        recs.append(run(**kw))
        return recs[-1]

    monkeypatch.setattr(sim, "run", keep)
    rc, line, err = run_cell(capsys, tiny_root(tmp_path), cell, trace=1,
                             seed=3300000029)
    assert rc == 0, err
    assert line["correct"] is True
    got = line["metrics"][NAME]
    assert got["unit"] == "%" and 0 < got["value"] <= 100
    spans = [sp for sp in recs[0]["spans"] if sp.name == "sim.phase_tables"]
    assert spans and len(spans) % 2 == 0
    for sp in spans:
        assert {"k", "k_pad", "n_pad", "bytes"} <= set(sp.args)
        assert sp.args["n_pad"] == 16 and sp.args["bytes"] > 0
