"""The harness on the CPU at a tiny size: every cell runs end to end and
prints a result line of the contract's shape, the program agrees with
the plain reference, and a configuration, a mix and a metric added as
new files are found by name."""
from __future__ import annotations

import json

import pytest

from perfbench_tiny import REPO, bench, cells, run_cell, tiny_root

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _shape_ok(line: dict, names: set):
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert DEVICE_KEYS <= set(line["device"])
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float) and m["value"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell", cells())
def test_cell_runs_and_agrees_with_reference(capsys, root, cell):
    rc, line, err = run_cell(capsys, root, cell, trace=0)
    assert rc == 0, err
    e2e = {m["name"] for m in bench()["end_to_end"]}
    _shape_ok(line, e2e)
    assert set(line["metrics"]) == e2e
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert all(c["value"] == 0 for c in line["checks"].values())
    # the numbers compared are the last lines of standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


@pytest.mark.parametrize("cell", cells())
def test_traced_run_reports_layer_metrics(capsys, root, cell):
    rc, line, err = run_cell(capsys, root, cell, trace=1, seed=17)
    assert rc == 0, err
    layer = {m["name"] for m in bench()["per_layer"]}
    _shape_ok(line, layer)
    assert line["correct"] is True
    # the program's spans and the harness's clock give these on any
    # device, in every cell whose metric lists name it; the profiler's
    # device time only on the card
    listed = {m["name"] for m in bench()["per_layer"]
              if cell in m.get("workloads", [cell])}
    assert {"setup.plan_s", "sweep.row_fill_pct",
            "sim_cycle_mfu_pct"} & listed <= set(line["metrics"])
    if "sweep.row_fill_pct" in listed:
        assert 0 < line["metrics"]["sweep.row_fill_pct"]["value"] <= 100


def _builds(config: dict, mix: dict) -> bool:
    from perfbench import grid as G
    try:
        G.scenario_defs(config, mix)
    except ValueError:
        return False
    return True


def _mixes_without_a_cell() -> list:
    """(configuration, mix) for every mix under `perfbench/traffic/` that
    no cell names, each with the first configuration in `BENCHMARK.json`
    whose data builds its scenarios (collective traffic needs one with a
    model), or else the first, so that the case fails.  Empty once every
    mix has a cell."""
    from perfbench import grid as G
    doc = bench()
    named = {w["traffic"] for w in doc["workloads"]}
    configs = [(c["name"], G.load_json(REPO / c["file"]))
               for c in doc["configs"]]
    out = []
    for path in sorted((REPO / "perfbench" / "traffic").glob("*.json")):
        if path.stem in named:
            continue
        mix = G.load_json(path)
        config = next((name for name, c in configs if _builds(c, mix)),
                      configs[0][0])
        out.append(pytest.param(config, path.stem, id=path.stem))
    return out


@pytest.mark.parametrize("config,mix", _mixes_without_a_cell())
def test_mix_kept_for_a_later_cell_runs_and_agrees(capsys, tmp_path,
                                                  config, mix):
    """A mix committed before its cell runs end to end once a cell names
    it, and agrees with the reference; adding that cell later needs no
    edit here."""
    root = tiny_root(tmp_path)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    name = f"{config}.{mix}"
    doc["workloads"].append({"name": name, "config": config,
                             "traffic": mix, "chips": 1,
                             "why": "a later cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    rc, line, err = run_cell(capsys, root, name, trace=1)
    assert rc == 0, err
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert all(c["value"] == 0 for c in line["checks"].values())


def test_same_seed_same_answers(capsys, root):
    cell = cells()[0]
    a = run_cell(capsys, root, cell, seed=2 ** 31 + 11)[1]
    b = run_cell(capsys, root, cell, seed=2 ** 31 + 11)[1]
    assert a["attempted"] >= 1 and b["correct"] and a["correct"]


def test_new_config_mix_and_metric_are_found_by_name(capsys, tmp_path):
    """A cell added as new files only: a configuration, a traffic mix and
    a per-layer metric, with no existing file edited."""
    root = tiny_root(tmp_path)
    pb = root / "perfbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    cfg = json.loads((pb / "configs" / "fig4-n256-organic.json")
                     .read_text())
    cfg.update(name="fig8-n16-glass", substrate="glass",
               topologies=["mesh", "folded_hexa_torus"], areas_mm2=[74.0])
    (pb / "configs" / "fig8-n16-glass.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "tornado.json").write_text(json.dumps(
        {"traffic": {"kind": "pattern", "name": "tornado"},
         "routing": "static"}))
    (pb / "metrics" / "groups_run.py").write_text(
        "def read(rec):\n    return float(len(rec['window']))\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append(dict(doc["configs"][0], name="fig8-n16-glass",
                               file="perfbench/configs/fig8-n16-glass.json"))
    doc["workloads"].append({"name": "fig8-n16-glass.tornado",
                             "config": "fig8-n16-glass",
                             "traffic": "tornado", "chips": 1,
                             "why": "a new cell"})
    doc["per_layer"].append({"name": "groups_run", "unit": "groups",
                             "better": "higher", "source": "host_clock",
                             "layer": "sweep engine",
                             "moves": "sim_router_cycles_per_s",
                             "workloads": ["fig8-n16-glass.tornado"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    after = {p: p.read_bytes() for p in before}
    assert after == before
    rc, line, err = run_cell(capsys, root, "fig8-n16-glass.tornado",
                             trace=1)
    assert rc == 0, err
    assert line["correct"] is True
    assert line["metrics"]["groups_run"]["value"] >= 1
    assert "tornado" in err


def test_unknown_workload_prints_no_result(capsys, root):
    from perfbench import run
    rc = run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"],
                  root=root, device="cpu")
    assert rc != 0 and capsys.readouterr().out == ""


def test_no_card_prints_no_result(capsys, monkeypatch):
    """Without a card the harness exits non-zero before any work."""
    import torch
    from perfbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", cells()[0], "--seed", "1", "--seconds",
                   "1"], root=REPO)
    assert rc == 3 and capsys.readouterr().out == ""
