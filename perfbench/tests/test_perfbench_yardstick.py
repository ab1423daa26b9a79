"""The yardstick itself: BENCHMARK.json against the contract's shape,
the byte counts against hand counts, and the imports of every module
under perfbench/ (no JAX, no JAX package; the reference nothing of the
program)."""
from __future__ import annotations

import ast
import json
import re

import pytest

from perfbench_tiny import REPO, bench

PB = REPO / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the yardstick: nothing here may import the program
YARDSTICK = ["reference", "compare.py", "roofline.py", "grid.py",
             "profiling.py", "control.py"]


def _imports(path) -> set:
    """Top-level names of every module `path` imports (absolute imports
    and the strings handed to import_module / __import__)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            out.add(node.args[0].value.split(".")[0])
    return out


def _py_files(*parts):
    for part in parts or ("",):
        p = PB / part
        yield from ([p] if p.is_file() else sorted(p.rglob("*.py")))


def test_no_module_imports_jax_or_the_jax_package():
    for path in _py_files():
        bad = _imports(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_yardstick_imports_nothing_of_the_program():
    for path in _py_files(*YARDSTICK):
        assert "repro_torch" not in _imports(path), path


def test_forbidden_check_compares_whole_names(monkeypatch):
    import sys
    from perfbench import run
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert run.forbidden_loaded() == ["repro"]


def test_netstep_bytes_equal_a_hand_count():
    from perfbench import roofline as RL
    # [B, N, PI, V] = [2, 3, 5, 4]: op_slot 120 x 4 + eligible 120 +
    # rr_vc, rr_port 2 x 4 x 2 + win 120 + vc_choice, out_req 2 x 30 x 4
    assert RL.netstep_bytes((2, 3, 5, 4)) == 480 + 120 + 16 + 120 + 240
    ms, by, ops = RL.netstep_bound((2, 3, 5, 4), 976)
    assert ops == 2 * 3 * 5 * (3 * 4 + 3 * 5)
    assert by == "bytes" and ms == pytest.approx(1e3 * 976 / 3.35e12)


def test_cycle_state_bytes_equal_a_hand_count():
    from perfbench import roofline as RL
    # n 2, p 1, c 2, d 3, V 2, B 2: 8 input VCs x 2 slots x 2 words,
    # 8 x (head, count), 2 x 1 x 2 credits, 2 x 3 link slots x 3 words,
    # 2 x 3 x 2 credit-pipe counts, one pointer = 83 words
    assert RL.cycle_state_words(2, 1, 2, 3, 2, 2) == 32 + 16 + 4 + 18 \
        + 12 + 1
    assert RL.cycle_state_bytes(2, 1, 2, 3, 2, 2) == 2 * 4 * 83


def test_cycle_state_bytes_are_a_floor_of_the_programs_state():
    """The least bytes never exceed what the program's runner carries
    for one unpadded row, read and written once."""
    import numpy as np
    import repro_torch.core.simulator as sim
    from repro_torch.core.routing import cached_routing
    from repro_torch.core import traffic as TR
    from perfbench import roofline as RL
    topo, r = cached_routing("folded_hexa_torus", 16)
    spec = sim.make_spec(r, TR.uniform(topo))
    cfg = sim.SimConfig(cycles=4, warmup=1)
    _, _, shape, _, _, _, _, run = sim._prepare(
        [spec], np.array([[0.1]]), cfg, None, "cpu", None, None)
    probe = {}
    run(cfg, probe)
    least = RL.cycle_state_bytes(spec.n, spec.p, spec.c, spec.d, 4, 4)
    assert 0 < least <= 2 * probe["state_bytes"]


def test_benchmark_json_keeps_the_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for word in b["command"]:
        assert not word.startswith("/") and ".." not in word
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert (REPO / c["file"]).is_file()
        f = json.loads((REPO / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
        assert f["source"] == c["source"]
        names.add(c["name"])
    used = {w["config"] for w in b["workloads"]}
    assert used == names
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
        cells.add(w["name"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        layers.add(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (PB / "metrics" / f"{m['name']}.py").is_file()
    every = [w["name"] for w in b["workloads"]]
    assert len(set(every)) == len(every)
    for cell in cells:
        reports = {m["moves"] for m in b["per_layer"]
                   if cell in m["workloads"]}
        assert reports <= e2e and reports
    assert len(json.dumps(b)) <= 64 * 1024
    for path in PB.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$",
                            str(path.relative_to(REPO))), path
