"""A tiny copy of the benchmark's data for the CPU tests.

`tiny_root(tmp)` writes BENCHMARK.json and the configurations, mixes
and metric readers into `tmp`, with every configuration cut to N = 16,
two chiplet areas and 60 cycles (20 of warm-up), so that a cell runs
end to end on the CPU in seconds; a training step's mesh becomes the
configuration's `step.tiny_mesh`, or TINY_MESH where it gives none.
`run_cell` runs one cell there and returns its exit code, result line
and standard error.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_SIM = {"n_vcs": 4, "buf_depth": 4, "cycles": 60, "warmup": 20}
#: the mesh of a training step at N = 16 where a configuration names none
TINY_MESH = {"data": 2, "model": 8}


def bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def cells() -> list:
    return [w["name"] for w in bench()["workloads"]]


def tiny_root(tmp: Path) -> Path:
    tmp = Path(tmp)
    pb = tmp / "perfbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(REPO / "perfbench" / sub, pb / sub)
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for path in (pb / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["sizes"] = [16]
        c["areas_mm2"] = c["areas_mm2"][:2]
        c["sim"] = dict(TINY_SIM)
        if "step" in c:
            c["step"]["mesh"] = dict(c["step"].get("tiny_mesh",
                                                  TINY_MESH))
        path.write_text(json.dumps(c))
    return tmp


def run_cell(capsys, root: Path, cell: str, seed: int = 3000000019,
             trace: int = 0, seconds: float = 0.3):
    """(exit code, parsed last stdout line or None, stderr)."""
    from perfbench import run
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], root=root,
                  device="cpu")
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    line = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, line, err
