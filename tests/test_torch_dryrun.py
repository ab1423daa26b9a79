"""The port's multi-pod dry-run (`repro_torch.launch.dryrun`) on a fake
process group, against the reference's record and its readers.

Each cell runs in its own subprocess (the fake group is process-wide,
and a fake tensor on "cuda" would abort a CPU-only build), the three at
once, each with a deadline: qwen3-1.7b `train_4k` (one microbatch) and
qwen3-moe-235b-a22b `decode_32k` on 16 x 16, and the latter on 2 x 16 x
16.  Checks:

* each record has exactly the keys the reference's `run_cell` writes
  (read from its source), and its collective kinds are among the
  reference's five;
* train: the all-gathers over "data" move each data-sharded leaf whole,
  in bf16, at each use (the layers' leaves twice per microbatch under
  `remat="full"`, the embedding twice, the final norm once); the
  all-gathers over "model" and the reduce-scatters over "data" are as
  exact; the only all-reduce over "model" is the grad norm's, where
  `step_collective_ops` plans activation all-reduces there;
* decode: per layer one token gather over "data", one reduce-scatter
  there, two weight gathers over "model" (wq, wo) and four all-reduces
  (distributed decode's three, the MoE's one), plus the logits' gathers
  and the embedding's;
* readers: `benchmarks.roofline.analyze` reads the directory as `ok`
  rows, the train row's useful-FLOPs ratio in the range derived below,
  and `examples/topology_collectives.py`'s pricing loop with the port's
  `build_ici_model` gives finite times;
* `examples_torch/topology_collectives.py` on the train record prints
  the pricing lines the reference's `examples/topology_collectives.py`
  prints for it (both scripts run at once, each in its own process),
  with FoldedHexaTorus cheaper than Mesh; without a record under
  `build/dryrun/` it points to the port's dry-run and exits 0.
"""
import ast
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 150
CELLS = [("qwen3-1.7b", "train_4k", False),
         ("qwen3-moe-235b-a22b", "decode_32k", False),
         ("qwen3-moe-235b-a22b", "decode_32k", True)]
KINDS = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute"}
MESH = {"data": 16, "model": 16}


def _tag(arch, shape, multi):
    return f"{arch.replace('-', '_').replace('.', '_')}__{shape}__" \
        f"{'pod2' if multi else 'pod1'}"


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{tag: record} of the three cells, run at once."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, multi in CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--microbatches", "1", "--out",
               str(out)] + (["--multi-pod"] if multi else [])
        procs.append(subprocess.Popen(cmd, env=env, cwd=out,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    end = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            try:
                log, _ = p.communicate(timeout=max(end - time.monotonic(),
                                                   1))
            except subprocess.TimeoutExpired:
                pytest.fail(f"a dry-run cell did not finish within "
                            f"{DEADLINE_S} s")
            assert p.returncode == 0, log[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(5)
    recs = {}
    for arch, shape, multi in CELLS:
        with open(out / f"{_tag(arch, shape, multi)}.json") as f:
            recs[_tag(arch, shape, multi)] = json.load(f)
    return out, recs


def _reference_keys():
    """The keys of an `ok` record of the reference's `run_cell`: its
    `dict(...)` and its first `rec.update(...)` (read from the source,
    since importing that module sets XLA_FLAGS for the process)."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys, updates = set(), []
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                and getattr(n.value.func, "id", None) == "dict" \
                and getattr(n.targets[0], "id", None) == "rec":
            keys |= {k.arg for k in n.value.keywords}
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "update" \
                and getattr(n.func.value, "id", None) == "rec":
            updates.append((n.lineno, {k.arg for k in n.keywords}))
    return keys | min(updates)[1]


def _by_axis(rec):
    return rec["raw_static"]["u1"]["collectives_by_axis"]


def _qwen3_layout():
    """(cfg, [(leaf's shape, spec)]) of qwen3-1.7b's parameters on 16 x
    16 in the train layout, and the uses per microbatch of each."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as St
    from repro_torch.models import Model
    from repro_torch.models import sharding as SH
    cfg = get_config("qwen3-1.7b")
    ctx = St.build_ctx(MESH)
    shapes, shardings = St.param_shardings(Model(cfg, ctx), ctx)
    rows = []
    for (path, t), sh in zip(T.leaves_with_paths(shapes),
                             T.leaves(shardings, is_leaf=SH.is_sharding)):
        # gathered in each layer's forward and again under remat="full";
        # the embedding at its lookup and at the head; the final norm once
        fwd, bwd = {"layers": (2, 1), "embed": (2, 2)}.get(path[0], (1, 1))
        rows.append((tuple(t.shape), sh.spec, fwd, bwd))
    assert cfg.compute_dtype == torch.bfloat16 and cfg.remat == "full"
    return cfg, rows


def _split(spec, axis):
    from repro_torch.models import sharding as SH
    return any(axis in SH.entry_axes(e) for e in spec)


def test_records_have_the_reference_keys(records):
    _, recs = records
    want = _reference_keys()
    for tag, rec in recs.items():
        assert rec["ok"], rec.get("error")
        assert set(rec) == want, (tag, set(rec) ^ want)
        assert set(rec["collectives"]) <= KINDS, tag
        for v in rec["collectives"].values():
            assert set(v) == {"count", "bytes"}
        assert rec["collective_bytes_per_chip"] == sum(
            v["bytes"] for v in rec["collectives"].values())
        assert rec["bytes_accessed_per_chip"] == -1.0
        assert rec["unroll2_s"] == 0.0
        assert rec["flops_per_chip"] > 0 and rec["peak_bytes_per_chip"] > 0


def test_train_collectives_are_the_design_s(records):
    """qwen3-1.7b train_4k on 16 x 16, one microbatch: the FSDP-style
    gathers and reduce-scatters, byte for byte."""
    from repro_torch.models.sharding import step_collective_ops
    _, recs = records
    rec = recs[_tag("qwen3-1.7b", "train_4k", False)]
    k = rec["microbatches"]
    assert k == 1
    cfg, rows = _qwen3_layout()
    got = _by_axis(rec)
    bf16 = 2
    want = {"all-gather@data": [0, 0], "all-gather@model": [0, 0],
            "reduce-scatter@data": [0, 0]}
    for shape, spec, fwd, bwd in rows:
        full = math.prod(shape) * bf16
        on_data, on_model = _split(spec, "data"), _split(spec, "model")
        if on_model:      # gathered over "model" first, still split on data
            row = want["all-gather@model"]
            row[0] += k * fwd
            row[1] += k * fwd * full // (MESH["data"] if on_data else 1)
        if on_data:       # then whole over "data"; its gradient scattered
            want["all-gather@data"][0] += k * fwd
            want["all-gather@data"][1] += k * fwd * full
            want["reduce-scatter@data"][0] += k * bwd
            want["reduce-scatter@data"][1] += k * bwd * full // MESH["data"]
    for key, (count, nbytes) in want.items():
        assert (got[key]["count"], got[key]["bytes"]) == (count, nbytes), key
    # the difference from the reference's plan: no activation all-reduce
    # over "model" (dense layers run whole on each model rank); the grad
    # norm's float64 sum is the one all-reduce there
    plan = step_collective_ops(cfg, MESH, seq_len=4096, global_batch=256)
    assert {(o.phase, o.axis) for o in plan} >= {("fwd_tp", "model"),
                                                  ("bwd_tp", "model")}
    assert got["all-reduce@model"] == {"count": 1, "bytes": 8}
    assert set(got) == set(want) | {"all-reduce@model", "all-reduce@data"}
    # the plan gathers the parameters over "data" once per step; the port
    # gathers each leaf at each use
    fsdp = next(o for o in plan if o.phase == "fsdp_gather")
    assert got["all-gather@data"]["bytes"] > 2 * fsdp.bytes_per_chip


def test_decode_collectives_are_the_design_s(records):
    """qwen3-moe-235b-a22b decode_32k: distributed decode over the
    sequence-sharded cache (4 kv heads do not tile 16) and the
    weight-stationary MoE, per layer; on 2 x 16 x 16 the logits are
    gathered over "pod" too."""
    from repro_torch.configs import get_config
    _, recs = records
    n = get_config("qwen3-moe-235b-a22b").n_layers
    for multi in (False, True):
        got = _by_axis(recs[_tag("qwen3-moe-235b-a22b", "decode_32k",
                                 multi)])
        counts = {key: row["count"] for key, row in got.items()}
        want = {"all-gather@data": n + 1, "reduce-scatter@data": n,
                "all-gather@model": 2 * n + 2, "all-reduce@model": 4 * n}
        if multi:
            want["all-gather@pod"] = 1
        assert counts == want, (multi, counts)


def test_readers_take_the_records(records):
    """`benchmarks.roofline.analyze` and the pricing loop of
    `examples/topology_collectives.py`.

    The train row's useful-FLOPs ratio, 6 N D / chips over the counted
    FLOPs: each chip runs its data rank's D / 16 tokens through whole
    dense layers (the model axis splits storage, not the dense work), so
    per token it does 6 N_l + 3 A + 6 d V (no recompute) to 8 N_l + 4 A
    + 6 d V (all of it recomputed under remat="full"; checkpointing stops
    recomputing early), N_l the layers' product parameters, A the dense
    attention scores' FLOPs, d V the head."""
    import numpy as np
    from benchmarks.roofline import analyze
    from repro_torch.core.collectives import build_ici_model
    out, recs = records
    rows = analyze(str(out))
    assert len(rows) == len(CELLS) and all(r["ok"] for r in rows)
    row = next(r for r in rows if r["shape"] == "train_4k")
    cfg, _ = _qwen3_layout()
    d, h, kv, hd, f, t = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                          cfg.d_ff, 4096)
    n_l = cfg.n_layers * (2 * d * h * hd + 2 * d * kv * hd + 3 * d * f)
    a = cfg.n_layers * 4 * t * hd * h
    dv = d * cfg.vocab
    useful = 6 * (n_l + dv)
    lo = useful / (MESH["model"] * (8 * n_l + 4 * a + 6 * dv))
    hi = useful / (MESH["model"] * (6 * n_l + 3 * a + 6 * dv))
    assert lo <= row["useful_flops_ratio"] <= hi, (lo, row, hi)
    for rec in recs.values():
        for topo in ("mesh", "hexamesh", "folded_torus",
                     "folded_hexa_torus"):
            m = build_ici_model(topo, 64, "organic", device="cpu")
            s = sum(m.collective_time_s(kind.replace("-", "_"), v["bytes"])
                    for kind, v in rec["collectives"].items())
            assert np.isfinite(s) and s > 0, (rec["tag"], topo)


def _topology_collectives(script, args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, str(ROOT / script), *args],
                            cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(procs):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=DEADLINE_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(5)
    return outs


def test_topology_collectives_prices_as_the_reference(records, tmp_path):
    out, _ = records
    path = str(out / f"{_tag('qwen3-1.7b', 'train_4k', False)}.json")
    ref, port = _finish([
        _topology_collectives("examples/topology_collectives.py", [path],
                              tmp_path),
        _topology_collectives("examples_torch/topology_collectives.py",
                              ["--device", "cpu", path], tmp_path)])
    assert port == ref
    lines = port.splitlines()
    assert lines[1] == f"=== {_tag('qwen3-1.7b', 'train_4k', False)} ==="
    ms = {}
    for line in lines[3:]:
        name, rest = line.split(None, 1)
        ms[name] = float(rest.rsplit("~", 1)[1].split()[0])
    assert list(ms) == ["mesh", "hexamesh", "folded_torus",
                        "folded_hexa_torus"]
    assert 0 < ms["folded_hexa_torus"] < ms["mesh"], ms


def test_topology_collectives_without_a_record(tmp_path):
    out, = _finish([_topology_collectives(
        "examples_torch/topology_collectives.py", ["--device", "cpu"],
        tmp_path)])
    assert out.startswith("no dry-run artifacts found — run python -m "
                          "repro_torch.launch.dryrun"), out
