"""A training step's reference derivation chosen by name: the default
gives the frozen TP x FSDP workload bit for bit, the model and the step
reach both sides as before, a name with no file stops the run in set-up,
and a planted derivation reaches the check and the control."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import re

import numpy as np
import pytest

from perfbench_tiny import REPO, TINY_MESH, run_cell, tiny_root

CELL = "collectives-n64-organic.moe-train-step"
CONFIG = "collectives-n64-organic"

#: the parent's `model_sizes` of collectives-n64-organic's model
QWEN_SIZES = dict(name="qwen3-moe-235b-a22b", d_model=4096, n_layers=94,
                  n_heads=64, n_kv_heads=4, head_dim=128, d_ff=1536,
                  vocab=151936, n_experts=128, top_k=8, moe_every=1)
#: the parent's `step_kwargs` of its step
QWEN_STEP = {"seq_len": 2048, "step_cycles": 1000, "min_phase": 50,
             "dtype_bytes": 2, "mesh_shape": {"data": 8, "model": 8}}
#: sha256 (first 16 hex digits) of the parent's scenario definitions and
#: settings, and of every scenario's analytic bound, rate grid, spec,
#: compiled schedule and phases as the reference builds them
PARENT_DIGESTS = {
    ("fig4-n256-organic", "uniform"):
        ("cd241a93ef8a172a", "0ece7d43db04066d"),
    ("collectives-n64-organic", "moe-train-step"):
        ("37ebacb0a422091e", "6deacbe30ad65a1a"),
    ("fig4-n256-organic", "hotspot-adaptive"):
        ("afe2af118fc665e2", "1f061fe52a6f5f47"),
    ("fig4-n256-organic", "uniform-one-batch"):
        ("7580fbd853bbf78d", "0ece7d43db04066d"),
}

#: a derivation that doubles the bytes of one phase of the default's
DOUBLED = '''
import dataclasses

from perfbench.reference.derivations.tp_fsdp import step_collective_ops \\
    as _tp_fsdp

CALLS = []


def step_collective_ops(config, mesh_shape, **kw):
    CALLS.append(dict(mesh_shape))
    return [dataclasses.replace(op, bytes_per_chip=2 * op.bytes_per_chip)
            if op.phase == "moe_a2a" else op
            for op in _tp_fsdp(config, mesh_shape, **kw)]
'''


def _load(*parts):
    return json.loads((REPO / "perfbench").joinpath(*parts).read_text())


def _feed(h, x):
    """Hash `x` by value: arrays by dtype, shape and bytes."""
    import torch
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    if isinstance(x, np.ndarray):
        h.update(f"{x.dtype}{x.shape}".encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif isinstance(x, (list, tuple)):
        h.update(b"[")
        for v in x:
            _feed(h, v)
        h.update(b"]")
    elif isinstance(x, dict):
        for k in sorted(x):
            h.update(str(k).encode())
            _feed(h, x[k])
    else:
        h.update(repr(x).encode())


@pytest.mark.parametrize("config,mix", sorted(PARENT_DIGESTS))
def test_cells_build_what_they_built_on_the_parent(config, mix):
    """Scenario definitions, compiled schedules and rate grids at the
    cell's own size equal the parent's bit for bit."""
    from perfbench import grid as G
    from perfbench.reference import scenario as S
    c, m = _load("configs", f"{config}.json"), _load("traffic", f"{mix}.json")
    s = G.settings(c, m)
    defs = G.scenario_defs(c, m)
    h_defs = hashlib.sha256()
    _feed(h_defs, [dataclasses.asdict(d) for d in defs])
    _feed(h_defs, dataclasses.asdict(s))
    h_built = hashlib.sha256()
    for d in defs:
        b = S.build_scenario(d, s)
        sched = b["schedule"]
        _feed(h_built, [
            b["analytic"], b["rates"], vars(b["spec"]),
            vars(b["sched_spec"]) if b["sched_spec"] is not None else None,
            [(p.label, p.duration, p.intensity, p.traffic)
             for p in sched.phases] if sched is not None else None])
    assert (h_defs.hexdigest()[:16], h_built.hexdigest()[:16]) == \
        PARENT_DIGESTS[(config, mix)]


def test_model_sizes_and_step_kwargs_keep_the_parents_values():
    """The mapped fields keep their names, values and types; every
    published key rides beside them; the step's keywords are the
    parent's, the harness's own keys left out."""
    from perfbench import grid as G
    c = _load("configs", f"{CONFIG}.json")
    got = vars(G.model_sizes(c["model"]))
    for k, v in QWEN_SIZES.items():
        assert got[k] == v and type(got[k]) is type(v), k
    for k, v in c["model"].items():
        if k not in QWEN_SIZES:
            assert got[k] == v, k
    assert G.step_kwargs(c["step"]) == QWEN_STEP
    marked = dict(c["step"], derivation="tp_fsdp", tiny_mesh=TINY_MESH)
    assert G.step_kwargs(marked) == QWEN_STEP
    # fig4's configuration has no training step
    assert "model" not in _load("configs", "fig4-n256-organic.json")


def test_mapped_field_wins_a_clash_and_new_keys_pass():
    from perfbench import grid as G
    model = dict(_load("configs", f"{CONFIG}.json")["model"],
                 head_dim=None, n_group=8)
    got = G.model_sizes(model)
    assert got.head_dim == 0 and got.n_group == 8
    kw = G.step_kwargs({"seq_len": "4096", "stages": 4, "mesh": {"pp": 2},
                        "derivation": "x"})
    assert kw == {"seq_len": 4096, "stages": 4, "mesh_shape": {"pp": 2}}


@pytest.mark.parametrize("n", [16, 64])
def test_default_derivation_is_the_frozen_workload(n):
    """The reference's schedule through the named default equals a
    direct call of the frozen `collective_workload`: phase labels,
    durations, flow matrices and intensities, bit for bit."""
    from perfbench import grid as G
    from perfbench.reference import scenario as S
    from perfbench.reference.collective import collective_workload
    from perfbench.reference.topology import build
    c = _load("configs", f"{CONFIG}.json")
    c.update(sizes=[n], areas_mm2=[74.0])
    if n == 16:
        c["step"]["mesh"] = TINY_MESH
    m = _load("traffic", "moe-train-step.json")
    s = G.settings(c, m)
    meas = s.cycles - s.warmup
    for d in G.scenario_defs(c, m):
        topo = build(d.topology, d.n, substrate=d.substrate,
                     chiplet_area_mm2=d.area, roles_scheme=d.roles)
        step = d.traffic["step"]
        raw = collective_workload(G.model_sizes(d.traffic["model"]), topo,
                                  **G.step_kwargs(step))
        _, got = S._schedule(d, topo, meas)
        want = raw.fit(meas)
        assert [p.label for p in got.phases] == \
            [p.label for p in want.phases] == \
            ["fsdp_gather", "fwd_tp", "moe_a2a", "bwd_tp", "grad_reduce"]
        for p, q in zip(got.phases, want.phases):
            assert p.duration == q.duration
            assert np.float64(p.intensity).tobytes() == \
                np.float64(q.intensity).tobytes()
            assert np.array_equal(p.traffic, q.traffic)
            assert p.traffic.dtype == q.traffic.dtype


def _derivation_config(root, name):
    """The tiny collective configuration naming derivation `name`."""
    path = root / "perfbench" / "configs" / f"{CONFIG}.json"
    c = json.loads(path.read_text())
    c["step"]["derivation"] = name
    path.write_text(json.dumps(c))
    return c


def test_missing_derivation_stops_the_run_in_set_up(capsys, tmp_path,
                                                    monkeypatch):
    """A derivation with no `.py` file stops the run before the window,
    naming the path it looked for; there is no fallback."""
    from perfbench import control
    from perfbench.drivers import sim
    groups = []
    monkeypatch.setattr(sim, "run_group",
                        lambda *a, **kw: groups.append(a))
    root = tiny_root(tmp_path)
    config = _derivation_config(root, "no_such_step")
    want = re.escape(str(REPO / "perfbench" / "reference" / "derivations"
                         / "no_such_step.py"))
    with pytest.raises(FileNotFoundError, match=want):
        run_cell(capsys, root, CELL)
    assert groups == []
    mix = _load("traffic", "moe-train-step.json")
    with pytest.raises(FileNotFoundError, match=want):
        control.readings(config, mix, 11, "cpu")


def test_derivation_name_must_be_a_module_name():
    from perfbench.reference import derivations
    for bad in ("../collective_ops", "tp_fsdp.py", "", "a/b"):
        with pytest.raises(ValueError):
            derivations.load(bad)
    assert derivations.load("tp_fsdp").step_collective_ops.__module__ \
        == "perfbench.reference.collective_ops"


@pytest.fixture
def doubled(tmp_path, monkeypatch):
    """A derivation `doubled_moe_a2a` in a temporary directory of the
    derivations package."""
    import sys
    from perfbench.reference import derivations
    pkg = tmp_path / "planted"
    pkg.mkdir()
    (pkg / "doubled_moe_a2a.py").write_text(DOUBLED)
    monkeypatch.setattr(derivations, "__path__",
                        [*derivations.__path__, str(pkg)])
    name = f"{derivations.__name__}.doubled_moe_a2a"
    monkeypatch.delitem(sys.modules, name, raising=False)
    yield "doubled_moe_a2a"
    sys.modules.pop(name, None)


def test_planted_derivation_fails_the_check(capsys, tmp_path, doubled):
    """The program never sees the name, so a derivation that doubles the
    MoE all-to-all's bytes leaves the reference disagreeing with it:
    `correct` comes out false."""
    import sys
    root = tiny_root(tmp_path / "tiny")
    _derivation_config(root, doubled)
    rc, line, err = run_cell(capsys, root, CELL, seed=23)
    assert rc == 0, err
    assert line["correct"] is False
    assert line["checks"]["counters_differing"]["value"] > 0
    calls = sys.modules[
        f"perfbench.reference.derivations.{doubled}"].CALLS
    assert calls and all(c == TINY_MESH for c in calls)


def test_planted_derivation_reaches_the_control(tmp_path, doubled):
    """The control builds its reference from the named derivation too:
    the planted file is called for each scenario it reads, and its
    schedules are not the default's, which the program runs."""
    import sys
    from perfbench import compare as C
    from perfbench import control
    from perfbench import grid as G
    from perfbench.reference import scenario as S
    root = tiny_root(tmp_path / "tiny")
    config = _derivation_config(root, doubled)
    mix = _load("traffic", "moe-train-step.json")
    r = control.readings(config, mix, 11, "cpu", inject_dtype="float32")
    calls = sys.modules[
        f"perfbench.reference.derivations.{doubled}"].CALLS
    assert len(calls) == 2 * len(r["scenarios"])
    s = G.settings(config, mix)
    default = dict(config, step=dict(config["step"], derivation="tp_fsdp"))
    planted = {d.label: d for d in G.scenario_defs(config, mix)}
    for d in G.scenario_defs(default, mix):
        if d.label not in r["scenarios"]:
            continue
        want, want_row = S.simulate(planted[d.label], s, 5, "cpu")
        got, got_row = S.simulate(d, s, 5, "cpu")
        assert C.compare(got, got_row, want, want_row)[
            "counters_differing"] > 0


def test_derivation_may_bring_its_own_flows():
    """A derivation's `op_flow` replaces the frozen mapping of each op
    onto the placement: here it sends every op's bytes one chiplet on,
    without wrapping, and the schedule carries exactly those flows."""
    import types
    from perfbench import grid as G
    from perfbench.reference.collective import collective_workload
    from perfbench.reference.derivations import tp_fsdp
    from perfbench.reference.topology import build

    def shift(topo, mesh_shape, op):
        f = np.zeros((topo.n, topo.n))
        idx = np.arange(topo.n - 1)
        f[idx, idx + 1] = op.bytes_per_chip
        return f

    c = _load("configs", f"{CONFIG}.json")
    derivation = types.SimpleNamespace(
        step_collective_ops=tp_fsdp.step_collective_ops, op_flow=shift)
    topo = build("mesh", 16, substrate="organic", chiplet_area_mm2=74.0)
    kw = dict(G.step_kwargs(c["step"]), mesh_shape=TINY_MESH)
    sched = collective_workload(G.model_sizes(c["model"]), topo,
                                derivation=derivation, **kw)
    ops = tp_fsdp.step_collective_ops(G.model_sizes(c["model"]), TINY_MESH,
                                      seq_len=2048, global_batch=8,
                                      dtype_bytes=2)
    assert [p.label for p in sched.phases] == [op.phase for op in ops]
    for p, op in zip(sched.phases, ops):
        assert np.array_equal(p.traffic, shift(topo, None, op))
