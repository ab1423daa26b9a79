"""The pipeline x expert x ZeRO-1 training step (`models.pipeline_step`)
and the flows it adds to `core.collectives`, on the CPU.

DeepSeek-V3's published configuration (the keys of its `config.json`,
read from the benchmark's configuration file as data) is counted, staged
and derived into ops; the new flows are held to hand counts on 16
chiplets; the step keys the scheme needs are checked; and the planner's
and the simulator's new spans and counters are recorded with their
attributes.  The schedule's bit-for-bit comparison with the benchmark's
plain reference derivation lives beside that reference, in
`perfbench/tests/test_perfbench_deepseek_v3.py`.
"""
from __future__ import annotations

import importlib
import json
import types
from pathlib import Path

import numpy as np
import pytest

import repro_torch.workloads as W
from repro_torch.configs import get_config
from repro_torch.core import collectives as C
from repro_torch.core import simulator as S
from repro_torch.core import topology as T
from repro_torch.core.routing import build_routing
from repro_torch.core.traffic import uniform
from repro_torch.models import pipeline_step as PS
from repro_torch.obs.metrics import metrics

TR = importlib.import_module("repro_torch.obs.trace")

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "perfbench"
                     / "configs" / "deepseek-v3-n256-organic.json")
                    .read_text())
STEP_KEYS = ("seq_len", "global_batch", "dtype_bytes", "dispatch_bytes",
             "step_cycles", "min_phase")


def _model():
    """The published keys, as the configuration file holds them."""
    return types.SimpleNamespace(**CONFIG["model"])


def _step(mesh):
    return dict({k: CONFIG["step"][k] for k in STEP_KEYS}, mesh_shape=mesh)


def _param_counts(c) -> tuple:
    """(total, active) parameters of the main model, its MTP module left
    out, from the program's per-layer counts: every layer, the embedding,
    the untied output head and the final norm; active counts
    num_experts_per_tok routed experts of each MoE layer."""
    d = c.hidden_size
    total = active = 2 * c.vocab_size * d + d
    for i in range(c.num_hidden_layers):
        moe = PS._is_moe(c, i)
        rep, routed = PS._layer(c, moe)
        total += rep + routed
        active += rep + routed // c.n_routed_experts \
            * c.num_experts_per_tok * moe
    return total, active


def test_parameter_count_is_the_published_one():
    """DeepSeek-V3 is published as 671 B parameters with 37 B activated
    a token (arXiv:2412.19437, the MTP module left out): the program's
    per-layer counts over the configuration's keys give 671.026 B and
    37.552 B, and the stages hold every non-routed parameter of them
    once, beside the MTP module."""
    c = _model()
    total, active = _param_counts(c)
    assert (total, active) == (671_026_419_200, 37_552_297_472)
    assert total == pytest.approx(671.026e9, rel=1e-4)
    assert active == pytest.approx(37.552e9, rel=1e-4)
    routed = sum(PS._layer(c, PS._is_moe(c, i))[1]
                 for i in range(c.num_hidden_layers))
    d = c.hidden_size
    mtp = 2 * d * d + 2 * d + PS._layer(c, True)[0] + d
    assert sum(st.replicated for st in PS.stages(c, 4)) == \
        total - routed + c.num_nextn_predict_layers * mtp


def test_stages_at_the_published_depth():
    """15 / 15 / 15 / 16 layers and the MTP module at pipe 4: stage 0
    has the 3 dense layers and the embedding, the last the head."""
    st = PS.stages(_model(), 4)
    assert [len(s.layers) for s in st] == [15, 15, 15, 16]
    assert [s.moe_blocks for s in st] == [12, 15, 15, 17]
    assert st[1].replicated == st[2].replicated
    assert st[0].replicated > st[1].replicated
    assert st[3].replicated > st[1].replicated
    assert [len(s.layers) for s in PS.stages(_model(), 2)] == [30, 31]
    with pytest.raises(ValueError):
        PS.stages(_model(), 62)


def test_ops_carry_integer_bytes_and_their_stage():
    ops = PS.step_collective_ops(_model(), CONFIG["step"]["mesh"],
                                 seq_len=4096, global_batch=7680,
                                 dtype_bytes=2, dispatch_bytes=1)
    assert all(type(op.bytes_per_chip) is int for op in ops)
    by_phase = {}
    for op in ops:
        by_phase.setdefault(op.phase, []).append(op.stage)
    assert by_phase["pp_fwd"] == [0, 1, 2]
    assert by_phase["pp_bwd"] == [1, 2, 3]
    assert all(by_phase[p] == [0, 1, 2, 3] for p in (
        "ep_dispatch", "ep_combine", "grad_dispatch", "grad_combine",
        "grad_reduce", "param_gather"))
    act = 120 * 4096 * 7168
    disp = {op.stage: op for op in ops if op.phase == "ep_dispatch"}
    comb = {op.stage: op for op in ops if op.phase == "ep_combine"}
    assert disp[3].bytes_per_chip == 17 * act
    assert comb[3].bytes_per_chip == 2 * 17 * act
    assert disp[0].shares == (0.5, 1.0)
    with pytest.raises(ValueError, match="data ranks"):
        PS.step_collective_ops(_model(), CONFIG["step"]["mesh"],
                               seq_len=4096, global_batch=100,
                               dtype_bytes=2, dispatch_bytes=1)


# ---- the new flows on 16 chiplets (the mesh: raster order = ids) ------

def _topo16():
    topo = T.build("mesh", 16)
    assert np.array_equal(C.raster_order(topo), np.arange(16))
    return topo


def test_groups_over_two_axes():
    """A group over (node, local) is a stage's chiplets, [node][local];
    over "pipe" a column of one (node, local) through the stages."""
    topo = _topo16()
    mesh = {"pipe": 2, "node": 2, "local": 4}
    assert C.mesh_axis_groups(topo, mesh, ("node", "local")) == [
        [[0, 1, 2, 3], [4, 5, 6, 7]], [[8, 9, 10, 11], [12, 13, 14, 15]]]
    assert C.mesh_axis_groups(topo, mesh, ("pipe", "node")) == [
        [[0, 4], [8, 12]], [[1, 5], [9, 13]], [[2, 6], [10, 14]],
        [[3, 7], [11, 15]]]
    assert C.mesh_axis_groups(topo, mesh, "pipe") == [
        [i, i + 8] for i in range(8)]
    with pytest.raises(KeyError):
        C.mesh_axis_groups(topo, mesh, ("node", "data"))


def test_ring_over_two_axes_runs_row_major():
    topo = _topo16()
    mesh = {"pipe": 2, "node": 2, "local": 4}
    groups = C.mesh_axis_groups(topo, mesh, ("node", "local"))
    m = C.collective_flow(16, "reduce_scatter", groups, 64)
    want = np.zeros((16, 16))
    for base in (0, 8):
        for i in range(8):
            want[base + i, base + (i + 1) % 8] = 64 * 7 / 8
    assert np.array_equal(m, want)


@pytest.mark.parametrize("kind,edges", [
    ("send_next", [(0, 4), (4, 8), (8, 12)]),
    ("send_prev", [(4, 0), (8, 4), (12, 8)])])
def test_unwrapped_send(kind, edges):
    """Each member sends its payload one stage on (back), and no edge
    joins the last stage to the first."""
    topo = _topo16()
    mesh = {"pipe": 4, "node": 2, "local": 2}
    groups = C.mesh_axis_groups(topo, mesh, "pipe")
    assert groups[0] == [0, 4, 8, 12]
    m = C.collective_flow(16, kind, groups, 5.0)
    want = np.zeros((16, 16))
    for col in range(4):
        for i, j in edges:
            want[i + col, j + col] = 5.0
    assert np.array_equal(m, want)
    assert m[12, 0] == m[0, 12] == 0.0
    assert m.sum() == 5.0 * 3 * 4


@pytest.mark.parametrize("kind", ["dispatch", "combine"])
def test_two_stage_dispatch_and_combine(kind):
    """inter of the payload to the same-local chiplet of the other node,
    intra to every other chiplet of its own node: row and column sums
    are the payload x (inter (G - 1) + intra (L - 1)); combine is the
    dispatch transposed."""
    topo = _topo16()
    mesh = {"pipe": 2, "node": 2, "local": 4}
    groups = C.mesh_axis_groups(topo, mesh, ("node", "local"))
    m = C.collective_flow(16, kind, groups, 8, shares=(0.5, 0.25))
    assert np.array_equal(m.sum(axis=1), np.full(16, 8 * (0.5 + 0.75)))
    assert np.array_equal(m.sum(axis=0), np.full(16, 8 * (0.5 + 0.75)))
    assert m[0, 4] == 4.0 and m[0, 1] == m[0, 3] == 2.0
    assert m[0, 5] == m[0, 8] == m[0, 0] == 0.0
    d = C.collective_flow(16, "dispatch", groups, 8, shares=(0.5, 0.25))
    assert np.array_equal(m, d if kind == "dispatch" else d.T)
    assert m.flags.c_contiguous


def test_stage_op_keeps_its_stage_rows():
    """An op of one stage sends from that stage's chiplets alone."""
    topo = _topo16()
    mesh = {"pipe": 2, "node": 2, "local": 4}
    fwd = W.collective.op_flow(topo, mesh, PS.StageOp(
        "pp_fwd", "send_next", "pipe", 3, stage=0))
    want = np.zeros((16, 16))
    want[np.arange(8), np.arange(8) + 8] = 3
    assert np.array_equal(fwd, want)
    disp = W.collective.op_flow(topo, mesh, PS.StageOp(
        "ep_dispatch", "dispatch", ("node", "local"), 4, stage=1,
        shares=(2.0, 2.0)))
    assert not disp[:8].any() and not disp[:, :8].any()
    assert np.array_equal(disp[8:].sum(axis=1), np.full(8, 4 * (2 + 6)))


# ---- the step keys --------------------------------------------------

def test_dispatch_bytes_needs_the_pipeline_mesh():
    """The pipeline scheme needs dispatch_bytes and global_batch, with
    no fallback; a TP x FSDP mesh takes no dispatch_bytes."""
    topo = T.build("mesh", 16)
    with pytest.raises(ValueError, match="dispatch_bytes"):
        W.collective_workload(get_config("qwen3_moe_235b_a22b"), topo,
                              mesh_shape={"data": 2, "model": 8},
                              dispatch_bytes=1)
    for missing in ("dispatch_bytes", "global_batch"):
        kw = _step(CONFIG["step"]["tiny_mesh"])
        del kw[missing]
        with pytest.raises(ValueError, match="needs global_batch"):
            W.collective_workload(_model(), topo, **kw)


# ---- spans and counters ----------------------------------------------

@pytest.fixture
def traced():
    TR.disable_tracing()
    TR.clear_trace()
    TR.enable_tracing()
    yield
    TR.disable_tracing()
    TR.clear_trace()


def _named(name):
    return [sp for sp in TR.get_spans() if sp.name == name]


@pytest.mark.parametrize("scheme", ["pp_ep_zero1", "tp_fsdp"])
def test_plan_collective_span_and_op_counters(traced, scheme):
    topo = _topo16()
    if scheme == "pp_ep_zero1":
        model, kw = _model(), _step(CONFIG["step"]["tiny_mesh"])
    else:
        model = get_config("qwen3_moe_235b_a22b")
        kw = dict(mesh_shape={"data": 2, "model": 8}, seq_len=2048,
                  dtype_bytes=2)
    _, ops = W.collective.step_ops(
        model, kw["mesh_shape"], seq_len=kw["seq_len"],
        global_batch=kw.get("global_batch", 0),
        dtype_bytes=kw["dtype_bytes"],
        dispatch_bytes=kw.get("dispatch_bytes", 0))
    kinds = {op.kind for op in ops}
    before = {k: metrics.get(f"collective.ops.{k}") for k in kinds}
    sched = W.collective_workload(model, topo, **kw)
    (sp,) = _named("plan.collective")
    assert sp.args["scheme"] == scheme and sp.args["n"] == 16
    assert sp.args["ops"] == len(ops)
    assert sp.args["phases"] == len(sched.phases)
    assert sp.args["bytes"] == sum(op.bytes_per_chip for op in ops)
    for k in kinds:
        assert metrics.get(f"collective.ops.{k}") - before[k] == \
            sum(op.kind == k for op in ops)


def test_phase_tables_spans(traced):
    """A workload batch records `sim.phase_tables` twice, stacking and
    uploading, with its phases, padded phases and nodes and bytes; a
    static batch records none."""
    specs, scheds = [], []
    for name, k in (("mesh", 3), ("folded_hexa_torus", 2)):
        r = build_routing(T.build(name, 16))
        specs.append(S.make_spec(r, uniform(r.topo)))
        scheds.append(W.hotspot_drift(r.topo, n_phases=k,
                                      dwell=10).compile())
    cfg = S.SimConfig(cycles=30, warmup=10)
    S.run_batch(specs, np.array([0.1], np.float32), cfg, schedules=scheds,
                device="cpu", k_pad=4)
    stack, upload = _named("sim.phase_tables")
    for sp in (stack, upload):
        assert (sp.args["k"], sp.args["k_pad"], sp.args["n_pad"]) == \
            (3, 4, 16)
    assert stack.ts < upload.ts
    # cum [2, 4, 16, 16] and inj_w [2, 4, 16] in float32, at least
    assert stack.args["bytes"] >= 4 * 2 * 4 * 16 * 17
    # the tables of 30 cycles x 2 rows beside cum and inj_w
    assert upload.args["bytes"] > 4 * 2 * 4 * 16 * 17 + 30 * 2 * 4
    TR.clear_trace()
    S.run_batch(specs, np.array([0.1], np.float32), cfg, device="cpu")
    assert _named("sim.phase_tables") == []
    assert _named("sim.stack")


def test_spans_cost_nothing_with_tracing_off():
    TR.disable_tracing()
    TR.clear_trace()
    W.collective_workload(_model(), _topo16(),
                          **_step(CONFIG["step"]["tiny_mesh"]))
    assert TR.get_spans() == []


def test_pipeline_mesh_is_named_by_its_axes():
    assert PS.is_pipeline_mesh({"pipe": 2, "node": 2, "local": 4})
    assert PS.is_pipeline_mesh({"node": 2, "pipe": 2, "local": 4})
    assert not PS.is_pipeline_mesh({"data": 2, "model": 8})
    assert not PS.is_pipeline_mesh({"pipe": 2, "data": 8})
