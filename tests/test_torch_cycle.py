"""The fused cycle kernels' CPU side (`repro_torch.kernels.cycle`): which
runs take them (`simulator._fused`), their plain versions against the
simulator's PyTorch body bit for bit, the wrappers' checks and the
argument layout shared with `csrc/cycle.cu`.  The kernels themselves
run only on the card (tests/test_torch_cuda.py)."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core import topology as T, traffic as TR  # noqa: E402
from repro_torch.core.routing import build_routing  # noqa: E402
from repro_torch.kernels.cycle import ops  # noqa: E402
from repro_torch.kernels.cycle.ref import draw_ref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops in several worker processes on one CPU: one torch
    thread each (see tests/test_torch_simulator.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STATIC = sim.SimConfig()


@pytest.mark.parametrize("device,cfg,probe,want", [
    ("cuda", STATIC, None, True),
    ("cuda:0", STATIC._replace(alloc="cuda"), None, True),
    ("cuda", STATIC, {}, True),                      # a profile's probe
    ("cuda", STATIC, {"state_bytes": 1}, True),
    ("cuda", STATIC, {"cycle": None}, False),        # an op trace
    ("cpu", STATIC, None, False),
    ("cpu", STATIC._replace(alloc="torch"), None, False),
    ("cuda", STATIC._replace(alloc="torch"), None, False),
    ("cuda", STATIC._replace(routing="adaptive"), None, True),
    ("cuda", STATIC._replace(telemetry=True), None, True),
    ("cuda", STATIC._replace(telemetry=True, telemetry_windows=2), None,
     True),
    ("cuda", STATIC._replace(routing="adaptive", telemetry=True), None,
     True),
], ids=["cuda", "cuda0_alloc_cuda", "profile_probe", "profile_bytes",
        "op_trace", "cpu", "cpu_torch", "alloc_torch", "adaptive",
        "recorder", "recorder_windows", "adaptive_recorder"])
def test_fused_path_only_where_it_applies(device, cfg, probe, want):
    """The fused kernels run exactly for (CUDA, the kernel allocator, no
    op trace), in every routing and recorder mode; the CPU,
    `alloc="torch"` and op traces keep the PyTorch body.  Decided without
    a card."""
    assert sim._fused(torch.device(device), cfg, probe) is want
    assert sim._fused(device, cfg, probe) is want


#: (topology, n) batches: HETERO of tests/test_torch_simulator.py (N 36,
#: P 8) and one whose rows straddle the kernels' warps (N 25, P 4)
BATCHES = {
    "hetero": [("mesh", 16), ("folded_hexa_torus", 36),
               ("honeycomb_mesh", 16), ("octamesh", 25)],
    "straddle": [("mesh", 25), ("honeycomb_mesh", 16), ("hexamesh", 19)],
}


def _batch(name, mode, v, **kw):
    import repro_torch.workloads as W
    specs, scheds = [], []
    for topo, n in BATCHES[name]:
        r = build_routing(T.build(topo, n))
        specs.append(sim.make_spec(r, TR.uniform(r.topo)))
        scheds.append(W.hotspot_drift(r.topo, n_phases=3,
                                      dwell=70).compile())
    cfg = sim.SimConfig(cycles=300, warmup=100, n_vcs=v, **kw)
    return (specs, np.array([0.3, 0.6], np.float32), cfg,
            scheds if mode == "workload" else None)


def _fused_equals_body(specs, rates, cfg, scheds, monkeypatch):
    """Runs the batch on the CPU through the PyTorch body, then through
    the fused path (the wrappers computing their plain versions), and
    asserts every result key equal, bit for bit and in dtype; returns the
    body's results."""
    from repro_torch.obs.metrics import metrics
    body = sim.run_batch(specs, rates, cfg, schedules=scheds, device="cpu")
    monkeypatch.setattr(sim, "_fused", lambda device, cfg, probe: True)
    before = metrics.get("sim.fused_cycles")
    launched = ops.cycle_route.launches, ops.cycle_move.launches
    fused = sim.run_batch(specs, rates, cfg, schedules=scheds,
                          device="cpu")
    assert metrics.get("sim.fused_cycles") - before == cfg.cycles
    # CPU calls compute the plain versions and count no launch
    assert (ops.cycle_route.launches, ops.cycle_move.launches) == launched
    assert sum(int(r["delivered"].sum()) for r in body) > 0
    for f, b in zip(fused, body):
        assert set(f) == set(b)
        for key in set(b) - {"pad_fill"}:
            np.testing.assert_array_equal(f[key], b[key], err_msg=key)
            assert np.asarray(f[key]).dtype == np.asarray(b[key]).dtype
    return body


@pytest.mark.parametrize("name,mode,v", [
    ("hetero", "static", 4), ("hetero", "workload", 4),
    ("straddle", "static", 1), ("straddle", "static", 2),
    ("straddle", "static", 3),
    ("straddle", "static", 8), ("straddle", "workload", 2),
    ("straddle", "workload", 8)])
def test_plain_fused_cycle_equals_torch_body(name, mode, v, monkeypatch):
    """The fused path run on the CPU, where the kernels' wrappers compute
    their plain versions (pulled deliveries and credits on int32 state),
    equals the PyTorch body in every result key, bit for bit, over 300
    cycles with a warm-up of 100 (both cross a chunk edge)."""
    _fused_equals_body(*_batch(name, mode, v), monkeypatch)


#: the adaptive and recorder modes of the fused path's CPU tests
MODES = {
    "adaptive": dict(routing="adaptive"),
    "recorder": dict(telemetry=True),
    "recorder_windows": dict(telemetry=True, telemetry_windows=3),
    "adaptive_recorder": dict(routing="adaptive", telemetry=True,
                              telemetry_windows=3),
}


@pytest.mark.parametrize("kind", list(MODES))
@pytest.mark.parametrize("name,mode,v", [
    ("hetero", "static", 4), ("hetero", "workload", 4),
    ("straddle", "static", 2), ("straddle", "workload", 8)])
def test_plain_fused_adaptive_and_recorder_equal_torch_body(
        name, mode, v, kind, monkeypatch):
    """The plain versions' adaptive lookup (packed productive ports,
    the downstream VC carried to cycle_move) and flight recorder
    (occupancy, stalls and injections in cycle_route; traversals,
    ejections and latency bins in cycle_move; 1 or 3 windows) equal the
    PyTorch body in every result key, bit for bit."""
    body = _fused_equals_body(*_batch(name, mode, v, **MODES[kind]),
                              monkeypatch)
    if "telemetry" in MODES[kind]:
        assert sum(int(r["link_busy"].sum()) for r in body) > 0
        assert sum(int(r["link_stall"].sum()) for r in body) > 0
        assert sum(int(r["lat_hist"].sum()) for r in body) > 0


def test_fused_spans_count_the_fused_cycles(monkeypatch):
    """With tracing on, each `sim.cycles` span carries `fused`, its
    cycles simulated through the fused path; 0 on the PyTorch body."""
    import importlib
    tr = importlib.import_module("repro_torch.obs.trace")
    specs, rates, cfg, _ = _batch("straddle", "static", 4)

    def fused_per_chunk():
        tr.clear_trace()
        tr.enable_tracing()
        try:
            sim.run_batch(specs[:1], rates, cfg, device="cpu")
        finally:
            tr.disable_tracing()
        spans = [sp for sp in tr.get_spans() if sp.name == "sim.cycles"]
        tr.clear_trace()
        return [sp.args["fused"] for sp in spans]

    assert fused_per_chunk() == [0, 0]
    monkeypatch.setattr(sim, "_fused", lambda device, cfg, probe: True)
    assert fused_per_chunk() == [256, 44]


def test_params_layout_matches_the_kernel_source():
    """`ops._Params` lists `CycleParams`'s fields in the source's order:
    every pointer, then the ints."""
    src = ops._SOURCE.read_text()
    body = re.search(r"struct CycleParams \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    pointers = re.findall(r"\*\s*(\w+);", body)
    ints = re.search(r"\bint (\w+(?:, \w+)*);", body).group(1).split(", ")
    assert tuple(pointers) == ops.ARGS
    assert tuple(ints) == ops.INTS
    assert [f[0] for f in ops._Params._fields_] == pointers + ints


def _state():
    """Fused-kernel arguments of a tiny static batch on the CPU."""
    specs, rates, cfg, _ = _batch("straddle", "static", 2)
    dev, _, shape, batch, rates2, kmax, _, _ = sim._prepare(
        specs[:1], rates, cfg, None, "cpu", None, None)
    lv, srow, rate, _ = sim._device_args(batch, None, kmax, rates2, cfg,
                                         dev)
    a = sim._fused_args(lv, srow, rate, None, shape.n, shape.p, shape.c,
                        shape.d, cfg)
    B, N = srow.shape[0], shape.n
    i32 = torch.int32
    a.update(u_inj=torch.zeros((4, N)), u_dst=torch.zeros((4, N)),
             vcs=torch.zeros((4, N), dtype=torch.int64),
             rr=torch.zeros(B, dtype=i32),
             delivered=torch.zeros(B, dtype=i32),
             offered=torch.zeros(B, dtype=i32),
             accepted=torch.zeros(B, dtype=i32),
             lat_node=torch.zeros((B, N), dtype=i32),
             t=torch.zeros(1, dtype=torch.int64),
             **sim._recorder_counters(cfg, B, N, shape.c, "cpu"))
    return a


@pytest.mark.parametrize("bad,exc,match", [
    (lambda a: dict(cnt=a["cnt"].long()), TypeError, "cnt must be"),
    (lambda a: dict(credits=a["credits"][:, :, :1].contiguous()),
     ValueError, "credits must be shaped"),
    (lambda a: dict(head=a["head"].transpose(0, 1).contiguous()
                    .transpose(0, 1)), ValueError, "head must be contig"),
    (lambda a: dict(t=torch.zeros(1, dtype=torch.int32)), TypeError,
     "t must be"),
    (lambda a: dict(bk=torch.zeros((3, a["srow"].shape[0]),
                                   dtype=torch.int64)),
     ValueError, "exactly in workload runs"),
    (lambda a: dict(rate=a["rate"].to("meta")), ValueError,
     "several devices"),
    (lambda a: dict(dvc=torch.zeros_like(a["op_slot"])), ValueError,
     "exactly in adaptive runs"),
    (lambda a: dict(tel_hist=torch.zeros((a["srow"].shape[0], 16),
                                         dtype=torch.int32)),
     ValueError, "exactly in recorder runs"),
    (lambda a: dict(prod=torch.zeros(a["table"].shape[:3],
                                     dtype=torch.int32),
                    dvc=torch.zeros_like(a["op_slot"]),
                    tel_busy=torch.zeros(1)),
     ValueError, "exactly in recorder runs"),
    (lambda a: dict(windows=2, meas=200), ValueError,
     "2 recorder windows need the recorder"),
], ids=["dtype", "shape", "layout", "t_dtype", "half_workload", "devices",
        "half_adaptive", "half_recorder", "adaptive_and_half_recorder",
        "windows_without_recorder"])
def test_wrappers_raise_on_what_the_kernels_do_not_take(bad, exc, match):
    a = _state()
    ops.cycle_route(a, False)                    # the good arguments run
    a = _state()
    a.update(bad(a))
    with pytest.raises(exc, match=match):
        ops.cycle_route(a, False)


def test_wrappers_refuse_missing_arguments_and_wide_routers():
    a = _state()
    del a["ticket"]
    with pytest.raises(ValueError, match="missing arguments"):
        ops.cycle_route(a, False)
    a = _state()
    B, N, PI, V, Bd = a["buf_dst"].shape
    for shape in ((B, N, 33, V, Bd), (B, N, PI, 33, Bd)):
        a["buf_dst"] = torch.zeros(shape, dtype=torch.int32)
        with pytest.raises(ValueError, match="1 <= P <= 31 ports and 1 <= "
                                             "V <= 32"):
            ops.cycle_route(a, False)


def test_draw_counts_entries_below_the_draw():
    """The plain draw: entries strictly below u, at most N - 1."""
    cum = torch.tensor([[0.25, 0.5, 0.5, 1.0], [1.0, 1.0, 1.0, 1.0],
                        [0.1, 0.2, 0.3, 0.4]])
    u = torch.tensor([0.5, 0.0, 0.9])
    assert draw_ref(cum, u).tolist() == [1, 0, 3]
    assert ops.cycle_draw(cum, u).tolist() == [1, 0, 3]
