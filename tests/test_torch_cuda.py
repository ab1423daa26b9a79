"""The port's CUDA kernels (`netstep`, `flash_attention`, `ssd_scan`), the
simulator, the synthesis search, the hazard pass and the LM serving and
training paths on the card.  Every test
here needs an NVIDIA GPU and nvcc (marker `requires_cuda`) and skips
without one; on such a machine run

    python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

This file imports only torch, numpy and the port, so it runs where the
JAX package is not installed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core import topology as T, traffic as TR  # noqa: E402
from repro_torch.core.routing import build_routing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.netstep.ops import netstep  # noqa: E402
from repro_torch.kernels.netstep.ref import netstep_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402
from repro_torch.models import Model  # noqa: E402

pytestmark = pytest.mark.requires_cuda

HETERO = [("mesh", 16), ("folded_hexa_torus", 36), ("honeycomb_mesh", 16),
          ("octamesh", 25)]
RAW = ("delivered", "offered_n", "accepted_n", "lat_sum")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(rng, shape, device):
    pi = shape[-2]
    op_slot = rng.integers(-1, pi, shape).astype(np.int32)
    eligible = (rng.uniform(size=shape) < 0.5) & (op_slot >= 0)
    return (torch.from_numpy(op_slot).to(device),
            torch.from_numpy(eligible).to(device))


def _assert_kernel_equals_plain(op_slot, eligible, rr_vc, rr_port):
    got = netstep(op_slot, eligible, rr_vc, rr_port)
    want = netstep_ref(op_slot, eligible, rr_vc, rr_port)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("rr", [0, 3, 11])
@pytest.mark.parametrize("n,pi,v", [(16, 5, 4), (100, 7, 4), (64, 31, 2)])
def test_kernel_equals_plain(cuda, n, pi, v, rr):
    op_slot, eligible = _inputs(np.random.default_rng(4), (1, n, pi, v), cuda)
    rr_t = torch.tensor([rr], dtype=torch.int32, device=cuda)
    _assert_kernel_equals_plain(op_slot, eligible, rr_t, rr_t)


@pytest.mark.parametrize("seed", range(8))
def test_kernel_equals_plain_random_batches(cuda, seed):
    rng = np.random.default_rng(seed)
    shape = (int(rng.integers(1, 9)), int(rng.integers(1, 300)),
             int(rng.integers(1, 33)), int(rng.integers(1, 9)))
    op_slot, eligible = _inputs(rng, shape, cuda)
    rr_vc = torch.from_numpy(rng.integers(0, 999, shape[0]).astype(
        np.int32)).to(cuda)
    rr_port = torch.from_numpy(rng.integers(0, 999, shape[0]).astype(
        np.int32)).to(cuda)
    _assert_kernel_equals_plain(op_slot, eligible, rr_vc, rr_port)


@pytest.mark.parametrize("v", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("pi", [1, 2, 5, 7, 8, 15, 16, 17, 31, 32])
def test_kernel_equals_plain_warp_layouts(cuda, pi, v):
    """Every router width (R = 32 // PI routers per warp), the vector-load
    widths V in {1, 2, 4, 8} and the generic V = 3, on rows of N = 13
    (no multiple of R > 1, so warps straddle rows with different rr
    pairs), with slots outside [0, PI): the cases of
    tests/test_torch_netstep_lanes.py through the kernel."""
    rng = np.random.default_rng(100 * pi + v)
    shape = (3, 13, pi, v)
    op_slot = torch.from_numpy(
        rng.integers(-2, pi + 1, shape).astype(np.int32)).to(cuda)
    eligible = torch.from_numpy(rng.uniform(size=shape) < 0.6).to(cuda)
    rr_vc, rr_port = (torch.from_numpy(rng.integers(-40, 1000, 3).astype(
        np.int32)).to(cuda) for _ in range(2))
    _assert_kernel_equals_plain(op_slot, eligible, rr_vc, rr_port)


@pytest.mark.parametrize("shape", [(40, 1, 7, 4), (9, 1, 2, 3),
                                   (7, 1000, 5, 4), (3, 4099, 31, 2)])
def test_kernel_finds_each_routers_row(cuda, shape):
    """The kernel finds a router's row by a multiply-high (N > 1) or
    takes the router itself (N = 1); rows with their own rr pairs."""
    rng = np.random.default_rng(sum(shape))
    op_slot, eligible = _inputs(rng, shape, cuda)
    rr_vc, rr_port = (torch.from_numpy(rng.integers(0, 999, shape[0]).astype(
        np.int32)).to(cuda) for _ in range(2))
    _assert_kernel_equals_plain(op_slot, eligible, rr_vc, rr_port)


def test_kernel_rejects_misaligned_inputs_and_takes_empty_ones(cuda):
    """The vector loads need aligned bases: a view at a storage offset
    raises, except at a V the kernel reads element by element.  An empty
    input returns empty outputs and launches nothing."""
    rng = np.random.default_rng(3)
    op_slot, eligible = _inputs(rng, (2, 9, 7, 4), cuda)
    rr = torch.tensor([1, 5], dtype=torch.int32, device=cuda)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    with pytest.raises(ValueError, match="aligned"):
        netstep(shifted(op_slot), eligible, rr, rr)
    with pytest.raises(ValueError, match="aligned"):
        netstep(op_slot, shifted(eligible), rr, rr)
    op3, el3 = _inputs(rng, (2, 9, 7, 3), cuda)
    _assert_kernel_equals_plain(shifted(op3), shifted(el3), rr, rr)
    for shape in ((0, 9, 7, 4), (2, 0, 7, 4), (2, 9, 0, 4), (2, 9, 7, 0)):
        before = netstep.launches
        rr_b = torch.zeros((shape[0],), dtype=torch.int32, device=cuda)
        win, vc, req = netstep(
            torch.zeros(shape, dtype=torch.int32, device=cuda),
            torch.zeros(shape, dtype=torch.bool, device=cuda), rr_b, rr_b)
        assert netstep.launches == before
        assert win.shape == shape and win.dtype == torch.bool
        assert vc.shape == req.shape == shape[:3]
        assert vc.dtype == req.dtype == torch.int32


def test_kernel_counts_launches_and_rejects_wide_routers(cuda):
    op_slot, eligible = _inputs(np.random.default_rng(0), (2, 8, 5, 4), cuda)
    rr = torch.zeros((2,), dtype=torch.int32, device=cuda)
    before = netstep.launches
    netstep(op_slot, eligible, rr, rr)
    assert netstep.launches == before + 1
    wide, wide_el = _inputs(np.random.default_rng(0), (2, 8, 33, 4), cuda)
    with pytest.raises(ValueError, match="PI <= 32"):
        netstep(wide, wide_el, rr, rr)


def test_hash_bits_on_card_equal_cpu(cuda):
    t = torch.arange(0, 70_000, 997, dtype=torch.int64).view(-1, 1)
    nodes = torch.arange(300, dtype=torch.int64)
    for stream in (0, 1, 2):
        cpu = sim._node_bits(7, t, nodes, stream)
        gpu = sim._node_bits(7, t.to(cuda), nodes.to(cuda), stream)
        assert torch.equal(gpu.cpu(), cpu)


def test_simulator_kernel_equals_plain_and_cpu(cuda):
    specs = []
    for name, n in HETERO:
        r = build_routing(T.build(name, n))
        specs.append(sim.make_spec(r, TR.uniform(r.topo)))
    rates = np.array([0.05, 0.15, 0.3, 0.6], np.float32)
    cfg = sim.SimConfig(cycles=300, warmup=100)
    before = netstep.launches
    kernel = sim.run_batch(specs, rates, cfg, device=cuda)
    assert netstep.launches - before == cfg.cycles
    plain = sim.run_batch(specs, rates, cfg._replace(alloc="torch"),
                          device=cuda)
    cpu = sim.run_batch(specs, rates, cfg, device="cpu")
    for k, p, c in zip(kernel, plain, cpu):
        for key in RAW:
            np.testing.assert_array_equal(k[key], p[key], err_msg=key)
            np.testing.assert_array_equal(k[key], c[key], err_msg=key)


@pytest.mark.parametrize("kw", [
    dict(routing="adaptive"), dict(telemetry=True, telemetry_windows=3),
    dict(routing="adaptive", telemetry=True, telemetry_windows=3)],
    ids=["adaptive", "recorder", "adaptive_recorder"])
def test_simulator_modes_kernel_equal_plain_and_cpu(cuda, kw):
    """Adaptive routing and the flight recorder on the card: every result
    key equal with the kernel, the plain allocator and on the CPU."""
    specs = []
    for name, n in HETERO:
        r = build_routing(T.build(name, n))
        specs.append(sim.make_spec(r, TR.uniform(r.topo)))
    rates = np.array([0.05, 0.3, 0.6], np.float32)
    cfg = sim.SimConfig(cycles=240, warmup=80, **kw)
    before = netstep.launches
    kernel = sim.run_batch(specs, rates, cfg, device=cuda)
    assert netstep.launches - before == cfg.cycles
    plain = sim.run_batch(specs, rates, cfg._replace(alloc="torch"),
                          device=cuda)
    cpu = sim.run_batch(specs, rates, cfg, device="cpu")
    for k, p, c in zip(kernel, plain, cpu):
        assert set(k) == set(p) == set(c)
        for key in set(k) - {"pad_fill"}:
            for other in (p, c):
                np.testing.assert_array_equal(k[key], other[key],
                                              err_msg=key)
                assert k[key].dtype == other[key].dtype, key


def test_search_kernel_equals_plain_and_cpu(cuda):
    """The synthesis search at the resume config (tests/test_torch_synth.py)
    with the kernel equals the same search with the plain allocator on
    the card and on the CPU: pool, ledger, metrics and front."""
    from repro_torch import synth as S

    def record(res):
        st = res.state
        return ([(c.topo.structural_hash(), c.analytic, c.sim)
                 for c in st.pool], st.rejected, st.stats,
                [c.topo.name for c in res.front()])
    cfg = S.SearchConfig(n=16, n_random=6, generations=2, offspring=6,
                         sim_top=2, n_rates=2,
                         cfg=sim.SimConfig(cycles=240, warmup=80))
    before = netstep.launches
    kernel = S.run_search(cfg, device=cuda)
    assert netstep.launches > before
    plain = S.run_search(dataclasses.replace(
        cfg, cfg=cfg.cfg._replace(alloc="torch")), device=cuda)
    cpu = S.run_search(cfg, device="cpu")
    assert record(kernel) == record(plain) == record(cpu)


#: the loop's four modes; 300 cycles (not a multiple of the 256-cycle
#: chunk) with a warm-up of 100 (off a chunk edge)
GRAPH_MODES = {
    "static": dict(),
    "workload": dict(),
    "adaptive": dict(routing="adaptive"),
    "recorder": dict(telemetry=True, telemetry_windows=3),
}


def _graph_batch(mode):
    """(specs, rates, cfg, schedules) of the HETERO batch in `mode`."""
    import repro_torch.workloads as W
    specs, scheds = [], []
    for name, n in HETERO:
        r = build_routing(T.build(name, n))
        specs.append(sim.make_spec(r, TR.uniform(r.topo)))
        scheds.append(W.hotspot_drift(r.topo, n_phases=3,
                                      dwell=70).compile())
    cfg = sim.SimConfig(cycles=300, warmup=100, **GRAPH_MODES[mode])
    return (specs, np.array([0.05, 0.3, 0.6], np.float32), cfg,
            scheds if mode == "workload" else None)


def _assert_same_results(got, want):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in set(g) - {"pad_fill"}:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype


@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_graphed_loop_equals_eager_and_cpu(cuda, mode, monkeypatch):
    """Each mode replayed from CUDA graphs equals the same body run
    eagerly on the card and the CPU run, every result key bit for bit;
    the spans count the replays (all cycles but each body's first) and
    `netstep.launches` grows by exactly the cycles run."""
    import importlib
    tr = importlib.import_module("repro_torch.obs.trace")
    specs, rates, cfg, scheds = _graph_batch(mode)
    tr.clear_trace()
    tr.enable_tracing()
    before = netstep.launches
    try:
        graphed = sim.run_batch(specs, rates, cfg, schedules=scheds,
                                device=cuda)
    finally:
        tr.disable_tracing()
    launched = netstep.launches - before
    chunks = [sp for sp in tr.get_spans() if sp.name == "sim.cycles"]
    tr.clear_trace()
    assert launched == cfg.cycles
    assert sum(sp.args["graphed"] for sp in chunks) == cfg.cycles - 2
    assert all("alloc_calls" not in sp.args for sp in chunks)
    monkeypatch.setattr(sim, "_graphed", lambda device, probe: False)
    before = netstep.launches
    eager = sim.run_batch(specs, rates, cfg, schedules=scheds, device=cuda)
    assert netstep.launches - before == cfg.cycles
    cpu = sim.run_batch(specs, rates, cfg, schedules=scheds, device="cpu")
    _assert_same_results(graphed, eager)
    _assert_same_results(graphed, cpu)


@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_graphed_loop_never_waits_for_the_card(cuda, mode):
    """The graphed loop, eager cycles and captures included, runs under
    `torch.cuda.set_sync_debug_mode("error")` (the batch is uploaded and
    read back outside it)."""
    specs, rates, cfg, scheds = _graph_batch(mode)
    dev, _, shape, batch, rates2, kmax, _, _ = sim._prepare(
        specs, rates, cfg, None, cuda, scheds, None)
    sbatch = None
    if scheds is not None:
        from repro_torch.sweep.padding import stack_schedules
        sbatch, kmax = stack_schedules(scheds, shape.n, None)
    lv, srow, rate, sched = sim._device_args(batch, sbatch, kmax, rates2,
                                             cfg, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        raw = sim._simulate_rows(lv, srow, rate, shape.n, shape.p, shape.c,
                                 shape.d, cfg, netstep, sched)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(raw[0].sum()) > 0


def test_graphed_runs_leave_memory_where_it_started(cuda):
    """Back-to-back runs of two group shapes release their graphs and
    the graphs' memory pools: allocated memory returns to where it
    started after each run, and no graph holds a pool afterwards, so
    emptying the allocator's cache returns every reserved byte."""
    specs, rates, cfg, _ = _graph_batch("static")
    shapes = (specs[:2], specs[2:])
    for group in shapes:                     # build and load the kernel
        sim.run_batch(group, rates, cfg, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    for _ in range(3):
        for group in shapes:
            sim.run_batch(group, rates, cfg, device=cuda)
            torch.cuda.synchronize()
            assert torch.cuda.memory_allocated() == allocated
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= reserved


#: batches of the fused-kernel tests: HETERO (N 36, P 8: PI 9, three
#: routers a warp, 12 a row) and one whose rows straddle warps (N 25, P
#: 4: PI 5, six routers a warp), both with heterogeneous N and P
FUSED_BATCHES = {
    "hetero": HETERO,
    "straddle": [("mesh", 25), ("honeycomb_mesh", 16), ("hexamesh", 19)],
}


def _fused_batch(batch, mode, v, **kw):
    """(specs, rates, cfg, schedules) of a fused-kernel test: 300 cycles
    with a warm-up of 100, so both bodies cross a chunk edge; `kw` adds
    to the SimConfig."""
    import repro_torch.workloads as W
    specs, scheds = [], []
    for name, n in FUSED_BATCHES[batch]:
        r = build_routing(T.build(name, n))
        specs.append(sim.make_spec(r, TR.uniform(r.topo)))
        scheds.append(W.hotspot_drift(r.topo, n_phases=3,
                                      dwell=70).compile())
    cfg = sim.SimConfig(cycles=300, warmup=100, n_vcs=v, **kw)
    return (specs, np.array([0.05, 0.3, 0.6], np.float32), cfg,
            scheds if mode == "workload" else None)


#: the adaptive and recorder modes of the fused-kernel tests: W = 0 and 3
FUSED_MODES = {
    "adaptive": dict(routing="adaptive"),
    "recorder": dict(telemetry=True),
    "recorder_windows": dict(telemetry=True, telemetry_windows=3),
    "adaptive_recorder": dict(routing="adaptive", telemetry=True,
                              telemetry_windows=3),
}


@pytest.mark.parametrize("batch", list(FUSED_BATCHES))
@pytest.mark.parametrize("mode,v,kind", [
    pytest.param(m, v, None, id=f"{m}-{v}") for m, v in (
        ("static", 1), ("static", 2), ("static", 3), ("static", 4),
        ("static", 8), ("workload", 2), ("workload", 4), ("workload", 8))
] + [
    pytest.param(m, v, kind, id=f"{m}-{v}-{kind}")
    for kind in FUSED_MODES for m in ("static", "workload")
    for v in (2, 4, 8)])
def test_fused_kernels_equal_torch_body_and_cpu(cuda, batch, mode, v, kind,
                                                monkeypatch):
    """The fused cycle kernels (graphed, the card's default in every
    mode) equal the PyTorch body on the card (the predicate patched off)
    and the CPU run, every result key bit for bit; V = 3 takes the
    kernels' generic instantiation, and adaptive routing and the flight
    recorder (1 or 3 windows) their own."""
    from repro_torch.kernels.cycle.ops import cycle_move, cycle_route
    from repro_torch.obs.metrics import metrics
    specs, rates, cfg, scheds = _fused_batch(batch, mode, v,
                                             **FUSED_MODES.get(kind, {}))
    assert sim._fused(cuda, cfg, None)
    before = metrics.get("sim.fused_cycles")
    launched = netstep.launches, cycle_route.launches, cycle_move.launches
    fused = sim.run_batch(specs, rates, cfg, schedules=scheds, device=cuda)
    assert metrics.get("sim.fused_cycles") - before == cfg.cycles
    assert [n - b for n, b in zip((netstep.launches, cycle_route.launches,
                                   cycle_move.launches), launched)] == \
        [cfg.cycles] * 3
    monkeypatch.setattr(sim, "_fused", lambda device, cfg, probe: False)
    body = sim.run_batch(specs, rates, cfg, schedules=scheds, device=cuda)
    assert metrics.get("sim.fused_cycles") - before == cfg.cycles
    cpu = sim.run_batch(specs, rates, cfg, schedules=scheds, device="cpu")
    _assert_same_results(fused, body)
    _assert_same_results(fused, cpu)


def test_fused_kernels_run_eagerly_too(cuda, monkeypatch):
    """Without graphs (`_graphed` patched off) every cycle launches the
    fused kernels from Python, and the results are the same."""
    specs, rates, cfg, scheds = _fused_batch("straddle", "workload", 4)
    graphed = sim.run_batch(specs, rates, cfg, schedules=scheds,
                            device=cuda)
    monkeypatch.setattr(sim, "_graphed", lambda device, probe: False)
    eager = sim.run_batch(specs, rates, cfg, schedules=scheds, device=cuda)
    _assert_same_results(graphed, eager)


@pytest.mark.parametrize("n", [1, 2, 7, 36, 256, 300])
def test_fused_draw_equals_linear_count(cuda, n):
    """The kernels' binary-search destination draw equals the linear count
    `(cum < u).sum().clamp(0, N - 1)` of the PyTorch body on random
    cumulative rows with pad columns (1.0) and pad rows, for draws on the
    simulator's 24-bit grid, draws equal to an entry, 0 and the last
    value below 1."""
    from repro_torch.kernels.cycle.ops import cycle_draw
    from repro_torch.kernels.cycle.ref import draw_ref
    rng = np.random.default_rng(n)
    rows = 4096
    w = rng.exponential(size=(rows, n)) * (rng.uniform(size=(rows, n))
                                           < 0.7)
    cum = np.cumsum(w, axis=1)
    cum = cum / np.maximum(cum[:, -1:], 1e-12)
    cum[cum[:, -1] <= 0] = 1.0
    live = rng.integers(1, n + 1, rows)
    cum[np.arange(n)[None, :] >= live[:, None]] = 1.0     # pad columns
    cum[rng.uniform(size=rows) < 0.05] = 1.0              # pad rows
    cum = cum.astype(np.float32)
    u = (rng.integers(0, 1 << 24, rows) * (1.0 / (1 << 24))).astype(
        np.float32)
    tie = rng.uniform(size=rows) < 0.25
    u[tie] = cum[tie, rng.integers(0, n, rows)[tie]]
    u[:64] = 0.0
    u[64:128] = np.float32(1.0 - 2.0 ** -24)
    cum_t, u_t = torch.from_numpy(cum), torch.from_numpy(u)
    got = cycle_draw(cum_t.to(cuda), u_t.to(cuda))
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), draw_ref(cum_t, u_t))


@pytest.mark.parametrize("kw", [
    dict(), dict(routing="adaptive"),
    dict(telemetry=True, telemetry_windows=3)],
    ids=["static", "adaptive", "recorder"])
def test_fused_cycles_counted_where_the_kernels_ran(cuda, kw):
    """`sim.fused_cycles` and the `sim.cycles` spans' `fused` count the
    cycles simulated through the fused kernels: all of a run's on the
    card with the kernel allocator, static, adaptive or with the
    recorder alike."""
    import importlib
    tr = importlib.import_module("repro_torch.obs.trace")
    from repro_torch.obs.metrics import metrics
    specs, rates, cfg, _ = _graph_batch("static")
    cfg = cfg._replace(**kw)
    want = cfg.cycles
    before = metrics.get("sim.fused_cycles")
    tr.clear_trace()
    tr.enable_tracing()
    try:
        sim.run_batch(specs, rates, cfg, device=cuda)
    finally:
        tr.disable_tracing()
    chunks = [sp for sp in tr.get_spans() if sp.name == "sim.cycles"]
    tr.clear_trace()
    assert metrics.get("sim.fused_cycles") - before == want
    assert sum(sp.args["fused"] for sp in chunks) == want


@pytest.mark.parametrize("mode", ["static", "workload"])
def test_profiler_sees_each_netstep_launch_once(cuda, mode):
    """Under torch.profiler the card's kernels whose names hold
    "netstep" number exactly `netstep.launches` of the run (the fused
    kernels' names do not hold it), and each fused kernel runs once a
    cycle."""
    from torch.profiler import ProfilerActivity, profile
    specs, rates, cfg, scheds = _fused_batch("straddle", mode, 4)
    sim.run_batch(specs, rates, cfg, schedules=scheds, device=cuda)
    for _ in range(3):
        torch.cuda.synchronize()
        before = netstep.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sim.run_batch(specs, rates, cfg, schedules=scheds, device=cuda)
            torch.cuda.synchronize()
        made = netstep.launches - before
        counts: dict = {}
        for e in prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                counts[e.name()] = counts.get(e.name(), 0) + 1
        seen = sum(c for k, c in counts.items() if "netstep" in k)
        if seen:
            break
    assert made == cfg.cycles
    assert seen == made
    for kernel in ("cycle_route", "cycle_move"):
        assert sum(c for k, c in counts.items() if kernel in k) == \
            cfg.cycles, kernel


@pytest.mark.parametrize("kw", [
    dict(), dict(routing="adaptive"),
    dict(telemetry=True, telemetry_windows=2),
    dict(routing="adaptive", telemetry=True)],
    ids=["static", "adaptive", "recorder", "adaptive_recorder"])
def test_hazard_pass_logs_its_cycles_on_the_card(cuda, kw):
    """Every mode of the loop: its ops on the card, and no wait of the
    host for the card inside it (the card's sync watch is on)."""
    from repro_torch.analysis import runner_hazards as H
    specs = []
    for name, n in HETERO:
        r = build_routing(T.build(name, n))
        specs.append(sim.make_spec(r, TR.uniform(r.topo)))
    before = netstep.launches
    log, _, _ = sim.trace_batch(specs, [0.1, 0.3], sim.SimConfig(**kw),
                                device=cuda)
    assert not [r for r in H.loop_ops(log) if r.synced]
    assert netstep.launches - before == sim.TRACE_CYCLES
    loop = H.loop_ops(log)
    assert loop and any("cuda" in r.out_devices for r in loop)
    assert set(H.host_side_ops(log, "cuda")) <= set(H.HOST_SIDE_OPS)
    found = H.check_host_sync(log) + H.check_dtype_promotions(log)
    assert set(H.findings(found)) == set(H.INTENDED)


def test_card_watch_marks_every_wait_for_the_card(cuda):
    """On the card the op log also marks each op whose call made the
    host wait: a blocking upload and a Python number written through an
    index, which no name rule counts, as well as `.item()` and a
    boolean-mask index."""
    from repro_torch.analysis import runner_hazards as H
    x = torch.arange(12, dtype=torch.float32, device=cuda).view(3, 4)
    rows = torch.tensor([0, 2], device=cuda)
    probe = {"cycle": 0}
    with sim.log_ops(probe) as log:
        x.sum().item()
        x[x > 5]
        torch.ones(4).to(cuda)
        x[rows] = 7.0
        probe["cycle"] = 1
        x + 1
    synced = [(r.op.split(".")[1], r.cycle) for r in log if r.synced]
    assert synced == [("_local_scalar_dense", 0), ("index", 0),
                      ("_to_copy", 0), ("index_put_", 0)]
    assert all(r.synced.startswith("test_torch_cuda.py:")
               for r in log if r.synced)
    found = {d.witness_dict()["op"] for d in H.check_host_sync(log)}
    assert found == {"aten._local_scalar_dense", "aten.index",
                     "aten._to_copy", "aten.index_put_"}
    assert torch.cuda.get_sync_debug_mode() == 0


# ---------------------------------------------------------------------
# flash attention and SSD scan against their plain versions
# ---------------------------------------------------------------------

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(
        device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("tq,tk,causal,window", [
    (128, 128, True, None), (256, 256, True, None), (128, 256, False, None),
    (256, 256, True, 128), (128, 128, True, 64)])
def test_flash_kernel_matches_plain(cuda, tq, tk, causal, window, hd, dtype):
    rng = np.random.default_rng(0)
    q = _randn(rng, (2, tq, 4, hd), dtype, cuda)
    k = _randn(rng, (2, tk, 2, hd), dtype, cuda)
    v = _randn(rng, (2, tk, 2, hd), dtype, cuda)
    before = fops.flash_attention.launches
    got = fops.flash_attention(q, k, v, causal=causal, window=window)
    assert fops.flash_attention.launches == before + 1
    want = fops.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_kernel_matches_plain_at_serving_shape(cuda):
    """qwen3-1.7b's prefill: batch 4, prompt 1024, 16 q heads over 8 kv
    heads of 128, bf16, causal: the tensor-core route."""
    rng = np.random.default_rng(1)
    q = _randn(rng, (4, 1024, 16, 128), torch.bfloat16, cuda)
    k = _randn(rng, (4, 1024, 8, 128), torch.bfloat16, cuda)
    v = _randn(rng, (4, 1024, 8, 128), torch.bfloat16, cuda)
    got = fops.flash_attention(q, k, v, causal=True)
    want = fops.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_f32_kernel_matches_plain_at_serving_shape(cuda):
    """The same shape in float32: the CUDA-core route, exact f32 products."""
    rng = np.random.default_rng(9)
    q = _randn(rng, (4, 1024, 16, 128), torch.float32, cuda)
    k = _randn(rng, (4, 1024, 8, 128), torch.float32, cuda)
    v = _randn(rng, (4, 1024, 8, 128), torch.float32, cuda)
    got = fops.flash_attention(q, k, v, causal=True)
    want = fops.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,hd", [(16, 16, 64), (64, 4, 128)])
def test_flash_kernel_matches_plain_at_families_shapes(cuda, h, kv, hd,
                                                       dtype):
    """seamless-m4t-medium's decoder (hd 64, 16 q heads over 16 kv heads)
    and qwen3-moe-235b-a22b (a GQA group of 16) at prompt 1024, batch 2."""
    rng = np.random.default_rng(17)
    q = _randn(rng, (2, 1024, h, hd), dtype, cuda)
    k = _randn(rng, (2, 1024, kv, hd), dtype, cuda)
    v = _randn(rng, (2, 1024, kv, hd), dtype, cuda)
    got = fops.flash_attention(q, k, v, causal=True)
    want = fops.flash_attention_plain(q, k, v, causal=True)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_at_gemma3_shape(cuda, dtype):
    """gemma3-1b's prefill at batch 1: 4 q heads over 1 kv head of 256,
    prompt 2048, causal, global (no window) and local (window 1024)."""
    rng = np.random.default_rng(10)
    q = _randn(rng, (1, 2048, 4, 256), dtype, cuda)
    k = _randn(rng, (1, 2048, 1, 256), dtype, cuda)
    v = _randn(rng, (1, 2048, 1, 256), dtype, cuda)
    tol = FLASH_TOL[dtype]
    for window in (None, 1024):
        got = fops.flash_attention(q, k, v, causal=True, window=window)
        want = fops.flash_attention_plain(q, k, v, causal=True, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("h,kv,tq", [(3, 1, 192), (6, 2, 64), (4, 4, 320)])
def test_flash_bf16_kernel_pairs_heads_and_tiles(cuda, h, kv, tq):
    """The bf16 kernel's two warpgroups share a block: two q heads of one
    kv head when H / KV is even, else two q tiles of one head (an odd tile
    count leaves the last block one tile)."""
    rng = np.random.default_rng(8)
    q = _randn(rng, (2, tq, h, 64), torch.bfloat16, cuda)
    k = _randn(rng, (2, tq, kv, 64), torch.bfloat16, cuda)
    v = _randn(rng, (2, tq, kv, 64), torch.bfloat16, cuda)
    for window in (None, 96):
        got = fops.flash_attention(q, k, v, causal=True, window=window)
        want = fops.flash_attention_plain(q, k, v, causal=True, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    rng = np.random.default_rng(2)
    q = _randn(rng, (1, 128, 2, 64), torch.float32, cuda)
    # hd 48 is still refused: the kernels take 16, 32, 64, 128 and 256
    with pytest.raises(ValueError, match=r"hd in \(16, 32, 64, 128, 256\), "
                                         r"not 48"):
        fops.flash_attention(q[..., :48], q[..., :48], q[..., :48])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="multiples of 64"):
        fops.flash_attention(q[:, :96], q[:, :96], q[:, :96])
    wide = _randn(rng, (1, 128, 2, 128), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fops.flash_attention(wide[..., ::2], wide[..., ::2], wide[..., ::2])
    odd = _randn(rng, (1, 128, 2, 64), torch.bfloat16, cuda).flatten()
    shifted = odd[1:1 + 128 * 2 * 32].view(1, 128, 2, 32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fops.flash_attention(shifted, shifted, shifted)


def _ssd_inputs(rng, b, t, h, p, n, dtype, device):
    x = _randn(rng, (b, t, h, p), dtype, device)
    dt = torch.from_numpy(rng.uniform(0.05, 0.9, (b, t, h)).astype(
        np.float32)).to(device)
    a = -torch.from_numpy(rng.uniform(0.3, 2.0, (h,)).astype(
        np.float32)).to(device)
    return (x, dt, a, _randn(rng, (b, t, n), dtype, device),
            _randn(rng, (b, t, n), dtype, device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,p,n,chunk", [
    (2, 64, 4, 8, 16, 16), (1, 128, 2, 16, 8, 32), (3, 32, 8, 4, 4, 8),
    (1, 512, 4, 64, 128, 256)])
def test_ssd_kernel_matches_plain(cuda, b, t, h, p, n, chunk, dtype):
    args = _ssd_inputs(np.random.default_rng(3), b, t, h, p, n, dtype, cuda)
    before = sops.ssd_scan.launches
    y, s = sops.ssd_scan(*args, chunk=chunk)
    assert sops.ssd_scan.launches == before + 1
    yr, sr = sops.ssd_ref(*args, chunk)
    torch.cuda.synchronize()
    tol = SSD_TOL[dtype]
    assert y.dtype == dtype and s.dtype == torch.float32
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(s, sr, atol=tol, rtol=tol)


def test_ssd_kernel_stays_finite_under_strong_decay(cuda):
    """exp(cum_q - cum_k) above the diagonal would overflow here; the
    kernel never takes it."""
    x, dt, a, bm, cm = _ssd_inputs(np.random.default_rng(5), 1, 64, 2, 4, 4,
                                   torch.float32, cuda)
    a = torch.tensor([-60.0, -0.5], device=cuda)
    y, s = sops.ssd_scan(x, dt, a, bm, cm, chunk=32)
    yr, sr = sops.ssd_ref(x, dt, a, bm, cm, 32)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)


def test_ssd_bf16_kernel_stays_finite_under_strong_decay(cuda):
    """The same through the tensor-core route."""
    x, dt, a, bm, cm = _ssd_inputs(np.random.default_rng(5), 1, 64, 2, 4, 4,
                                   torch.bfloat16, cuda)
    a = torch.tensor([-60.0, -0.5], device=cuda)
    y, s = sops.ssd_scan(x, dt, a, bm, cm, chunk=32)
    yr, sr = sops.ssd_ref(x, dt, a, bm, cm, 32)
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y.float(), yr.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(s, sr, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("b,t,h,p,n,chunk", [
    (1, 96, 2, 8, 8, 48), (2, 16, 4, 16, 16, 8), (2, 40, 3, 12, 20, 20),
    (1, 320, 2, 72, 136, 160), (4, 1024, 64, 64, 128, 256),
    (4, 1024, 128, 64, 64, 256)])
def test_ssd_bf16_kernel_takes_any_chunk(cuda, b, t, h, p, n, chunk):
    """The tensor-core route tiles Q, P and N itself (zero-filled ragged
    tiles): chunks that are no multiple of 32, the smoke config (P 16,
    chunk 8), P and N past one tile, and mamba2-1.3b's and
    jamba-v0.1-52b's prefill shapes."""
    args = _ssd_inputs(np.random.default_rng(13), b, t, h, p, n,
                       torch.bfloat16, cuda)
    before = sops.ssd_scan.launches
    y, s = sops.ssd_scan(*args, chunk=chunk)
    assert sops.ssd_scan.launches == before + 1
    yr, sr = sops.ssd_ref(*args, chunk)
    torch.testing.assert_close(y.float(), yr.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(s, sr, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("b,t,h,p,n,chunk", [(4, 1024, 64, 64, 128, 256),
                                           (4, 1024, 128, 64, 64, 256)])
def test_ssd_bf16_kernel_keeps_outputs_near_zero(cuda, b, t, h, p, n, chunk):
    """At the serving shapes an output near 0 sums terms of about 100 that
    cancel.  With plain TF32 operands such an output could miss the
    route's 3e-2 against the plain version; with every f32 operand split
    into TF32 hi + lo the kernel stays within 0.02 of the f64 value (the
    plain bf16 path: about 0.002)."""
    args = _ssd_inputs(np.random.default_rng(23), b, t, h, p, n,
                       torch.bfloat16, cuda)
    y, _ = sops.ssd_scan(*args, chunk=chunk)
    y64, _ = sops.ssd_ref(*(v.double() for v in args), chunk)
    small = y64.abs() < 1
    assert int(small.sum()) > 10_000
    assert float((y.double() - y64).abs()[small].max()) <= 0.02


def test_ssd_kernel_rejects_what_it_does_not_take(cuda):
    """The f32 route keeps its tiles (chunk <= 32 or a multiple of 32) and
    its shared memory; the bf16 route takes both shapes."""
    x, dt, a, bm, cm = _ssd_inputs(np.random.default_rng(6), 1, 96, 2, 8, 8,
                                   torch.float32, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sops.ssd_scan(x.half(), dt, a, bm.half(), cm.half(), chunk=32)
    with pytest.raises(ValueError, match="multiple of 32"):
        sops.ssd_scan(x, dt, a, bm, cm, chunk=48)
    with pytest.raises(ValueError, match="contiguous"):
        sops.ssd_scan(x, dt, a, bm.transpose(1, 2).contiguous()
                      .transpose(1, 2), cm, chunk=32)
    big = _ssd_inputs(np.random.default_rng(7), 1, 256, 1, 256, 256,
                      torch.float32, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        sops.ssd_scan(*big, chunk=256)
    bf = torch.bfloat16
    sops.ssd_scan(x.to(bf), dt, a, bm.to(bf), cm.to(bf), chunk=48)
    sops.ssd_scan(big[0].to(bf), big[1], big[2], big[3].to(bf),
                  big[4].to(bf), chunk=256)
    with pytest.raises(ValueError, match="contiguous"):
        sops.ssd_scan(x.to(bf), dt, a, bm.to(bf).transpose(1, 2)
                      .contiguous().transpose(1, 2), cm.to(bf), chunk=32)


@pytest.mark.parametrize("arch,t,flash,ssd", [
    ("qwen3-1.7b", 128, 2, 0), ("mamba2-1.3b", 16, 0, 2),
    ("seamless-m4t-medium", 128, 2, 0), ("jamba-v0.1-52b", 128, 1, 3)])
def test_prefill_launches_each_layers_kernel(cuda, arch, t, flash, ssd):
    """With the kernel flags on, every layer's prefill goes through its
    kernel once (an encoder-decoder's decoder self-attention only, not its
    encoder or cross attention), and the logits agree with the plain
    path's."""
    import dataclasses
    cfg = get_config(arch, smoke=True)
    model = Model(dataclasses.replace(
        cfg, use_flash_kernel=True, use_ssd_kernel=True)).init(
        torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, t))).to(cuda)
    frames = (torch.from_numpy(rng.normal(0, 0.02, (2, t, cfg.d_model))
                               .astype(np.float32)).to(cuda)
              if cfg.arch_kind == "encdec" else None)
    before = (fops.flash_attention.launches, sops.ssd_scan.launches)
    logits, _ = model.prefill(tokens, frames)
    after = (fops.flash_attention.launches, sops.ssd_scan.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (flash, ssd)
    model.cfg = dataclasses.replace(model.cfg, use_flash_kernel=False,
                                    use_ssd_kernel=False)
    plain, _ = model.prefill(tokens, frames)
    torch.testing.assert_close(logits.float(), plain.float(), atol=0.08,
                               rtol=0.08)


def test_kernel_wrappers_refuse_autograd_on_card(cuda):
    """The CUDA kernels' outputs carry no gradient, so with grad enabled
    an input that requires grad raises before any launch, and a model
    with the kernel flags set refuses its differentiable forward."""
    q = torch.randn((1, 128, 4, 64), device=cuda, requires_grad=True)
    k = torch.randn((1, 128, 2, 64), device=cuda)
    before = fops.flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fops.flash_attention(q, k, k)
    x = torch.randn((1, 32, 2, 8), device=cuda, requires_grad=True)
    dt = torch.rand((1, 32, 2), device=cuda) * 0.8 + 0.05
    a = -torch.rand((2,), device=cuda) - 0.3
    bm = torch.randn((1, 32, 8), device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        sops.ssd_scan(x, dt, a, bm, bm, chunk=16)
    assert fops.flash_attention.launches == before
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              use_flash_kernel=True)
    model = Model(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.zeros((1, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss_fn(model.param_tree(), {"tokens": toks, "labels": toks})


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-1b", "mamba2-1.3b"])
def test_train_step_on_card_equals_cpu(cuda, arch, microbatches):
    """One float32 train step of a smoke config on the card and on the CPU
    (the path the CPU tests hold against the JAX package): loss, grad
    norm and every updated parameter within 1e-4."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import steps as St
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=torch.float32)
    models = [Model(cfg).init(torch.Generator().manual_seed(0))
              for _ in range(2)]
    models[0].to(cuda)
    batch = SyntheticLMData(vocab=cfg.vocab, seq_len=32, global_batch=4,
                            seed=0).batch(0)
    out = []
    for model in models:
        step = St.make_train_step(model, St.TrainConfig(
            microbatches=microbatches, warmup_steps=2))
        loss, gn = step(adamw_init(model.param_tree()),
                        {k: torch.from_numpy(v).to(model.device)
                         for k, v in batch.items()})
        out.append((float(loss), float(gn)))
    assert out[0] == pytest.approx(out[1], rel=1e-4, abs=1e-4)
    card, cpu = (m.state_dict() for m in models)
    for name in cpu:
        torch.testing.assert_close(card[name].cpu(), cpu[name], atol=1e-4,
                                   rtol=1e-4)


def test_train_driver_on_card_resumes(cuda, tmp_path):
    """The driver on the card (its default device): 8 steps with a
    checkpoint at 4; stopped after it and resumed, it takes the same
    steps."""
    import os
    import shutil
    from repro_torch.launch import train
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "8", "--batch",
            "4", "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "4", "--log-every", "100"]
    full = train.run(train.parse_args(argv))
    assert all(np.isfinite(r["loss"]) for r in full)
    shutil.rmtree(os.path.join(tmp_path, "step_00000008"))
    resumed = train.run(train.parse_args(argv))
    assert [r["step"] for r in resumed] == [4, 5, 6, 7]
    for a, b in zip(full[4:], resumed):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-6, abs=1e-6)


# ---------------------------------------------------------------------
# the model families: MoE's grouped route, MLA, the encoder-decoder
# ---------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 256])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "grok-1-314b",
                                  "jamba-v0.1-52b"])
def test_moe_grouped_route_equals_loop_on_card(cuda, arch, t):
    """bf16 on the card takes the grouped route (`torch._grouped_mm`, the
    group offsets on the card); it computes the per-expert loop's layer
    at a decode and a prefill token count, and waits for the card at no
    point (the loop waits once, for the group ends)."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import make_moe_apply
    cfg = get_config(arch, smoke=True)
    model = Model(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    lp = next(lp for lp, s in zip(model.layers, model.specs) if s["moe"])
    params = {k: v.detach().to(torch.bfloat16) for k, v in lp["moe"].items()}
    x = torch.randn((4, t, cfg.d_model), device=cuda).to(torch.bfloat16)
    assert L.moe_route(x) == "grouped"
    apply = make_moe_apply(cfg)
    out, waits = {}, {}
    orig = L.moe_route
    for route in ("grouped", "loop"):
        torch.cuda.synchronize()
        try:
            L.moe_route = lambda x, route=route: route
            with sim.log_ops({}) as log:
                out[route] = apply(params, x)
        finally:
            L.moe_route = orig
        waits[route] = sum(1 for op in log if op.synced)
    (got, aux), (want, aux2) = out["grouped"], out["loop"]
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    assert float(aux) == float(aux2)
    assert waits == {"grouped": 0, "loop": 1}


@pytest.mark.parametrize("arch", ["minicpm3-4b", "seamless-m4t-medium",
                                  "qwen3-moe-235b-a22b", "grok-1-314b",
                                  "jamba-v0.1-52b"])
def test_families_on_card_equal_cpu(cuda, arch):
    """float32 prefill and three decode steps of each family's smoke
    config on the card and on the CPU (the path the CPU tests hold against
    the JAX package) within 1e-4."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=torch.float32)
    cpu = Model(cfg).init(torch.Generator().manual_seed(0))
    card = Model(cfg).init(torch.Generator().manual_seed(0)).to(cuda)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
    frames = (torch.from_numpy(rng.normal(0, 0.02, (2, 16, cfg.d_model))
                               .astype(np.float32))
              if cfg.arch_kind == "encdec" else None)
    outs = []
    for model, dev in ((card, cuda), (cpu, torch.device("cpu"))):
        logits, caches = model.prefill(
            toks.to(dev), None if frames is None else frames.to(dev))
        seq = [logits.cpu()]
        for i in range(3):
            logits, caches = model.decode_step(caches, toks[:, i:i + 1].to(
                dev), 16 + i)
            seq.append(logits.cpu())
        outs.append(seq)
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------
# the sharded paths on one card (world size 1)
# ---------------------------------------------------------------------

@pytest.fixture
def fresh_world():
    """No process group before the test; the test's own is destroyed
    after it."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    yield dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _mixed_world(dist, tmp_path):
    """A world of one rank whose collectives take gloo for CPU tensors
    and NCCL for the card's, and its 1 x 1 meshes on both."""
    from repro_torch.launch import mesh as M
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    return M.make_host_mesh(), M.make_host_mesh("cpu")


def test_host_mesh_brings_up_nccl(cuda, fresh_world):
    """With no argument and no process group, `make_host_mesh` starts a
    world of one NCCL rank and returns its 1 x 1 ("data", "model") mesh
    on the card; an all-reduce over "model" runs."""
    from repro_torch.launch import mesh as M
    mesh = M.make_host_mesh()
    assert fresh_world.get_backend() == "nccl"
    assert mesh.device_type == "cuda"
    assert mesh.mesh_dim_names == ("data", "model")
    x = torch.ones(3, device=cuda)
    fresh_world.all_reduce(x, group=mesh.get_group("model"))
    assert x.tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("body", ["local", "stationary"])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "grok-1-314b",
                                  "jamba-v0.1-52b"])
def test_moe_ep_on_card_equals_cpu(cuda, fresh_world, tmp_path, arch, body):
    """Each expert-parallel body in bf16 on the card equals the same body
    on the CPU within 2e-2, at the config's capacity factor (drops
    included), at a prefill token count."""
    from repro_torch.launch import steps as St
    from repro_torch.models import layers as L
    card_mesh, cpu_mesh = _mixed_world(fresh_world, tmp_path)
    cfg = get_config(arch, smoke=True)
    model = Model(cfg).init(torch.Generator().manual_seed(0))
    lp = next(lp for lp, s in zip(model.layers, model.specs) if s["moe"])
    params = {k: v.detach().to(torch.bfloat16) for k, v in lp["moe"].items()}
    x = torch.randn((4, 256, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).to(
                        torch.bfloat16)
    outs = []
    for mesh, dev in ((card_mesh, cuda), (cpu_mesh, torch.device("cpu"))):
        p = {k: v.to(dev) for k, v in params.items()}
        if body == "local":
            y, aux = L.moe_ep_local(p, x.to(dev), cfg, mesh, "model",
                                    e_par=1, f_par=1)
        else:
            y, aux = L.moe_ep_stationary(p, x.to(dev), cfg,
                                         St.build_ctx(mesh))
        outs.append((y.float().cpu(), float(aux)))
    torch.testing.assert_close(outs[0][0], outs[1][0], atol=2e-2, rtol=2e-2)
    assert abs(outs[0][1] - outs[1][1]) < 2e-2


def test_sharded_prefill_launches_flash_on_local_shard(cuda, fresh_world):
    """The sharded model's prefill on the card's 1 x 1 mesh goes through
    the flash kernel once per attention layer, on the rank's blocks, and
    gives the unsharded model's logits (f32, no token dropped)."""
    from torch.distributed.tensor import DTensor
    from repro_torch import tree as Tr
    from repro_torch.launch import mesh as M, steps as St
    ctx = St.build_ctx(M.make_host_mesh())
    cfg = dataclasses.replace(
        get_config("qwen3-moe-235b-a22b", smoke=True),
        compute_dtype=torch.float32, capacity_factor=8.0,
        use_flash_kernel=True)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 128))).to(cuda)
    plain = Model(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    sharded = Model(cfg, ctx).init(torch.Generator(device=cuda).manual_seed(0))
    assert all(isinstance(p, DTensor)
               for p in Tr.leaves(sharded.param_tree()))
    want, _ = plain.prefill(toks)
    before = fops.flash_attention.launches
    got, caches = sharded.prefill(toks)
    torch.cuda.synchronize()
    assert fops.flash_attention.launches - before == 2
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_sharded_train_step_on_card_equals_unsharded(cuda, fresh_world,
                                                     microbatches):
    """chip_smoke's `sharded_train` (a) at the smoke config: three train
    steps of qwen3-1.7b's `Model(cfg, ctx)` on the card's 1 x 1 NCCL mesh
    against the unsharded step from the same parameters (f32): losses,
    grad norms, parameters, m and v within 1e-5."""
    from torch.distributed.tensor import DTensor
    from repro_torch import tree as Tr
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import mesh as M, steps as St
    from repro_torch.optim import adamw_init
    ctx = St.build_ctx(M.make_host_mesh())
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              compute_dtype=torch.float32)
    models = [Model(cfg).init(torch.Generator(device=cuda).manual_seed(0)),
              Model(cfg, ctx).init(torch.Generator(device=cuda).manual_seed(0))]
    tcfg = St.TrainConfig(microbatches=microbatches, total_steps=50,
                          warmup_steps=2)
    runs = [(St.make_train_step(m, tcfg), adamw_init(m.param_tree()))
            for m in models]
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=32, global_batch=4,
                           seed=0)
    for i in range(3):
        batch = {k: torch.from_numpy(v).to(cuda)
                 for k, v in data.batch(i).items()}
        (lp, gp), (ls, gs) = [step(opt, batch) for step, opt in runs]
        assert float(ls) == pytest.approx(float(lp), rel=1e-5, abs=1e-5)
        assert float(gs) == pytest.approx(float(gp), rel=1e-5, abs=1e-5)
    for tree in (lambda k: models[k].param_tree(),
                 lambda k: runs[k][1]["m"], lambda k: runs[k][1]["v"]):
        for a, b in zip(Tr.leaves(tree(1)), Tr.leaves(tree(0))):
            assert isinstance(a, DTensor)
            torch.testing.assert_close(a.full_tensor(), b.detach(),
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("body", ["local", "stationary"])
def test_moe_ep_grads_on_card_equal_dropless(cuda, fresh_world, body):
    """The expert-parallel bodies' gradients (input, router, experts) on
    the card's 1 x 1 NCCL mesh at qwen3-moe's smoke width, f32, capacity
    factor n_experts / top_k (nothing dropped), against the dropless loop
    route within 1e-4."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import mesh as M, steps as St
    from repro_torch.models import layers as L
    from repro_torch.models.model import make_moe_apply
    mesh = M.make_host_mesh()
    ctx = St.build_ctx(mesh)
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b", smoke=True),
                              compute_dtype=torch.float32, capacity_factor=4.0)
    g = torch.Generator(device=cuda).manual_seed(3)
    params = L.init_moe(g, cfg)
    x = torch.randn((4, 520, cfg.d_model), generator=g, device=cuda)
    w = torch.randn(x.shape, generator=g, device=cuda)
    names = ("router", "wi", "wg", "wo")
    _, shardings = St.param_shardings(Model(cfg, ctx), ctx)
    sh = next(lp["moe"] for lp in shardings["layers"] if "moe" in lp)

    def grads(apply, leaves):
        xg = x.detach().requires_grad_()
        y, aux = apply(dict(zip(names, leaves)), xg)
        out = torch.autograd.grad((y * w).sum() + aux, [xg] + list(leaves))
        return [o.full_tensor() if isinstance(o, DTensor) else o
                for o in out]

    want = grads(lambda p, xg: L.moe_ragged(p, xg, cfg, route="loop"),
                 [params[n].requires_grad_() for n in names])
    dts = [DTensor.from_local(params[n].detach(), mesh, sh[n].placements,
                              run_check=False).requires_grad_()
           for n in names]
    apply = (make_moe_apply(cfg, ctx, batch=4) if body == "local" else
             lambda p, xg: L.moe_ep_stationary(p, xg, cfg, ctx, batch=4))
    for got, ref in zip(grads(apply, dts), want):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
