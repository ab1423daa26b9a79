"""The port's cycle simulator on the CPU is bitwise-equal to the JAX
package's (`alloc="jnp"`) on the heterogeneous batch of
tests/test_sweep.py, with the very same specs carried across by
`convert.spec_from_reference`; batched equals single-spec, a fat pad
changes nothing, and the sweep engine equals `run_batch`.  The adaptive
and recorder modes are held in depth by tests/test_torch_adaptive.py and
tests/test_torch_telemetry.py."""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as RS  # noqa: E402
from repro.core import topology as RT, traffic as RTR  # noqa: E402
from repro.core.routing import build_routing  # noqa: E402
from repro_torch.convert import spec_from_reference  # noqa: E402
from repro_torch.core import simulator as PS  # noqa: E402
from repro_torch.core import topology as PT, traffic as PTR  # noqa: E402
from repro_torch.core.routing import build_routing as p_build_routing  # noqa: E402,E501
from repro_torch.sweep.engine import SweepCase, SweepEngine  # noqa: E402
from repro_torch.sweep.padding import PadShape, stack_specs  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on one CPU; torch's
    per-process thread pool oversubscribes it (spinning OpenMP threads
    slow every worker several-fold), and these tests' ops are small, so
    they run on one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HETERO = [("mesh", 16), ("folded_hexa_torus", 36), ("honeycomb_mesh", 16),
          ("octamesh", 25)]
NAMES = [f"{name}{n}" for name, n in HETERO]
RATES = np.array([0.05, 0.15, 0.3, 0.6], np.float32)
RCFG = RS.SimConfig(cycles=300, warmup=100, alloc="jnp")
PCFG = PS.SimConfig(cycles=300, warmup=100)
RAW = ("delivered", "offered_n", "accepted_n", "lat_sum")
DERIVED = ("throughput", "latency", "offered", "accepted")


def _assert_results_equal(got, want, keys=RAW + DERIVED):
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.fixture(scope="module")
def ref_specs():
    specs = []
    for name, n in HETERO:
        r = build_routing(RT.build(name, n))
        specs.append(RS.make_spec(r, RTR.uniform(r.topo)))
    return specs


@pytest.fixture(scope="module")
def port_specs(ref_specs):
    return [spec_from_reference(dataclasses.asdict(s)) for s in ref_specs]


@pytest.fixture(scope="module")
def ref_results(ref_specs):
    return RS.run_batch(ref_specs, RATES, RCFG)


@pytest.fixture(scope="module")
def port_results(port_specs):
    return PS.run_batch(port_specs, RATES, PCFG, device="cpu")


@pytest.mark.parametrize("i", range(len(HETERO)), ids=NAMES)
def test_run_batch_bitwise_equals_reference(i, port_results, ref_results):
    _assert_results_equal(port_results[i], ref_results[i])
    np.testing.assert_array_equal(port_results[i]["rate"],
                                  ref_results[i]["rate"])


@pytest.mark.parametrize("i", range(len(HETERO)), ids=NAMES)
def test_batched_equals_single_spec(i, port_specs, port_results):
    single = PS.run_batch([port_specs[i]], RATES[None, :], PCFG,
                          device="cpu")[0]
    _assert_results_equal(single, port_results[i])


@pytest.mark.parametrize("i", range(len(HETERO)), ids=NAMES)
def test_own_make_spec_equals_reference(i, ref_specs):
    name, n = HETERO[i]
    r = p_build_routing(PT.build(name, n))
    got = PS.make_spec(r, PTR.uniform(r.topo))
    for f in dataclasses.fields(PS.SimSpec):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(ref_specs[i], f.name),
                                      err_msg=f.name)


def test_fat_pad_is_invisible(port_specs, port_results):
    fat = PadShape.of(port_specs)
    fat = PadShape(n=fat.n + 5, p=fat.p + 2, c=fat.c + 17, d=fat.d + 3)
    got = PS.run_batch(port_specs, RATES, PCFG, pad_shape=fat, device="cpu")
    for g, w in zip(got, port_results):
        _assert_results_equal(g, w)


def test_padding_leaves_equal_reference(ref_specs, port_specs):
    from repro.sweep.padding import stack_specs as ref_stack
    got, shape = stack_specs(port_specs)
    want, ref_shape = ref_stack(ref_specs)
    assert (shape.n, shape.p, shape.c, shape.d) == \
        (ref_shape.n, ref_shape.p, ref_shape.c, ref_shape.d)
    for k, v in got._asdict().items():
        np.testing.assert_array_equal(v, getattr(want, k), err_msg=k)
        assert v.dtype == getattr(want, k).dtype, k
    with pytest.raises(ValueError, match="does not cover"):
        stack_specs(port_specs, PadShape(n=4, p=2, c=4, d=2))


def test_engine_run_specs_equals_run_batch(port_specs):
    rates = np.array([0.05, 0.2, 0.5], np.float32)
    eng = SweepEngine(cfg=PCFG, device="cpu")
    got = eng.run_specs(port_specs, rates)
    want = PS.run_batch(port_specs, rates, PCFG, device="cpu")
    for g, w in zip(got, want):
        _assert_results_equal(g, w)
        assert g["delivered"].shape == (3,)
    # four distinct radices -> four groups, as in the reference engine;
    # the port compiles nothing per shape, so every group is a reuse
    assert eng.stats == dict(runs=1, groups=4, specs=4, compiles=0,
                             reuses=4)
    one = SweepEngine(cfg=PCFG, device="cpu").run_specs(
        port_specs, rates, single_program=True)
    for g, w in zip(one, want):
        _assert_results_equal(g, w)


def test_saturation_throughput_equals_reference():
    rr = build_routing(RT.build("folded_hexa_torus", 16))
    pr = p_build_routing(PT.build("folded_hexa_torus", 16))
    traffic = RTR.uniform(rr.topo)
    want = RS.saturation_throughput(rr, traffic, RCFG, n_rates=4)
    got = PS.saturation_throughput(pr, traffic, PCFG, n_rates=4,
                                   device="cpu")
    for k in ("sim_saturation", "analytic_saturation", "latency_at_sat"):
        assert got[k] == want[k], k
    for k in ("throughput", "latency", "offered", "accepted"):
        np.testing.assert_array_equal(got["sweep"][k], want["sweep"][k])


def test_sweep_case_builds_routing_and_traffic():
    r, traffic = SweepCase("folded_hexa_torus", 16).build()
    np.testing.assert_array_equal(traffic, RTR.uniform(RT.build(
        "folded_hexa_torus", 16)))
    assert r.topo.n == 16
    assert not SweepCase("hypercube", 36).valid


def test_alloc_resolution():
    assert PS.resolve_alloc("auto", "cpu") == "torch"
    assert PS.resolve_alloc("torch", "cpu") == "torch"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        PS.resolve_alloc("cuda", "cpu")
    with pytest.raises(ValueError, match="unknown alloc"):
        PS.resolve_alloc("pallas", "cpu")


@pytest.mark.parametrize("kw,exc,match", [
    (dict(routing="adaptive", n_vcs=1), ValueError, "n_vcs >= 2"),
    (dict(telemetry_windows=2), ValueError, "requires telemetry=True"),
    (dict(telemetry=True, telemetry_windows=-1), ValueError, ">= 0"),
    (dict(routing="bogus"), ValueError, "unknown routing"),
    (dict(alloc="cuda"), ValueError, "needs a CUDA device"),
    (dict(telemetry=True, telemetry_windows=4), ValueError,
     "exceeds the measured window"),
])
def test_deferred_and_invalid_configs_raise(port_specs, kw, exc, match):
    """No mode is deferred any more: what raises is an invalid config,
    with the reference runner's messages."""
    cfg = PCFG._replace(cycles=4, warmup=1, **kw)
    with pytest.raises(exc, match=match):
        PS.run_batch(port_specs[:1], RATES[:1], cfg, device="cpu")
    if kw.get("alloc") != "cuda":
        with pytest.raises(exc, match=match):
            RS.run_batch(ref_specs_of(port_specs[:1]), RATES[:1],
                         RCFG._replace(cycles=4, warmup=1, **kw))


def ref_specs_of(specs):
    return [RS.SimSpec(**dataclasses.asdict(s)) for s in specs]


@pytest.mark.parametrize("kw", [
    dict(telemetry=True), dict(telemetry=True, telemetry_windows=4),
    dict(routing="adaptive")], ids=["telemetry", "windows", "adaptive"])
def test_modes_run_batch_equals_reference(kw, ref_specs, port_specs):
    """The modes that once raised here run, and every result key equals
    the reference's (raw, recorder, window counters)."""
    want = RS.run_batch(ref_specs[:2], RATES[1:], RCFG._replace(**kw))
    got = PS.run_batch(port_specs[:2], RATES[1:], PCFG._replace(**kw),
                       device="cpu")
    for g, w in zip(got, want):
        _assert_results_equal(g, w, keys=tuple(k for k in w
                                               if k != "pad_fill"))


def test_schedules_are_a_later_slice(port_specs):
    """Phase schedules are ported now (tests/test_torch_workloads.py):
    what stays is that a schedule list must pair one schedule with each
    spec."""
    with pytest.raises(ValueError, match="schedules 2 != specs 1"):
        PS.run_batch(port_specs[:1], RATES[:1], PCFG, device="cpu",
                     schedules=[object(), object()])


def test_spec_from_reference_rejects_other_dicts(ref_specs):
    fields = dataclasses.asdict(ref_specs[0])
    spec = spec_from_reference(fields)
    assert isinstance(spec.n, int) and spec.table.dtype == np.int16
    with pytest.raises(ValueError, match="unknown fields"):
        spec_from_reference(dict(fields, bogus=1))
    fields.pop("table")
    with pytest.raises(ValueError, match="missing fields"):
        spec_from_reference(fields)


def test_hash_matches_reference_bits():
    """The int64 hash with split multiplies equals the reference's
    wrapping uint32 hash, including at cycle counts past 2^16."""
    import jax.numpy as jnp
    import torch
    t = np.array([0, 1, 77, 65_537, 2 ** 31 - 1], np.int64)
    nodes = np.arange(300)
    for stream in (0, 1, 2):
        for seed in (0, 12345):
            got = PS._node_bits(seed, torch.from_numpy(t).view(-1, 1),
                                torch.from_numpy(nodes), stream).numpy()
            want = np.stack([np.asarray(RS._node_bits(
                seed, jnp.int32(ti), jnp.asarray(nodes), stream))
                for ti in t])
            np.testing.assert_array_equal(got, want.astype(np.int64))


# ---------------------------------------------------------------------
# the graphed cycle loop, rehearsed on the CPU
# ---------------------------------------------------------------------

class _OpGraph:
    """A stand-in for a CUDA graph on the CPU.  `capture` runs the body
    under a dispatch mode that records every aten op with its very
    tensors, then undoes what the ops wrote into tensors they did not
    make, since a capture runs nothing.  `replay` runs the recorded ops
    again on those tensors and writes each new result into the tensor
    the capture made, as a graph's kernels read and write fixed
    addresses: a Python value the body read at capture stays as it was
    then."""

    def __init__(self):
        self.ops = []

    def capture(self, body):
        from torch.utils._python_dispatch import TorchDispatchMode
        ops, saved = self.ops, []

        class _Record(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                for i, a in enumerate(func._schema.arguments):
                    v = args[i] if i < len(args) else kwargs.get(a.name)
                    if isinstance(v, torch.Tensor) and a.alias_info \
                            is not None and a.alias_info.is_write:
                        saved.append((v, v.clone()))
                out = func(*args, **kwargs)
                views = any(r.alias_info is not None
                            for r in func._schema.returns)
                ops.append((func, args, kwargs, None if views else out))
                return out

        with _Record():
            body()
        for v, old in reversed(saved):
            v.copy_(old)

    def replay(self):
        from torch.utils._pytree import tree_leaves
        for func, args, kwargs, out in self.ops:
            res = func(*args, **kwargs)
            if out is not None:
                for o, r in zip(tree_leaves(out), tree_leaves(res)):
                    o.copy_(r)

    def reset(self):
        self.ops.clear()


class _CpuGraphs(PS._CycleGraphs):
    """`_CycleGraphs` with `_OpGraph` in place of CUDA graphs."""

    def __init__(self, dev):
        self.graphs, self.launches, self.replays = {}, {}, {}

    def capture(self, key, body):
        self.graphs[key] = _OpGraph()
        self.graphs[key].capture(body)
        self.launches[key] = [0] * len(PS._COUNTED)
        self.replays[key] = 0

    def replay(self, key):
        self.graphs[key].replay()
        self.replays[key] += 1


GRAPH_CFG = PS.SimConfig(cycles=300, warmup=100)
GRAPH_MODES = {
    "static": dict(),
    "workload": dict(),
    "adaptive": dict(routing="adaptive"),
    "recorder": dict(telemetry=True, telemetry_windows=3),
}


def _graph_batch(port_specs, mode):
    import repro_torch.workloads as PW
    specs = port_specs[:2]
    scheds = None
    if mode == "workload":
        scheds = [PW.hotspot_drift(PT.build(name, n), n_phases=3,
                                   dwell=70).compile()
                  for name, n in HETERO[:2]]
    return specs, GRAPH_CFG._replace(**GRAPH_MODES[mode]), scheds


@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_replayed_cycles_equal_eager_ones(mode, port_specs, monkeypatch):
    """Every cycle but each body's first replayed from a stand-in graph
    (300 cycles, warm-up 100, so both bodies cross a chunk edge): every
    result key equals the eager loop's bit for bit, the spans count the
    replays, and the run counts its captures and replays."""
    TR = importlib.import_module("repro_torch.obs.trace")
    from repro_torch.obs.metrics import metrics
    specs, cfg, scheds = _graph_batch(port_specs, mode)
    eager = PS.run_batch(specs, RATES[1:], cfg, schedules=scheds,
                         device="cpu")
    monkeypatch.setattr(PS, "_graphed", lambda device, probe: True)
    monkeypatch.setattr(PS, "_CycleGraphs", _CpuGraphs)
    before = {k: metrics.get(k) for k in ("sim.graph_captures",
                                          "sim.graph_replays")}
    TR.clear_trace()
    TR.enable_tracing()
    try:
        graphed = PS.run_batch(specs, RATES[1:], cfg, schedules=scheds,
                               device="cpu")
    finally:
        TR.disable_tracing()
    chunks = [sp for sp in TR.get_spans() if sp.name == "sim.cycles"]
    TR.clear_trace()
    for g, e in zip(graphed, eager):
        _assert_results_equal(g, e, keys=tuple(k for k in e
                                               if k != "pad_fill"))
    assert sum(sp.args["graphed"] for sp in chunks) == cfg.cycles - 2
    assert all(sp.args["graphed"] > 0 and "alloc_calls" not in sp.args
               for sp in chunks)
    assert metrics.get("sim.graph_captures") - \
        before["sim.graph_captures"] == 2
    assert metrics.get("sim.graph_replays") - \
        before["sim.graph_replays"] == cfg.cycles - 2


def test_stand_in_graph_keeps_what_the_body_read_at_capture():
    """The rehearsal can fail: a body that reads a host number each
    cycle replays the number it read at capture, and a capture leaves
    the state as it found it."""
    state = torch.zeros(3, dtype=torch.int64)
    step = [1]

    def body():
        state.add_(step[0])

    g = _OpGraph()
    g.capture(body)
    assert state.tolist() == [0, 0, 0]
    step[0] = 5
    g.replay()
    g.replay()
    assert state.tolist() == [2, 2, 2]


def test_cpu_spans_carry_graphed_zero_and_alloc_calls(port_specs):
    """On the CPU the loop stays eager: each `sim.cycles` span carries
    `graphed = 0` and one allocator call a cycle."""
    TR = importlib.import_module("repro_torch.obs.trace")
    TR.clear_trace()
    TR.enable_tracing()
    try:
        PS.run_batch(port_specs[:1], RATES[:2], GRAPH_CFG, device="cpu")
    finally:
        TR.disable_tracing()
    chunks = [sp for sp in TR.get_spans() if sp.name == "sim.cycles"]
    TR.clear_trace()
    assert len(chunks) == 2
    for sp in chunks:
        assert sp.args["graphed"] == 0
        assert sp.args["alloc_calls"] == sp.args["cycles"]


#: what every traced `sim.cycles` span carries; an eager chunk (no cycle
#: replayed) adds `alloc_calls`
SPAN_ATTRS = {"t0", "cycles", "measured", "mode", "adaptive", "recorder",
              "graphed", "fused"}


@pytest.mark.parametrize("replayed", [False, True],
                         ids=["eager", "replayed"])
def test_cycles_spans_carry_the_documented_attributes(replayed, port_specs,
                                                      monkeypatch):
    """With tracing on, a `sim.cycles` span carries exactly SPAN_ATTRS,
    and `alloc_calls` too where none of its cycles was replayed: the
    CPU's eager loop, or a stand-in graph replaying each body's cycles
    after its first."""
    TR = importlib.import_module("repro_torch.obs.trace")
    if replayed:
        monkeypatch.setattr(PS, "_graphed", lambda device, probe: True)
        monkeypatch.setattr(PS, "_CycleGraphs", _CpuGraphs)
    TR.clear_trace()
    TR.enable_tracing()
    try:
        PS.run_batch(port_specs[:1], RATES[:2], GRAPH_CFG, device="cpu")
    finally:
        TR.disable_tracing()
    chunks = [sp for sp in TR.get_spans() if sp.name == "sim.cycles"]
    TR.clear_trace()
    assert len(chunks) == 2
    for sp in chunks:
        assert (sp.args["graphed"] > 0) is replayed
        assert set(sp.args) == SPAN_ATTRS | (
            set() if replayed else {"alloc_calls"})


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "cpu"])
def test_op_trace_keeps_the_loop_eager(device):
    """The loop replays graphs on a CUDA device unless an op trace (a
    probe that follows the cycle) is attached; a profile's probe, which
    only takes the state's bytes, does not stop it.  Decided from the
    device and the probe alone, without a card."""
    cuda = torch.device(device).type == "cuda"
    assert PS._graphed(torch.device(device), None) is cuda
    assert PS._graphed(device, {}) is cuda
    assert PS._graphed(device, {"cycle": None}) is False
    assert PS._graphed(device, {"cycle": 3, "state_bytes": 1}) is False
