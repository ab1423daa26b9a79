"""The port's workload runner on the CPU is bitwise-equal to the JAX
package's (`alloc="jnp"`) on a heterogeneous padded batch of
multi-phase schedules — ON/OFF bursts, a zero-intensity phase and
`k_pad > k` — with specs and schedules carried across by
`convert.spec_from_reference` / `convert.sched_from_reference`; the
port's own invariants (a single uniform phase equals the static run,
padding is invisible, phase counters partition the totals, the engine
equals single runs) hold; and the schedule compiler, padding and
generators give the reference's leaves."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.workloads as RW  # noqa: E402
from repro.core import simulator as RS  # noqa: E402
from repro.core import topology as RT, traffic as RTR  # noqa: E402
from repro.core.routing import build_routing  # noqa: E402
from repro.sweep.padding import stack_schedules as ref_stack  # noqa: E402
import repro_torch.workloads as PW  # noqa: E402
from repro_torch.convert import (sched_from_reference,  # noqa: E402
                                 spec_from_reference)
from repro_torch.core import simulator as PS  # noqa: E402
from repro_torch.core import topology as PT, traffic as PTR  # noqa: E402
from repro_torch.sweep.engine import SweepEngine  # noqa: E402
from repro_torch.sweep.padding import stack_schedules  # noqa: E402


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


HETERO = [("mesh", 16), ("folded_hexa_torus", 36), ("octamesh", 25)]
NAMES = [f"{name}{n}" for name, n in HETERO]
RATES = np.array([0.05, 0.2, 0.5], np.float32)
K_PAD = 6
RCFG = RS.SimConfig(cycles=300, warmup=100, alloc="jnp")
PCFG = PS.SimConfig(cycles=300, warmup=100)
RAW = ("delivered", "offered_n", "accepted_n", "lat_sum")
PHASE = ("delivered_ph", "offered_ph", "accepted_ph", "lat_sum_ph")
PHASE_DERIVED = ("phase_cycles", "throughput_ph", "latency_ph",
                 "offered_rate_ph")
DERIVED = ("throughput", "latency", "offered", "accepted")


def _phases(i, u, t):
    """Schedule i of the batch: 3, 4 and 2 phases; bursts (gain > 1 in
    ON), a zero-intensity phase, and a schedule that replays cyclically
    inside the 300 cycles."""
    return [
        [(u, 1.0, 70), (t, 0.8, 90, 10, 30), (u, 0.0, 40)],
        [(t, 1.3, 50, 5, 7), (u, 1.0, 100), (u, 0.0, 30),
         (t, 0.6, 120, 3, 1)],
        [(u, 0.7, 60, 20, 60), (t, 1.0, 40)],
    ][i]


def _assert_equal(got, want, keys):
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.fixture(scope="module")
def ref_pairs():
    specs, scheds = [], []
    for i, (name, n) in enumerate(HETERO):
        r = build_routing(RT.build(name, n))
        u, t = RTR.uniform(r.topo), RTR.tornado(r.topo)
        specs.append(RS.make_spec(r, u))
        scheds.append(RS.make_sched_spec(_phases(i, u, t)))
    return specs, scheds


@pytest.fixture(scope="module")
def port_pairs(ref_pairs):
    specs, scheds = ref_pairs
    return ([spec_from_reference(dataclasses.asdict(s)) for s in specs],
            [sched_from_reference(dataclasses.asdict(s)) for s in scheds])


@pytest.fixture(scope="module")
def ref_results(ref_pairs):
    specs, scheds = ref_pairs
    return RS.run_batch(specs, RATES, RCFG, schedules=scheds, k_pad=K_PAD)


@pytest.fixture(scope="module")
def port_results(port_pairs):
    specs, scheds = port_pairs
    return PS.run_batch(specs, RATES, PCFG, schedules=scheds, k_pad=K_PAD,
                        device="cpu")


# ---------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(HETERO)), ids=NAMES)
def test_workload_run_batch_bitwise_equals_reference(i, port_results,
                                                     ref_results):
    got, want = port_results[i], ref_results[i]
    assert set(got) == set(want)
    _assert_equal(got, want, RAW + DERIVED + PHASE + PHASE_DERIVED)
    assert got["pad_fill"] == want["pad_fill"]
    np.testing.assert_array_equal(got["rate"], want["rate"])


def test_zero_intensity_and_burst_phases_are_exercised(port_results):
    """The batch is not vacuous: the zero-intensity phases offer nothing,
    and every other phase with measured cycles offers flits at the top
    rate (phase 0 of schedule 1 ends before the warm-up does)."""
    for res, zero in zip(port_results, (2, 2, None)):
        offered = res["offered_ph"][-1]
        for k, o in enumerate(offered):
            live = k != zero and res["phase_cycles"][k] > 0
            assert (o > 0) == live, (k, offered)
    assert port_results[1]["phase_cycles"][0] == 0
    assert port_results[1]["offered_ph"].shape == (len(RATES), 4)


@pytest.mark.parametrize("i", range(len(HETERO)), ids=NAMES)
def test_sched_from_reference_equals_own_make_sched_spec(i, ref_pairs):
    """A JAX SchedSpec carried across equals the port's own compile of
    the same phases, field by field and dtype by dtype."""
    name, n = HETERO[i]
    topo = PT.build(name, n)
    own = PS.make_sched_spec(_phases(i, PTR.uniform(topo),
                                     PTR.tornado(topo)))
    carried = sched_from_reference(dataclasses.asdict(ref_pairs[1][i]))
    for f in dataclasses.fields(PS.SchedSpec):
        a, b = getattr(carried, f.name), getattr(own, f.name)
        np.testing.assert_array_equal(a, b, err_msg=f.name)
        assert type(a) is type(b), f.name
        assert np.asarray(a).dtype == np.asarray(b).dtype, f.name


def test_sched_from_reference_rejects_other_dicts(ref_pairs):
    fields = dataclasses.asdict(ref_pairs[1][0])
    assert isinstance(sched_from_reference(fields).total, int)
    with pytest.raises(ValueError, match="unknown fields"):
        sched_from_reference(dict(fields, bogus=1))
    fields.pop("cum")
    with pytest.raises(ValueError, match="missing fields"):
        sched_from_reference(fields)


def test_stack_schedules_leaves_equal_reference(ref_pairs, port_pairs):
    want, k_want = ref_stack(ref_pairs[1], 40, K_PAD)
    got, k_got = stack_schedules(port_pairs[1], 40, K_PAD)
    assert k_got == k_want == K_PAD
    for k, v in got._asdict().items():
        np.testing.assert_array_equal(v, getattr(want, k), err_msg=k)
        assert v.dtype == getattr(want, k).dtype, k
    assert (got.end[:, -1] == 2 ** 30).all()          # inert pad phases
    with pytest.raises(ValueError, match="does not cover"):
        stack_schedules(port_pairs[1], 16, K_PAD)


@pytest.mark.parametrize("i", range(len(HETERO)), ids=NAMES)
def test_phase_measured_cycles_equals_reference(i, ref_pairs, port_pairs):
    np.testing.assert_array_equal(
        PS.phase_measured_cycles(port_pairs[1][i], PCFG),
        RS.phase_measured_cycles(ref_pairs[1][i], RCFG))


# ---------------------------------------------------------------------
# the port's own invariants (mirror tests/test_workloads.py)
# ---------------------------------------------------------------------

def test_single_uniform_phase_bitwise_equals_static(port_pairs):
    spec = port_pairs[0][1]
    topo = PT.build("folded_hexa_torus", 36)
    rates = RATES[None, :]
    static = PS.run_batch([spec], rates, PCFG, device="cpu")[0]
    sched = PW.static_schedule(PTR.uniform(topo), PCFG.cycles).compile()
    wl = PS.run_batch([spec], rates, PCFG, schedules=[sched],
                      device="cpu")[0]
    _assert_equal(wl, static, RAW + DERIVED)
    np.testing.assert_array_equal(wl["delivered_ph"][:, 0],
                                  wl["delivered"])


@pytest.mark.parametrize("i", range(len(HETERO)), ids=NAMES)
def test_single_pair_equals_padded_batch(i, port_pairs, port_results):
    """Each (spec, schedule) run alone at its own phase count equals its
    row of the batch padded to K_PAD phases and the widest spec: the
    spec, rate and phase axes all pad invisibly."""
    specs, scheds = port_pairs
    single = PS.run_batch([specs[i]], RATES[None, :], PCFG,
                          schedules=[scheds[i]], device="cpu")[0]
    assert single["pad_fill"]["phase"] == 1.0
    _assert_equal(single, port_results[i], RAW + PHASE + PHASE_DERIVED)


@pytest.mark.parametrize("i", range(len(HETERO)), ids=NAMES)
def test_phase_counters_partition_totals(i, port_pairs, port_results):
    res = port_results[i]
    for ph_key, tot_key in zip(PHASE, RAW):
        np.testing.assert_array_equal(res[ph_key].sum(axis=1),
                                      res[tot_key], err_msg=ph_key)
    assert res["phase_cycles"].sum() == PCFG.cycles - PCFG.warmup


def test_engine_run_workloads_equals_run_batch(port_pairs, port_results):
    """The engine splits the batch into groups (three radices), pads
    each group's batch, rate and phase axes, and still gives every pair
    its batched counters; the per-phase keys keep their phase axis."""
    specs, scheds = port_pairs
    eng = SweepEngine(cfg=PCFG, device="cpu")
    got = eng.run_workloads(specs, scheds, RATES)
    for g, w in zip(got, port_results):
        _assert_equal(g, w, RAW + PHASE + PHASE_DERIVED)
    assert eng.stats == dict(runs=1, groups=3, specs=3, compiles=0,
                             reuses=3)
    with pytest.raises(ValueError, match="schedules"):
        eng.run_workloads(specs, scheds[:2], RATES)


def test_mismatched_schedule_raises(port_pairs):
    specs, scheds = port_pairs
    with pytest.raises(ValueError, match="node"):
        PS.run_batch(specs[:1], RATES, PCFG, schedules=scheds[1:2],
                     device="cpu")


# ---------------------------------------------------------------------
# schedules and generators equal the reference's
# ---------------------------------------------------------------------

def _assert_schedule_equal(got, want):
    assert got.name == want.name
    assert len(got.phases) == len(want.phases)
    for a, b in zip(got.phases, want.phases):
        np.testing.assert_array_equal(a.traffic, b.traffic)
        assert (a.intensity, a.duration, a.burst_on, a.burst_off,
                a.label) == (b.intensity, b.duration, b.burst_on,
                             b.burst_off, b.label)
    np.testing.assert_array_equal(got.mean_traffic(), want.mean_traffic())
    g, w = got.compile(), want.compile()
    for f in dataclasses.fields(PS.SchedSpec):
        np.testing.assert_array_equal(getattr(g, f.name),
                                      getattr(w, f.name), err_msg=f.name)
        assert np.asarray(getattr(g, f.name)).dtype == \
            np.asarray(getattr(w, f.name)).dtype, f.name


GENERATORS = [
    ("hotspot_drift", dict(n_phases=6, dwell=200)),
    ("hotspot_drift", dict(n_phases=3, dwell=50, n_hotspots=2, seed=5)),
    ("phase_alternating", dict(phase_cycles=300, repeats=2)),
    ("phase_alternating", dict(patterns=("neighbor", "tornado",
                                         "uniform"), phase_cycles=40,
                               repeats=1, intensities=[0.5, 1.0, 2.0],
                               burst=(3, 9))),
    ("bursty_uniform", dict(on=20, off=60)),
    ("trace_workload", dict(trace="fluidanimate", region_cycles=40)),
    ("trace_workload", dict(trace="blackscholes")),
]


@pytest.mark.parametrize("topo_name,n", [("mesh", 16),
                                         ("folded_hexa_torus", 36)])
@pytest.mark.parametrize("gen,kw", GENERATORS,
                         ids=[f"{g}{i}" for i, (g, _) in
                              enumerate(GENERATORS)])
def test_generators_equal_reference(gen, kw, topo_name, n):
    roles = "hetero_cmi" if gen == "trace_workload" else "homogeneous"
    got = getattr(PW, gen)(PT.build(topo_name, n, roles_scheme=roles),
                           **kw)
    want = getattr(RW, gen)(RT.build(topo_name, n, roles_scheme=roles),
                            **kw)
    _assert_schedule_equal(got, want)
    for target in (200, 777, got.total_cycles + 1):
        _assert_schedule_equal(got.fit(target), want.fit(target))
    _assert_schedule_equal(got.scaled(0.37), want.scaled(0.37))


def test_trace_json_round_trip(tmp_path):
    topo_p = PT.build("mesh", 16, roles_scheme="hetero_cmi")
    topo_r = RT.build("mesh", 16, roles_scheme="hetero_cmi")
    for name, tr in PW.builtin_traces(30).items():
        path = tmp_path / f"{name}.json"
        tr.save(str(path))
        again = PW.load_trace(str(path))
        assert again == tr
        want = RW.load_trace(str(path))
        _assert_schedule_equal(again.to_schedule(topo_p),
                               want.to_schedule(topo_r))
        _assert_schedule_equal(PW.trace_workload(topo_p, str(path)),
                               RW.trace_workload(topo_r, str(path)))
    got = [(w.name, w(topo_p)) for w in PW.trace_workloads(25)]
    want = [(w.name, w(topo_r)) for w in RW.trace_workloads(25)]
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, g), (_, w) in zip(got, want):
        _assert_schedule_equal(g, w)
    assert dataclasses.asdict(PW.from_profile("blackscholes", 10, (2, 3))) \
        == dataclasses.asdict(RW.traces.from_profile("blackscholes", 10,
                                                     (2, 3)))


def test_trace_region_traffic_equals_reference():
    topo_p = PT.build("hexamesh", 25, roles_scheme="hetero_cmi")
    topo_r = RT.build("hexamesh", 25, roles_scheme="hetero_cmi")
    assert PTR.TRACE_PROFILES == RTR.TRACE_PROFILES
    for profile, regions in RTR.TRACE_PROFILES.items():
        for i in range(len(regions)):
            m, a = PTR.trace_region_traffic(topo_p, profile, i)
            w, b = RTR.trace_region_traffic(topo_r, profile, i)
            np.testing.assert_array_equal(m, w)
            assert a == b


@pytest.mark.parametrize("name", ["collective_workload",
                                  "collective_workloads",
                                  "default_mesh_shape", "mixed_tenant",
                                  "mixed_tenant_workload", "superimpose"])
def test_collective_workloads_are_a_later_slice(name):
    with pytest.raises(NotImplementedError,
                       match="collective-workloads slice"):
        getattr(PW, name)(None)
