"""The port's minimal-adaptive routing on the CPU is bitwise-equal to the
JAX package's (`alloc="jnp"`): the route lookup itself on states full of
credit ties (first maximum, as `jnp.argmax`), the heterogeneous batch of
tests/test_sweep.py, batched = single spec, a fat pad, a k_pad workload
batch and a faulted batch, and the `repro_torch.adaptive` facade."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import repro.adaptive as RA  # noqa: E402
import repro.faults as RF  # noqa: E402
from repro.core import simulator as RS  # noqa: E402
from repro.core import topology as RT, traffic as RTR  # noqa: E402
from repro.core.routing import build_routing  # noqa: E402
import repro_torch.adaptive as PA  # noqa: E402
from repro_torch.convert import (sched_from_reference,  # noqa: E402
                                 spec_from_reference)
from repro_torch.core import simulator as PS  # noqa: E402
from repro_torch.core import topology as PT, traffic as PTR  # noqa: E402
from repro_torch.core.routing import build_routing as p_build  # noqa: E402
from repro_torch.sweep.padding import PadShape  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on one CPU; these
    tests' ops are small, so they run on one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HETERO = [("mesh", 16), ("folded_hexa_torus", 36), ("honeycomb_mesh", 16),
          ("octamesh", 25)]
NAMES = [f"{name}{n}" for name, n in HETERO]
RATES = np.array([0.05, 0.2, 0.5], np.float32)
RCFG = RS.SimConfig(cycles=300, warmup=100, alloc="jnp", routing="adaptive")
PCFG = PS.SimConfig(cycles=300, warmup=100, routing="adaptive")
RAW = ("delivered", "offered_n", "accepted_n", "lat_sum")
DERIVED = ("throughput", "latency", "offered", "accepted")
PHASE = ("delivered_ph", "offered_ph", "accepted_ph", "lat_sum_ph")


def _equal(got, want, keys=RAW + DERIVED):
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def _port(spec):
    return spec_from_reference(dataclasses.asdict(spec))


@pytest.fixture(scope="module")
def ref_specs():
    out = []
    for name, n in HETERO:
        r = build_routing(RT.build(name, n))
        out.append(RS.make_spec(r, RTR.uniform(r.topo)))
    return out


@pytest.fixture(scope="module")
def port_specs(ref_specs):
    return [_port(s) for s in ref_specs]


@pytest.fixture(scope="module")
def port_results(port_specs):
    return PS.run_batch(port_specs, RATES, PCFG, device="cpu")


# ---------------------------------------------------------------------
# the lookup itself, on ties
# ---------------------------------------------------------------------

def _tie_states(spec, rows, seed):
    """Random router states whose credits are drawn from {0, 2, 4}, so
    that productive ports and adaptive VCs tie for the maximum credit;
    row 0 has every credit at the buffer depth (the state at t = 0)."""
    rng = np.random.default_rng(seed)
    n, p, v = spec.n, spec.p, 4
    credits = rng.choice([0, 2, 4], size=(rows, n, p, v)).astype(np.int64)
    credits[0] = 4
    cnt = rng.integers(0, 3, size=(rows, n, p + 1, v))
    head = rng.integers(0, n, size=(rows, n, p + 1, v))
    return credits, cnt, head


@pytest.mark.parametrize("name,n", [("mesh", 16), ("folded_hexa_torus", 36),
                                    ("octamesh", 25)])
def test_adaptive_lookup_first_max_on_ties(name, n):
    r = build_routing(RT.build(name, n))
    spec = RS.make_spec(r, RTR.uniform(r.topo))
    credits, cnt, head = _tie_states(spec, rows=6, seed=n)
    p, v = spec.p, credits.shape[-1]
    got = PS._route_lookup_adaptive(
        torch.as_tensor(spec.table[None]), torch.as_tensor(spec.prod[None]),
        torch.zeros(len(credits), dtype=torch.int64),
        torch.as_tensor(credits), torch.as_tensor(head),
        torch.as_tensor(cnt), p)
    ties = 0
    for b in range(len(credits)):
        cred_pad = np.concatenate(
            [credits[b], np.full((spec.n, 1, v), 2 ** 30)], axis=1)
        want = RS._route_lookup_adaptive(
            jnp.asarray(spec.table), jnp.asarray(spec.prod),
            jnp.asarray(cred_pad, jnp.int32), jnp.asarray(head[b]),
            jnp.asarray(cnt[b]), spec.n, p, v)
        for g, w, what in zip(got, want, ("op_slot", "eligible", "starved",
                                          "dvc")):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w),
                                          err_msg=f"row {b} {what}")
        # the lookup really met ties: lanes with two or more productive
        # ports at the maximum adaptive credit
        cred_ad = credits[b][..., 1:].sum(-1)                 # [N, P]
        dst = np.where(cnt[b] > 0, head[b], 0)
        cand = spec.prod[dst, np.arange(spec.n)[:, None, None]]
        score = np.where(cand & (cred_ad[:, None, None, :] > 0),
                         cred_ad[:, None, None, :], -1)
        best = score.max(-1, keepdims=True)
        ties += int((((score == best) & (best > 0)).sum(-1) > 1).sum())
    assert ties > 100


def test_static_lookup_starved_equals_reference():
    """The recorder's credit-starved mask of the static lookup."""
    r = build_routing(RT.build("folded_hexa_torus", 16))
    spec = RS.make_spec(r, RTR.uniform(r.topo))
    credits, cnt, head = _tie_states(spec, rows=4, seed=3)
    p, v = spec.p, credits.shape[-1]
    got = PS._route_lookup(
        torch.as_tensor(spec.table[None]),
        torch.zeros(len(credits), dtype=torch.int64),
        torch.as_tensor(credits), torch.as_tensor(head),
        torch.as_tensor(cnt), p, starved=True)
    for b in range(len(credits)):
        cred_pad = np.concatenate(
            [credits[b], np.full((spec.n, 1, v), 2 ** 30)], axis=1)
        want = RS._route_lookup(jnp.asarray(spec.table),
                                jnp.asarray(cred_pad, jnp.int32),
                                jnp.asarray(head[b]), jnp.asarray(cnt[b]),
                                spec.n, p, v)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


# ---------------------------------------------------------------------
# the batched runner
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_results(ref_specs):
    return RS.run_batch(ref_specs, RATES, RCFG)


@pytest.mark.parametrize("i", range(len(HETERO)), ids=NAMES)
def test_adaptive_run_batch_bitwise_equals_reference(i, port_results,
                                                     ref_results):
    _equal(port_results[i], ref_results[i])


@pytest.mark.parametrize("i", range(len(HETERO)), ids=NAMES)
def test_adaptive_batched_equals_single_spec(i, port_specs, port_results):
    single = PS.run_batch([port_specs[i]], RATES[None, :], PCFG,
                          device="cpu")[0]
    _equal(single, port_results[i])


def test_adaptive_fat_pad_is_invisible(port_specs, port_results):
    """Fat-padding every axis changes no adaptive counter: the pad
    region of the productive-ports leaf is all-False."""
    specs = port_specs[:2]
    shape = PadShape.of(specs)
    fat = PadShape(n=shape.n + 7, p=shape.p + 2, c=shape.c + 19,
                   d=shape.d + 3)
    padded = PS.run_batch(specs, RATES, PCFG, pad_shape=fat, device="cpu")
    for a, b in zip(padded, port_results):
        _equal(a, b)


def test_adaptive_differs_from_static(port_specs, port_results):
    static = PS.run_batch(port_specs, RATES, PCFG._replace(routing="static"),
                          device="cpu")
    assert any(not np.array_equal(a["delivered"], b["delivered"])
               for a, b in zip(static, port_results))


def test_adaptive_workload_batch_equals_reference():
    """A k_pad workload batch (tests/test_torch_workloads.py's phases,
    cut to two specs) under adaptive routing: raw and per-phase."""
    specs, scheds = [], []
    for name, n in (("mesh", 16), ("folded_hexa_torus", 36)):
        r = build_routing(RT.build(name, n))
        u, t = RTR.uniform(r.topo), RTR.tornado(r.topo)
        specs.append(RS.make_spec(r, u))
        scheds.append(RS.make_sched_spec(
            [(t, 1.3, 50, 5, 7), (u, 1.0, 100), (u, 0.0, 30)]))
    want = RS.run_batch(specs, RATES, RCFG, schedules=scheds, k_pad=5)
    got = PS.run_batch([_port(s) for s in specs], RATES, PCFG,
                       schedules=[sched_from_reference(
                           dataclasses.asdict(s)) for s in scheds],
                       k_pad=5, device="cpu")
    for g, w in zip(got, want):
        _equal(g, w, RAW + DERIVED + PHASE)


def test_adaptive_faulted_batch_equals_reference():
    """Degraded specs (link and chiplet faults) under adaptive routing."""
    mesh = RT.build("mesh", 16)
    specs = []
    for fs in (RF.sample_faults(mesh, 2, "random", seed=3),
               RF.sample_faults(mesh, 1, "chiplets", seed=0)):
        r = build_routing(fs.apply(mesh))
        specs.append(RS.make_spec(r, fs.mask_traffic(RTR.uniform(mesh))))
    want = RS.run_batch(specs, RATES, RCFG)
    got = PS.run_batch([_port(s) for s in specs], RATES, PCFG,
                       device="cpu")
    for g, w in zip(got, want):
        _equal(g, w)


def test_adaptive_needs_two_vcs(port_specs):
    with pytest.raises(ValueError, match="n_vcs >= 2"):
        PS.run_batch(port_specs[:1], RATES, PCFG._replace(n_vcs=1),
                     device="cpu")


# ---------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------

def test_adaptive_config_equals_reference():
    for kw in ({}, dict(n_vcs=1), dict(n_vcs=6, cycles=50)):
        got = PA.adaptive_config(PS.SimConfig(**kw))
        want = RA.adaptive_config(RS.SimConfig(**kw))
        assert got._asdict() == dict(want._asdict(), alloc="auto")
    assert PA.adaptive_config(n_vcs=3).n_vcs == 3
    assert set(RA.__all__) == set(PA.__all__)
    assert PA.ADAPTIVE_HEADROOM == RA.ADAPTIVE_HEADROOM
    assert PA.routing_headroom("adaptive") == RA.routing_headroom("adaptive")


def test_compare_saturation_equals_reference():
    rr = build_routing(RT.build("folded_hexa_torus", 16))
    pr = p_build(PT.build("folded_hexa_torus", 16))
    cfg = dict(cycles=160, warmup=60)
    want = RA.compare_saturation(rr, RTR.uniform(rr.topo),
                                 RS.SimConfig(alloc="jnp", **cfg), n_rates=3)
    got = PA.compare_saturation(pr, PTR.uniform(pr.topo),
                                PS.SimConfig(**cfg), n_rates=3,
                                device="cpu")
    for k in ("static", "adaptive", "gain", "analytic"):
        assert got[k] == want[k], k
    for mode in ("static_sweep", "adaptive_sweep"):
        for k in ("throughput", "latency"):
            np.testing.assert_array_equal(got[mode]["sweep"][k],
                                          want[mode]["sweep"][k])


def test_facade_check_escape_equals_reference():
    rr = build_routing(RT.build("hexamesh", 16))
    pr = p_build(PT.build("hexamesh", 16))
    got, n_got = PA.check_escape(pr)
    want, n_want = RA.check_escape(rr)
    assert n_got == n_want > 0
    assert [d.to_dict() for d in got] == [d.to_dict() for d in want]
    np.testing.assert_array_equal(PA.productive_ports(pr),
                                  RA.productive_ports(rr))
