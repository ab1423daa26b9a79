"""The port's flight recorder on the CPU is bitwise-equal to the JAX
package's (`alloc="jnp"`): every per-link, per-node, histogram and
window counter, and the values derived from them, on the heterogeneous
batch of tests/test_sweep.py under static and adaptive routing, on a
k_pad workload batch and on a faulted batch; batched = single spec, a
fat pad changes nothing, the golden `telemetry:fht16` pins of
tests/test_simulator.py hold, the recorder conserves flits and the
windows sum to the aggregates."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.faults as RF  # noqa: E402
from repro.core import simulator as RS  # noqa: E402
from repro.core import topology as RT, traffic as RTR  # noqa: E402
from repro.core.routing import build_routing  # noqa: E402
from repro_torch.convert import (sched_from_reference,  # noqa: E402
                                 spec_from_reference)
from repro_torch.core import simulator as PS  # noqa: E402
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
MODES = {"static": dict(telemetry=True),
         "adaptive_w4": dict(telemetry=True, routing="adaptive",
                             telemetry_windows=4)}
RCFG = RS.SimConfig(cycles=300, warmup=100, alloc="jnp")
PCFG = PS.SimConfig(cycles=300, warmup=100)
WINDOWED = (("link_busy", "link_busy_w"), ("link_stall", "link_stall_w"),
            ("link_occ_sum", "link_occ_w"), ("inj_node", "inj_node_w"),
            ("eject_node", "eject_node_w"))
# tests/test_simulator.py's golden pins of the telemetry-on static path
GOLDEN_FHT16 = {
    "delivered": [163, 654, 1950], "offered_n": [161, 653, 1948],
    "accepted_n": [161, 653, 1935], "lat_sum": [2240, 9071, 32384]}
GOLDEN_FHT16_TEL = {"link_busy": 4787, "link_stall": 929,
                    "inj_node": 2749, "eject_node": 2767}


def _equal(got, want):
    """Every key of the reference's result dict, values and dtypes."""
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "pad_fill":
            assert got[k] == w
            continue
        np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(w).dtype, k


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


@pytest.fixture(scope="module", params=list(MODES))
def mode(request):
    return request.param


@pytest.fixture(scope="module")
def results(mode, ref_specs, port_specs):
    """(port, reference) results of the batch in `mode`."""
    kw = MODES[mode]
    return (PS.run_batch(port_specs, RATES, PCFG._replace(**kw),
                         device="cpu"),
            RS.run_batch(ref_specs, RATES, RCFG._replace(**kw)))


@pytest.mark.parametrize("i", range(len(HETERO)), ids=NAMES)
def test_recorder_bitwise_equals_reference(i, results):
    got, want = results
    assert "link_busy" in want[i]
    _equal(got[i], want[i])


def test_recorder_conserves_and_windows_reconcile(results, mode):
    got, _ = results
    for res in got:
        np.testing.assert_array_equal(res["inj_node"].sum(1),
                                      res["accepted_n"])
        np.testing.assert_array_equal(res["eject_node"].sum(1),
                                      res["delivered"])
        np.testing.assert_array_equal(res["lat_hist"].sum(1),
                                      res["delivered"])
        np.testing.assert_array_equal(res["lat_hist"][:, 0], 0)
        if "window_cycles" not in res:
            assert mode == "static" and "link_busy_w" not in res
            continue
        assert res["window_cycles"].sum() == PCFG.cycles - PCFG.warmup
        for agg, win in WINDOWED:
            np.testing.assert_array_equal(res[win].sum(axis=1), res[agg],
                                          err_msg=win)


@pytest.fixture(scope="module")
def batched_w4(port_specs):
    return PS.run_batch(port_specs, RATES,
                        PCFG._replace(**MODES["adaptive_w4"]), device="cpu")


@pytest.mark.parametrize("i", range(len(HETERO)), ids=NAMES)
def test_recorder_batched_equals_single_spec(i, port_specs, batched_w4):
    single = PS.run_batch([port_specs[i]], RATES[None, :],
                          PCFG._replace(**MODES["adaptive_w4"]),
                          device="cpu")[0]
    batched = dict(batched_w4[i])
    batched.pop("pad_fill"), single.pop("pad_fill")
    _equal(single, batched)


def test_recorder_fat_pad_is_invisible(port_specs):
    """Pad channels, nodes, ports and ring slots never reach a sliced
    counter: the sacrificial row takes every pad lane."""
    specs = port_specs[:2]
    cfg = PCFG._replace(telemetry=True, telemetry_windows=3)
    tight = PS.run_batch(specs, RATES, cfg, device="cpu")
    shape = PadShape.of(specs)
    fat = PadShape(n=shape.n + 6, p=shape.p + 2, c=shape.c + 23,
                   d=shape.d + 2)
    padded = PS.run_batch(specs, RATES, cfg, pad_shape=fat, device="cpu")
    for a, b in zip(tight, padded):
        a.pop("pad_fill"), b.pop("pad_fill")
        _equal(b, a)


def test_golden_telemetry_fht16_pins():
    r = build_routing(RT.build("folded_hexa_torus", 16))
    spec = _port(RS.make_spec(r, RTR.uniform(r.topo)))
    res = PS.run_batch([spec], np.array([[0.05, 0.2, 0.6]], np.float32),
                       PCFG._replace(telemetry=True), device="cpu")[0]
    for k, want in GOLDEN_FHT16.items():
        assert res[k].tolist() == want, k
    for k, want in GOLDEN_FHT16_TEL.items():
        assert int(res[k].sum()) == want, k
    occ = res["link_occ_sum"]
    np.testing.assert_array_equal(res["link_occ_escape"], occ[:, :, 0])
    np.testing.assert_array_equal(res["link_occ_adaptive"],
                                  occ[:, :, 1:].sum(axis=-1))


def test_recorder_workload_batch_equals_reference():
    """k_pad workload batch with windows, static and adaptive."""
    specs, scheds = [], []
    for name, n in (("mesh", 16), ("octamesh", 25)):
        r = build_routing(RT.build(name, n))
        u, t = RTR.uniform(r.topo), RTR.tornado(r.topo)
        specs.append(RS.make_spec(r, u))
        scheds.append(RS.make_sched_spec(
            [(u, 0.7, 60, 20, 60), (t, 1.0, 40), (u, 0.0, 30)]))
    p_specs = [_port(s) for s in specs]
    p_scheds = [sched_from_reference(dataclasses.asdict(s)) for s in scheds]
    for routing in ("static", "adaptive"):
        kw = dict(telemetry=True, telemetry_windows=3, routing=routing)
        want = RS.run_batch(specs, RATES, RCFG._replace(**kw),
                            schedules=scheds, k_pad=5)
        got = PS.run_batch(p_specs, RATES, PCFG._replace(**kw),
                           schedules=p_scheds, k_pad=5, device="cpu")
        for g, w in zip(got, want):
            _equal(g, w)


def test_recorder_faulted_batch_equals_reference():
    mesh = RT.build("mesh", 16)
    specs = []
    for fs in (RF.sample_faults(mesh, 2, "random", seed=3),
               RF.sample_faults(mesh, 1, "chiplets", seed=0)):
        r = build_routing(fs.apply(mesh))
        specs.append(RS.make_spec(r, fs.mask_traffic(RTR.uniform(mesh))))
    kw = dict(telemetry=True, telemetry_windows=2)
    want = RS.run_batch(specs, RATES, RCFG._replace(**kw))
    got = PS.run_batch([_port(s) for s in specs], RATES,
                       PCFG._replace(**kw), device="cpu")
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("cycles,warmup,w", [(300, 100, 4), (301, 100, 7),
                                             (50, 0, 50), (10, 3, 1)])
def test_window_cycles_equal_reference(cycles, warmup, w):
    cfg = dict(cycles=cycles, warmup=warmup, telemetry=True,
               telemetry_windows=w)
    got = PS.telemetry_window_cycles(PS.SimConfig(**cfg))
    want = RS.telemetry_window_cycles(RS.SimConfig(**cfg))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and got.sum() == cycles - warmup
    with pytest.raises(ValueError, match="must be > 0"):
        PS.telemetry_window_cycles(PS.SimConfig())


def test_recorder_constants_and_off_path(port_specs):
    assert PS.TELEMETRY_KEYS == RS.TELEMETRY_KEYS
    assert PS.TELEMETRY_WINDOW_KEYS == RS.TELEMETRY_WINDOW_KEYS
    assert PS.LAT_HIST_BINS == RS.LAT_HIST_BINS
    off = PS.run_batch(port_specs[:1], RATES, PCFG, device="cpu")[0]
    assert not set(off) & set(PS.TELEMETRY_KEYS + PS.TELEMETRY_WINDOW_KEYS)
