"""The port's experiment API on the CPU gives the JAX package's tidy rows
and raw results: one Experiment mixing static, workload, degraded
(empty `FaultSet`, link faults, chiplet faults) and invalid scenarios
goes through `repro.experiments.run` and `repro_torch.experiments.run(...,
device="cpu")`, row by row and column by column.  Also held: plan
buckets and skip reasons, `single_program`, `chunk_size` with progress,
`on_error="skip"`, the CSV and JSON bytes, the analytic backend,
the legacy per-scenario views, the sweep engine's group keys,
`figures`, adaptive scenarios, and the flight recorder's columns and
per-link / per-window views."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.experiments as RX  # noqa: E402
import repro.faults as RF  # noqa: E402
import repro.workloads as RW  # noqa: E402
from repro.core import topology as RT  # noqa: E402
from repro.core.simulator import SimConfig as RCfg  # noqa: E402
from repro.sweep.engine import SweepEngine as REngine  # noqa: E402
import repro_torch.experiments as PX  # noqa: E402
import repro_torch.faults as PF  # noqa: E402
import repro_torch.workloads as PW  # noqa: E402
from repro_torch import figures  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core.simulator import SimConfig as PCfg  # noqa: E402
from repro_torch.sweep.engine import SweepEngine  # noqa: E402


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


RCFG = RCfg(cycles=300, warmup=100, alloc="jnp")
PCFG = PCfg(cycles=300, warmup=100)
RAW = ("delivered", "offered_n", "accepted_n", "lat_sum")


def _scenarios(X, W, F, T):
    """The mixed grid, built with either package's classes."""
    g3 = X.SaturationGrid(3)
    alt = W.Workload("alt", lambda t: W.phase_alternating(
        t, phase_cycles=60, repeats=1))
    trace = W.Workload("trace", lambda t: W.trace_workload(
        t, "fluidanimate", region_cycles=40))
    burst = W.Workload("burst", lambda t: W.bursty_uniform(
        t, on=5, off=15, cycles=200))
    fht = T.build("folded_hexa_torus", 16)
    links = F.sample_faults(fht, 2, "random", seed=0)
    chips = F.sample_faults(fht, 1, "chiplets", seed=0)
    return [
        X.Scenario("mesh", 16, rates=g3),                               # 0
        X.Scenario("folded_hexa_torus", 16, rates=g3),                  # 1
        X.Scenario("hexamesh", 16, "glass", "tornado", rates=g3),       # 2
        X.Scenario("hypercube", 15),                                    # 3
        X.Scenario("mesh", 16, traffic=alt, rates=g3),                  # 4
        X.Scenario("folded_hexa_torus", 16, traffic=trace,
                   roles="hetero_cmi", rates=g3),                       # 5
        X.Scenario("folded_hexa_torus", 16, traffic=burst,
                   rates=X.ExplicitRates((0.1, 0.3))),                  # 6
        X.Scenario("folded_hexa_torus", 16, faults=F.FaultSet(),
                   rates=g3),                                           # 7
        X.Scenario("folded_hexa_torus", 16, faults=links, rates=g3,
                   tags=(("faulted", "links"),)),                       # 8
        X.Scenario("folded_hexa_torus", 16, faults=chips, rates=g3),    # 9
        X.Scenario("folded_hexa_torus", 16, faults=chips, traffic=alt,
                   rates=g3),                                           # 10
    ]


N_SCEN = 11


def _ref_exp(**kw):
    return RX.Experiment(_scenarios(RX, RW, RF, RT), cfg=RCFG,
                         name="mixed", **kw)


def _port_exp(**kw):
    return PX.Experiment(_scenarios(PX, PW, PF, PT), cfg=PCFG,
                         name="mixed", **kw)


@pytest.fixture(scope="module")
def ref_frame():
    return RX.run(_ref_exp(), engine=REngine(cfg=RCFG))


@pytest.fixture(scope="module")
def port_frame():
    return PX.run(_port_exp(), engine=SweepEngine(cfg=PCFG, device="cpu"))


def _rows_equal(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k] == v and type(got[k]) is type(v), (k, got[k], v)


def _results_equal(got, want):
    if want is None:
        assert got is None
        return
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "pad_fill":
            assert got[k] == v
            continue
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k


# ---------------------------------------------------------------------
# acceptance: the same rows and results as the JAX package
# ---------------------------------------------------------------------

@pytest.mark.parametrize("i", range(N_SCEN))
def test_tidy_rows_equal_reference(i, port_frame, ref_frame):
    _rows_equal(port_frame.rows[i], ref_frame.rows[i])


@pytest.mark.parametrize("i", range(N_SCEN))
def test_raw_results_equal_reference(i, port_frame, ref_frame):
    _results_equal(port_frame.results[i], ref_frame.results[i])


def test_statuses_and_columns(port_frame, ref_frame):
    assert [r["status"] for r in port_frame.rows] == \
        ["ok"] * 3 + ["invalid"] + ["ok"] * 7
    assert port_frame.columns == ref_frame.columns
    assert port_frame.rows[3]["diag_code"] == "DP006"
    assert port_frame.errors == ref_frame.errors == []


def test_empty_faultset_row_equals_pristine(port_frame):
    pristine, empty = port_frame.rows[1], port_frame.rows[7]
    assert empty == pristine
    assert port_frame.planned[7].routing is port_frame.planned[1].routing
    _results_equal(port_frame.results[7], port_frame.results[1])
    assert port_frame.rows[8]["faults"] != "none"
    assert port_frame.rows[9]["failed_chiplets"] == 1


def test_legacy_views_equal_reference(port_frame, ref_frame):
    for i in range(N_SCEN):
        got, want = port_frame.case_result(i), ref_frame.case_result(i)
        if want is None:
            assert got is None
            continue
        for k in ("sim_saturation", "analytic_saturation",
                  "latency_at_sat"):
            assert got[k] == want[k], (i, k)
        w_got, w_want = port_frame.workload_result(i), \
            ref_frame.workload_result(i)
        for k in ("workload", "phase_labels"):
            assert w_got.get(k) == w_want.get(k), (i, k)
        for k in ("throughput_ph", "latency_ph", "offered_rate_ph",
                  "phase_cycles"):
            if k in w_want:
                np.testing.assert_array_equal(w_got[k], w_want[k])


@pytest.mark.parametrize("i", [4, 5, 6, 10])
def test_workload_scenario_equals_single_spec_oracle(i, port_frame):
    """A workload scenario's sweep equals the port's own single-spec
    `run_batch` fed the planned (fitted, fault-masked) schedule and rate
    grid; a chiplet-faulted schedule is masked in every phase."""
    from repro_torch.core.simulator import run_batch
    ps = port_frame.planned[i]
    single = run_batch([ps.spec], ps.rates[None, :], PCFG,
                       schedules=[ps.sched_spec], device="cpu")[0]
    for k in RAW + ("delivered_ph", "lat_sum_ph", "phase_cycles"):
        np.testing.assert_array_equal(single[k], port_frame.results[i][k],
                                      err_msg=k)
    assert ps.schedule.total_cycles == PCFG.cycles - PCFG.warmup
    if ps.scenario.degraded:
        dead = ps.scenario.faults.chiplets[0]
        for p in ps.schedule.phases:
            m = np.asarray(p.traffic)
            assert m[dead].sum() == 0 and m[:, dead].sum() == 0


# ---------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------

def test_plan_buckets_and_skips_equal_reference():
    for single in (False, True):
        got = PX.plan(_port_exp(), single_program=single)
        want = RX.plan(_ref_exp(), single_program=single)
        assert got.skipped == want.skipped
        assert got.skip_codes == want.skip_codes
        assert got.describe() == want.describe()
        assert [[ps.index for ps in b.items] for b in got.buckets] == \
            [[ps.index for ps in b.items] for b in want.buckets]
        for b, c in zip(got.buckets, want.buckets):
            for ps, qs in zip(b.items, c.items):
                np.testing.assert_array_equal(ps.rates, qs.rates)
                np.testing.assert_array_equal(ps.traffic, qs.traffic)
                assert ps.analytic == qs.analytic


def test_rate_policies_and_traffic_errors_equal_reference():
    for n_rates, headroom in ((5, None), (3, 2.5)):
        got = PX.SaturationGrid(n_rates, headroom)
        want = RX.SaturationGrid(n_rates, headroom)
        np.testing.assert_array_equal(got.resolve(0.4), want.resolve(0.4))
        assert got.describe() == want.describe()
    ex = PX.ExplicitRates((0.3, 0.1))
    np.testing.assert_array_equal(
        ex.resolve(123.0), RX.ExplicitRates((0.3, 0.1)).resolve(123.0))
    assert ex.describe() == RX.ExplicitRates((0.3, 0.1)).describe()
    with pytest.raises(ValueError):
        PX.ExplicitRates(())
    with pytest.raises(KeyError, match="unknown traffic pattern"):
        PX.plan(PX.Experiment([PX.Scenario("mesh", 16,
                                           traffic="nonesuch")], cfg=PCFG))
    from repro_torch.core import traffic as PTR
    with pytest.raises(TypeError, match="CustomTraffic"):
        PX.plan(PX.Experiment([PX.Scenario("mesh", 16,
                                           traffic=PTR.uniform)], cfg=PCFG))
    with pytest.raises(ValueError, match="reserved"):
        PX.Scenario("mesh", 16, tags=(("status", "x"),))
    with pytest.raises(ValueError, match="routing"):
        PX.Scenario("mesh", 16, routing="wild")


def test_fault_rejection_skips_as_the_reference():
    def scens(X, F, T):
        e = np.sort(np.asarray(T.build("mesh", 16).edges), axis=1)
        cut = F.FaultSet(links=tuple(tuple(int(x) for x in lk)
                                     for lk in e[(e == 0).any(1)]))
        return [X.Scenario("mesh", 16, faults=cut)]
    got = PX.plan(PX.Experiment(scens(PX, PF, PT), cfg=PCFG))
    want = RX.plan(RX.Experiment(scens(RX, RF, RT), cfg=RCFG))
    assert got.skipped == want.skipped and got.skip_codes == \
        want.skip_codes == {0: "FT001"}


#: specs as (topology, N, phase count; 0 for a static spec), and whether
#: they form one `single_program` batch
KEY_CASES = {
    "static-mesh": ([("mesh", 16, 0)], False),
    "static-fht": ([("folded_hexa_torus", 36, 0)], False),
    "workload-odd": ([("hypercube", 16, 3)], False),
    "workload-even": ([("folded_hexa_torus", 16, 4)], False),
    "single-static": ([("mesh", 16, 0), ("hypercube", 16, 0),
                       ("folded_hexa_torus", 36, 0)], True),
    "single-workload": ([("mesh", 16, 5), ("folded_hexa_torus", 16, 2)],
                        True),
}


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_group_key_equals_reference_bucketing(case):
    """The engine's group of a spec (`group_key`) and of a
    `single_program` batch (`merged_key`) are the reference engine's
    `bucket_shape` and its rounding of the phase count."""
    from repro.sweep.engine import _round_up as ref_round_up
    from repro.sweep.padding import PadShape as RPad
    from repro_torch.core.routing import build_routing
    from repro_torch.core.simulator import make_spec
    from repro_torch.core.traffic import uniform
    from repro_torch.sweep import engine as E
    cells, single = KEY_CASES[case]
    specs, scheds = [], []
    for name, n, k in cells:
        r = build_routing(PT.build(name, n))
        specs.append(make_spec(r, uniform(r.topo)))
        scheds.append(PW.hotspot_drift(r.topo, n_phases=k, dwell=50)
                      .compile() if k else None)
    ks = [sc.k if sc is not None else 0 for sc in scheds]
    assert ks == [k for _, _, k in cells]
    ref = REngine(cfg=RCFG)

    def dims(shape):
        return (shape.n, shape.p, shape.c, shape.d)

    if single:
        got = [E.merged_key(specs, scheds)]
        want = [(ref.bucket_shape(RPad.of(specs)),
                 max(ref_round_up(k, ref.k_round) for k in ks))]
    else:
        got = [E.group_key(spec, sc) for spec, sc in zip(specs, scheds)]
        want = [(ref.bucket_shape(RPad(*dims(spec))),
                 ref_round_up(k, ref.k_round))
                for spec, k in zip(specs, ks)]
    assert [(dims(sh), k) for sh, k in got] == \
        [(dims(sh), k) for sh, k in want]


def test_sweep_imports_nothing_of_the_experiment_api():
    """The sweep engine sits below the experiment API: no module of
    `repro_torch.sweep` imports `repro_torch.experiments`."""
    import ast
    import pathlib
    import repro_torch.sweep as S
    pkg = ["repro_torch", "sweep"]
    for path in sorted(pathlib.Path(S.__file__).parent.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                base = pkg[:len(pkg) + 1 - node.level] if node.level \
                    else []
                mod = ".".join(base + ([node.module] if node.module
                                       else []))
                names = [mod] + [f"{mod}.{a.name}" for a in node.names]
            else:
                continue
            assert not any(m.split(".")[:2] == ["repro_torch",
                                                "experiments"]
                           for m in names), (path.name, names)


# ---------------------------------------------------------------------
# execution: single program, chunks, progress, failures
# ---------------------------------------------------------------------

def test_single_program_equals_grouped(port_frame):
    one = PX.run(_port_exp(), engine=SweepEngine(cfg=PCFG, device="cpu"),
                 single_program=True)
    for i in range(N_SCEN):
        _results_equal({k: v for k, v in one.results[i].items()
                        if k != "pad_fill"} if one.results[i] else None,
                       {k: v for k, v in port_frame.results[i].items()
                        if k != "pad_fill"} if port_frame.results[i]
                       else None)


def test_chunked_execution_and_progress(port_frame):
    exp = PX.Experiment(_port_exp().scenarios[:3], cfg=PCFG)
    ticks, infos = [], []
    frame = PX.run(exp, device="cpu", chunk_size=1,
                   progress=lambda done, total, key, info: (
                       ticks.append((done, total)), infos.append(info)))
    for i in range(3):
        _results_equal(frame.results[i], port_frame.results[i])
    assert ticks[-1] == (3, 3) and len(ticks) == 3
    assert all(i["compiled"] == 0 and i["status"] == "ok" for i in infos)
    legacy = []
    PX.run(exp, device="cpu", chunk_size=2,
           progress=lambda done, total, key: legacy.append(done))
    assert legacy[-1] == 3


class _FailingEngine(SweepEngine):
    """Raises for any chunk containing the poisoned topology size."""
    poison_n: int = 0

    def run_specs(self, specs, rates, single_program=False, cfg=None):
        if any(s.n == self.poison_n for s in specs):
            raise RuntimeError("injected failure")
        return super().run_specs(specs, rates, single_program, cfg=cfg)


def test_partial_failure_isolation(port_frame):
    eng = _FailingEngine(cfg=PCFG, device="cpu")
    eng.poison_n = 36
    exp = PX.Experiment([PX.Scenario("mesh", 16, rates=PX.SaturationGrid(3)),
                         PX.Scenario("mesh", 36),
                         PX.Scenario("folded_hexa_torus", 16,
                                     rates=PX.SaturationGrid(3))], cfg=PCFG)
    with pytest.raises(RuntimeError, match="injected"):
        PX.run(exp, engine=eng)
    frame = PX.run(exp, engine=eng, chunk_size=1, on_error="skip")
    assert [r["status"] for r in frame.rows] == ["ok", "failed", "ok"]
    assert "injected failure" in frame.rows[1]["error"]
    assert frame.rows[1]["diag_code"] == "EX001"
    assert frame.errors[0][0] == 1
    _results_equal(frame.results[0], port_frame.results[0])
    _results_equal(frame.results[2], port_frame.results[1])
    with pytest.raises(ValueError, match="on_error"):
        PX.run(exp, engine=eng, on_error="ignore")


# ---------------------------------------------------------------------
# writers, analytic backend, shims
# ---------------------------------------------------------------------

def test_csv_and_json_bytes_equal_reference(port_frame, ref_frame,
                                            tmp_path):
    assert PX.SCHEMA_VERSION == RX.SCHEMA_VERSION
    for fail in (False, True):
        port_frame.to_csv(str(tmp_path / "p.csv"), include_failures=fail)
        ref_frame.to_csv(str(tmp_path / "r.csv"), include_failures=fail)
        assert (tmp_path / "p.csv").read_bytes() == \
            (tmp_path / "r.csv").read_bytes()
        port_frame.to_json(str(tmp_path / "p.json"), include_failures=fail)
        ref_frame.to_json(str(tmp_path / "r.json"), include_failures=fail)
        assert (tmp_path / "p.json").read_bytes() == \
            (tmp_path / "r.json").read_bytes()
    assert PX.read_json(str(tmp_path / "p.json"))["n_scenarios"] == N_SCEN
    rows = [dict(b=1, a=2), None, dict(a=3, b=4, c='say "hi", x')]
    assert PX.write_csv(str(tmp_path / "p2.csv"), rows) == \
        RX.write_csv(str(tmp_path / "r2.csv"), rows)
    assert (tmp_path / "p2.csv").read_bytes() == \
        (tmp_path / "r2.csv").read_bytes()


def test_analytic_backend_equals_reference():
    got = PX.run(_port_exp(backend="analytic"), device="cpu")
    want = RX.run(_ref_exp(backend="analytic"))
    for a, b in zip(got.rows, want.rows):
        _rows_equal(a, b)
    assert got.results == want.results == [None, None, None, None] + \
        [None] * (N_SCEN - 4)


# ---------------------------------------------------------------------
# one routing walk a planned scenario: the plan's hops and latency
# ---------------------------------------------------------------------

def _planned(pl) -> dict:
    return {ps.index: ps for b in pl.buckets for ps in b.items}


@pytest.fixture(scope="module")
def analytic_plan():
    return PX.plan(_port_exp(backend="analytic"))


@pytest.mark.parametrize("backend", ["sim", "analytic"])
@pytest.mark.parametrize("i", range(N_SCEN))
def test_planned_walk_values_equal_a_fresh_walk(i, backend, port_frame,
                                                analytic_plan):
    """The planner's one walk gives `analytic`, `avg_hops` and
    `zero_load_cycles` bit for bit as `saturation_rate`, a fresh
    `paths_channel_loads` and `zero_load_latency` do (static, workload
    and degraded scenarios; the skipped one has none)."""
    from repro_torch.core.simulator import zero_load_latency
    ps = (port_frame.planned[i] if backend == "sim"
          else _planned(analytic_plan).get(i))
    if i == 3:                       # hypercube at N = 15: skipped
        assert ps is None
        return
    _, hops, _ = ps.routing.paths_channel_loads(ps.traffic)
    w = ps.traffic / max(ps.traffic.sum(), 1e-12)
    for got, want in ((ps.analytic, ps.routing.saturation_rate(ps.traffic)),
                      (ps.avg_hops, float((hops * w).sum())),
                      (ps.zero_load_cycles,
                       zero_load_latency(ps.routing, ps.traffic))):
        assert type(got) is float and got == want


@pytest.mark.parametrize("backend", ["sim", "analytic"])
def test_routing_walks_once_a_planned_scenario(backend):
    """`routing.walks` rises by one a planned scenario in `plan()` and
    not at all in `execute()`: the tidy rows walk no path."""
    from repro_torch.obs.metrics import metrics
    before = metrics.get("routing.walks")
    pl = PX.plan(_port_exp(backend=backend))
    planned = metrics.get("routing.walks")
    assert pl.n_planned == N_SCEN - 1
    assert planned - before == pl.n_planned
    frame = PX.execute(pl, device="cpu")
    assert metrics.get("routing.walks") == planned
    assert [r["status"] for r in frame.rows].count("ok") == pl.n_planned


def test_fig8_frame_equals_reference(tmp_path):
    """`figures.fig8` at one tiny size, simulated on the CPU, gives the
    JAX package's frame for the same scenarios."""
    cfg = PCfg(cycles=120, warmup=40)
    got = figures.figure("fig8", sizes=[9], use_sim=True, cfg=cfg,
                         device="cpu", out_dir=str(tmp_path))
    want = RX.run(RX.Experiment(
        [RX.Scenario(name, 9, "glass", pattern)
         for pattern in ("permutation", "tornado", "neighbor")
         for name in RT.GENERATORS],
        cfg=RCfg(cycles=120, warmup=40, alloc="jnp"), name="fig8",
        backend="sim"))
    assert len(got) == len(want) > 0
    for a, b in zip(got.rows, want.rows):
        _rows_equal(a, b)
    for a, b in zip(got.results, want.results):
        _results_equal(a, b)
    want.to_csv(str(tmp_path / "want.csv"))
    assert (tmp_path / "fig8.csv").read_bytes() == \
        (tmp_path / "want.csv").read_bytes()


def test_figures_cli_writes_csv(tmp_path, capsys):
    assert figures.main(["--only", "fig4", "--sizes", "16", "--device",
                         "cpu", "--out", str(tmp_path)]) == 0
    assert (tmp_path / "fig4.csv").read_text().startswith(
        "schema_version,experiment,backend")
    assert "fig4," in capsys.readouterr().out


# ---------------------------------------------------------------------
# deferred paths and device rules
# ---------------------------------------------------------------------

def _adaptive_scenarios(X):
    g3 = X.SaturationGrid(3)
    return [X.Scenario("mesh", 16, rates=g3),
            X.Scenario("mesh", 16, routing="adaptive", rates=g3),
            X.Scenario("folded_hexa_torus", 16, routing="adaptive",
                       rates=g3)]


def test_adaptive_scenario_plans_and_runs_like_reference(tmp_path):
    """Adaptive scenarios (per Scenario and through the Experiment's
    SimConfig) plan the reference's buckets and run to its rows, raw
    results and CSV bytes."""
    for cfg_kw in ({}, dict(routing="adaptive")):
        ref = RX.Experiment(_adaptive_scenarios(RX),
                            cfg=RCFG._replace(**cfg_kw), name="adaptive")
        port = PX.Experiment(_adaptive_scenarios(PX),
                             cfg=PCFG._replace(**cfg_kw), name="adaptive")
        assert [b.key.routing for b in PX.plan(port).buckets] == \
            [b.key.routing for b in RX.plan(ref).buckets]
        want = RX.run(ref)
        got = PX.run(port, device="cpu")
        assert [r["routing"] for r in got.rows] == \
            [r["routing"] for r in want.rows]
        for a, b in zip(got.rows, want.rows):
            _rows_equal(a, b)
        for a, b in zip(got.results, want.results):
            _results_equal(a, b)
        got.to_csv(str(tmp_path / "got.csv"))
        want.to_csv(str(tmp_path / "want.csv"))
        assert (tmp_path / "got.csv").read_bytes() == \
            (tmp_path / "want.csv").read_bytes()


def test_reference_faultset_is_rejected():
    with pytest.raises(TypeError, match="FaultSet"):
        PX.Scenario("mesh", 16, faults=RF.FaultSet(links=((0, 1),)))
    with pytest.raises(TypeError, match="FaultSet"):
        PX.Scenario("mesh", 16, faults=[(0, 1)])


def _telemetry_scenarios(X, F, T):
    g3 = X.SaturationGrid(3)
    chips = F.sample_faults(T.build("folded_hexa_torus", 16), 1,
                            "chiplets", seed=0)
    return [X.Scenario("mesh", 16, rates=g3, tags=(("cell", "a"),)),
            X.Scenario("folded_hexa_torus", 16, routing="adaptive",
                       rates=g3),
            X.Scenario("folded_hexa_torus", 16, faults=chips, rates=g3)]


@pytest.fixture(scope="module")
def telemetry_frames():
    """(port, reference) frames of a telemetry Experiment with 3 windows:
    static, adaptive and a degraded scenario (dead-link rows)."""
    kw = dict(telemetry=True, telemetry_windows=3)
    want = RX.run(RX.Experiment(_telemetry_scenarios(RX, RF, RT),
                                cfg=RCFG._replace(**kw), name="tel"))
    got = PX.run(PX.Experiment(_telemetry_scenarios(PX, PF, PT),
                               cfg=PCFG._replace(**kw), name="tel"),
                 device="cpu")
    return got, want


@pytest.mark.parametrize("view", ["link_rows", "window_rows"])
def test_telemetry_views_equal_reference(view, telemetry_frames, tmp_path):
    """`ResultFrame`'s per-link and per-window views: rows, the `all_`
    form and the CSV bytes equal the reference's; the tidy rows carry
    the link-load columns."""
    got, want = telemetry_frames
    for i in range(len(want.rows)):
        assert getattr(got, view)(i) == getattr(want, view)(i)
        assert getattr(got, view)(i, rate_index=0) == \
            getattr(want, view)(i, rate_index=0)
    assert getattr(got, "all_" + view)() == getattr(want, "all_" + view)()
    csv = "to_link_csv" if view == "link_rows" else "to_window_csv"
    getattr(got, csv)(str(tmp_path / "got.csv"))
    getattr(want, csv)(str(tmp_path / "want.csv"))
    assert (tmp_path / "got.csv").read_bytes() == \
        (tmp_path / "want.csv").read_bytes()
    for a, b in zip(got.rows, want.rows):
        _rows_equal(a, b)
        assert a["link_gini"] is not None and a["link_util_max"] > 0


def test_entry_points_need_a_card_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    exp = PX.Experiment([PX.Scenario("mesh", 16)], cfg=PCFG,
                        backend="analytic")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PX.run(exp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PX.engine_for(PCFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        figures.main(["--only", "fig4", "--sizes", "16"])
    assert PX.engine_for(PCFG, "cpu") is PX.engine_for(PCFG, "cpu")
    assert PX.engine_for(PCFG, "cpu").device == "cpu"
