"""The port's collective workloads, configs, ICI model and paper tables
on the CPU, held against the JAX package.

Every architecture config (CONFIG and SMOKE) equals the JAX package's
field for field (dtypes by name); the collective plan of a sharded step,
the chiplet <-> mesh mapping, the collective flow matrices and the
collective / mixed-tenant schedules are equal value for value; the
workload runner's counters on a collective and a mixed-tenant schedule
at N = 16 are bitwise-equal to `repro`'s `alloc="jnp"`; `build_ici_model`
is equal analytically and through the simulator; and the rows of
Fig. 2 and Tables I-III and of the collectives bridge equal
`benchmarks/paper_benches.py`'s CSVs byte for byte (written to a
temporary directory, never to `results/`)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.core.collectives as RCOL  # noqa: E402
import repro.experiments as RX  # noqa: E402
import repro.workloads as RW  # noqa: E402
from benchmarks import paper_benches  # noqa: E402
from repro.core import simulator as RS  # noqa: E402
from repro.core import topology as RT  # noqa: E402
from repro.core.routing import build_routing as ref_routing  # noqa: E402
from repro.models.sharding import step_collective_ops as ref_ops  # noqa: E402
import repro_torch.configs as PC  # noqa: E402
import repro_torch.core.collectives as PCOL  # noqa: E402
import repro_torch.experiments as PX  # noqa: E402
import repro_torch.workloads as PW  # noqa: E402
from repro_torch import figures  # noqa: E402
from repro_torch.convert import (sched_from_reference,  # noqa: E402
                                 spec_from_reference)
from repro_torch.core import simulator as PS  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core.routing import build_routing  # noqa: E402
from repro_torch.models.sharding import step_collective_ops  # noqa: E402
from test_torch_workloads import _assert_schedule_equal  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops in several worker processes: one torch thread each (see
    tests/test_torch_workloads.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = list(RC.ARCHS)
MESHES = [{"data": 8, "model": 8}, {"data": 4, "model": 4},
          {"data": 1, "model": 16}, {"data": 16, "model": 1}]
TOPOS = [("mesh", 16), ("hexamesh", 36), ("folded_hexa_torus", 64)]
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "collective_permute",
         "all_to_all")
RAW = ("delivered", "offered_n", "accepted_n", "lat_sum")
PHASE = ("delivered_ph", "offered_ph", "accepted_ph", "lat_sum_ph")
RATES = np.array([0.05, 0.2, 0.5], np.float32)
RCFG = RS.SimConfig(cycles=300, warmup=100, alloc="jnp")
PCFG = PS.SimConfig(cycles=300, warmup=100)


def _meshes(n):
    """Logical meshes of n chiplets: the default, TP 2, a pure data axis
    and a three-axis mesh."""
    out = [PW.default_mesh_shape(n), PW.default_mesh_shape(n, 2),
           {"data": n, "model": 1}]
    if n % 4 == 0:
        out.append({"pod": 2, "data": n // 8 if n % 8 == 0 else 1,
                    "model": 4 if n % 8 == 0 else n // 2})
    return out


def _dtype_name(x):
    if isinstance(x, torch.dtype):
        return str(x).split(".")[-1]
    return str(jnp.dtype(x))


# ---------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch, smoke):
    got = PC.get_config(arch, smoke=smoke)
    want = RC.get_config(arch, smoke=smoke)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name.endswith("_dtype"):
            assert isinstance(a, torch.dtype), f.name
            assert _dtype_name(a) == _dtype_name(b), f.name
        else:
            assert a == b and type(a) is type(b), f.name
    assert got.layer_specs() == want.layer_specs()
    assert got.pattern() == want.pattern()
    assert PC.get_config(arch.replace("_", "-"), smoke=smoke) is got


def test_registry_equals_reference():
    assert PC.ARCHS == RC.ARCHS
    assert PC.SHAPES == RC.SHAPES
    assert PC.LONG_CONTEXT_OK == RC.LONG_CONTEXT_OK
    assert PC.cells() == RC.cells()
    assert PC.canon("qwen3-moe-235b.a22b") == RC.canon("qwen3-moe-235b.a22b")
    with pytest.raises(ModuleNotFoundError):
        PC.get_config("no-such-arch")


# ---------------------------------------------------------------------
# the collective plan of a sharded step
# ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_step_collective_ops_equal_reference(arch):
    cfg, rcfg = PC.get_config(arch), RC.get_config(arch)
    for mesh in MESHES:
        for kw in ({}, dict(seq_len=512, global_batch=8, dtype_bytes=4)):
            got = step_collective_ops(cfg, mesh, **kw)
            want = ref_ops(rcfg, mesh, **kw)
            assert [dataclasses.astuple(o) for o in got] == \
                [dataclasses.astuple(o) for o in want], (mesh, kw)
    labels = [o.phase for o in step_collective_ops(cfg, MESHES[0])]
    assert ("moe_a2a" in labels) == bool(cfg.n_experts)


# ---------------------------------------------------------------------
# chiplet <-> mesh mapping and flow matrices
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name,n", TOPOS, ids=[f"{a}{b}" for a, b in TOPOS])
def test_mesh_mapping_and_flows_equal_reference(name, n):
    topo, rtopo = PT.build(name, n), RT.build(name, n)
    np.testing.assert_array_equal(PCOL.raster_order(topo),
                                  RCOL.raster_order(rtopo))
    for mesh in _meshes(n):
        got, want = PCOL.mesh_coords(topo, mesh), RCOL.mesh_coords(rtopo,
                                                                   mesh)
        assert list(got) == list(want)
        for axis in mesh:
            np.testing.assert_array_equal(got[axis], want[axis])
            groups = PCOL.mesh_axis_groups(topo, mesh, axis)
            assert groups == RCOL.mesh_axis_groups(rtopo, mesh, axis)
            for kind in KINDS:
                np.testing.assert_array_equal(
                    PCOL.collective_flow(n, kind, groups, 1234.5),
                    RCOL.collective_flow(n, kind, groups, 1234.5))
    assert PW.default_mesh_shape(n) == RW.default_mesh_shape(n)
    assert PW.default_mesh_shape(n, 2) == RW.default_mesh_shape(n, 2)
    with pytest.raises(ValueError, match="slots"):
        PCOL.mesh_coords(topo, {"data": n + 1})
    with pytest.raises(KeyError, match="not in mesh"):
        PCOL.mesh_axis_groups(topo, {"data": n}, "model")
    with pytest.raises(KeyError, match="unknown collective"):
        PCOL.collective_flow(n, "broadcastish", [[0, 1]], 1.0)
    with pytest.raises(ValueError, match="does not divide"):
        PW.default_mesh_shape(n, n + 1)


# ---------------------------------------------------------------------
# collective and mixed-tenant schedules
# ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_collective_and_mixed_schedules_equal_reference(arch):
    cfg, rcfg = PC.get_config(arch), RC.get_config(arch)
    for name, n in (("folded_hexa_torus", 16), ("hexamesh", 36)):
        topo, rtopo = PT.build(name, n), RT.build(name, n)
        got = PW.collective_workload(cfg, topo)
        _assert_schedule_equal(got, RW.collective_workload(rcfg, rtopo))
        assert ("moe_a2a" in [p.label for p in got.phases]) == \
            bool(cfg.n_experts)
        kw = dict(mesh_shape={"data": n // 2, "model": 2}, seq_len=1024,
                  step_cycles=700, min_phase=20)
        _assert_schedule_equal(PW.collective_workload(cfg, topo, **kw),
                               RW.collective_workload(rcfg, rtopo, **kw))
        for pattern, frac in (("uniform", 0.3), ("tornado", 0.0),
                              ("neighbor", 1.0)):
            _assert_schedule_equal(
                PW.mixed_tenant_workload(cfg, topo, serve_pattern=pattern,
                                         serve_frac=frac),
                RW.mixed_tenant_workload(rcfg, rtopo, serve_pattern=pattern,
                                         serve_frac=frac))
        got = PW.mixed_tenant(cfg, "uniform", 0.3)
        want = RW.mixed_tenant(rcfg, "uniform", 0.3)
        assert got.name == want.name
        _assert_schedule_equal(got.build(topo), want.build(rtopo))
    wls = PW.collective_workloads([cfg], step_cycles=600)
    rwls = RW.collective_workloads([rcfg], step_cycles=600)
    assert [w.name for w in wls] == [w.name for w in rwls]
    _assert_schedule_equal(wls[0].build(topo), rwls[0].build(rtopo))


def test_superimpose_equals_reference_and_checks_inputs():
    topo, rtopo = PT.build("mesh", 16), RT.build("mesh", 16)
    cfg, rcfg = PC.get_config("qwen3-1.7b"), RC.get_config("qwen3-1.7b")
    sched = PW.collective_workload(cfg, topo)
    rsched = RW.collective_workload(rcfg, rtopo)
    bg = np.random.default_rng(4).random((16, 16))
    for frac in (0.0, 0.25, 1.0):
        _assert_schedule_equal(PW.superimpose(sched, bg, frac),
                               RW.superimpose(rsched, bg, frac))
    _assert_schedule_equal(PW.superimpose(sched, bg, 0.5, name="x"),
                           RW.superimpose(rsched, bg, 0.5, name="x"))
    with pytest.raises(ValueError, match="frac"):
        PW.superimpose(sched, bg, 1.5)
    with pytest.raises(ValueError, match="background shape"):
        PW.superimpose(sched, bg[:8], 0.5)


@pytest.mark.parametrize("kind", ["collective", "mixed"])
def test_workload_run_batch_bitwise_equals_reference(kind):
    """A collective (MoE: five phases) and a mixed-tenant schedule at
    N = 16 through both runners, specs and schedules carried across."""
    cfg = RC.get_config("qwen3_moe_235b_a22b")
    specs, scheds = [], []
    for name in ("folded_hexa_torus", "mesh"):
        r = ref_routing(RT.build(name, 16))
        sched = (RW.collective_workload(cfg, r.topo, step_cycles=400)
                 if kind == "collective" else
                 RW.mixed_tenant_workload(cfg, r.topo, step_cycles=400))
        specs.append(RS.make_spec(r, sched.mean_traffic()))
        scheds.append(sched.fit(RCFG.cycles - RCFG.warmup).compile())
    want = RS.run_batch(specs, RATES, RCFG, schedules=scheds)
    got = PS.run_batch([spec_from_reference(dataclasses.asdict(s))
                        for s in specs], RATES, PCFG,
                       schedules=[sched_from_reference(dataclasses.asdict(s))
                                  for s in scheds], device="cpu")
    for g, w in zip(got, want):
        for k in RAW + PHASE:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
        assert g["delivered"].max() > 0
    # the port's own build of the same schedules gives the same inputs
    topo = PT.build("folded_hexa_torus", 16)
    pcfg = PC.get_config("qwen3_moe_235b_a22b")
    own = (PW.collective_workload(pcfg, topo, step_cycles=400)
           if kind == "collective" else
           PW.mixed_tenant_workload(pcfg, topo, step_cycles=400))
    spec = PS.make_spec(build_routing(topo), own.mean_traffic())
    for f in dataclasses.fields(PS.SimSpec):
        np.testing.assert_array_equal(
            getattr(spec, f.name),
            getattr(spec_from_reference(dataclasses.asdict(specs[0])),
                    f.name), err_msg=f.name)


# ---------------------------------------------------------------------
# the ICI model
# ---------------------------------------------------------------------

def _ici_equal(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for kind in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
                 "collective_permute"):
        for s in (2.0 ** 24, 2.0 ** 30):
            assert got.collective_time_s(kind, s) == \
                want.collective_time_s(kind, s)


@pytest.mark.parametrize("n", [16, 64])
def test_ici_model_analytic_equals_reference(n):
    for name in ("mesh", "hexamesh", "folded_torus", "folded_hexa_torus"):
        for substrate in ("organic", "glass"):
            _ici_equal(PCOL.build_ici_model(name, n, substrate),
                       RCOL.build_ici_model(name, n, substrate))
    assert PCOL.compare_topologies(2.0 ** 30, n=n) == \
        RCOL.compare_topologies(2.0 ** 30, n=n)


def test_ici_model_simulated_equals_reference(monkeypatch):
    """use_sim=True at N = 16 with a short run: the Experiment each
    package builds gets a small SimConfig."""
    monkeypatch.setattr(RX, "Experiment", functools.partial(
        RX.Experiment, cfg=RS.SimConfig(cycles=240, warmup=80,
                                        alloc="jnp")))
    monkeypatch.setattr(PX, "Experiment", functools.partial(
        PX.Experiment, cfg=PS.SimConfig(cycles=240, warmup=80)))
    RCOL.build_ici_model.cache_clear()
    PCOL.build_ici_model.cache_clear()
    try:
        for name in ("folded_hexa_torus", "mesh"):
            got = PCOL.build_ici_model(name, 16, "organic", use_sim=True,
                                       device="cpu")
            want = RCOL.build_ici_model(name, 16, "organic", use_sim=True)
            _ici_equal(got, want)
            assert got.b_eff_gbps != PCOL.build_ici_model(
                name, 16, "organic").b_eff_gbps
        # the device is part of the cache key
        assert PCOL.build_ici_model("mesh", 16, "organic", True, "cpu") is \
            PCOL.build_ici_model("mesh", 16, "organic", True, "cpu")
        info = PCOL.build_ici_model.cache_info()
        assert info.hits >= 1
    finally:
        RCOL.build_ici_model.cache_clear()
        PCOL.build_ici_model.cache_clear()


# ---------------------------------------------------------------------
# the paper's other tables
# ---------------------------------------------------------------------

REF_TABLES = {"fig2": paper_benches.fig2_linkmodel,
              "table1": paper_benches.table1_area,
              "table2": paper_benches.table2_power,
              "table3": paper_benches.table3_properties,
              "collectives": paper_benches.collectives_bridge}


@pytest.mark.parametrize("name", list(REF_TABLES))
def test_table_rows_equal_reference(name, tmp_path, monkeypatch):
    """Each table's CSV equals the JAX package's bench, byte for byte
    (the reference writes to a temporary RESULTS_DIR); Table II at two
    sizes."""
    sizes = [16, 64] if name == "table2" else None
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    monkeypatch.setattr(paper_benches, "RESULTS_DIR", str(ref_dir))
    REF_TABLES[name](sizes)
    rows = figures.table(name, sizes, device="cpu", out_dir=str(port_dir))
    want = (ref_dir / f"{name}.csv").read_bytes()
    assert (port_dir / f"{name}.csv").read_bytes() == want
    assert len(rows) == want.count(b"\n") - 1 > 0


def test_figures_cli_writes_a_table(tmp_path, capsys):
    assert figures.main(["--only", "table3", "--device", "cpu", "--out",
                         str(tmp_path)]) == 0
    text = (tmp_path / "table3.csv").read_text()
    assert text.startswith("schema_version,topology,n,diameter")
    assert "table3," in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            figures.table("fig2", out_dir=None)
