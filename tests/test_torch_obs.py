"""The port's observability modules equal the JAX package's: the flight
recorder's reports (`obs.flight`, `obs.report`) at `benchmarks/
obs_bench.py`'s smoke setting — the channel-load Gini held to `repro`'s
live value, the link-load and window CSVs byte-equal to the ones it
wrote under results/ — the BENCH documents and their regression gate
(`obs.bench`, on the reference's own BENCH files), the runner profiles
(`obs.profile`), and the table format of `tools/smoke_reference.py
adaptive` (the port's CPU path on a cut-down copy of chip_smoke's
adaptive_telemetry scenarios against the JAX package's)."""
import glob
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.experiments as RX  # noqa: E402
import repro.obs as RO  # noqa: E402
from repro.core.simulator import SimConfig as RCfg  # noqa: E402
from repro.obs import bench as RB  # noqa: E402
from repro.obs import report as RR  # noqa: E402
import repro_torch.experiments as PX  # noqa: E402
import repro_torch.obs as PO  # noqa: E402
import repro_torch.workloads as PW  # noqa: E402
from repro_torch.core import simulator as PS  # noqa: E402
from repro_torch.core import topology as PT, traffic as PTR  # noqa: E402
from repro_torch.core.routing import build_routing  # noqa: E402
from repro_torch.obs import bench as PB  # noqa: E402
from repro_torch.obs import profile as PP  # noqa: E402
from repro_torch.obs import report as PR  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "results")
# obs_bench's SMOKE: N = 16, organic, uniform, 360 cycles, 120 warm-up,
# 3 rates; its window companion adds hotspot_drift at 6 windows
SMOKE = dict(cycles=360, warmup=120, telemetry=True)
TOPOLOGIES = ("mesh", "torus", "folded_hexa_torus")
# results/link_load_summary.csv's Gini column
CSV_GINI = {"mesh": 0.382899, "torus": 0.349286,
            "folded_hexa_torus": 0.293657}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on one CPU; these
    tests' ops are small, so they run on one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _link_exp(X, cfg):
    return X.Experiment(
        [X.Scenario(name, 16, "organic", traffic="uniform",
                    rates=X.SaturationGrid(3)) for name in TOPOLOGIES],
        cfg=cfg, name="link_load")


def _window_exp(X, W, cfg):
    wl = W.Workload("hotspot_drift",
                    lambda topo: W.hotspot_drift(topo, n_phases=6, dwell=200))
    return X.Experiment(
        [X.Scenario("folded_hexa_torus", 16, traffic=wl,
                    rates=X.SaturationGrid(3))],
        cfg=cfg._replace(telemetry_windows=6), name="window_heatmap")


@pytest.fixture(scope="module")
def link_frames():
    return (PX.run(_link_exp(PX, PS.SimConfig(**SMOKE)), device="cpu"),
            RX.run(_link_exp(RX, RCfg(alloc="jnp", **SMOKE))))


def test_link_load_gini_equals_live_reference(link_frames):
    got, want = link_frames
    summary = PR.link_load_summary(got.all_link_rows())
    assert summary == RR.link_load_summary(want.all_link_rows())
    assert {s["topology"]: s["gini"] for s in summary} == CSV_GINI
    for row, s in zip(got.rows, summary):
        assert row["link_gini"] == s["gini"]


def test_link_reports_reproduce_results_csvs(link_frames, tmp_path):
    got, _ = link_frames
    heat, summ = tmp_path / "heatmap.csv", tmp_path / "summary.csv"
    out = PO.write_link_reports(str(heat), str(summ), got.all_link_rows())
    assert len(out) == 3
    for path, name in ((heat, "link_load_heatmap.csv"),
                       (summ, "link_load_summary.csv")):
        with open(os.path.join(RESULTS, name), "rb") as f:
            assert path.read_bytes() == f.read(), name


def test_window_reports_reproduce_results_csvs(tmp_path):
    frame = PX.run(_window_exp(PX, PW, PS.SimConfig(**SMOKE)), device="cpu")
    heat, summ = tmp_path / "heatmap.csv", tmp_path / "summary.csv"
    out = PO.write_window_reports(str(heat), str(summ),
                                  frame.all_window_rows())
    assert [s["window"] for s in out] == list(range(6))
    assert out == PR.window_summary(frame.all_window_rows())
    for path, name in ((heat, "window_heatmap.csv"),
                       (summ, "window_summary.csv")):
        with open(os.path.join(RESULTS, name), "rb") as f:
            assert path.read_bytes() == f.read(), name


@pytest.mark.parametrize("x", [[], [0, 0], [1.0], [3, 1, 2, 0.5],
                               list(np.linspace(0, 1, 17) ** 3)])
def test_gini_equals_reference(x):
    assert PO.gini(x) == RO.gini(x)


def test_obs_exports_the_reference_names():
    ported = {"trace", "metrics", "flight", "report", "profile", "bench"}
    names = {k for k, v in vars(RO).items() if not k.startswith("_")
             and getattr(v, "__module__", "").rsplit(".", 1)[-1] in ported}
    assert names <= set(vars(PO))
    assert PO.LINK_COLUMNS == RO.LINK_COLUMNS
    assert PO.WINDOW_COLUMNS == RO.WINDOW_COLUMNS


# ---------------------------------------------------------------------
# obs.bench
# ---------------------------------------------------------------------

BENCH_FILES = sorted(glob.glob(os.path.join(RESULTS, "BENCH_*.json")))


@pytest.mark.parametrize("path", BENCH_FILES,
                         ids=[os.path.basename(p) for p in BENCH_FILES])
def test_compare_reads_the_reference_bench_files(path):
    old = PB.load_bench(path)
    assert old == RB.load_bench(path)
    other = BENCH_FILES[(BENCH_FILES.index(path) + 1) % len(BENCH_FILES)]
    new = dict(old, metrics={k: (v * 1.5 if isinstance(v, (int, float))
                                 else v)
                             for k, v in old["metrics"].items()})
    for a, b in ((old, old), (old, new), (new, old),
                 (old, PB.load_bench(other))):
        rows = PB.compare(a, b, 20.0)
        assert rows == RB.compare(a, b, 20.0)
        assert PB.format_compare(rows) == RB.format_compare(rows)


def test_compare_cli_gate(tmp_path, capsys):
    old = PB.load_bench(BENCH_FILES[0])
    worse = dict(old, metrics={k: v * 2 for k, v in old["metrics"].items()
                               if isinstance(v, (int, float))})
    path = PB.write_bench(dict(worse, name="worse"), str(tmp_path))
    assert path == os.path.join(str(tmp_path), "BENCH_worse.json")
    args = ["compare", BENCH_FILES[0], path]
    assert PB.main(args) == RB.main(args)
    assert PB.main(args + ["--warn-only"]) == 0
    assert PB.main(["compare", BENCH_FILES[0], BENCH_FILES[0]]) == 0
    assert PB.main(["run", "sweep"]) == 2
    capsys.readouterr()


def test_bench_doc_schema_and_machine(tmp_path):
    doc = PB.bench_doc("t", {"a_s": 1.0, "speedup": 2}, mode="smoke",
                       directions={"speedup": "higher"},
                       profiles=[{"key": [1]}])
    want = RB.bench_doc("t", {"a_s": 1.0, "speedup": 2}, mode="smoke",
                        directions={"speedup": "higher"},
                        profiles=[{"key": [1]}])
    assert set(doc) == set(want)
    assert doc["bench_schema_version"] == RB.BENCH_SCHEMA_VERSION
    m = doc["machine"]
    assert m["torch"] == torch.__version__ and "jax" not in m
    assert m["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    with pytest.raises(TypeError, match="non-scalar"):
        PB.bench_doc("t", {"x": [1]})
    with pytest.raises(ValueError, match="direction"):
        PB.bench_doc("t", {}, directions={"x": "up"})
    path = PB.write_bench(doc, str(tmp_path))
    assert PB.load_bench(path)["metrics"] == doc["metrics"]


# ---------------------------------------------------------------------
# obs.profile
# ---------------------------------------------------------------------

@pytest.fixture
def profiling():
    PP.clear_profiles()
    PP.enable_profiling()
    yield
    PP.disable_profiling()
    PP.clear_profiles()


def test_runner_profile_once_per_key(profiling):
    r = build_routing(PT.build("mesh", 16))
    spec = PS.make_spec(r, PTR.uniform(r.topo))
    rates = np.array([0.1, 0.3], np.float32)
    cfg = PS.SimConfig(cycles=120, warmup=40)
    plain = PS.run_batch([spec], rates, cfg, device="cpu")[0]
    PP.disable_profiling()
    assert PS.run_batch([spec], rates, cfg, device="cpu")[0]["delivered"] \
        .tolist() == plain["delivered"].tolist()
    PP.enable_profiling()
    PS.run_batch([spec, spec], rates, cfg, device="cpu")   # same key
    tel = cfg._replace(telemetry=True, telemetry_windows=2,
                       routing="adaptive")
    PS.run_batch([spec], rates, tel, device="cpu")
    profs = PP.get_profiles()
    assert len(profs) == 2
    for prof, c in zip(profs, (cfg, tel)):
        assert prof["key"] == [16, 4, 48, spec.d, str(c), "torch", 0, "cpu"]
        assert prof["profile_cycles"] == PP.PROFILE_CYCLES
        assert prof["device"] == "cpu"
        for k in ("flops", "bytes_accessed", "compile_s",
                  "peak_device_bytes", "device_launches_per_cycle"):
            assert prof[k] is None, k
        assert prof["argument_bytes"] > 0 and prof["output_bytes"] > 0
    assert profs[1]["state_bytes"] > profs[0]["state_bytes"] > 0
    assert profs[1]["output_bytes"] > profs[0]["output_bytes"]


def test_profile_batch_records_without_running():
    PP.clear_profiles()
    assert not PP.profiling_enabled()
    r = build_routing(PT.build("folded_hexa_torus", 16))
    spec = PS.make_spec(r, PTR.uniform(r.topo))
    cfg = PS.SimConfig(cycles=3000, warmup=1000)
    prof = PS.profile_batch([spec], [0.2], cfg, device="cpu")
    assert PP.get_profiles() == [prof]
    assert prof["profile_cycles"] == PP.PROFILE_CYCLES
    assert PS.profile_batch([spec], [0.2], cfg, device="cpu") is prof
    PP.clear_profiles()


# ---------------------------------------------------------------------
# tools/smoke_reference.py adaptive: the table's format
# ---------------------------------------------------------------------

def test_smoke_reference_adaptive_table_on_the_cpu():
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    try:
        import chip_smoke
        import smoke_reference
    finally:
        del sys.path[:2]
    cut = dict(n=16, cycles=240, warmup=80, n_rates=2, windows=2)
    want = smoke_reference.adaptive(**cut)
    cfg = chip_smoke.adaptive_cfg(PS.SimConfig, cut["cycles"],
                                  cut["warmup"], cut["windows"])
    frame = PX.run(PX.Experiment(
        chip_smoke.adaptive_scenarios(PX, PW, cut["n"], cut["n_rates"]),
        cfg=cfg, name="chip_smoke_adaptive"), device="cpu")
    got = chip_smoke.adaptive_table(frame)
    assert got == want
    assert json.loads(json.dumps(got)) == got
    assert [e["label"] for e in got["table"]] == [
        f"{t}/hotspot_drift/{r}" for t in chip_smoke.ADAPTIVE_TOPOLOGIES
        for r in ("static", "adaptive")]
    assert got["n_window_rows"] == cut["windows"] * len(
        frame.link_rows(len(frame.rows) - 1))
