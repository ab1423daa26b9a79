"""The port's static verification (`repro_torch.analysis`) equals the JAX
package's: certificates, escape checks and their witnesses on four
topologies, a faulted one and deliberately broken routings (a cyclic
ring, a dead end, an undeclared port, a livelock, a poisoned
productive-ports mask), the code registry, reports and their JSON bytes,
`routing_for(certify=True)`; the design-principle lint and its messages,
`analyze` and the CLI (its JSON bytes at DEFAULT_N), the JX001-JX003
checks on seeded hazards; and the port's own JX004 / JX005, read from the
op log of a few real cycles, on its loop and on seeded hazards."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.analysis as RA
from repro.analysis import jaxpr_hazards as RH
from repro.analysis.__main__ import main as ref_main
from repro.analysis.routing_verify import check_escape
import repro.faults as RF
from repro.core import routing as RR
from repro.core import topology as RT
from repro.core import traffic as RTR
from repro.core.simulator import SimConfig as RCfg
from repro.core.simulator import make_spec as r_make_spec
from repro.sweep.padding import PadShape as RPad
from repro.sweep.padding import stack_specs as r_stack
import repro_torch.analysis as PA
from repro_torch.analysis import runner_hazards as PH
from repro_torch.analysis.__main__ import main as port_main
import repro_torch.faults as PF
from repro_torch.core import routing as PR
from repro_torch.core import simulator as PSIM
from repro_torch.core import topology as PT
from repro_torch.core import traffic as PTR
from repro_torch.sweep.padding import PadShape as PPad
from repro_torch.sweep.padding import stack_specs as p_stack

FOUR = [("mesh", 16), ("folded_hexa_torus", 36), ("hexamesh", 16),
        ("octamesh", 25)]


def _cert(cert) -> dict:
    d = dataclasses.asdict(cert)
    d["diagnostics"] = [x.to_dict() for x in cert.diagnostics]
    d["ok"] = cert.ok
    return d


def _pair(name, n, substrate="organic"):
    return (RR.build_routing(RT.build(name, n, substrate=substrate)),
            PR.build_routing(PT.build(name, n, substrate=substrate)))


@pytest.mark.parametrize("name,n", FOUR, ids=[f"{a}{b}" for a, b in FOUR])
def test_certify_routing_equals_reference(name, n):
    ref, port = _pair(name, n, "glass" if name == "hexamesh" else "organic")
    got, want = PA.certify_routing(port), RA.certify_routing(ref)
    assert _cert(got) == _cert(want)
    assert got.ok and got.n_adaptive_choices > 0
    np.testing.assert_array_equal(PA.dependency_edges(port),
                                  RA.dependency_edges(ref))


@pytest.mark.parametrize("name,n", FOUR, ids=[f"{a}{b}" for a, b in FOUR])
def test_check_escape_equals_reference(name, n):
    ref, port = _pair(name, n)
    got, n_got = PA.check_escape(port)
    want, n_want = check_escape(ref)
    assert n_got == n_want > 0 and not got and not want


def test_faulted_routing_certifies_like_reference():
    rt, pt = (T.build("folded_hexa_torus", 36) for T in (RT, PT))
    for kind, k in (("random", 3), ("chiplets", 2)):
        ref = RR.build_routing(RF.sample_faults(rt, k, kind, seed=1).apply(rt))
        port = PR.build_routing(
            PF.sample_faults(pt, k, kind, seed=1).apply(pt))
        assert _cert(PA.certify_routing(port)) == \
            _cert(RA.certify_routing(ref))


def _ring(T, Routing, n):
    """A deliberately cyclic routing (tests/test_analysis.py's ring):
    everything forwarded clockwise with no turn prohibition."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pos = np.stack([np.cos(ang), np.sin(ang)], axis=1) * 10
    topo = T.make_topology(f"ring{n}", pos,
                           np.array([(i, (i + 1) % n) for i in range(n)]))
    table = np.full((n, n, 2), -1, np.int16)
    for d in range(n):
        for v in range(n):
            table[d, v, :] = Routing.EJECT if v == d else 0
    ch_src = np.arange(n)
    return Routing(
        topo=topo, ch_src=ch_src, ch_dst=(ch_src + 1) % n,
        ch_len_mm=np.ones(n), ch_out_port=np.zeros(n, np.int64),
        ch_in_port=np.zeros(n, np.int64), out_ch=np.arange(n).reshape(n, 1),
        in_ch=((np.arange(n) - 1) % n).reshape(n, 1),
        n_ports=np.ones(n, np.int64), table=table, prohibited_turns=0,
        total_turns=n)


def _broken(r, kind):
    """A copy of mesh16's routing `r` broken one way."""
    table = r.table.copy()
    if kind == "dead_end":
        table[0, 3, r.max_ports] = -1
    elif kind == "undeclared":
        table[0, 5, 0] = int(r.n_ports[5])
    elif kind == "livelock":
        c01 = int(np.flatnonzero((r.ch_src == 0) & (r.ch_dst == 1))[0])
        c10 = int(np.flatnonzero((r.ch_src == 1) & (r.ch_dst == 0))[0])
        table[15, 0, r.max_ports] = r.ch_out_port[c01]
        table[15, 1, r.ch_in_port[c01]] = r.ch_out_port[c10]
        table[15, 0, r.ch_in_port[c10]] = r.ch_out_port[c01]
    out = dataclasses.replace(r, table=table, cert=None)
    if kind == "poisoned":
        routing = RR if isinstance(r, RR.Routing) else PR
        prod = routing.productive_ports(r).copy()
        u, p = next((5, p) for p in range(r.max_ports)
                    if r.out_ch[5, p] >= 0 and not prod[0, 5, p])
        prod[0, u, p] = True
        out.prod = prod
    return out


@pytest.mark.parametrize("kind", ["ring", "dead_end", "undeclared",
                                  "livelock", "poisoned"])
def test_broken_routings_give_the_reference_witnesses(kind):
    if kind == "ring":
        ref = _ring(RT, RR.Routing, 7)
        port = _ring(PT, PR.Routing, 7)
    else:
        ref, port = (_broken(r, kind) for r in _pair("mesh", 16))
    got, want = PA.certify_routing(port), RA.certify_routing(ref)
    assert _cert(got) == _cert(want)
    assert not got.ok and got.diagnostics


def test_codes_reports_and_json_equal_reference(tmp_path):
    assert PA.CODES == RA.CODES
    rep_p, rep_r = PA.Report(), RA.Report()
    for name, n in FOUR[:2]:
        ref, port = _pair(name, n)
        PA.verify_routing(port, rep_p)
        RA.verify_routing(ref, rep_r)
    ring_p = _ring(PT, PR.Routing, 5)
    ring_r = _ring(RT, RR.Routing, 5)
    PA.verify_routing(ring_p, rep_p)
    RA.verify_routing(ring_r, rep_r)
    rep_p.add(PA.diag("DP006", "n not supported", target="x", n=15))
    rep_r.add(RA.diag("DP006", "n not supported", target="x", n=15))
    assert rep_p.summary() == rep_r.summary()
    assert rep_p.counts() == rep_r.counts()
    assert rep_p.counts()["RT001"] == 1 == rep_p.counts()["DP006"]
    assert rep_p.gate() == rep_r.gate() == 1
    assert rep_p.gate("error") == 1 and not rep_p.ok
    assert [str(d) for d in rep_p] == [str(d) for d in rep_r]
    rep_p.to_json(str(tmp_path / "port.json"), run="t")
    rep_r.to_json(str(tmp_path / "ref.json"), run="t")
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    with pytest.raises(KeyError, match="unknown diagnostic code"):
        PA.diag("XX999", "nope")


def test_routing_for_certify_caches_the_certificate():
    PR.routing_cache_clear()
    topo = PT.build("folded_hexa_torus", 16)
    r1 = PR.routing_for(topo)
    assert r1.cert is None
    r2 = PR.routing_for(topo, certify=True)
    assert r2 is r1 and r2.cert is not None and r2.cert.ok
    assert PR.routing_for(topo, certify=True).cert is r2.cert
    want = RR.routing_for(RT.build("folded_hexa_torus", 16), certify=True)
    assert _cert(r2.cert) == _cert(want.cert)


# =====================================================================
# design-principle lint, the engine, the CLI and the runner hazards
# =====================================================================

CFG = dict(cycles=120, warmup=40)


def _diags(report_or_list, codes=None) -> list:
    return [(d.code, d.target, d.message) for d in report_or_list
            if codes is None or d.code in codes]


def test_principle_messages_match_legacy_strings():
    from repro_torch.synth.feasibility import FeasibilityCriteria, check
    crit = FeasibilityCriteria(max_radix=3, max_wire_cost_mm=1.0)
    topo = PT.build("torus", 36)
    legacy = check(topo, crit)
    diags = PA.diagnose(topo, crit)
    assert [d.message for d in diags] == legacy
    assert legacy[0] == "link-range 4 > 1 (Principle 2)"
    codes = [d.code for d in diags]
    assert codes == sorted(codes)
    assert all(d.severity == "warning" for d in diags)
    want = RA.diagnose(RT.build("torus", 36), RA.FeasibilityCriteria(
        max_radix=3, max_wire_cost_mm=1.0))
    assert [d.to_dict() for d in diags] == [d.to_dict() for d in want]


def test_rate_floor_diagnostic_on_glass_vs_organic():
    crit = PA.FeasibilityCriteria(min_rate_fraction=0.95)
    for substrate in ("organic", "glass"):
        got = PA.lint_topology(PT.build("torus", 36, substrate=substrate),
                               crit)
        want = RA.lint_topology(RT.build("torus", 36, substrate=substrate),
                                RA.FeasibilityCriteria(min_rate_fraction=0.95))
        assert [d.to_dict() for d in got] == [d.to_dict() for d in want]
    dp2 = [d for d in PA.diagnose(PT.build("torus", 36), crit)
           if d.code == "DP002"]
    assert dp2 and "organic rate floor 0.95" in dp2[0].message
    w = dp2[0].witness_dict()
    assert w["max_link_mm"] > w["cap_mm"]


def test_n_constraint_lint_matches_planner_string():
    import repro_torch.experiments as PX
    assert PA.check_n_constraint("mesh", 36) == []
    diags = PA.check_n_constraint("hypercube", 36)
    assert diags[0].code == "DP006"
    assert diags[0].message == \
        "hypercube does not support N=36 (topology.N_CONSTRAINTS)"
    assert [d.to_dict() for d in diags] == \
        [d.to_dict() for d in RA.check_n_constraint("hypercube", 36)]
    pl = PX.plan(PX.Experiment([PX.Scenario("hypercube", 36)],
                               backend="analytic"))
    assert pl.skipped == [(0, diags[0].message)]
    assert pl.skip_codes == {0: diags[0].code}


def test_overflow_bounds_equal_reference():
    for kw in (dict(cycles=50_000, warmup=1000), dict(),
               dict(telemetry=True), dict(cycles=200_000, telemetry=True)):
        p, r = PSIM.SimConfig(**kw), RCfg(**kw)
        assert PH.counter_bounds(36, 4, p) == RH.counter_bounds(36, 4, r)
        assert _diags(PH.check_overflow(36, 4, p, target="t")) == \
            _diags(RH.check_overflow(36, 4, r, target="t"))
    hot = PH.check_overflow(36, 4, PSIM.SimConfig(cycles=50_000,
                                                  warmup=1000))
    lat = [d for d in hot if d.witness_dict()["counter"] == "lat_node"]
    assert lat and lat[0].severity == "error"
    assert PH.check_overflow(36, 4, PSIM.SimConfig()) == []


def _spec_pair(name, n):
    return (PSIM.make_spec(PR.routing_for(PT.build(name, n)),
                           PTR.uniform(PT.build(name, n))),
            r_make_spec(RR.routing_for(RT.build(name, n)),
                        RTR.uniform(RT.build(name, n))))


def test_seeded_pad_slot_writes_flagged_like_reference():
    pairs = [_spec_pair("folded_hexa_torus", 36), _spec_pair("mesh", 16)]
    ps, rs = [p for p, _ in pairs], [r for _, r in pairs]
    (pb, _), (rb, _) = p_stack(ps), r_stack(rs)
    assert PH.check_padding_contract(pb, ps) == []

    def seeded(batch, leaf, idx, value):
        arr = getattr(batch, leaf).copy()
        arr[idx] = value
        return batch._replace(**{leaf: arr})
    live = tuple(int(x) for x in np.argwhere(ps[1].out_ch >= 0)[0])
    for leaf, idx, value in (("out_ch", (1, ps[1].n + 1, 0), 3),
                             ("inj_weight", (1, ps[1].n), 0.5),
                             ("out_ch", (1,) + live, ps[1].c + 5),
                             ("ch_depth", (0, 3), 0),
                             ("prod", (1, 20, 0, 0), True)):
        got = PH.check_padding_contract(seeded(pb, leaf, idx, value), ps)
        want = RH.check_padding_contract(seeded(rb, leaf, idx, value), rs)
        assert got and all(d.code == "JX002" for d in got)
        assert [d.to_dict() for d in got] == [d.to_dict() for d in want]


def test_recompile_hazard_equals_reference():
    shapes = [(16, 4, 48, 4), (36, 4, 120, 4), (16, 4, 48, 4)]
    for bucketed in (None, [(40, 4, 128, 4)] * 3):
        got = PH.check_recompiles(
            [PPad(*s) for s in shapes],
            bucketed=bucketed and [PPad(*s) for s in bucketed])
        want = RH.check_recompiles(
            [RPad(*s) for s in shapes],
            bucketed=bucketed and [RPad(*s) for s in bucketed])
        assert [d.to_dict() for d in got] == [d.to_dict() for d in want]
    assert "reduce this to 1" in got[0].message
    assert PH.check_recompiles([PPad(*shapes[0])] * 2) == []


@pytest.mark.parametrize("kw", [
    dict(), dict(routing="adaptive"),
    dict(telemetry=True, telemetry_windows=2),
    dict(routing="adaptive", telemetry=True)],
    ids=["static", "adaptive", "recorder", "adaptive_recorder"])
def test_runner_loop_findings_are_the_intended_ones(kw):
    specs = [s for s, _ in (_spec_pair("mesh", 16),
                            _spec_pair("folded_hexa_torus", 16))]
    log, shape, batch = PSIM.trace_batch(specs, [0.1, 0.3],
                                         PSIM.SimConfig(**CFG, **kw),
                                         device="cpu")
    assert shape.n == 16 and batch.table.shape[0] == 2
    loop = PH.loop_ops(log)
    assert {r.cycle for r in loop} == set(range(PSIM.TRACE_CYCLES))
    assert len(loop) > 3 * 50 and len(log) > len(loop)
    found = PH.check_host_sync(log) + PH.check_dtype_promotions(log)
    assert set(PH.findings(found)) == set(PH.INTENDED)
    assert PH.host_side_ops(log, "cpu") == []


def test_workload_loop_findings_are_the_intended_ones():
    import repro_torch.workloads as PW
    spec, _ = _spec_pair("mesh", 16)
    sched = PW.phase_alternating(PT.build("mesh", 16), phase_cycles=30,
                                 repeats=1).compile()
    log, _, _ = PSIM.trace_batch([spec], [0.2], PSIM.SimConfig(**CFG),
                                 device="cpu", schedules=[sched], k_pad=4)
    found = PH.check_host_sync(log) + PH.check_dtype_promotions(log)
    assert set(PH.findings(found)) == set(PH.INTENDED)


def test_op_log_finds_seeded_host_sync_and_promotion():
    """The counterpart of the reference's seeded jaxpr hazards: a
    `.item()` and a float64 promotion in a small function, logged as
    the cycle loop logs its ops, are both found."""
    probe = {"cycle": 0}

    def step(x):
        scale = float(x.max().item())                # host sync
        y = x.double() * 2.0                         # a float64 tensor
        n = (x > scale / 2).sum(1)                   # bool -> int64
        return y, n

    with PSIM.log_ops(probe) as log:
        step(torch.arange(12, dtype=torch.float32).view(3, 4))
    hs = PH.check_host_sync(log)
    assert [d.code for d in hs] == ["JX004"]
    assert hs[0].witness_dict()["op"] == "aten._local_scalar_dense"
    dp = PH.check_dtype_promotions(log)
    assert {d.code for d in dp} == {"JX005"}
    assert ("JX005", "aten.sum.dim_IntList", "torch.bool", "torch.int64") \
        in PH.findings(dp)
    assert any("torch.float64" in d.message for d in dp)
    # outside the cycle loop nothing counts
    probe["cycle"] = None
    with PSIM.log_ops(probe) as log2:
        step(torch.ones(3, 4))
    assert PH.check_host_sync(log2) == PH.check_dtype_promotions(log2) == []


@pytest.mark.parametrize("case", [
    "mask_read", "mask_write", "masked_select", "repeat_interleave",
    "unique", "int_index", "tensor_write"])
def test_op_log_names_ops_that_sync_inside_their_kernel(case):
    """Ops that size their output from the data wait for the device
    inside their kernel; the op log names them on any device.  An
    integer index and a tensor written through one are not such ops."""
    x = torch.arange(12, dtype=torch.float32).view(3, 4)
    mask = x > 5
    steps = {
        "mask_read": ("aten.index", lambda: x[mask]),
        "mask_write": ("aten.index_put_", lambda: x.clone().__setitem__(
            mask, 0.0)),
        "masked_select": ("aten.masked_select",
                          lambda: x.masked_select(mask)),
        "repeat_interleave": ("aten.repeat_interleave", lambda:
                              torch.repeat_interleave(torch.tensor([1, 2]))),
        "unique": ("aten._unique2", lambda: torch.unique(x)),
        "int_index": (None, lambda: x[torch.tensor([0, 2])]),
        "tensor_write": (None, lambda: x.clone().__setitem__(
            torch.tensor([0, 2]), torch.ones(2, 4))),
    }
    op, step = steps[case]
    with PSIM.log_ops({"cycle": 0}) as log:
        step()
    found = [d.witness_dict()["op"] for d in PH.check_host_sync(log)]
    assert found == ([op] if op else [])


def test_analyze_batch_front_door_equals_reference():
    pairs = [_spec_pair("folded_hexa_torus", 16), _spec_pair("mesh", 16)]
    got = PH.analyze_batch([p for p, _ in pairs], [0.1],
                           PSIM.SimConfig(**CFG), target="b",
                           device="cpu")
    want = RH.analyze_batch([r for _, r in pairs], [0.1], RCfg(**CFG),
                            target="b")
    assert got.ok and got.analyzed == want.analyzed
    codes = ("JX001", "JX002", "JX003")
    assert _diags(got, codes) == _diags(want, codes)
    assert set(PH.findings(got)) == set(PH.INTENDED)
    quick = PH.analyze_batch([p for p, _ in pairs], [0.1], trace=False,
                             device="cpu")
    assert not any(kind in ("host-sync", "dtype")
                   for kind, _ in quick.analyzed)


def test_analyze_front_door_and_metrics():
    from repro_torch.obs.metrics import metrics
    before = metrics.with_prefix("analysis.").get("analysis.certified", 0)
    kw = dict(names=["folded_hexa_torus", "hypercube"], n=36,
              substrates=("organic",), fault_kmax=1)
    rep = PA.analyze(**kw)
    assert rep.ok
    assert [d.code for d in rep if d.code == "DP006"] == ["DP006"]
    assert any("hypercube/n32" in lbl for _, lbl in rep.analyzed)
    assert metrics.with_prefix("analysis.")["analysis.certified"] > before
    want = RA.analyze(**kw)
    assert _diags(rep) == _diags(want) and rep.analyzed == want.analyzed
    assert PA.builtin_names() == RA.builtin_names()
    assert PA.DEFAULT_N == RA.DEFAULT_N == 36


def test_analyze_fault_variants_equal_reference():
    kw = dict(names=["folded_hexa_torus"], n=36, fault_kmax=2)
    got, want = PA.analyze(**kw), RA.analyze(**kw)
    assert _diags(got) == _diags(want) and got.analyzed == want.analyzed


def test_cli_all_builtin_equals_reference(tmp_path, capsys):
    """`--all-builtin` at DEFAULT_N: the same summary, exit code and JSON
    bytes; with the runner-hazard pass (`--hazards` / `--jax`) the same
    DP, RT and JX001-JX003 diagnostics, and the port's JX004 / JX005 are
    the intended ones."""
    out_p, out_r = tmp_path / "port.json", tmp_path / "ref.json"
    assert port_main(["--all-builtin", "-q", "-o", str(out_p)]) == 0
    text_p = capsys.readouterr().out
    assert ref_main(["--all-builtin", "-q", "-o", str(out_r)]) == 0
    text_r = capsys.readouterr().out
    assert "0 error(s)" in text_p
    assert text_p.splitlines()[0] == text_r.splitlines()[0]
    assert out_p.read_bytes() == out_r.read_bytes()
    doc = json.loads(out_p.read_text())
    assert len([a for a in doc["analyzed"] if a[0] == "routing"]) >= \
        2 * len(PT.GENERATORS)
    assert port_main(["--all-builtin", "-q", "--hazards", "--device", "cpu",
                      "-o", str(out_p)]) == 0
    assert ref_main(["--all-builtin", "-q", "--jax", "-o", str(out_r)]) == 0
    capsys.readouterr()
    got, want = (json.loads(p.read_text()) for p in (out_p, out_r))
    keep = lambda doc: [r for r in doc["rows"]  # noqa: E731
                        if r["code"] not in ("JX004", "JX005")]
    assert keep(got) == keep(want) and want["rows"] == keep(want)
    assert got["analyzed"] == want["analyzed"]
    port_extra = [(r["code"], r["witness"]["op"], r["witness"]["src"],
                   r["witness"]["dst"]) for r in got["rows"]
                  if r["code"] in ("JX004", "JX005")]
    assert set(port_extra) == set(PH.INTENDED)


def test_cli_fails_on_warning_threshold(capsys):
    args = ["torus", "-n", "36", "--substrate", "organic", "-q"]
    assert port_main(args + ["--fail-on", "warning"]) == 1
    assert port_main(args) == 0
    assert ref_main(args + ["--fail-on", "warning"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[2]
    with pytest.raises(SystemExit):
        port_main([])
