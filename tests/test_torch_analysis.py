"""The port's static verification (`repro_torch.analysis`: diagnostics
and routing_verify) equals the JAX package's: certificates, escape
checks and their witnesses on four topologies, a faulted one and
deliberately broken routings (a cyclic ring, a dead end, an undeclared
port, a livelock, a poisoned productive-ports mask), the code registry,
reports and their JSON bytes, and `routing_for(certify=True)`."""
import dataclasses

import numpy as np
import pytest

import repro.analysis as RA
from repro.analysis.routing_verify import check_escape
import repro.faults as RF
from repro.core import routing as RR
from repro.core import topology as RT
import repro_torch.analysis as PA
import repro_torch.faults as PF
from repro_torch.core import routing as PR
from repro_torch.core import topology as PT

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
