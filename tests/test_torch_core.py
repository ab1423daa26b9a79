"""The port's host-side core equals the reference's: every Table III
generator valid at N in {16, 36} on organic and glass gives the same
topology, routing tables, channel maps, productive ports, analytic
saturation and simulator spec; traffic patterns, link and cost models
agree too."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import costmodel as RC  # noqa: E402
from repro.core import linkmodel as RL  # noqa: E402
from repro.core import routing as RR  # noqa: E402
from repro.core import simulator as RS  # noqa: E402
from repro.core import topology as RT  # noqa: E402
from repro.core import traffic as RTR  # noqa: E402
from repro_torch.core import costmodel as PC  # noqa: E402
from repro_torch.core import linkmodel as PL  # noqa: E402
from repro_torch.core import routing as PR  # noqa: E402
from repro_torch.core import simulator as PS  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core import traffic as PTR  # noqa: E402

CASES = [(name, n, sub) for name in sorted(RT.GENERATORS)
         for n in (16, 36) for sub in ("organic", "glass")
         if RT.valid_n(name, n)]

ROUTING_FIELDS = ("ch_src", "ch_dst", "ch_len_mm", "ch_out_port",
                  "ch_in_port", "out_ch", "in_ch", "n_ports", "table",
                  "prohibited_turns", "total_turns")


def _assert_spec_equal(got, want):
    for f in dataclasses.fields(RS.SimSpec):
        a, b = getattr(got, f.name), getattr(want, f.name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f.name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f.name


def test_generator_registry_matches():
    assert sorted(PT.GENERATORS) == sorted(RT.GENERATORS)
    assert sorted(PT.N_CONSTRAINTS) == sorted(RT.N_CONSTRAINTS)
    assert all(PT.valid_n(k, n) == RT.valid_n(k, n)
               for k in RT.GENERATORS for n in range(2, 70))


@pytest.mark.parametrize("name,n,substrate", CASES)
def test_topology_routing_spec_parity(name, n, substrate):
    rt = RT.build(name, n, substrate=substrate)
    pt = PT.build(name, n, substrate=substrate)
    np.testing.assert_array_equal(pt.edges, rt.edges)
    np.testing.assert_array_equal(pt.pos, rt.pos)
    np.testing.assert_array_equal(pt.roles, rt.roles)
    assert pt.structural_hash() == rt.structural_hash()
    np.testing.assert_array_equal(pt.link_lengths_mm(), rt.link_lengths_mm())

    rr, pr = RR.build_routing(rt), PR.build_routing(pt)
    for f in ROUTING_FIELDS:
        np.testing.assert_array_equal(getattr(pr, f), getattr(rr, f),
                                      err_msg=f)
    np.testing.assert_array_equal(PR.productive_ports(pr),
                                  RR.productive_ports(rr))
    traffic = RTR.uniform(rt)
    np.testing.assert_array_equal(PTR.uniform(pt), traffic)
    assert pr.saturation_rate(traffic) == rr.saturation_rate(traffic)
    _assert_spec_equal(PS.make_spec(pr, traffic), RS.make_spec(rr, traffic))


@pytest.mark.parametrize("pattern", sorted(RTR.PATTERNS))
@pytest.mark.parametrize("roles", ["homogeneous", "hetero_cm", "hetero_cmi"])
def test_traffic_patterns_match(pattern, roles):
    rt = RT.build("folded_hexa_torus", 36, roles_scheme=roles)
    pt = PT.build("folded_hexa_torus", 36, roles_scheme=roles)
    np.testing.assert_array_equal(PTR.PATTERNS[pattern](pt),
                                  RTR.PATTERNS[pattern](rt))


@pytest.mark.parametrize("name", ["mesh", "hexamesh", "folded_hexa_torus",
                                  "flattened_butterfly"])
@pytest.mark.parametrize("substrate", ["organic", "glass"])
def test_cost_and_link_models_match(name, substrate):
    rt = RT.build(name, 36, substrate=substrate)
    pt = PT.build(name, 36, substrate=substrate)
    lengths = np.linspace(0.0, 80.0, 33)
    np.testing.assert_array_equal(PL.rate_gbps(lengths, substrate),
                                  RL.rate_gbps(lengths, substrate))
    np.testing.assert_array_equal(PL.hop_latency_cycles(lengths, substrate),
                                  RL.hop_latency_cycles(lengths, substrate))
    assert PC.data_wires(pt) == RC.data_wires(rt)
    assert PC.absolute_throughput_gbps(pt, 0.3) == \
        RC.absolute_throughput_gbps(rt, 0.3)
    assert dataclasses.asdict(PC.report(pt, 0.3, 2.5, 20.0)) == \
        dataclasses.asdict(RC.report(rt, 0.3, 2.5, 20.0))
    assert PC.wire_cost_mm(pt) == RC.wire_cost_mm(rt)


def test_make_topology_and_validation_match():
    rt = RT.build("hexamesh", 16)
    pt = PT.make_topology("custom", rt.pos, rt.edges)
    assert pt.structural_hash() == rt.structural_hash()
    with pytest.raises(ValueError, match="self-loop"):
        PT.make_topology("bad", rt.pos, [[0, 0], [0, 1]])
    with pytest.raises(ValueError, match="disconnected"):
        PT.make_topology("bad", rt.pos, [[0, 1]])
    with pytest.raises(KeyError):
        PT.build("no_such_topology", 16)


def test_routing_cache_and_zero_load_latency():
    topo, r = PR.cached_routing("folded_hexa_torus", 16)
    topo2, r2 = PR.cached_routing("folded_hexa_torus", 16)
    assert r2 is r and topo2 is topo
    assert PR.routing_for(PT.build("folded_hexa_torus", 16)) is r
    rr = RR.build_routing(RT.build("folded_hexa_torus", 16))
    traffic = RTR.uniform(rr.topo)
    assert PS.zero_load_latency(r, traffic) == \
        RS.zero_load_latency(rr, traffic)
    np.testing.assert_array_equal(PS.saturation_rate_grid(0.2, 8),
                                  RS.saturation_rate_grid(0.2, 8))
    assert PS.routing_headroom("static") == RS.routing_headroom("static")
