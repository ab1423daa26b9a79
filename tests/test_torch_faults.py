"""The port's fault layer equals the JAX package's: `FaultSet`
canonicalisation and names, its lowering (`apply`, `dead_link_mask`,
`mask_traffic`, `mask_schedule`), every sampler of `SAMPLERS` over
several topologies, k and seeds, `iter_fault_variants`, and the errors
of disconnecting or malformed sets; the degraded topologies route to the
reference's tables."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.faults as RF  # noqa: E402
import repro.workloads as RW  # noqa: E402
from repro.core import topology as RT, traffic as RTR  # noqa: E402
from repro.core.routing import routing_for as r_routing_for  # noqa: E402
import repro_torch.faults as PF  # noqa: E402
import repro_torch.workloads as PW  # noqa: E402
from repro_torch.core import topology as PT, traffic as PTR  # noqa: E402
from repro_torch.core.routing import routing_for  # noqa: E402

TOPOS = [("mesh", 16), ("folded_hexa_torus", 36), ("hexamesh", 25),
         ("octamesh", 16)]
TOPO_IDS = [f"{a}{b}" for a, b in TOPOS]


def _pair(name, n):
    return PT.build(name, n), RT.build(name, n)


def _same_set(got, want):
    assert (got.links, got.chiplets, got.name) == \
        (want.links, want.chiplets, want.name)


def _same_topology(got, want):
    np.testing.assert_array_equal(np.asarray(got.edges),
                                  np.asarray(want.edges))
    assert (got.name, got.n, got.substrate) == \
        (want.name, want.n, want.substrate)
    assert got.structural_hash() == want.structural_hash()


@pytest.mark.parametrize("links,chiplets,name", [
    (((5, 1), (1, 5), (2, 3)), (7, 7, 2), ""),
    ((), (), ""),
    (((0, 1),), (), "custom"),
    ((), (3, 0), ""),
])
def test_canonicalization_and_names_equal_reference(links, chiplets, name):
    got = PF.FaultSet(links=links, chiplets=chiplets, name=name)
    want = RF.FaultSet(links=links, chiplets=chiplets, name=name)
    _same_set(got, want)
    assert (got.empty, got.n_links, got.n_chiplets) == \
        (want.empty, want.n_links, want.n_chiplets)
    assert got.describe() == want.describe()
    with pytest.raises(PF.FaultError, match="self-loop"):
        PF.FaultSet(links=((3, 3),))


@pytest.mark.parametrize("name,n", TOPOS, ids=TOPO_IDS)
def test_lowering_equals_reference(name, n):
    """dead_link_mask, apply, alive, mask_traffic and mask_schedule for
    a link set, a chiplet set and both."""
    tp, tr = _pair(name, n)
    e = np.sort(np.asarray(tp.edges), axis=1)
    links = tuple(tuple(int(x) for x in e[i]) for i in (0, len(e) // 2))
    u_p, u_r = PTR.tornado(tp), RTR.tornado(tr)
    sched_p = PW.phase_alternating(tp, phase_cycles=20, repeats=1)
    sched_r = RW.phase_alternating(tr, phase_cycles=20, repeats=1)
    for kw in (dict(links=links), dict(chiplets=(1,)),
               dict(links=links[:1], chiplets=(n - 1,))):
        fp, fr = PF.FaultSet(**kw), RF.FaultSet(**kw)
        np.testing.assert_array_equal(fp.dead_link_mask(tp),
                                      fr.dead_link_mask(tr))
        np.testing.assert_array_equal(fp.alive(n), fr.alive(n))
        _same_topology(fp.apply(tp), fr.apply(tr))
        np.testing.assert_array_equal(fp.mask_traffic(u_p),
                                      fr.mask_traffic(u_r))
        mp, mr = fp.mask_schedule(sched_p), fr.mask_schedule(sched_r)
        for a, b in zip(mp.phases, mr.phases):
            np.testing.assert_array_equal(a.traffic, b.traffic)
        assert PF.surviving_connected(tp, fp) == \
            RF.surviving_connected(tr, fr)
    empty = PF.FaultSet()
    assert empty.apply(tp) is tp
    assert empty.mask_traffic(u_p) is u_p
    assert empty.mask_schedule(sched_p) is sched_p


@pytest.mark.parametrize("name,n", TOPOS[:2], ids=TOPO_IDS[:2])
def test_degraded_routing_equals_reference(name, n):
    tp, tr = _pair(name, n)
    for kind, k in (("random", 3), ("chiplets", 2)):
        fp = PF.sample_faults(tp, k, kind, seed=1)
        fr = RF.sample_faults(tr, k, kind, seed=1)
        rp, rr = routing_for(fp.apply(tp)), r_routing_for(fr.apply(tr))
        for f in ("table", "out_ch", "in_ch", "ch_src", "ch_dst",
                  "ch_len_mm"):
            np.testing.assert_array_equal(getattr(rp, f), getattr(rr, f),
                                          err_msg=f)
        u = PTR.uniform(tp)
        assert rp.saturation_rate(fp.mask_traffic(u)) == \
            rr.saturation_rate(fr.mask_traffic(u))


@pytest.mark.parametrize("kind", sorted(RF.SAMPLERS))
@pytest.mark.parametrize("name,n", TOPOS, ids=TOPO_IDS)
def test_samplers_pick_the_reference_faults(kind, name, n):
    tp, tr = _pair(name, n)
    assert sorted(PF.SAMPLERS) == sorted(RF.SAMPLERS)
    for k in (0, 1, 3):
        for seed in ((0,) if kind == "adversarial" else (0, 1, 7)):
            got = PF.sample_faults(tp, k, kind, seed=seed)
            want = RF.sample_faults(tr, k, kind, seed=seed)
            _same_set(got, want)


def test_adversarial_with_traffic_equals_reference():
    tp, tr = _pair("folded_hexa_torus", 16)
    got = PF.adversarial_link_faults(tp, 2, traffic=PTR.tornado(tp))
    want = RF.adversarial_link_faults(tr, 2, traffic=RTR.tornado(tr))
    _same_set(got, want)


@pytest.mark.parametrize("name,n", TOPOS[:2], ids=TOPO_IDS[:2])
def test_iter_fault_variants_equals_reference(name, n):
    tp, tr = _pair(name, n)
    kw = dict(kinds=("random", "chiplets", "correlated"), seeds=(0, 3))
    got = list(PF.iter_fault_variants(tp, 2, **kw))
    want = list(RF.iter_fault_variants(tr, 2, **kw))
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, g), (_, w) in zip(got, want):
        if w is None:
            assert g is None
            continue
        _same_set(g, w)
        _same_topology(PF.apply_variant(tp, g), RF.apply_variant(tr, w))
    assert list(PF.iter_fault_variants(tp, 0, include_pristine=False)) \
        == []
    with pytest.raises(ValueError, match="kmax"):
        list(PF.iter_fault_variants(tp, -1))


def test_disconnecting_sets_raise_as_the_reference():
    tp, tr = _pair("mesh", 16)
    e = np.sort(np.asarray(tp.edges), axis=1)
    cut = tuple(tuple(int(x) for x in lk) for lk in e[(e == 0).any(1)])
    with pytest.raises(RF.DisconnectedFaultError) as want:
        RF.FaultSet(links=cut).apply(tr)
    with pytest.raises(PF.DisconnectedFaultError) as got:
        PF.FaultSet(links=cut).apply(tp)
    assert str(got.value) == str(want.value)
    assert "islands" in str(got.value)
    assert isinstance(got.value, PF.FaultError)
    assert not PF.surviving_connected(tp, PF.FaultSet(links=cut))
    with pytest.raises(PF.DisconnectedFaultError, match="every chiplet"):
        PF.check_survivors_connected(4, np.zeros((0, 2)),
                                     np.zeros(4, bool))


def test_malformed_sets_and_sampler_errors_equal_reference():
    tp, tr = _pair("mesh", 16)
    for kw in (dict(links=((0, 5),)), dict(chiplets=(16,))):
        with pytest.raises(RF.FaultError) as want:
            RF.FaultSet(**kw).dead_link_mask(tr)
        with pytest.raises(PF.FaultError) as got:
            PF.FaultSet(**kw).dead_link_mask(tp)
        assert str(got.value) == str(want.value)
    with pytest.raises(KeyError, match="unknown fault kind"):
        PF.sample_faults(tp, 1, "nonesuch")
    for kind, k in (("random", len(tp.edges)), ("chiplets", 16)):
        with pytest.raises(PF.FaultError, match="survivable"):
            PF.sample_faults(tp, k, kind)


def test_port_faultset_is_its_own_type():
    """The two packages' FaultSets are distinct types with equal fields:
    the port never accepts the reference's objects."""
    fs = RF.FaultSet(links=((0, 1),))
    assert not isinstance(fs, PF.FaultSet)
    assert dataclasses.asdict(PF.FaultSet(links=((0, 1),))) == \
        dataclasses.asdict(fs)
