"""The port's topology synthesis (`repro_torch.synth`) equals the JAX
package's on the CPU: the Threefry seeds of `jax.random`, fold-mask
variants, random geometric graphs, perturbation moves, candidate pairs,
the feasibility filter and its messages, the Pareto utilities, a whole
search (pool, ledger, metrics, front, CSV bytes) and its pause / JSON /
resume; the custom-topology registry, the routing pieces the search
needs (`build_routing` sweeps, `cached_routing`'s rebuild branch, the
deprecated acyclicity shim) and a `Scenario` naming a registered
topology; and the README's acceptance search at N = 48."""
import dataclasses
import hashlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import repro.experiments as RX  # noqa: E402
import repro.synth as RS  # noqa: E402
from repro.core import routing as RR  # noqa: E402
from repro.core import topology as RT  # noqa: E402
from repro.core.simulator import SimConfig as RCfg  # noqa: E402
from repro.experiments import io as rio  # noqa: E402
import repro_torch.experiments as PX  # noqa: E402
import repro_torch.synth as PS  # noqa: E402
from repro_torch.core import costmodel as cm  # noqa: E402
from repro_torch.core import routing as PR  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core.simulator import SimConfig as PCfg  # noqa: E402
from repro_torch.experiments import io as pio  # noqa: E402
from repro_torch.synth import prng  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edges(topo) -> list:
    return sorted((min(int(a), int(b)), max(int(a), int(b)))
                  for a, b in topo.edges)


def _same_topology(got, want):
    assert got.name == want.name and got.n == want.n
    assert got.substrate == want.substrate
    assert got.chiplet_area_mm2 == want.chiplet_area_mm2
    np.testing.assert_array_equal(got.pos, want.pos)
    assert _edges(got) == _edges(want)
    assert got.structural_hash() == want.structural_hash()


# =====================================================================
# Threefry keys (jax 0.9.0, partitionable counters, 32-bit mode)
# =====================================================================

@pytest.mark.parametrize("seed", [0, 1, 7, 123, 2 ** 31 - 1, 2 ** 32 + 5])
def test_key_seeds_equal_jax(seed):
    for g in range(6):
        rkey = jax.random.fold_in(jax.random.key(seed), g)
        pkey = prng.fold_in(prng.key(seed), g)
        np.testing.assert_array_equal(pkey, jax.random.key_data(rkey))
        for n in (1, 6, 16, 33):
            got = PS.key_seeds(pkey, n)
            want = RS.key_seeds(rkey, n)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)


def test_seed_high_word_is_dropped_in_32_bit_mode():
    """jax in 32-bit mode truncates an integer seed to 32 bits: seeds
    2^32 apart give one key, and the key's high word is 0."""
    for seed in (5, 2 ** 32 + 5, 2 ** 40 + 5, -(2 ** 32) + 5):
        np.testing.assert_array_equal(
            prng.key(seed), jax.random.key_data(jax.random.key(seed)))
        np.testing.assert_array_equal(prng.key(seed), [0, 5])


@pytest.mark.parametrize("lo,hi", [(0, 1), (-7, 13), (0, 256),
                                   (-2 ** 31, 2 ** 31 - 1), (5, 5)])
def test_split_bits_and_randint_equal_jax(lo, hi):
    key = jax.random.key(42)
    pkey = prng.key(42)
    np.testing.assert_array_equal(
        prng.split(pkey, 5), jax.random.key_data(jax.random.split(key, 5)))
    np.testing.assert_array_equal(
        prng.random_bits32(pkey, 9),
        jax.random.bits(key, (9,), np.uint32))
    np.testing.assert_array_equal(
        prng.randint(pkey, 17, lo, hi),
        jax.random.randint(key, (17,), lo, hi))


def test_randint_rejects_wide_bounds():
    with pytest.raises(ValueError, match="int32"):
        prng.randint(prng.key(0), 3, 0, 2 ** 31)


# =====================================================================
# the design space
# =====================================================================

@pytest.mark.parametrize("n", [16, 48])
@pytest.mark.parametrize("family", ["grid", "brick", "grid_diag"])
def test_fold_mask_variants_equal_reference(n, family):
    got = PS.fold_mask_variants(n, families=(family,), substrate="glass")
    want = RS.fold_mask_variants(n, families=(family,), substrate="glass")
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _same_topology(g, w)


def test_fold_mask_recovers_table_iii_points():
    pairs = [(("grid", ("path", "path")), "mesh"),
             (("grid", ("folded", "folded")), "folded_torus"),
             (("brick", ("path", "path", "path")), "hexamesh"),
             (("brick", ("folded", "folded", "folded")),
              "folded_hexa_torus")]
    for (family, modes), name in pairs:
        fm = PS.fold_mask_topology(48, family, modes)
        assert fm.structural_hash() == PT.build(name, 48).structural_hash()
    with pytest.raises(ValueError, match="chain groups"):
        PS.fold_mask_topology(16, "grid", ("path",))
    with pytest.raises(KeyError, match="unknown family"):
        PS.fold_mask_topology(16, "spiral", ("path",))


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("family,max_degree,extra",
                         [("grid", 5, None), ("brick", 6, None),
                          ("grid", 3, 0.5)])
def test_random_geometric_equals_reference(seed, family, max_degree, extra):
    kw = dict(family=family, max_degree=max_degree, max_range=1,
              extra_frac=extra)
    got = PS.random_geometric(24, seed, **kw)
    want = RS.random_geometric(24, seed, **kw)
    assert (got is None) == (want is None)
    if got is not None:
        _same_topology(got, want)
        assert got.degrees().max() <= max_degree
        assert got.link_ranges().max() <= 1


@pytest.mark.parametrize("seed", [3, 11, 2024])
@pytest.mark.parametrize("n_moves", [1, 2, 5])
def test_perturb_equals_reference(seed, n_moves):
    base_p = PS.random_geometric(16, 3, max_degree=5, max_range=1)
    base_r = RS.random_geometric(16, 3, max_degree=5, max_range=1)
    got = PS.perturb(base_p, seed, max_degree=5, max_range=1,
                     n_moves=n_moves)
    want = RS.perturb(base_r, seed, max_degree=5, max_range=1,
                      n_moves=n_moves)
    assert (got is None) == (want is None)
    if got is not None:
        _same_topology(got, want)
        assert got.structural_hash() != base_p.structural_hash()
        assert got.is_connected() and got.degrees().max() <= 5


@pytest.mark.parametrize("name,n", [("mesh", 16), ("folded_hexa_torus", 48),
                                    ("octamesh", 25)])
@pytest.mark.parametrize("max_range", [0, 1, 2])
def test_candidate_pairs_equal_reference(name, n, max_range):
    pos = PT.build(name, n).pos
    np.testing.assert_array_equal(PS.candidate_pairs(pos, max_range),
                                  RS.candidate_pairs(pos, max_range))


def test_candidate_pairs_match_link_ranges_convention():
    t = PS.random_geometric(24, 5, family="brick", max_degree=6,
                            max_range=1)
    assert t.link_ranges().max() <= 1
    pairs = PS.candidate_pairs(t.pos, max_range=0)
    adj_only = PT.make_topology("adj", t.pos, pairs)
    assert adj_only.link_ranges().max() == 0


# =====================================================================
# feasibility filter and Pareto utilities
# =====================================================================

CRITS = [dict(), dict(max_radix=3, max_wire_cost_mm=1.0),
         dict(min_rate_fraction=0.95), dict(max_link_range=0, max_radix=4)]


@pytest.mark.parametrize("crit", CRITS, ids=lambda c: str(sorted(c)))
def test_feasibility_equals_reference(crit):
    cp, cr = PS.FeasibilityCriteria(**crit), RS.FeasibilityCriteria(**crit)
    names = ["mesh", "torus", "folded_hexa_torus", "octamesh",
             "kite_large", "flattened_butterfly"]
    for substrate in ("organic", "glass"):
        tp = [PT.build(nm, 36, substrate=substrate) for nm in names]
        tr = [RT.build(nm, 36, substrate=substrate) for nm in names]
        for a, b in zip(tp, tr):
            assert PS.check(a, cp) == RS.check(b, cr)
            assert [d.to_dict() for d in PS.feasibility.check_diagnostics(
                a, cp)] == [d.to_dict() for d in
                            RS.feasibility.check_diagnostics(b, cr)]
        fp, rp = PS.filter_feasible(tp, cp)
        fr, rr = RS.filter_feasible(tr, cr)
        assert [t.name for t in fp] == [t.name for t in fr]
        assert [(t.name, r) for t, r in rp] == [(t.name, r) for t, r in rr]
    for sub in ("organic", "glass"):
        for frac in (0.25, 0.9):
            assert PS.max_feasible_link_mm(sub, frac) == \
                RS.max_feasible_link_mm(sub, frac)


def test_feasibility_accepts_fht_rejects_torus_wraps():
    crit = PS.FeasibilityCriteria()
    assert PS.check(PT.build("folded_hexa_torus", 48), crit) == []
    reasons = PS.check(PT.build("torus", 48), crit)
    assert any("link-range" in r for r in reasons)
    reasons = PS.check(PT.build("octamesh", 48),
                       PS.FeasibilityCriteria(max_radix=4))
    assert any("radix" in r for r in reasons)
    assert cm.wire_cost_mm(PT.build("mesh", 16)) > 0


def test_pareto_equals_reference():
    pts = np.array([[10.0, 5.0, 100.0], [12.0, 6.0, 120.0],
                    [9.0, 7.0, 140.0], [9.9, 5.2, 104.0],
                    [1.0, 50.0, 500.0], [np.nan, 1.0, 1.0],
                    [12.0, 6.0, 120.0]])
    mx = (True, False, False)
    for eps in (0.0, 0.05, 0.5):
        np.testing.assert_array_equal(PS.pareto_mask(pts, mx, eps),
                                      RS.pareto_mask(pts, mx, eps))
    assert PS.pareto_mask(pts[:5], mx).tolist() == \
        [True, True, False, False, False]
    assert PS.pareto_mask(pts, mx)[5] == False  # noqa: E712  NaN row
    rng = np.random.default_rng(0)
    for _ in range(5):
        r = rng.random((30, 3))
        r[rng.random(30) < 0.2, 1] = np.nan
        for eps in (0.0, 0.05):
            np.testing.assert_array_equal(PS.pareto_mask(r, mx, eps),
                                          RS.pareto_mask(r, mx, eps))
        np.testing.assert_array_equal(PS.pareto_front(r, mx),
                                      RS.pareto_front(r, mx))
        for a, b in zip(r[:-1], r[1:]):
            assert PS.dominates(a, b, mx) == RS.dominates(a, b, mx)
    assert PS.pareto_mask(np.zeros((0, 3)), mx).shape == (0,)


# =====================================================================
# the search driver
# =====================================================================

RESUME = dict(n=16, n_random=6, generations=2, offspring=6, sim_top=2,
              n_rates=2)


def _resume_cfgs():
    return (PS.SearchConfig(**RESUME, cfg=PCfg(cycles=240, warmup=80)),
            RS.SearchConfig(**RESUME, cfg=RCfg(cycles=240, warmup=80)))


def _csv_bytes(io, rows, path) -> bytes:
    io.write_csv(str(path), rows)
    return path.read_bytes()


def _search_record(res, io, path) -> dict:
    """Everything a search result holds, in comparable form."""
    st = res.state
    return dict(
        pool=[(c.topo.name, c.topo.structural_hash(), c.origin, c.parent,
               c.analytic, c.sim) for c in st.pool],
        seen=sorted(st.seen), rejected=st.rejected, stats=st.stats,
        generation=st.generation,
        simulated=[c.topo.name for c in res.simulated],
        front=[c.topo.name for c in res.front()],
        front_eps=[c.topo.name for c in res.front(0.05)],
        prefilter=res.prefilter_ratio,
        csv=hashlib.sha256(_csv_bytes(io, res.rows(), path)).hexdigest())


@pytest.fixture(scope="module")
def resume_pair():
    pcfg, rcfg = _resume_cfgs()
    return (PS.run_search(pcfg, device="cpu"), RS.run_search(rcfg))


def test_search_equals_reference(resume_pair, tmp_path):
    got, want = resume_pair
    a = _search_record(got, pio, tmp_path / "port.csv")
    b = _search_record(want, rio, tmp_path / "ref.csv")
    assert a == b
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "ref.csv").read_bytes()
    assert got.stats["n_generated"] == got.stats["n_feasible"] + \
        got.stats["n_infeasible"] + got.stats["n_duplicate"]
    # the stage-2 frame's raw counters, scenario by scenario
    for pr, rr in zip(got.frame.results, want.frame.results):
        for key in ("delivered", "offered_n", "accepted_n", "lat_sum"):
            np.testing.assert_array_equal(pr[key], rr[key])


def test_search_state_json_roundtrip_and_resume(resume_pair, tmp_path):
    """Pause after generation 1, serialize, resume: identical to an
    uninterrupted run and to the reference's; the state JSON's bytes
    equal the reference's."""
    pcfg, rcfg = _resume_cfgs()
    at_end = PS.run_search(pcfg, pause_after=pcfg.generations, device="cpu")
    assert at_end.frame is None and at_end.simulated == []
    assert at_end.state.generation == pcfg.generations
    paused = PS.run_search(pcfg, pause_after=1, device="cpu")
    assert paused.frame is None and paused.simulated == []
    path = tmp_path / "port_state.json"
    paused.state.to_json(str(path))
    RS.run_search(rcfg, pause_after=1).state.to_json(
        str(tmp_path / "ref_state.json"))
    assert path.read_bytes() == (tmp_path / "ref_state.json").read_bytes()
    loaded = PS.SearchState.from_json(str(path))
    assert loaded.config == pcfg and loaded.generation == 1
    resumed = PS.run_search(state=loaded, device="cpu")
    full, _ = resume_pair
    assert _search_record(resumed, pio, tmp_path / "a.csv") == \
        _search_record(full, pio, tmp_path / "b.csv")
    with pytest.raises(ValueError, match="different SearchConfig"):
        PS.run_search(dataclasses.replace(pcfg, seed=1),
                      state=PS.SearchState.from_json(str(path)),
                      device="cpu")
    with pytest.raises(ValueError, match="not a synth search state"):
        pio.write_json(str(tmp_path / "x.json"), [], meta=dict(kind="x"))
        PS.SearchState.from_json(str(tmp_path / "x.json"))


def test_rejection_ledger_carries_codes():
    st_ = PS.SearchState(config=PS.SearchConfig(n=36, substrate="organic"))
    assert not st_.admit(PT.build("torus", 36), origin="registry")
    assert not st_.admit(PT.build("torus", 36), origin="registry")
    rej = st_.rejected[0]
    assert rej["reasons"] == ["link-range 4 > 1 (Principle 2)"]
    assert rej["diag_codes"] == ["DP001"]
    assert st_.stats == dict(n_generated=2, n_duplicate=1, n_infeasible=1,
                             n_feasible=0, n_simulated=0)


def test_search_config_round_trips():
    cfg = PS.SearchConfig(seed=3, anchors=("mesh",),
                          cfg=PCfg(cycles=10, warmup=2))
    assert PS.SearchConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.criteria == PS.FeasibilityCriteria(max_radix=8)
    assert cfg.to_dict() == RS.SearchConfig(
        seed=3, anchors=("mesh",), cfg=RCfg(cycles=10, warmup=2)).to_dict()


ACCEPT_CFG = dict(n=48, substrate="organic", seed=0, n_random=16,
                  generations=2, offspring=10, sim_top=3, n_rates=3)


@pytest.fixture(scope="module")
def accept_result():
    return PS.run_search(PS.SearchConfig(**ACCEPT_CFG,
                                         cfg=PCfg(cycles=700, warmup=250)),
                         device="cpu")


def test_acceptance_search_fht_on_own_pareto_front(accept_result):
    """The reference's acceptance search at N = 48 (organic): FHT on (or
    within 5 % of) its own Pareto front, the prefilter >= 5x."""
    res = accept_result
    assert any(c.topo.name == "folded_hexa_torus" for c in res.simulated)
    assert res.on_front("folded_hexa_torus", eps=0.05)
    assert res.stats["n_simulated"] >= 1
    assert res.prefilter_ratio >= 5.0


def test_acceptance_search_pool_and_front(accept_result):
    res = accept_result
    s = res.stats
    assert s["n_generated"] == s["n_feasible"] + s["n_infeasible"] + \
        s["n_duplicate"]
    assert s["n_feasible"] >= 50
    origins = {c.origin for c in res.state.pool}
    assert {"registry", "fold_mask", "random", "perturb"} <= origins
    assert res.front()
    crit = PS.SearchConfig(**ACCEPT_CFG).criteria
    for c in res.simulated:
        assert c.sim is not None and "sim_saturation" in c.sim
        assert PS.check(c.topo, crit) == []
    rows = res.rows()
    assert len(rows) == len(res.state.pool) + len(res.state.rejected)
    assert any(r["status"] == "infeasible" for r in rows)


# =====================================================================
# the custom-topology registry and the routing pieces
# =====================================================================

POS3 = np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]])


@pytest.mark.parametrize("edges,match", [
    ([(0, 1), (1, 2), (2, 2)], "self-loop"),
    ([(0, 1), (1, 2), (2, 1)], "duplicate edge"),
    ([(0, 1), (1, 3)], "out of range")])
def test_make_topology_rejects_bad_edges(edges, match):
    with pytest.raises(ValueError, match=match):
        PT.make_topology("bad", POS3, edges)


def test_build_validates_registered_generators():
    PT.register_topology(
        "bad_gen", lambda n: ("bad_gen", POS3[:n],
                              [(i, i) for i in range(n)]), overwrite=True)
    try:
        with pytest.raises(ValueError, match="self-loop"):
            PT.build("bad_gen", 3)
    finally:
        PT.unregister_topology("bad_gen")
    pos25 = np.stack([np.arange(25.0) % 5, np.arange(25.0) // 5], axis=-1)
    ring25 = [(i, (i + 1) % 25) for i in range(25)]
    PT.register_topology("wrong_n", lambda n: ("wrong_n", pos25, ring25),
                         overwrite=True)
    PT.register_topology("wrong_t", lambda n: PT.build("mesh", 25),
                         overwrite=True)
    try:
        with pytest.raises(ValueError, match="25 positions"):
            PT.build("wrong_n", 16)
        with pytest.raises(ValueError, match="returned N=25"):
            PT.build("wrong_t", 16)
    finally:
        PT.unregister_topology("wrong_n")
        PT.unregister_topology("wrong_t")
    with pytest.raises(KeyError, match="register_topology"):
        PT.build("never_registered", 16)


def test_register_topology_guards():
    with pytest.raises(ValueError, match="built-in"):
        PT.register_topology("mesh", lambda n: None)
    with pytest.raises(TypeError, match="callable"):
        PT.register_topology("not_callable", 3)
    PT.register_topology("reg_guard_demo", lambda n: None, overwrite=True)
    try:
        with pytest.raises(ValueError, match="already registered"):
            PT.register_topology("reg_guard_demo", lambda n: None)
    finally:
        PT.unregister_topology("reg_guard_demo")
    assert "reg_guard_demo" not in PT.CUSTOM_GENERATORS
    PT.unregister_topology("reg_guard_demo")         # absent: no error


def test_scenario_naming_a_registered_topology_equals_reference():
    """A registered name runs through the planner in the port (it raised
    KeyError before the registry was ported), bit for bit with the
    reference, and builds the structure its generator emits."""
    def gen(T):
        def make(n):
            base = T.build("folded_hexa_torus", n)
            return ("wrapped_fht", base.pos, base.edges)
        return make
    PT.register_topology("wrapped_fht", gen(PT), overwrite=True)
    RT.register_topology("wrapped_fht", gen(RT), overwrite=True)
    try:
        topo = PT.build("wrapped_fht", 16)
        assert topo.structural_hash() == \
            PT.build("folded_hexa_torus", 16).structural_hash()
        frames = []
        for X, cfg, kw in ((PX, PCfg(cycles=240, warmup=80),
                            dict(device="cpu")),
                           (RX, RCfg(cycles=240, warmup=80, alloc="jnp"),
                            {})):
            frames.append(X.run(X.Experiment(
                [X.Scenario("wrapped_fht", 16,
                            rates=X.ExplicitRates((0.1, 0.3))),
                 X.Scenario("wrapped_fht", 16, "glass",
                            rates=X.ExplicitRates((0.2,)))],
                cfg=cfg, name="registered"), **kw))
        got, want = frames
        assert got.rows == want.rows
        assert got.rows[0]["topology"] == "wrapped_fht"
        for a, b in zip(got.results, want.results):
            for key in ("delivered", "offered_n", "accepted_n", "lat_sum"):
                np.testing.assert_array_equal(a[key], b[key])
    finally:
        PT.unregister_topology("wrapped_fht")
        RT.unregister_topology("wrapped_fht")


def test_cached_routing_no_collision_for_reregistered_name():
    PT.register_topology("clash", lambda n: PT.build("mesh", n),
                         overwrite=True)
    try:
        t1, r1 = PR.cached_routing("clash", 16)
        PT.register_topology("clash",
                             lambda n: PT.build("folded_torus", n),
                             overwrite=True)
        t2, r2 = PR.cached_routing("clash", 16)
        assert t1.structural_hash() != t2.structural_hash()
        assert r1.n_channels != r2.n_channels or \
            not np.array_equal(r1.table, r2.table)
        assert r2 is PR.routing_for(PT.build("folded_torus", 16))
    finally:
        PT.unregister_topology("clash")


def test_routing_cache_shares_entries_across_names():
    info0 = PR.routing_cache_info()
    base = PT.build("mesh", 20)
    alias = dataclasses.replace(base, name="mesh_alias")
    assert PR.routing_for(base) is PR.routing_for(alias)
    info1 = PR.routing_cache_info()
    assert info1["hits"] >= info0["hits"] + 1
    c = PT.build("folded_torus", 16)
    assert base.structural_hash() == dataclasses.replace(
        base, name="x", edges=base.edges[::-1].copy()).structural_hash()
    assert base.structural_hash() != c.structural_hash()


@pytest.mark.parametrize("name,n", [("mesh", 16), ("folded_hexa_torus", 24),
                                    ("octamesh", 25), ("kite_large", 20)])
@pytest.mark.parametrize("orderings", [False, True])
def test_build_routing_sweeps_equal_reference(name, n, orderings):
    got = PR.build_routing(PT.build(name, n), sweep_roots=True,
                           include_orderings=orderings)
    want = RR.build_routing(RT.build(name, n), sweep_roots=True,
                            include_orderings=orderings)
    for f in ("table", "ch_src", "ch_dst", "out_ch", "in_ch"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.prohibited_turns == want.prohibited_turns


@pytest.mark.parametrize("seed", [1, 77, 4321])
@pytest.mark.parametrize("n,max_degree", [(12, 3), (18, 5), (24, 6)])
def test_routing_is_deadlock_free_on_random_topologies(seed, n, max_degree):
    topo = PS.random_geometric(n, seed, max_degree=max_degree, max_range=1)
    assert topo is not None
    r = PR.build_routing(topo)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert PR.dependency_graph_is_acyclic(r) is True
        assert any(issubclass(x.category, DeprecationWarning) for x in w)
    hops = r.restricted_hops()
    off = ~np.eye(n, dtype=bool)
    assert (hops[off] >= 1).all() and hops.max() <= 4 * n
    assert PR.dependency_graph_is_acyclic.__doc__.startswith("Deprecated")


def test_nearest_valid_n_equals_reference():
    for name in ("mesh", "hypercube", "cluscross_v1", "cluscross_v2"):
        for n in (2, 15, 16, 36, 50, 64):
            assert PT.nearest_valid_n(name, n) == RT.nearest_valid_n(name, n)
    assert PT.nearest_valid_n("hypercube", 36) == 32
