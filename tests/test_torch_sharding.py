"""The port's sharded LM paths against the JAX package, in one process.

* The logical axes of every parameter (all ten configs at full size,
  leaf for leaf) and the specs of `launch.steps` (parameters in train
  and decode mode, batches and caches of every `SHAPES` entry) on the
  16 x 16 and 2 x 16 x 16 production meshes, given to both packages as
  axis sizes with no devices.
* On a world-size-1 gloo mesh (`make_host_mesh("cpu")`), against the
  reference's bodies on a 1 x 1 jax mesh: `moe_ep_local` (under a
  `shard_map`, as the reference's `make_moe_apply` calls it) and
  `moe_ep_stationary` at each MoE config's own `capacity_factor`, drops
  included, within 1e-5; `decode_attention_dist` within 2e-5 (the
  reference test's tolerance) with the updated cache bit-equal.

The multi-rank checks (2 and 4 spawned gloo ranks) are in
`test_torch_sharding_ranks.py`.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import ARCHS, SHAPES, get_config as ref_get_config
from repro.launch import steps as RSt
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.models import Model as RefModel, unbox
from repro.models import layers as RL
from repro.models.model import DecodeDims as RefDims, \
    init_layer as ref_init_layer
from repro_torch import convert, tree as T
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M, steps as St
from repro_torch.models import Model
from repro_torch.models import layers as L, sharding as SH
from repro_torch.models.model import DecodeDims

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
MOE_ARCHS = ["qwen3_moe_235b_a22b", "grok_1_314b", "jamba_v0_1_52b"]
EP_TOL = 1e-5
DIST_TOL = 2e-5


def _ref_flat(tree, is_leaf=None):
    """{path: leaf} of a jax tree, paths as tuples of keys / indices."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            leaf for path, leaf in flat}


def _port_flat(tree, is_leaf=None):
    return dict(T.leaves_with_paths(tree, is_leaf=is_leaf))


def _same(xs):
    assert all(x == xs[0] for x in xs), xs
    return xs[0]


def _stacked_axes(axes, cfg):
    """The port's axes tree in the reference's layout ("layers" first)."""
    return convert.reference_tree(axes, cfg,
                                  lambda xs: ("layers",) + _same(xs),
                                  SH.is_axes_leaf)


def _stacked_specs(specs, cfg):
    """A tree of Sharding in the reference's layout, as spec tuples."""
    tree = T.tree_map(lambda s: tuple(s.spec), specs, SH.is_sharding)
    return convert.reference_tree(tree, cfg, lambda xs: (None,) + _same(xs),
                                  _is_spec)


def _stacked_caches(caches, cfg, stack, is_leaf):
    """A per-layer cache tree (the port's) in the reference's layout:
    {blocks, tail[, cross_blocks, cross_tail]}."""
    pat, n_rep, tail = cfg.pattern()
    k = len(pat)
    cross = cfg.arch_kind == "encdec"

    def own(c):
        return c[:-1] if cross else c

    def group(entries):
        return T.unflatten(entries[0], [stack(ts) for ts in zip(
            *(T.leaves(e, is_leaf) for e in entries))], is_leaf)

    out = {"blocks": tuple(group([own(caches[r * k + s])
                                  for r in range(n_rep)]) for s in range(k)),
           "tail": tuple(own(caches[n_rep * k + i])
                         for i in range(len(tail)))}
    if cross:
        out["cross_blocks"] = tuple(group([caches[r * k + s][-1]
                                           for r in range(n_rep)])
                                    for s in range(k))
        out["cross_tail"] = tuple(caches[n_rep * k + i][-1]
                                  for i in range(len(tail)))
    return out


def _is_spec(x):
    """A spec tuple (entries None, names, or tuples of names)."""
    return isinstance(x, tuple) and len(x) > 0 and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and e and all(isinstance(a, str)
                                               for a in e)) for e in x)


# ---------------------------------------------------------------------
# logical axes and specs (no ranks)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_axes_tree_matches_reference(arch):
    """Every leaf's logical axes (and shape), all ten configs at full
    size, as the reference's `unbox(eval_shape(init))`."""
    ref_shapes, ref_axes = unbox(jax.eval_shape(
        RefModel(ref_get_config(arch)).init, jax.random.PRNGKey(0)))
    cfg = get_config(arch)
    shapes, axes = St.param_shapes_and_axes(Model(cfg))
    assert all(t.device.type == "meta" for t in T.leaves(shapes))
    got = _port_flat(_stacked_axes(axes, cfg), SH.is_axes_leaf)
    want = _ref_flat(ref_axes, SH.is_axes_leaf)
    assert got == want
    got_shapes = _port_flat(convert.reference_tree(shapes, cfg))
    assert {k: tuple(v.shape) for k, v in got_shapes.items()} == \
        {k: tuple(v.shape) for k, v in _ref_flat(ref_shapes).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch):
    """`param_shardings` (train and decode), `batch_specs` and
    `cache_specs` for every SHAPES entry equal the reference's specs on
    the production meshes, as tuples."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name, sizes in MESHES.items():
        rctx = RSt.build_ctx(AbstractMesh(tuple(sizes.values()),
                                          tuple(sizes)))
        ctx = St.build_ctx(sizes)
        rmodel, model = RefModel(rcfg, rctx), Model(cfg, ctx)
        assert model.cfg.seq_parallel == rmodel.cfg.seq_parallel
        for mode in ("train", "decode"):
            _, rsh = RSt.param_shardings(rmodel, rctx, mode)
            _, sh = St.param_shardings(model, ctx, mode)
            got = _port_flat(_stacked_specs(sh, cfg), _is_spec)
            want = {k: tuple(v.spec) for k, v in _ref_flat(
                rsh, lambda x: hasattr(x, "spec")).items()}
            assert got == want, (name, mode)
        for shape_name, shape in SHAPES.items():
            _, rb = RSt.batch_specs(rcfg, shape, rctx)
            b, sb = St.batch_specs(cfg, shape, ctx)
            assert all(t.device.type == "meta" for t in b.values())
            assert {k: tuple(v.spec) for k, v in sb.items()} == \
                {k: tuple(v.spec) for k, v in rb.items()}, shape_name
            dims = (shape["global_batch"], shape["seq_len"])
            _, rc = RSt.cache_specs(rmodel, RefDims(*dims), rctx)
            _, sc = St.cache_specs(model, DecodeDims(*dims), ctx)
            got = _port_flat(_stacked_caches(
                T.tree_map(lambda s: tuple(s.spec), sc, SH.is_sharding), cfg,
                lambda xs: (None,) + _same(xs), _is_spec), _is_spec)
            want = {k: tuple(v.spec) for k, v in _ref_flat(
                rc, lambda x: hasattr(x, "spec")).items()}
            assert got == want, (name, shape_name)


def test_cache_axes_match_reference():
    """`Model.cache_logical_axes` in the reference's layout, for every
    config."""
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        want = RefModel(ref_get_config(arch, smoke=True)).cache_logical_axes(
            RefDims(2, 16))
        got = _stacked_caches(Model(cfg).cache_logical_axes(DecodeDims(2, 16)),
                              cfg, lambda xs: ("layers",) + _same(xs),
                              SH.is_axes_leaf)
        assert _port_flat(got, SH.is_axes_leaf) == _ref_flat(
            want, SH.is_axes_leaf), arch


def test_spec_to_placements_follows_the_mesh_order():
    """A dimension split over several mesh axes takes them in the mesh's
    order; the other order has no placements and raises."""
    class FakeMesh:
        mesh_dim_names = ("pod", "data", "model")
    pl = SH.placements(FakeMesh, SH.Spec((("pod", "data"), "model")))
    assert [(p.is_shard(), getattr(p, "dim", None)) for p in pl] == \
        [(True, 0), (True, 0), (True, 1)]
    with pytest.raises(ValueError, match="mesh's order"):
        SH.placements(FakeMesh, SH.Spec((("data", "pod"), None)))


# ---------------------------------------------------------------------
# world-size-1 gloo mesh against the reference's bodies
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_mesh():
    """The port's 1 x 1 gloo mesh; its process group is destroyed after
    the module, since later test files run in the same worker."""
    mesh = M.make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def _moe_inputs(arch, seed=0):
    """The reference config (own capacity_factor), the first MoE layer's
    parameters of its smoke model (virtual-split layout) and x [2, 16,
    D], as numpy.  x shares one offset across its tokens, so the router
    favours the same experts for many of them and some exceed their
    capacity."""
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                               compute_dtype=jnp.float32)
    spec = next(sp for sp in rcfg.layer_specs() if sp["moe"])
    layer, _ = unbox(jax.jit(partial(ref_init_layer, spec=spec, cfg=rcfg))(
        jax.random.PRNGKey(seed)))
    moe = {k: np.asarray(v) for k, v in layer["moe"].items()}
    rng = np.random.default_rng(seed + 1)
    x = (rng.normal(0, 1, (2, 16, rcfg.d_model)) +
         rng.normal(0, 2, (rcfg.d_model,))).astype(np.float32)
    return rcfg, moe, x


def _drops(moe, x, cfg, tokens):
    """(token, expert) pairs routed beyond each expert's capacity."""
    _, top_e, _ = L._router({"router": torch.from_numpy(moe["router"])},
                            torch.from_numpy(x), cfg)
    counts = torch.bincount(top_e.reshape(-1), minlength=cfg.n_experts)
    return int((counts - L.moe_capacity(tokens, cfg)).clamp(min=0).sum())


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("body", ["local", "stationary"])
def test_moe_ep_matches_reference(host_mesh, arch, body):
    """Each expert-parallel body equals the reference's on one rank at the
    config's own capacity_factor (1.25), drops included."""
    from jax.experimental.shard_map import shard_map
    rcfg, moe, x = _moe_inputs(arch)
    cfg = get_config(arch, smoke=True)
    assert cfg.capacity_factor == rcfg.capacity_factor == 1.25
    assert _drops(moe, x, cfg, x.shape[0] * x.shape[1]) > 0
    rmesh = ref_host_mesh()
    rctx = RSt.build_ctx(rmesh)
    jp = {k: jnp.asarray(v) for k, v in moe.items()}
    tp = {k: torch.from_numpy(v) for k, v in moe.items()}
    if body == "local":
        fn = shard_map(
            partial(RL.moe_ep_local, cfg=rcfg, axis_name="model", e_par=1,
                    f_par=1), mesh=rmesh,
            in_specs=({"router": P(), "wi": P("model"), "wg": P("model"),
                       "wo": P("model")}, P("data", None, None)),
            out_specs=(P("data", None, None), P()), check_rep=False)
        want_y, want_aux = jax.jit(fn)(jp, jnp.asarray(x))
        got_y, got_aux = L.moe_ep_local(tp, torch.from_numpy(x), cfg,
                                        host_mesh, "model", e_par=1, f_par=1)
    else:
        want_y, want_aux = jax.jit(partial(
            RL.moe_ep_stationary, cfg=rcfg, ctx=rctx))(jp, jnp.asarray(x))
        got_y, got_aux = L.moe_ep_stationary(
            tp, torch.from_numpy(x), cfg, St.build_ctx(host_mesh))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=EP_TOL, rtol=0)
    assert abs(float(got_aux) - float(want_aux)) < EP_TOL


def test_decode_attention_dist_matches_reference(host_mesh):
    """`decode_attention_dist` equals the reference's and the dense decode
    within 2e-5, and writes the cache bit for bit as they do."""
    cfg = get_config("qwen3_1_7b", smoke=True)
    rcfg = ref_get_config("qwen3_1_7b", smoke=True)
    rng = np.random.default_rng(3)
    b, s, kv, hd, h = 2, 8, 2, 16, 4
    q, kn, vn = (rng.normal(0, 1, (b, 1, n, hd)).astype(np.float32)
                 for n in (h, kv, kv))
    ck, cv = (rng.normal(0, 1, (b, s, kv, hd)).astype(np.float32)
              for _ in range(2))
    pos = 13                               # ring slot 5
    rctx = RSt.build_ctx(ref_host_mesh())
    want, (wck, wcv) = RL.decode_attention_dist(
        None, *map(jnp.asarray, (q, kn, vn)),
        (jnp.asarray(ck), jnp.asarray(cv)), pos, rcfg, rctx)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, (gck, gcv) = L.decode_attention_dist(
        None, *map(torch.from_numpy, (q, kn, vn)), (tck, tcv), pos, cfg,
        St.build_ctx(host_mesh))
    assert gck is tck and gcv is tcv                  # written in place
    np.testing.assert_array_equal(gck.numpy(), np.asarray(wck))
    np.testing.assert_array_equal(gcv.numpy(), np.asarray(wcv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=DIST_TOL, rtol=DIST_TOL)
    ck_r, cv_r = ck.copy(), cv.copy()
    ck_r[:, pos % s], cv_r[:, pos % s] = kn[:, 0], vn[:, 0]
    kr = np.repeat(ck_r, h // kv, 2)
    vr = np.repeat(cv_r, h // kv, 2)
    sc = np.einsum("bqhd,bshd->bhqs", q, kr) / np.sqrt(hd)
    w = np.exp(sc - sc.max(-1, keepdims=True))
    ref = np.einsum("bhqs,bshd->bqhd", w / w.sum(-1, keepdims=True), vr)
    np.testing.assert_allclose(got.numpy(), ref, atol=DIST_TOL,
                               rtol=DIST_TOL)


def test_host_mesh_and_production_mesh(host_mesh):
    """The host mesh is 1 x 1 over ("data", "model") on gloo; the
    production meshes refuse a world of the wrong size."""
    assert host_mesh.mesh_dim_names == ("data", "model")
    assert tuple(host_mesh.mesh.shape) == (1, 1)
    assert dist.get_backend() == "gloo"
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="ranks"):
            M.make_production_mesh(multi_pod=multi, device="cpu")


def test_sharded_model_on_one_rank(host_mesh):
    """`Model(cfg, ctx)` on the 1 x 1 mesh: DTensor parameters and caches,
    and the same prefill, decode, loss and loss gradients as the
    unsharded model."""
    from torch.distributed.tensor import DTensor
    ctx = St.build_ctx(host_mesh)
    for arch in ("qwen3_moe_235b_a22b", "jamba_v0_1_52b",
                 "seamless_m4t_medium"):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  compute_dtype=torch.float32,
                                  capacity_factor=8.0)   # no drops
        mu = Model(cfg).init(torch.Generator().manual_seed(0))
        ms = Model(cfg, ctx).init(torch.Generator().manual_seed(0))
        assert all(isinstance(t, DTensor) for t in T.leaves(ms.param_tree()))
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
        frames = (torch.from_numpy(rng.normal(0, 0.02, (2, 16, cfg.d_model))
                                   .astype(np.float32))
                  if cfg.arch_kind == "encdec" else None)
        (lu, cu), (ls, cs) = mu.prefill(toks, frames), ms.prefill(toks,
                                                                  frames)
        assert all(isinstance(t, DTensor) for t in T.leaves(cs))
        assert float((lu - ls).abs().max()) < 1e-5
        tok = lu.argmax(-1)[:, None]
        for i in range(2):
            a, cu = mu.decode_step(cu, tok, 16 + i)
            b, cs = ms.decode_step(cs, tok, 16 + i)
            assert float((a - b).abs().max()) < 1e-5
            tok = a[:, -1].argmax(-1)[:, None]
        batch = {"tokens": toks, "labels": toks}
        if frames is not None:
            batch["frames"] = frames
        with torch.no_grad():
            assert abs(float(mu.loss_fn(mu.param_tree(), batch) -
                             ms.loss_fn(ms.param_tree(), batch))) < 1e-5
        # under grad: the same loss and the same gradients, in the
        # parameters' layout (the sharded train step's)
        out = []
        for m in (mu, ms):
            leaves = [p.detach().requires_grad_()
                      for p in T.leaves(m.param_tree())]
            loss = m.loss_fn(T.unflatten(m.param_tree(), leaves), batch)
            out.append((loss, torch.autograd.grad(loss, leaves)))
        assert abs(float(out[0][0] - out[1][0])) < 1e-5
        for gu, gs in zip(out[0][1], out[1][1]):
            assert isinstance(gs, DTensor)
            assert float((gu - gs.full_tensor()).abs().max()) < 1e-5
