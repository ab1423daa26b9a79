"""The sharded `Model` on 2 and 4 spawned gloo ranks, against the port's
unsharded `Model` and the JAX package's.

The parent computes the reference (`repro`'s unsharded model, jitted on
the CPU) once and pickles its parameters, inputs and outputs; then two
spawns run every check on their ranks:

* 2 ranks, meshes (1, 2) and (2, 1); 4 ranks, mesh (2, 2): for
  qwen3-moe, grok (virtual split), jamba, minicpm3 (MLA, 3 heads: the
  sequence-parallel rule switches on) and starcoder2 with 3 heads (as
  the reference's seq-parallel test; its 3 kv heads do not tile the
  model axis, so decode runs `decode_attention_dist`), at
  `capacity_factor=8.0` as the reference test uses: `loss_fn`, prefill
  logits and 4 decode steps within 1e-4 of the unsharded port and of
  `repro`; every parameter's local block has its spec's shard size;
  a decode step writes the attention and MLA cache blocks in place;
* (1, 2) saves qwen3-moe's parameters, (2, 2) restores them onto its
  own placements (`restore_checkpoint(placements=)`): the full tensors
  equal the saved ones bit for bit;
* (2, 2): `make_moe_apply`'s `moe_ep_local` branch (b*t > 2048) equals
  the dropless MoE within 1e-5.

Each spawn has its own deadline: a rank that hangs fails the test and
every rank is terminated, so the suite never waits on it.  Ranks import
torch and the port only.
"""
import dataclasses
import math
import pickle
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

B, T, STEPS = 4, 16, 4
# decode positions: ring slots 6..9 of the 16-slot caches, so that on a
# model axis of 2 both halves of a sequence-sharded cache own a slot
DECODE_AT = T + 6
TOL = 1e-4
EP_TOL = 1e-5
DEADLINE_S = 150
EP_TOKENS = 520                       # 4 x 520 = 2080 tokens > 2048
# arch -> config overrides (besides float32 compute, capacity_factor 8)
ARCHS = {
    "qwen3_moe_235b_a22b": {},
    "grok_1_314b": {},
    "jamba_v0_1_52b": {},
    "minicpm3_4b": {"n_heads": 3},
    "starcoder2_3b": {"n_heads": 3, "n_kv_heads": 3, "head_dim": 16,
                      "d_model": 48, "d_ff": 96},
}
SAVED = "qwen3_moe_235b_a22b"


def _port_cfg(arch):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=torch.float32,
                               capacity_factor=8.0, **ARCHS[arch])


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A directory holding `reference.pkl`: per arch the JAX package's
    parameters (numpy), the inputs, and its loss, prefill logits and
    teacher-forced decode logits."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import Model, unbox

    d = tmp_path_factory.mktemp("sharded")
    data = {}
    for arch, over in ARCHS.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  compute_dtype=jnp.float32,
                                  capacity_factor=8.0, **over)
        model = Model(cfg)
        params = unbox(jax.jit(model.init)(jax.random.PRNGKey(0)))[0]
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
        steps = rng.integers(0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)
        loss = jax.jit(model.loss_fn)(params, {"tokens": tokens,
                                               "labels": labels})
        logits, caches = jax.jit(model.prefill)(params, {"tokens": tokens})
        decode = jax.jit(model.decode_step)
        outs = []
        for i in range(STEPS):
            step_logits, caches = decode(params, caches, steps[i],
                                         DECODE_AT + i)
            outs.append(np.asarray(step_logits)[:, -1])
        data[arch] = dict(
            params=jax.tree.map(np.asarray, params), tokens=tokens,
            labels=labels, steps=steps, loss=float(loss),
            prefill=np.asarray(logits), decode=outs)
    with open(d / "reference.pkl", "wb") as f:
        pickle.dump(data, f)
    return d


def _serve(model, ref):
    """(loss, prefill logits, decode logits per step) of `model` on the
    reference's inputs, as numpy."""
    tokens = torch.from_numpy(ref["tokens"]).long()
    with torch.no_grad():
        loss = float(model.loss_fn(model.param_tree(), {
            "tokens": tokens,
            "labels": torch.from_numpy(ref["labels"]).long()}))
    logits, caches = model.prefill(tokens)
    out = []
    for i in range(STEPS):
        step, caches = model.decode_step(
            caches, torch.from_numpy(ref["steps"][i]).long(), DECODE_AT + i)
        out.append(step[:, -1].numpy())
    return loss, logits.numpy(), out


def _check_blocks(model, ctx, what):
    """Each parameter is a DTensor whose local block has its spec's shard
    size."""
    from repro_torch import tree as Tr
    from repro_torch.launch import steps as St
    from repro_torch.models import sharding as SH
    _, shardings = St.param_shardings(model, ctx)
    for p, sh in zip(Tr.leaves(model.param_tree()),
                     Tr.leaves(shardings, is_leaf=SH.is_sharding)):
        assert p.to_local().numel() == math.prod(sh.shard_shape(p.shape)), \
            (what, sh.spec, tuple(p.shape), tuple(p.to_local().shape))


def _close(got, want, tol, what):
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _check_cache_stays(model, ref, what):
    """A decode step writes each self-attention and MLA cache block in
    place: a cache sharded over the model axis, along its kv heads or its
    sequence, is never gathered and placed anew."""
    def blocks(caches):
        return [caches[i][0][j].to_local().data_ptr()
                for i, sp in enumerate(model.specs)
                if sp["kind"] in ("attn", "mla")
                for j in (0, 1)]
    _, caches = model.prefill(torch.from_numpy(ref["tokens"]).long())
    before = blocks(caches)
    _, caches = model.decode_step(
        caches, torch.from_numpy(ref["steps"][0]).long(), DECODE_AT)
    assert blocks(caches) == before, f"{what}: a cache block moved"


def _model_checks(ctx, data, label):
    from repro_torch import convert
    for arch, ref in data.items():
        cfg = _port_cfg(arch)
        plain = convert.params_from_reference(ref["params"], cfg)
        sharded = convert.params_from_reference(ref["params"], cfg, ctx)
        _check_blocks(sharded, ctx, f"{label} {arch}")
        _check_cache_stays(sharded, ref, f"{label} {arch}")
        got, want = _serve(sharded, ref), _serve(plain, ref)
        for other, name in ((want, "unsharded port"), (
                (ref["loss"], ref["prefill"], ref["decode"]), "repro")):
            _close(got[0], other[0], TOL, f"{label} {arch} loss vs {name}")
            _close(got[1], other[1], TOL, f"{label} {arch} prefill vs {name}")
            for i in range(STEPS):
                _close(got[2][i], other[2][i], TOL,
                       f"{label} {arch} decode {i} vs {name}")


def _save(ctx, data, ckpt):
    """The sharded qwen3-moe's parameters, gathered on every rank, written
    by rank 0."""
    from repro_torch import convert, tree as Tr
    from repro_torch.checkpoint.checkpoint import _to_numpy, save_checkpoint
    model = convert.params_from_reference(data[SAVED]["params"],
                                          _port_cfg(SAVED), ctx)
    host = Tr.tree_map(_to_numpy, model.param_tree())
    if dist.get_rank() == 0:
        save_checkpoint(str(ckpt), 1, host)
    dist.barrier()


def _restore(ctx, data, ckpt):
    """Restore onto this mesh's placements: every leaf's full tensor
    equals the saved one bit for bit, its block has its shard size."""
    from torch.distributed.tensor import DTensor
    from repro_torch import convert, tree as Tr
    from repro_torch.checkpoint.checkpoint import restore_checkpoint
    from repro_torch.launch import steps as St
    from repro_torch.models import Model
    from repro_torch.models import sharding as SH
    cfg = _port_cfg(SAVED)
    shapes, shardings = St.param_shardings(Model(cfg, ctx), ctx)
    got = restore_checkpoint(str(ckpt), 1, shapes, placements=shardings)
    want = convert.params_from_reference(data[SAVED]["params"],
                                         cfg).param_tree()
    for g, w, sh in zip(Tr.leaves(got), Tr.leaves(want),
                        Tr.leaves(shardings, is_leaf=SH.is_sharding)):
        assert isinstance(g, DTensor)
        assert torch.equal(g.full_tensor(), w.detach())
        assert g.to_local().numel() == math.prod(sh.shard_shape(w.shape))


def _ep_local_checks(ctx, data):
    """make_moe_apply's expert-parallel branch for b*t > 2048 against the
    dropless MoE, output and aux."""
    from repro_torch import convert
    from repro_torch.models import sharding as SH
    from repro_torch.models.model import make_moe_apply
    for arch in ("qwen3_moe_235b_a22b", "grok_1_314b", "jamba_v0_1_52b"):
        cfg = _port_cfg(arch)
        plain = convert.params_from_reference(data[arch]["params"], cfg)
        sharded = convert.params_from_reference(data[arch]["params"], cfg,
                                                ctx)
        i = next(j for j, sp in enumerate(cfg.layer_specs()) if sp["moe"])
        x = torch.from_numpy(np.random.default_rng(7).normal(
            0, 1, (B, EP_TOKENS, cfg.d_model)).astype(np.float32))
        want_y, want_aux = make_moe_apply(cfg)(
            plain.param_tree()["layers"][i]["moe"], x)
        xl = SH.local_shard(x, ctx.mesh, SH.batch_spec(ctx, B, 3))
        with torch.no_grad():
            y, aux = make_moe_apply(cfg, ctx, batch=B)(
                sharded.param_tree()["layers"][i]["moe"], xl)
        y = SH.gather_dim(y, ctx.mesh, SH.batch_spec(ctx, B, 3)[0], 0)
        _close(y.detach(), want_y.detach(), EP_TOL, f"{arch} moe_ep_local")
        _close(aux, want_aux.detach(), EP_TOL, f"{arch} moe_ep_local aux")


def _rank_main(rank, world, store, workdir, shapes):
    """One gloo rank: every check on every mesh of `shapes`."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import steps as St
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        workdir = Path(workdir)
        with open(workdir / "reference.pkl", "rb") as f:
            data = pickle.load(f)
        for shape in shapes:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            ctx = St.build_ctx(mesh)
            _model_checks(ctx, data, f"mesh {shape}")
            if shape == (1, 2):
                _save(ctx, data, workdir / "ckpt")
            if shape == (2, 2):
                _restore(ctx, data, workdir / "ckpt")
                _ep_local_checks(ctx, data)
    finally:
        dist.destroy_process_group()


def _spawn(world, workdir, shapes):
    """Run `_rank_main` on `world` spawned ranks; fail (and terminate them
    all) if they have not finished within DEADLINE_S."""
    ctx = mp.start_processes(
        _rank_main, args=(world, str(workdir / f"store{world}"),
                          str(workdir), shapes),
        nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > end:
                pytest.fail(f"{world} gloo ranks did not finish within "
                            f"{DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(5)


def test_sharded_model_on_two_ranks(workdir):
    """Meshes (1, 2) and (2, 1); (1, 2) saves the checkpoint the 4-rank
    test restores."""
    _spawn(2, workdir, [(1, 2), (2, 1)])


def test_sharded_model_on_four_ranks(workdir):
    """Mesh (2, 2), the elastic restore from (1, 2), and the expert-
    parallel branch for long inputs."""
    if not (workdir / "ckpt").exists():
        _spawn(2, workdir, [(1, 2)])
    _spawn(4, workdir, [(2, 2)])
