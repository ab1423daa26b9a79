"""The sharded train step on 2 and 4 spawned gloo ranks, against the
port's unsharded step and the JAX package's.

The parent computes, from the JAX package's smoke parameters (carried
over as numpy), the reference's train step (2 steps, jitted) and the
unsharded port's (the loss and every leaf's gradient at the start, then
2 steps at microbatches 1 and 2: losses, grad norms, parameters, m and
v), and pickles them; then two spawns run the sharded step on their
ranks and compare:

* cases, all at float32 compute: qwen3-1.7b (dense, FSDP), qwen3-moe at
  capacity factor n_experts / top_k (nothing dropped, so the expert-
  parallel bodies equal the dropless MoE) with batch 4 x 16 tokens
  (`moe_ep_stationary`) and 4 x 520 (2080 > 2048: `moe_ep_local`), and
  gemma3-1b with 3 heads (they do not tile a model axis of 2, so
  sequence parallelism switches on there);
* meshes (1, 2) and (2, 1) on 2 ranks, (2, 2) on 4 (spawned at the same
  time as (2, 1)): the loss and each
  leaf's gradient gathered whole within 1e-5 of the unsharded port;
  after 2 steps the losses, grad norms, parameters, m and v within 1e-5
  of the unsharded port at microbatches 1 and 2, and the losses, grad
  norms and parameters within 1e-4 of the JAX package (microbatches 1);
  m and v are DTensors laid out as the parameters;
* checkpoints: `launch.train.run` on (2, 2) saves at step 2 and ends at
  step 3; resumed on (2, 2) it takes step 3 bit for bit; resumed on
  (1, 2) and unsharded (the parent) within 1e-5.

Each spawn has a deadline after which the test fails and every rank is
terminated.  Ranks import torch and the port only.
"""
import dataclasses
import pickle
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

B, STEPS = 4, 2
TOL = 1e-5                 # sharded against the unsharded port
JAX_TOL = 1e-4             # against the JAX package (its sums differ)
DEADLINE_S = 150
SCHEDULE = dict(total_steps=50, warmup_steps=1)
DROPLESS = {"capacity_factor": 4.0}        # the smoke MoE: 8 experts, top 2
# name -> (arch, config overrides, sequence length, microbatches)
CASES = {
    "dense": ("qwen3_1_7b", {}, 16, (1, 2)),
    "moe_stationary": ("qwen3_moe_235b_a22b", DROPLESS, 16, (1, 2)),
    "moe_local": ("qwen3_moe_235b_a22b", DROPLESS, 520, (1,)),
    "seq_parallel": ("gemma3_1b", {"n_heads": 3}, 16, (1, 2)),
}
CKPT = dict(case="dense", steps=3, every=2)


def _port_cfg(case):
    from repro_torch.configs import get_config
    arch, over, _, _ = CASES[case]
    return dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=torch.float32, **over)


def _batches(vocab, seq):
    from repro_torch.data import SyntheticLMData
    data = SyntheticLMData(vocab=vocab, seq_len=seq, global_batch=B, seed=0)
    return [data.batch(i) for i in range(STEPS)]


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_steps(model, batches, microbatches):
    """(losses, grad norms, params, m, v) of STEPS train steps, the trees
    as flat lists of whole float32 numpy arrays."""
    from repro_torch import tree as T
    from repro_torch.launch import steps as St
    from repro_torch.optim import adamw_init
    step = St.make_train_step(model, St.TrainConfig(
        microbatches=microbatches, **SCHEDULE))
    opt = adamw_init(model.param_tree())
    out = [tuple(float(x) for x in step(opt, _tb(b))) for b in batches]

    def whole(tree):
        return [_whole(t) for t in T.leaves(tree)]
    return ([o[0] for o in out], [o[1] for o in out],
            whole(model.param_tree()), whole(opt["m"]), whole(opt["v"]), opt)


def _whole(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().numpy().copy()


def _loss_and_grads(model, batch):
    """(loss, whole gradient of every leaf) at the model's parameters."""
    from repro_torch import tree as T
    tree = model.param_tree()
    leaves = [p.detach().requires_grad_() for p in T.leaves(tree)]
    loss = model.loss_fn(T.unflatten(tree, leaves), _tb(batch))
    grads = torch.autograd.grad(loss, leaves)
    return float(loss), [_whole(g) for g in grads]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A directory holding `reference.pkl`: per case the JAX parameters
    (numpy), the batches, the JAX trajectory and the unsharded port's
    gradients and trajectories."""
    d = tmp_path_factory.mktemp("sharded_train")
    # small tensors: one thread, as each rank runs (several threads per
    # process oversubscribe the cores the ranks and other workers share)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        data = _references()
    finally:
        torch.set_num_threads(threads)
    with open(d / "reference.pkl", "wb") as f:
        pickle.dump(data, f)
    return d


def _references() -> dict:
    """{case: its references} (`workdir`)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch import steps as JS
    from repro.models import Model, unbox
    from repro.optim import adamw_init
    from repro_torch.convert import params_from_reference
    data, params = {}, {}
    for case, (arch, over, seq, mbs) in CASES.items():
        jcfg = dataclasses.replace(get_config(arch, smoke=True),
                                   compute_dtype=jnp.float32, **over)
        key = (arch, tuple(sorted(over.items())))
        if key not in params:
            params[key] = jax.tree.map(np.asarray, unbox(
                jax.jit(Model(jcfg).init)(jax.random.PRNGKey(0)))[0])
        p = params[key]
        batches = _batches(jcfg.vocab, seq)
        step = jax.jit(JS.make_train_step(Model(jcfg), JS.TrainConfig(
            **SCHEDULE)))
        jp, opt, jax_out = p, adamw_init(p), []
        for b in batches:
            jp, opt, met = step(jp, opt, {k: jnp.asarray(v)
                                          for k, v in b.items()})
            jax_out.append((float(met["loss"]), float(met["grad_norm"])))
        cfg = _port_cfg(case)
        ref = dict(params=p, batches=batches,
                   jax_loss=[o[0] for o in jax_out],
                   jax_gnorm=[o[1] for o in jax_out],
                   jax_params=_flat_port(jax.tree.map(np.asarray, jp), cfg),
                   grads=_loss_and_grads(params_from_reference(p, cfg),
                                         batches[0]),
                   steps={})
        for mb in mbs:
            ref["steps"][mb] = _port_steps(params_from_reference(p, cfg),
                                           batches, mb)[:5]
        data[case] = ref
    return data


def _flat_port(jax_params, cfg):
    """The JAX parameters as the port's flat leaves (numpy)."""
    from repro_torch import tree as T
    from repro_torch.convert import params_from_reference
    return [t.detach().numpy() for t in
            T.leaves(params_from_reference(jax_params, cfg).param_tree())]


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _close_all(got, want, tol, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, tol, f"{what}, leaf {i}")


def _train_checks(ctx, data, label):
    from torch.distributed.tensor import DTensor
    from repro_torch import tree as T
    from repro_torch.convert import params_from_reference
    for case, ref in data.items():
        cfg = _port_cfg(case)
        what = f"{label} {case}"
        model = params_from_reference(ref["params"], cfg, ctx)
        loss, grads = _loss_and_grads(model, ref["batches"][0])
        _close(loss, ref["grads"][0], TOL, f"{what} loss")
        _close_all(grads, ref["grads"][1], TOL, f"{what} gradient")
        for mb, want in ref["steps"].items():
            model = params_from_reference(ref["params"], cfg, ctx)
            got = _port_steps(model, ref["batches"], mb)
            for i, name in enumerate(("loss", "grad norm")):
                _close(got[i], want[i], TOL, f"{what} mb {mb} {name}")
            for i, name in ((2, "params"), (3, "m"), (4, "v")):
                _close_all(got[i], want[i], TOL, f"{what} mb {mb} {name}")
            opt = got[5]
            for p, m in zip(T.leaves(model.param_tree()), T.leaves(opt["m"])):
                assert isinstance(m, DTensor) and \
                    m.placements == p.placements, f"{what}: m's layout"
            if mb == 1:
                _close(got[0], ref["jax_loss"], JAX_TOL, f"{what} JAX loss")
                _close(got[1], ref["jax_gnorm"], JAX_TOL,
                       f"{what} JAX grad norm")
                _close_all(got[2], ref["jax_params"], JAX_TOL,
                           f"{what} JAX params")


def _ckpt_argv(ckpt):
    return ["--arch", "qwen3-1.7b", "--smoke", "--steps", str(CKPT["steps"]),
            "--batch", str(B), "--seq", "16", "--ckpt-dir", str(ckpt),
            "--ckpt-every", str(CKPT["every"]), "--log-every", "100",
            "--device", "cpu"]


def _resume(ctx, data, workdir, into):
    """`train.run` resumed from the (2, 2) run's step-2 checkpoint, copied
    to `into` first (by rank 0), on `ctx` (None: unsharded): (records,
    whole parameters)."""
    from repro_torch import tree as T
    from repro_torch.convert import params_from_reference
    from repro_torch.launch import train
    src = workdir / "ckpt"
    if not dist.is_initialized() or dist.get_rank() == 0:
        shutil.copytree(src, into)
        shutil.rmtree(into / f"step_{CKPT['steps']:08d}")
    if dist.is_initialized():
        dist.barrier()
    model = params_from_reference(data[CKPT["case"]]["params"],
                                  _port_cfg(CKPT["case"]), ctx)
    recs = train.run(train.parse_args(_ckpt_argv(into)), model=model)
    return recs, [_whole(p) for p in T.leaves(model.param_tree())]


def _checkpoint_run(ctx, data, workdir):
    """On (2, 2): the uninterrupted run (saved to workdir/ckpt.pkl) and its
    resume from step 2, which must take step 3 bit for bit."""
    from repro_torch import tree as T
    from repro_torch.convert import params_from_reference
    from repro_torch.launch import train
    ckpt = workdir / "ckpt"
    model = params_from_reference(data[CKPT["case"]]["params"],
                                  _port_cfg(CKPT["case"]), ctx)
    whole = train.run(train.parse_args(_ckpt_argv(ckpt)), model=model)
    full = [_whole(p) for p in T.leaves(model.param_tree())]
    dist.barrier()                       # rank 0's last write has ended
    if dist.get_rank() == 0:
        with open(workdir / "ckpt.pkl", "wb") as f:
            pickle.dump(dict(records=whole, params=full), f)
    recs, params = _resume(ctx, data, workdir, workdir / "resume_2x2")
    assert [r["step"] for r in recs] == [CKPT["every"]]
    assert (recs[0]["loss"], recs[0]["grad_norm"]) == (
        whole[-1]["loss"], whole[-1]["grad_norm"]), "resumed step differs"
    for g, w in zip(params, full):
        assert np.array_equal(g, w), "resumed parameters differ"


def _cross_mesh_resume(ctx, data, workdir, label, into):
    with open(workdir / "ckpt.pkl", "rb") as f:
        want = pickle.load(f)
    recs, params = _resume(ctx, data, workdir, into)
    assert [r["step"] for r in recs] == [CKPT["every"]], label
    for key in ("loss", "grad_norm"):
        _close(recs[0][key], want["records"][-1][key], TOL,
               f"{label} resumed {key}")
    _close_all(params, want["params"], TOL, f"{label} resumed params")


def _rank_main(rank, world, store, workdir, shapes):
    """One gloo rank: the train checks on every mesh of `shapes`; (2, 2)
    writes the checkpoint, (1, 2) resumes from it."""
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
            _train_checks(ctx, data, f"mesh {shape}")
            if shape == (2, 2):
                _checkpoint_run(ctx, data, workdir)
            if shape == (1, 2) and (workdir / "ckpt.pkl").exists():
                _cross_mesh_resume(ctx, data, workdir, "mesh (1, 2)",
                                   workdir / "resume_1x2")
    finally:
        dist.destroy_process_group()


def _spawn(*groups):
    """Run `_rank_main` on each group's spawned ranks, the groups at once
    (a group: (world, workdir, mesh shapes)); fail (and terminate them
    all) if they have not finished within DEADLINE_S."""
    ctxs = [mp.start_processes(
        _rank_main, args=(world, str(workdir / f"store{world}_{i}"),
                          str(workdir), shapes),
        nprocs=world, join=False, start_method="spawn")
        for i, (world, workdir, shapes) in enumerate(groups)]
    end = time.monotonic() + DEADLINE_S
    try:
        for ctx in ctxs:
            while not ctx.join(timeout=1):
                if time.monotonic() > end:
                    pytest.fail(f"gloo ranks did not finish within "
                                f"{DEADLINE_S} s")
    finally:
        for ctx in ctxs:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(5)


def test_sharded_train_on_four_ranks(workdir):
    """Mesh (2, 2): the train checks, and the checkpointed run with its
    resume on the same mesh; at the same time mesh (2, 1) on 2 ranks."""
    _spawn((4, workdir, [(2, 2)]), (2, workdir, [(2, 1)]))


def test_sharded_train_on_two_ranks(workdir):
    """Mesh (1, 2), which resumes the (2, 2) checkpoint."""
    if not (workdir / "ckpt.pkl").exists():
        _spawn((4, workdir, [(2, 2)]))
    _spawn((2, workdir, [(1, 2)]))


def test_sharded_checkpoint_resumes_unsharded(workdir):
    """The (2, 2) run's step-2 checkpoint resumed by the unsharded model."""
    if not (workdir / "ckpt.pkl").exists():
        _spawn((4, workdir, [(2, 2)]))
    with open(workdir / "reference.pkl", "rb") as f:
        data = pickle.load(f)
    _cross_mesh_resume(None, data, workdir, "unsharded",
                       workdir / "resume_unsharded")
