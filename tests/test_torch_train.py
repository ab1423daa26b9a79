"""The port's training path on the CPU, held against the JAX package's on
the smoke configs of qwen3-1.7b, gemma3-1b, starcoder2-3b, chameleon-34b
and mamba2-1.3b: both run the JAX package's `Model.init(PRNGKey(0))`
parameters (carried over by `convert.params_from_reference`) through
their train steps (`launch.steps.make_train_step`: mixed-precision cast,
value and grad, microbatch accumulation, warmup-cosine, AdamW) on the
same `SyntheticLMData` batches, and their losses, grad norms and updated
parameters agree.

Tolerances, as tests/test_torch_models.py holds the forward: 1e-4 at
float32 compute (loss, grad norm, parameters; the two frameworks sum in
other orders), and 0.08 on the loss at bfloat16 (the gradients of two
bf16 evaluations differ by their roundings).  Remat modes are one
function: their values are held to each other at 1e-6."""
import dataclasses
import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import SyntheticLMData  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import Model as JaxModel, unbox  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_core  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import DecodeDims, Model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen3-1.7b", "gemma3-1b", "starcoder2-3b", "chameleon-34b",
         "mamba2-1.3b"]
COMPUTE = {"float32": (jnp.float32, torch.float32, 1e-4),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.08)}
SCHEDULE = dict(total_steps=50, warmup_steps=2)
B, SEQ, N_STEPS = 2, 16, 3


@pytest.fixture(scope="module")
def reference_params():
    """JAX parameters of each smoke config, as jax arrays."""
    return {arch: unbox(JaxModel(jax_get_config(arch, smoke=True)).init(
        jax.random.PRNGKey(0)))[0] for arch in ARCHS}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, compute, **overrides):
    jdt, tdt, _ = COMPUTE[compute]
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               compute_dtype=jdt, **overrides)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=tdt, **overrides)
    return jcfg, cfg


def _batches(cfg, n, b=B, t=SEQ):
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=t, global_batch=b,
                           seed=0)
    return [data.batch(i) for i in range(n)]


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _params_close(model, jax_params, cfg, tol):
    want = params_from_reference(_np(jax_params), cfg).state_dict()
    for name, got in model.state_dict().items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   rtol=tol, atol=tol, err_msg=name)


_TRAJECTORIES = {}


def _jax_trajectory(arch, compute, reference_params, microbatches=1):
    """(loss, grad norm, params) after each of N_STEPS JAX train steps,
    from the reference parameters (computed once per case)."""
    key = (arch, compute, microbatches)
    if key not in _TRAJECTORIES:
        jcfg, _ = _configs(arch, compute)
        step = jax.jit(JS.make_train_step(JaxModel(jcfg), JS.TrainConfig(
            microbatches=microbatches, **SCHEDULE)))
        params = reference_params[arch]
        opt = jax_adamw_init(params)
        out = []
        for batch in _batches(jcfg, N_STEPS):
            params, opt, met = step(params, opt, _jb(batch))
            out.append((float(met["loss"]), float(met["grad_norm"]), params))
        _TRAJECTORIES[key] = out
    return _TRAJECTORIES[key]


def _port_run(arch, compute, reference_params, n, microbatches=1,
              **overrides):
    _, cfg = _configs(arch, compute, **overrides)
    model = params_from_reference(_np(reference_params[arch]), cfg)
    step = S.make_train_step(model, S.TrainConfig(microbatches=microbatches,
                                                  **SCHEDULE))
    opt = adamw_init(model.param_tree())
    out = [tuple(float(x) for x in step(opt, _tb(batch)))
           for batch in _batches(cfg, n)]
    return model, opt, out


@pytest.mark.parametrize("n", [1, N_STEPS])
@pytest.mark.parametrize("compute", list(COMPUTE))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, compute, n, reference_params):
    tol = COMPUTE[compute][2]
    want = _jax_trajectory(arch, compute, reference_params)
    model, opt, got = _port_run(arch, compute, reference_params, n)
    assert int(opt["step"]) == n
    for (loss, gn), (jloss, jgn, _) in zip(got, want):
        assert loss == pytest.approx(jloss, abs=tol, rel=tol)
        if compute == "float32":
            assert gn == pytest.approx(jgn, abs=tol, rel=tol)
    if compute == "float32":
        _params_close(model, want[n - 1][2], model.cfg, tol)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
def test_microbatched_steps_match_reference(arch, reference_params):
    """microbatches=2 in both packages; and the port's accumulated step
    equals its whole-batch step up to the mean's rounding."""
    want = _jax_trajectory(arch, "float32", reference_params, microbatches=2)
    model, _, got = _port_run(arch, "float32", reference_params, N_STEPS,
                              microbatches=2)
    for (loss, gn), (jloss, jgn, _) in zip(got, want):
        assert loss == pytest.approx(jloss, abs=1e-4, rel=1e-4)
        assert gn == pytest.approx(jgn, abs=1e-4, rel=1e-4)
    _params_close(model, want[-1][2], model.cfg, 1e-4)
    _, _, whole = _port_run(arch, "float32", reference_params, 1)
    assert got[0][0] == pytest.approx(whole[0][0], rel=1e-5)
    assert got[0][1] == pytest.approx(whole[0][1], rel=1e-4)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-1b", "mamba2-1.3b"])
def test_remat_modes_give_the_same_values(arch, remat, reference_params):
    """Each remat mode equals the JAX package's step and the port's
    no-remat step: recomputation changes memory, not values."""
    want = _jax_trajectory(arch, "float32", reference_params)
    model, _, got = _port_run(arch, "float32", reference_params, 2,
                              remat=remat)
    base_model, _, base = _port_run(arch, "float32", reference_params, 2,
                                    remat="none")
    for (loss, gn), (bl, bg), (jloss, jgn, _) in zip(got, base, want):
        assert loss == pytest.approx(bl, rel=1e-6, abs=1e-6)
        assert gn == pytest.approx(bg, rel=1e-6, abs=1e-6)
        assert loss == pytest.approx(jloss, rel=1e-4, abs=1e-4)
    for (name, p), q in zip(model.state_dict().items(),
                            base_model.state_dict().values()):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


class _CountOps(TorchDispatchMode):
    """Counts each aten op that runs under it, the checkpoints'
    recomputation in the backward pass included."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
def test_remat_policies_recompute_what_they_say(arch, reference_params):
    """"full" runs every layer's products again in the backward pass;
    "dots" keeps the products without batch dims (`aten.mm`) and runs
    none of them again, but recomputes the batched ones (`aten.bmm`,
    the attention and SSD einsums) as "full" does."""
    counts = {}
    for remat in ("none", "dots", "full"):
        _, cfg = _configs(arch, "float32", remat=remat)
        model = params_from_reference(_np(reference_params[arch]), cfg)
        leaves = [p.detach().requires_grad_()
                  for p in T.leaves(model.param_tree())]
        with _CountOps() as mode:
            loss = model.loss_fn(T.unflatten(model.param_tree(), leaves),
                                 _tb(_batches(cfg, 1)[0]))
            torch.autograd.grad(loss, leaves)
        counts[remat] = mode.counts
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert counts["dots"][mm] == counts["none"][mm] < counts["full"][mm]
    assert counts["dots"].get(bmm, 0) == counts["full"].get(bmm, 0) \
        > counts["none"].get(bmm, 0)


def test_unknown_remat_mode_raises(reference_params):
    with pytest.raises(ValueError, match="remat"):
        _port_run("qwen3-1.7b", "float32", reference_params, 1,
                  remat="everything")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
def test_jax_step_then_port_step(arch, reference_params):
    """JAX takes step 1; its parameters and AdamW state move to the port
    (`opt_state_from_reference`), which takes step 2 as JAX does."""
    want = _jax_trajectory(arch, "float32", reference_params)
    jcfg, cfg = _configs(arch, "float32")
    jstep = jax.jit(JS.make_train_step(JaxModel(jcfg),
                                       JS.TrainConfig(**SCHEDULE)))
    batches = _batches(cfg, 2)
    params, opt, _ = jstep(reference_params[arch],
                           jax_adamw_init(reference_params[arch]),
                           _jb(batches[0]))
    model = params_from_reference(_np(params), cfg)
    state = opt_state_from_reference(_np(opt), cfg)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
    assert len(T.leaves(state["m"])) == len(T.leaves(model.param_tree()))
    loss, gn = S.make_train_step(model, S.TrainConfig(**SCHEDULE))(
        state, _tb(batches[1]))
    assert float(loss) == pytest.approx(want[1][0], abs=1e-4, rel=1e-4)
    assert float(gn) == pytest.approx(want[1][1], abs=1e-4, rel=1e-4)
    _params_close(model, want[1][2], cfg, 1e-4)


def test_opt_state_from_reference_rejects_bad_trees(reference_params):
    _, cfg = _configs("qwen3-1.7b", "float32")
    opt = _np(jax_adamw_init(reference_params["qwen3-1.7b"]))
    bad = dict(opt._asdict(), v=dict(opt.v, embed=opt.v["embed"][:3]))
    with pytest.raises(ValueError, match="embed: shape"):
        opt_state_from_reference(bad, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_gets_a_gradient(arch, reference_params):
    """Differentiating `loss_fn` at the compute-dtype casts reaches every
    parameter (a detached copy would give zeros without an error)."""
    _, cfg = _configs(arch, "bfloat16")
    model = params_from_reference(_np(reference_params[arch]), cfg)
    leaves = [p.detach().to(cfg.compute_dtype).requires_grad_()
              for p in T.leaves(model.param_tree())]
    loss = model.loss_fn(T.unflatten(model.param_tree(), leaves),
                         _tb(_batches(cfg, 1)[0]))
    grads = torch.autograd.grad(loss, leaves)
    names = [T.keystr(p) for p, _ in T.leaves_with_paths(model.param_tree())]
    for name, g in zip(names, grads):
        assert g.dtype == cfg.compute_dtype and bool(g.abs().sum() > 0), name


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch, reference_params):
    """The loss at the masters, with a label masked out (< 0)."""
    jcfg, cfg = _configs(arch, "float32")
    batch = _batches(cfg, 1)[0]
    batch["labels"][0, :3] = -1
    want = JaxModel(jcfg).loss_fn(reference_params[arch], _jb(batch))
    model = params_from_reference(_np(reference_params[arch]), cfg)
    got = model.loss_fn(model.param_tree(), _tb(batch))
    assert got.requires_grad
    assert float(got.detach()) == pytest.approx(float(want), abs=1e-4,
                                                rel=1e-4)


def test_training_leaves_the_serving_copy_fresh(reference_params):
    """Serving after a train step answers with the updated parameters."""
    _, cfg = _configs("qwen3-1.7b", "bfloat16")
    model = params_from_reference(_np(reference_params["qwen3-1.7b"]), cfg)
    toks = torch.from_numpy(_batches(cfg, 1)[0]["tokens"]).long()
    before = model.logits_fn(toks)
    S.make_train_step(model, S.TrainConfig(**SCHEDULE))(
        adamw_init(model.param_tree()), _tb(_batches(cfg, 1)[0]))
    after = model.logits_fn(toks)
    again = type(model)(cfg).init(torch.Generator().manual_seed(1))
    again.load_state_dict(model.state_dict())
    assert not torch.equal(after, before)
    assert torch.equal(after, again.logits_fn(toks))


def test_loss_decreases():
    """tests/test_models.py::test_loss_decreases on the port: 12 steps on
    one batch, warm-up 2, the loss falls by more than 0.5."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    model = train.build_model(train.parse_args(
        ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu"]))
    step = S.make_train_step(model, S.TrainConfig(total_steps=50,
                                                  warmup_steps=2))
    opt = adamw_init(model.param_tree())
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (4, 33)).astype(np.int32)
    batch = _tb({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    losses = [float(step(opt, batch)[0]) for _ in range(12)]
    assert losses[-1] < losses[0] - 0.5, losses


@pytest.mark.parametrize("arch,flag,t", [("qwen3-1.7b", "use_flash_kernel",
                                          128),
                                         ("mamba2-1.3b", "use_ssd_kernel",
                                          256)])
def test_kernel_flags_refuse_training(arch, flag, t, reference_params):
    """With a kernel flag set, the differentiable forward raises where it
    reaches the kernel (it has no backward); serving still runs."""
    _, cfg = _configs(arch, "float32", **{flag: True})
    if flag == "use_ssd_kernel":
        cfg = dataclasses.replace(cfg, ssm_chunk=t)
    model = params_from_reference(_np(reference_params[arch]), cfg)
    batch = _tb(_batches(cfg, 1, b=1, t=t)[0])
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss_fn(model.param_tree(), batch)
    assert model.logits_fn(batch["tokens"].long()).shape == (1, t, cfg.vocab)


def test_ssd_chunked_core_gradcheck():
    """The plain SSD core is differentiable (no in-place write on a saved
    tensor), and its gradient stays finite where exp(seg) above the
    chunk's diagonal overflows."""
    rng = np.random.default_rng(0)
    b, t, h, p, n, chunk = 1, 8, 2, 3, 2, 4
    f64 = dict(dtype=torch.float64)
    args = (torch.tensor(rng.normal(0, 1, (b, t, h, p)), **f64),
            torch.tensor(rng.uniform(0.05, 0.9, (b, t, h)), **f64),
            torch.tensor(-rng.uniform(0.3, 2.0, (h,)), **f64),
            torch.tensor(rng.normal(0, 1, (b, t, n)), **f64),
            torch.tensor(rng.normal(0, 1, (b, t, n)), **f64))
    args = tuple(a.requires_grad_() for a in args)
    assert torch.autograd.gradcheck(
        lambda *a: ssd_chunked_core(*a, chunk), args)
    strong = [a.detach().float().requires_grad_() for a in args]
    with torch.no_grad():
        strong[1].fill_(200.0)                 # exp(+seg) overflows float32
    y, s = ssd_chunked_core(*strong, chunk)
    grads = torch.autograd.grad((y.sum() + s.sum()), strong)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_prefill_and_decode_steps_wrap_the_model(reference_params):
    _, cfg = _configs("qwen3-1.7b", "float32")
    model = params_from_reference(_np(reference_params["qwen3-1.7b"]), cfg)
    toks = torch.from_numpy(_batches(cfg, 1)[0]["tokens"]).long()
    logits, caches = S.make_prefill_step(model)({"tokens": toks})
    want, _ = model.prefill(toks)
    assert torch.equal(logits, want)
    widened = model.init_cache(DecodeDims(batch=B, seq=SEQ + 1))
    for c, w in zip(caches, widened):
        for src, dst in zip(c[0], w[0]):
            dst[:, :SEQ] = src
    out, _ = S.make_decode_step(model)(widened, toks[:, -1:], SEQ)
    assert out.shape == (B, 1, cfg.vocab)


def _driver(ck, steps, every, *extra):
    return train.run(train.parse_args(
        ["--arch", "qwen3-1.7b", "--smoke", "--steps", str(steps),
         "--batch", "4", "--seq", "32", "--ckpt-dir", ck, "--ckpt-every",
         str(every), "--log-every", "100", "--device", "cpu", *extra]))


def test_train_driver_end_to_end(tmp_path):
    """tests/test_integration.py's driver test: train, checkpoint, resume."""
    ck = str(tmp_path / "ck")
    losses = train.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "8",
                         "--batch", "4", "--seq", "32", "--ckpt-dir", ck,
                         "--ckpt-every", "4", "--log-every", "100",
                         "--device", "cpu"])
    assert len(losses) == 8
    assert sorted(os.listdir(ck)) == ["heartbeat.json", "step_00000004",
                                      "step_00000008"]
    losses2 = train.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "12",
                          "--batch", "4", "--seq", "32", "--ckpt-dir", ck,
                          "--ckpt-every", "100", "--log-every", "100",
                          "--device", "cpu"])
    assert len(losses2) == 4            # resumed at step 8
    assert all(np.isfinite(losses + losses2))


@pytest.mark.parametrize("microbatches", ["1", "2"])
def test_resumed_run_equals_uninterrupted(tmp_path, microbatches):
    """A run stopped after its step-4 checkpoint and resumed in a fresh
    model and optimizer takes exactly the steps of the uninterrupted run:
    a checkpoint named step N holds the state after N updates."""
    ck = str(tmp_path / "ck")
    full = _driver(ck, 8, 4, "--microbatches", microbatches)
    last = train.restore_checkpoint(
        ck, 8, {"params": train.build_model(train.parse_args(
            ["--smoke", "--device", "cpu"])).param_tree()})
    shutil.rmtree(os.path.join(ck, "step_00000008"))
    resumed = _driver(ck, 8, 4, "--microbatches", microbatches)
    assert [r["step"] for r in resumed] == [4, 5, 6, 7]
    for a, b in zip(full[4:], resumed):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
    again = train.restore_checkpoint(ck, 8, last)
    for a, b in zip(T.leaves(last), T.leaves(again)):
        assert torch.equal(a, b)


def test_train_driver_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "1"])


# ---------------------------------------------------------------------
# chip_smoke.py's training parity table (tools/smoke_reference.py train)
# ---------------------------------------------------------------------

def _smoke_modules():
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    try:
        import chip_smoke
        import smoke_reference
    finally:
        del sys.path[:2]
    return chip_smoke, smoke_reference


def test_smoke_reference_train_table_is_the_committed_one():
    chip_smoke, smoke_reference = _smoke_modules()
    got = smoke_reference.train()
    want = chip_smoke.REFERENCE_TRAIN
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-6, abs=1e-6), key


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_parity_run_on_the_cpu(microbatches):
    """chip_smoke.py's `train_parity` on the CPU: the port's driver loop
    from `train_smoke_params` equals REFERENCE_TRAIN within TRAIN_TOL."""
    chip_smoke, _ = _smoke_modules()
    ts = chip_smoke.TRAIN_SMOKE
    cfg = dataclasses.replace(get_config(chip_smoke.TRAIN_ARCH, smoke=True),
                              compute_dtype=torch.float32)
    model = chip_smoke.train_smoke_model(torch, Model, cfg, "cpu")
    records = train.run(train.parse_args(
        ["--smoke", "--steps", str(ts["steps"]), "--batch", str(ts["batch"]),
         "--seq", str(ts["seq"]), "--seed", str(ts["seed"]),
         "--microbatches", str(microbatches), "--device", "cpu"]),
        model=model)
    suffix = "" if microbatches == 1 else "_mb2"
    for key in ("loss", "grad_norm"):
        assert [r[key] for r in records] == pytest.approx(
            chip_smoke.REFERENCE_TRAIN[key + suffix],
            rel=chip_smoke.TRAIN_TOL, abs=chip_smoke.TRAIN_TOL)
