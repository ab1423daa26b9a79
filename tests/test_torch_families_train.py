"""The port's training path for the MLA, MoE, hybrid and encoder-decoder
families on the CPU, held against the JAX package's on the smoke configs
of minicpm3-4b, seamless-m4t-medium, qwen3-moe-235b-a22b, grok-1-314b
(virtual-split experts) and jamba-v0.1-52b: both run the JAX package's
`Model.init(PRNGKey(0))` parameters through `loss_fn` (the MoE aux term
included) and their gradients, through one and three train steps of
`SyntheticLMData` batches (an encoder-decoder's frames drawn per step as
both drivers draw them), and across the packages: a JAX step handed to
the port, and checkpoints written by one package and read by the other.

Tolerances, as tests/test_torch_train.py: 1e-4 at float32 compute (loss,
grad norm, every gradient and updated parameter); bfloat16 compute is
held to the reference in the forward (tests/test_torch_families.py, 0.08)
and here by every leaf's gradient being nonzero.

jamba's SSD core in the JAX package computes exp(seg) above each chunk's
diagonal before it selects it away: after one update of the smoke config
that exp overflows, and the reference's gradient is NaN from step 2 on
(ROADMAP Queue 3, a reference caveat).  The port masks before the exp.
Its trajectories are therefore held to the reference's step with that
one line changed (`_masked_ssd_core`, the same forward values), and a
test shows the unchanged reference's NaN beside the port's finite
step."""
import dataclasses
import os
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import SyntheticLMData  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models import Model as JaxModel, unbox  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import (restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference, reference_tree)
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

FAMILIES = ["minicpm3-4b", "seamless-m4t-medium", "qwen3-moe-235b-a22b",
            "grok-1-314b", "jamba-v0.1-52b"]
COMPUTE = {"float32": (jnp.float32, torch.float32, 1e-4),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.08)}
SCHEDULE = dict(total_steps=50, warmup_steps=2)
B, SEQ, N_STEPS = 2, 16, 3


@pytest.fixture(scope="module")
def reference_params():
    return {arch: unbox(jax.jit(JaxModel(jax_get_config(
        arch, smoke=True)).init)(jax.random.PRNGKey(0)))[0]
        for arch in FAMILIES}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, compute):
    jdt, tdt, _ = COMPUTE[compute]
    return (dataclasses.replace(jax_get_config(arch, smoke=True),
                                compute_dtype=jdt),
            dataclasses.replace(get_config(arch, smoke=True),
                                compute_dtype=tdt))


def _batches(cfg, n, b=B, t=SEQ):
    """The driver's batches of steps 0..n-1, with its frames for an
    encoder-decoder (`launch.train.frames`: a generator seeded by the
    step, as `repro.launch.train` draws them)."""
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=t, global_batch=b,
                           seed=0)
    out = []
    for i in range(n):
        batch = dict(data.batch(i))
        if cfg.arch_kind == "encdec":
            batch["frames"] = np.asarray(np.random.default_rng(i).normal(
                0, 0.02, (b, t, cfg.d_model)), np.float32)
        out.append(batch)
    return out


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _params_close(model, jax_params, cfg, tol):
    want = params_from_reference(_np(jax_params), cfg).state_dict()
    for name, got in model.state_dict().items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   rtol=tol, atol=tol, err_msg=name)


def _masked_ssd_core(x, dt, a, b_mat, c_mat, chunk, initial_state=None):
    """`repro.models.ssm.ssd_chunked_core` with exp(seg) masked before the
    exp (as the port's core does): the same values, and a finite gradient
    where exp(seg) above the diagonal overflows."""
    bsz, t, h, p = x.shape
    n, q = b_mat.shape[-1], chunk
    nc = t // q
    xr = x.reshape(bsz, nc, q, h, p)
    dtr = dt.reshape(bsz, nc, q, h)
    br = b_mat.reshape(bsz, nc, q, n)
    cr = c_mat.reshape(bsz, nc, q, n)
    cum = jnp.cumsum(dtr * a[None, None, None, :], axis=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = jnp.tril(jnp.ones((q, q), bool))[None, None, :, :, None]
    l_mat = jnp.exp(jnp.where(tri, seg, -jnp.inf))
    cb = jnp.einsum("bcqn,bckn->bcqk", cr, br,
                    preferred_element_type=jnp.float32)
    y_diag = jnp.einsum("bcqk,bcqkh,bckhp->bcqhp", cb, l_mat,
                        (xr * dtr[..., None]).astype(jnp.float32))
    decay_tail = jnp.exp(cum[:, :, -1:, :] - cum)
    states = jnp.einsum("bckn,bckh,bckhp->bchnp", br.astype(jnp.float32),
                        (decay_tail * dtr).astype(jnp.float32),
                        xr.astype(jnp.float32))
    s0 = (jnp.zeros((bsz, h, n, p), jnp.float32) if initial_state is None
          else initial_state.astype(jnp.float32))

    def scan_fn(s_prev, inp):
        st, dec = inp
        return s_prev * dec[:, :, None, None] + st, s_prev

    s_final, s_in = jax.lax.scan(scan_fn, s0, (
        jnp.moveaxis(states, 1, 0),
        jnp.moveaxis(jnp.exp(cum[:, :, -1, :]), 1, 0)))
    y_inter = jnp.einsum("bcqn,bchnp->bcqhp", cr.astype(jnp.float32),
                         jnp.moveaxis(s_in, 0, 1)) * jnp.exp(cum)[..., None]
    return (y_diag + y_inter).reshape(bsz, t, h, p).astype(x.dtype), s_final


_TRAJECTORIES = {}


def _jax_trajectory(arch, compute, reference_params, masked=True):
    """(loss, grad norm, params, AdamW state) after each of N_STEPS JAX
    train steps; `masked`: with `_masked_ssd_core` in the reference."""
    key = (arch, compute, masked)
    if key not in _TRAJECTORIES:
        jcfg, _ = _configs(arch, compute)
        step = jax.jit(JS.make_train_step(JaxModel(jcfg),
                                          JS.TrainConfig(**SCHEDULE)))
        params = reference_params[arch]
        opt = jax_adamw_init(params)
        out = []
        with mock.patch.object(JSSM, "ssd_chunked_core", _masked_ssd_core
                               if masked else JSSM.ssd_chunked_core):
            for batch in _batches(jcfg, N_STEPS):
                params, opt, met = step(params, opt, _jb(batch))
                out.append((float(met["loss"]), float(met["grad_norm"]),
                            params, opt))
        _TRAJECTORIES[key] = out
    return _TRAJECTORIES[key]


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_match_reference(arch, reference_params):
    """`loss_fn` (with 0.01 * aux) and its gradient in every leaf, at the
    float32 masters, against `jax.value_and_grad` of the reference's."""
    jcfg, cfg = _configs(arch, "float32")
    batch = _batches(cfg, 1)[0]
    batch["labels"][0, :3] = -1
    want, jgrads = jax.jit(jax.value_and_grad(JaxModel(jcfg).loss_fn))(
        reference_params[arch], _jb(batch))
    model = params_from_reference(_np(reference_params[arch]), cfg)
    leaves = [p.detach().requires_grad_()
              for p in T.leaves(model.param_tree())]
    loss = model.loss_fn(T.unflatten(model.param_tree(), leaves), _tb(batch))
    assert float(loss.detach()) == pytest.approx(float(want), abs=1e-4,
                                                 rel=1e-4)
    grads = torch.autograd.grad(loss, leaves)
    ref = params_from_reference(_np(jgrads), cfg)
    names = [T.keystr(p) for p, _ in T.leaves_with_paths(model.param_tree())]
    for name, g, w in zip(names, grads, T.leaves(ref.param_tree())):
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_steps_match_reference(arch, reference_params):
    """One and three float32 steps: each step's loss and grad norm, and
    the parameters after step 1 and step 3."""
    want = _jax_trajectory(arch, "float32", reference_params)
    _, cfg = _configs(arch, "float32")
    model = params_from_reference(_np(reference_params[arch]), cfg)
    step = S.make_train_step(model, S.TrainConfig(**SCHEDULE))
    opt = adamw_init(model.param_tree())
    for i, batch in enumerate(_batches(cfg, N_STEPS)):
        loss, gn = (float(x) for x in step(opt, _tb(batch)))
        jloss, jgn = want[i][:2]
        assert loss == pytest.approx(jloss, abs=1e-4, rel=1e-4), i
        assert gn == pytest.approx(jgn, abs=1e-4, rel=1e-4), i
        if i in (0, N_STEPS - 1):
            _params_close(model, want[i][2], cfg, 1e-4)
    assert int(opt["step"]) == N_STEPS


def test_reference_gradient_is_nan_where_the_port_masks(reference_params):
    """The caveat above: the unchanged reference's jamba step 2 has a NaN
    gradient norm, the masked reference's and the port's are finite and
    equal, and step 1 is the same in all three."""
    raw = _jax_trajectory("jamba-v0.1-52b", "float32", reference_params,
                          masked=False)
    fixed = _jax_trajectory("jamba-v0.1-52b", "float32", reference_params)
    assert np.isnan(raw[1][1]) and np.isfinite(fixed[1][1])
    assert raw[0][:2] == fixed[0][:2]
    _, cfg = _configs("jamba-v0.1-52b", "float32")
    model = params_from_reference(_np(reference_params["jamba-v0.1-52b"]),
                                  cfg)
    step = S.make_train_step(model, S.TrainConfig(**SCHEDULE))
    opt = adamw_init(model.param_tree())
    for i, batch in enumerate(_batches(cfg, 2)):
        _, gn = step(opt, _tb(batch))
        assert float(gn) == pytest.approx(fixed[i][1], abs=1e-4, rel=1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_jax_step_then_port_step(arch, reference_params):
    """JAX takes step 1; its parameters and AdamW state move to the port,
    which takes step 2 as JAX does."""
    want = _jax_trajectory(arch, "float32", reference_params)
    _, cfg = _configs(arch, "float32")
    model = params_from_reference(_np(want[0][2]), cfg)
    state = opt_state_from_reference(_np(want[0][3]), cfg)
    loss, gn = S.make_train_step(model, S.TrainConfig(**SCHEDULE))(
        state, _tb(_batches(cfg, 2)[1]))
    assert float(loss) == pytest.approx(want[1][0], abs=1e-4, rel=1e-4)
    assert float(gn) == pytest.approx(want[1][1], abs=1e-4, rel=1e-4)
    _params_close(model, want[1][2], cfg, 1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_leaf_gets_a_gradient(arch, reference_params):
    """Differentiating at the bf16 casts reaches every parameter: the
    router through the aux loss and the combine weights, the encoder
    through the cross attention."""
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


@pytest.mark.parametrize("remat", ["dots", "none"])
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "jamba-v0.1-52b"])
def test_remat_modes_give_the_same_values(arch, remat, reference_params):
    """aux and the encoder output pass through the checkpoints: each
    remat mode's loss and gradients equal "full"'s."""
    _, cfg = _configs(arch, "float32")
    out = {}
    for mode in ("full", remat):
        model = params_from_reference(_np(reference_params[arch]),
                                      dataclasses.replace(cfg, remat=mode))
        leaves = [p.detach().requires_grad_()
                  for p in T.leaves(model.param_tree())]
        loss = model.loss_fn(T.unflatten(model.param_tree(), leaves),
                             _tb(_batches(cfg, 1)[0]))
        out[mode] = [loss] + list(torch.autograd.grad(loss, leaves))
    for a, b in zip(out["full"], out[remat]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", FAMILIES)
def test_checkpoints_read_across_packages(arch, reference_params, tmp_path):
    """The port writes its parameters in the reference's layout
    (`convert.reference_tree`) and JAX restores them into its own tree;
    JAX writes its parameters and the port restores and converts them:
    every leaf arrives unchanged, under the same file names."""
    _, cfg = _configs(arch, "float32")
    jparams = reference_params[arch]
    model = params_from_reference(_np(jparams), cfg)
    mine = str(tmp_path / "port")
    save_checkpoint(mine, 1, {"params": reference_tree(model.param_tree(),
                                                       cfg)})
    got = jax_ckpt.restore_checkpoint(mine, 1, {"params": jparams})
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves({"params": jparams})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))
    ref = str(tmp_path / "jax")
    jax_ckpt.save_checkpoint(ref, 2, {"params": jparams})
    back = restore_checkpoint(ref, 2, {"params": reference_tree(
        model.param_tree(), cfg)})
    again = params_from_reference(T.tree_map(lambda t: t.numpy(),
                                             back["params"]), cfg)
    for name, t in again.state_dict().items():
        assert torch.equal(t, model.state_dict()[name]), name
    jax_ckpt.save_checkpoint(str(tmp_path / "jax1"), 1, {"params": jparams})
    assert sorted(os.listdir(os.path.join(mine, "step_00000001"))) == \
        sorted(os.listdir(str(tmp_path / "jax1" / "step_00000001")))


def test_train_driver_draws_the_reference_frames(reference_params):
    """The port's driver loop on seamless from the reference parameters:
    its per-step frames make each step's loss the JAX step's."""
    want = _jax_trajectory("seamless-m4t-medium", "float32",
                           reference_params)
    _, cfg = _configs("seamless-m4t-medium", "float32")
    model = params_from_reference(_np(reference_params[
        "seamless-m4t-medium"]), cfg)
    args = train.parse_args(["--arch", "seamless-m4t-medium", "--smoke",
                             "--steps", str(N_STEPS), "--batch", str(B),
                             "--seq", str(SEQ), "--device", "cpu",
                             "--log-every", "100"])
    # the driver's schedule is not SCHEDULE: the first loss (before any
    # update) is held to JAX's, and every step's frames to the reference's
    records = train.run(args, model=model)
    assert len(records) == N_STEPS
    assert records[0]["loss"] == pytest.approx(want[0][0], abs=1e-4,
                                               rel=1e-4)
    for i in range(N_STEPS):
        np.testing.assert_array_equal(
            train.frames(cfg, args, i).numpy(),
            _batches(cfg, N_STEPS)[i]["frames"])
