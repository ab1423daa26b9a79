"""The port's optimizer, LR schedule and data pipeline on the CPU, held
against the JAX package's: `SyntheticLMData` batches bit for bit for the
same (seed, step, n_hosts, host_index); `warmup_cosine` over a step
range and `adamw_update` / `clip_by_global_norm` on the same numpy
parameters, gradients and state within float32 rounding (1e-6: the same
formula in the same order, summed in other orders)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import SyntheticLMData as JaxData  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine  # noqa
from repro_torch import tree as T  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, clip_by_global_norm,
                               warmup_cosine)

TOL = 1e-6


@pytest.mark.parametrize("seed,n_hosts,host_index,vocab,seq,batch", [
    (0, 1, 0, 512, 32, 4),
    (3, 2, 1, 151936, 64, 4),
    (7, 4, 2, 97, 17, 8),
])
def test_data_batches_bitwise(seed, n_hosts, host_index, vocab, seq, batch):
    kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed,
              n_hosts=n_hosts, host_index=host_index)
    mine, ref = SyntheticLMData(**kw), JaxData(**kw)
    assert mine.host_batch == ref.host_batch == batch // n_hosts
    for step in (0, 1, 5, 123):
        got, want = mine.batch(step), ref.batch(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_data_rejects_uneven_host_split():
    with pytest.raises(AssertionError):
        SyntheticLMData(vocab=8, seq_len=4, global_batch=5, n_hosts=2)


@pytest.mark.parametrize("warmup,total,floor", [
    (100, 10000, 0.1), (5, 8, 0.1), (2, 50, 0.0), (0, 1, 0.5)])
def test_warmup_cosine_matches_reference(warmup, total, floor):
    steps = np.arange(0, total + 20, dtype=np.int32)
    want = np.asarray(jax_warmup_cosine(jnp.asarray(steps), warmup=warmup,
                                        total=total, floor=floor))
    got = warmup_cosine(torch.from_numpy(steps), warmup=warmup, total=total,
                        floor=floor)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert float(warmup_cosine(3, warmup=warmup, total=total,
                               floor=floor)) == pytest.approx(
        float(want[3]), rel=TOL, abs=TOL)


def _tree(rng, scale=1.0):
    """A parameter-shaped tree with nested dicts and a list."""
    return {"embed": rng.normal(0, scale, (16, 8)).astype(np.float32),
            "final_norm": {"w": rng.normal(1, scale, (8,)).astype(np.float32)},
            "layers": [{"attn": {"wq": rng.normal(0, scale, (8, 2, 4))
                                 .astype(np.float32)}},
                       {"mlp": {"wi": rng.normal(0, scale, (8, 12))
                                .astype(np.float32),
                                "wo": rng.normal(0, scale, (12, 8))
                                .astype(np.float32)}}]}


def _torch(tree, dtype=torch.float32):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def _close(got_tree, want_tree, tol=TOL):
    got, want = T.leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])   # under / over clip
def test_clip_by_global_norm_matches_reference(grad_scale):
    grads = _tree(np.random.default_rng(1), grad_scale)
    want, want_gn = jax_adamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads), 1.0)
    got, gn = clip_by_global_norm(_torch(grads), 1.0)
    assert gn.dtype == torch.float32
    assert float(gn) == pytest.approx(float(want_gn), rel=TOL)
    _close(got, want)


def test_adamw_init_is_zero_float32_state():
    params = _torch(_tree(np.random.default_rng(0)))
    state = adamw_init(params)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for m, v, p in zip(T.leaves(state["m"]), T.leaves(state["v"]),
                       T.leaves(params)):
        assert m.shape == v.shape == p.shape
        assert m.dtype == v.dtype == torch.float32
        assert not m.any() and not v.any() and m.data_ptr() != v.data_ptr()


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale,lr_scale,steps", [
    (1e-3, 1.0, 1), (10.0, 0.5, 3), (0.3, 0.01, 4)])
def test_adamw_update_matches_reference(grad_scale, lr_scale, steps,
                                        grad_dtype):
    """The same params and gradient sequence through both optimizers: the
    parameters, m, v, the step count and each step's grad norm."""
    rng = np.random.default_rng(2)
    params = _tree(rng)
    cfg = AdamWConfig(lr=1e-2)
    jcfg = jax_adamw.AdamWConfig(lr=1e-2)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[grad_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[grad_dtype]
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jax_adamw.adamw_init(jp)
    tp = _torch(params)
    tstate = adamw_init(tp)
    for _ in range(steps):
        grads = _tree(rng, grad_scale)
        jp, jstate, jgn = jax_adamw.adamw_update(
            jcfg, jp, jax.tree.map(lambda a: jnp.asarray(a, jdt), grads),
            jstate, jnp.float32(lr_scale))
        out, tstate, gn = adamw_update(cfg, tp, _torch(grads, tdt), tstate,
                                       torch.tensor(lr_scale))
        assert out is tp                          # updated in place
        assert float(gn) == pytest.approx(float(jgn), rel=TOL)
    assert int(tstate["step"]) == int(jstate.step) == steps
    _close(tp, jp)
    _close(tstate["m"], jstate.m)
    _close(tstate["v"], jstate.v)


def test_adamw_update_keeps_a_non_float32_leaf_dtype():
    """A bf16 parameter is updated in float32 and cast back, as the
    reference casts `p32` back to `p.dtype`."""
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(0, 1, (6,)).astype(np.float32)}
    grads = {"a": rng.normal(0, 1, (6,)).astype(np.float32)}
    jp = {"a": jnp.asarray(params["a"], jnp.bfloat16)}
    jp, _, _ = jax_adamw.adamw_update(jax_adamw.AdamWConfig(), jp,
                                      jax.tree.map(jnp.asarray, grads),
                                      jax_adamw.adamw_init(jp))
    tp = {"a": torch.from_numpy(params["a"]).to(torch.bfloat16)}
    adamw_update(AdamWConfig(), tp, _torch(grads), adamw_init(tp))
    assert tp["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["a"].float().numpy(),
                                  np.asarray(jp["a"], np.float32))


def test_global_norm_is_exact_on_a_large_leaf():
    """A vocab-sized leaf (10^7 elements here): the norm before clipping
    equals the float64 norm to float32 rounding (the CPU's float32 norm
    alone drifts by about 4e-4 at this size)."""
    g = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1e-3, 10**7).astype(np.float32))
    before = g.clone()
    clipped, gn = clip_by_global_norm({"embed": g, "w": g[:5]}, 1.0)
    want = float(torch.cat([g, g[:5]]).double().norm())
    assert float(gn) == pytest.approx(want, rel=1e-6)
    assert torch.equal(g, before)             # the input is not scaled
    assert float(clipped["embed"].double().norm()) == pytest.approx(
        1.0 * float(g.double().norm()) / want, rel=1e-5)
