"""The port's decoder models on the CPU, held against the JAX package's
`Model` on the smoke configs of qwen3-1.7b, gemma3-1b (5 local : 1
global sliding-window layers; its SMOKE: hd 32, window 8, a global layer
every 3), the other dense GQA decoders starcoder2-3b and chameleon-34b,
and mamba2-1.3b: both models run the JAX package's
`Model.init(PRNGKey(0))` parameters (carried over by
`convert.params_from_reference`) on the same numpy-seeded tokens, and
their logits and decode caches agree.

Tolerances: 1e-4 at float32 compute (the two frameworks sum in other
orders; the logits are O(1)), and atol = rtol = 0.08 at bfloat16, as
tests/test_models.py and tests/test_integration.py hold the JAX package's
own kernel and decode paths."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel, unbox  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402
from repro_torch.models import DecodeDims, Model  # noqa: E402

ARCHS = ["qwen3-1.7b", "gemma3-1b", "starcoder2-3b", "chameleon-34b",
         "mamba2-1.3b"]
COMPUTE = {"float32": (jnp.float32, torch.float32, 1e-4),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.08)}
N_DECODE = 4


@pytest.fixture(scope="module")
def reference_params():
    """JAX parameters of each smoke config, as jax arrays and numpy."""
    out = {}
    for arch in ARCHS:
        params, _ = unbox(JaxModel(jax_get_config(arch, smoke=True)).init(
            jax.random.PRNGKey(0)))
        out[arch] = (params, jax.tree.map(np.asarray, params))
    return out


def _pair(arch, reference_params, **overrides):
    """(JAX model, its params, port model) on the same parameters."""
    jax_cfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                                  **overrides.pop("jax", {}))
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              **overrides.pop("port", {}))
    params, np_params = reference_params[arch]
    return JaxModel(jax_cfg), params, params_from_reference(np_params, cfg)


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t)) \
        .astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _caches_close(got, want, cfg, tol):
    """The port's per-layer caches against the JAX package's stacked ones:
    layer rep * len(pattern) + slot holds repetition rep of slot's leaves
    (then the tail), leaf for leaf in the same nesting."""
    pat, n_rep, _ = cfg.pattern()
    for i, layer in enumerate(got):
        rep, slot = divmod(i, len(pat))
        if rep < n_rep:
            ref = [leaf[rep] for leaf in jax.tree.leaves(want["blocks"][slot])]
        else:
            ref = jax.tree.leaves(want["tail"][i - n_rep * len(pat)])
        mine = jax.tree.leaves(layer, is_leaf=lambda x: isinstance(
            x, torch.Tensor))
        assert len(mine) == len(ref), i
        for a, b in zip(mine, ref):
            assert tuple(a.shape) == tuple(b.shape), i
            _close(a, b, tol)


@pytest.mark.parametrize("compute", list(COMPUTE))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, compute,
                                                reference_params):
    jdt, tdt, tol = COMPUTE[compute]
    jm, params, tm = _pair(arch, reference_params,
                           jax={"compute_dtype": jdt},
                           port={"compute_dtype": tdt})
    toks = _tokens(jm.cfg, 2, 16)
    batch = {"tokens": jnp.asarray(toks)}
    t_toks = torch.from_numpy(toks).long()
    want, _ = jax.jit(jm.logits_fn)(params, batch)
    _close(tm.logits_fn(t_toks), want, tol)

    want, j_caches = jax.jit(jm.prefill)(params, batch)
    got, t_caches = tm.prefill(t_toks)
    assert tuple(got.shape) == (2, jm.cfg.vocab)
    _close(got, want, tol)
    _caches_close(t_caches, j_caches, tm.cfg, tol)

    decode = jax.jit(jm.decode_step)
    tok = toks[:, -1:]
    for i in range(N_DECODE):
        want, j_caches = decode(params, j_caches, jnp.asarray(tok),
                                jnp.int32(16 + i))
        got, t_caches = tm.decode_step(t_caches, torch.from_numpy(tok).long(),
                                       16 + i)
        assert tuple(got.shape) == (2, 1, jm.cfg.vocab)
        _close(got, want, tol)
        tok = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)[:, None]
    _caches_close(t_caches, j_caches, tm.cfg, tol)


def test_flash_flag_matches_reference_dense(reference_params):
    """use_flash_kernel=True (T = 128, the dispatch minimum) in the port
    against the JAX package's dense path, as test_integration.py does."""
    jm, params, tm = _pair("qwen3-1.7b", reference_params,
                           port={"use_flash_kernel": True})
    toks = _tokens(jm.cfg, 1, 128)
    want, _ = jax.jit(jm.logits_fn)(params, {"tokens": jnp.asarray(toks)})
    before = fops.flash_attention.launches
    got = tm.logits_fn(torch.from_numpy(toks).long())
    assert fops.flash_attention.launches == before   # CPU: plain version
    _close(got, want, 0.08)


def test_ssd_flag_matches_reference_kernel(reference_params):
    """use_ssd_kernel=True, ssm_chunk=8 in both: the port's wrapper (CPU:
    the plain version) against the Pallas kernel in interpret mode."""
    flags = {"use_ssd_kernel": True, "ssm_chunk": 8}
    jm, params, tm = _pair("mamba2-1.3b", reference_params, jax=dict(flags),
                           port=dict(flags))
    toks = _tokens(jm.cfg, 2, 16, seed=1)
    want, _ = jax.jit(jm.logits_fn)(params, {"tokens": jnp.asarray(toks)})
    before = sops.ssd_scan.launches
    got = tm.logits_fn(torch.from_numpy(toks).long())
    assert sops.ssd_scan.launches == before
    _close(got, want, 0.05)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """prefill(t[:-1]) + decode(t[-1]) == the full forward's last logits,
    with each attention cache ring widened by one slot."""
    cfg = get_config(arch, smoke=True)
    model = Model(cfg).init(torch.Generator().manual_seed(0))
    b, t = 2, 17
    toks = torch.from_numpy(_tokens(cfg, b, t)).long()
    full = model.logits_fn(toks)
    _, caches = model.prefill(toks[:, :t - 1])
    widened = model.init_cache(DecodeDims(batch=b, seq=t))
    for spec, c, w in zip(model.specs, caches, widened):
        if spec["kind"] == "attn":
            for src, dst in zip(c[0], w[0]):
                dst[:, :t - 1] = src
        else:
            for src, dst in zip(c, w):
                dst.copy_(src)
    got, _ = model.decode_step(widened, toks[:, t - 1:], t - 1)
    np.testing.assert_allclose(got[:, 0].float().numpy(),
                               full[:, -1].float().numpy(),
                               rtol=0.08, atol=0.08)


def test_serving_copy_follows_the_compute_dtype():
    """The cached compute-dtype copy is rebuilt when the config's compute
    dtype changes, so the same model answers as a fresh one would."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    toks = torch.from_numpy(_tokens(cfg, 1, 8)).long()
    model = Model(cfg).init(torch.Generator().manual_seed(0))
    bf16 = model.logits_fn(toks)
    model.cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    f32 = model.logits_fn(toks)
    fresh = Model(model.cfg).init(torch.Generator().manual_seed(0))
    assert bf16.dtype == torch.bfloat16 and f32.dtype == torch.float32
    assert torch.equal(f32, fresh.logits_fn(toks))


def test_params_from_reference_rejects_bad_trees(reference_params):
    cfg = get_config("qwen3-1.7b", smoke=True)
    _, np_params = reference_params["qwen3-1.7b"]
    missing = dict(np_params, blocks=[dict(np_params["blocks"][0])])
    del missing["blocks"][0]["ln2"]
    with pytest.raises(ValueError, match="missing leaves.*ln2"):
        params_from_reference(missing, cfg)
    extra = dict(np_params, enc_norm={"w": np.ones(cfg.d_model, np.float32)})
    with pytest.raises(ValueError, match="unknown leaves.*enc_norm"):
        params_from_reference(extra, cfg)
    shaped = dict(np_params, embed=np_params["embed"][:10])
    with pytest.raises(ValueError, match="embed: shape"):
        params_from_reference(shaped, cfg)


def test_unported_archs_and_layers_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        Model(get_config("minicpm3-4b"))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        Model(get_config("seamless-m4t-medium"))
    moe = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              n_experts=4, top_k=2)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        Model(moe)
    with pytest.raises(RuntimeError, match="init"):
        Model(get_config("qwen3-1.7b", smoke=True)).logits_fn(
            torch.zeros((1, 4), dtype=torch.long))


@pytest.mark.parametrize("arch", ARCHS)
def test_layers_in_true_order(arch, reference_params):
    """Layer i of the port holds slot i % len(pattern) of repetition
    i // len(pattern) of the JAX package's stacked blocks."""
    cfg = get_config(arch, smoke=True)
    _, np_params = reference_params[arch]
    model = params_from_reference(np_params, cfg)
    pat, n_rep, _ = cfg.pattern()
    group = "attn" if pat[0]["kind"] == "attn" else "ssm"
    name = "wq" if group == "attn" else "in_x"
    for i, layer in enumerate(model.layers):
        rep, slot = divmod(i, len(pat))
        np.testing.assert_array_equal(
            layer[group][name].detach().numpy(),
            np_params["blocks"][slot][group][name][rep])
