"""The port's MLA, MoE, hybrid and encoder-decoder models on the CPU, held
against the JAX package's `Model` on the smoke configs of minicpm3-4b
(MLA), qwen3-moe-235b-a22b (MoE, qk-norm), grok-1-314b (MoE with each
expert split into 2 virtual experts), jamba-v0.1-52b (Mamba2 with
attention and MoE every other layer) and seamless-m4t-medium (encoder-
decoder over precomputed frames): both models run the JAX package's
`Model.init(PRNGKey(0))` parameters (carried over by
`convert.params_from_reference`) on the same numpy-seeded tokens and
frames, and their logits, MoE aux losses and decode caches agree.

Tolerances, as tests/test_torch_models.py holds the dense decoders: 1e-4
at float32 compute and atol = rtol = 0.08 at bfloat16.  In bfloat16 the
routers' top-k choices are compared too: where the two packages pick
different experts for a token, the test reports the router logits'
margin between the swapped experts, which must lie below what one
bfloat16 rounding of the router's input can move."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.layers as JL  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel, unbox  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import DecodeDims, Model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

FAMILIES = ["minicpm3-4b", "seamless-m4t-medium", "qwen3-moe-235b-a22b",
            "grok-1-314b", "jamba-v0.1-52b"]
MOE = ["qwen3-moe-235b-a22b", "grok-1-314b", "jamba-v0.1-52b"]
COMPUTE = {"float32": (jnp.float32, torch.float32, 1e-4),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.08)}
B, T, N_DECODE = 2, 16, 4
BF16_EPS = 2.0 ** -8        # bfloat16's relative rounding step (8 bits)


@pytest.fixture(scope="module")
def reference_params():
    """JAX parameters of each smoke config, as jax arrays and numpy."""
    out = {}
    for arch in FAMILIES:
        params, _ = unbox(jax.jit(JaxModel(jax_get_config(
            arch, smoke=True)).init)(jax.random.PRNGKey(0)))
        out[arch] = (params, jax.tree.map(np.asarray, params))
    return out


def _pair(arch, reference_params, jdt=jnp.float32, tdt=torch.float32,
          **port):
    """(JAX model, its params, port model) on the same parameters."""
    jax_cfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                                  compute_dtype=jdt)
    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=tdt,
                              **port)
    params, np_params = reference_params[arch]
    return JaxModel(jax_cfg), params, params_from_reference(np_params, cfg)


def _inputs(cfg, b=B, t=T, seed=0):
    """numpy tokens [b, t] int32 and, for an encoder-decoder, frames
    [b, t, d_model] float32 (None otherwise)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    frames = (rng.normal(0, 0.02, (b, t, cfg.d_model)).astype(np.float32)
              if cfg.arch_kind == "encdec" else None)
    return toks, frames


def _jbatch(toks, frames):
    batch = {"tokens": jnp.asarray(toks)}
    if frames is not None:
        batch["frames"] = jnp.asarray(frames)
    return batch


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _caches_close(got, want, cfg, tol):
    """The port's per-layer caches against the JAX package's stacked ones:
    layer rep * len(pattern) + slot holds repetition rep of slot's leaves
    (then the tail), an encoder-decoder's layer ending with its cross
    (k, v) from `cross_blocks` / `cross_tail`."""
    pat, n_rep, _ = cfg.pattern()
    for i, layer in enumerate(got):
        rep, slot = divmod(i, len(pat))
        if rep < n_rep:
            groups = [want["blocks"][slot]] + (
                [want["cross_blocks"][slot]] if "cross_blocks" in want else [])
            ref = [leaf[rep] for g in groups for leaf in jax.tree.leaves(g)]
        else:
            j = i - n_rep * len(pat)
            groups = [want["tail"][j]] + (
                [want["cross_tail"][j]] if "cross_tail" in want else [])
            ref = [leaf for g in groups for leaf in jax.tree.leaves(g)]
        mine = jax.tree.leaves(layer, is_leaf=lambda x: isinstance(
            x, torch.Tensor))
        assert len(mine) == len(ref), i
        for a, b in zip(mine, ref):
            assert tuple(a.shape) == tuple(b.shape), i
            _close(a, b, tol)


@pytest.mark.parametrize("compute", list(COMPUTE))
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_prefill_decode_match_reference(arch, compute,
                                                reference_params):
    jdt, tdt, tol = COMPUTE[compute]
    jm, params, tm = _pair(arch, reference_params, jdt, tdt)
    toks, frames = _inputs(jm.cfg)
    batch = _jbatch(toks, frames)
    t_toks, t_frames = torch.from_numpy(toks).long(), _t(frames)
    want, want_aux = jax.jit(jm.logits_fn)(params, batch)
    got, aux = tm.logits_fn(t_toks, t_frames, return_aux=True)
    _close(got, want, tol)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert float(aux) == pytest.approx(float(want_aux), abs=tol, rel=tol)
    assert (float(aux) > 0) == (arch in MOE)

    want, j_caches = jax.jit(jm.prefill)(params, batch)
    got, t_caches = tm.prefill(t_toks, t_frames)
    assert tuple(got.shape) == (B, jm.cfg.vocab)
    _close(got, want, tol)
    _caches_close(t_caches, j_caches, tm.cfg, tol)
    cross = [(c[-1], [t.clone() for t in c[-1]]) for c in t_caches] \
        if tm.cross else []

    decode = jax.jit(jm.decode_step)
    tok = toks[:, -1:]
    for i in range(N_DECODE):
        want, j_caches = decode(params, j_caches, jnp.asarray(tok),
                                jnp.int32(T + i))
        got, t_caches = tm.decode_step(t_caches, torch.from_numpy(tok).long(),
                                       T + i)
        assert tuple(got.shape) == (B, 1, jm.cfg.vocab)
        _close(got, want, tol)
        tok = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)[:, None]
    _caches_close(t_caches, j_caches, tm.cfg, tol)
    # decode reads the cross caches and never writes them
    for c, (before, values) in zip(t_caches, cross):
        assert all(a is b and torch.equal(a, v)
                   for a, b, v in zip(c[-1], before, values))


def _router_log(module, monkeypatch, jax_side):
    """Patch `module._router` to record (router input, top-k experts) of
    every call, in call order (the layers' order in both packages)."""
    log, orig = [], module._router

    def spy(params, x, cfg):
        out = orig(params, x, cfg)
        if jax_side:
            jax.debug.callback(lambda a, e: log.append(
                (np.asarray(a, np.float32), np.asarray(e))), x, out[1],
                ordered=True)
        else:
            log.append((x.float().numpy(), out[1].numpy()))
        return out

    monkeypatch.setattr(module, "_router", spy)
    return log


@pytest.mark.parametrize("arch", MOE)
def test_bf16_router_choices_match_reference(arch, reference_params,
                                             monkeypatch):
    """bf16 prefill: every MoE layer's top-k experts per token in both
    packages.  A token routed differently must sit on a near-tie: the
    port's router logits of the swapped experts lie closer together than
    one bfloat16 rounding of the router input can move them."""
    jm, params, tm = _pair(arch, reference_params, jnp.bfloat16,
                           torch.bfloat16)
    jm = JaxModel(jm.cfg)                  # a fresh object: no cached trace
    toks, frames = _inputs(jm.cfg, b=4, t=32, seed=3)
    jlog = _router_log(JL, monkeypatch, jax_side=True)
    tlog = _router_log(L, monkeypatch, jax_side=False)
    jax.block_until_ready(jm.prefill(params, _jbatch(toks, frames)))
    tm.prefill(torch.from_numpy(toks).long(), _t(frames))
    n_moe = sum(s["moe"] for s in tm.specs)
    assert len(jlog) == len(tlog) == n_moe
    router = [lp["moe"]["router"].detach().to(torch.bfloat16).float().numpy()
              for lp, s in zip(tm.layers, tm.specs) if s["moe"]]
    flips, margins = 0, []
    for w, (_, je), (x, te) in zip(router, jlog, tlog):
        x, je, te = x.reshape(-1, x.shape[-1]), je.reshape(-1, je.shape[-1]), \
            te.reshape(-1, te.shape[-1])
        logits = x @ w
        for n in np.nonzero((np.sort(je, -1) != np.sort(te, -1)).any(-1))[0]:
            flips += 1
            for i, j in zip(sorted(set(je[n]) - set(te[n])),
                            sorted(set(te[n]) - set(je[n]))):
                margin = abs(logits[n, i] - logits[n, j])
                bound = BF16_EPS * float(np.abs(x[n]) @ (np.abs(w[:, i]) +
                                                         np.abs(w[:, j])))
                margins.append((int(n), int(i), int(j), float(margin), bound))
                assert margin <= bound, (arch, margins[-1])
    print(f"{arch}: {flips} of {len(tlog) * toks.size} (token, layer) "
          f"routes differ; (token, jax expert, port expert, logit margin, "
          f"bf16 bound): {margins}")


def test_grok_virtual_split_is_the_unsplit_experts(reference_params):
    """grok keeps the reference's (E*s, D, F/s) layout leaf for leaf, and
    reassembling the E real experts gives the same layer as an unsplit
    model holding them."""
    _, np_params = reference_params["grok-1-314b"]
    cfg = dataclasses.replace(get_config("grok-1-314b", smoke=True),
                              compute_dtype=torch.float32)
    split = params_from_reference(np_params, cfg)
    e, s = cfg.n_experts, cfg.moe_virtual_split
    moe = split.layers[0]["moe"]
    assert tuple(moe["wi"].shape) == (e * s, cfg.d_model, cfg.d_ff // s)
    assert tuple(moe["wo"].shape) == (e * s, cfg.d_ff // s, cfg.d_model)
    np.testing.assert_array_equal(moe["wi"].detach().numpy(),
                                  np_params["blocks"][0]["moe"]["wi"][0])
    whole = Model(dataclasses.replace(cfg, moe_virtual_split=1)).init(
        torch.Generator().manual_seed(0))
    state = {}
    for name, t in split.state_dict().items():
        if name.endswith(("moe.wi", "moe.wg")):
            t = t.reshape(e, s, cfg.d_model, -1).movedim(1, 2).reshape(
                e, cfg.d_model, cfg.d_ff)
        elif name.endswith("moe.wo"):
            t = t.reshape(e, cfg.d_ff, cfg.d_model)
        state[name] = t
    whole.load_state_dict(state)
    toks, _ = _inputs(cfg)
    got, aux = split.logits_fn(torch.from_numpy(toks).long(), return_aux=True)
    want, want_aux = whole.logits_fn(torch.from_numpy(toks).long(),
                                     return_aux=True)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert float(aux) == float(want_aux)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", MOE)
def test_moe_routes_compute_the_same_layer(arch, dtype):
    """The card's route (one `torch._grouped_mm` over the expert groups,
    the offsets on the device) computes the plain per-expert loop's
    function; rehearsed here on the CPU, where `moe_route` picks the
    loop."""
    cfg = get_config(arch, smoke=True)
    model = Model(cfg).init(torch.Generator().manual_seed(0))
    lp = next(lp for lp, s in zip(model.layers, model.specs) if s["moe"])
    params = {k: v.detach().to(dtype) for k, v in lp["moe"].items()}
    x = torch.randn((3, 40, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)).to(dtype)
    if cfg.moe_virtual_split > 1:
        e, s = cfg.n_experts, cfg.moe_virtual_split
        for nm in ("wi", "wg"):
            w = params[nm]
            params[nm] = w.reshape(e, s, w.shape[1], -1).movedim(1, 2) \
                .reshape(e, w.shape[1], -1)
        params["wo"] = params["wo"].reshape(e, -1, cfg.d_model)
    assert L.moe_route(x) == "loop"
    loop, aux = L.moe_ragged(params, x, cfg)
    grouped, aux2 = L.moe_ragged(params, x, cfg, route="grouped")
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(grouped, loop, atol=tol, rtol=tol)
    assert float(aux) == float(aux2)


def test_router_breaks_ties_by_the_lower_expert():
    """Equal probabilities go to the lower expert index, as
    `jax.lax.top_k` gives them."""
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b", smoke=True),
                              n_experts=6, top_k=3)
    router = torch.zeros((cfg.d_model, 6))
    router[0] = torch.tensor([1.0, 2.0, 2.0, 0.0, 2.0, 1.0])
    x = torch.ones((1, 2, cfg.d_model))
    top_p, top_e, _ = L._router({"router": router}, x, cfg)
    jp, je, _ = JL._router({"router": jnp.asarray(router.numpy())},
                           jnp.asarray(x.numpy()), cfg)
    assert top_e.tolist() == np.asarray(je).tolist() == [[[1, 2, 4]] * 2]
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jp), rtol=1e-6)


def test_encoder_decoder_needs_frames(reference_params):
    _, _, tm = _pair("seamless-m4t-medium", reference_params)
    with pytest.raises(ValueError, match="frames"):
        tm.prefill(torch.zeros((1, 4), dtype=torch.long))


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_full_forward(arch):
    """prefill(t[:-1]) + decode(t[-1]) == the full forward's last logits,
    with each attention and MLA cache ring widened by one slot (the cross
    caches keep the encoder's length)."""
    cfg = get_config(arch, smoke=True)
    model = Model(cfg).init(torch.Generator().manual_seed(0))
    t = 17
    toks, frames = _inputs(cfg, t=t)
    toks, frames = torch.from_numpy(toks).long(), _t(frames)
    full = model.logits_fn(toks, frames)
    _, caches = model.prefill(toks[:, :t - 1], frames)
    widened = model.init_cache(DecodeDims(batch=B, seq=t))
    for spec, c, w in zip(model.specs, caches, widened):
        if spec["kind"] in ("attn", "mla"):
            for src, dst in zip(c[0], w[0]):
                dst[:, :t - 1] = src
        else:
            for src, dst in zip(c[:2], w[:2]):
                dst.copy_(src)
    if model.cross:
        widened = [w[:-1] + (c[-1],) for w, c in zip(widened, caches)]
    got, _ = model.decode_step(widened, toks[:, t - 1:], t - 1)
    np.testing.assert_allclose(got[:, 0].float().numpy(),
                               full[:, -1].float().numpy(),
                               rtol=0.08, atol=0.08)


@pytest.mark.parametrize("arch,flag,t", [
    ("seamless-m4t-medium", "use_flash_kernel", 128),
    ("jamba-v0.1-52b", "use_flash_kernel", 128),
    ("jamba-v0.1-52b", "use_ssd_kernel", 128)])
def test_kernel_flags_match_reference(arch, flag, t, reference_params):
    """A kernel flag in the port (CPU: the wrapper's plain version, no
    launch) against the JAX package's dense path, at the flash dispatch's
    minimum length: the encoder and the cross attention never dispatch."""
    jm, params, tm = _pair(arch, reference_params, **{flag: True})
    toks, frames = _inputs(jm.cfg, b=1, t=t, seed=2)
    want, _ = jax.jit(jm.logits_fn)(params, _jbatch(toks, frames))
    before = (fops.flash_attention.launches, sops.ssd_scan.launches)
    got = tm.logits_fn(torch.from_numpy(toks).long(), _t(frames))
    assert (fops.flash_attention.launches, sops.ssd_scan.launches) == before
    _close(got, want, 1e-4)


def test_serve_inputs_are_the_reference_drivers():
    """The serving driver draws the prompts and then, for an encoder-
    decoder, the frames from one numpy generator, as
    `repro.launch.serve` does."""
    cfg = get_config("seamless-m4t-medium", smoke=True)
    toks, frames = serve.inputs(cfg, 3, 8, 5)
    rng = np.random.default_rng(5)
    np.testing.assert_array_equal(toks, rng.integers(0, cfg.vocab, (3, 8)))
    np.testing.assert_array_equal(
        frames, np.asarray(rng.normal(0, 0.02, (3, 8, cfg.d_model)),
                           np.float32))
    np.testing.assert_array_equal(serve.prompts(cfg, 3, 8, 5), toks)
    assert serve.inputs(get_config("qwen3-1.7b", smoke=True), 3, 8, 5)[1] \
        is None


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "jamba-v0.1-52b"])
def test_serve_main_runs_the_families(arch):
    toks = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                       "--prompt-len", "16", "--gen", "3", "--device",
                       "cpu"])
    assert tuple(toks.shape) == (2, 4) and toks.dtype == torch.int32

