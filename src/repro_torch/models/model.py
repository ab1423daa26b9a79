"""The model family of the port (serving and training paths).

`ModelConfig` carries every field of the JAX package's config, with
torch dtypes.  `Model` is an `nn.Module` whose layers sit in an
`nn.ModuleList` in true layer order; the JAX package stacks them per
pattern slot and runs a `lax.scan` over repetitions, so its layer
`rep * len(pattern) + slot` is the port's `layers[i]` at that index,
then the tail (an encoder-decoder's encoder stack, `enc_blocks` there,
is `enc_layers` here).  Every unsharded family of the JAX package
builds: GQA (+ qk-norm, sliding window), MLA, MoE (the dropless
reference, with `moe_virtual_split`), Mamba2 and attention:SSM hybrids,
and the encoder-decoder with cross attention over precomputed frames.
Serving entry points (`logits_fn`, `prefill`, `init_cache`,
`decode_step`) run with no grad on a cached compute-dtype copy of the
parameters; `loss_fn` is differentiable in an explicit parameter tree
(`param_tree`), with per-layer activation checkpointing as `cfg.remat`
says.  The MoE layers' load-balancing aux loss is summed over layers:
`logits_fn(..., return_aux=True)` returns it, and `loss_fn` adds
`0.01 * aux`, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import tree as T
from . import layers as L
from . import ssm as S

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    # attention
    attn_kind: str = "gqa"             # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 1e4
    window: int = 0                    # sliding window (local layers)
    global_every: int = 0              # k>0: every k-th layer is global
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    mla_nope_dim: int = 0
    mla_rope_dim: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                 # 1: all layers; 2: odd layers
    capacity_factor: float = 1.25
    moe_virtual_split: int = 1         # split each expert's d_ff s ways
    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0                # k>0: attention at i%k==k//2
    # structure
    arch_kind: str = "decoder"         # decoder | encdec
    n_enc_layers: int = 0
    frontend: str = "none"             # none | audio_frames
    # numerics / perf
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: str = "full"                # full | dots | none
    use_flash_kernel: bool = False
    use_ssd_kernel: bool = False
    scan_unroll: int = 1               # dry-run cost extrapolation knob
    seq_parallel: bool = False         # sharded path, not ported

    @property
    def hd(self):
        return self.head_dim or self.d_model // self.n_heads

    # ---- layer pattern --------------------------------------------------
    def layer_specs(self):
        specs = []
        for i in range(self.n_layers):
            if self.attn_kind == "none":
                kind = "mamba"
            elif self.attn_every:
                kind = ("attn" if i % self.attn_every == self.attn_every // 2
                        else "mamba")
            else:
                kind = "mla" if self.attn_kind == "mla" else "attn"
            window = 0
            if kind == "attn" and self.global_every:
                if i % self.global_every != self.global_every - 1:
                    window = self.window
            moe = bool(self.n_experts) and (
                i % self.moe_every == self.moe_every - 1)
            has_mlp = self.d_ff > 0 and kind != "mamba" or \
                (kind == "mamba" and self.attn_every > 0 and self.d_ff > 0)
            specs.append(dict(kind=kind, window=window, moe=moe,
                              mlp=has_mlp and not moe))
        return specs

    def pattern(self):
        """(pattern slots, n_rep, tail slots)."""
        specs = self.layer_specs()
        p = 1
        for k in (self.global_every, self.attn_every,
                  self.moe_every if self.n_experts else 1):
            if k:
                p = p * k // math.gcd(p, k)
        p = min(p, self.n_layers)
        n_rep = self.n_layers // p
        tail = specs[n_rep * p:]
        for i in range(n_rep * p):
            if specs[i] != specs[i % p]:
                raise ValueError(f"layer {i} breaks the pattern: {specs[i]} "
                                 f"!= {specs[i % p]}")
        return specs[:p], n_rep, tail


def _to_compute(t, cd):
    """float32 leaves in the compute dtype (the JAX package's `_cast`)."""
    return t.to(cd) if t.dtype == torch.float32 else t


@dataclasses.dataclass(frozen=True)
class DecodeDims:
    """Cache geometry for serve steps."""
    batch: int
    seq: int          # cache length (== shape's seq_len)


# =====================================================================
# single layer
# =====================================================================

# the encoder's layers: full (non-causal) attention with rope, and an MLP
ENC_SPEC = dict(kind="attn", window=0, moe=False, mlp=True)


def init_layer(gen, spec, cfg: ModelConfig, cross: bool = False) -> dict:
    """{group: {name: tensor}} of one layer, as the JAX package's tree
    (`cross`: an encoder-decoder's decoder layer, with `ln_x` and the
    cross attention `xattn`).  With `moe_virtual_split` s > 1 each
    expert's d_ff is split s ways into E * s virtual experts, `wi` / `wg`
    (E*s, D, F/s) and `wo` (E*s, F/s, D), the reference's layout."""
    dt = cfg.param_dtype
    p = {"ln1": L.init_rmsnorm(gen, cfg.d_model, dt)}
    if spec["kind"] == "attn":
        p["attn"] = L.init_attention(gen, cfg, dt)
    elif spec["kind"] == "mla":
        p["attn"] = L.init_mla(gen, cfg, dt)
    else:
        p["ssm"] = S.init_mamba2(gen, cfg, dt)
    if cross:
        p["ln_x"] = L.init_rmsnorm(gen, cfg.d_model, dt)
        p["xattn"] = L.init_attention(gen, cfg, dt)
    if spec["moe"]:
        p["ln2"] = L.init_rmsnorm(gen, cfg.d_model, dt)
        p["moe"] = L.init_moe(gen, cfg, dt)
        s = cfg.moe_virtual_split
        if s > 1:
            for nm in ("wi", "wg", "wo"):
                w = p["moe"][nm]
                e, r, c = w.shape
                if nm == "wo":      # [E, F, D]: split F
                    w = w.reshape(e * s, r // s, c)
                else:               # [E, D, F]: split F
                    w = w.reshape(e, r, s, c // s).movedim(2, 1).reshape(
                        e * s, r, c // s)
                p["moe"][nm] = w.contiguous()
    elif spec["mlp"]:
        p["ln2"] = L.init_rmsnorm(gen, cfg.d_model, dt)
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def make_moe_apply(cfg: ModelConfig):
    """fn(params, x) -> (y, aux): the dropless MoE.  With
    `moe_virtual_split` s > 1 the E real experts are reassembled from
    their E * s virtual slices first, as the reference's unsharded path
    does."""
    s, e = cfg.moe_virtual_split, cfg.n_experts
    if s == 1:
        return lambda params, x: L.moe_ragged(params, x, cfg)

    def ragged(params, x):
        wi, wg, wo = params["wi"], params["wg"], params["wo"]
        pm = dict(params)
        for nm, w in (("wi", wi), ("wg", wg)):
            pm[nm] = w.reshape(e, s, w.shape[1], w.shape[2]).movedim(
                1, 2).reshape(e, w.shape[1], w.shape[2] * s)
        pm["wo"] = wo.reshape(e, wo.shape[1] * s, wo.shape[2])
        return L.moe_ragged(pm, x, cfg)
    return ragged


def apply_layer(spec, p, x, cfg: ModelConfig, *, positions, cache,
                cache_pos, enc_out=None, moe_apply=None, build=False):
    """One layer -> (x, new_cache, aux).  A decoder layer of an
    encoder-decoder (it holds `xattn`) attends to `enc_out` [B, Te, D]
    in training and prefill, and to the cross (k, v) that closes its
    cache entry in decode; its new cache entry ends with that (k, v),
    passed on unchanged.  aux is the MoE layer's load-balancing loss
    (through `moe_apply`, `make_moe_apply(cfg)`), None for the other
    layers."""
    h = L.rms_norm(p["ln1"], x)
    if spec["kind"] == "attn":
        c_self = cache[0] if cache is not None else None
        out, nc = L.attention(
            p["attn"], h, cfg, positions=positions, cache=c_self,
            cache_pos=cache_pos, window=spec["window"] or None,
            use_flash=cfg.use_flash_kernel, build_cache=build)
        new_cache = (nc,)
    elif spec["kind"] == "mla":
        c_self = cache[0] if cache is not None else None
        out, nc = L.mla_attention(
            p["attn"], h, cfg, positions=positions, cache=c_self,
            cache_pos=cache_pos, build_cache=build)
        new_cache = (nc,)
    else:
        st = cache[0] if cache is not None else None
        cc = cache[1] if cache is not None else None
        out, new_cache = S.mamba2_block(
            p["ssm"], h, cfg, state=st, conv_cache=cc,
            use_kernel=cfg.use_ssd_kernel, build_cache=build)
    x = x + out

    if "xattn" in p:
        hx = L.rms_norm(p["ln_x"], x)
        xkv = (cache[-1] if cache is not None
               else L.project_kv(p["xattn"], enc_out))
        out, _ = L.attention(p["xattn"], hx, cfg, positions=positions,
                             cross_kv=xkv)
        x = x + out
        new_cache = new_cache + (xkv,)

    aux = None
    if spec["moe"]:
        h2 = L.rms_norm(p["ln2"], x)
        out2, aux = moe_apply(p["moe"], h2)
        x = x + out2
    elif spec["mlp"]:
        h2 = L.rms_norm(p["ln2"], x)
        x = x + L.mlp(p["mlp"], h2)
    return x, new_cache, aux


def _save_dots(ctx, op, *args, **kwargs):
    """remat="dots": keep the outputs of products without batch dims (the
    projections and MLP products, `aten.mm`), recompute everything else
    -- `jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims`."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


REMAT_CONTEXT = {
    "full": None,
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _save_dots),
}


# =====================================================================
# full model
# =====================================================================

class Model(nn.Module):
    """The LM (decoder or encoder-decoder).  `Model(cfg)` is empty;
    `init(generator)` draws the parameters on the generator's device (or
    `convert.params_from_reference` loads the JAX package's)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.arch_kind not in ("decoder", "encdec"):
            raise ValueError(f"arch_kind must be decoder or encdec, not "
                             f"{cfg.arch_kind!r}")
        self.cfg = cfg
        self.specs = cfg.layer_specs()
        self.cross = cfg.arch_kind == "encdec"
        self.register_parameter("embed", None)
        self.final_norm = nn.ParameterDict()
        self.layers = nn.ModuleList()
        self.enc_layers = nn.ModuleList()
        self.enc_norm = nn.ParameterDict()
        self._compute = None

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        cfg = self.cfg

        def module(tree):
            return nn.ModuleDict({g: nn.ParameterDict(ps)
                                  for g, ps in tree.items()})

        self.embed = nn.Parameter(L._norm(generator, (cfg.vocab, cfg.d_model),
                                          dtype=cfg.param_dtype))
        self.final_norm = nn.ParameterDict(
            L.init_rmsnorm(generator, cfg.d_model, cfg.param_dtype))
        self.layers = nn.ModuleList(
            module(init_layer(generator, spec, cfg, cross=self.cross))
            for spec in self.specs)
        if self.cross:
            self.enc_layers = nn.ModuleList(
                module(init_layer(generator, ENC_SPEC, cfg))
                for _ in range(cfg.n_enc_layers))
            self.enc_norm = nn.ParameterDict(
                L.init_rmsnorm(generator, cfg.d_model, cfg.param_dtype))
        self._compute = None
        return self

    # The JAX package casts every float32 parameter to the compute dtype
    # on every call (`Model._cast`).  Serving keeps one compute-dtype copy
    # instead, made at the first call after `init`, `load_state_dict`, a
    # move between devices or a change of `cfg.compute_dtype`; it rounds
    # the same parameters (a_log, dt_bias, d_skip, the router and the norm
    # weights too).  Change parameters only through those or followed by
    # `drop_compute_copy`, or the copy goes stale.  Training never reads
    # it: its step casts the masters itself, once per step, and
    # differentiates with respect to that cast (`launch.steps`).
    def _apply(self, fn, *args, **kwargs):
        self._compute = None
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._compute = None
        return super().load_state_dict(*args, **kwargs)

    def drop_compute_copy(self):
        """Forget the serving copy: the training step calls this after it
        changes the parameters in place."""
        self._compute = None

    def param_tree(self) -> dict:
        """The parameters as a tree {embed, final_norm: {w}, layers: [{group:
        {name}}]} (layers in true order; an encoder-decoder adds
        enc_layers: [...] and enc_norm: {w}): what `loss_fn` takes, and
        what the optimizer and checkpoints hold."""
        if self.embed is None:
            raise RuntimeError("the model has no parameters: call "
                               "init(generator) first")

        def layers(mods):
            return [{g: dict(grp) for g, grp in layer.items()}
                    for layer in mods]

        tree = dict(embed=self.embed, final_norm=dict(self.final_norm),
                    layers=layers(self.layers))
        if self.cross:
            tree.update(enc_layers=layers(self.enc_layers),
                        enc_norm=dict(self.enc_norm))
        return tree

    def _cast(self) -> dict:
        cd = self.cfg.compute_dtype
        if self._compute is None or self._compute["dtype"] != cd:
            self._compute = None                  # free the old copy first
            self._compute = dict(dtype=cd, **T.tree_map(
                lambda t: _to_compute(t.detach(), cd), self.param_tree()))
        return self._compute

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _encode(self, p, frames):
        """The encoder over frame embeddings [B, Te, D]: non-causal
        attention with rope, never the flash kernel, then enc_norm.  Not
        checkpointed in training, as the reference scans it without
        `jax.checkpoint`."""
        if frames is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder: it "
                             f"needs frames [B, T, d_model]")
        cfg = self.cfg
        x = frames.to(device=self.device, dtype=cfg.compute_dtype)
        b, t, _ = x.shape
        positions = torch.arange(t, device=x.device)[None].expand(b, t)
        for lp in p["enc_layers"]:
            h = L.rms_norm(lp["ln1"], x)
            out, _ = L.attention(lp["attn"], h, cfg, positions=positions,
                                 causal=False)
            x = x + out
            x = x + L.mlp(lp["mlp"], L.rms_norm(lp["ln2"], x))
        return L.rms_norm(p["enc_norm"], x)

    def _run_layers(self, p, x, *, positions, caches, cache_pos,
                    enc_out=None, build=False):
        """-> (x, new caches in layer order, summed aux or None)."""
        moe_apply = make_moe_apply(self.cfg) if self.cfg.n_experts else None
        new_caches, aux = [], None
        for i, spec in enumerate(self.specs):
            c = caches[i] if caches is not None else None
            x, nc, a = apply_layer(spec, p["layers"][i], x, self.cfg,
                                   positions=positions, cache=c,
                                   cache_pos=cache_pos, enc_out=enc_out,
                                   moe_apply=moe_apply, build=build)
            new_caches.append(nc)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, new_caches, aux

    def _train_layers(self, p, x, positions, enc_out=None):
        """The layers with autograd, each one checkpointed as `cfg.remat`
        says ("full": recomputed whole in the backward pass, "dots": the
        matmul outputs kept, "none": every activation kept).  Returns (x,
        summed aux or None); aux and the encoder output pass through the
        checkpoints like x."""
        remat = self.cfg.remat
        if remat not in ("full", "dots", "none"):
            raise ValueError(f"remat must be full, dots or none, not "
                             f"{remat!r}")
        moe_apply = make_moe_apply(self.cfg) if self.cfg.n_experts else None
        aux = None
        for spec, lp in zip(self.specs, p["layers"]):
            def layer(x, enc_out, spec=spec, lp=lp):
                x, _, a = apply_layer(spec, lp, x, self.cfg,
                                      positions=positions, cache=None,
                                      cache_pos=None, enc_out=enc_out,
                                      moe_apply=moe_apply)
                return x if a is None else (x, a)
            if remat == "none":
                out = layer(x, enc_out)
            else:
                ctx = REMAT_CONTEXT[remat]
                out = checkpoint(layer, x, enc_out, use_reentrant=False,
                                 **({"context_fn": ctx} if ctx else {}))
            if spec["moe"]:
                x, a = out
                aux = a if aux is None else aux + a
            else:
                x = out
        return x, aux

    def _embed(self, p, tokens):
        return p["embed"][tokens].to(self.cfg.compute_dtype)

    def _start(self, p, tokens, frames):
        """(embedded tokens, positions, encoder output or None)."""
        b, t = tokens.shape
        x = self._embed(p, tokens)
        positions = torch.arange(t, device=x.device)[None].expand(b, t)
        enc_out = self._encode(p, frames) if self.cross else None
        return x, positions, enc_out

    # ---- entry points -----------------------------------------------------
    @torch.no_grad()
    def logits_fn(self, tokens, frames=None, *, return_aux=False):
        """Full forward: tokens [B, T] (and, for an encoder-decoder, frames
        [B, Te, D]) -> logits [B, T, V] (the training and prefill math).
        With `return_aux`, (logits, aux): the MoE layers' summed
        load-balancing loss, a float32 scalar (0 without MoE layers), as
        the JAX package's `logits_fn` returns it."""
        p = self._cast()
        x, positions, enc_out = self._start(p, tokens, frames)
        x, _, aux = self._run_layers(p, x, positions=positions, caches=None,
                                     cache_pos=None, enc_out=enc_out)
        x = L.rms_norm(p["final_norm"], x)
        logits = x @ p["embed"].T
        if not return_aux:
            return logits
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, aux

    def loss_fn(self, params, batch):
        """Masked mean next-token NLL of `batch` {"tokens", "labels"} [B, T]
        (labels < 0 masked out; an encoder-decoder also reads "frames"),
        plus `0.01 * aux`, the MoE layers' summed load-balancing loss, as
        `repro.models.Model.loss_fn`; differentiable in `params`, a tree
        as `param_tree` gives (float32 leaves are cast to the compute
        dtype; leaves already in it are used as they are).  log_softmax
        in float32."""
        cd = self.cfg.compute_dtype
        p = T.tree_map(lambda t: _to_compute(t, cd), params)
        tokens = batch["tokens"].long()
        labels = batch["labels"].long()
        x, positions, enc_out = self._start(p, tokens, batch.get("frames"))
        x, aux = self._train_layers(p, x, positions, enc_out)
        x = L.rms_norm(p["final_norm"], x)
        logp = torch.log_softmax((x @ p["embed"].T).float(), dim=-1)
        ll = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
        mask = (labels >= 0).float()
        loss = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss if aux is None else loss + 0.01 * aux

    @torch.no_grad()
    def prefill(self, tokens, frames=None):
        """Full forward that also builds the decode caches: tokens [B, T]
        (and frames [B, Te, D] for an encoder-decoder) -> (logits [B, V]
        of the last position, caches)."""
        p = self._cast()
        x, positions, enc_out = self._start(p, tokens, frames)
        x, caches, _ = self._run_layers(p, x, positions=positions,
                                        caches=None, cache_pos=None,
                                        enc_out=enc_out, build=True)
        x = L.rms_norm(p["final_norm"], x)
        return x[:, -1] @ p["embed"].T, caches

    def init_cache(self, dims: DecodeDims) -> list:
        """Zero decode caches for every layer, in layer order: ((k, v),)
        [B, S, KV, hd] for attention (S clipped to a local layer's
        window), ((c_kv [B, S, kv_lora], k_rope [B, S, rope_dim]),) for
        MLA, (state [B, H, N, P] f32, conv [B, K-1, conv_dim]) for Mamba2;
        an encoder-decoder's layers end with the cross (k, v) [B, S, KV,
        hd]."""
        cfg = self.cfg
        b, s = dims.batch, dims.seq
        dt, dev = cfg.compute_dtype, self.device

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        caches = []
        for spec in self.specs:
            if spec["kind"] == "attn":
                sz = min(s, spec["window"]) if spec["window"] else s
                c = ((zeros(b, sz, cfg.n_kv_heads, cfg.hd),
                      zeros(b, sz, cfg.n_kv_heads, cfg.hd)),)
            elif spec["kind"] == "mla":
                c = ((zeros(b, s, cfg.kv_lora_rank),
                      zeros(b, s, cfg.mla_rope_dim)),)
            else:
                d_in = cfg.ssm_expand * cfg.d_model
                h = d_in // cfg.ssm_head_dim
                c = (zeros(b, h, cfg.ssm_state, cfg.ssm_head_dim,
                           dtype=torch.float32),
                     zeros(b, cfg.ssm_conv - 1, d_in + 2 * cfg.ssm_state))
            if self.cross:
                c = c + ((zeros(b, s, cfg.n_kv_heads, cfg.hd),
                          zeros(b, s, cfg.n_kv_heads, cfg.hd)),)
            caches.append(c)
        return caches

    @torch.no_grad()
    def decode_step(self, caches, tokens, pos: int):
        """One serving step: tokens [B, 1] at absolute position `pos`
        against caches -> (logits [B, 1, V], caches).  Each attention and
        MLA cache ring is written at `pos % its_length` in place; Mamba2
        states and conv caches are replaced; the cross (k, v) of an
        encoder-decoder is read, never written."""
        p = self._cast()
        b = tokens.shape[0]
        x = self._embed(p, tokens)
        positions = torch.full((b, 1), pos, dtype=torch.int64,
                               device=x.device)
        x, new_caches, _ = self._run_layers(p, x, positions=positions,
                                            caches=caches, cache_pos=pos)
        x = L.rms_norm(p["final_norm"], x)
        return x @ p["embed"].T, new_caches
