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

`Model(cfg, ctx)` with a `sharding.ParallelCtx` is the sharded model:
each parameter is a DTensor holding this rank's block, laid out by
`launch.steps.param_shardings`; at use a layer's dense leaves are
gathered whole (FSDP-style), while the MoE experts stay blocks for the
expert-parallel paths (`layers.moe_ep_stationary` for b*t <= 2048
tokens, else `layers.moe_ep_local`), and a decode over a cache
sequence-sharded over "model" runs `layers.decode_attention_dist`.
Activations are this rank's batch block (`_bshard`), and its sequence
block under sequence parallelism (set when the q heads do not tile the
model axis, as in the reference).  Entry points take and return global
tensors, the same on every rank; caches are DTensors laid out by
`launch.steps.cache_specs`.  The flash and SSD kernels run on each
rank's blocks, through the same wrappers as unsharded.  `loss_fn` is
differentiable on a mesh too: the layers run as unsharded training runs
them (checkpointed per `cfg.remat`), each rank's parameters are gathered
inside its checkpoints, and the gradients arrive in the parameters'
layout (`sharding.full`'s rule says where they are summed).
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
from . import sharding as SH
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
    seq_parallel: bool = False         # set by Model when heads don't
                                       # tile the model axis (see __init__)

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


def make_moe_apply(cfg: ModelConfig, ctx=None, *, batch=None, seq=None):
    """fn(params, x) -> (y, aux).  Without `ctx` the dropless MoE; with
    `moe_virtual_split` s > 1 the E real experts are reassembled from
    their E * s virtual slices first, as the reference's unsharded path
    does.  With `ctx`, expert parallelism over the model axis: params are
    DTensors (or full tensors every rank holds), x this rank's batch
    block of a global batch of `batch` rows (and, with `seq`, its
    sequence block, gathered first); `moe_ep_stationary` when the
    global b*t <= 2048, else `moe_ep_local` on the experts' blocks."""
    s, e = cfg.moe_virtual_split, cfg.n_experts
    if ctx is not None:
        mesh, maxis = ctx.mesh, ctx.model_axis
        m = ctx.mesh_shape[maxis]
        if (e * s) % m:
            raise ValueError(f"{cfg.name}: {e * s} (virtual) experts do not "
                             f"tile the model axis of {m}")

        def apply(params, x):
            if seq is not None:
                x = seq.gather(x, same=True)
            bl, t, _ = x.shape
            b = bl if batch is None else batch
            if b * t <= 2048:
                # serving / few tokens: weight-stationary expert parallelism
                y, aux = L.moe_ep_stationary(params, x, cfg, ctx, batch=b)
            else:
                stats = SH.entry_axes(SH.batch_spec(ctx, b, 3)[0])
                lp = {"router": SH.full(params["router"], stats)}
                for nm in ("wi", "wg", "wo"):
                    lp[nm] = SH.to_local(params[nm], mesh,
                                         SH.Spec((maxis, None, None)), stats)
                y, aux = L.moe_ep_local(lp, x, cfg, mesh, maxis, e_par=m,
                                        f_par=1, stats_axes=stats)
            return (y if seq is None else seq.local(y)), aux
        return apply
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
                cache_pos, enc_out=None, moe_apply=None, build=False,
                attn_ctx=None, seq=None):
    """One layer -> (x, new_cache, aux).  A decoder layer of an
    encoder-decoder (it holds `xattn`) attends to `enc_out` [B, Te, D]
    in training and prefill, and to the cross (k, v) that closes its
    cache entry in decode; its new cache entry ends with that (k, v),
    passed on unchanged.  aux is the MoE layer's load-balancing loss
    (through `moe_apply`, `make_moe_apply(cfg)`), None for the other
    layers.  `attn_ctx`: the self-attention (or MLA) cache is this rank's
    block of a cache sharded over the model axis (decode on the block);
    `seq`: x is this rank's sequence block (`sharding.SeqShard`)."""
    h = L.rms_norm(p["ln1"], x)
    if spec["kind"] == "attn":
        c_self = cache[0] if cache is not None else None
        out, nc = L.attention(
            p["attn"], h, cfg, positions=positions, cache=c_self,
            cache_pos=cache_pos, window=spec["window"] or None,
            use_flash=cfg.use_flash_kernel, build_cache=build,
            ctx=attn_ctx, seq=seq)
        new_cache = (nc,)
    elif spec["kind"] == "mla":
        c_self = cache[0] if cache is not None else None
        out, nc = L.mla_attention(
            p["attn"], h, cfg, positions=positions, cache=c_self,
            cache_pos=cache_pos, build_cache=build, seq=seq, ctx=attn_ctx)
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
    `convert.params_from_reference` loads the JAX package's).  With a
    `ctx` (`sharding.ParallelCtx` on a DeviceMesh) it is the sharded
    model of the module's docstring."""

    def __init__(self, cfg: ModelConfig, ctx=None):
        super().__init__()
        if cfg.arch_kind not in ("decoder", "encdec"):
            raise ValueError(f"arch_kind must be decoder or encdec, not "
                             f"{cfg.arch_kind!r}")
        # Sequence parallelism: when the q-head count does not tile the
        # model axis (gemma3: 4, starcoder2: 24, minicpm3: 40 vs 16),
        # head sharding fails; sharding the *sequence* over the model
        # axis keeps attention distributed (k/v are all-gathered).
        if ctx is not None and cfg.attn_kind in ("gqa", "mla") and \
                cfg.attn_every == 0 and \
                cfg.n_heads % ctx.mesh_shape[ctx.model_axis] != 0:
            cfg = dataclasses.replace(cfg, seq_parallel=True)
        if ctx is not None and cfg.seq_parallel and \
                ctx.mesh_shape[ctx.model_axis] > 1 and (
                    cfg.arch_kind == "encdec" or cfg.attn_every):
            raise NotImplementedError(
                f"{cfg.name}: sequence parallelism over a model axis of "
                f"more than one rank covers attention-only decoders")
        self.cfg = cfg
        self.ctx = ctx            # ParallelCtx or None
        self.specs = cfg.layer_specs()
        self.cross = cfg.arch_kind == "encdec"
        self.register_parameter("embed", None)
        self.final_norm = nn.ParameterDict()
        self.layers = nn.ModuleList()
        self.enc_layers = nn.ModuleList()
        self.enc_norm = nn.ParameterDict()
        self._compute = None

    @torch.no_grad()
    def init(self, generator, serving_mode: str = "train") -> "Model":
        """Draw the parameters from `generator` (on its device); with a
        ctx, every rank draws them whole, then keeps its blocks as
        `launch.steps.param_shardings(self, ctx, serving_mode)` lays
        them out."""
        self._draw(generator)
        if self.ctx is not None:
            from ..launch.steps import param_shardings
            self.place(param_shardings(self, self.ctx, serving_mode)[1])
        return self

    @torch.no_grad()
    def _draw(self, generator) -> "Model":
        """The parameters, whole (`layers.META`: meta tensors, no draws)."""
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

    @torch.no_grad()
    def place(self, shardings) -> "Model":
        """Lay each parameter out as `shardings` (a tree shaped like
        `param_tree()` of `sharding.Sharding`) says: a whole tensor is cut
        to this rank's block (no collective), a DTensor redistributed."""
        want = T.leaves(shardings, is_leaf=SH.is_sharding)
        return self.load_param_tree(T.unflatten(self.param_tree(), [
            SH.distribute(p.detach(), sh.mesh, sh.spec)
            for p, sh in zip(T.leaves(self.param_tree()), want)]))

    @torch.no_grad()
    def load_param_tree(self, tree) -> "Model":
        """Make the leaves of `tree` (shaped like `param_tree()`: tensors
        or DTensors, taken as they are) the model's parameters."""
        for (path, old), new in zip(T.leaves_with_paths(self.param_tree()),
                                    T.leaves(tree)):
            owner = self
            for key in path[:-1]:
                owner = getattr(owner, key) if owner is self else owner[key]
            new = nn.Parameter(new, requires_grad=old.requires_grad)
            if owner is self:
                setattr(self, path[-1], new)
            else:
                owner[path[-1]] = new
            del old
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
    # differentiates with respect to that cast (`launch.steps`).  With a
    # ctx the copy holds this rank's blocks.
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

    # ---- the sharded layout (ctx) -----------------------------------------
    def _at_use(self, lp: dict, part=()) -> dict:
        """A layer's parameters as its functions take them: with a ctx,
        each leaf gathered whole (FSDP-style), its gradient summed over
        the mesh axes `part` (`_grad_axes`); the MoE group stays as it is
        (the expert-parallel paths take the experts as blocks and gather
        the router themselves)."""
        if self.ctx is None:
            return lp
        return {g: grp if g == "moe" else
                {n: SH.full(t, part) for n, t in grp.items()}
                for g, grp in lp.items()}

    def _grad_axes(self, batch: int, seq=None) -> tuple:
        """The mesh axes on which the ranks see different tokens of a
        global batch of `batch` rows: the batch axes `batch_spec` splits
        it over, and the model axis under sequence parallelism.  The
        gradient of a dense parameter is summed over these (and the
        loss's partial sums are)."""
        if self.ctx is None:
            return ()
        axes = SH.entry_axes(SH.batch_spec(self.ctx, batch, 2)[0])
        return axes + ((self.ctx.model_axis,) if seq is not None else ())

    def _seq(self, t: int):
        """The `SeqShard` of a sequence of `t` under sequence parallelism
        (None unless the model axis has more than one rank and divides
        t, so a decode step's single token is never split)."""
        if self.ctx is None or not self.cfg.seq_parallel:
            return None
        m = self.ctx.mesh_shape[self.ctx.model_axis]
        return (SH.SeqShard(self.ctx.mesh, self.ctx.model_axis)
                if m > 1 and t % m == 0 else None)

    def _bshard(self, x, seq=None):
        """This rank's block of a global activation [B, T, ...]: the batch
        as `batch_spec` splits it and, with `seq`, the sequence over the
        model axis (a slice; every rank holds the global tensor)."""
        if self.ctx is None:
            return x
        spec = SH.batch_spec(self.ctx, x.shape[0], x.ndim)
        if seq is not None:
            spec = SH.Spec((spec[0], self.ctx.model_axis) + spec[2:])
        return SH.local_shard(x, self.ctx.mesh, spec)

    def _logits_shard(self, logits, batch: int, seq=None):
        """The global logits, which every rank returns, from this rank's
        block (batch rows as `batch_spec` splits `batch`, and the sequence
        block with `seq`; the vocabulary is whole on every rank)."""
        if self.ctx is None:
            return logits
        if seq is not None:
            logits = seq.gather(logits)
        bs = SH.batch_spec(self.ctx, batch, logits.ndim)[0]
        return SH.gather_dim(logits, self.ctx.mesh, bs, 0) if bs else logits

    def _cache_in(self, entry, spec):
        """A layer's cache entry of DTensors as its functions take it:
        (entry, ctx).  A self-attention cache sharded over the model axis
        (attention: along its sequence or its kv heads; MLA: along its
        sequence) stays this rank's blocks and ctx is returned (decode
        runs on the blocks); every other leaf, the Mamba2 state and conv
        window and the cross (k, v), is gathered to the batch block (ctx
        None)."""
        from torch.distributed.tensor import Replicate
        leaves = T.leaves(entry)
        dist = spec["kind"] in ("attn", "mla") and any(
            p.is_shard() and p.dim in (1, 2) for p in leaves[0].placements)
        out = []
        for j, c in enumerate(leaves):
            if dist and j < 2:
                out.append(c.to_local())
            else:
                keep = [p if p.is_shard() and p.dim == 0 else Replicate()
                        for p in c.placements]
                out.append(c.redistribute(c.device_mesh, keep).to_local())
        return T.unflatten(entry, out), (self.ctx if dist else None)

    def _place_cache(self, entry, axes, batch: int):
        """A layer's cache entry of batch blocks (whole otherwise) as
        DTensors laid out by `cache_specs`' rules; DTensor leaves pass as
        they are."""
        from torch.distributed.tensor import DTensor
        ctx = self.ctx
        rules = SH.cache_ctx(self.cfg, ctx).rules(for_weights=False)
        sizes, mesh = ctx.mesh_shape, ctx.mesh
        out = []
        for t, ax in zip(T.leaves(entry),
                         T.leaves(axes, is_leaf=SH.is_axes_leaf)):
            if not isinstance(t, DTensor):
                spec = SH._spec_for(ax, (batch,) + tuple(t.shape[1:]), rules,
                                    sizes)
                t = DTensor.from_local(
                    SH.local_shard(t, mesh, SH.Spec((None,) + spec[1:])),
                    mesh, SH.placements(mesh, spec), run_check=False)
            out.append(t)
        return T.unflatten(entry, out)

    def _encode(self, p, frames, part=()):
        """The encoder over frame embeddings [B, Te, D]: non-causal
        attention with rope, never the flash kernel, then enc_norm.  Not
        checkpointed in training, as the reference scans it without
        `jax.checkpoint`."""
        if frames is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder: it "
                             f"needs frames [B, T, d_model]")
        cfg = self.cfg
        x = self._bshard(frames.to(device=self.device,
                                   dtype=cfg.compute_dtype))
        b, t, _ = x.shape
        positions = torch.arange(t, device=x.device)[None].expand(b, t)
        for lp in p["enc_layers"]:
            lp = self._at_use(lp, part)
            h = L.rms_norm(lp["ln1"], x)
            out, _ = L.attention(lp["attn"], h, cfg, positions=positions,
                                 causal=False)
            x = x + out
            x = x + L.mlp(lp["mlp"], L.rms_norm(lp["ln2"], x))
        return L.rms_norm({"w": SH.full(p["enc_norm"]["w"], part)}, x)

    def _run_layers(self, p, x, *, positions, caches, cache_pos,
                    enc_out=None, build=False, batch=None, seq=None):
        """-> (x, new caches in layer order, summed aux or None).  With a
        ctx, `batch` is the global batch, `seq` the sequence split, and
        the caches are DTensors (in and out)."""
        from torch.distributed.tensor import DTensor
        cfg, ctx = self.cfg, self.ctx
        moe_apply = (make_moe_apply(cfg, ctx, batch=batch, seq=seq)
                     if cfg.n_experts else None)
        axes = (self.cache_logical_axes(None)
                if ctx is not None and (build or caches is not None)
                else None)
        new_caches, aux = [], None
        for i, spec in enumerate(self.specs):
            c = caches[i] if caches is not None else None
            attn_ctx = None
            if ctx is not None and c is not None:
                old, (c, attn_ctx) = c, self._cache_in(c, spec)
            x, nc, a = apply_layer(spec, self._at_use(p["layers"][i]), x,
                                   cfg, positions=positions, cache=c,
                                   cache_pos=cache_pos, enc_out=enc_out,
                                   moe_apply=moe_apply, build=build,
                                   attn_ctx=attn_ctx, seq=seq)
            if axes is not None:
                if attn_ctx is not None:       # the blocks stay in place
                    olds = T.leaves(old)
                    nc = (tuple(DTensor.from_local(
                        t, ctx.mesh, o.placements, run_check=False)
                        for t, o in zip(nc[0], olds)),) + nc[1:]
                nc = self._place_cache(nc, axes[i], batch)
            new_caches.append(nc)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, new_caches, aux

    def _train_layers(self, p, x, positions, enc_out=None, *, batch=None,
                      seq=None, part=()):
        """The layers with autograd, each one checkpointed as `cfg.remat`
        says ("full": recomputed whole in the backward pass, "dots": the
        matmul outputs kept, "none": every activation kept).  Returns (x,
        summed aux or None); aux and the encoder output pass through the
        checkpoints like x.  With a ctx, x is this rank's block, `batch`
        the global batch, `seq` the sequence split and `part` the axes of
        `_grad_axes`; a layer's parameters are gathered inside its
        checkpoint, so "full" gathers them again in the backward pass."""
        remat = self.cfg.remat
        if remat not in ("full", "dots", "none"):
            raise ValueError(f"remat must be full, dots or none, not "
                             f"{remat!r}")
        moe_apply = (make_moe_apply(self.cfg, self.ctx, batch=batch, seq=seq)
                     if self.cfg.n_experts else None)
        aux = None
        for spec, lp in zip(self.specs, p["layers"]):
            def layer(x, enc_out, spec=spec, lp=lp):
                x, _, a = apply_layer(spec, self._at_use(lp, part), x,
                                      self.cfg, positions=positions,
                                      cache=None, cache_pos=None,
                                      enc_out=enc_out, moe_apply=moe_apply,
                                      seq=seq)
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

    def _embed(self, p, tokens, part=()):
        return SH.full(p["embed"], part)[tokens].to(self.cfg.compute_dtype)

    def _start(self, p, tokens, frames, seq=None, part=()):
        """(embedded tokens, positions, encoder output or None); with a
        ctx, of this rank's block of `tokens`."""
        b, t = tokens.shape
        positions = torch.arange(t, device=self.device)[None].expand(b, t)
        tokens, positions = self._bshard(tokens, seq), \
            self._bshard(positions, seq)
        x = self._embed(p, tokens, part)
        enc_out = self._encode(p, frames, part) if self.cross else None
        return x, positions, enc_out

    def _head(self, p, x, part=()):
        """final_norm, then the logits against the embedding."""
        x = L.rms_norm({"w": SH.full(p["final_norm"]["w"], part)}, x)
        return x @ SH.full(p["embed"], part).T

    # ---- entry points -----------------------------------------------------
    @torch.no_grad()
    def logits_fn(self, tokens, frames=None, *, return_aux=False):
        """Full forward: tokens [B, T] (and, for an encoder-decoder, frames
        [B, Te, D]) -> logits [B, T, V] (the training and prefill math).
        With `return_aux`, (logits, aux): the MoE layers' summed
        load-balancing loss, a float32 scalar (0 without MoE layers), as
        the JAX package's `logits_fn` returns it."""
        p = self._cast()
        seq = self._seq(tokens.shape[1])
        x, positions, enc_out = self._start(p, tokens, frames, seq)
        x, _, aux = self._run_layers(p, x, positions=positions, caches=None,
                                     cache_pos=None, enc_out=enc_out,
                                     batch=tokens.shape[0], seq=seq)
        logits = self._logits_shard(self._head(p, x), tokens.shape[0], seq)
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
        in float32.  With a ctx, `params` are DTensors laid out as
        `param_tree()`'s, the batch is global (the same on every rank),
        each rank runs its block (and its sequence block under sequence
        parallelism) through the layers and sums its tokens' terms, and
        the sums are all-reduced; the gradients are those of the global
        loss in the parameters' layout (`sharding.full`'s rule)."""
        cd = self.cfg.compute_dtype
        p = T.tree_map(lambda t: _to_compute(t, cd), params)
        tokens = batch["tokens"].long()
        labels = batch["labels"].long()
        seq = self._seq(tokens.shape[1])
        part = self._grad_axes(tokens.shape[0], seq)
        x, positions, enc_out = self._start(p, tokens, batch.get("frames"),
                                            seq, part)
        x, aux = self._train_layers(p, x, positions, enc_out,
                                    batch=tokens.shape[0], seq=seq,
                                    part=part)
        labels = self._bshard(labels, seq)
        logp = torch.log_softmax(self._head(p, x, part).float(), dim=-1)
        ll = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
        mask = (labels >= 0).float()
        sums = torch.stack([(ll * mask).sum(), mask.sum()])
        if part:
            sums = SH.all_reduce(sums, self.ctx.mesh, part)
        loss = -sums[0] / torch.clamp(sums[1], min=1.0)
        return loss if aux is None else loss + 0.01 * aux

    @torch.no_grad()
    def prefill(self, tokens, frames=None):
        """Full forward that also builds the decode caches: tokens [B, T]
        (and frames [B, Te, D] for an encoder-decoder) -> (logits [B, V]
        of the last position, caches)."""
        p = self._cast()
        b, t = tokens.shape
        seq = self._seq(t)
        x, positions, enc_out = self._start(p, tokens, frames, seq)
        x, caches, _ = self._run_layers(p, x, positions=positions,
                                        caches=None, cache_pos=None,
                                        enc_out=enc_out, build=True,
                                        batch=b, seq=seq)
        if seq is not None:
            x = seq.gather(x)
        return self._logits_shard(self._head(p, x[:, -1]), b), caches

    def cache_logical_axes(self, dims=None) -> list:
        """Logical-axis tree mirroring `init_cache`'s structure (one entry
        per layer, in layer order; no "layers" axis, the port does not
        stack layers).  `dims` is unused, as in the reference."""
        kv = ("batch", "seq", "kv", "qkv")
        out = []
        for spec in self.specs:
            if spec["kind"] == "attn":
                c = ((kv, kv),)
            elif spec["kind"] == "mla":
                c = ((("batch", "seq", None), ("batch", "seq", None)),)
            else:
                c = (("batch", "heads", None, None), ("batch", None, "mlp"))
            if self.cross:
                c = c + ((kv, kv),)
            out.append(c)
        return out

    def cache_shapes(self, dims: DecodeDims) -> list:
        """`init_cache`'s tree as meta tensors (whole, no allocation)."""
        return self._zero_caches(dims, torch.device("meta"))

    def init_cache(self, dims: DecodeDims) -> list:
        """Zero decode caches for every layer, in layer order: ((k, v),)
        [B, S, KV, hd] for attention (S clipped to a local layer's
        window), ((c_kv [B, S, kv_lora], k_rope [B, S, rope_dim]),) for
        MLA, (state [B, H, N, P] f32, conv [B, K-1, conv_dim]) for Mamba2;
        an encoder-decoder's layers end with the cross (k, v) [B, S, KV,
        hd].  With a ctx, DTensors of which this rank allocates only its
        blocks, laid out by `launch.steps.cache_specs`."""
        if self.ctx is None:
            return self._zero_caches(dims, self.device)
        from torch.distributed.tensor import DTensor
        from ..launch.steps import cache_specs
        shapes, shardings = cache_specs(self, dims, self.ctx)
        return T.unflatten(shapes, [
            DTensor.from_local(torch.zeros(sh.shard_shape(t.shape),
                                           dtype=t.dtype, device=self.device),
                               sh.mesh, sh.placements, run_check=False)
            for t, sh in zip(T.leaves(shapes),
                             T.leaves(shardings, is_leaf=SH.is_sharding))])

    def _zero_caches(self, dims: DecodeDims, dev) -> list:
        cfg = self.cfg
        b, s = dims.batch, dims.seq
        dt = cfg.compute_dtype

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
        x = self._embed(p, self._bshard(tokens))
        positions = torch.full((x.shape[0], 1), pos, dtype=torch.int64,
                               device=x.device)
        x, new_caches, _ = self._run_layers(p, x, positions=positions,
                                            caches=caches, cache_pos=pos,
                                            batch=b)
        return self._logits_shard(self._head(p, x), b), new_caches


def param_axes(tree: dict, cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of a parameter tree shaped like
    `Model.param_tree()` (the reference's `Boxed` annotations, without
    the "layers" axis its stacked blocks add)."""
    specs = cfg.layer_specs()
    groups = {"ln1": L.RMSNORM_AXES, "ln2": L.RMSNORM_AXES,
              "ln_x": L.RMSNORM_AXES, "xattn": L.ATTENTION_AXES,
              "mlp": L.MLP_AXES, "moe": L.MOE_AXES, "ssm": S.MAMBA2_AXES}

    def layer(lp, spec):
        out = {}
        for g, grp in lp.items():
            table = groups.get(g) if g != "attn" else (
                L.MLA_AXES if spec["kind"] == "mla" else L.ATTENTION_AXES)
            out[g] = {n: table[n] for n in grp}
        return out

    out = {"embed": ("vocab", "embed"), "final_norm": dict(L.RMSNORM_AXES),
           "layers": [layer(lp, sp) for lp, sp in zip(tree["layers"],
                                                      specs)]}
    if "enc_layers" in tree:
        out["enc_layers"] = [layer(lp, ENC_SPEC) for lp in tree["enc_layers"]]
        out["enc_norm"] = dict(L.RMSNORM_AXES)
    return out
