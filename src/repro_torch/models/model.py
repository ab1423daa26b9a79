"""The decoder model family of the port (serving path).

`ModelConfig` carries every field of the JAX package's config, with
torch dtypes.  `Model` is an `nn.Module` whose layers sit in an
`nn.ModuleList` in true layer order; the JAX package stacks them per
pattern slot and runs a `lax.scan` over repetitions, so its layer
`rep * len(pattern) + slot` is the port's `layers[i]` at that index,
then the tail.  The port has the GQA (+ qk-norm, sliding window) and
Mamba2 decoders' `logits_fn`, `prefill`, `init_cache` and `decode_step`
(no loss, no backward): qwen3-1.7b, gemma3-1b, starcoder2-3b,
chameleon-34b and mamba2-1.3b build; MLA, MoE and the encoder-decoder
raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from . import layers as L
from . import ssm as S

NOT_PORTED = "not ported yet (ROADMAP Queue 1)"


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


@dataclasses.dataclass(frozen=True)
class DecodeDims:
    """Cache geometry for serve steps."""
    batch: int
    seq: int          # cache length (== shape's seq_len)


# =====================================================================
# single layer
# =====================================================================

def init_layer(gen, spec, cfg: ModelConfig) -> dict:
    """{group: {name: tensor}} of one layer, as the JAX package's tree."""
    dt = cfg.param_dtype
    p = {"ln1": L.init_rmsnorm(gen, cfg.d_model, dt)}
    if spec["kind"] == "attn":
        p["attn"] = L.init_attention(gen, cfg, dt)
    elif spec["kind"] == "mamba":
        p["ssm"] = S.init_mamba2(gen, cfg, dt)
    else:
        raise NotImplementedError(f"{spec['kind']} layers are {NOT_PORTED}")
    if spec["moe"]:
        raise NotImplementedError(f"MoE layers are {NOT_PORTED}")
    if spec["mlp"]:
        p["ln2"] = L.init_rmsnorm(gen, cfg.d_model, dt)
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def apply_layer(spec, p, x, cfg: ModelConfig, *, positions, cache,
                cache_pos, build=False):
    h = L.rms_norm(p["ln1"], x)
    if spec["kind"] == "attn":
        c_self = cache[0] if cache is not None else None
        out, nc = L.attention(
            p["attn"], h, cfg, positions=positions, cache=c_self,
            cache_pos=cache_pos, window=spec["window"] or None,
            use_flash=cfg.use_flash_kernel, build_cache=build)
        new_cache = (nc,)
    else:
        st = cache[0] if cache is not None else None
        cc = cache[1] if cache is not None else None
        out, new_cache = S.mamba2_block(
            p["ssm"], h, cfg, state=st, conv_cache=cc,
            use_kernel=cfg.use_ssd_kernel, build_cache=build)
    x = x + out
    if spec["mlp"]:
        h2 = L.rms_norm(p["ln2"], x)
        x = x + L.mlp(p["mlp"], h2)
    return x, new_cache


# =====================================================================
# full model
# =====================================================================

class Model(nn.Module):
    """Decoder LM.  `Model(cfg)` is empty; `init(generator)` draws the
    parameters on the generator's device (or `convert.
    params_from_reference` loads the JAX package's)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.arch_kind != "decoder":
            raise NotImplementedError(f"{cfg.arch_kind} models are "
                                      f"{NOT_PORTED}")
        if cfg.attn_kind == "mla" or cfg.n_experts:
            raise NotImplementedError(f"MLA and MoE are {NOT_PORTED}")
        self.cfg = cfg
        self.specs = cfg.layer_specs()
        self.register_parameter("embed", None)
        self.final_norm = nn.ParameterDict()
        self.layers = nn.ModuleList()
        self._compute = None

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        cfg = self.cfg
        self.embed = nn.Parameter(L._norm(generator, (cfg.vocab, cfg.d_model),
                                          dtype=cfg.param_dtype))
        self.final_norm = nn.ParameterDict(
            L.init_rmsnorm(generator, cfg.d_model, cfg.param_dtype))
        self.layers = nn.ModuleList(
            nn.ModuleDict({g: nn.ParameterDict(ps) for g, ps in
                           init_layer(generator, spec, cfg).items()})
            for spec in self.specs)
        self._compute = None
        return self

    # The JAX package casts every float32 parameter to the compute dtype
    # on every call (`Model._cast`).  Serving keeps one compute-dtype copy
    # instead, made at the first call after `init`, `load_state_dict`, a
    # move between devices or a change of `cfg.compute_dtype`; it rounds
    # the same parameters (a_log, dt_bias, d_skip and the norm weights
    # too).  Change parameters only through those, or the copy goes stale.
    def _apply(self, fn, *args, **kwargs):
        self._compute = None
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._compute = None
        return super().load_state_dict(*args, **kwargs)

    def _cast(self) -> dict:
        if self.embed is None:
            raise RuntimeError("the model has no parameters: call "
                               "init(generator) first")
        cd = self.cfg.compute_dtype
        if self._compute is None or self._compute["dtype"] != cd:
            self._compute = None                  # free the old copy first

            def c(t):
                t = t.detach()
                return t.to(cd) if t.dtype == torch.float32 else t

            self._compute = dict(
                dtype=cd, embed=c(self.embed),
                final_norm={k: c(v) for k, v in self.final_norm.items()},
                layers=[{g: {k: c(v) for k, v in grp.items()}
                         for g, grp in layer.items()}
                        for layer in self.layers])
        return self._compute

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _run_layers(self, p, x, *, positions, caches, cache_pos,
                    build=False):
        new_caches = []
        for i, spec in enumerate(self.specs):
            c = caches[i] if caches is not None else None
            x, nc = apply_layer(spec, p["layers"][i], x, self.cfg,
                                positions=positions, cache=c,
                                cache_pos=cache_pos, build=build)
            new_caches.append(nc)
        return x, new_caches

    def _embed(self, p, tokens):
        return p["embed"][tokens].to(self.cfg.compute_dtype)

    # ---- entry points -----------------------------------------------------
    @torch.no_grad()
    def logits_fn(self, tokens):
        """Full forward: tokens [B, T] -> logits [B, T, V] (the training
        and prefill math).  The JAX package also returns the MoE aux
        loss, which is 0 for the ported archs."""
        p = self._cast()
        b, t = tokens.shape
        x = self._embed(p, tokens)
        positions = torch.arange(t, device=x.device)[None].expand(b, t)
        x, _ = self._run_layers(p, x, positions=positions, caches=None,
                                cache_pos=None)
        x = L.rms_norm(p["final_norm"], x)
        return x @ p["embed"].T

    @torch.no_grad()
    def prefill(self, tokens):
        """Full forward that also builds the decode caches: tokens [B, T]
        -> (logits [B, V] of the last position, caches)."""
        p = self._cast()
        b, t = tokens.shape
        x = self._embed(p, tokens)
        positions = torch.arange(t, device=x.device)[None].expand(b, t)
        x, caches = self._run_layers(p, x, positions=positions, caches=None,
                                     cache_pos=None, build=True)
        x = L.rms_norm(p["final_norm"], x)
        return x[:, -1] @ p["embed"].T, caches

    def init_cache(self, dims: DecodeDims) -> list:
        """Zero decode caches for every layer, in layer order: (k, v)
        [B, S, KV, hd] for attention (S clipped to a local layer's
        window), (state [B, H, N, P] f32, conv [B, K-1, conv_dim]) for
        Mamba2."""
        cfg = self.cfg
        b, s = dims.batch, dims.seq
        dt, dev = cfg.compute_dtype, self.device
        caches = []
        for spec in self.specs:
            if spec["kind"] == "attn":
                sz = min(s, spec["window"]) if spec["window"] else s
                shape = (b, sz, cfg.n_kv_heads, cfg.hd)
                caches.append(((torch.zeros(shape, dtype=dt, device=dev),
                                torch.zeros(shape, dtype=dt, device=dev)),))
            else:
                d_in = cfg.ssm_expand * cfg.d_model
                h = d_in // cfg.ssm_head_dim
                caches.append((
                    torch.zeros((b, h, cfg.ssm_state, cfg.ssm_head_dim),
                                dtype=torch.float32, device=dev),
                    torch.zeros((b, cfg.ssm_conv - 1, d_in + 2 * cfg.ssm_state),
                                dtype=dt, device=dev)))
        return caches

    @torch.no_grad()
    def decode_step(self, caches, tokens, pos: int):
        """One serving step: tokens [B, 1] at absolute position `pos`
        against caches -> (logits [B, 1, V], caches).  Each attention
        cache ring is written at `pos % its_length` in place; Mamba2
        states and conv caches are replaced."""
        p = self._cast()
        b = tokens.shape[0]
        x = self._embed(p, tokens)
        positions = torch.full((b, 1), pos, dtype=torch.int64,
                               device=x.device)
        x, new_caches = self._run_layers(p, x, positions=positions,
                                         caches=caches, cache_pos=pos)
        x = L.rms_norm(p["final_norm"], x)
        return x @ p["embed"].T, new_caches
