"""Flux.1 rectified-flow transformer (schnell / dev).

Beyond-reference model family: the black-forest-labs Flux architecture —
19 double-stream (img/txt) blocks + 38 single-stream blocks at width 3072,
24 heads of 128, 3-axis rotary position embeddings (axes_dim [16,56,56]
over (id, y, x)), qk RMSNorm, T5 context + CLIP-L pooled conditioning, and
(dev) an embedded guidance input replacing CFG.  Transcribed from the
public flux reference semantics, built like models/mmdit.py: fused-qkv
matmuls through ``B.linear`` (int8/int4 weight-only capable), joint
attention through the shared dispatch in ops/attention.py, modulation
vectors in f32.

Param names mirror the bare flux checkpoint tails under the internal
``flux.`` prefix (``flux.double_blocks.0.img_attn.qkv.weight`` ...).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..ops.attention import attention
from . import blocks as B


@dataclass(frozen=True)
class FluxParams:
    depth_double: int = 19
    depth_single: int = 38
    d_model: int = 3072
    n_head: int = 24
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: float = 10000.0
    n_ch_in: int = 64           # packed 2x2 patches of the 16-ch latent
    n_ch_out: int = 64
    d_ctx_in: int = 4096        # t5 width
    d_pooled: int = 768         # clip-L pooled
    mlp_ratio: int = 4
    guidance_embed: bool = False   # dev: True (distilled guidance input)
    # fields the session/sampler read (shared with UnetParams/MmditParams)
    n_ctx: int = 4096
    ch_adm_in: int = 768
    cond_label: bool = True
    uncond_empty_zero: bool = False
    clip_norm: bool = False
    vparam: bool = False
    n_step_train: int = 1000
    flow: bool = True
    flux: bool = True
    # dynamic resolution-dependent schedule shift: shift = exp(mu) with
    # mu = lerp over image seq len between (256, base) and (4096, max)
    flow_shift: float = 1.0     # schnell: no shift
    shift_base: float = 0.5     # dev dynamic-shift endpoints
    shift_max: float = 1.15
    dynamic_shift: bool = False

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_head


FLUX_SCHNELL = FluxParams()
FLUX_DEV = FluxParams(guidance_embed=True, dynamic_shift=True)


def dynamic_flow_shift(P: FluxParams, h_lat: int, w_lat: int) -> float:
    """exp(mu) for the resolution-dependent schedule shift (dev/pro);
    seq len counts packed 2x2 patches."""
    if not P.dynamic_shift:
        return P.flow_shift
    seq = (h_lat // 2) * (w_lat // 2)
    m = (P.shift_max - P.shift_base) / (4096 - 256)
    mu = P.shift_base + m * (seq - 256)
    return float(math.exp(mu))


def rope_tables(P: FluxParams, hp: int, wp: int, s_txt: int):
    """Host-side rotary tables for the (txt ++ img) sequence.

    Returns (cos, sin) float32 [S, d_head//2]: per-position rotation angles
    laid out axis-by-axis (axes_dim pairs).  txt ids are all-zero (the flux
    convention); img ids are (0, y, x)."""
    ids = np.zeros((s_txt + hp * wp, 3), np.float64)
    yy, xx = np.mgrid[0:hp, 0:wp]
    ids[s_txt:, 1] = yy.reshape(-1)
    ids[s_txt:, 2] = xx.reshape(-1)
    parts_cos, parts_sin = [], []
    for ax, dim in enumerate(P.axes_dim):
        half = dim // 2
        freqs = 1.0 / (P.theta ** (np.arange(half, dtype=np.float64) * 2
                                   / dim))
        ang = ids[:, ax:ax + 1] * freqs[None, :]
        parts_cos.append(np.cos(ang))
        parts_sin.append(np.sin(ang))
    cos = np.concatenate(parts_cos, axis=-1).astype(np.float32)
    sin = np.concatenate(parts_sin, axis=-1).astype(np.float32)
    return cos, sin


def _rope_apply(x, cos, sin):
    """x: [N,S,H,D]; rotate interleaved pairs (x_even, x_odd) by the
    per-position angles (flux convention: pairs are adjacent elements)."""
    xf = x.astype(jnp.float32)
    x_even = xf[..., 0::2]
    x_odd = xf[..., 1::2]
    c = cos[None, :, None]
    s = sin[None, :, None]
    out_even = x_even * c - x_odd * s
    out_odd = x_even * s + x_odd * c
    out = jnp.stack([out_even, out_odd], axis=-1)
    return out.reshape(x.shape).astype(x.dtype)


def _rms(ctx: B.Ctx, name: str, x, eps: float = 1e-6):
    """Flux RMSNorm (scale only, f32 statistics)."""
    xf = x.astype(jnp.float32)
    n = xf * jax_rsqrt(jnp.mean(xf * xf, axis=-1, keepdims=True) + eps)
    w = ctx.param(name + ".scale", (x.shape[-1],), B.VEC, jnp.float32)
    return (n * w.astype(jnp.float32)).astype(x.dtype)


def jax_rsqrt(v):
    return jnp.reciprocal(jnp.sqrt(v))


def _qkv_split(ctx: B.Ctx, pre: str, x, P: FluxParams):
    """Fused qkv -> per-head q/k/v with flux qk RMSNorm."""
    d, h, dh = P.d_model, P.n_head, P.d_head
    y = B.linear(ctx, pre + ".qkv", x, 3 * d)
    n, s = y.shape[0], y.shape[1]
    y = y.reshape(n, s, 3, h, dh)
    q, k, v = y[:, :, 0], y[:, :, 1], y[:, :, 2]
    q = _rms(ctx, pre + ".norm.query_norm", q)
    k = _rms(ctx, pre + ".norm.key_norm", k)
    return q, k, v


def _attn_proj(ctx: B.Ctx, pre: str, o, P: FluxParams):
    n, s = o.shape[0], o.shape[1]
    o2 = o.reshape(n, s, P.d_model)
    return B.linear(ctx, pre + ".proj", o2, P.d_model)


def _mlp_embed(ctx: B.Ctx, pre: str, x, d_out: int):
    """MLPEmbedder: in_layer -> silu -> out_layer."""
    x = B.linear(ctx, pre + ".in_layer", x, d_out)
    return B.linear(ctx, pre + ".out_layer", B.silu(x), d_out)


def _modulation(ctx: B.Ctx, pre: str, vec, n_chunks: int, d: int):
    """silu(vec) -> lin -> n_chunks [N,d] f32 vectors."""
    y = B.linear(ctx, pre + ".lin", B.silu(vec), n_chunks * d)
    y = y.astype(jnp.float32)
    return [y[:, i * d:(i + 1) * d] for i in range(n_chunks)]


def _mod_apply(x, shift, scale):
    dt = x.dtype
    return x * (1.0 + scale[:, None, :]).astype(dt) \
        + shift[:, None, :].astype(dt)


def _ln(x):
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    return ((xf - mean) * jax_rsqrt(var + 1e-6)).astype(x.dtype)


def double_block(ctx: B.Ctx, pre: str, img, txt, vec, cos, sin,
                 P: FluxParams):
    """Double-stream block: separate img/txt qkv+mlp, one joint attention
    over (txt ++ img) with RoPE."""
    d = P.d_model
    (i_sh1, i_sc1, i_g1,
     i_sh2, i_sc2, i_g2) = _modulation(ctx, pre + ".img_mod", vec, 6, d)
    (t_sh1, t_sc1, t_g1,
     t_sh2, t_sc2, t_g2) = _modulation(ctx, pre + ".txt_mod", vec, 6, d)

    iq, ik, iv = _qkv_split(ctx, pre + ".img_attn",
                            _mod_apply(_ln(img), i_sh1, i_sc1), P)
    tq, tk, tv = _qkv_split(ctx, pre + ".txt_attn",
                            _mod_apply(_ln(txt), t_sh1, t_sc1), P)
    st = txt.shape[1]
    q = jnp.concatenate([tq, iq], axis=1)
    k = jnp.concatenate([tk, ik], axis=1)
    v = jnp.concatenate([tv, iv], axis=1)
    q = _rope_apply(q, cos, sin)
    k = _rope_apply(k, cos, sin)
    o = attention(q, k, v)

    img = img + (i_g1[:, None, :]).astype(img.dtype) * _attn_proj(
        ctx, pre + ".img_attn", o[:, st:], P)
    h = _mod_apply(_ln(img), i_sh2, i_sc2)
    h = B.linear(ctx, pre + ".img_mlp.0", h, P.mlp_ratio * d)
    h = B.linear(ctx, pre + ".img_mlp.2", B.gelu_tanh(h), d)
    img = img + (i_g2[:, None, :]).astype(img.dtype) * h

    txt = txt + (t_g1[:, None, :]).astype(txt.dtype) * _attn_proj(
        ctx, pre + ".txt_attn", o[:, :st], P)
    h = _mod_apply(_ln(txt), t_sh2, t_sc2)
    h = B.linear(ctx, pre + ".txt_mlp.0", h, P.mlp_ratio * d)
    h = B.linear(ctx, pre + ".txt_mlp.2", B.gelu_tanh(h), d)
    txt = txt + (t_g2[:, None, :]).astype(txt.dtype) * h
    return img, txt


def single_block(ctx: B.Ctx, pre: str, x, vec, cos, sin, P: FluxParams):
    """Single-stream block: parallel attention + MLP from one linear1,
    merged back through linear2."""
    d = P.d_model
    h, dh = P.n_head, P.d_head
    mlp_d = P.mlp_ratio * d
    sh, sc, gate = _modulation(ctx, pre + ".modulation", vec, 3, d)
    xm = _mod_apply(_ln(x), sh, sc)
    y = B.linear(ctx, pre + ".linear1", xm, 3 * d + mlp_d)
    qkv, mlp = y[..., :3 * d], y[..., 3 * d:]
    n, s = y.shape[0], y.shape[1]
    qkv = qkv.reshape(n, s, 3, h, dh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = _rms(ctx, pre + ".norm.query_norm", q)
    k = _rms(ctx, pre + ".norm.key_norm", k)
    q = _rope_apply(q, cos, sin)
    k = _rope_apply(k, cos, sin)
    o = attention(q, k, v).reshape(n, s, d)
    cat = jnp.concatenate([o, B.gelu_tanh(mlp)], axis=-1)
    out = B.linear(ctx, pre + ".linear2", cat, d)
    return x + (gate[:, None, :]).astype(x.dtype) * out


def _dc_split(depth_double: int) -> int:
    """Block-cache split point (--deepcache): the first ``k`` DOUBLE
    blocks are the always-recomputed shallow prefix; the remaining
    doubles plus the whole single-stream stack are the deep tail whose
    residual on the concatenated (txt ++ img) sequence is cached between
    refresh steps (same Delta-DiT-style scheme as models/mmdit.py).
    k = depth_double//8 keeps ~90% of block work cacheable on dev
    (2 of 19 doubles recompute; all 38 singles ride the cache)."""
    return max(1, depth_double // 8)


def flux_apply(ctx: B.Ctx, x, t, cond, pooled, P: FluxParams,
               pre: str = "flux", guidance=None, skip_layers=(),
               want_cache: bool = False, use_cache=None):
    """Flux forward.  x: [N,H,W,16] NHWC latent, t: [N] (sigma * 1000 —
    the embedder divides by 1000 to flux's native [0,1] time), cond:
    [N,S,4096] T5 context, pooled: [N,768] CLIP-L pooled, ``guidance``:
    [N] embedded-guidance values (dev) or None.  Returns [N,H,W,16].

    ``skip_layers`` (skip-layer guidance): block indices elided from the
    forward — 0..depth_double-1 name double blocks, depth_double..
    depth_double+depth_single-1 name single blocks.

    ``want_cache``/``use_cache`` (--deepcache): the deep tail's residual
    on the concatenated (txt ++ img) token stream — everything after the
    first ``_dc_split(depth_double)`` double blocks — is returned as the
    cache / reused in place of the tail.  The t-dependent final-layer
    modulation always recomputes.  The residual reconstruction matches
    the full forward to f.p. rounding (not bit-exact; see mmdit.py)."""
    dtype = ctx.dtype
    n, hh, ww, _ = x.shape
    hp, wp = hh // 2, ww // 2
    d = P.d_model
    x = x.astype(dtype)

    # pack 2x2 patches -> [N, hp*wp, 4*ch] (flux's latent packing)
    cl = P.n_ch_in // 4
    img = x.reshape(n, hp, 2, wp, 2, cl).transpose(0, 1, 3, 2, 4, 5)
    img = img.reshape(n, hp * wp, P.n_ch_in)
    img = B.linear(ctx, pre + ".img_in", img, d)
    txt = B.linear(ctx, pre + ".txt_in", cond.astype(dtype), d)

    tf = jnp.asarray(t, jnp.float32) / float(P.n_step_train)
    vec = _mlp_embed(ctx, pre + ".time_in",
                     B.timestep_embedding(tf * 1000.0, 256).astype(dtype), d)
    if P.guidance_embed:
        g = (jnp.zeros((n,), jnp.float32) if guidance is None
             else jnp.broadcast_to(jnp.asarray(guidance, jnp.float32), (n,)))
        vec = vec + _mlp_embed(
            ctx, pre + ".guidance_in",
            B.timestep_embedding(g * 1000.0, 256).astype(dtype), d)
    vec = vec + _mlp_embed(ctx, pre + ".vector_in",
                           pooled.astype(dtype), d)

    s_txt = cond.shape[1]
    cos_np, sin_np = rope_tables(P, hp, wp, int(s_txt))
    cos, sin = jnp.asarray(cos_np), jnp.asarray(sin_np)

    stacked = f"{pre}.double_blocks_p."
    if any(k.startswith(stacked) for k in ctx.params):
        if want_cache or use_cache is not None:
            # backstop (api._deepcache_check rejects mesh combos pre-trace)
            raise ValueError(
                "deepcache is not supported with --pp stacking")
        if skip_layers:
            # backstop (api._guidance_checks rejects slg+pp pre-trace)
            raise ValueError(
                "skip-layer guidance is not supported with --pp stacking")
        # pipeline-parallel block stacks (--pp): two chained GPipe passes
        # (double-stream, then single-stream), each over [pp, L, ...]
        # slabs zero-padded to a pp multiple (zero blocks are exact
        # identities through the modulation gates — see
        # api._stack_pipeline_blocks_flux).  The activation pytree is kept
        # uniform by carrying the concatenated (txt ++ img) sequence and
        # splitting inside the double block body; cos/sin are
        # sample-independent and ride as closures (replicated).
        from ..ops import attention as attn_mod
        from ..parallel import pipeline as pl
        plan = pl.PLAN

        def _slab(which):
            p = f"{pre}.{which}_p."
            return {k[len(p) - 1:]: v for k, v in ctx.params.items()
                    if k.startswith(p)}

        def dblock_fn(pj, acts):
            xx_, vec_ = acts
            bctx = B.Ctx(pj, dtype=ctx.dtype)
            with attn_mod.local_only():
                i2, t2 = double_block(bctx, "", xx_[:, s_txt:],
                                      xx_[:, :s_txt], vec_, cos, sin, P)
            return (jnp.concatenate([t2, i2], axis=1), vec_)

        def sblock_fn(pj, acts):
            xx_, vec_ = acts
            bctx = B.Ctx(pj, dtype=ctx.dtype)
            with attn_mod.local_only():
                x2 = single_block(bctx, "", xx_, vec_, cos, sin, P)
            return (x2, vec_)

        xx_ = jnp.concatenate([txt, img], axis=1)
        xx_ = pl.pipeline_apply(plan.mesh, dblock_fn, _slab("double_blocks"),
                                (xx_, vec), n_micro=plan.n_micro, collect=0)
        xx_ = pl.pipeline_apply(plan.mesh, sblock_fn, _slab("single_blocks"),
                                (xx_, vec), n_micro=plan.n_micro, collect=0)
    else:
        dc = want_cache or use_cache is not None
        if dc and skip_layers:
            # raise, not assert: survives python -O (same rationale as
            # the joint-stack backstop above)
            raise ValueError("deepcache: incompatible with skip_layers")
        split = _dc_split(P.depth_double) if dc else P.depth_double
        for i in range(split):
            if i in skip_layers:
                continue
            img, txt = double_block(ctx, f"{pre}.double_blocks.{i}", img,
                                    txt, vec, cos, sin, P)
        xx_ = jnp.concatenate([txt, img], axis=1)
        xx_shallow = xx_ if want_cache else None
        if use_cache is not None:
            xx_ = xx_ + use_cache.astype(xx_.dtype)
        else:
            for i in range(split, P.depth_double):
                if i in skip_layers:
                    continue
                img, txt = double_block(ctx, f"{pre}.double_blocks.{i}",
                                        img, txt, vec, cos, sin, P)
            if split < P.depth_double:
                xx_ = jnp.concatenate([txt, img], axis=1)
            for i in range(P.depth_single):
                if (i + P.depth_double) in skip_layers:
                    continue
                xx_ = single_block(ctx, f"{pre}.single_blocks.{i}", xx_,
                                   vec, cos, sin, P)
        if want_cache:
            cache_out = xx_ - xx_shallow
    img = xx_[:, s_txt:]

    fpre = pre + ".final_layer"
    # flux final layer: adaLN_modulation = Sequential(SiLU, Linear(d, 2d))
    y = B.linear(ctx, fpre + ".adaLN_modulation.1", B.silu(vec), 2 * d)
    y = y.astype(jnp.float32)
    shift, scale = y[:, :d], y[:, d:]
    img = _mod_apply(_ln(img), shift, scale)
    img = B.linear(ctx, fpre + ".linear", img, P.n_ch_out)

    # unpack [N, hp*wp, 4*ch] -> [N,H,W,ch]
    img = img.reshape(n, hp, wp, 2, 2, cl).transpose(0, 1, 3, 2, 4, 5)
    out = img.reshape(n, hh, ww, cl)
    if want_cache:
        return out, cache_out
    return out


def denoise(ctx: B.Ctx, x, sigma, t, cond, label, P: FluxParams,
            pre: str = "flux", control=None, extra_ch=None,
            skip_layers=(), want_cache: bool = False, use_cache=None):
    """Rectified-flow wrapper (sampler-body signature).  ``label`` carries
    the CLIP pooled vector, with the embedded-guidance value appended as
    one extra column when P.guidance_embed (the session packs it there —
    a per-generation scalar riding the conditioning tensor)."""
    assert control is None and extra_ch is None, \
        "control/extra channels are not supported for Flux models"
    t = jnp.broadcast_to(jnp.asarray(t, jnp.float32), (x.shape[0],))
    guidance = None
    if P.guidance_embed:
        guidance = label[:, P.d_pooled].astype(jnp.float32)
        label = label[:, :P.d_pooled]
    if want_cache:
        out, cache = flux_apply(ctx, x.astype(ctx.dtype), t, cond, label,
                                P, pre=pre, guidance=guidance,
                                skip_layers=skip_layers, want_cache=True)
        return out.astype(jnp.float32), cache
    out = flux_apply(ctx, x.astype(ctx.dtype), t, cond, label, P, pre=pre,
                     guidance=guidance, skip_layers=skip_layers,
                     use_cache=use_cache)
    return out.astype(jnp.float32)
