"""MMDiT diffusion transformer (Stable Diffusion 3 family).

Beyond-reference model family: the reference (aagdev/mlimgsynth) ends at
SDXL UNets; this adds the SD3 rectified-flow MMDiT so the same session /
sampler / serving stack drives transformer diffusion models.  Architecture
follows the public SD3 paper ("Scaling Rectified Flow Transformers for
High-Resolution Image Synthesis") and the sd3 single-file checkpoint layout
(``model.diffusion_model.joint_blocks.N.{context_block,x_block}...``).

Layout choices:
* qkv stays FUSED as one ``[d, 3d]`` matmul per stream (the checkpoint ships
  it fused), heads split via a single reshape of the packed result into the
  ``[N, S, H, D]`` layout attention takes;
* joint attention (text tokens ++ latent patches in one sequence) runs
  through :func:`~..ops.attention.attention`, so its cuDNN route and the
  mesh paths apply unchanged;
* adaLN modulation vectors are computed once per step in f32 and broadcast
  into the bf16 stream;
* patchify/unpatchify are a stride-2 conv (NHWC) and a reshape — no gathers.

Param names mirror the checkpoint tails under the internal ``mmdit.`` prefix
(see nameconv.normalize_name), so loading keys directly like the UNet does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax.numpy as jnp

from ..ops.attention import attention
from . import blocks as B


@dataclass(frozen=True)
class MmditParams:
    """SD3-family MMDiT hyperparameters.

    ``depth`` is the block count; width is ``64 * depth`` with ``depth``
    heads of 64 (the SD3 scaling rule).  ``ch_adm_in`` / ``cond_label`` /
    ``uncond_empty_zero`` / ``clip_norm`` / ``n_ch_in`` mirror the
    UnetParams fields the session layer reads; ``flow=True`` marks the
    rectified-flow parameterization for the sampler (velocity prediction,
    sigma == t in [0,1], no c_in scaling)."""
    depth: int = 24
    d_model: int = 0            # 0 -> 64 * depth
    n_head: int = 0             # 0 -> depth
    patch: int = 2
    n_ch_in: int = 16
    n_ch_out: int = 16
    d_ctx_in: int = 4096        # context token width (t5 width; clip padded)
    d_pooled: int = 2048        # pooled conditioning width (clipL + clipG)
    pos_embed_max: int = 192    # pos-embed grid side (192 for SD3-medium)
    d_t_embed: int = 256
    qk_norm: bool = False       # RMSNorm on per-head q/k (SD3.5)
    # MMDiT-X (SD3.5-medium): block indices whose x_block carries a SECOND
    # self-attention over the latent tokens only (attn2, 9-chunk adaLN)
    x_self_attn_layers: Tuple[int, ...] = ()
    # fields shared with UnetParams that the session/sampler read
    n_ctx: int = 4096
    ch_adm_in: int = 2048
    cond_label: bool = True
    uncond_empty_zero: bool = False
    clip_norm: bool = False
    vparam: bool = False
    n_step_train: int = 1000
    flow: bool = True
    flow_shift: float = 3.0

    @property
    def width(self) -> int:
        return self.d_model or 64 * self.depth

    @property
    def heads(self) -> int:
        return self.n_head or self.depth


MMDIT_SD3_MEDIUM = MmditParams(depth=24)
MMDIT_SD35_LARGE = MmditParams(depth=38, qk_norm=True)
# SD3.5-medium is MMDiT-X: same width/depth as SD3-medium plus qk-norm, a
# 384-grid pos embed, and dual attention in x-blocks 0..12
MMDIT_SD35_MEDIUM = MmditParams(depth=24, qk_norm=True, pos_embed_max=384,
                                x_self_attn_layers=tuple(range(13)))


def _modulate(x, shift, scale):
    """adaLN modulation; shift/scale are [N, d] f32, x is [N, S, d]."""
    dt = x.dtype
    return x * (1.0 + scale[:, None, :]).astype(dt) + shift[:, None, :].astype(dt)


def _rms_norm(x, w, eps: float = 1e-6):
    """RMSNorm over the last axis in f32 (SD3.5 per-head qk norm)."""
    xf = x.astype(jnp.float32)
    n = xf * jnp.reciprocal(jnp.sqrt(
        jnp.mean(xf * xf, axis=-1, keepdims=True) + eps))
    return (n * w.astype(jnp.float32)).astype(x.dtype)


def _qkv(ctx: B.Ctx, pre: str, x, P: MmditParams):
    """Fused qkv projection -> ([N,S,H,D], [N,S,H,D], [N,S,H,D]).

    One [d, 3d] matmul (checkpoint-native packing; B.linear also gives the
    int8/int4 weight-only path); heads split by a reshape of the packed
    [N,S,3,H,D] result."""
    d = P.width
    h = P.heads
    dh = d // h
    y = B.linear(ctx, pre + ".qkv", x, 3 * d)
    n, s = y.shape[0], y.shape[1]
    y = y.reshape(n, s, 3, h, dh)
    q, k, v = y[:, :, 0], y[:, :, 1], y[:, :, 2]
    if P.qk_norm:
        q = _rms_norm(q, ctx.param(pre + ".ln_q.weight", (dh,), B.VEC,
                                   jnp.float32))
        k = _rms_norm(k, ctx.param(pre + ".ln_k.weight", (dh,), B.VEC,
                                   jnp.float32))
    return q, k, v


def _attn_out(ctx: B.Ctx, pre: str, o, P: MmditParams):
    """[N,S,H,D] attention output -> [N,S,d] through the proj linear."""
    n, s = o.shape[0], o.shape[1]
    return B.linear(ctx, pre + ".proj", o.reshape(n, s, P.width), P.width)


def _mlp(ctx: B.Ctx, pre: str, x, P: MmditParams):
    x = B.linear(ctx, pre + ".fc1", x, P.width * 4)
    x = B.gelu_tanh(x)
    return B.linear(ctx, pre + ".fc2", x, P.width)


def _block_mod(ctx: B.Ctx, pre: str, c, n_chunks: int, P: MmditParams):
    """adaLN modulation vectors: SiLU(c) -> linear -> n_chunks [N,d] f32."""
    y = B.linear(ctx, pre + ".adaLN_modulation.1", B.silu(c),
                 n_chunks * P.width)
    y = y.astype(jnp.float32)
    return [y[:, i * P.width:(i + 1) * P.width] for i in range(n_chunks)]


def joint_block(ctx: B.Ctx, pre: str, cx, x, c, P: MmditParams,
                ctx_pre_only: bool, x_self_attn: bool = False):
    """One MMDiT joint block.

    ``cx`` [N,Sc,d] context stream, ``x`` [N,Sx,d] latent stream, ``c``
    [N,d] conditioning vector.  Both streams project q/k/v, attention runs
    over the CONCATENATED sequence, outputs split back per stream.  The
    final block's context side is ``pre_only``: it feeds attention but has
    no output projection or MLP (its stream ends here).

    ``x_self_attn`` (MMDiT-X / SD3.5-medium): the x-block additionally runs
    a SECOND self-attention over the latent tokens only, with its own
    qkv/proj (``attn2``) and modulation (the adaLN emits 9 chunks); its
    gated output is added after the joint-attention residual."""
    cpre = pre + ".context_block"
    xpre = pre + ".x_block"
    if ctx_pre_only:
        cmod = _block_mod(ctx, cpre, c, 2, P)
        c_shift, c_scale = cmod
        c_gate = c_gate2 = c_shift2 = c_scale2 = None
    else:
        (c_shift, c_scale, c_gate,
         c_shift2, c_scale2, c_gate2) = _block_mod(ctx, cpre, c, 6, P)
    xs_shift = xs_scale = xs_gate = None
    if x_self_attn:
        (x_shift, x_scale, x_gate, x_shift2, x_scale2, x_gate2,
         xs_shift, xs_scale, xs_gate) = _block_mod(ctx, xpre, c, 9, P)
    else:
        (x_shift, x_scale, x_gate,
         x_shift2, x_scale2, x_gate2) = _block_mod(ctx, xpre, c, 6, P)

    cn = B.layer_norm(ctx, cpre + ".norm1", cx, eps=1e-6, affine=False)
    cn = _modulate(cn, c_shift, c_scale)
    cq, ck, cv = _qkv(ctx, cpre + ".attn", cn, P)

    xn0 = B.layer_norm(ctx, xpre + ".norm1", x, eps=1e-6, affine=False)
    xn = _modulate(xn0, x_shift, x_scale)
    xq, xk, xv = _qkv(ctx, xpre + ".attn", xn, P)

    sc = cx.shape[1]
    q = jnp.concatenate([cq, xq], axis=1)
    k = jnp.concatenate([ck, xk], axis=1)
    v = jnp.concatenate([cv, xv], axis=1)
    o = attention(q, k, v)          # scale 1/sqrt(d_head)

    xo = _attn_out(ctx, xpre + ".attn", o[:, sc:], P)
    x = x + (x_gate[:, None, :]).astype(x.dtype) * xo
    if x_self_attn:
        # latent-only self-attention branch off the SAME norm1 output
        xn2 = _modulate(xn0, xs_shift, xs_scale)
        q2, k2, v2 = _qkv(ctx, xpre + ".attn2", xn2, P)
        o2 = attention(q2, k2, v2)
        x = x + (xs_gate[:, None, :]).astype(x.dtype) * _attn_out(
            ctx, xpre + ".attn2", o2, P)
    xn = B.layer_norm(ctx, xpre + ".norm2", x, eps=1e-6, affine=False)
    xn = _modulate(xn, x_shift2, x_scale2)
    x = x + (x_gate2[:, None, :]).astype(x.dtype) * _mlp(ctx, xpre + ".mlp",
                                                         xn, P)

    if ctx_pre_only:
        return None, x
    co = _attn_out(ctx, cpre + ".attn", o[:, :sc], P)
    cx = cx + (c_gate[:, None, :]).astype(cx.dtype) * co
    cn = B.layer_norm(ctx, cpre + ".norm2", cx, eps=1e-6, affine=False)
    cn = _modulate(cn, c_shift2, c_scale2)
    cx = cx + (c_gate2[:, None, :]).astype(cx.dtype) * _mlp(
        ctx, cpre + ".mlp", cn, P)
    return cx, x


def _pos_embed_crop(ctx: B.Ctx, pre: str, hp: int, wp: int, P: MmditParams):
    """Center-crop the learned pos-embed grid to the [hp, wp] patch grid
    (the sd3 convention: the table covers pos_embed_max^2 positions)."""
    g = P.pos_embed_max
    pe = ctx.param(pre + ".pos_embed", (1, g * g, P.width), B.MAT)
    pe = pe.reshape(g, g, P.width)
    top = (g - hp) // 2
    left = (g - wp) // 2
    pe = jnp.asarray(pe)[top:top + hp, left:left + wp]
    return pe.reshape(1, hp * wp, P.width)


def _dc_split(depth: int) -> int:
    """Block-cache split point: the first ``k`` joint blocks are the
    always-recomputed SHALLOW prefix; blocks k..depth-1 are the DEEP tail
    whose img-stream residual is cached between refresh steps (the DiT
    analog of DeepCache's UNet encoder cache — Delta-DiT-style back-block
    residual reuse).  k = depth//8 keeps ~87% of block work cacheable
    while the prefix tracks the step-to-step structural drift."""
    return max(1, depth // 8)


def mmdit_apply(ctx: B.Ctx, x, t, cond, pooled, P: MmditParams,
                pre: str = "mmdit", skip_layers=(),
                want_cache: bool = False, use_cache=None):
    """MMDiT forward.  x: [N,H,W,16] NHWC latent, t: [N] timesteps (0..1000
    scale), cond: [N,S,d_ctx_in] context tokens, pooled: [N,d_pooled].
    Returns [N,H,W,n_ch_out] (the velocity field for rectified flow).

    ``skip_layers``: joint-block indices elided from the depth loop —
    the degraded forward used by skip-layer guidance (SD3.5-medium's
    recommended sampling mode; the SLG pass runs the conditional input
    with these structure-forming blocks removed and the output steers
    *away* from that degradation).

    ``want_cache``/``use_cache`` (--deepcache on flow models): the deep
    tail's residual on the img token stream (x after ALL joint blocks
    minus x after the first ``_dc_split(depth)`` blocks) is returned as
    the cache / reused in place of running blocks k..depth-1.  The
    t-dependent final-layer modulation always recomputes, so cached
    steps still track the timestep.  At identical inputs the shallow
    reconstruction x_k + (x_D - x_k) matches the full forward to f.p.
    rounding (the UNet cache is concat-exact; this residual form is
    not bit-exact, only ~1 ulp)."""
    dtype = ctx.dtype
    n, h, w, _ = x.shape
    p = P.patch
    hp, wp = h // p, w // p
    x = x.astype(dtype)
    cond = cond.astype(dtype)

    # patchify: stride-p conv == linear on p x p patches
    xe = B.conv2d(ctx, pre + ".x_embedder.proj", x, P.width, kernel=p,
                  stride=p, pad=0)
    xe = xe.reshape(n, hp * wp, P.width)
    xe = xe + _pos_embed_crop(ctx, pre, hp, wp, P).astype(dtype)

    te = B.timestep_embedding(t, P.d_t_embed).astype(dtype)
    te = B.linear(ctx, pre + ".t_embedder.mlp.0", te, P.width)
    te = B.linear(ctx, pre + ".t_embedder.mlp.2", B.silu(te), P.width)
    ye = B.linear(ctx, pre + ".y_embedder.mlp.0", pooled.astype(dtype),
                  P.width)
    ye = B.linear(ctx, pre + ".y_embedder.mlp.2", B.silu(ye), P.width)
    c = (te + ye).astype(jnp.float32)

    cx = B.linear(ctx, pre + ".context_embedder", cond, P.width)

    stacked = f"{pre}.joint_blocks_p."
    if any(k.startswith(stacked) for k in ctx.params):
        if want_cache or use_cache is not None:
            # backstop (api._deepcache_check rejects mesh combos pre-trace)
            raise ValueError(
                "deepcache is not supported with --pp stacking")
        if skip_layers:
            # backstop (api._guidance_checks rejects slg+pp pre-trace);
            # a raise survives python -O where an assert would vanish
            raise ValueError(
                "skip-layer guidance is not supported with --pp stacking")
        # pipeline-parallel block stack (--pp): the session restacked all
        # depth blocks into [pp, L, ...] slabs sharded over the 'pp' mesh
        # axis (the final pre_only block's missing context-side params are
        # zero-filled, so its gates read 0 and the uniform joint_block is
        # exact — see api._stack_pipeline_blocks).  Microbatches stream
        # through the stages via parallel/pipeline.py.
        from ..ops import attention as attn_mod
        from ..parallel import pipeline as pl
        plan = pl.PLAN
        slab = {k[len(stacked) - 1:]: v for k, v in ctx.params.items()
                if k.startswith(stacked)}

        def block_fn(pj, acts):
            cx_, xe_, c_ = acts
            bctx = B.Ctx(pj, dtype=ctx.dtype)
            with attn_mod.local_only():
                cx2, xe2 = joint_block(bctx, "", cx_, xe_, c_, P,
                                       ctx_pre_only=False)
            return (cx2, xe2, c_)

        xe = pl.pipeline_apply(plan.mesh, block_fn, slab, (cx, xe, c),
                               n_micro=plan.n_micro, collect=1)
    else:
        k_cache = 0
        if want_cache or use_cache is not None:
            if skip_layers:
                # raise, not assert: survives python -O
                raise ValueError(
                    "deepcache: incompatible with skip_layers")
            k_cache = _dc_split(P.depth)
        xe_shallow = None
        n_run = k_cache if use_cache is not None else P.depth
        for i in range(n_run):
            if i in skip_layers:
                continue
            cx, xe = joint_block(ctx, f"{pre}.joint_blocks.{i}", cx, xe, c,
                                 P, ctx_pre_only=(i == P.depth - 1),
                                 x_self_attn=(i in P.x_self_attn_layers))
            if want_cache and i == k_cache - 1:
                xe_shallow = xe
        if use_cache is not None:
            xe = xe + use_cache.astype(xe.dtype)
        if want_cache:
            # deep-tail residual on the img token stream (blocks k..D-1)
            cache_out = xe - xe_shallow

    fpre = pre + ".final_layer"
    shift, scale = _block_mod(ctx, fpre, c, 2, P)
    xe = B.layer_norm(ctx, fpre + ".norm_final", xe, eps=1e-6, affine=False)
    xe = _modulate(xe, shift, scale)
    xe = B.linear(ctx, fpre + ".linear", xe, p * p * P.n_ch_out)

    # unpatchify [N, hp*wp, p*p*C] -> [N, H, W, C]
    out = xe.reshape(n, hp, wp, p, p, P.n_ch_out)
    out = out.transpose(0, 1, 3, 2, 4, 5).reshape(n, hp * p, wp * p,
                                                  P.n_ch_out)
    if want_cache:
        return out, cache_out
    return out


def denoise(ctx: B.Ctx, x, sigma, t, cond, label, P: MmditParams,
            pre: str = "mmdit", control=None, extra_ch=None,
            skip_layers=(), want_cache: bool = False, use_cache=None):
    """Rectified-flow wrapper matching the UNet ``denoise`` signature used
    by the sampler body: x_t = (1-sigma) x0 + sigma noise, the model
    predicts the velocity v = noise - x0 = dx/dsigma, so the output IS the
    solver derivative — no c_in/c_skip scalings (``t`` is already
    sigma * n_step_train, computed by the sampler for flow models)."""
    assert control is None and extra_ch is None, \
        "control/extra channels are not supported for MMDiT models"
    t = jnp.broadcast_to(jnp.asarray(t, jnp.float32), (x.shape[0],))
    if want_cache:
        out, cache = mmdit_apply(ctx, x.astype(ctx.dtype), t, cond, label,
                                 P, pre=pre, skip_layers=skip_layers,
                                 want_cache=True)
        return out.astype(jnp.float32), cache
    out = mmdit_apply(ctx, x.astype(ctx.dtype), t, cond, label, P, pre=pre,
                      skip_layers=skip_layers, use_cache=use_cache)
    return out.astype(jnp.float32)
