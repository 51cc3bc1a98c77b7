"""Stable Diffusion UNet (SD1/SD2/SDXL variants).

Architecture, parameter naming and k-diffusion scalings mirror the reference
(reference: src/unet.c): hierarchical names like
``in.1.1.transf.0.attn2.k_proj.weight`` match the checkpoint normalizer
output, enabling direct keying into the param dict.

Layout: NHWC activations, one batched forward for CFG (cond/uncond as
batch rows) instead of the reference's two sequential evaluations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import jax.numpy as jnp

from . import blocks as B


@dataclass(frozen=True)
class UnetParams:
    """ref: src/unet.c:21-83."""
    n_ch_in: int = 4
    n_ch_out: int = 4
    n_res_blk: int = 2
    attn_res: Tuple[int, ...] = (4, 2, 1)
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    transf_depth: Tuple[int, ...] = (1, 1, 1, 1)
    n_te: int = 1280
    n_head: int = 0
    d_head: int = 0
    n_ctx: int = 768
    n_ch: int = 320
    ch_adm_in: int = 0
    clip_norm: bool = True
    cond_label: bool = False
    uncond_empty_zero: bool = False
    vparam: bool = False
    n_step_train: int = 1000


UNET_SD1 = UnetParams(n_head=8, n_ctx=768)
UNET_SD2 = UnetParams(d_head=64, n_ctx=1024, vparam=True)
UNET_SDXL = UnetParams(
    attn_res=(4, 2), ch_mult=(1, 2, 4), transf_depth=(1, 2, 10),
    d_head=64, n_ctx=2048, ch_adm_in=2816, clip_norm=False,
    cond_label=True, uncond_empty_zero=True)
# SDXL-refiner (beyond-reference; stability sd_xl_refiner.yaml): a single
# OpenCLIP-bigG text tower (n_ctx 1280), 4 levels with attention only at
# ds 2/4, label = pooled feature + 5x256 size/aesthetic embeddings
# (orig_h, orig_w, crop_top, crop_left, aesthetic_score) = 2560.
UNET_SDXL_REFINER = UnetParams(
    attn_res=(4, 2), ch_mult=(1, 2, 4, 4), transf_depth=(4, 4, 4, 4),
    n_ch=384, n_te=1536, d_head=64, n_ctx=1280, ch_adm_in=2560,
    clip_norm=False, cond_label=True, uncond_empty_zero=True)

# aesthetic-score conditioning for the refiner's label (sgm defaults:
# aesthetic_score 6.0 for cond, negative_aesthetic_score 2.5 for uncond)
AESTHETIC_SCORE = 6.0
AESTHETIC_NSCORE = 2.5


def _heads(P: UnetParams, d_embed: int) -> Tuple[int, int]:
    n_head, d_head = P.n_head, P.d_head
    if not n_head:
        n_head = d_embed // d_head
    if not d_head:
        d_head = d_embed // n_head
    return n_head, d_head


def spatial_transformer(ctx: B.Ctx, pre: str, x, cond, d_embed: int,
                        P: UnetParams, depth: int,
                        self_identity: bool = False):
    """ref: mlb_spatial_transf (src/unet.c:110-145).
    ``self_identity``: identity self-attention maps (PAG perturbation)."""
    n, h, w, ch_in = x.shape
    n_head, _ = _heads(P, d_embed)
    x0 = x
    x = B.group_norm(ctx, pre + ".norm", x)
    x = B.conv2d(ctx, pre + ".proj_in", x, d_embed, 1, 1, pad=0)
    x = x.reshape(n, h * w, d_embed)
    for i in range(depth):
        x = B.basic_transformer(ctx, f"{pre}.transf.{i}", x, cond,
                                d_embed, d_embed, n_head,
                                self_identity=self_identity)
    x = x.reshape(n, h, w, d_embed)
    x = B.conv2d(ctx, pre + ".proj_out", x, ch_in, 1, 1, pad=0)
    return x + x0


def unet_embed(ctx: B.Ctx, pre: str, t, label, P: UnetParams):
    """ref: mlb_unet__embed (src/unet.c:147-165)."""
    emb = B.timestep_embedding(t, P.n_ch).astype(ctx.dtype)
    emb = B.linear(ctx, pre + ".time_embed.0", emb, P.n_te)
    emb = B.silu(emb)
    emb = B.linear(ctx, pre + ".time_embed.2", emb, P.n_te)
    if P.ch_adm_in and label is not None:
        le = B.linear(ctx, pre + ".label_embed.0", label.astype(ctx.dtype),
                      P.n_te)
        le = B.silu(le)
        le = B.linear(ctx, pre + ".label_embed.2", le, P.n_te)
        emb = emb + le
    return emb


def _freeu_filter(h, scale, threshold=1):
    """FreeU skip-connection Fourier filter: scale the ``threshold``
    lowest spatial frequencies (f32 fft over H,W; NHWC axes 1,2).  The
    unshifted index set {0..t-1, N-t..N-1} equals the centered 2t x 2t
    region of the fftshifted spectrum."""
    hf = jnp.fft.fft2(h.astype(jnp.float32), axes=(1, 2))
    H, W = h.shape[1], h.shape[2]
    ih, iw = jnp.arange(H), jnp.arange(W)
    mh = (ih < threshold) | (ih >= H - threshold)
    mw = (iw < threshold) | (iw >= W - threshold)
    mask = jnp.where(mh[:, None] & mw[None, :], jnp.float32(scale), 1.0)
    hf = hf * mask[None, :, :, None]
    return jnp.real(jnp.fft.ifft2(hf, axes=(1, 2))).astype(h.dtype)


def _freeu_apply(x, h, P, freeu):
    """FreeU ("FreeU: Free Lunch in Diffusion U-Net", PAPERS.md) at one
    decoder block: scale the first half of the backbone feature's
    channels and low-pass-attenuate the skip.  Channel-count dispatch
    (the ComfyUI/A1111 convention): 4*n_ch -> (b1, s1), 2*n_ch ->
    (b2, s2), anything else untouched."""
    b1, b2, s1, s2 = freeu
    cb = x.shape[-1]
    if cb == P.n_ch * 4:
        b, s = b1, s1
    elif cb == P.n_ch * 2:
        b, s = b2, s2
    else:
        return x, h
    half = cb // 2
    x = jnp.concatenate([x[..., :half] * jnp.asarray(b, x.dtype),
                         x[..., half:]], axis=-1)
    return x, _freeu_filter(h, s)


def unet_apply(ctx: B.Ctx, x, t, cond, label, P: UnetParams,
               pre: str = "unet", control=None,
               want_cache: bool = False, use_cache=None, freeu=None,
               pag: bool = False):
    """Full UNet forward.  x: [N,H,W,4] NHWC, t: [N], cond: [N,77,n_ctx],
    label: [N, ch_adm_in] or None.  ref: mlb_unet_denoise (src/unet.c:263-281)
    plus mlb_unet__in/__mid/__out.

    ``control`` (optional): ControlNet residuals as returned by
    :func:`~.controlnet.controlnet_apply` — one per encoder skip plus the
    middle residual last; each is added to its skip as the decoder consumes
    it (the standard ControlNet injection points).

    Encoder caching (DeepCache / "Faster Diffusion"-style; PAPERS.md):
    the split point is the feature entering the level-0 decoder block.
    ``want_cache`` returns ``(out, cache)`` with that feature captured;
    ``use_cache`` runs only the SHALLOW path — level-0 encoder blocks,
    the level-0 decoder fed the cached deep feature, and the head — so
    cached steps skip every deeper level and the mid transformer."""
    dtype = ctx.dtype
    x = x.astype(dtype)
    cond = cond.astype(dtype)
    emb = unet_embed(ctx, pre, t, label, P)
    n_levels = len(P.ch_mult)
    if use_cache is not None:
        assert control is None and not want_cache and n_levels >= 2

    # --- input blocks (src/unet.c:167-203)
    x = B.conv2d(ctx, pre + ".in.conv", x, P.n_ch)
    stack = [x]
    i_blk = 0
    ds = 1
    ch = P.n_ch
    for im in range(1 if use_cache is not None else n_levels):
        if im:
            ds *= 2
            i_blk += 1
            x = B.downsample(ctx, f"{pre}.in.{i_blk}.0", x, ch)
            stack.append(x)
        for _ in range(P.n_res_blk):
            i_blk += 1
            ch = P.n_ch * P.ch_mult[im]
            x = B.resnet(ctx, f"{pre}.in.{i_blk}.0", x, emb, ch)
            if ds in P.attn_res:
                x = spatial_transformer(ctx, f"{pre}.in.{i_blk}.1", x, cond,
                                        ch, P, P.transf_depth[im])
            stack.append(x)

    ctrl = None
    if use_cache is not None:
        x = use_cache.astype(dtype)
        i_oblk0 = (n_levels - 1) * (P.n_res_blk + 1)
        ds = 1
    else:
        # --- middle (src/unet.c:205-217)
        im = n_levels - 1
        ch = P.n_ch * P.ch_mult[im]
        x = B.resnet(ctx, pre + ".mid.0", x, emb, ch)
        # PAG perturbs the MID transformer's self-attention (the standard
        # "m0" injection point): attention map -> identity
        x = spatial_transformer(ctx, pre + ".mid.1", x, cond, ch, P,
                                P.transf_depth[im], self_identity=pag)
        x = B.resnet(ctx, pre + ".mid.2", x, emb, ch)
        if control is not None:
            assert len(control) == len(stack) + 1, (len(control),
                                                    len(stack))
            x = x + control[-1].astype(x.dtype)
            ctrl = list(control[:-1])
        i_oblk0 = 0

    # --- output blocks (src/unet.c:219-261)
    cache_out = None
    i_oblk = i_oblk0
    for im in (range(n_levels - 1, -1, -1) if use_cache is None
               else [0]):    # shallow: level-0 decoder only
        for j in range(P.n_res_blk + 1):
            if im == 0 and j == 0 and want_cache:
                cache_out = x    # feature entering the level-0 decoder
            h = stack.pop()
            if ctrl is not None:
                h = h + ctrl.pop().astype(h.dtype)
            if freeu is not None:
                x, h = _freeu_apply(x, h, P, freeu)
            x = jnp.concatenate([x, h], axis=-1)
            i_sub = 0
            ch = P.n_ch * P.ch_mult[im]
            x = B.resnet(ctx, f"{pre}.out.{i_oblk}.{i_sub}", x, emb, ch)
            i_sub += 1
            if ds in P.attn_res:
                x = spatial_transformer(ctx, f"{pre}.out.{i_oblk}.{i_sub}",
                                        x, cond, ch, P, P.transf_depth[im])
                i_sub += 1
            if im != 0 and j == P.n_res_blk:
                x = B.upsample(ctx, f"{pre}.out.{i_oblk}.{i_sub}", x, ch)
                ds //= 2
            i_oblk += 1
    assert not stack

    x = B.group_norm(ctx, pre + ".out.norm", x)
    x = B.silu(x)
    x = B.conv2d(ctx, pre + ".out.conv", x, P.n_ch_out)
    if want_cache:
        return x, cache_out
    return x


def denoise(ctx: B.Ctx, x, sigma, t, cond, label, P: UnetParams,
            pre: str = "unet", control=None, extra_ch=None,
            want_cache: bool = False, use_cache=None, freeu=None,
            pag: bool = False):
    """k-diffusion wrapper: input scaling ``c_in = 1/sqrt(sigma^2+1)`` and
    v-param output scaling (ref: unet_denoise_run, src/unet.c:460-498).
    Returns the derivative ``dx/dsigma`` used by the solvers.
    ``sigma`` and ``t`` are [N] or scalars (t = continuous train step).

    ``control``: optional ``(hint_feat, strength)`` — runs the ControlNet
    copy on the c_in-scaled input and injects its strength-scaled residuals
    into the UNet decoder.

    ``extra_ch``: optional [1 or N, H, W, n_ch_in - 4] conditioning
    channels for inpaint-variant UNets (repaint mask + masked-image
    latent), concatenated AFTER the c_in scaling — the extra channels are
    not part of the noised state (diffusers SD-inpaint convention)."""
    sigma = jnp.asarray(sigma, jnp.float32)
    c_in = 1.0 / jnp.sqrt(sigma * sigma + 1.0)
    xs = (x * _bcast(c_in, x)).astype(ctx.dtype)
    t = jnp.broadcast_to(jnp.asarray(t, jnp.float32), (x.shape[0],))
    if extra_ch is not None:
        e = jnp.broadcast_to(extra_ch.astype(xs.dtype),
                             xs.shape[:1] + extra_ch.shape[1:])
        xs = jnp.concatenate([xs, e], axis=-1)
    residuals = None
    if control is not None:
        from .controlnet import controlnet_apply
        hint_feat, strength = control
        residuals = controlnet_apply(ctx, xs, t, cond, label, hint_feat, P)
        residuals = [r * jnp.asarray(strength, r.dtype) for r in residuals]
    out = unet_apply(ctx, xs, t, cond, label, P, pre=pre,
                     control=residuals, want_cache=want_cache,
                     use_cache=use_cache, freeu=freeu, pag=pag)
    cache = None
    if want_cache:
        out, cache = out
    out = out.astype(jnp.float32)
    if P.vparam:
        c_skip = sigma / (sigma * sigma + 1.0)
        c_out = 1.0 / jnp.sqrt(sigma * sigma + 1.0)
        out = out * _bcast(c_out, out) + x.astype(jnp.float32) * _bcast(c_skip, x)
    if want_cache:
        return out, cache
    return out


def _bcast(s, x):
    s = jnp.asarray(s, jnp.float32)
    while s.ndim < x.ndim:
        s = s[..., None]
    return s
