"""ControlNet — conditional control for the SD UNets.

Beyond-reference addition: ControlNet is on the reference's Future-plans
list (reference: README.md:75) but unimplemented there.  Architecture per
Zhang et al., "Adding Conditional Control to Text-to-Image Diffusion
Models": a trainable copy of the UNet encoder + middle (same hyperparams,
so :class:`~.unet.UnetParams` is reused verbatim) that consumes the latent
plus an encoded hint image and feeds one zero-initialized 1x1-conv
residual per encoder skip (plus one for the middle) back into the UNet
decoder.

Internal names live under the ``cnet.`` prefix and mirror the UNet scheme
(``cnet.in.N.*``, ``cnet.mid.*``, ``cnet.time_embed.*``) so
:func:`~.unet.unet_embed` and the block library are shared; ControlNet-only
parts are ``cnet.hint.{0..7}`` (the hint encoder), ``cnet.zc.{0..11}``
(per-skip zero convs) and ``cnet.mid.out``.  Checkpoint names
(``control_model.*`` CompVis layout / diffusers ControlNetModel layout)
are mapped by :func:`mlimgsynth_tpu.nameconv.normalize_cnet_name`.

Device notes: the hint encoder is hint-only (no x/t dependence), so the
sampler evaluates it ONCE per program — inside the same fused dispatch,
hoisted out of the denoise scan — and only the encoder+middle copy runs
per step.  CFG's stacked cond/uncond batch rows broadcast against the
batch-1 hint features, matching the standard apply-to-both convention.
"""
from __future__ import annotations

from . import blocks as B
from .unet import UnetParams, spatial_transformer, unet_embed

# Hint encoder: 8 3x3 convs, silu between, three stride-2 stages
# (image resolution -> latent resolution = /8); the last conv is
# zero-initialized in trained checkpoints.
HINT_CH = (16, 16, 32, 32, 96, 96, 256)
HINT_STRIDE = (1, 1, 2, 1, 2, 1, 2)


def hint_apply(ctx: B.Ctx, hint, P: UnetParams, pre: str = "cnet"):
    """Encode the hint image [N,H,W,3] (values in [0,1]) to latent
    resolution [N,H/8,W/8,n_ch].  Runs once per generation."""
    x = hint.astype(ctx.dtype)
    for i, (ch, st) in enumerate(zip(HINT_CH, HINT_STRIDE)):
        x = B.conv2d(ctx, f"{pre}.hint.{i}", x, ch, 3, st, pad=1)
        x = B.silu(x)
    return B.conv2d(ctx, f"{pre}.hint.{len(HINT_CH)}", x, P.n_ch, 3, 1,
                    pad=1)


def controlnet_apply(ctx: B.Ctx, x, t, cond, label, hint_feat,
                     P: UnetParams, pre: str = "cnet"):
    """ControlNet forward: the UNet encoder + middle (same block layout as
    :func:`~.unet.unet_apply`) with the hint features added after the input
    conv, tapping a zero-conv residual after every skip-producing block.

    Returns ``n_skips + 1`` residuals: one per UNet encoder skip (in push
    order) and the middle-block residual last.  x: [N,H,W,4] NHWC (already
    c_in-scaled), hint_feat: [N or 1, H, W, n_ch]."""
    dtype = ctx.dtype
    x = x.astype(dtype)
    cond = cond.astype(dtype)
    emb = unet_embed(ctx, pre, t, label, P)

    x = B.conv2d(ctx, pre + ".in.conv", x, P.n_ch)
    x = x + hint_feat.astype(dtype)
    outs = [B.conv2d(ctx, f"{pre}.zc.0", x, P.n_ch, 1, 1, pad=0)]
    i_blk = 0
    ds = 1
    ch = P.n_ch
    n_levels = len(P.ch_mult)
    for im in range(n_levels):
        if im:
            ds *= 2
            i_blk += 1
            x = B.downsample(ctx, f"{pre}.in.{i_blk}.0", x, ch)
            outs.append(B.conv2d(ctx, f"{pre}.zc.{i_blk}", x, ch, 1, 1,
                                 pad=0))
        for _ in range(P.n_res_blk):
            i_blk += 1
            ch = P.n_ch * P.ch_mult[im]
            x = B.resnet(ctx, f"{pre}.in.{i_blk}.0", x, emb, ch)
            if ds in P.attn_res:
                x = spatial_transformer(ctx, f"{pre}.in.{i_blk}.1", x, cond,
                                        ch, P, P.transf_depth[im])
            outs.append(B.conv2d(ctx, f"{pre}.zc.{i_blk}", x, ch, 1, 1,
                                 pad=0))

    im = n_levels - 1
    ch = P.n_ch * P.ch_mult[im]
    x = B.resnet(ctx, pre + ".mid.0", x, emb, ch)
    x = spatial_transformer(ctx, pre + ".mid.1", x, cond, ch, P,
                            P.transf_depth[im])
    x = B.resnet(ctx, pre + ".mid.2", x, emb, ch)
    outs.append(B.conv2d(ctx, pre + ".mid.out", x, ch, 1, 1, pad=0))
    return outs
