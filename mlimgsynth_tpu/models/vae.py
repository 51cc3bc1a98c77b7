"""KL autoencoder (SD VAE) encoder/decoder.

reference: src/vae.c.  Parameter names match the internal scheme
(``vae.encoder.down.0.block.0.norm1.weight`` ...).  Tiling for
memory-bounded execution lives in the session layer (the graph here is a
plain function of its input shape).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops.attention import attention
from . import blocks as B


@dataclass(frozen=True)
class VaeParams:
    """ref: src/vae.c:22-44."""
    ch_x: int = 3
    ch_z: int = 4
    ch: int = 128
    n_res: int = 4
    n_res_blk: int = 2
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    d_embed: int = 4
    f_down: int = 8
    scale_factor: float = 0.18215
    # latent shift (z_model = (z - shift) * scale; SD3's VAE uses 0.0609)
    shift_factor: float = 0.0
    # SD1/SDXL VAEs wrap the moments/latent in 1x1 quant/post_quant convs;
    # the SD3 16-channel VAE drops both
    quant_conv: bool = True


VAE_SD1 = VaeParams(scale_factor=0.18215)
VAE_SDXL = VaeParams(scale_factor=0.13025)
# SD3 family: 16-channel latent, shift factor, no quant convs
VAE_SD3 = VaeParams(ch_z=16, d_embed=16, scale_factor=1.5305,
                    shift_factor=0.0609, quant_conv=False)
# Flux: same architecture as the SD3 VAE, different scaling
VAE_FLUX = VaeParams(ch_z=16, d_embed=16, scale_factor=0.3611,
                     shift_factor=0.1159, quant_conv=False)


def attn_2d_self(ctx: B.Ctx, pre: str, x):
    """Single-head 2D self-attention mid-block (ref: mlb_attn_2d_self,
    src/vae.c:46-74).  x: [N,H,W,C]."""
    n, h, w, c = x.shape
    x0 = x
    x = B.group_norm(ctx, pre + ".norm", x)
    q = B.conv2d(ctx, pre + ".q", x, c, 1, 1, pad=0).reshape(n, h * w, 1, c)
    k = B.conv2d(ctx, pre + ".k", x, c, 1, 1, pad=0).reshape(n, h * w, 1, c)
    v = B.conv2d(ctx, pre + ".v", x, c, 1, 1, pad=0).reshape(n, h * w, 1, c)
    o = attention(q, k, v)  # scale 1/sqrt(c)
    o = o.reshape(n, h, w, c)
    o = B.conv2d(ctx, pre + ".proj_out", o, c, 1, 1, pad=0)
    return o + x0


def kl_encoder(ctx: B.Ctx, pre: str, x, ch_out: int, P: VaeParams):
    """ref: mlb_kl_encoder (src/vae.c:76-118)."""
    x = B.conv2d(ctx, pre + ".conv_in", x, P.ch)
    ch_blk = P.ch
    for i in range(P.n_res):
        ch_blk_out = P.ch * P.ch_mult[i]
        for j in range(P.n_res_blk):
            x = B.resnet(ctx, f"{pre}.down.{i}.block.{j}", x, None, ch_blk_out)
            ch_blk = ch_blk_out
        if i + 1 != P.n_res:
            x = B.downsample(ctx, f"{pre}.down.{i}.downsample", x, ch_blk,
                             vae=True)
    x = B.resnet(ctx, pre + ".mid.block_1", x, None, ch_blk)
    x = attn_2d_self(ctx, pre + ".mid.attn_1", x)
    x = B.resnet(ctx, pre + ".mid.block_2", x, None, ch_blk)
    x = B.group_norm(ctx, pre + ".norm_out", x)
    x = B.silu(x)
    x = B.conv2d(ctx, pre + ".conv_out", x, ch_out)
    return x


def kl_decoder(ctx: B.Ctx, pre: str, x, ch_out: int, P: VaeParams):
    """ref: mlb_kl_decoder (src/vae.c:130-169)."""
    ch_blk = P.ch * P.ch_mult[P.n_res - 1]
    x = B.conv2d(ctx, pre + ".conv_in", x, ch_blk)
    x = B.resnet(ctx, pre + ".mid.block_1", x, None, ch_blk)
    x = attn_2d_self(ctx, pre + ".mid.attn_1", x)
    x = B.resnet(ctx, pre + ".mid.block_2", x, None, ch_blk)
    for i in range(P.n_res - 1, -1, -1):
        ch_blk_out = P.ch * P.ch_mult[i]
        for j in range(P.n_res_blk + 1):
            x = B.resnet(ctx, f"{pre}.up.{i}.block.{j}", x, None, ch_blk_out)
            ch_blk = ch_blk_out
        if i != 0:
            x = B.upsample(ctx, f"{pre}.up.{i}.upsample", x, ch_blk)
    x = B.group_norm(ctx, pre + ".norm_out", x)
    x = B.silu(x)
    x = B.conv2d(ctx, pre + ".conv_out", x, ch_out)
    return x


def vae_encode_apply(ctx: B.Ctx, img, P: VaeParams, pre: str = "vae"):
    """img [N,H,W,3] in [-1,1] -> moments [N,H/8,W/8,8]
    (ref: mlb_sdvae_encoder, src/vae.c:120-128)."""
    x = img.astype(ctx.dtype)
    x = kl_encoder(ctx, pre + ".encoder", x, P.ch_z * 2, P)
    if P.quant_conv:
        x = B.conv2d(ctx, pre + ".quant_conv", x, P.ch_z * 2, 1, 1, pad=0)
    return x


def vae_decode_apply(ctx: B.Ctx, latent, P: VaeParams, pre: str = "vae"):
    """latent [N,h,w,4] (scaled) -> img [N,8h,8w,3] in [-1,1]
    (ref: mlb_sdvae_decoder, src/vae.c:171-180)."""
    x = latent.astype(ctx.dtype) * (1.0 / P.scale_factor)
    if P.shift_factor:
        x = x + jnp.float32(P.shift_factor).astype(x.dtype)
    if P.quant_conv:
        x = B.conv2d(ctx, pre + ".post_quant_conv", x, P.d_embed, 1, 1,
                     pad=0)
    x = kl_decoder(ctx, pre + ".decoder", x, P.ch_x, P)
    return x


def latent_mean(moments, P: VaeParams):
    """moments [N,h,w,2z] -> (mean - shift) * scale
    (ref: sdvae_latent_mean; shift is 0 for the SD families)."""
    return (moments[..., :P.ch_z] - P.shift_factor) * P.scale_factor


def latent_sample(moments, rand, P: VaeParams):
    """Sample ((mean + std*rand) - shift) * scale (ref: sdvae_latent_sample,
    src/vae.c:197-220).  ``rand`` is standard normal of latent shape."""
    mean = moments[..., :P.ch_z]
    logvar = jnp.clip(moments[..., P.ch_z:], -30.0, 20.0)
    z = mean + jnp.exp(logvar * 0.5) * rand
    return (z - P.shift_factor) * P.scale_factor
