"""Parameter context and NN building blocks.

The reference builds ggml graphs through a declarative block stack that both
names parameters hierarchically and emits ops (reference: src/mlblock.c,
src/mlblock_nn.c).  The JAX equivalent is a functional param *context*:
blocks are plain functions that request parameters by hierarchical name from a
``Ctx``; run under ``jax.eval_shape`` with a recording context, the same code
yields the model's full parameter spec (names, shapes, layout kinds) used by
the checkpoint loader — one definition, no spec drift.

Layout conventions (unlike the reference's ggml/NCHW):
* activations NHWC, linear weights ``[d_in, d_out]``, conv weights HWIO.
* matmuls/convs run in the context compute dtype (bf16 by default);
  normalizations and softmax accumulate in float32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.attention import attention

# Param layout kinds; the loader uses these to transform checkpoint arrays.
LINEAR_W = "linear_w"   # checkpoint [out,in]  -> [in,out]
CONV_W = "conv_w"       # checkpoint [out,in,kh,kw] -> [kh,kw,in,out]
VEC = "vec"             # 1-D as-is (biases, norm scales)
EMBED = "embed"         # [vocab, d] as-is
MAT = "mat"             # 2-D as-is (position embeddings, text_proj)


@dataclass
class ParamSpec:
    shape: Tuple[int, ...]
    kind: str
    dtype: object


class Ctx:
    """Parameter provider.

    ``params`` maps internal names to arrays already in device layout.  When
    ``record`` is set, requested params are recorded into ``spec`` and zeros
    are returned (use under ``jax.eval_shape`` to build a model spec without
    compute).
    """

    def __init__(self, params: Optional[Dict[str, jnp.ndarray]] = None,
                 dtype=jnp.bfloat16, record: bool = False,
                 tiling: bool = False):
        self.params = params if params is not None else {}
        self.dtype = dtype
        self.record = record
        # seamless-tiling mode (A1111 "tiling"): every conv pads
        # circularly, making the whole conv stack wrap-equivariant
        self.tiling = tiling
        self.spec: Dict[str, ParamSpec] = {}

    def param(self, name: str, shape: Tuple[int, ...], kind: str,
              dtype=None):
        dtype = dtype or self.dtype
        if self.record:
            self.spec[name] = ParamSpec(tuple(shape), kind, dtype)
            return jnp.zeros(shape, dtype)
        p = self.params[name]
        return p

    def has(self, name: str) -> bool:
        if self.record:
            return True
        return name in self.params


def trace_spec(fn, *example_args) -> Dict[str, ParamSpec]:
    """Run ``fn(ctx, *args)`` abstractly and return its parameter spec."""
    ctx = Ctx(record=True)
    jax.eval_shape(lambda *a: fn(ctx, *a), *example_args)
    return ctx.spec


# ---------------------------------------------------------------------------
# Activations (ggml-exact variants)
# ---------------------------------------------------------------------------

def silu(x):
    return x * jax.nn.sigmoid(x)


def gelu_tanh(x):
    # ggml_gelu: tanh approximation
    return jax.nn.gelu(x, approximate=True)


def gelu_exact(x):
    return jax.nn.gelu(x, approximate=False)


def gelu_quick(x):
    # ggml_gelu_quick: x * sigmoid(1.702 x)
    return x * jax.nn.sigmoid(1.702 * x)


# ---------------------------------------------------------------------------
# Core layers
# ---------------------------------------------------------------------------

def linear(ctx: Ctx, pre: str, x, n_out: int, bias: bool = True):
    """ref: mlb_nn_linear (src/mlblock_nn.c:16-28).

    When the param dict holds a quantized pair (``.weight_q8`` int8 or
    ``.weight_q4`` packed nibbles, + ``.weight_scale``), the weight-only
    quantized path runs instead (dequantize, then dot; see
    ops/q8_matmul.py, ops/q4_matmul.py)."""
    if not ctx.record and (pre + ".weight_q8") in ctx.params:
        from ..ops.q8_matmul import q8_dot
        x = q8_dot(x, ctx.params[pre + ".weight_q8"],
                   ctx.params[pre + ".weight_scale"])
    elif not ctx.record and (pre + ".weight_q4") in ctx.params:
        from ..ops.q4_matmul import q4_dot
        x = q4_dot(x, ctx.params[pre + ".weight_q4"],
                   ctx.params[pre + ".weight_scale"])
    else:
        w = ctx.param(pre + ".weight", (x.shape[-1], n_out), LINEAR_W)
        x = jnp.dot(x, w.astype(x.dtype))
    if bias:
        b = ctx.param(pre + ".bias", (n_out,), VEC)
        x = x + b.astype(x.dtype)
    return x


def conv2d(ctx: Ctx, pre: str, x, ch_out: int, kernel: int = 3,
           stride: int = 1, pad=1, bias: bool = True):
    """ref: mlb_nn_conv2d (src/mlblock_nn.c:31-55). x: [N,H,W,C]."""
    ch_in = x.shape[-1]
    w = ctx.param(pre + ".weight", (kernel, kernel, ch_in, ch_out), CONV_W)
    if isinstance(pad, int):
        padding = [(pad, pad), (pad, pad)]
    else:
        padding = pad
    if ctx.tiling and any(p for pair in padding for p in pair):
        x = jnp.pad(x, [(0, 0), padding[0], padding[1], (0, 0)],
                    mode="wrap")
        padding = [(0, 0), (0, 0)]
    x = jax.lax.conv_general_dilated(
        x, w.astype(x.dtype), window_strides=(stride, stride),
        padding=padding, dimension_numbers=("NHWC", "HWIO", "NHWC"))
    if bias:
        b = ctx.param(pre + ".bias", (ch_out,), VEC)
        x = x + b.astype(x.dtype)
    return x


def layer_norm(ctx: Ctx, pre: str, x, eps: float = 1e-5,
               affine: bool = True, bias: bool = True):
    """ref: mlb_nn_layer_norm (src/mlblock_nn.c:58-75). Normalizes last dim.

    Like :func:`group_norm`: float32 statistics, activation-dtype
    normalization arithmetic (no f32 materialization of the activations)."""
    dt = x.dtype
    # Two-pass variance: E[x^2]-mean^2 would fuse into one read of x but its
    # cancellation error grows with mean^2/var, which SD VAE decoder
    # activations are known to push >>1; the shifted form is exact-mean
    # robust.
    mean = jnp.mean(x, axis=-1, keepdims=True, dtype=jnp.float32)
    var = jnp.mean(jnp.square(x.astype(jnp.float32) - mean), axis=-1,
                   keepdims=True)
    xf = (x - mean.astype(dt)) * jax.lax.rsqrt(var + eps).astype(dt)
    if affine:
        w = ctx.param(pre + ".weight", (x.shape[-1],), VEC, jnp.float32)
        xf = xf * w.astype(dt)
        if bias:
            b = ctx.param(pre + ".bias", (x.shape[-1],), VEC, jnp.float32)
            xf = xf + b.astype(dt)
    return xf.astype(dt)


def group_norm(ctx: Ctx, pre: str, x, n_grp: int = 32, eps: float = 1e-6,
               affine: bool = True):
    """ref: mlb_nn_groupnorm32 (src/mlblock_nn.c:78-103, eps 1e-6).
    x: [N,H,W,C]; normalizes over (H,W,C/g) per group.

    Statistics accumulate in float32; the normalization arithmetic stays in
    the activation dtype (the output is that dtype regardless, and this
    avoids an f32 materialization of the full activation)."""
    import os
    if "gn" in os.environ.get("MLIS_ABLATE", ""):
        # perf-attribution mode: scale-only, skips the reduction passes
        w0 = ctx.param(pre + ".weight", (x.shape[-1],), VEC, jnp.float32)
        b0 = ctx.param(pre + ".bias", (x.shape[-1],), VEC, jnp.float32)
        return x * w0.astype(x.dtype) + b0.astype(x.dtype)
    dt = x.dtype
    n, h, w, c = x.shape
    xg = x.reshape(n, h * w, n_grp, c // n_grp)
    # two-pass shifted variance (see layer_norm): robust when mean^2/var >> 1
    # (VAE decoder activations)
    mean = jnp.mean(xg, axis=(1, 3), keepdims=True, dtype=jnp.float32)
    var = jnp.mean(jnp.square(xg.astype(jnp.float32) - mean), axis=(1, 3),
                   keepdims=True)
    xg = ((xg - mean.astype(dt)) *
          jax.lax.rsqrt(var + eps).astype(dt))
    xf = xg.reshape(n, h, w, c)
    if affine:
        wt = ctx.param(pre + ".weight", (c,), VEC, jnp.float32)
        b = ctx.param(pre + ".bias", (c,), VEC, jnp.float32)
        xf = xf * wt.astype(dt) + b.astype(dt)
    return xf.astype(dt)


def downsample(ctx: Ctx, pre: str, x, ch_out: int, vae: bool = False):
    """ref: mlb_downsample (src/mlblock_nn.c:105-116)."""
    if vae:
        # asymmetric pad (0,1) on both spatial dims
        return conv2d(ctx, pre + ".conv", x, ch_out, 3, 2,
                      pad=[(0, 1), (0, 1)])
    return conv2d(ctx, pre + ".conv", x, ch_out, 3, 2, pad=1)


def upsample(ctx: Ctx, pre: str, x, ch_out: int):
    """ref: mlb_upsample (src/mlblock_nn.c:118-126). Nearest 2x then conv.

    Default: the nearest-neighbor duplication and the 3x3 conv collapse
    into ONE lhs-dilated conv with a pre-summed 4x4 kernel
    (K4[s,t] = sum_{a,b in {0,1}} W[s-a,t-b]): nearest-up is linear, so the
    composition is exact up to fp summation order, but XLA's phase
    decomposition then computes 4 MACs/output instead of 9 (4/9 the FLOPs)
    and the 2x-upsampled intermediate is never written to device memory.
    Its time on the GPU against the plain upsample is not measured yet.
    Opt out with MLIS_FUSED_UPSAMPLE=0."""
    import os
    ch_in = x.shape[-1]
    if os.environ.get("MLIS_FUSED_UPSAMPLE", "1") not in ("0", "false",
                                                          "no"):
        w = ctx.param(pre + ".conv.weight", (3, 3, ch_in, ch_out), CONV_W)
        w = w.astype(jnp.float32)
        w4 = jnp.zeros((4, 4, ch_in, ch_out), jnp.float32)
        for a in (0, 1):
            for b in (0, 1):
                w4 = w4.at[a:a + 3, b:b + 3].add(w)
        padding = ((2, 2), (2, 2))
        if ctx.tiling:
            # one wrapped input pixel per side reproduces the circular
            # dilated grid exactly (period-2h phase layout)
            x = jnp.pad(x, [(0, 0), (1, 1), (1, 1), (0, 0)], mode="wrap")
            padding = ((0, 0), (0, 0))
        y = jax.lax.conv_general_dilated(
            x, w4.astype(x.dtype), window_strides=(1, 1),
            padding=padding, lhs_dilation=(2, 2),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        b_ = ctx.param(pre + ".conv.bias", (ch_out,), VEC)
        return y + b_.astype(y.dtype)
    x = jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)
    return conv2d(ctx, pre + ".conv", x, ch_out, 3, 1, pad=1)


def resnet(ctx: Ctx, pre: str, x, emb, ch_out: int):
    """ref: mlb_resnet (src/mlblock_nn.c:129-156)."""
    ch_in = x.shape[-1]
    x0 = x
    x = group_norm(ctx, pre + ".norm1", x)
    x = silu(x)
    x = conv2d(ctx, pre + ".conv1", x, ch_out)
    if emb is not None:
        e = silu(emb)
        e = linear(ctx, pre + ".emb_proj", e, ch_out)
        x = x + e[:, None, None, :].astype(x.dtype)
    x = group_norm(ctx, pre + ".norm2", x)
    x = silu(x)
    x = conv2d(ctx, pre + ".conv2", x, ch_out)
    if ch_in != ch_out:
        x0 = conv2d(ctx, pre + ".skip_conv", x0, ch_out, 1, 1, pad=0)
    return x + x0


def geglu(ctx: Ctx, pre: str, x, d_out: int):
    """ref: mlb_GEGLU (src/mlblock_nn.c:159-172)."""
    y = linear(ctx, pre + ".proj", x, d_out * 2)
    xh, g = y[..., :d_out], y[..., d_out:]
    return xh * gelu_tanh(g)


def feed_forward(ctx: Ctx, pre: str, x, d_out: int, mult: int = 4):
    """ref: mlb_feed_forward (src/mlblock_nn.c:175-187)."""
    d_inner = x.shape[-1] * mult
    x = geglu(ctx, pre + ".net.0", x, d_inner)
    return linear(ctx, pre + ".net.2", x, d_out)


def attn_mhead(ctx: Ctx, pre: str, q, k, v, d_out: int, d_embed: int,
               n_head: int, mask: bool = False, bias: bool = False,
               bias_out: bool = True, identity: bool = False):
    """ref: mlb_attn_mhead (src/mlblock_nn.c:190-231).
    q: [N, Sq, *], k/v: [N, Sk, *]; returns [N, Sq, d_out].

    The head split and merge are reshapes: the projections emit
    [N, S, H, D], the layout :func:`attention` takes.

    ``identity``: perturbed-attention mode — the attention map is replaced
    by the identity (each token attends only to itself), so the output is
    ``out_proj(v_proj(v))`` with no token mixing.  The degraded forward
    used by perturbed-attention guidance (PAG); the head split is a no-op
    reshape here, so the projections compose to two plain linears."""
    if identity:
        o = linear(ctx, pre + ".v_proj", v, d_embed, bias)
        return linear(ctx, pre + ".out_proj", o, d_out, bias_out)
    d_head = d_embed // n_head
    n, sq = q.shape[0], q.shape[1]
    sk = k.shape[1]
    q = linear(ctx, pre + ".q_proj", q, d_embed, bias)
    k = linear(ctx, pre + ".k_proj", k, d_embed, bias)
    v = linear(ctx, pre + ".v_proj", v, d_embed, bias)
    o = attention(q.reshape(n, sq, n_head, d_head),
                  k.reshape(n, sk, n_head, d_head),
                  v.reshape(n, sk, n_head, d_head), causal=mask)
    return linear(ctx, pre + ".out_proj", o.reshape(n, sq, d_embed), d_out,
                  bias_out)


def basic_transformer(ctx: Ctx, pre: str, x, c, d_out: int, d_embed: int,
                      n_head: int, self_identity: bool = False):
    """ref: mlb_basic_transf (src/mlblock_nn.c:234-253).
    ``self_identity``: identity self-attention map (PAG perturbation)."""
    r = x
    x = layer_norm(ctx, pre + ".norm1", x)
    x = attn_mhead(ctx, pre + ".attn1", x, x, x, d_out, d_embed, n_head,
                   identity=self_identity)
    x = x + r
    r = x
    x = layer_norm(ctx, pre + ".norm2", x)
    x = attn_mhead(ctx, pre + ".attn2", x, c, c, d_out, d_embed, n_head)
    x = x + r
    r = x
    x = layer_norm(ctx, pre + ".norm3", x)
    x = feed_forward(ctx, pre + ".ff", x, d_out)
    return x + r


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """CompVis sinusoidal embedding, cos half then sin half
    (ref: ggml_timestep_embedding use in src/unet.c:150 and
    sd_timestep_embedding, src/mlimgsynth.c:1506-1518).  t: [N] float."""
    half = dim // 2
    freqs = jnp.exp(-math.log(max_period) *
                    jnp.arange(half, dtype=jnp.float32) / half)
    args = t.astype(jnp.float32)[:, None] * freqs[None, :]
    return jnp.concatenate([jnp.cos(args), jnp.sin(args)], axis=-1)
