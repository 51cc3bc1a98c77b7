"""Attention ops: one shape rule picks cuDNN's fused kernel or XLA's softmax.

The reference computes full-softmax attention ``softmax(K^T Q / sqrt(d)) V``
(reference: src/ggml_extend.c:200-222) head-batched on a single device; its
flash-attention flag is disabled as broken.  Here :func:`attention_route`
sends each call either to cuDNN's fused attention (through
``jax.nn.dot_product_attention(implementation="cudnn")``) or to
:func:`attention_xla`, the O(n^2) softmax that XLA compiles and that every
test compares against.

Layout: every tensor is ``[B, S, H, D]`` (batch, tokens, heads, head dim),
the layout cuDNN takes, so the projections feed it through a reshape and no
transpose is materialised.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp

# Set by the session when a multi-device mesh is active.  Read at trace
# time; mesh-sharded inputs force a fresh trace (shardings are part of the
# jit cache key), so the setting takes effect per session setup.  cuDNN's
# fused attention carries its own GSPMD partitioning rule over batch and
# heads, so dp/tp meshes need no wrapper; only sp reroutes (ring attention).
MESH = None

# Trace-time depth counter: >0 while tracing code that already runs
# per-device inside a shard_map (e.g. the pipeline-parallel block stack).
# Nested shard_maps are illegal, so the sp wrappers are skipped there.
_LOCAL_ONLY = 0

# cuDNN's fused attention on Hopper takes bf16/fp16 with a head dim that is
# a multiple of 8 and at most 256 (jax/_src/cudnn/fused_attention_stablehlo
# check_is_flash_attention).
_CUDNN_DTYPES = (jnp.bfloat16, jnp.float16)
_CUDNN_MAX_D = 256


class local_only:
    """Context manager: treat the session mesh as absent while tracing a
    region that is already per-device (inside an enclosing shard_map)."""

    def __enter__(self):
        global _LOCAL_ONLY
        _LOCAL_ONLY += 1
        return self

    def __exit__(self, *exc):
        global _LOCAL_ONLY
        _LOCAL_ONLY -= 1
        return False


def _sp_size() -> int:
    if MESH is None or _LOCAL_ONLY:
        return 1
    from ..parallel.mesh import SP_AXIS
    return MESH.shape.get(SP_AXIS, 1)


def _sp_attention(q, k, v, scale, causal):
    """Sequence-parallel routing: ring attention when the token axis is
    sharded over ``sp`` (self/joint attention), q-sharded local attention for
    short cross-attention contexts.  Returns None when batch or heads don't
    divide the mesh (caller falls through to the replicated-sequence
    paths).  Causal masking is not wired through the ring (no caller needs
    it)."""
    if causal:
        return None
    from ..parallel import ring_attention as ring
    if not ring.sp_compatible(MESH, q.shape[0], q.shape[2]):
        _warn_sp_fallback(q.shape, k.shape)
        return None
    if q.shape[1] == k.shape[1]:
        return ring.ring_attention(q, k, v, MESH, scale=scale)
    return ring.sp_cross_attention(q, k, v, MESH, scale=scale)


_SP_FALLBACK_SEEN: set = set()


def _warn_sp_fallback(q_shape, k_shape) -> None:
    """--sp was requested but this attention shape can't ride the ring
    (batch or heads don't divide the dp/tp mesh axes): make the GSPMD
    fallback visible instead of silently changing the parallel strategy."""
    key = (tuple(q_shape), tuple(k_shape))
    if key in _SP_FALLBACK_SEEN:
        return
    _SP_FALLBACK_SEEN.add(key)
    from ..utils.log import g_logger
    g_logger.warning(
        f"sp: attention q{tuple(q_shape)} x kv{tuple(k_shape)} does not "
        f"divide the dp/tp mesh axes; falling back to GSPMD sharding for "
        f"this shape (no ring attention)")


def attention_xla(q, k, v, scale=None, causal=False):
    """Reference attention. q,k,v: [B, Sq|Sk, H, D]; returns [B, Sq, H, D].

    Logits and softmax accumulate in f32 regardless of input dtype.
    """
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                        preferred_element_type=jnp.float32) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = jnp.tril(jnp.ones((sq, sk), bool), k=sk - sq)
        logits = jnp.where(mask, logits, -jnp.inf)
    w = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    return jnp.einsum("bhqk,bkhd->bqhd", w, v)


def attention_route(d: int, dtype, platform: str) -> str:
    """The one shape rule: ``"cudnn"`` or ``"xla"``.

    cuDNN's fused kernel runs wherever it accepts the shape: on the GPU, in
    bf16/fp16, with a head dim that is a multiple of 8 and <= 256.  On the
    H100 it beat XLA's softmax 2.3-5x on every self/joint attention of the
    model families and took SD1.5 e2e from 0.287 to 0.182 s/image; the
    77-token cross-attention is within noise of XLA per call, and routing it
    to XLA cost 3-7% e2e (PERF.md).  Everything else (f32 sessions, the
    VAE's d=512 mid-block, the CPU) runs :func:`attention_xla`."""
    if (platform == "gpu" and jnp.dtype(dtype) in _CUDNN_DTYPES
            and d % 8 == 0 and d <= _CUDNN_MAX_D):
        return "cudnn"
    return "xla"


def attention(q, k, v, scale=None, causal=False):
    """q,k,v: [B, S, H, D] -> [B, Sq, H, D], routed by
    :func:`attention_route`."""
    if "attn" in os.environ.get("MLIS_ABLATE", ""):
        # perf-attribution mode (tools/step_bench.py): skip the softmax
        # attention itself, keep projections — NOT for real generation
        mean_v = jnp.mean(v, axis=1, keepdims=True)
        return jnp.broadcast_to(mean_v, q.shape[:3] + (v.shape[-1],))
    if _sp_size() > 1:
        o = _sp_attention(q, k, v, scale, causal)
        if o is not None:
            return o
    # cuDNN aligns a causal mask top-left, attention_xla bottom-right; they
    # agree when Sq == Sk (CLIP, the only causal caller)
    if (attention_route(q.shape[-1], q.dtype, jax.default_backend())
            == "cudnn" and not (causal and q.shape[1] != k.shape[1])):
        return jax.nn.dot_product_attention(
            q, k, v, scale=scale, is_causal=causal, implementation="cudnn")
    return attention_xla(q, k, v, scale=scale, causal=causal)
