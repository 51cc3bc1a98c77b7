"""Weight-only int4 matmul: unpack and dequantize, then a plain dot.

The 4-bit tier below ops/q8_matmul.py: weights live in device memory as
packed nibbles (two 4-bit values per int8 byte) with the same
per-[128 x column] f32 scales, quartering the bf16 weight footprint (Flux
12B: ~24 GiB bf16 -> ~11.75 int8 -> ~6.2 GiB int4 resident).  Activations
stay in their dtype and XLA decides where the dequantization runs.  The
reference's analog is computing directly from ggml q4 blocks (reference:
src/ccompute/tensorstore.c dequant tables); here 4-bit is a runtime path,
not only a load-time decode.

Quantization: symmetric per (K-block=128, output-column) group:
``w = q * scale``, q in [-7, 7], ``scale = max|w_block| / 7``.

Packing layout: within each 128-row K-block, row ``r`` of the 64 packed
bytes holds block-row ``r`` in the LOW nibble and block-row ``r + 64`` in
the HIGH nibble, so unpacking is two arithmetic shifts and one concat.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .q8_matmul import KBLOCK

HALF = KBLOCK // 2


def quantize_weight_q4(w: np.ndarray):
    """[K, N] float -> (packed int8 [K/2, N], f32 scales [K/128, N])."""
    k, n = w.shape
    assert k % KBLOCK == 0, (k, n)
    wb = np.asarray(w, np.float32).reshape(k // KBLOCK, KBLOCK, n)
    amax = np.abs(wb).max(axis=1, keepdims=True)
    scale = (amax / 7.0).astype(np.float32)
    q = np.clip(np.round(wb / np.maximum(scale, 1e-30)), -7, 7
                ).astype(np.int8)
    lo = q[:, :HALF, :] & 0x0F                    # block rows 0..63
    hi = q[:, HALF:, :] << 4                      # block rows 64..127
    packed = (lo | hi).astype(np.int8).reshape(k // 2, n)
    return packed, scale.reshape(k // KBLOCK, n)


def unpack_q4(packed, k):
    """[K/2, N] packed -> [K, N] int8."""
    n = packed.shape[1]
    pb = jnp.asarray(packed).reshape(k // KBLOCK, HALF, n)
    lo = (pb << 4) >> 4
    hi = pb >> 4
    return jnp.concatenate([lo, hi], axis=1).reshape(k, n)


def q4_dot(x, w_q4, w_scale):
    """x @ dequant(w): unpack + dequantize, then matmul in x's dtype."""
    k = x.shape[-1]
    n = w_q4.shape[1]
    q = unpack_q4(w_q4, k)
    w = (q.astype(jnp.float32).reshape(k // KBLOCK, KBLOCK, n)
         * w_scale[:, None, :]).reshape(k, n)
    return jnp.dot(x, w.astype(x.dtype))

