"""Weight-only int8 matmul: dequantize, then a plain dot.

The reference computes directly on ggml-quantized weights (q8_0 etc.) to
cut memory; here weights stay int8 in device memory with per-[128 x column]
float scales and are dequantized to the activation dtype right before the
dot.  The weight footprint halves against bf16; activations keep their
dtype and XLA decides where the dequantization runs.

Quantization: symmetric per (K-block=128, output-column) group:
``w = q * scale``, ``q`` int8, ``scale = max|w_block| / 127``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

KBLOCK = 128


def quantize_weight(w: np.ndarray):
    """[K, N] float -> (int8 [K, N], f32 scales [K/128, N]).

    K is padded to a multiple of 128 by the caller's layout (model dims
    always are)."""
    k, n = w.shape
    assert k % KBLOCK == 0, (k, n)
    wb = np.asarray(w, np.float32).reshape(k // KBLOCK, KBLOCK, n)
    amax = np.abs(wb).max(axis=1, keepdims=True)
    scale = (amax / 127.0).astype(np.float32)
    q = np.clip(np.round(wb / np.maximum(scale, 1e-30)), -127, 127)
    return (q.astype(np.int8).reshape(k, n),
            scale.reshape(k // KBLOCK, n))


def q8_dot(x, w_q8, w_scale):
    """x @ dequant(w): dequantize, then matmul in x's dtype."""
    k, n = w_q8.shape
    w = (w_q8.astype(jnp.float32).reshape(k // KBLOCK, KBLOCK, n)
         * w_scale[:, None, :]).reshape(k, n)
    return jnp.dot(x, w.astype(x.dtype))

