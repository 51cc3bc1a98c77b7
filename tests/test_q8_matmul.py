"""Weight-only int8 matmul: quantization accuracy, q8_dot against a numpy
dequantise-then-matmul reference, and quantized end-to-end generation."""
import jax.numpy as jnp
import numpy as np
import pytest

from mlimgsynth_tpu.ops import q8_matmul as q8

# (M, K, N): odd M (77 text tokens, 130), K a prime multiple of 128 (2432 =
# 19 x 128, sd35-large's width), K >> N and N >> K, N not a power of two
SHAPES = [(64, 256, 512), (77, 128, 512), (130, 384, 1024), (64, 2432, 128),
          (130, 2432, 512), (64, 1024, 1024), (77, 2432, 128),
          (100, 256, 384), (70, 384, 392), (77, 1024, 128),
          (200, 1024, 384), (2304, 512, 384)]

# f32: both sides accumulate K products of O(1) terms in float32 / float64.
# bf16: x is already bf16; the dequantised weight and the output each round
# to bf16 (2^-9 relative), so the bound is a small multiple of that.
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def np_dequant(q, s):
    """numpy reference: int8 [K, N] x per-(128-row block, column) scale."""
    k, n = q.shape
    return (q.astype(np.float64).reshape(k // 128, 128, n)
            * np.asarray(s, np.float64)[:, None, :]).reshape(k, n)


def test_quantize_roundtrip_error():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((256, 320)).astype(np.float32) * 0.05
    q, s = q8.quantize_weight(w)
    assert q.dtype == np.int8 and s.shape == (2, 320)
    wd = (q.astype(np.float32).reshape(2, 128, 320) * s[:, None, :]
          ).reshape(256, 320)
    rel = np.abs(wd - w).max() / np.abs(w).max()
    assert rel < 0.01  # int8 per-block quantization error


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_q8_dot_matches_numpy_dequant(m, k, n, dtype):
    rng = np.random.default_rng(m * 7 + k + n)
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32) * 0.3,
                    dtype)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    q, s = q8.quantize_weight(w)
    out = q8.q8_dot(x, jnp.asarray(q), jnp.asarray(s))
    assert out.shape == (m, n) and out.dtype == x.dtype
    ref = np.asarray(x, np.float64) @ np_dequant(q, s)
    err = np.abs(np.asarray(out, np.float64) - ref).max()
    assert err <= TOL[dtype] * np.abs(ref).max(), err


def test_batched_input_shape():
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 16, 256)).astype(np.float32))
    w = rng.standard_normal((256, 512)).astype(np.float32)
    q, s = q8.quantize_weight(w)
    out = q8.q8_dot(x, jnp.asarray(q), jnp.asarray(s))
    assert out.shape == (2, 16, 512)
    np.testing.assert_allclose(
        np.asarray(out).reshape(32, 512),
        np.asarray(x).reshape(32, 256) @ np_dequant(q, s), rtol=1e-4,
        atol=1e-3)


def test_q8_generation_close_to_fp(tmp_path, monkeypatch):
    """End-to-end: weight-type q8_0 generates an image close to the fp one."""
    from mlimgsynth_tpu.api import MLImgSynth
    from helpers import TINY_MODEL_TYPE, patch_tiny_model_types, \
        write_tiny_checkpoint
    ckpt = tmp_path / "tiny.safetensors"
    write_tiny_checkpoint(ckpt)

    def session(wt):
        patch_tiny_model_types(monkeypatch)
        s = MLImgSynth()
        s._dtype = jnp.float32
        s.option_set("model", str(ckpt))
        s.option_set("model-type", "sd1")
        s.option_set("image-dim", 64)
        s.option_set("steps", 2)
        s.option_set("seed", 11)
        if wt:
            s.option_set("weight-type", wt)
            s._dtype = jnp.float32  # keep f32 compute; only weights int8
        s.option_set("no-decode", True)  # compare raw latents
        s.option_set("prompt", "a dog")
        return s

    ref = session(None).generate()
    sq = session("q8_0")
    assert sq._weights_q8
    out = sq.generate()
    assert np.isfinite(out).all()
    assert any(k.endswith("_q8") for k in sq._params["unet"])
    # int8 weights perturb the latent slightly but not wildly
    diff = np.abs(out - ref).mean() / max(np.abs(ref).mean(), 1e-6)
    assert 0 < diff < 0.5, diff


def test_attn_mixed_quantization():
    """Cross-attention where k/v projections are int8 (K divisible by 128)
    but q/out are not: each projection takes its own linear() route."""
    from mlimgsynth_tpu.models import blocks as B
    rng = np.random.default_rng(6)
    d_model, d_ctx, n_head = 64, 128, 4   # k/v K=128 quantizes; q K=64 not
    spec = B.trace_spec(
        lambda ctx, x, c: B.attn_mhead(ctx, "blk.attn2", x, c, c,
                                       d_model, d_model, n_head),
        jnp.zeros((1, 16, d_model)), jnp.zeros((1, 7, d_ctx)))
    host = {k: (rng.standard_normal(
        (ps.shape[1], ps.shape[0]) if ps.kind == B.LINEAR_W else ps.shape)
        .astype(np.float32) * 0.05) for k, ps in spec.items()}
    from mlimgsynth_tpu.weights import _to_layout, quantize_linear_weights
    host = {k: _to_layout(v, spec[k], k) for k, v in host.items()}
    full = {k: jnp.asarray(v) for k, v in host.items()}
    n_q = quantize_linear_weights(host, spec)
    assert n_q >= 1  # k/v (and not q/out) quantized
    assert "blk.attn2.q_proj.weight" in host
    assert "blk.attn2.k_proj.weight_q8" in host
    qparams = {k: jnp.asarray(v) for k, v in host.items()}
    x = jnp.asarray(rng.standard_normal((1, 16, d_model)).astype(np.float32))
    c = jnp.asarray(rng.standard_normal((1, 7, d_ctx)).astype(np.float32))
    ref = B.attn_mhead(B.Ctx(full, dtype=jnp.float32), "blk.attn2", x, c, c,
                       d_model, d_model, n_head)
    out = B.attn_mhead(B.Ctx(qparams, dtype=jnp.float32), "blk.attn2", x, c,
                       c, d_model, d_model, n_head)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=0.05)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_linear_weights_skips_unaligned_k(bits):
    """Only linears whose K is a multiple of 128 are quantized; the rest
    stay in the compute dtype, and every pair is stored per 128-row block."""
    from mlimgsynth_tpu import weights as W
    from mlimgsynth_tpu.models.blocks import LINEAR_W, VEC, ParamSpec
    rng = np.random.default_rng(14)
    spec = {
        "blk.a.weight": ParamSpec((256, 384), LINEAR_W, jnp.bfloat16),
        "blk.b.weight": ParamSpec((80, 128), LINEAR_W, jnp.bfloat16),
        "blk.a.bias": ParamSpec((384,), VEC, jnp.bfloat16),
    }
    host = {name: rng.standard_normal(ps.shape).astype(np.float32) * 0.02
            for name, ps in spec.items()}
    assert W.quantize_linear_weights(host, spec, bits=bits) == 1
    tag = f"blk.a.weight_q{bits}"
    assert tag in host and "blk.a.weight" not in host
    assert host["blk.a.weight_scale"].shape == (2, 384)
    assert host[tag].shape == ((256 if bits == 8 else 128), 384)
    assert "blk.b.weight" in host and "blk.a.bias" in host
