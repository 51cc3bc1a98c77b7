"""Weight-only int4 matmul: packing, q4_dot against a numpy
dequantise-then-matmul reference, and quantized end-to-end generation."""
import jax.numpy as jnp
import numpy as np
import pytest

from mlimgsynth_tpu.ops import q4_matmul as q4
from test_q8_matmul import SHAPES, TOL


def np_dequant_q4(w, s):
    """numpy reference: re-derive the int4 values from the float weight
    (independent of the packing) and scale them per 128-row block."""
    k, n = w.shape
    wb = w.astype(np.float64).reshape(k // 128, 128, n)
    sb = np.asarray(s, np.float64)[:, None, :]
    qv = np.clip(np.round(wb / np.maximum(sb, 1e-30)), -7, 7)
    return (qv * sb).reshape(k, n)


def test_pack_unpack_exact():
    """Packing two nibbles per byte and unpacking is lossless for the
    quantized values (sign extension included)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((256, 320)).astype(np.float32) * 0.05
    packed, s = q4.quantize_weight_q4(w)
    assert packed.dtype == np.int8 and packed.shape == (128, 320)
    assert s.shape == (2, 320)
    qv = np.asarray(q4.unpack_q4(packed, 256))
    assert qv.min() >= -7 and qv.max() <= 7
    # re-derive the expected quantized values
    wb = w.reshape(2, 128, 320)
    expect = np.clip(np.round(wb / np.maximum(s[:, None, :], 1e-30)),
                     -7, 7).astype(np.int8).reshape(256, 320)
    np.testing.assert_array_equal(qv, expect)


def test_quantize_roundtrip_error():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((256, 320)).astype(np.float32) * 0.05
    packed, s = q4.quantize_weight_q4(w)
    qv = np.asarray(q4.unpack_q4(packed, 256), np.float32)
    wd = (qv.reshape(2, 128, 320) * s[:, None, :]).reshape(256, 320)
    rel = np.abs(wd - w).max() / np.abs(w).max()
    assert rel < 0.15  # int4 per-block quantization error


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_q4_dot_matches_numpy_dequant(m, k, n, dtype):
    rng = np.random.default_rng(m * 5 + k + n)
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32) * 0.3,
                    dtype)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    packed, s = q4.quantize_weight_q4(w)
    out = q4.q4_dot(x, jnp.asarray(packed), jnp.asarray(s))
    assert out.shape == (m, n) and out.dtype == x.dtype
    ref = np.asarray(x, np.float64) @ np_dequant_q4(w, s)
    err = np.abs(np.asarray(out, np.float64) - ref).max()
    assert err <= TOL[dtype] * np.abs(ref).max(), err


def test_batched_input_shape():
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 16, 256)).astype(np.float32))
    w = rng.standard_normal((256, 512)).astype(np.float32)
    packed, s = q4.quantize_weight_q4(w)
    out = q4.q4_dot(x, jnp.asarray(packed), jnp.asarray(s))
    assert out.shape == (2, 16, 512)


def test_q4_generation_close_to_fp(tmp_path, monkeypatch):
    """End-to-end: weight-type q4_0 runs the packed-int4 linears and
    generates an image close to the fp one (int4 noise is visible but
    bounded on the tiny model)."""
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from helpers import patch_tiny_model_types, write_tiny_checkpoint
    from mlimgsynth_tpu.api import MLImgSynth

    ckpt = tmp_path / "tiny.safetensors"
    write_tiny_checkpoint(ckpt)

    def gen(wt):
        patch_tiny_model_types(monkeypatch)
        s = MLImgSynth()
        s._dtype = jnp.float32
        s.option_set("model", str(ckpt))
        s.option_set("model-type", "sd1")
        if wt:
            s.option_set("weight-type", wt)
        s.option_set("image-dim", 64)
        s.option_set("steps", 2)
        s.option_set("seed", 3)
        s.option_set("prompt", "an int4 test")
        img = s.generate()
        return img, s

    base, _ = gen("")
    img, s = gen("q4_0")
    assert s._weights_qbits == 4
    # the packed pairs actually exist in the loaded unet params
    dev = s._get_params("unet")
    assert any(k.endswith(".weight_q4") for k in dev)
    assert not any(k.endswith(".weight_q8") for k in dev)
    assert np.isfinite(img).all()
    assert np.abs(img - base).mean() < 0.15
