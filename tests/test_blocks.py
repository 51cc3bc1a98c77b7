"""Block-level parity tests against torch (independent implementation)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mlimgsynth_tpu.models import blocks as B

DT = jnp.float32


def ctx_with(params):
    return B.Ctx(params={k: jnp.asarray(v) for k, v in params.items()},
                 dtype=DT)


def rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_linear_vs_torch():
    x = rand(2, 5, 16)
    w = rand(32, 16, seed=1)  # torch [out, in]
    b = rand(32, seed=2)
    ctx = ctx_with({"l.weight": w.T, "l.bias": b})
    got = np.asarray(B.linear(ctx, "l", jnp.asarray(x), 32))
    ref = F.linear(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("stride,pad", [(1, 1), (2, 1), (1, 0)])
def test_conv2d_vs_torch(stride, pad):
    x = rand(2, 8, 8, 3)
    w = rand(5, 3, 3, 3, seed=1)  # torch OIHW
    b = rand(5, seed=2)
    ctx = ctx_with({"c.weight": w.transpose(2, 3, 1, 0), "c.bias": b})
    got = np.asarray(B.conv2d(ctx, "c", jnp.asarray(x), 5, 3, stride, pad))
    ref = F.conv2d(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                   torch.from_numpy(w), torch.from_numpy(b),
                   stride=stride, padding=pad).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_vae_downsample_asymmetric_pad():
    # reference pads (0,1) then convs with stride 2, pad 0 (src/mlblock_nn.c:109-112)
    x = rand(1, 8, 8, 4)
    w = rand(4, 4, 3, 3, seed=1)
    b = np.zeros(4, np.float32)
    ctx = ctx_with({"d.conv.weight": w.transpose(2, 3, 1, 0), "d.conv.bias": b})
    got = np.asarray(B.downsample(ctx, "d", jnp.asarray(x), 4, vae=True))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    xt = F.pad(xt, (0, 1, 0, 1))
    ref = F.conv2d(xt, torch.from_numpy(w), torch.from_numpy(b),
                   stride=2).numpy().transpose(0, 2, 3, 1)
    assert got.shape == (1, 4, 4, 4)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_layer_norm_vs_torch():
    x = rand(2, 7, 16)
    w, b = rand(16, seed=1), rand(16, seed=2)
    ctx = ctx_with({"n.weight": w, "n.bias": b})
    got = np.asarray(B.layer_norm(ctx, "n", jnp.asarray(x)))
    ref = F.layer_norm(torch.from_numpy(x), (16,), torch.from_numpy(w),
                       torch.from_numpy(b), eps=1e-5).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_group_norm_vs_torch():
    x = rand(2, 6, 6, 32)
    w, b = rand(32, seed=1), rand(32, seed=2)
    ctx = ctx_with({"g.weight": w, "g.bias": b})
    got = np.asarray(B.group_norm(ctx, "g", jnp.asarray(x), n_grp=8, eps=1e-6))
    ref = F.group_norm(torch.from_numpy(x.transpose(0, 3, 1, 2)), 8,
                       torch.from_numpy(w), torch.from_numpy(b),
                       eps=1e-6).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_fused_upsample_matches_unfused(monkeypatch):
    """MLIS_FUSED_UPSAMPLE=1 (one lhs-dilated conv with a pre-summed 4x4
    kernel) must equal nearest-up + 3x3 conv to fp tolerance — the
    composition is exact mathematically."""
    x = rand(2, 8, 8, 16, seed=4)
    w = rand(3, 3, 16, 12, seed=5) * 0.1
    b = rand(12, seed=6) * 0.1
    ctx = ctx_with({"u.conv.weight": w, "u.conv.bias": b})
    monkeypatch.setenv("MLIS_FUSED_UPSAMPLE", "0")
    ref = np.asarray(B.upsample(ctx, "u", jnp.asarray(x), 12))
    monkeypatch.setenv("MLIS_FUSED_UPSAMPLE", "1")  # the default
    got = np.asarray(B.upsample(ctx, "u", jnp.asarray(x), 12))
    assert got.shape == (2, 16, 16, 12)
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_norms_large_mean_robust():
    """Cancellation robustness (ADVICE r2): VAE decoder activations reach
    large magnitudes where mean^2/var >> 1; one-pass E[x^2]-mean^2 variance
    underestimates badly there.  Compare against float64 ground truth at
    offset 300, std 1 (mean^2/var ~ 1e5) — torch's own F.group_norm shows
    ~4e-2 error on this input (it uses the one-pass form), so it is not a
    valid oracle here; f64 is."""
    base = rand(2, 6, 6, 32, seed=3) + 300.0
    w, b = rand(32, seed=1), rand(32, seed=2)
    ctx = ctx_with({"g.weight": w, "g.bias": b,
                    "n.weight": w, "n.bias": b})

    def f64_norm(x64, axes, eps):
        m = x64.mean(axis=axes, keepdims=True)
        v = ((x64 - m) ** 2).mean(axis=axes, keepdims=True)
        return (x64 - m) / np.sqrt(v + eps)

    got = np.asarray(B.group_norm(ctx, "g", jnp.asarray(base), n_grp=8,
                                  eps=1e-6))
    xg = base.astype(np.float64).reshape(2, 36, 8, 4)
    ref = (f64_norm(xg, (1, 3), 1e-6).reshape(2, 6, 6, 32) * w + b)
    np.testing.assert_allclose(got, ref, atol=5e-4)

    got = np.asarray(B.layer_norm(ctx, "n", jnp.asarray(base[0, 0])))
    ref = f64_norm(base[0, 0].astype(np.float64), -1, 1e-5) * w + b
    np.testing.assert_allclose(got, ref, atol=5e-4)


def test_activations_vs_torch():
    x = rand(100)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(np.asarray(B.silu(jnp.asarray(x))),
                               F.silu(xt).numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(B.gelu_tanh(jnp.asarray(x))),
                               F.gelu(xt, approximate="tanh").numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(B.gelu_exact(jnp.asarray(x))),
                               F.gelu(xt).numpy(), atol=1e-6)
    # gelu_quick = x*sigmoid(1.702x)
    np.testing.assert_allclose(np.asarray(B.gelu_quick(jnp.asarray(x))),
                               (xt * torch.sigmoid(1.702 * xt)).numpy(),
                               atol=1e-6)


def _bshd(x):
    """torch's [B, H, S, D] <-> attention_xla's [B, S, H, D]."""
    return jnp.asarray(x).transpose(0, 2, 1, 3)


def test_attention_vs_torch():
    from mlimgsynth_tpu.ops.attention import attention_xla
    q = rand(2, 4, 9, 16)
    k = rand(2, 4, 7, 16, seed=1)
    v = rand(2, 4, 7, 16, seed=2)
    got = np.asarray(_bshd(attention_xla(_bshd(q), _bshd(k), _bshd(v))))
    ref = F.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_attention_causal_vs_torch():
    from mlimgsynth_tpu.ops.attention import attention_xla
    q = rand(1, 2, 8, 8)
    k = rand(1, 2, 8, 8, seed=1)
    v = rand(1, 2, 8, 8, seed=2)
    got = np.asarray(_bshd(attention_xla(_bshd(q), _bshd(k), _bshd(v),
                                         causal=True)))
    ref = F.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=True).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_timestep_embedding_compvis():
    # ref formula: out[i]=cos(t*f_i), out[i+half]=sin(t*f_i),
    # f_i = exp(-ln(10000) i/half)  (src/mlimgsynth.c:1502-1518)
    t = np.array([999.0, 0.0, 3.5], np.float32)
    got = np.asarray(B.timestep_embedding(jnp.asarray(t), 320))
    half = 160
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half)
    for s, tv in enumerate(t):
        # f32 trig of args up to ~1000 rad: ~1e-4 abs error is expected
        # (the reference computes in f32 as well)
        np.testing.assert_allclose(got[s, :half], np.cos(tv * freqs),
                                   atol=5e-4)
        np.testing.assert_allclose(got[s, half:], np.sin(tv * freqs),
                                   atol=5e-4)


def test_upsample_nearest():
    x = rand(1, 2, 2, 8)
    w = np.zeros((8, 8, 3, 3), np.float32)
    for i in range(8):
        w[i, i, 1, 1] = 1.0  # identity conv
    ctx = ctx_with({"u.conv.weight": w.transpose(2, 3, 1, 0),
                    "u.conv.bias": np.zeros(8, np.float32)})
    got = np.asarray(B.upsample(ctx, "u", jnp.asarray(x), 8))
    ref = F.interpolate(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                        scale_factor=2, mode="nearest")
    np.testing.assert_allclose(got, ref.numpy().transpose(0, 2, 3, 1),
                               atol=1e-6)


def test_spec_trace():
    def f(ctx, x):
        x = B.linear(ctx, "a", x, 8)
        return B.conv2d(ctx, "b", x[:, None, None, :], 4, 1, 1, 0)

    spec = B.trace_spec(f, jnp.zeros((2, 16)))
    assert spec["a.weight"].shape == (16, 8)
    assert spec["a.weight"].kind == B.LINEAR_W
    assert spec["b.weight"].shape == (1, 1, 8, 4)
    assert spec["b.weight"].kind == B.CONV_W
    assert spec["a.bias"].kind == B.VEC
