"""Attention: the shape rule that picks cuDNN or XLA, and the XLA paths
against a float64 numpy softmax reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlimgsynth_tpu.ops import attention as A


def np_attention(q, k, v, causal=False, bottom_right=True):
    """float64 numpy reference; q,k,v [B, S, H, D].  With Sq < Sk the
    causal mask aligns the last query with the last key (attention_xla)
    or the first with the first (jax.nn.dot_product_attention)."""
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        sq, sk = s.shape[-2:]
        diag = sk - sq if bottom_right else 0
        s = np.where(np.tril(np.ones((sq, sk), bool), k=diag), s, -np.inf)
    s = s - s.max(axis=-1, keepdims=True)
    w = np.exp(s)
    w /= w.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", w, v)


# (model width, head dim, dtype, platform) -> route.  cuDNN takes bf16/fp16
# heads that are multiples of 8 up to 256 on the GPU; the rest is XLA.
ROUTES = [
    ("sd1 level0", 40, jnp.bfloat16, "gpu", "cudnn"),
    ("sd1 level1", 80, jnp.bfloat16, "gpu", "cudnn"),
    ("sd1 level2", 160, jnp.bfloat16, "gpu", "cudnn"),
    ("sdxl/sd3", 64, jnp.bfloat16, "gpu", "cudnn"),
    ("flux", 128, jnp.bfloat16, "gpu", "cudnn"),
    ("fp16 session", 64, jnp.float16, "gpu", "cudnn"),
    ("largest cuDNN head", 256, jnp.bfloat16, "gpu", "cudnn"),
    ("vae mid-block", 512, jnp.bfloat16, "gpu", "xla"),
    ("f32 session", 64, jnp.float32, "gpu", "xla"),
    ("f32 sd1", 40, jnp.float32, "gpu", "xla"),
    ("odd head", 36, jnp.bfloat16, "gpu", "xla"),
    ("cpu bf16", 64, jnp.bfloat16, "cpu", "xla"),
    ("cpu f32", 40, jnp.float32, "cpu", "xla"),
]


@pytest.mark.parametrize("name,d,dtype,platform,want", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_attention_route(name, d, dtype, platform, want):
    assert A.attention_route(d, dtype, platform) == want


@pytest.mark.parametrize("route", ["cudnn", "xla"])
def test_attention_names_its_implementation(route, monkeypatch):
    """attention() asks dot_product_attention for cuDNN by name (never
    implementation=None, which falls back silently) and sends the XLA
    route to attention_xla."""
    seen = []
    real = jax.nn.dot_product_attention

    def spy(*a, implementation=None, **kw):
        seen.append(implementation)
        return real(*a, implementation="xla", **kw)

    monkeypatch.setattr(jax.nn, "dot_product_attention", spy)
    monkeypatch.setattr(A, "attention_route", lambda d, dt, p: route)
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.standard_normal((1, 16, 2, 8)), jnp.bfloat16)
               for _ in range(3))
    out = A.attention(q, k, v)
    assert out.shape == (1, 16, 2, 8)
    assert seen == (["cudnn"] if route == "cudnn" else [])


CASES = [  # (B, Sq, Sk, H, causal)
    ("self", 2, 48, 48, 2, False),
    ("cross", 2, 40, 77, 2, False),
    ("causal", 1, 33, 33, 2, True),
    ("causal sq<sk", 1, 16, 40, 1, True),
]


@pytest.mark.parametrize("impl", ["attention_xla", "jax_nn_xla"])
@pytest.mark.parametrize("d", [40, 64, 128, 512])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_xla_paths_match_numpy(case, d, impl):
    _, b, sq, sk, h, causal = case
    rng = np.random.default_rng(d + sq + sk)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    if impl == "attention_xla":
        out = A.attention_xla(q, k, v, causal=causal)
    else:
        out = jax.nn.dot_product_attention(q, k, v, is_causal=causal,
                                           implementation="xla")
    ref = np_attention(q, k, v, causal, bottom_right=impl == "attention_xla")
    # float32 logits over d terms and a float32 softmax: a few f32 ulps
    np.testing.assert_allclose(np.asarray(out, np.float64), ref,
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("d", [40, 64, 128])
def test_attention_bf16_matches_numpy(d):
    """The routed wrapper in bf16 (XLA on the CPU) stays within bf16
    rounding of the float64 reference of the same bf16 inputs."""
    rng = np.random.default_rng(d)
    q, k, v = (jnp.asarray(rng.standard_normal((2, 64, 2, d)), jnp.bfloat16)
               for _ in range(3))
    out = np.asarray(A.attention(q, k, v).astype(jnp.float32))
    ref = np_attention(q.astype(jnp.float32), k.astype(jnp.float32),
                       v.astype(jnp.float32))
    assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()
