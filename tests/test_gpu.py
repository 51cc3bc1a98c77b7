"""Checks that only the card can make: cuDNN's fused attention against the
XLA reference, compiled into the UNet step.  Run on the GPU with
``python -m pytest tests/test_gpu.py -m gpu``; elsewhere they skip."""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on "
                    f"'{jax.default_backend()}'")
    return jax.devices()[0]


@pytest.mark.parametrize("shape", [(2, 256, 256, 8, 40), (2, 256, 77, 8, 40),
                                   (1, 300, 300, 4, 64),
                                   (1, 128, 128, 2, 128)])
def test_cudnn_route_matches_xla(gpu, shape):
    import jax
    import jax.numpy as jnp
    from mlimgsynth_tpu.ops import attention as A
    b, sq, sk, h, d = shape
    assert A.attention_route(d, jnp.bfloat16, "gpu") == "cudnn"
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(ks[0], (b, sq, h, d), jnp.bfloat16)
    k = jax.random.normal(ks[1], (b, sk, h, d), jnp.bfloat16)
    v = jax.random.normal(ks[2], (b, sk, h, d), jnp.bfloat16)
    out = np.asarray(jax.jit(A.attention)(q, k, v), np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(A.attention_xla(*(x.astype(jnp.float32)
                                           for x in (q, k, v))))
    assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()


def test_unet_step_holds_cudnn_attention(gpu):
    import jax
    import jax.numpy as jnp
    from mlimgsynth_tpu.models import blocks as B
    from mlimgsynth_tpu.models import unet as U
    from mlimgsynth_tpu.testing import TINY_UNET
    x = jnp.zeros((2, 8, 8, 4), jnp.bfloat16)
    t = jnp.zeros((2,))
    c = jnp.zeros((2, 77, TINY_UNET.n_ctx), jnp.bfloat16)
    spec = B.trace_spec(
        lambda ctx, x, t, c: U.unet_apply(ctx, x, t, c, None, TINY_UNET),
        x, t, c)
    params = {k: jnp.full(ps.shape, 0.01, jnp.bfloat16)
              for k, ps in spec.items()}
    f = jax.jit(lambda p, x, t, c: U.unet_apply(
        B.Ctx(p, dtype=jnp.bfloat16), x, t, c, None, TINY_UNET))
    assert "cudnn$fmha" in f.lower(params, x, t, c).compile().as_text()
