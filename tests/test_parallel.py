"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlimgsynth_tpu.models import blocks as B
from mlimgsynth_tpu.models import unet as unet_mod
from mlimgsynth_tpu.parallel import mesh as pmesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

TINY = unet_mod.UnetParams(
    n_ch=32, ch_mult=(1, 2), transf_depth=(1, 1), attn_res=(1, 2),
    n_head=4, n_te=64, n_ctx=32)


def _tiny_setup():
    def f(ctx, x, t, c):
        return unet_mod.unet_apply(ctx, x, t, c, None, TINY)

    x = jnp.zeros((4, 8, 8, 4))
    t = jnp.full((4,), 500.0)
    c = jnp.zeros((4, 7, 32))
    spec = B.trace_spec(f, x, t, c)
    rng = np.random.default_rng(0)
    params = {k: jnp.asarray(
        rng.standard_normal(s.shape).astype(np.float32) * 0.05)
        for k, s in spec.items()}
    rngx = np.random.default_rng(1)
    xv = jnp.asarray(rngx.standard_normal((4, 8, 8, 4)).astype(np.float32))
    cv = jnp.asarray(rngx.standard_normal((4, 7, 32)).astype(np.float32))
    return f, params, xv, t, cv


def test_mesh_shapes():
    m = pmesh.make_mesh(8, tp=4)
    assert dict(m.shape) == {"dp": 2, "pp": 1, "sp": 1, "tp": 4}
    m = pmesh.make_mesh(8, tp=1)
    assert dict(m.shape) == {"dp": 8, "pp": 1, "sp": 1, "tp": 1}
    m = pmesh.make_mesh(8, tp=2, sp=2)
    assert dict(m.shape) == {"dp": 2, "pp": 1, "sp": 2, "tp": 2}


def test_tp_rules():
    from jax.sharding import PartitionSpec as P
    assert pmesh.param_spec(
        "unet.in.1.1.transf.0.attn2.k_proj.weight", 2) == P(None, "tp")
    assert pmesh.param_spec(
        "unet.in.1.1.transf.0.attn1.out_proj.weight", 2) == P("tp", None)
    assert pmesh.param_spec(
        "clip.text.encoder.layers.3.mlp.fc1.weight", 2) == P(None, "tp")
    assert pmesh.param_spec("unet.in.conv.weight", 4) == P()
    # MMDiT (SD3) fused-qkv + MMDiT-X dual attention
    assert pmesh.param_spec(
        "mmdit.joint_blocks.2.x_block.attn.qkv.weight", 2) == P(None, "tp")
    assert pmesh.param_spec(
        "mmdit.joint_blocks.2.x_block.attn2.proj.weight", 2) == P("tp", None)
    # Flux double/single-stream
    assert pmesh.param_spec(
        "flux.double_blocks.0.img_attn.qkv.weight", 2) == P(None, "tp")
    assert pmesh.param_spec(
        "flux.double_blocks.0.txt_attn.proj.weight", 2) == P("tp", None)
    assert pmesh.param_spec(
        "flux.double_blocks.0.img_mlp.0.weight", 2) == P(None, "tp")
    assert pmesh.param_spec(
        "flux.double_blocks.0.txt_mlp.2.weight", 2) == P("tp", None)
    assert pmesh.param_spec(
        "flux.single_blocks.7.linear1.weight", 2) == P(None, "tp")
    assert pmesh.param_spec(
        "flux.single_blocks.7.linear2.weight", 2) == P("tp", None)
    # flux qk-norm scales and modulations stay replicated
    assert pmesh.param_spec(
        "flux.double_blocks.0.img_attn.norm.query_norm.scale", 1) == P()
    assert pmesh.param_spec(
        "flux.single_blocks.7.modulation.lin.weight", 2) == P()
    # T5 encoder
    assert pmesh.param_spec(
        "t5.encoder.block.3.layer.0.SelfAttention.q.weight", 2) \
        == P(None, "tp")
    assert pmesh.param_spec(
        "t5.encoder.block.3.layer.0.SelfAttention.o.weight", 2) \
        == P("tp", None)
    assert pmesh.param_spec(
        "t5.encoder.block.3.layer.1.DenseReluDense.wi_1.weight", 2) \
        == P(None, "tp")
    assert pmesh.param_spec(
        "t5.encoder.block.3.layer.1.DenseReluDense.wo.weight", 2) \
        == P("tp", None)
    assert pmesh.param_spec(
        "t5.encoder.block.3.layer.0.SelfAttention"
        ".relative_attention_bias.weight", 2) == P()


def test_dp_tp_unet_matches_single_device():
    f, params, x, t, c = _tiny_setup()
    ctx = B.Ctx(params, dtype=jnp.float32)
    ref = np.asarray(jax.jit(lambda x, t, c: f(ctx, x, t, c))(x, t, c))

    mesh = pmesh.make_mesh(8, tp=4)  # dp=2 x tp=4
    sp = pmesh.shard_params(params, mesh)
    xs = pmesh.shard_batch(x, mesh)
    cs = pmesh.shard_batch(c, mesh)
    ts = pmesh.shard_batch(t, mesh)

    ctx_s = B.Ctx(sp, dtype=jnp.float32)
    out = jax.jit(lambda x, t, c: f(ctx_s, x, t, c))(xs, ts, cs)
    np.testing.assert_allclose(np.asarray(out), ref, atol=2e-5)


def test_sampler_loop_sharded():
    """Full denoise loop under dp sharding produces the single-device result."""
    from mlimgsynth_tpu.rng import RngPhilox
    from mlimgsynth_tpu.sampling.sampler import (SamplerConfig, make_plan,
                                                 run_sampler)

    f, params, x, t, c = _tiny_setup()
    cfg = SamplerConfig(method="euler", n_step=2, cfg_scale=1.0)
    plan = make_plan(cfg, (4, 4, 8, 8), RngPhilox(seed=3))
    x0 = np.zeros((4, 4, 8, 8), np.float32)
    ref = run_sampler(params, x0, plan, np.asarray(c), None, None, None,
                      None, cfg, TINY, dtype=jnp.float32)

    mesh = pmesh.make_mesh(8, tp=4)
    sp = pmesh.shard_params(params, mesh)
    out = run_sampler(sp, x0, plan, np.asarray(c), None, None, None,
                      None, cfg, TINY, dtype=jnp.float32)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_generate_tp_dp_matches_single(tmp_path, monkeypatch):
    """--tp/--dp through the session API produce the same image as the
    single-device path (VERDICT r1 item 6: multi-chip in the product path)."""
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from helpers import TINY_MODEL_TYPE, patch_tiny_model_types, \
        write_tiny_checkpoint
    from mlimgsynth_tpu.api import MLImgSynth

    ckpt = tmp_path / "sd1.safetensors"
    write_tiny_checkpoint(ckpt)
    patch_tiny_model_types(monkeypatch)

    def make(tp, dp, sp=1):
        s = MLImgSynth()
        s._dtype = jnp.float32
        s.option_set("model", str(ckpt))
        s.option_set("model-type", "sd1")
        s.option_set("image-dim", 64)
        s.option_set("steps", 2)
        s.option_set("seed", 11)
        s.option_set("batch-size", 2)
        s.option_set("tp", tp)
        s.option_set("dp", dp)
        s.option_set("sp", sp)
        s.option_set("prompt", "a shard test")
        return s

    base = make(1, 1).generate()

    s = make(2, 2)
    img = s.generate()
    assert s._mesh is not None and dict(s._mesh.shape) == {"dp": 2, "pp": 1, "sp": 1, "tp": 2}
    # different reduction orders over the mesh -> small float drift; the
    # output is uint8-quantized, so drift near a rounding boundary shows as
    # exactly one 1/255 level on isolated pixels — allow one level
    np.testing.assert_allclose(img, base, atol=1.5 / 255)

    # dp-only path (replicated weights, sharded batch)
    img_dp = make(1, 2).generate()
    np.testing.assert_allclose(img_dp, base, atol=1.5 / 255)

    # sp over the UNet: spatial self-attention rides the ring, the
    # 77-token cross-attention rides the q-sharded path
    img_sp = make(1, 2, sp=2).generate()
    np.testing.assert_allclose(img_sp, base, atol=1.5 / 255)


def test_tp_option_needs_devices(monkeypatch):
    from mlimgsynth_tpu.api import MLImgSynth, MlisError
    s = MLImgSynth()
    s.option_set("tp", 1024)
    with pytest.raises(MlisError):
        s._backend_init()


def test_generate_flux_tp_dp_matches_single(tmp_path, monkeypatch):
    """Flux (double/single-stream DiT) under --tp/--dp: the new TP rules
    (img_attn/txt_attn qkv+proj, img_mlp/txt_mlp, single-block
    linear1/linear2) must reproduce the single-device image."""
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from helpers import patch_tiny_model_types
    from mlimgsynth_tpu.api import MLImgSynth, ModelTypeDef
    from mlimgsynth_tpu.testing import (TINY_CLIP, TINY_FLUX_SCHNELL,
                                        TINY_VAE_FLUX, write_tiny_flux_files)

    files = write_tiny_flux_files(tmp_path)
    types = {"flux_schnell": ModelTypeDef(
        "flux_schnell", TINY_CLIP, None, TINY_FLUX_SCHNELL,
        TINY_VAE_FLUX, 64, 1)}

    def make(tp, dp):
        patch_tiny_model_types(monkeypatch, types)
        s = MLImgSynth()
        s._dtype = jnp.float32
        s.option_set("model", files["model"])
        s.option_set("clip", files["clip"])
        s.option_set("vae", files["vae"])
        s.option_set("image-dim", 64, 64)
        s.option_set("steps", 2)
        s.option_set("seed", 33)
        s.option_set("batch-size", 2)
        s.option_set("tp", tp)
        s.option_set("dp", dp)
        s.option_set("prompt", "a sharded rope test")
        return s

    base = make(1, 1).generate()
    s = make(2, 2)
    img = s.generate()
    assert s._mesh is not None and dict(s._mesh.shape) == {"dp": 2, "pp": 1, "sp": 1, "tp": 2}
    np.testing.assert_allclose(img, base, atol=1.5 / 255)

    # sp option plumbing on flux: the tiny joint sequence (93 tokens) does
    # NOT divide sp=2, so this exercises the ring's token padding
    s_sp = make(1, 1)
    s_sp.option_set("sp", 2)
    s_sp.option_set("dp", 2)
    img_sp = s_sp.generate()
    np.testing.assert_allclose(img_sp, base, atol=1.5 / 255)


def test_t5_block_sharded_matches_single():
    """T5 encoder forward with tp-sharded q/k/v/o + wi/wo weights matches
    the replicated result (the einsum head-reshape path under GSPMD)."""
    from mlimgsynth_tpu.models import t5 as t5_mod

    P5 = t5_mod.T5Params(d_model=32, d_kv=8, n_head=4, d_ff=36, n_layer=2,
                         n_vocab=64)
    toks = jnp.asarray(np.arange(16, dtype=np.int32).reshape(2, 8) % 64)
    spec = B.trace_spec(
        lambda ctx, t: t5_mod.t5_encode_apply(ctx, t, P5), toks)
    rng = np.random.default_rng(7)
    params = {k: jnp.asarray(
        rng.standard_normal(s.shape).astype(np.float32) * 0.05)
        for k, s in spec.items()}

    def f(params, t):
        return t5_mod.t5_encode_apply(B.Ctx(params, dtype=jnp.float32), t, P5)

    ref = np.asarray(jax.jit(f)(params, toks))
    mesh = pmesh.make_mesh(8, tp=4)
    sp = pmesh.shard_params(params, mesh)
    # the tp rules must actually fire on the T5 names
    from jax.sharding import PartitionSpec as P
    assert pmesh.param_spec(
        "t5.encoder.block.0.layer.0.SelfAttention.q.weight", 2) \
        == P(None, "tp")
    out = np.asarray(jax.jit(f)(sp, pmesh.shard_batch(toks, mesh)))
    np.testing.assert_allclose(out, ref, atol=2e-5)


# ---------------------------------------------------------------------------
# Sequence parallelism (sp axis): ring attention + q-sharded cross attention
# ---------------------------------------------------------------------------

def _rand_qkv(rng, b, h, sq, sk, d, dtype=np.float32):
    """[B, S, H, D] q/k/v (the layout attention() takes)."""
    q = jnp.asarray(rng.standard_normal((b, sq, h, d)).astype(dtype))
    k = jnp.asarray(rng.standard_normal((b, sk, h, d)).astype(dtype))
    v = jnp.asarray(rng.standard_normal((b, sk, h, d)).astype(dtype))
    return q, k, v


def test_ring_attention_matches_dense():
    from mlimgsynth_tpu.ops.attention import attention_xla
    from mlimgsynth_tpu.parallel import ring_attention as ring

    rng = np.random.default_rng(5)
    # pure sp=8 ring
    mesh = pmesh.make_mesh(8, tp=1, sp=8)
    q, k, v = _rand_qkv(rng, 2, 3, 64, 64, 16)
    ref = np.asarray(attention_xla(q, k, v))
    out = np.asarray(jax.jit(
        lambda q, k, v: ring.ring_attention(q, k, v, mesh))(q, k, v))
    np.testing.assert_allclose(out, ref, atol=2e-6)

    # mixed (dp=2, sp=2, tp=2) mesh
    mesh2 = pmesh.make_mesh(8, tp=2, sp=2)
    q, k, v = _rand_qkv(rng, 4, 4, 32, 32, 8)
    ref = np.asarray(attention_xla(q, k, v))
    out = np.asarray(jax.jit(
        lambda q, k, v: ring.ring_attention(q, k, v, mesh2))(q, k, v))
    np.testing.assert_allclose(out, ref, atol=2e-6)


@pytest.mark.parametrize("sp,n_tok", [(4, 34), (8, 50), (4, 170),
                                      (2, 33)])
def test_ring_attention_pads_nondividing_tokens(sp, n_tok):
    """Token counts that don't divide sp (SD3 1024px: 4096 + 154 = 4250 on
    sp=4) are zero-padded and the padded keys masked: self and cross
    attention still match the dense reference."""
    from mlimgsynth_tpu.ops.attention import attention_xla
    from mlimgsynth_tpu.parallel import ring_attention as ring

    rng = np.random.default_rng(sp * 100 + n_tok)
    mesh = pmesh.make_mesh(8, tp=1, sp=sp)          # dp = 8 / sp
    b = 8 // sp
    q, k, v = _rand_qkv(rng, b, 2, n_tok, n_tok, 8)
    out = np.asarray(jax.jit(
        lambda q, k, v: ring.ring_attention(q, k, v, mesh))(q, k, v))
    np.testing.assert_allclose(out, np.asarray(attention_xla(q, k, v)),
                               atol=2e-6)
    q, k, v = _rand_qkv(rng, b, 2, n_tok, 7, 8)
    out = np.asarray(jax.jit(
        lambda q, k, v: ring.sp_cross_attention(q, k, v, mesh))(q, k, v))
    np.testing.assert_allclose(out, np.asarray(attention_xla(q, k, v)),
                               atol=2e-6)


def test_ring_attention_bf16():
    """bf16 inputs: f32 statistics inside the ring keep the result within
    bf16 rounding of the f32-softmax reference."""
    from mlimgsynth_tpu.ops.attention import attention_xla
    from mlimgsynth_tpu.parallel import ring_attention as ring

    rng = np.random.default_rng(6)
    mesh = pmesh.make_mesh(8, tp=1, sp=4)  # dp=2 x sp=4
    q = jnp.asarray(rng.standard_normal((2, 32, 2, 8)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((2, 32, 2, 8)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((2, 32, 2, 8)), jnp.bfloat16)
    ref = np.asarray(attention_xla(q, k, v).astype(jnp.float32))
    out = np.asarray(ring.ring_attention(q, k, v, mesh).astype(jnp.float32))
    np.testing.assert_allclose(out, ref, atol=2e-2)


def test_sp_cross_attention_matches_dense():
    from mlimgsynth_tpu.ops.attention import attention_xla
    from mlimgsynth_tpu.parallel import ring_attention as ring

    rng = np.random.default_rng(7)
    mesh = pmesh.make_mesh(8, tp=2, sp=2)
    q, k, v = _rand_qkv(rng, 2, 4, 32, 7, 16)  # 7 kv rows: replicated
    ref = np.asarray(attention_xla(q, k, v))
    out = np.asarray(jax.jit(
        lambda q, k, v: ring.sp_cross_attention(q, k, v, mesh))(q, k, v))
    np.testing.assert_allclose(out, ref, atol=2e-6)


def test_attention_dispatch_sp(monkeypatch):
    """attention() routes through the ring when the session mesh has sp>1,
    and falls back to the XLA path on non-dividing shapes."""
    from mlimgsynth_tpu.ops import attention as attn_mod
    from mlimgsynth_tpu.parallel import ring_attention as ring

    rng = np.random.default_rng(8)
    mesh = pmesh.make_mesh(8, tp=1, sp=8)
    monkeypatch.setattr(attn_mod, "MESH", mesh)
    calls = {"ring": 0, "cross": 0}
    real_ring = ring.ring_attention
    real_cross = ring.sp_cross_attention
    monkeypatch.setattr(
        ring, "ring_attention",
        lambda *a, **kw: (calls.__setitem__("ring", calls["ring"] + 1),
                          real_ring(*a, **kw))[1])
    monkeypatch.setattr(
        ring, "sp_cross_attention",
        lambda *a, **kw: (calls.__setitem__("cross", calls["cross"] + 1),
                          real_cross(*a, **kw))[1])

    q, k, v = _rand_qkv(rng, 1, 2, 64, 64, 8)
    ref = np.asarray(attn_mod.attention_xla(q, k, v))
    out = np.asarray(attn_mod.attention(q, k, v))
    np.testing.assert_allclose(out, ref, atol=2e-6)
    assert calls["ring"] == 1

    # cross-attention shape (Sk != Sq, Sk tiny): q-sharded path
    q, k, v = _rand_qkv(rng, 1, 2, 64, 7, 8)
    ref = np.asarray(attn_mod.attention_xla(q, k, v))
    out = np.asarray(attn_mod.attention(q, k, v))
    np.testing.assert_allclose(out, ref, atol=2e-6)
    assert calls["cross"] == 1

    # non-dividing token count (S=50 on sp=8): the ring pads and masks
    q, k, v = _rand_qkv(rng, 1, 2, 50, 50, 8)
    ref = np.asarray(attn_mod.attention_xla(q, k, v))
    out = np.asarray(attn_mod.attention(q, k, v))
    np.testing.assert_allclose(out, ref, atol=2e-6)
    assert calls["ring"] == 2 and calls["cross"] == 1

    # heads that don't divide tp: visible GSPMD fallback, no ring
    mesh_tp = pmesh.make_mesh(8, tp=2, sp=4)
    monkeypatch.setattr(attn_mod, "MESH", mesh_tp)
    q, k, v = _rand_qkv(rng, 1, 3, 64, 64, 8)
    ref = np.asarray(attn_mod.attention_xla(q, k, v))
    out = np.asarray(attn_mod.attention(q, k, v))
    np.testing.assert_allclose(out, ref, atol=2e-6)
    assert calls["ring"] == 2


def test_generate_sd3_sp_matches_single(tmp_path, monkeypatch):
    """SD3 generate() on a (dp=2, sp=2, tp=2) mesh: the MMDiT joint
    attention (S = 154 ctx + 16 img = 170 tokens at 64px tiny geometry)
    runs sequence-parallel through the ring and reproduces the
    single-device image."""
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from helpers import patch_tiny_model_types
    from mlimgsynth_tpu.api import MLImgSynth
    from mlimgsynth_tpu.parallel import ring_attention as ring
    from mlimgsynth_tpu.testing import (TINY_MODEL_TYPE_SD3,
                                        write_checkpoint_sd3)

    ckpt = tmp_path / "sd3.safetensors"
    write_checkpoint_sd3(ckpt)
    types = {"sd3": TINY_MODEL_TYPE_SD3}

    def make(tp, dp, sp):
        patch_tiny_model_types(monkeypatch, types)
        s = MLImgSynth()
        s._dtype = jnp.float32
        s.option_set("model", str(ckpt))
        s.option_set("image-dim", 64)
        s.option_set("steps", 2)
        s.option_set("seed", 21)
        s.option_set("batch-size", 2)
        s.option_set("tp", tp)
        s.option_set("dp", dp)
        s.option_set("sp", sp)
        s.option_set("prompt", "a ring attention test")
        return s

    base = make(1, 1, 1).generate()

    calls = {"ring": 0}
    real_ring = ring.ring_attention
    monkeypatch.setattr(
        ring, "ring_attention",
        lambda *a, **kw: (calls.__setitem__("ring", calls["ring"] + 1),
                          real_ring(*a, **kw))[1])
    s = make(2, 2, 2)
    img = s.generate()
    assert dict(s._mesh.shape) == {"dp": 2, "pp": 1, "sp": 2, "tp": 2}
    assert calls["ring"] > 0, "joint attention did not take the ring path"
    np.testing.assert_allclose(img, base, atol=1.5 / 255)


# ---------------------------------------------------------------------------
# Pipeline parallelism (pp axis): GPipe-style microbatched block stack
# ---------------------------------------------------------------------------

def test_pipeline_apply_matches_sequential():
    from mlimgsynth_tpu.parallel import pipeline as pl

    rng = np.random.default_rng(0)
    D, pp = 8, 4
    mesh = pmesh.make_mesh(4, pp=4)
    ws = jnp.asarray(rng.standard_normal((D, 16, 16)).astype(np.float32) * .3)
    bs = jnp.asarray(rng.standard_normal((D, 16)).astype(np.float32) * .1)
    slab = {"w": ws.reshape(pp, D // pp, 16, 16),
            "b": bs.reshape(pp, D // pp, 16)}

    def block_fn(pj, acts):
        u, x, c = acts
        x = jnp.tanh(x @ pj["w"] + pj["b"] + 0.1 * u + c[:, :1][..., None])
        return (u + 1.0, x, c)

    n = 6
    u0 = jnp.zeros((n, 4, 16))
    c0 = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
    x0 = jnp.asarray(rng.standard_normal((n, 4, 16)).astype(np.float32))
    acts = (u0, x0, c0)
    for i in range(D):
        acts = block_fn({"w": ws[i], "b": bs[i]}, acts)
    ref = np.asarray(acts[1])

    for m in (0, 2, 3, 6):   # microbatch splits (0 -> one per sample)
        out = np.asarray(jax.jit(lambda s, u, x, c: pl.pipeline_apply(
            mesh, block_fn, s, (u, x, c), n_micro=m))(slab, u0, x0, c0))
        np.testing.assert_allclose(out, ref, atol=1e-6, err_msg=f"m={m}")


def _sd3_pp_session(monkeypatch, ckpt, depth=4):
    import dataclasses
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from helpers import patch_tiny_model_types
    from mlimgsynth_tpu.api import ModelTypeDef
    from mlimgsynth_tpu.testing import (TINY_CLIP, TINY_CLIP2, TINY_MMDIT,
                                        TINY_VAE_SD3, write_checkpoint_sd3)
    P = dataclasses.replace(TINY_MMDIT, depth=depth)
    if not ckpt.exists():
        write_checkpoint_sd3(ckpt, P=P)
    types = {"sd3": ModelTypeDef("sd3", TINY_CLIP, TINY_CLIP2, P,
                                 TINY_VAE_SD3, 64, 2)}
    patch_tiny_model_types(monkeypatch, types)


def test_generate_sd3_pp_matches_single(tmp_path, monkeypatch):
    """SD3 generate() with the block stack cut into pipeline stages
    (microbatched over the pp mesh axis) reproduces the single-device
    image bit-exactly (same reduction orders: the pipeline only reorders
    WHICH device runs a block, not the math inside it)."""
    from mlimgsynth_tpu.api import MLImgSynth

    ckpt = tmp_path / "sd3pp.safetensors"

    def make(pp):
        _sd3_pp_session(monkeypatch, ckpt, depth=4)
        s = MLImgSynth()
        s._dtype = jnp.float32
        s.option_set("model", str(ckpt))
        s.option_set("image-dim", 64)
        s.option_set("steps", 2)
        s.option_set("seed", 13)
        s.option_set("batch-size", 2)
        s.option_set("pp", pp)
        s.option_set("prompt", "a pipeline test")
        return s

    base = make(1).generate()
    s2 = make(2)
    img2 = s2.generate()
    assert dict(s2._mesh.shape) == {"dp": 1, "pp": 2, "sp": 1, "tp": 1}
    np.testing.assert_array_equal(img2, base)
    img4 = make(4).generate()    # one block per stage
    np.testing.assert_array_equal(img4, base)


def test_pp_rejects_unsupported(tmp_path, monkeypatch):
    from mlimgsynth_tpu.api import MLImgSynth, MlisError

    ckpt = tmp_path / "sd3pp3.safetensors"
    _sd3_pp_session(monkeypatch, ckpt, depth=4)
    s = MLImgSynth()
    s._dtype = jnp.float32
    s.option_set("model", str(ckpt))
    s.option_set("image-dim", 64)
    s.option_set("steps", 1)
    s.option_set("batch-size", 2)
    s.option_set("pp", 3)        # does not divide depth 4
    s.option_set("prompt", "x")
    with pytest.raises(MlisError):
        s.generate()

    # pp does not compose with the other axes yet: refuse loudly instead
    # of silently replicating the block stack over tp/dp/sp
    s2 = MLImgSynth()
    s2.option_set("model", str(ckpt))
    s2.option_set("pp", 2)
    s2.option_set("tp", 2)
    s2.option_set("prompt", "x")
    with pytest.raises(MlisError):
        s2.generate()


def test_generate_sd3_pp_q8_matches_unpipelined(tmp_path, monkeypatch):
    """--pp with --weight-type q8_0: the int8 weight/scale pairs stack into
    the same [pp, L, ...] slabs (zero-filled pairs for the final block's
    missing context-side tensors dequantize to zero).  Unlike the f32 case
    (bit-exact), the dequant multiply fuses differently around a slab
    dynamic-slice than around a standalone weight, so isolated pixels may
    land one u8 level apart — the same drift class (and bound) as the
    tp/dp reduction-order tests."""
    from mlimgsynth_tpu.api import MLImgSynth

    ckpt = tmp_path / "sd3ppq8.safetensors"

    def make(pp):
        _sd3_pp_session(monkeypatch, ckpt, depth=4)
        s = MLImgSynth()
        s._dtype = jnp.float32
        s.option_set("model", str(ckpt))
        s.option_set("weight-type", "q8_0")
        s.option_set("image-dim", 64)
        s.option_set("steps", 2)
        s.option_set("seed", 17)
        s.option_set("batch-size", 2)
        s.option_set("pp", pp)
        s.option_set("prompt", "a quantized pipeline test")
        return s

    base = make(1).generate()
    img = make(2).generate()
    np.testing.assert_allclose(img, base, atol=1.5 / 255)


def test_pp_plan_survives_other_sessions(tmp_path, monkeypatch):
    """The trace-time pipeline plan is a module global; another session's
    backend init must not poison a pp session's NEXT trace (setup()
    re-publishes the mesh/plan globals every generate)."""
    from mlimgsynth_tpu.api import MLImgSynth

    ckpt = tmp_path / "sd3pp_stale.safetensors"
    _sd3_pp_session(monkeypatch, ckpt, depth=4)

    a = MLImgSynth()
    a._dtype = jnp.float32
    a.option_set("model", str(ckpt))
    a.option_set("image-dim", 64)
    a.option_set("steps", 2)
    a.option_set("seed", 19)
    a.option_set("batch-size", 2)
    a.option_set("pp", 2)
    a.option_set("prompt", "stale plan test")
    img1 = a.generate()

    # session B (pp=1) clobbers parallel.pipeline.PLAN and attention.MESH
    b = MLImgSynth()
    b._dtype = jnp.float32
    b.option_set("model", str(ckpt))
    b.option_set("image-dim", 64)
    b.option_set("steps", 1)
    b.option_set("prompt", "other session")
    b.generate()
    from mlimgsynth_tpu.parallel import pipeline as pl
    assert pl.PLAN is None

    # A re-traces (new image-dim) — must see ITS plan again, not B's None
    a.option_set("image-dim", 64, 96)
    img2 = a.generate()
    assert img2.shape[-1] == 64 and img2.shape[-2] == 96
    assert np.isfinite(img2).all()
    assert pl.PLAN is not None and pl.PLAN.pp == 2


def _flux_pp_session(monkeypatch, tmpdir, dd=2, ds=3):
    """Tiny flux with non-trivial stacks (ds=3 exercises the zero-pad at
    pp=2: singles 3 -> 4 with one identity block)."""
    import dataclasses
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from helpers import patch_tiny_model_types
    from mlimgsynth_tpu.api import ModelTypeDef
    from mlimgsynth_tpu.testing import (TINY_CLIP, TINY_FLUX_SCHNELL,
                                        TINY_VAE_FLUX, write_tiny_flux_files)
    P = dataclasses.replace(TINY_FLUX_SCHNELL, depth_double=dd,
                            depth_single=ds)
    files = write_tiny_flux_files(tmpdir, P=P)
    types = {"flux_schnell": ModelTypeDef("flux_schnell", TINY_CLIP, None,
                                          P, TINY_VAE_FLUX, 64, 1)}
    patch_tiny_model_types(monkeypatch, types)
    return files


def test_generate_flux_pp_matches_single(tmp_path, monkeypatch):
    """Flux generate() with both block stacks cut into pipeline stages
    (two chained GPipe passes, single stack zero-padded 3 -> 4)
    reproduces the single-device image bit-exactly — zero-filled flux
    blocks are exact identities through the modulation gates."""
    from mlimgsynth_tpu.api import MLImgSynth

    files = _flux_pp_session(monkeypatch, tmp_path)

    def make(pp):
        s = MLImgSynth()
        s._dtype = jnp.float32
        s.option_set("model", files["model"])
        s.option_set("clip", files["clip"])
        s.option_set("vae", files["vae"])
        s.option_set("image-dim", 64)
        s.option_set("steps", 2)
        s.option_set("seed", 23)
        s.option_set("batch-size", 2)
        s.option_set("pp", pp)
        s.option_set("prompt", "a flux pipeline test")
        return s

    base = make(1).generate()
    s2 = make(2)
    img2 = s2.generate()
    assert dict(s2._mesh.shape) == {"dp": 1, "pp": 2, "sp": 1, "tp": 1}
    np.testing.assert_array_equal(img2, base)
    # pp=4: doubles 2 -> 4 (two identity blocks), singles 3 -> 4
    img4 = make(4).generate()
    np.testing.assert_array_equal(img4, base)


def test_generate_flux_pp_q8_matches_unpipelined(tmp_path, monkeypatch):
    """Flux --pp with --weight-type q8_0: the int8 pairs stack into the
    zero-padded [pp, L, ...] slabs (zero pairs dequantize to zero ->
    identity pad blocks).  Same one-u8-level drift bound as the sd3 q8
    pipeline test (dequant fuses differently around slab dynamic-slices)."""
    from mlimgsynth_tpu.api import MLImgSynth

    files = _flux_pp_session(monkeypatch, tmp_path)

    def make(pp):
        s = MLImgSynth()
        s._dtype = jnp.float32
        s.option_set("model", files["model"])
        s.option_set("clip", files["clip"])
        s.option_set("vae", files["vae"])
        s.option_set("weight-type", "q8_0")
        s.option_set("image-dim", 64)
        s.option_set("steps", 2)
        s.option_set("seed", 29)
        s.option_set("batch-size", 2)
        s.option_set("pp", pp)
        s.option_set("prompt", "a quantized flux pipeline test")
        return s

    base = make(1).generate()
    img = make(2).generate()
    np.testing.assert_allclose(img, base, atol=1.5 / 255)
