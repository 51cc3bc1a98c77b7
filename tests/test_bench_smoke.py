"""CPU smoke of the bench harness wiring for the newest config.

The real benches run on the GPU at full model size; this catches shape/spec
bugs in the bench-side plumbing (fused encode spec, latent channels, flow
plan) before chip time is spent on them, by monkeypatching the model tables
to tiny geometries."""
import dataclasses

import numpy as np
import pytest


def test_bench_sd3_smoke(monkeypatch):
    import bench
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import mmdit as MM
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.testing import TINY_CLIP, TINY_CLIP2, TINY_VAE_SD3

    tiny_mm = MM.MmditParams(
        depth=2, d_model=32, n_head=2, patch=2, n_ch_in=4, n_ch_out=4,
        d_ctx_in=80, d_pooled=64, pos_embed_max=8, d_t_embed=16,
        n_ctx=80, ch_adm_in=64)
    monkeypatch.setattr(MM, "MMDIT_SD3_MEDIUM", tiny_mm)
    monkeypatch.setattr(V, "VAE_SD3", TINY_VAE_SD3)
    monkeypatch.setattr(C, "CLIP_VIT_L_14", TINY_CLIP)
    monkeypatch.setattr(C, "CLIP_VIT_BIGG_14", TINY_CLIP2)
    monkeypatch.setattr(bench, "STEPS", 2)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    r = bench.bench_config("sd3")
    assert r["unit"] == "s/image"
    assert r["value"] > 0
    assert "SD3-medium" in r["metric"]


def test_bench_sd35_large_q8_smoke(monkeypatch):
    """sd35-large is always int8 weight-only; d_model=128 here so the
    KBLOCK=128 eligibility actually fires and the device-side q8
    synthesis + q8 linears run (dq mode works on CPU)."""
    import bench
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import mmdit as MM
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.testing import TINY_CLIP, TINY_CLIP2, TINY_VAE_SD3

    tiny_mm = MM.MmditParams(
        depth=2, d_model=128, n_head=2, patch=2, n_ch_in=4, n_ch_out=4,
        d_ctx_in=80, d_pooled=64, pos_embed_max=8, d_t_embed=16,
        n_ctx=80, ch_adm_in=64, qk_norm=True)
    monkeypatch.setattr(MM, "MMDIT_SD35_LARGE", tiny_mm)
    monkeypatch.setattr(V, "VAE_SD3", TINY_VAE_SD3)
    monkeypatch.setattr(C, "CLIP_VIT_L_14", TINY_CLIP)
    monkeypatch.setattr(C, "CLIP_VIT_BIGG_14", TINY_CLIP2)
    monkeypatch.setattr(bench, "STEPS", 2)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    r = bench.bench_config("sd35-large")
    assert r["unit"] == "s/image"
    assert r["value"] > 0
    assert "int8" in r["metric"]


def test_bench_sd35_large_dc_smoke(monkeypatch):
    """sd35-large-dc: DeepCache residual caching COMBINED with the q8
    quantized-pair path (the deep-tail split must carry quantized
    params through both the full and shallow branches)."""
    import bench
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import mmdit as MM
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.testing import TINY_CLIP, TINY_CLIP2, TINY_VAE_SD3

    tiny_mm = MM.MmditParams(
        depth=2, d_model=128, n_head=2, patch=2, n_ch_in=4, n_ch_out=4,
        d_ctx_in=80, d_pooled=64, pos_embed_max=8, d_t_embed=16,
        n_ctx=80, ch_adm_in=64, qk_norm=True)
    monkeypatch.setattr(MM, "MMDIT_SD35_LARGE", tiny_mm)
    monkeypatch.setattr(V, "VAE_SD3", TINY_VAE_SD3)
    monkeypatch.setattr(C, "CLIP_VIT_L_14", TINY_CLIP)
    monkeypatch.setattr(C, "CLIP_VIT_BIGG_14", TINY_CLIP2)
    monkeypatch.setattr(bench, "STEPS", 3)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    r = bench.bench_config("sd35-large-dc")
    assert r["value"] > 0
    assert "deepcache" in r["metric"] and "int8" in r["metric"]


def test_bench_sd35_medium_smoke(monkeypatch):
    """sd35-medium is MMDiT-X: dual attention in the listed x-blocks plus
    qk-norm must run through the bench's fused flow path."""
    import bench
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import mmdit as MM
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.testing import TINY_CLIP, TINY_CLIP2, TINY_VAE_SD3

    tiny_mm = MM.MmditParams(
        depth=2, d_model=32, n_head=2, patch=2, n_ch_in=4, n_ch_out=4,
        d_ctx_in=80, d_pooled=64, pos_embed_max=8, d_t_embed=16,
        n_ctx=80, ch_adm_in=64, qk_norm=True, x_self_attn_layers=(0,))
    monkeypatch.setattr(MM, "MMDIT_SD35_MEDIUM", tiny_mm)
    monkeypatch.setattr(V, "VAE_SD3", TINY_VAE_SD3)
    monkeypatch.setattr(C, "CLIP_VIT_L_14", TINY_CLIP)
    monkeypatch.setattr(C, "CLIP_VIT_BIGG_14", TINY_CLIP2)
    monkeypatch.setattr(bench, "STEPS", 2)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    r = bench.bench_config("sd35-medium")
    assert r["unit"] == "s/image"
    assert r["value"] > 0
    assert "MMDiT-X" in r["metric"]


def test_bench_flux_smoke(monkeypatch):
    import bench
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import flux as FX
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.testing import (TINY_CLIP, TINY_FLUX_DEV,
                                        TINY_VAE_FLUX)

    monkeypatch.setattr(FX, "FLUX_DEV", TINY_FLUX_DEV)
    monkeypatch.setattr(V, "VAE_FLUX", TINY_VAE_FLUX)
    monkeypatch.setattr(C, "CLIP_VIT_L_14", TINY_CLIP)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    r = bench.bench_flux("flux-dev")
    assert r["unit"] == "s/image"
    assert r["value"] > 0
    assert "Flux.1-dev" in r["metric"]


def test_bench_sd15_q4_smoke(monkeypatch):
    """-q4 suffix: device-side packed-int4 synthesis + the q4 linears run
    end-to-end (XLA unpack path on CPU); d_model sized so KBLOCK=128
    eligibility fires."""
    import bench
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import unet as U
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.testing import TINY_CLIP, TINY_VAE

    tiny_u = dataclasses.replace(
        U.UNET_SD1, n_ch=32, ch_mult=(1, 2), transf_depth=(1, 1),
        attn_res=(1, 2), n_head=4, n_te=128, n_ctx=TINY_CLIP.d_embed)
    monkeypatch.setattr(U, "UNET_SD1", tiny_u)
    monkeypatch.setattr(V, "VAE_SD1", TINY_VAE)
    monkeypatch.setattr(C, "CLIP_VIT_L_14", TINY_CLIP)
    monkeypatch.setattr(bench, "STEPS", 2)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    r = bench.bench_config("sd15-q4")
    assert r["value"] > 0
    assert "int4-weights" in r["metric"]


def test_bench_sd15_pag_smoke(monkeypatch):
    """-pag suffix: perturbed-attention guidance (+1 NFE/step) runs
    through the fused bench loop."""
    import bench
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import unet as U
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.testing import TINY_CLIP, TINY_VAE

    tiny_u = dataclasses.replace(
        U.UNET_SD1, n_ch=32, ch_mult=(1, 2), transf_depth=(1, 1),
        attn_res=(1, 2), n_head=4, n_te=128, n_ctx=TINY_CLIP.d_embed)
    monkeypatch.setattr(U, "UNET_SD1", tiny_u)
    monkeypatch.setattr(V, "VAE_SD1", TINY_VAE)
    monkeypatch.setattr(C, "CLIP_VIT_L_14", TINY_CLIP)
    monkeypatch.setattr(bench, "STEPS", 2)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    r = bench.bench_config("sd15-pag")
    assert r["value"] > 0
    assert "pag3" in r["metric"]


def test_bench_sd15_unipc_smoke(monkeypatch):
    """-unipc suffix: the UniPC bh2 solver runs through the fused bench
    loop."""
    import bench
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import unet as U
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.testing import TINY_CLIP, TINY_VAE

    tiny_u = dataclasses.replace(
        U.UNET_SD1, n_ch=32, ch_mult=(1, 2), transf_depth=(1, 1),
        attn_res=(1, 2), n_head=4, n_te=128, n_ctx=TINY_CLIP.d_embed)
    monkeypatch.setattr(U, "UNET_SD1", tiny_u)
    monkeypatch.setattr(V, "VAE_SD1", TINY_VAE)
    monkeypatch.setattr(C, "CLIP_VIT_L_14", TINY_CLIP)
    monkeypatch.setattr(bench, "STEPS", 3)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    r = bench.bench_config("sd15-unipc")
    assert r["value"] > 0
    assert "unipc" in r["metric"]


def test_bench_sd15_lcm_smoke(monkeypatch):
    """-lcm suffix: 4-step cfg-1 distilled shape on the lcm solver's
    implied timestep grid."""
    import bench
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import unet as U
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.testing import TINY_CLIP, TINY_VAE

    tiny_u = dataclasses.replace(
        U.UNET_SD1, n_ch=32, ch_mult=(1, 2), transf_depth=(1, 1),
        attn_res=(1, 2), n_head=4, n_te=128, n_ctx=TINY_CLIP.d_embed)
    monkeypatch.setattr(U, "UNET_SD1", tiny_u)
    monkeypatch.setattr(V, "VAE_SD1", TINY_VAE)
    monkeypatch.setattr(C, "CLIP_VIT_L_14", TINY_CLIP)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    r = bench.bench_config("sd15-lcm")
    assert r["value"] > 0
    assert "lcm4" in r["metric"]


def test_bench_sd15_hires_smoke(monkeypatch):
    """-hires suffix: base loop -> latent 2x -> refine loop + decode."""
    import dataclasses

    import bench
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import unet as U
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.testing import TINY_CLIP, TINY_VAE

    tiny_u = dataclasses.replace(
        U.UNET_SD1, n_ch=32, ch_mult=(1, 2), transf_depth=(1, 1),
        attn_res=(1, 2), n_head=4, n_te=128, n_ctx=TINY_CLIP.d_embed)
    monkeypatch.setattr(U, "UNET_SD1", tiny_u)
    monkeypatch.setattr(V, "VAE_SD1", TINY_VAE)
    monkeypatch.setattr(C, "CLIP_VIT_L_14", TINY_CLIP)
    monkeypatch.setattr(bench, "STEPS", 2)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    r = bench.bench_config("sd15-hires")
    assert r["value"] > 0
    assert "highres-fix 64->128px" in r["metric"]


def test_bench_sd15_dc_smoke(monkeypatch):
    """-dc suffix: deepcache-3 loop compiles and runs e2e."""
    import bench
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import unet as U
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.testing import TINY_CLIP, TINY_VAE

    tiny_u = dataclasses.replace(
        U.UNET_SD1, n_ch=32, ch_mult=(1, 2), transf_depth=(1, 1),
        attn_res=(1, 2), n_head=4, n_te=128, n_ctx=TINY_CLIP.d_embed)
    monkeypatch.setattr(U, "UNET_SD1", tiny_u)
    monkeypatch.setattr(V, "VAE_SD1", TINY_VAE)
    monkeypatch.setattr(C, "CLIP_VIT_L_14", TINY_CLIP)
    monkeypatch.setattr(bench, "STEPS", 4)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    r = bench.bench_config("sd15-dc")
    assert r["value"] > 0
    assert "deepcache3" in r["metric"]


def test_bench_sd3_slg_smoke(monkeypatch):
    import bench
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import mmdit as MM
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.testing import TINY_CLIP, TINY_CLIP2, TINY_VAE_SD3

    tiny_mm = MM.MmditParams(
        depth=2, d_model=32, n_head=2, patch=2, n_ch_in=4, n_ch_out=4,
        d_ctx_in=80, d_pooled=64, pos_embed_max=8, d_t_embed=16,
        n_ctx=80, ch_adm_in=64)
    monkeypatch.setattr(MM, "MMDIT_SD3_MEDIUM", tiny_mm)
    monkeypatch.setattr(V, "VAE_SD3", TINY_VAE_SD3)
    monkeypatch.setattr(C, "CLIP_VIT_L_14", TINY_CLIP)
    monkeypatch.setattr(C, "CLIP_VIT_BIGG_14", TINY_CLIP2)
    monkeypatch.setattr(bench, "STEPS", 2)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    # tiny depth=2: bench clamps the official 7,8,9 layer set to the
    # model depth (falls back to the middle block)
    r = bench.bench_config("sd3-slg")
    assert r["value"] > 0
    assert "slg2.5" in r["metric"]


def test_bench_sd3_dc_smoke(monkeypatch):
    """-dc on a flow config: the MMDiT deep-tail cache loop compiles and
    runs e2e through the fused-encode bench path."""
    import bench
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import mmdit as MM
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.testing import TINY_CLIP, TINY_CLIP2, TINY_VAE_SD3

    tiny_mm = MM.MmditParams(
        depth=2, d_model=32, n_head=2, patch=2, n_ch_in=4, n_ch_out=4,
        d_ctx_in=80, d_pooled=64, pos_embed_max=8, d_t_embed=16,
        n_ctx=80, ch_adm_in=64)
    monkeypatch.setattr(MM, "MMDIT_SD3_MEDIUM", tiny_mm)
    monkeypatch.setattr(V, "VAE_SD3", TINY_VAE_SD3)
    monkeypatch.setattr(C, "CLIP_VIT_L_14", TINY_CLIP)
    monkeypatch.setattr(C, "CLIP_VIT_BIGG_14", TINY_CLIP2)
    monkeypatch.setattr(bench, "STEPS", 4)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    r = bench.bench_config("sd3-dc")
    assert r["value"] > 0
    assert "deepcache3" in r["metric"]


def test_bench_flux_dc_smoke(monkeypatch):
    """flux -dc suffix: the deep-tail cache loop compiles and runs e2e
    through the fused flux bench path (embedded guidance + deepcache)."""
    import bench
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import flux as FX
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.testing import (TINY_CLIP, TINY_FLUX_DEV,
                                        TINY_VAE_FLUX)

    monkeypatch.setattr(FX, "FLUX_DEV", TINY_FLUX_DEV)
    monkeypatch.setattr(V, "VAE_FLUX", TINY_VAE_FLUX)
    monkeypatch.setattr(C, "CLIP_VIT_L_14", TINY_CLIP)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    r = bench.bench_flux("flux-dev-dc")
    assert r["value"] > 0
    assert "deepcache3" in r["metric"]


def test_bench_sdxl_lowmem_smoke(monkeypatch):
    """sdxl-lowmem: int4 UNet + int8 CLIP towers + latent-only loop +
    the tiled-VAE decode as a second program, with the two-phase memory
    accounting (peak_gib) in the result."""
    import bench
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import unet as U
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.testing import (TINY_CLIP, TINY_CLIP2,
                                        TINY_UNET_XL, TINY_VAE)

    monkeypatch.setattr(U, "UNET_SDXL", TINY_UNET_XL)
    monkeypatch.setattr(V, "VAE_SDXL", TINY_VAE)
    monkeypatch.setattr(C, "CLIP_VIT_L_14", TINY_CLIP)
    monkeypatch.setattr(C, "CLIP_VIT_BIGG_14", TINY_CLIP2)
    monkeypatch.setattr(bench, "STEPS", 2)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    r = bench.bench_config("sdxl-lowmem")
    assert r["value"] > 0
    assert "lowmem" in r["metric"]
    # the two-program memory accounting ran (loop + decode analyses)
    assert r.get("peak_gib", 0) > 0


def test_bench_esrgan_smoke(monkeypatch):
    """esrgan-x4 config: RRDBNet upscale compiles and runs one-dispatch
    at tiny geometry."""
    import bench
    from mlimgsynth_tpu.models import esrgan as E

    tiny = E.EsrganParams(n_feat=16, n_block=2, growth=8)
    monkeypatch.setattr(E, "ESRGAN_X4", tiny)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    r = bench.bench_esrgan("esrgan-x4")
    assert r["value"] > 0
    assert "Real-ESRGAN x4" in r["metric"] and "64->256px" in r["metric"]


def test_bench_sd3_t5_smoke(monkeypatch):
    """-t5 suffix: real (tiny) T5 rows computed on device feed the fused
    sd3 loop in place of the zero rows."""
    import bench
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import mmdit as MM
    from mlimgsynth_tpu.models import t5 as T5M
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.testing import TINY_CLIP, TINY_CLIP2, TINY_VAE_SD3

    tiny_mm = MM.MmditParams(
        depth=2, d_model=32, n_head=2, patch=2, n_ch_in=4, n_ch_out=4,
        d_ctx_in=80, d_pooled=64, pos_embed_max=8, d_t_embed=16,
        n_ctx=80, ch_adm_in=64)
    tiny_t5 = T5M.T5Params(d_model=80, d_kv=8, n_head=4, d_ff=64,
                           n_layer=2)
    monkeypatch.setattr(MM, "MMDIT_SD3_MEDIUM", tiny_mm)
    monkeypatch.setattr(T5M, "T5_XXL", tiny_t5)
    monkeypatch.setattr(V, "VAE_SD3", TINY_VAE_SD3)
    monkeypatch.setattr(C, "CLIP_VIT_L_14", TINY_CLIP)
    monkeypatch.setattr(C, "CLIP_VIT_BIGG_14", TINY_CLIP2)
    monkeypatch.setattr(bench, "STEPS", 2)
    monkeypatch.setenv("MLIS_BENCH_SIZE", "64")
    r = bench.bench_config("sd3-t5")
    assert r["value"] > 0
    assert "+T5-XXL" in r["metric"]
