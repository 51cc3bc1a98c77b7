"""Composed end-to-end oracle: session.generate() vs an all-torch pipeline.

VERDICT r3 missing #1: BASELINE's fidelity criterion (PSNR > 40 dB vs the
reference at fixed seed) cannot run here (the reference CPU build needs
ggml — docs/PARITY.md), so this is the strongest achievable substitute:
the COMPLETE ``mlis_generate`` call stack
(/root/reference/src/mlimgsynth.c:1634-1773) — tokenize -> CLIP text
encode (cond + uncond) -> CFG denoise loop (sigma schedule, solver,
Philox noise) -> VAE decode -> u8 image — replicated in an independent
torch implementation (tests/torch_ref.py + tests/torch_sampler.py,
transcribed from the reference C sources, pure torch kernels) and
compared against ``generate()`` at tiny geometry:

  * per-step latents match (atol 1e-4) AND their 8-char stat hashes
    (utils/tensorstat, the reference's debug-comparable hash) agree, up to
    one bucket in one character where noted;
  * the final u8 image matches at PSNR > 40 dB.

Shared pieces are deliberately limited to DISCRETE logic that is
independently golden-tested: the BPE tokenizer + window wrapping
(test_tokenizer golden vectors incl. the reference's own,
/root/reference/src/test_text_tokenize_clip.c:35-71) and the Philox
stream (test_rng vs reference vectors).  Every numeric stage runs twice
in independent implementations.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helpers import patch_tiny_model_types, write_tiny_checkpoint
from mlimgsynth_tpu import tokenizer as tok_mod
from mlimgsynth_tpu.api import MLImgSynth
from mlimgsynth_tpu.nameconv import normalize_name
from mlimgsynth_tpu.rng import RngPhilox
from mlimgsynth_tpu.testing import TINY_CLIP, TINY_UNET, TINY_VAE
from mlimgsynth_tpu.utils.image import tensor_to_image_arr
from mlimgsynth_tpu.utils.tensorstat import tensor_stat

import torch_ref as TR
import torch_sampler as TS

PROMPT = "a cat riding a bicycle"
NPROMPT = "blurry, low quality"
SEED = 42
STEPS = 5
CFG = 7.0



def _hash_within_one_bucket(ha: str, hb: str) -> bool:
    """Stat hashes agree, or differ in one character by one base64 bucket.

    Each character bins one segment sum between the tensor's min and max
    segment sums.  A latent that matches to 1e-4 (asserted just before)
    can still put a segment sum right on a bin edge, where the float32
    summation order of XLA and torch decides the bin: on the CPU the sd1
    dpm++2m-karras leg gave 'QcdT/A2R' vs 'QcdT+A2R' at step 4 and the sdxl
    leg 'cndS/A5U' vs 'cndS+A5U' at step 2.  Any larger difference still
    fails."""
    from mlimgsynth_tpu.utils.tensorstat import _B64
    if len(ha) != len(hb):
        return False
    diff = [(x, y) for x, y in zip(ha, hb) if x != y]
    return len(diff) == 0 or (
        len(diff) == 1
        and abs(_B64.index(diff[0][0]) - _B64.index(diff[0][1])) == 1)

def _psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _wrapped_tokens(text: str) -> np.ndarray:
    toks = tok_mod.tokenize(text)
    wins, _, _ = tok_mod.split_windows(TINY_CLIP, toks)
    return np.asarray(wins[:1], np.int64)          # [1, 77]


@pytest.mark.parametrize("method,sched", [
    ("euler", "uniform"),
    ("dpmpp2m", "karras"),
])
def test_e2e_generate_matches_torch_stack_sd1(tmp_path, monkeypatch,
                                              method, sched):
    ckpt = tmp_path / "tiny.safetensors"
    arrays = write_tiny_checkpoint(ckpt)     # CompVis names, ckpt layout
    patch_tiny_model_types(monkeypatch)

    # ---- production stack: the real session, full generate ----
    s = MLImgSynth()
    s._dtype = jnp.float32
    s.option_set("model", str(ckpt))
    s.option_set("model-type", "sd1")
    s.option_set("image-dim", 64)
    s.option_set("steps", STEPS)
    s.option_set("seed", SEED)
    s.option_set("cfg-scale", CFG)
    s.option_set("method", method)
    s.option_set("scheduler", sched)
    s.option_set("no-prompt-parse", 1)   # both stacks see raw token streams
    s.option_set("prompt", PROMPT)
    s.option_set("nprompt", NPROMPT)
    traj_jax = []
    s.step_observer = lambda i, lat: traj_jax.append(
        np.asarray(lat, np.float32).copy())
    s.generate()
    img_jax = tensor_to_image_arr(np.asarray(s.tensors["image"], np.float32))

    # ---- oracle stack: tokenize -> torch CLIP -> torch sampler -> torch
    # VAE -> u8, entirely outside JAX ----
    params = {normalize_name(cv): arr for cv, arr in arrays.items()}
    assert all(v is not None for v in params)
    cond, _ = TR.torch_clip_text(params, _wrapped_tokens(PROMPT), TINY_CLIP)
    uncond, _ = TR.torch_clip_text(params, _wrapped_tokens(NPROMPT),
                                   TINY_CLIP)
    x0 = np.zeros((1, 4, 8, 8), np.float32)
    traj_t, _sig = TS.torch_sample(
        params, TINY_UNET, x0, cond.float(), uncond.float(),
        rng=RngPhilox(SEED), n_step=STEPS, method=method, sched=sched,
        cfg_scale=CFG)
    with torch.no_grad():
        dec = TR.torch_vae_decode(
            params, torch.from_numpy(traj_t[-1]), TINY_VAE)
    img01 = np.clip((dec.numpy() + 1.0) * 0.5, 0.0, 1.0)
    img_t = tensor_to_image_arr(img01)

    # ---- per-step latents + stat hashes ----
    assert len(traj_jax) == len(traj_t) == STEPS
    for i, (a, b) in enumerate(zip(traj_jax, traj_t)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
        assert _hash_within_one_bucket(tensor_stat(a).hash,
                                       tensor_stat(b).hash), \
            f"step {i} stat-hash mismatch"

    # ---- final image fidelity (the BASELINE criterion, oracle-side) ----
    psnr = _psnr_u8(img_jax, img_t)
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"


# ---------------------------------------------------------------------------
# SDXL: dual encoder + projected pooled feature + size labels
# ---------------------------------------------------------------------------

import math  # noqa: E402

from torch.nn.functional import pad as F_pad  # noqa: E402

from mlimgsynth_tpu.nameconv import QKV, TProj  # noqa: E402
from mlimgsynth_tpu.testing import (  # noqa: E402
    TINY_CLIP2, TINY_UNET_XL, write_checkpoint_sdxl)


def _internal_params(arrays):
    """Raw checkpoint arrays -> {internal_name: ckpt-layout array},
    mirroring weights.register_name/read_entry semantics (fused-qkv
    thirds, HF text_projection transpose) without touching the loader."""
    out = {}
    for raw, arr in arrays.items():
        r = normalize_name(raw)
        if r is None:
            continue
        if isinstance(r, QKV):
            base = r.name
            stem, suffix = ((base[:-len("in_proj_weight")], "weight")
                            if base.endswith("in_proj_weight")
                            else (base[:-len("in_proj_bias")], "bias"))
            d = arr.shape[0] // 3
            for i, which in enumerate(("q_proj", "k_proj", "v_proj")):
                out.setdefault(f"{stem}{which}.{suffix}",
                               arr[i * d:(i + 1) * d])
        elif isinstance(r, TProj):
            out.setdefault(r.name, np.ascontiguousarray(arr.T))
        else:
            out.setdefault(r, arr)
    return out


def _size_embed(vals) -> np.ndarray:
    """CompVis sinusoidal size-label embedding (cos half then sin half),
    torch-side mirror of blocks.timestep_embedding at dim=256."""
    half = 128
    freqs = np.exp(-math.log(10000.0) * np.arange(half, dtype=np.float64)
                   / half)
    args = np.asarray(vals, np.float32).astype(np.float64)[:, None] \
        * freqs[None, :]
    return np.concatenate([np.cos(args), np.sin(args)],
                          axis=-1).astype(np.float32).reshape(-1)


def _wrapped2(text: str, P):
    toks = tok_mod.tokenize(text)
    wins, _, fidx = tok_mod.split_windows(P, toks)
    return np.asarray(wins[:1], np.int64), fidx


def test_e2e_generate_matches_torch_stack_sdxl(tmp_path, monkeypatch):
    ckpt = tmp_path / "tiny_xl.safetensors"
    arrays = write_checkpoint_sdxl(ckpt)
    from mlimgsynth_tpu.testing import TINY_MODEL_TYPE_XL
    patch_tiny_model_types(monkeypatch, {"sdxl": TINY_MODEL_TYPE_XL})

    s = MLImgSynth()
    s._dtype = jnp.float32
    s.option_set("model", str(ckpt))
    s.option_set("model-type", "sdxl")
    s.option_set("image-dim", 64)
    s.option_set("steps", STEPS)
    s.option_set("seed", SEED)
    s.option_set("cfg-scale", CFG)
    s.option_set("method", "euler")
    s.option_set("scheduler", "uniform")
    s.option_set("no-prompt-parse", 1)
    s.option_set("prompt", PROMPT)
    s.option_set("nprompt", NPROMPT)     # non-empty: real uncond encode
    traj_jax = []
    s.step_observer = lambda i, lat: traj_jax.append(
        np.asarray(lat, np.float32).copy())
    s.generate()
    img_jax = tensor_to_image_arr(np.asarray(s.tensors["image"], np.float32))

    params = _internal_params(arrays)
    skip = 2                              # sdxl default clip skip

    def encode(text):
        t1, _ = _wrapped2(text, TINY_CLIP)
        t2, fidx = _wrapped2(text, TINY_CLIP2)
        c1, _ = TR.torch_clip_text(params, t1, TINY_CLIP, clip_skip=skip,
                                   norm=False)
        c2, feat = TR.torch_clip_text(params, t2, TINY_CLIP2, pre="clip2",
                                      clip_skip=skip, norm=False,
                                      feat_tok_idx=[fidx])
        return (torch.cat([c1, c2], dim=-1).float(), feat.float())

    cond, feat = encode(PROMPT)
    uncond, nfeat = encode(NPROMPT)
    se = _size_embed([64, 64, 0, 0, 64, 64])
    label = torch.cat([feat, torch.from_numpy(se)[None]], dim=-1)
    nlabel = torch.cat([nfeat, torch.from_numpy(se)[None]], dim=-1)

    x0 = np.zeros((1, 4, 8, 8), np.float32)
    traj_t, _sig = TS.torch_sample(
        params, TINY_UNET_XL, x0, cond, uncond, label, nlabel,
        rng=RngPhilox(SEED), n_step=STEPS, method="euler", sched="uniform",
        cfg_scale=CFG)
    with torch.no_grad():
        dec = TR.torch_vae_decode(
            params, torch.from_numpy(traj_t[-1]), TINY_VAE)
    img_t = tensor_to_image_arr(np.clip((dec.numpy() + 1.0) * 0.5, 0, 1))

    assert len(traj_jax) == len(traj_t) == STEPS
    for i, (a, b) in enumerate(zip(traj_jax, traj_t)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
        assert _hash_within_one_bucket(tensor_stat(a).hash,
                                       tensor_stat(b).hash), \
            f"step {i} stat-hash mismatch"
    psnr = _psnr_u8(img_jax, img_t)
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"


# ---------------------------------------------------------------------------
# SD3 (rectified flow): dual towers -> padded clip part + zero-T5 rows,
# pooled adaLN label, flow sigma grid, shift-factor VAE
# ---------------------------------------------------------------------------

from mlimgsynth_tpu.testing import (  # noqa: E402
    TINY_CLIP2 as _C2, TINY_MMDIT, TINY_VAE_SD3, write_checkpoint_sd3)


def test_e2e_generate_matches_torch_stack_sd3(tmp_path, monkeypatch):
    ckpt = tmp_path / "tiny_sd3.safetensors"
    arrays = write_checkpoint_sd3(ckpt)
    from mlimgsynth_tpu.testing import TINY_MODEL_TYPE_SD3
    patch_tiny_model_types(monkeypatch, {"sd3": TINY_MODEL_TYPE_SD3})

    s = MLImgSynth()
    s._dtype = jnp.float32
    s.option_set("model", str(ckpt))
    s.option_set("model-type", "sd3")
    s.option_set("image-dim", 64)
    s.option_set("steps", STEPS)
    s.option_set("seed", SEED)
    s.option_set("cfg-scale", 4.0)
    s.option_set("method", "euler")
    s.option_set("scheduler", "uniform")
    s.option_set("no-prompt-parse", 1)
    s.option_set("prompt", PROMPT)
    s.option_set("nprompt", NPROMPT)
    traj_jax = []
    s.step_observer = lambda i, lat: traj_jax.append(
        np.asarray(lat, np.float32).copy())
    s.generate()
    img_jax = tensor_to_image_arr(np.asarray(s.tensors["image"], np.float32))

    params = _internal_params(arrays)
    skip = 2                               # sd3 default clip skip

    def encode(text):
        t1, f1 = _wrapped2(text, TINY_CLIP)
        t2, f2 = _wrapped2(text, _C2)
        c1, feat1 = TR.torch_clip_text(params, t1, TINY_CLIP,
                                       clip_skip=skip, norm=False,
                                       feat_tok_idx=[f1])
        c2, feat2 = TR.torch_clip_text(params, t2, _C2, pre="clip2",
                                       clip_skip=skip, norm=False,
                                       feat_tok_idx=[f2])
        clip_part = torch.cat([c1, c2], dim=-1).float()
        pad = TINY_MMDIT.d_ctx_in - clip_part.shape[-1]
        clip_part = F_pad(clip_part, (0, pad))
        t5_part = torch.zeros((1, TINY_CLIP.n_token, TINY_MMDIT.d_ctx_in))
        cond = torch.cat([clip_part, t5_part], dim=1)
        return cond, torch.cat([feat1, feat2], dim=-1).float()

    cond, pooled = encode(PROMPT)
    uncond, npooled = encode(NPROMPT)

    x0 = np.zeros((1, TINY_MMDIT.n_ch_in, 8, 8), np.float32)
    traj_t, _sig = TS.torch_sample_flow(
        params, TINY_MMDIT, x0, cond, pooled, uncond, npooled,
        rng=RngPhilox(SEED), n_step=STEPS, method="euler", sched="uniform",
        cfg_scale=4.0)
    with torch.no_grad():
        dec = TR.torch_vae_decode(
            params, torch.from_numpy(traj_t[-1]), TINY_VAE_SD3)
    img_t = tensor_to_image_arr(np.clip((dec.numpy() + 1.0) * 0.5, 0, 1))

    assert len(traj_jax) == len(traj_t) == STEPS
    for i, (a, b) in enumerate(zip(traj_jax, traj_t)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
        assert tensor_stat(a).hash == tensor_stat(b).hash, \
            f"step {i} stat-hash mismatch"
    psnr = _psnr_u8(img_jax, img_t)
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"


def test_e2e_generate_matches_torch_stack_flux(tmp_path, monkeypatch):
    """Flux.1-schnell pipeline: zero-T5 context + unprojected pooled
    CLIP-L label + rectified-flow euler loop + shift-factor VAE, all
    replicated on torch kernels.  Flux forward parity carries a ~4e-4
    f32 reassociation spread (tests/test_flux.py), so the per-step gate
    is 2e-3 and the stat-hash comparison is skipped; the final image
    still gates at PSNR > 40 dB."""
    from mlimgsynth_tpu.api import ModelTypeDef
    from mlimgsynth_tpu.testing import (TINY_FLUX_SCHNELL, TINY_VAE_FLUX,
                                        write_tiny_flux_files)
    P = TINY_FLUX_SCHNELL
    files, params = write_tiny_flux_files(tmp_path, P=P,
                                          return_arrays=True)
    patch_tiny_model_types(monkeypatch, {
        "flux_schnell": ModelTypeDef("flux_schnell", TINY_CLIP, None, P,
                                     TINY_VAE_FLUX, 64, 1)})

    s = MLImgSynth()
    s._dtype = jnp.float32
    s.option_set("model", files["model"])
    s.option_set("clip", files["clip"])
    s.option_set("vae", files["vae"])
    s.option_set("image-dim", 64)
    s.option_set("steps", STEPS)
    s.option_set("seed", SEED)
    s.option_set("cfg-scale", 1.0)
    s.option_set("method", "euler")
    s.option_set("scheduler", "uniform")
    s.option_set("no-prompt-parse", 1)
    s.option_set("prompt", PROMPT)
    traj_jax = []
    s.step_observer = lambda i, lat: traj_jax.append(
        np.asarray(lat, np.float32).copy())
    s.generate()
    img_jax = tensor_to_image_arr(np.asarray(s.tensors["image"], np.float32))

    # conditioning: zero T5 rows (no --t5 file) + unprojected pooled EOS
    t1, f1 = _wrapped2(PROMPT, TINY_CLIP)
    _, pooled = TR.torch_clip_text(params, t1, TINY_CLIP, norm=False,
                                   feat_tok_idx=[f1], feat_proj=False)
    cond = torch.zeros((1, TINY_CLIP.n_token, P.d_ctx_in))

    x0 = np.zeros((1, P.n_ch_in // 4, 8, 8), np.float32)
    traj_t, _sig = TS.torch_sample_flow(
        params, P, x0, cond, pooled.float(),
        rng=RngPhilox(SEED), n_step=STEPS, method="euler", sched="uniform",
        cfg_scale=1.0)
    with torch.no_grad():
        dec = TR.torch_vae_decode(
            params, torch.from_numpy(traj_t[-1]), TINY_VAE_FLUX)
    img_t = tensor_to_image_arr(np.clip((dec.numpy() + 1.0) * 0.5, 0, 1))

    assert len(traj_jax) == len(traj_t) == STEPS
    for i, (a, b) in enumerate(zip(traj_jax, traj_t)):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=1e-3,
                                   err_msg=f"step {i} latent mismatch")
    psnr = _psnr_u8(img_jax, img_t)
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"


def test_e2e_generate_matches_torch_stack_flux_dev(tmp_path, monkeypatch):
    """Flux.1-dev variant: cfg_scale becomes the EMBEDDED guidance value
    (one NFE/step, no uncond pass) and the sigma grid uses the dynamic
    resolution shift — both replicated torch-side."""
    import dataclasses
    from mlimgsynth_tpu.api import ModelTypeDef
    from mlimgsynth_tpu.models import flux as flux_mod
    from mlimgsynth_tpu.testing import (TINY_FLUX_DEV, TINY_VAE_FLUX,
                                        write_tiny_flux_files)
    P = TINY_FLUX_DEV
    files, params = write_tiny_flux_files(tmp_path, P=P,
                                          return_arrays=True)
    patch_tiny_model_types(monkeypatch, {
        "flux_dev": ModelTypeDef("flux_dev", TINY_CLIP, None, P,
                                 TINY_VAE_FLUX, 64, 1)})

    s = MLImgSynth()
    s._dtype = jnp.float32
    s.option_set("model", files["model"])
    s.option_set("clip", files["clip"])
    s.option_set("vae", files["vae"])
    s.option_set("image-dim", 64)
    s.option_set("steps", STEPS)
    s.option_set("seed", SEED)
    s.option_set("cfg-scale", 3.5)        # -> embedded guidance
    s.option_set("method", "euler")
    s.option_set("scheduler", "uniform")
    s.option_set("no-prompt-parse", 1)
    s.option_set("prompt", PROMPT)
    traj_jax = []
    s.step_observer = lambda i, lat: traj_jax.append(
        np.asarray(lat, np.float32).copy())
    s.generate()
    img_jax = tensor_to_image_arr(np.asarray(s.tensors["image"], np.float32))

    t1, f1 = _wrapped2(PROMPT, TINY_CLIP)
    _, pooled = TR.torch_clip_text(params, t1, TINY_CLIP, norm=False,
                                   feat_tok_idx=[f1], feat_proj=False)
    cond = torch.zeros((1, TINY_CLIP.n_token, P.d_ctx_in))

    shift = flux_mod.dynamic_flow_shift(P, 8, 8)
    Pt = dataclasses.replace(P, flow_shift=shift)
    x0 = np.zeros((1, P.n_ch_in // 4, 8, 8), np.float32)
    traj_t, _sig = TS.torch_sample_flow(
        params, Pt, x0, cond, pooled.float(),
        rng=RngPhilox(SEED), n_step=STEPS, method="euler", sched="uniform",
        cfg_scale=1.0, guidance=torch.tensor([3.5]))
    with torch.no_grad():
        dec = TR.torch_vae_decode(
            params, torch.from_numpy(traj_t[-1]), TINY_VAE_FLUX)
    img_t = tensor_to_image_arr(np.clip((dec.numpy() + 1.0) * 0.5, 0, 1))

    assert len(traj_jax) == len(traj_t) == STEPS
    for i, (a, b) in enumerate(zip(traj_jax, traj_t)):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=1e-3,
                                   err_msg=f"step {i} latent mismatch")
    psnr = _psnr_u8(img_jax, img_t)
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"


def test_e2e_generate_matches_torch_stack_sd35_medium(tmp_path, monkeypatch):
    """MMDiT-X (SD3.5-medium style): qk RMSNorm + dual self-attention in
    the flagged x-blocks, on top of the SD3 conditioning stack — the 5th
    family variant through the composed oracle."""
    from mlimgsynth_tpu.testing import TINY_MMDIT_X, ModelTypeDef
    ckpt = tmp_path / "tiny_sd35m.safetensors"
    arrays = write_checkpoint_sd3(ckpt, P=TINY_MMDIT_X)
    patch_tiny_model_types(monkeypatch, {"sd3": ModelTypeDef(
        "sd3", TINY_CLIP, _C2, TINY_MMDIT_X, TINY_VAE_SD3, 64, 2)})

    s = MLImgSynth()
    s._dtype = jnp.float32
    s.option_set("model", str(ckpt))
    s.option_set("model-type", "sd3")
    s.option_set("image-dim", 64)
    s.option_set("steps", STEPS)
    s.option_set("seed", SEED)
    s.option_set("cfg-scale", 4.0)
    s.option_set("method", "euler")
    s.option_set("scheduler", "uniform")
    s.option_set("no-prompt-parse", 1)
    s.option_set("prompt", PROMPT)
    s.option_set("nprompt", NPROMPT)
    traj_jax = []
    s.step_observer = lambda i, lat: traj_jax.append(
        np.asarray(lat, np.float32).copy())
    s.generate()
    img_jax = tensor_to_image_arr(np.asarray(s.tensors["image"], np.float32))

    params = _internal_params(arrays)
    skip = 2

    def encode(text):
        t1, f1 = _wrapped2(text, TINY_CLIP)
        t2, f2 = _wrapped2(text, _C2)
        c1, feat1 = TR.torch_clip_text(params, t1, TINY_CLIP,
                                       clip_skip=skip, norm=False,
                                       feat_tok_idx=[f1])
        c2, feat2 = TR.torch_clip_text(params, t2, _C2, pre="clip2",
                                       clip_skip=skip, norm=False,
                                       feat_tok_idx=[f2])
        clip_part = torch.cat([c1, c2], dim=-1).float()
        pad = TINY_MMDIT_X.d_ctx_in - clip_part.shape[-1]
        clip_part = F_pad(clip_part, (0, pad))
        t5_part = torch.zeros((1, TINY_CLIP.n_token, TINY_MMDIT_X.d_ctx_in))
        cond = torch.cat([clip_part, t5_part], dim=1)
        return cond, torch.cat([feat1, feat2], dim=-1).float()

    cond, pooled = encode(PROMPT)
    uncond, npooled = encode(NPROMPT)

    x0 = np.zeros((1, TINY_MMDIT_X.n_ch_in, 8, 8), np.float32)
    traj_t, _sig = TS.torch_sample_flow(
        params, TINY_MMDIT_X, x0, cond, pooled, uncond, npooled,
        rng=RngPhilox(SEED), n_step=STEPS, method="euler", sched="uniform",
        cfg_scale=4.0)
    with torch.no_grad():
        dec = TR.torch_vae_decode(
            params, torch.from_numpy(traj_t[-1]), TINY_VAE_SD3)
    img_t = tensor_to_image_arr(np.clip((dec.numpy() + 1.0) * 0.5, 0, 1))

    assert len(traj_jax) == len(traj_t) == STEPS
    # the dual-attention x-blocks add a second f32 reassociation path, so
    # a stat-hash bucket can straddle (one adjacent-character flip seen at
    # step 4); pin the latents tightly + PSNR like the flux cases instead
    for i, (a, b) in enumerate(zip(traj_jax, traj_t)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    psnr = _psnr_u8(img_jax, img_t)
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"


# ---------------------------------------------------------------------------
# ControlNet: hint encoder + control branch residuals through the full stack
# ---------------------------------------------------------------------------

def test_e2e_generate_matches_torch_stack_controlnet(tmp_path, monkeypatch):
    """7th leg: the ControlNet-conditioned ``mlis_generate`` stack
    (reference: src/control.c + unet_with_control) vs the torch oracle —
    the only major conditioning path the composed oracle did not cover.
    The torch side recomputes the hint-encoder features each eval (the
    production path hoists them out of the loop: sampler consts), so
    agreement also pins that hoist as value-preserving."""
    from mlimgsynth_tpu.nameconv import normalize_cnet_name
    from mlimgsynth_tpu.testing import write_tiny_controlnet

    ckpt = tmp_path / "tiny.safetensors"
    cnet = tmp_path / "tiny_cnet.safetensors"
    arrays = write_tiny_checkpoint(ckpt)
    cnet_arrays = write_tiny_controlnet(cnet)
    patch_tiny_model_types(monkeypatch)
    hint_u8 = (np.random.default_rng(3).random((64, 64, 3)) * 255).astype(
        np.uint8)
    strength = 0.8

    s = MLImgSynth()
    s._dtype = jnp.float32
    s.option_set("model", str(ckpt))
    s.option_set("model-type", "sd1")
    s.option_set("control-net", str(cnet))
    s.option_set("control-image", hint_u8)
    s.option_set("control-strength", strength)
    s.option_set("image-dim", 64)
    s.option_set("steps", STEPS)
    s.option_set("seed", SEED)
    s.option_set("cfg-scale", CFG)
    s.option_set("method", "euler")
    s.option_set("scheduler", "uniform")
    s.option_set("no-prompt-parse", 1)
    s.option_set("prompt", PROMPT)
    s.option_set("nprompt", NPROMPT)
    traj_jax = []
    s.step_observer = lambda i, lat: traj_jax.append(
        np.asarray(lat, np.float32).copy())
    s.generate()
    img_jax = tensor_to_image_arr(np.asarray(s.tensors["image"], np.float32))

    params = {normalize_name(cv): arr for cv, arr in arrays.items()}
    params.update({normalize_cnet_name(ck): arr
                   for ck, arr in cnet_arrays.items()})
    cond, _ = TR.torch_clip_text(params, _wrapped_tokens(PROMPT), TINY_CLIP)
    uncond, _ = TR.torch_clip_text(params, _wrapped_tokens(NPROMPT),
                                   TINY_CLIP)
    hint = torch.from_numpy(
        hint_u8.astype(np.float32).transpose(2, 0, 1)[None] / 255.0)
    x0 = np.zeros((1, 4, 8, 8), np.float32)
    traj_t, _sig = TS.torch_sample(
        params, TINY_UNET, x0, cond.float(), uncond.float(),
        rng=RngPhilox(SEED), n_step=STEPS, method="euler", sched="uniform",
        cfg_scale=CFG, cnet_hint=hint, cnet_strength=strength)
    with torch.no_grad():
        dec = TR.torch_vae_decode(
            params, torch.from_numpy(traj_t[-1]), TINY_VAE)
    img01 = np.clip((dec.numpy() + 1.0) * 0.5, 0.0, 1.0)
    img_t = tensor_to_image_arr(img01)

    assert len(traj_jax) == len(traj_t) == STEPS
    for i, (a, b) in enumerate(zip(traj_jax, traj_t)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
        if i < STEPS - 2:
            # the control branch adds a second f32 accumulation path per
            # eval (hint encoder + residual taps); a late-step stat-hash
            # bucket can straddle (one adjacent-character flip seen at
            # step 3) -- early steps must still hash-match, late steps
            # are pinned by the tight latent allclose + final PSNR
            assert tensor_stat(a).hash == tensor_stat(b).hash, \
                f"step {i} stat-hash mismatch"
    psnr = _psnr_u8(img_jax, img_t)
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"


# ---------------------------------------------------------------------------
# img2img + latent-mask inpaint: VAE encode -> truncated schedule -> masked
# denoise -> decode through the full stack
# ---------------------------------------------------------------------------

def test_e2e_generate_matches_torch_stack_img2img_inpaint(tmp_path,
                                                          monkeypatch):
    """8th leg: the img2img+inpaint ``mlis_generate`` stack — VAE ENCODE
    (moments + Philox posterior sample, reference mlis_img2img), the
    f_t_ini-truncated schedule, per-step mask reapply (1 = KEEP, the
    library latent-mask convention, src/sampling.c:98-110), and decode —
    vs the all-torch pipeline.  Pins the encode draw order (per-sample
    streams at seed+i sharing the session offset) and the block-mean
    mask downsize against independent transcriptions."""
    ckpt = tmp_path / "tiny.safetensors"
    arrays = write_tiny_checkpoint(ckpt)
    patch_tiny_model_types(monkeypatch)
    rng0 = np.random.default_rng(7)
    init_u8 = (rng0.random((64, 64, 3)) * 255).astype(np.uint8)
    keep = np.ones((1, 1, 64, 64), np.float32)
    keep[:, :, 16:48, 8:40] = 0.0            # repaint window
    F_T_INI = 0.7

    s = MLImgSynth()
    s._dtype = jnp.float32
    s.option_set("model", str(ckpt))
    s.option_set("model-type", "sd1")
    s.option_set("image-dim", 64)
    s.option_set("steps", STEPS)
    s.option_set("seed", SEED)
    s.option_set("cfg-scale", CFG)
    s.option_set("method", "euler")
    s.option_set("scheduler", "uniform")
    s.option_set("f_t_ini", F_T_INI)
    s.option_set("no-prompt-parse", 1)
    s.option_set("prompt", PROMPT)
    s.option_set("nprompt", NPROMPT)
    s.option_set("image", init_u8)
    s.option_set("image_mask", keep)
    traj_jax = []
    s.step_observer = lambda i, lat: traj_jax.append(
        np.asarray(lat, np.float32).copy())
    s.generate()
    img_jax = tensor_to_image_arr(np.asarray(s.tensors["image"], np.float32))

    # ---- oracle stack ----
    params = {normalize_name(cv): arr for cv, arr in arrays.items()}
    cond, _ = TR.torch_clip_text(params, _wrapped_tokens(PROMPT), TINY_CLIP)
    uncond, _ = TR.torch_clip_text(params, _wrapped_tokens(NPROMPT),
                                   TINY_CLIP)
    # VAE encode: u8 -> [0,1] -> [-1,1] -> moments -> Philox posterior
    # sample * scale_factor (api.image_encode transcription)
    x01 = init_u8.astype(np.float32).transpose(2, 0, 1)[None] / 255.0
    with torch.no_grad():
        mom = TR.torch_vae_encode(
            params, torch.from_numpy(x01 * 2.0 - 1.0), TINY_VAE).numpy()
    rng = RngPhilox(SEED)
    st = RngPhilox(SEED + 0, rng.offset)     # per-sample stream, i = 0
    ch_z = TINY_VAE.ch_z
    rand = st.randn_shaped((ch_z, 8, 8))[None]
    rng.offset = st.offset
    mean, logvar = mom[:, :ch_z], np.clip(mom[:, ch_z:], -30, 20)
    x0 = ((mean + np.exp(logvar * 0.5) * rand)
          * TINY_VAE.scale_factor).astype(np.float32)
    # block-mean latent mask (ltensor_downsize transcription)
    lmask = keep.reshape(1, 1, 8, 8, 8, 8).mean(axis=(3, 5))
    traj_t, _sig = TS.torch_sample(
        params, TINY_UNET, x0, cond.float(), uncond.float(),
        rng=rng, n_step=STEPS, method="euler", sched="uniform",
        cfg_scale=CFG, f_t_ini=F_T_INI, lmask=lmask)
    with torch.no_grad():
        dec = TR.torch_vae_decode(
            params, torch.from_numpy(traj_t[-1]), TINY_VAE)
    img_t = tensor_to_image_arr(np.clip((dec.numpy() + 1.0) * 0.5, 0, 1))

    assert len(traj_jax) == len(traj_t) > 0
    # the VAE-encoder posterior sample feeds an extra f32 accumulation
    # path into every latent, so a stat-hash bucket can straddle (one
    # adjacent-character flip seen at step 1); pin the latents tightly +
    # PSNR like the flux / MMDiT-X / ControlNet cases instead
    for i, (a, b) in enumerate(zip(traj_jax, traj_t)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    psnr = _psnr_u8(img_jax, img_t)
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"
