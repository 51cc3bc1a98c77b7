"""Fully-jitted denoising loop.

The reference drives sampling from a host loop with one device round-trip per
UNet evaluation (reference: src/sampling.c:119-185, src/mlimgsynth.c:1746-1750)
and evaluates cond/uncond sequentially for CFG.  Here the whole loop is a
single ``lax.scan`` compiled once: CFG runs as one batched UNet call
(cond/uncond stacked on the batch axis), solver state lives in the scan carry,
and all noise is pre-drawn on the host with the reference's exact Philox
sequence (bit-compatible seeds) and passed in as scan inputs.

A step-at-a-time path (same compiled body, python-driven) is used when a
progress callback needs to observe/abort between steps; the carry stays on
device so the only per-step cost is dispatch.

Array convention at this module's boundary: latents are NCHW numpy (matching
the reference's memory order, so Philox noise lands on the same elements);
they are transposed to NHWC for the device loop internally.
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models import blocks as B
from ..models import unet as unet_mod
from ..rng import RngPhilox
from . import schedule as sch
from .solvers import SolverClass, get_solver

# Filled by run_sampler under MLIS_MEM_ANALYSIS=1 (bench memory reporting).
LAST_MEMORY_ANALYSIS = None


@dataclass
class SamplerConfig:
    """Mirrors the reference's DenoiseSampler config (src/sampling.h:16-37)."""
    method: str = "euler"
    sched: str = "uniform"
    n_step: int = 20
    cfg_scale: float = 7.0
    s_ancestral: float = 0.0
    s_noise: float = 0.0
    f_t_ini: float = 1.0
    f_t_end: float = 0.0
    # Ensemble-of-experts handoff knobs (beyond-reference; diffusers'
    # denoising_end/denoising_start semantics).  ``keep_tail``: drop the
    # schedule's final jump-to-zero so the run STOPS at sigma(f_t_end)
    # with that much noise remaining (the handoff latent).  ``noise_add``
    # False: skip the initial noise addition — the input latent is
    # already AT sigma(f_t_ini) (the draw still happens so later draws
    # in the stream are unchanged).
    keep_tail: bool = False
    noise_add: bool = True
    # Rectified-flow models (SD3/MMDiT): when > 0, schedules are built on
    # the flow sigma table with this resolution shift (sigma == t in [0,1],
    # velocity prediction — see models/mmdit.py).  0 = SD beta-linear.
    flow_shift: float = 0.0
    # CFG rescale phi (beyond-reference; Lin et al. 2023, "Common Diffusion
    # Noise Schedules and Sample Steps are Flawed" §3.4): blends the CFG
    # output toward a version whose per-sample std is restored to the
    # conditional prediction's std, countering CFG over-exposure on
    # v-prediction models.  0 = off (exact legacy mixing).
    cfg_rescale: float = 0.0
    # Skip-layer guidance (beyond-reference; SD3.5-medium's recommended
    # sampling mode): an EXTRA conditional model evaluation with
    # ``slg_layers`` joint blocks elided, mixed as
    # out += slg_scale * (cond - cond_skipped) on steps in the
    # [slg_start, slg_end) fraction of the schedule.  DiT families (MMDiT:
    # joint-block indices; Flux: 0..depth_double-1 = double blocks, then
    # single blocks).
    slg_scale: float = 0.0
    slg_layers: tuple = (7, 8, 9)
    slg_start: float = 0.01
    slg_end: float = 0.2
    # Perturbed-attention guidance (beyond-reference; Ahn et al. 2024,
    # "Self-Rectifying Diffusion Sampling with PAG"): an EXTRA conditional
    # eval with the MID transformer's self-attention map replaced by the
    # identity, mixed as out += pag_scale * (cond - cond_perturbed).
    # SD-UNet families only.
    pag_scale: float = 0.0
    pag_start: float = 0.0
    pag_end: float = 1.0


@dataclass
class SamplingPlan:
    """Host-computed schedule + noise (NCHW), ready for the device loop."""
    sigmas: np.ndarray
    n_step: int
    nfe_per_step: int
    s_hat: np.ndarray
    churn_sigma: np.ndarray
    s_down: np.ndarray
    s_up: np.ndarray
    t_next: np.ndarray
    noise0: np.ndarray
    churn_noise: np.ndarray
    anc_noise: np.ndarray
    # sigma<->t table the schedule was built on (flow models use their own);
    # None = the SD beta-linear default
    log_sigmas: Optional[np.ndarray] = None


def plan_n_step(cfg: SamplerConfig, nfe_per_dxdt: int = 1) -> int:
    """Loop step count the plan will have (schedule length after NFE
    division, f_t truncation, and keep_tail) — needed BEFORE encoding
    when prompt editing maps text segments onto steps."""
    solver = get_solver(cfg.method)
    sched = cfg.sched
    if solver.name == "lcm" and sched in (None, "", sch.SCHED_UNIFORM):
        sched = sch.SCHED_LCM
    ls = sch.log_sigmas_flow(cfg.flow_shift) if cfg.flow_shift else None
    s = sch.make_schedule(cfg.n_step, sched, solver.n_fe, nfe_per_dxdt,
                          cfg.f_t_ini, cfg.f_t_end, log_sigmas=ls)
    n = s.n_step
    if cfg.keep_tail and n >= 2:
        n -= 1
    return n


def _noise_slerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    """Per-sample spherical interpolation over the flattened noise
    tensors (A1111 seed-variation semantics, processing.slerp)."""
    out = np.empty_like(a)
    for i in range(a.shape[0]):
        va, vb = a[i].ravel(), b[i].ravel()
        dot = float(np.dot(va, vb)
                    / (np.linalg.norm(va) * np.linalg.norm(vb)))
        if abs(dot) > 0.9995:
            out[i] = (1.0 - t) * a[i] + t * b[i]
        else:
            om = np.arccos(dot)
            so = np.sin(om)
            out[i] = ((np.sin((1.0 - t) * om) / so) * a[i]
                      + (np.sin(t * om) / so) * b[i])
    return out


def make_plan(cfg: SamplerConfig, latent_shape, rng: RngPhilox,
              nfe_per_dxdt: int = 1, seeds=None, subseeds=None,
              subseed_strength: float = 0.0) -> SamplingPlan:
    """Compute sigma schedule and pre-draw all noise in the reference's exact
    order (initial, then per step: churn draw, post-step ancestral draw —
    src/sampling.c:119-178).  ``latent_shape`` is NCHW; for batch > 1 each
    sample gets its own sequential Philox draw.  ``seeds`` (optional list,
    one per batch element) overrides the default seed+i per-sample streams
    (used by the serving batch-merge path where requests bring their own
    seeds)."""
    solver = get_solver(cfg.method)
    sched = cfg.sched
    if solver.name == "lcm" and sched in (None, "", sch.SCHED_UNIFORM):
        # the lcm method implies the distillation's timestep grid unless a
        # schedule was chosen explicitly (diffusers bundles them)
        sched = sch.SCHED_LCM
    ls = None
    if cfg.flow_shift:
        if solver.name == "lcm":
            raise ValueError("lcm sampling is not defined for "
                             "rectified-flow models")
        ls = sch.log_sigmas_flow(cfg.flow_shift)
    s = sch.make_schedule(cfg.n_step, sched, solver.n_fe, nfe_per_dxdt,
                          cfg.f_t_ini, cfg.f_t_end, log_sigmas=ls)
    # SDE methods: s_ancestral doubles as eta (default 1), s_noise as the
    # k-diffusion noise multiplier; see plan_step_noise
    sde_eta = 0.0
    if solver.name.endswith("_sde"):
        sde_eta = cfg.s_ancestral if cfg.s_ancestral > 0 else 1.0
    if cfg.keep_tail and s.n_step >= 2:
        # drop the final jump-to-zero: the run ends AT sigma(f_t_end),
        # returning the handoff latent for an ensemble second stage
        s = sch.StepSchedule(sigmas=s.sigmas[:s.n_step].copy(),
                             n_step=s.n_step - 1,
                             nfe_per_step=s.nfe_per_step)
    plan = sch.plan_step_noise(s.sigmas, cfg.s_ancestral, cfg.s_noise,
                               sde_eta, lcm=(solver.name == "lcm"))
    n_step = s.n_step
    n_batch = latent_shape[0]
    sample_shape = tuple(latent_shape[1:])

    # batch sample i draws from an independent stream seeded (seed + i) so
    # batch entry i reproduces a single-image run with that seed (matching
    # the reference's generate.sh seed-increment loop)
    if seeds is None:
        seeds = [rng.seed + i for i in range(n_batch)]
    assert len(seeds) == n_batch, (len(seeds), n_batch)
    streams = [RngPhilox(sd, rng.offset) for sd in seeds]

    def draw():
        out = np.stack([st.randn_shaped(sample_shape) for st in streams])
        return out.astype(np.float32)

    noise0 = draw()
    if subseed_strength > 0 and subseeds is not None and cfg.noise_add:
        # seed variations: slerp toward an independent fresh stream per
        # sample (A1111 subseed/subseed_strength); only the INITIAL
        # noise is blended, per-step draws stay on the seed streams
        sub = np.stack([RngPhilox(sd, 0).randn_shaped(sample_shape)
                        for sd in subseeds]).astype(np.float32)
        noise0 = _noise_slerp(noise0, sub, float(subseed_strength))
    if not cfg.noise_add:
        # the input latent is already at sigma(f_t_ini) (ensemble handoff);
        # the draw above still advanced the stream so per-step draws match
        # an equivalent img2img run
        noise0 = np.zeros_like(noise0)
    churn = np.zeros((n_step,) + tuple(latent_shape), np.float32)
    anc = np.zeros_like(churn)
    for i in range(n_step):
        if plan.churn_sigma[i] > 0:
            churn[i] = draw()
        if plan.s_up[i] > 0:
            anc[i] = draw()
    rng.offset = streams[0].offset  # keep the session stream stateful
    return SamplingPlan(
        sigmas=s.sigmas, n_step=n_step, nfe_per_step=s.nfe_per_step,
        s_hat=plan.s_hat, churn_sigma=plan.churn_sigma, s_down=plan.s_down,
        s_up=plan.s_up, t_next=plan.t_next, noise0=noise0,
        churn_noise=churn, anc_noise=anc, log_sigmas=ls)


def jnp_sigma_to_t(log_sigmas, sigma):
    """Jittable sigma -> continuous t (src/unet.c:315-328)."""
    ls = jnp.log(sigma)
    n = log_sigmas.shape[0]
    idx = jnp.clip(jnp.searchsorted(log_sigmas, ls, side="right") - 1, 0, n - 2)
    v1 = log_sigmas[idx]
    v2 = log_sigmas[idx + 1]
    t = idx + (ls - v1) / (v2 - v1)
    return jnp.clip(t, 0.0, n - 1)


def _mask_apply(x, x0, lmask):
    """Inpainting mask re-application (src/sampling.c:98-110)."""
    return x0 * lmask + x * (1.0 - lmask)


# Solvers deepcache composes with: exactly ONE dxdt call per step (the
# cache update escapes through a closure cell that a multi-eval solver
# would fire more than once).  lcm is 1-eval but bypasses dxdt entirely.
DC_METHODS = ("euler", "dpmpp2m", "dpmpp2m_sde", "taylor3", "unipc")


def _dc_cache0(x_nhwc, use_cfg, unet_p, dtype, s_ctx=0):
    """Zero-initialized deepcache carry for the stacked [cond; uncond]
    rows: the UNet's level-0 decoder incoming deep feature, (flow MMDiT)
    the deep-tail residual on the img token stream, or (flux) the
    residual on the concatenated txt ++ img stream — ``s_ctx`` is the
    context token count (models/{mmdit,flux}.py _dc_split)."""
    rows = x_nhwc.shape[0] * (2 if use_cfg else 1)
    if getattr(unet_p, "flux", False):
        hp, wp = x_nhwc.shape[1] // 2, x_nhwc.shape[2] // 2
        return jnp.zeros((rows, s_ctx + hp * wp, unet_p.d_model), dtype)
    if getattr(unet_p, "flow", False):
        hp = x_nhwc.shape[1] // unet_p.patch
        wp = x_nhwc.shape[2] // unet_p.patch
        return jnp.zeros((rows, hp * wp, unet_p.width), dtype)
    return jnp.zeros(
        (rows, x_nhwc.shape[1], x_nhwc.shape[2],
         unet_p.n_ch * unet_p.ch_mult[1]), dtype)


def _cfg_mix(d, n, cfg_scale, cfg_rescale):
    """CFG mixing of a stacked [cond; uncond] model output, optionally
    std-rescaled (Lin et al. 2023 §3.4: restore the per-sample std of the
    conditional prediction, then lerp by phi).  ``cfg_rescale`` is static:
    0 keeps the legacy jaxpr bit-identical."""
    out = d[:n] * cfg_scale + d[n:] * (1.0 - cfg_scale)
    if cfg_rescale > 0:
        # unbiased (ddof=1) per-sample std — the paper/diffusers convention
        ax = tuple(range(1, out.ndim))
        std_c = jnp.std(d[:n].astype(jnp.float32), axis=ax, keepdims=True,
                        ddof=1)
        std_o = jnp.std(out.astype(jnp.float32), axis=ax, keepdims=True,
                        ddof=1)
        scaled = out * (std_c / jnp.maximum(std_o, 1e-8)).astype(out.dtype)
        out = cfg_rescale * scaled + (1.0 - cfg_rescale) * out
    return out


def _make_body(params, consts, *, method, unet_p, use_cfg, use_mask, dtype,
               deepcache=0, dc_warm=0, tiling=False, cfg_rescale=0.0,
               freeu=None, slg=None, pag=None):
    """Build the per-step body shared by the fused scan and stepwise paths.

    ``deepcache`` > 1 enables encoder caching (DeepCache / "Faster
    Diffusion"; PAPERS.md): the UNet's deep feature (everything below
    level 0, incl. the mid transformer) is carried in the scan state and
    reused on steps where ``i %% deepcache != 0`` — the body's
    ``lax.cond`` picks the full or the shallow forward at runtime.  An
    approximation: opt-in, SD-UNet families only, 1-dxdt/step solvers."""
    solver = get_solver(method)
    ctx = B.Ctx(params, dtype=dtype, tiling=tiling)
    (cond_all, label_all, lmask, x0_keep, log_sigmas, s_hat, churn_sigma,
     s_down, s_up, t_next, cfg_scale) = consts[:11]
    # Conditioning tail: consts may carry (hint_img NHWC, cnet_strength,
    # extra_ch NHWC) — ControlNet hint image + strength, and the
    # inpaint-variant UNet's extra input channels.  The hint encoder is
    # x/t-independent, so it runs HERE — once per compiled program,
    # outside the scan body (and the batch-1 hint features broadcast
    # against CFG's stacked cond/uncond rows).
    control = extra_ch = None
    if len(consts) > 11 and consts[11] is not None:
        from ..models.controlnet import hint_apply
        control = (hint_apply(ctx, consts[11], unet_p), consts[12])
    if len(consts) > 13 and consts[13] is not None:
        extra_ch = consts[13]
    # prompt editing: consts[14] is a per-step row-index matrix [S, R]
    # into the conditioning bank (cond_all/label_all hold the bank rows);
    # the body gathers the step's [R, ...] conditioning before the solver
    # step (one tiny gather per step vs the UNet's work)
    cond_idx = consts[14] if len(consts) > 14 else None

    # Rectified-flow models (MMDiT): sigma IS the flow time in [0,1]; the
    # model timestep is sigma * n_step_train (no table lookup) and the
    # velocity output is dx/dsigma directly (models/mmdit.py denoise).
    flow = bool(getattr(unet_p, "flow", False))

    def model_t(sigma):
        # shared by the plain and deepcache dxdt bodies — keep the flow
        # vs sigma-table timestep rule in ONE place
        if flow:
            return sigma * unet_p.n_step_train
        return jnp_sigma_to_t(log_sigmas, sigma)

    if flow and getattr(unet_p, "flux", False):
        from ..models import flux as flux_mod
        den = flux_mod.denoise
    elif flow:
        from ..models import mmdit as mmdit_mod
        den = mmdit_mod.denoise
    else:
        den = unet_mod.denoise
        if freeu is not None:
            den = functools.partial(unet_mod.denoise, freeu=freeu)
    assert freeu is None or not flow, "FreeU is UNet-only"

    def dxdt_with(ca, la, i_step=None):
        def dxdt(xv, sigma):
            n = xv.shape[0]
            t = model_t(sigma)
            if use_cfg:
                xb = jnp.concatenate([xv, xv], axis=0)
                d = den(ctx, xb, sigma, t, ca, la,
                        unet_p, control=control, extra_ch=extra_ch)
                out = _cfg_mix(d, n, cfg_scale, cfg_rescale)
                d_cond = d[:n]
            else:
                out = d_cond = den(ctx, xv, sigma, t, ca, la,
                                   unet_p, control=control,
                                   extra_ch=extra_ch)
            if slg is not None:
                # skip-layer guidance: one EXTRA conditional eval with
                # slg[1] joint blocks elided; steer away from the degraded
                # prediction on steps inside the [i0, i1) window (the
                # lax.cond genuinely skips the eval outside it)
                scale, layers, i0, i1 = slg
                ca_c = ca[:n] if use_cfg else ca
                la_c = la[:n] if (use_cfg and la is not None) else la

                def steered(_):
                    d_skip = den(ctx, xv, sigma, t, ca_c, la_c, unet_p,
                                 control=control, extra_ch=extra_ch,
                                 skip_layers=layers)
                    return out + scale * (d_cond - d_skip)

                return jax.lax.cond((i_step >= i0) & (i_step < i1),
                                    steered, lambda _: out, None)
            if pag is not None:
                # perturbed-attention guidance: one EXTRA conditional eval
                # with the mid transformer's self-attention map replaced by
                # the identity; steer away from the perturbed prediction
                scale, i0, i1 = pag
                ca_c = ca[:n] if use_cfg else ca
                la_c = la[:n] if (use_cfg and la is not None) else la

                def perturbed(_):
                    d_pag = den(ctx, xv, sigma, t, ca_c, la_c, unet_p,
                                control=control, extra_ch=extra_ch,
                                pag=True)
                    return out + scale * (d_cond - d_pag)

                return jax.lax.cond((i_step >= i0) & (i_step < i1),
                                    perturbed, lambda _: out, None)
            return out
        return dxdt

    dxdt = dxdt_with(cond_all, label_all)

    def dxdt_at(i):
        if cond_idx is None:
            return dxdt_with(cond_all, label_all, i) \
                if (slg is not None or pag is not None) else dxdt
        return dxdt_with(
            jnp.take(cond_all, cond_idx[i], axis=0),
            (jnp.take(label_all, cond_idx[i], axis=0)
             if label_all is not None else None), i)

    if method == "lcm":
        # Latent-consistency sampling (diffusers LCMScheduler semantics):
        # one consistency-function evaluation per sigma — x0 prediction
        # through the boundary scalings c_out*x0 + c_skip*(c_in*x) with
        # sigma_data=0.5 and timestep_scaling=10 (c_in maps the EDM-space
        # latent to the DDPM-space sample the scalings are defined on) —
        # then a FULL re-noise to the next sigma (the ancestral slot,
        # s_up[i] = sigma_{i+1}; zero on the last step).
        def body(carry, inp):
            x, t, state = carry
            i, c_noise, a_noise = inp
            d = x - t * dxdt_at(i)(x, t)
            ts = jnp_sigma_to_t(log_sigmas, t) * 10.0
            c_skip = 0.25 / (ts * ts + 0.25)
            c_out = ts * jax.lax.rsqrt(ts * ts + 0.25)
            c_in = jax.lax.rsqrt(t * t + 1.0)
            x = c_out * d + (c_skip * c_in) * x + a_noise * s_up[i]
            t = t_next[i]
            if use_mask:
                x = _mask_apply(x, x0_keep, lmask)
            return (x, t, state), None

        return solver, body

    if deepcache > 1:
        assert cond_idx is None and control is None \
            and extra_ch is None, "deepcache: unsupported combination"

        def dc_dxdt(cache, is_full):
            # the cache update escapes the solver's dxdt call through a
            # closure cell: 1-dxdt/step solvers trace it exactly once
            cell = {}

            def dxdt(xv, sigma):
                n = xv.shape[0]
                t = model_t(sigma)
                xb = (jnp.concatenate([xv, xv], axis=0) if use_cfg
                      else xv)

                def full(op):
                    xb_, _ = op
                    return den(ctx, xb_, sigma, t, cond_all, label_all,
                               unet_p, want_cache=True)

                def shallow(op):
                    xb_, cache_ = op
                    d_ = den(ctx, xb_, sigma, t, cond_all, label_all,
                             unet_p, use_cache=cache_)
                    return d_, cache_

                d, nc = jax.lax.cond(is_full, full, shallow, (xb, cache))
                cell["cache"] = nc
                if use_cfg:
                    return _cfg_mix(d, n, cfg_scale, cfg_rescale)
                return d

            return dxdt, cell

        def body_dc(carry, inp):
            x, t, state, cache = carry
            i, c_noise, a_noise = inp
            churn = churn_sigma[i]
            x = x + c_noise * churn
            if use_mask:
                x = jnp.where(churn > 0, _mask_apply(x, x0_keep, lmask),
                              x)
            t = jnp.where(churn > 0, s_hat[i], t)
            # early steps form the image structure: refresh all of them
            # (DeepCache's non-uniform finding), then every k-th
            fn, cell = dc_dxdt(cache,
                               ((i % deepcache) == 0) | (i < dc_warm))
            x, state = solver.step(fn, x, state, i, t, s_down[i])
            cache = cell["cache"]
            x = x + a_noise * s_up[i]
            t = t_next[i]
            if use_mask:
                x = _mask_apply(x, x0_keep, lmask)
            return (x, t, state, cache), None

        return solver, body_dc

    def body(carry, inp):
        x, t, state = carry
        i, c_noise, a_noise = inp
        # stochastic churn (src/sampling.c:138-151)
        churn = churn_sigma[i]
        x = x + c_noise * churn
        if use_mask:
            x = jnp.where(churn > 0, _mask_apply(x, x0_keep, lmask), x)
        t = jnp.where(churn > 0, s_hat[i], t)
        # solver step (src/solvers.c)
        x, state = solver.step(dxdt_at(i), x, state, i, t, s_down[i])
        # post-step ancestral noise (src/sampling.c:170-174)
        x = x + a_noise * s_up[i]
        t = t_next[i]
        if use_mask:
            x = _mask_apply(x, x0_keep, lmask)
        return (x, t, state), None

    return solver, body


def _fused_encode(encode, consts, dtype, clip_p, clip_skip, norm, clip2_p):
    """Fused text encode: CLIP runs in the SAME program as the (first chunk
    of the) loop.  Token rows are laid out like cond_all ([cond xN, uncond
    xN]); wmat carries the per-token A1111 emphasis weights (an all-zero
    uncond row implements SDXL's uncond_empty_zero).  Returns the consts
    tuple with the computed conditioning (and, for SDXL, size labels)
    substituted, plus the raw conditioning arrays for the caller."""
    from ..models import blocks as B2
    from ..models import clip as clip_mod
    lab_out = None
    if clip2_p is None and len(encode) == 3:
        clip_params, tokens, wmat = encode
        ctx_c = B2.Ctx(clip_params, dtype=dtype)
        emb, _ = clip_mod.clip_text_apply_nd(ctx_c, tokens, clip_p,
                                          clip_skip=clip_skip, norm=norm)
        cond_out = emb.astype(jnp.float32) * wmat[:, :, None]
        consts = (cond_out,) + consts[1:]
    elif clip2_p is None and len(encode) == 6:
        # Flux: context = precomputed T5 rows; label = the clip tower's
        # UNPROJECTED pooled row (HF pooler_output), with the embedded
        # guidance value appended as one extra column for dev models
        clip_params, tokens, wmat, fidx, t5_rows, grow = encode
        ctx_c = B2.Ctx(clip_params, dtype=dtype)
        _, feat = clip_mod.clip_text_apply_nd(
            ctx_c, tokens, clip_p, clip_skip=clip_skip, norm=norm,
            feat_tok_idx=fidx, feat_proj=False)
        lab_out = feat.astype(jnp.float32)
        if grow is not None:
            lab_out = jnp.concatenate([lab_out, grow], axis=-1)
        cond_out = t5_rows.astype(jnp.float32)
        consts = (cond_out, lab_out) + consts[2:]
    elif clip2_p is None:
        # single-tower label model (SDXL-refiner): ONE bigG pass yields
        # both the skip-layer embedding and the projected pooled feature;
        # label rows = feature + per-row size/aesthetic embeddings
        clip_params, tokens, wmat, fidx, serows = encode
        ctx_c = B2.Ctx(clip_params, dtype=dtype)
        emb, feat = clip_mod.clip_text_apply_nd(ctx_c, tokens, clip_p,
                                             clip_skip=clip_skip, norm=norm,
                                             feat_tok_idx=fidx)
        cond_out = emb.astype(jnp.float32) * wmat[:, :, None]
        lab_out = jnp.concatenate([feat.astype(jnp.float32), serows],
                                  axis=-1)
        consts = (cond_out, lab_out) + consts[2:]
    elif len(encode) == 8:
        # SD3 flow: both towers' skip-layer hiddens concat on the feature
        # axis (zero-padded to the t5 width) ++ precomputed T5 rows on the
        # sequence axis; the adaLN label = concat of the projected pooled
        # features.  t5_rows are zeros without --t5 (the public pipelines'
        # no-T5 mode) or one host-side T5 dispatch with it.
        (clip_params, tokens, wmat, clip2_params, tokens2, fidx, fidx2,
         t5_rows) = encode
        ctx1 = B2.Ctx(clip_params, dtype=dtype)
        emb1, feat1 = clip_mod.clip_text_apply_nd(
            ctx1, tokens, clip_p, clip_skip=clip_skip, norm=norm,
            feat_tok_idx=fidx)
        ctx2 = B2.Ctx(clip2_params, dtype=dtype)
        emb2, feat2 = clip_mod.clip_text_apply_nd(
            ctx2, tokens2, clip2_p, clip_skip=clip_skip, norm=norm,
            feat_tok_idx=fidx2, pre="clip2")
        emb = jnp.concatenate([emb1, emb2], axis=-1).astype(jnp.float32)
        emb = emb * wmat[:, :, None]
        d_ctx = t5_rows.shape[-1]
        emb = jnp.pad(emb, ((0, 0), (0, 0), (0, d_ctx - emb.shape[-1])))
        cond_out = jnp.concatenate([emb, t5_rows.astype(jnp.float32)],
                                   axis=1)
        lab_out = jnp.concatenate([feat1.astype(jnp.float32),
                                   feat2.astype(jnp.float32)], axis=-1)
        consts = (cond_out, lab_out) + consts[2:]
    else:
        # SDXL dual-encoder: clip-L + bigG embeddings concat per token;
        # the size label = bigG feature + timestep-embedded sizes
        # (reference: mlis_text_cond_encode, src/mlimgsynth.c:1501-1563)
        (clip_params, tokens, wmat, clip2_params, tokens2, fidx,
         size_emb) = encode
        ctx1 = B2.Ctx(clip_params, dtype=dtype)
        emb1, _ = clip_mod.clip_text_apply_nd(ctx1, tokens, clip_p,
                                           clip_skip=clip_skip, norm=norm)
        ctx2 = B2.Ctx(clip2_params, dtype=dtype)
        emb2, feat = clip_mod.clip_text_apply_nd(
            ctx2, tokens2, clip2_p, clip_skip=clip_skip, norm=norm,
            feat_tok_idx=fidx, pre="clip2")
        emb = jnp.concatenate([emb1, emb2], axis=-1).astype(jnp.float32)
        cond_out = emb * wmat[:, :, None]
        lab_out = jnp.concatenate(
            [feat.astype(jnp.float32),
             jnp.broadcast_to(size_emb[None, :],
                              (feat.shape[0], size_emb.shape[0]))],
            axis=-1)
        consts = (cond_out, lab_out) + consts[2:]
    return consts, cond_out, lab_out


@functools.partial(
    jax.jit,
    static_argnames=("method", "unet_p", "use_cfg", "use_mask", "dtype",
                     "decode_kind", "vae_p", "clip_p", "clip_skip", "norm",
                     "clip2_p", "deepcache", "dc_warm", "tiling",
                     "cfg_rescale", "freeu", "slg", "pag"))
def _loop_jit(params, x, consts, noise0, churn_noise, anc_noise, sigmas0,
              decode_params=None, encode=None, xscale0=None, *, method,
              unet_p, use_cfg, use_mask, dtype, decode_kind=None, vae_p=None,
              clip_p=None, clip_skip=0, norm=True, clip2_p=None,
              deepcache=0, dc_warm=0, tiling=False, cfg_rescale=0.0, freeu=None,
              slg=None, pag=None):
    cond_out = lab_out = None
    if encode is not None:
        consts, cond_out, lab_out = _fused_encode(
            encode, consts, dtype, clip_p, clip_skip, norm, clip2_p)
    solver, body = _make_body(params, consts, method=method, unet_p=unet_p,
                              use_cfg=use_cfg, use_mask=use_mask,
                              dtype=dtype, deepcache=deepcache,
                              dc_warm=dc_warm, tiling=tiling,
                              cfg_rescale=cfg_rescale, freeu=freeu, slg=slg,
                              pag=pag)
    lmask, x0_keep = consts[2], consts[3]
    x = x.astype(jnp.float32)
    # flow models interpolate toward noise (x_t = (1-sigma) x0 + sigma n,
    # xscale0 = 1-sigma0) instead of the variance-exploding x0 + sigma n
    if xscale0 is not None:
        x = x * xscale0
    x = x + noise0 * sigmas0
    if use_mask:
        x = _mask_apply(x, x0_keep, lmask)
    state = solver.init_state(x)
    n_step = churn_noise.shape[0]
    if deepcache > 1:
        (x, _, _, _), _ = jax.lax.scan(
            body, (x, sigmas0, state,
                   _dc_cache0(x, use_cfg, unet_p, dtype,
                              s_ctx=consts[0].shape[1])),
            (jnp.arange(n_step), churn_noise, anc_noise))
    else:
        (x, _, _), _ = jax.lax.scan(
            body, (x, sigmas0, state),
            (jnp.arange(n_step), churn_noise, anc_noise))
    if decode_kind is None:
        return (x, cond_out, lab_out) if encode is not None else x
    # Fused final decode: loop + VAE/TAE + uint8 quantize in ONE program —
    # one dispatch and one (4x smaller) device->host fetch per generation
    # instead of loop/decode/fetch round-trips.
    img = _decode_u8(decode_params, x, decode_kind, vae_p, dtype,
                     tiling=tiling)
    return (x, img, cond_out, lab_out) if encode is not None else (x, img)


def _decode_u8(decode_params, x, decode_kind, vae_p, dtype,
               tiling=False):
    from ..models import blocks as B2
    ctx = B2.Ctx(decode_params, dtype=dtype, tiling=tiling)
    if decode_kind == "vae":
        from ..models import vae as vae_mod
        img = vae_mod.vae_decode_apply(ctx, x, vae_p).astype(jnp.float32)
        img = (img + 1.0) * (255.0 / 2.0)
    elif decode_kind == "tae":
        # vae_p doubles as the decode-params slot: TaeParams here (the
        # 16-ch taesd3/taef1 variants ride the same path), None = taesd
        from ..models import tae as tae_mod
        img = tae_mod.tae_decode_apply(
            ctx, x, vae_p or tae_mod.TAE_SD1).astype(jnp.float32) * 255.0
    elif decode_kind == "latent":
        # cheap linear latent->RGB approximation (for streaming previews
        # when no TAE is loaded): latent-resolution u8 image, ~free to
        # compute, fused into the chunk dispatch like the real decodes
        m = jnp.asarray([[0.298, 0.207, 0.208],
                         [0.187, 0.286, 0.173],
                         [-0.158, 0.189, 0.264],
                         [-0.184, -0.271, -0.473]], jnp.float32)
        img = jnp.einsum("nhwc,cd->nhwd", x[..., :4].astype(jnp.float32), m)
        img = (img + 1.0) * (255.0 / 2.0)
    else:
        raise ValueError(decode_kind)
    return jnp.clip(img, 0.0, 255.0).astype(jnp.uint8)


@functools.partial(
    jax.jit,
    static_argnames=("method", "unet_p", "use_cfg", "use_mask", "dtype",
                     "deepcache", "dc_warm", "tiling", "cfg_rescale", "freeu", "slg", "pag"))
def _step_jit(params, carry, i, c_noise, a_noise, consts,
              *, method, unet_p, use_cfg, use_mask, dtype, deepcache=0,
              dc_warm=0, tiling=False, cfg_rescale=0.0, freeu=None, slg=None,
              pag=None):
    _, body = _make_body(params, consts, method=method, unet_p=unet_p,
                         use_cfg=use_cfg, use_mask=use_mask, dtype=dtype,
                         deepcache=deepcache, dc_warm=dc_warm,
                         tiling=tiling, cfg_rescale=cfg_rescale, freeu=freeu,
                         slg=slg, pag=pag)
    carry, _ = body(carry, (i, c_noise, a_noise))
    return carry


@functools.partial(
    jax.jit,
    static_argnames=("method", "unet_p", "use_cfg", "use_mask", "dtype",
                     "decode_kind", "vae_p", "clip_p", "clip_skip", "norm",
                     "clip2_p", "deepcache", "dc_warm", "tiling",
                     "cfg_rescale", "freeu", "slg", "pag"))
def _chunk_jit(params, carry, i0, c_noise_chunk, a_noise_chunk, consts,
               decode_params=None, encode=None, *, method, unet_p, use_cfg,
               use_mask, dtype, decode_kind=None, vae_p=None, clip_p=None,
               clip_skip=0, norm=True, clip2_p=None, deepcache=0,
               dc_warm=0, tiling=False, cfg_rescale=0.0, freeu=None, slg=None,
               pag=None):
    """Scan a fixed-size chunk of steps from an arbitrary carry: progress
    callbacks fire between chunks with 1/chunk the dispatch overhead.
    With ``decode_kind`` (the FINAL chunk of a run), the image decode +
    u8 quantize rides the same dispatch; with ``encode`` (the FIRST chunk),
    the text encode does — the cancellable path then spends zero extra
    dispatches on encode/decode."""
    cond_out = lab_out = None
    if encode is not None:
        consts, cond_out, lab_out = _fused_encode(
            encode, consts, dtype, clip_p, clip_skip, norm, clip2_p)
    _, body = _make_body(params, consts, method=method, unet_p=unet_p,
                         use_cfg=use_cfg, use_mask=use_mask, dtype=dtype,
                         deepcache=deepcache, dc_warm=dc_warm,
                         tiling=tiling, cfg_rescale=cfg_rescale, freeu=freeu,
                         slg=slg, pag=pag)
    k = c_noise_chunk.shape[0]
    carry, _ = jax.lax.scan(
        body, carry,
        (i0 + jnp.arange(k), c_noise_chunk, a_noise_chunk))
    out = (carry,)
    if decode_kind is not None:
        out = out + (_decode_u8(decode_params, carry[0], decode_kind, vae_p,
                                dtype, tiling=tiling),)
    if encode is not None:
        out = out + (cond_out, lab_out)
    return out[0] if len(out) == 1 else out


@functools.partial(
    jax.jit, static_argnames=("method", "use_mask"))
def _init_jit(x, noise0, sigmas0, lmask, x0_keep, xscale0=None, *, method,
              use_mask):
    x = x.astype(jnp.float32)
    if xscale0 is not None:
        x = x * xscale0
    x = x + noise0 * sigmas0
    if use_mask:
        x = _mask_apply(x, x0_keep, lmask)
    state = get_solver(method).init_state(x)
    return (x, sigmas0, state)


def _nhwc(a):
    return jnp.asarray(np.asarray(a, np.float32).transpose(0, 2, 3, 1))


def run_sampler(params, x_init, plan: SamplingPlan, cond, uncond, label,
                nlabel, lmask, cfg: SamplerConfig,
                unet_p: unet_mod.UnetParams, dtype=jnp.bfloat16,
                step_callback=None, step_observer=None, mesh=None,
                decode=None, want_latent=True, encode=None, preview=None,
                chunk_size=None, control=None, extra_channels=None,
                cond_steps=None, deepcache=0, tiling=False, freeu=None):
    """Run the sampling loop.  ``x_init`` (NCHW f32), ``lmask`` [N,1,h,w] or
    None; ``cond/uncond`` [N,77,n_ctx]; returns the final latent NCHW —
    or ``(latent NCHW, u8 image NHWC)`` when ``decode`` is given.

    ``decode=(kind, params, vae_p)`` with kind "vae"|"tae" fuses the final
    image decode + uint8 quantize into the SAME compiled program as the
    loop: one dispatch, one (4x smaller) fetch per generation.

    With ``step_callback`` the loop runs step-at-a-time (device-resident
    carry); the callback receives (i_step, n_step) after each step and may
    return truthy to abort (reference: MLIS_Callback semantics,
    include/mlimgsynth.h:452-456).

    With ``mesh`` (a (dp, tp) ``jax.sharding.Mesh``) the batch inputs are
    sharded over the ``dp`` axis and the (pre-sharded) params' tp shardings
    propagate through the jitted loop; XLA inserts the collectives.

    ``control=(hint NCHW [1,3,H,W] f32 in [0,1], strength)`` injects
    ControlNet residuals (params under ``cnet.`` in the same dict) into
    every UNet evaluation; the hint encoder runs once per program.

    ``extra_channels`` (NCHW [1,n_extra,h,w] f32): loop-constant UNet
    input channels for inpaint-variant models (repaint mask +
    masked-image latent), concatenated after the c_in scaling.

    ``preview=(kind, params, vae_p, observer)`` (chunked/step_callback path
    only) fuses an extra image decode into EVERY chunk dispatch — kind
    "tae" for real preview frames or "latent" for the ~free linear
    latent->RGB approximation — and calls ``observer(i_step, img_u8_nhwc)``
    after each chunk (the final chunk's frame is the real ``decode``
    output).  Streaming previews therefore cost zero extra dispatches over
    the cancellable path."""
    use_cfg = cfg.cfg_scale > 1
    use_mask = lmask is not None
    n = x_init.shape[0]
    method = get_solver(cfg.method).name
    deepcache = int(deepcache or 0)
    if deepcache > 1:
        if method not in DC_METHODS:
            raise ValueError(
                "deepcache needs a 1-eval/step solver "
                f"({', '.join(DC_METHODS)})")
        flow_ = bool(getattr(unet_p, "flow", False))
        if (control is not None
                or extra_channels is not None or cond_steps is not None
                or mesh is not None or step_observer is not None
                or (not flow_
                    and len(getattr(unet_p, "ch_mult", ())) < 2)):
            raise ValueError("deepcache: unsupported configuration")
    else:
        deepcache = 0

    x = _nhwc(x_init)
    f32 = functools.partial(jnp.asarray, dtype=jnp.float32)
    enc_args = enc_static = None
    enc_static2 = None
    if encode is not None:
        # fused text-encode: the caller supplies tokens laid out like
        # cond_all ([cond rows xN, uncond rows xN]); conditioning is
        # computed inside the loop program.  Single-encoder models pass 6
        # entries; SDXL passes 11 (clip2 params/tokens/feat-idx/size-emb).
        assert step_observer is None and mesh is None, \
            "fused encode: no step observer / mesh"
        assert cond_steps is None, \
            "prompt editing uses the precomputed conditioning bank"
        assert not unet_p.ch_adm_in or len(encode) > 6, \
            "cond_label models need a label-bearing encode spec"
        clip_params, tokens, wmat = encode[:3]
        enc_static = encode[3:6]
        enc_args = (clip_params, jnp.asarray(tokens, jnp.int32),
                    jnp.asarray(wmat, jnp.float32))
        if len(encode) == 11:       # SDXL dual-encoder spec
            clip2_params, tokens2, fidx, size_emb, clip2_p_s = encode[6:]
            enc_args = enc_args + (
                clip2_params, jnp.asarray(tokens2, jnp.int32),
                jnp.asarray(fidx, jnp.int32),
                jnp.asarray(size_emb, jnp.float32))
            enc_static2 = clip2_p_s
        elif len(encode) == 12:     # SD3 flow dual-tower spec
            (clip2_params, tokens2, fidx, fidx2, t5_rows,
             clip2_p_s) = encode[6:]
            enc_args = enc_args + (
                clip2_params, jnp.asarray(tokens2, jnp.int32),
                jnp.asarray(fidx, jnp.int32),
                jnp.asarray(fidx2, jnp.int32),
                jnp.asarray(t5_rows, jnp.float32))
            enc_static2 = clip2_p_s
        elif len(encode) == 9:      # flux spec (t5 rows + pooled clip)
            fidx, t5_rows, grow = encode[6:]
            enc_args = enc_args + (
                jnp.asarray(fidx, jnp.int32),
                jnp.asarray(t5_rows, jnp.float32),
                None if grow is None else jnp.asarray(grow, jnp.float32))
        elif len(encode) == 8:      # single-tower label spec (SDXL-refiner)
            fidx, serows = encode[6:]
            enc_args = enc_args + (jnp.asarray(fidx, jnp.int32),
                                   jnp.asarray(serows, jnp.float32))
        cond_all = jnp.zeros((0,), jnp.float32)  # replaced inside the jit
        label_all = None
    elif cond_steps is not None:
        # prompt editing: ``cond`` is a bank of encoded rows [B,77,d]
        # (labels [B,dl]); ``cond_steps`` [S,R] picks the R loop rows
        # ([cond xN; uncond xN] layout) per step.  One batched encode,
        # one gather per step inside the scan.
        assert uncond is None and nlabel is None, \
            "cond_steps: pass all rows through the cond/label bank"
        assert len(cond_steps) == plan.n_step, \
            (len(cond_steps), plan.n_step)
        cond_all = f32(cond)
        label_all = f32(label) if unet_p.ch_adm_in else None
    else:
        cond = f32(cond)
        uncond = f32(uncond) if uncond is not None else cond
        if unet_p.ch_adm_in:
            label_d = f32(label)
            nlabel_d = f32(nlabel) if nlabel is not None else label_d
        if use_cfg:
            cond_all = jnp.concatenate([cond, uncond], axis=0)
            label_all = (jnp.concatenate([label_d, nlabel_d], axis=0)
                         if unet_p.ch_adm_in else None)
        else:
            cond_all = cond
            label_all = label_d if unet_p.ch_adm_in else None

    lmask_d = _nhwc(lmask) if use_mask else jnp.zeros((), jnp.float32)
    x0_keep = x if use_mask else jnp.zeros((), jnp.float32)

    noise0 = _nhwc(plan.noise0)

    def _noise_stack(arr, active):
        # all-zero stacks (no churn / no ancestral) collapse to a
        # broadcastable stub: avoids transferring megabytes of zeros
        if not active:
            return jnp.zeros((arr.shape[0], 1, 1, 1, 1), jnp.float32)
        return jnp.asarray(arr.transpose(0, 1, 3, 4, 2))

    churn = _noise_stack(plan.churn_noise, bool(plan.churn_sigma.max() > 0))
    anc = _noise_stack(plan.anc_noise, bool(plan.s_up.max() > 0))

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.mesh import DP_AXIS
        dp = mesh.shape.get(DP_AXIS, 1)

        def put(a, batch_axis=0):
            if not hasattr(a, "ndim") or a.ndim <= batch_axis:
                return a
            if dp > 1 and a.shape[batch_axis] % dp == 0:
                axes = [None] * a.ndim
                axes[batch_axis] = DP_AXIS
            else:
                axes = [None] * a.ndim  # replicate (stub / indivisible)
            return jax.device_put(a, NamedSharding(mesh, P(*axes)))

        x = put(x)
        cond_all = put(cond_all)
        if label_all is not None:
            label_all = put(label_all)
        lmask_d = put(lmask_d)
        x0_keep = put(x0_keep)
        noise0 = put(noise0)
        churn = put(churn, batch_axis=1)
        anc = put(anc, batch_axis=1)

    consts = (cond_all, label_all, lmask_d, x0_keep,
              jnp.asarray(plan.log_sigmas if plan.log_sigmas is not None
                          else sch.get_log_sigmas()),
              f32(plan.s_hat), f32(plan.churn_sigma), f32(plan.s_down),
              f32(plan.s_up), f32(plan.t_next), jnp.float32(cfg.cfg_scale))
    if (control is not None or extra_channels is not None
            or cond_steps is not None):
        hint_d = strength_d = extra_d = None
        if control is not None:
            hint, strength = control
            hint_d = _nhwc(hint)
            strength_d = jnp.float32(strength)
            if mesh is not None:
                hint_d = put(hint_d)  # batch-1: replicated
        if extra_channels is not None:
            extra_d = _nhwc(extra_channels)
            if mesh is not None:
                extra_d = put(extra_d)
        consts = consts + (hint_d, strength_d, extra_d)
        if cond_steps is not None:
            consts = consts + (jnp.asarray(cond_steps, jnp.int32),)

    sigmas0 = jnp.float32(plan.sigmas[0])
    # flow models: the input latent is interpolated toward the noise
    # (x = (1-sigma0) x0 + sigma0 n); None keeps the VE path's jaxpr
    xscale0 = (jnp.float32(1.0 - float(plan.sigmas[0]))
               if getattr(unet_p, "flow", False) and cfg.noise_add else None)
    # Guidance option errors follow the library convention
    # (MlisError E_OPT_VALUE, reference src/mlimgsynth_options_set.c.h);
    # the session pre-validates (api._guidance_checks) but run_sampler is
    # public API, so direct callers get the same clean errors.  Lazy
    # import: api imports this module at load time.
    from ..api import MlisError
    slg = None
    if cfg.slg_scale > 0:
        if not getattr(unet_p, "flow", False):
            raise MlisError(
                MlisError.E_OPT_VALUE,
                "skip-layer guidance requires a DiT model (SD3/SD3.5/Flux)")
        depth = (getattr(unet_p, "depth", 0)
                 or getattr(unet_p, "depth_double", 0)
                 + getattr(unet_p, "depth_single", 0))
        layers = tuple(sorted(int(v) for v in cfg.slg_layers))
        if not layers or min(layers) < 0 or max(layers) >= depth:
            raise MlisError(MlisError.E_OPT_VALUE,
                            f"slg layers out of range for depth "
                            f"{depth}: {layers}")
        if cfg.slg_end <= cfg.slg_start:
            raise MlisError(MlisError.E_OPT_VALUE,
                            "slg window is empty (slg_end <= slg_start)")
        if deepcache:
            raise MlisError(MlisError.E_OPT_VALUE,
                            "slg: unsupported with deepcache")
        i0 = int(round(cfg.slg_start * plan.n_step))
        i1 = max(int(round(cfg.slg_end * plan.n_step)), i0 + 1)
        slg = (float(cfg.slg_scale), layers, i0, i1)
    pag = None
    if cfg.pag_scale > 0:
        if getattr(unet_p, "flow", False) or not getattr(unet_p, "attn_res",
                                                         ()):
            raise MlisError(
                MlisError.E_OPT_VALUE,
                "perturbed-attention guidance requires an SD-UNet model")
        if deepcache:
            raise MlisError(MlisError.E_OPT_VALUE,
                            "pag: unsupported with deepcache")
        if cfg.pag_end <= cfg.pag_start:
            raise MlisError(MlisError.E_OPT_VALUE,
                            "pag window is empty (pag_end <= pag_start)")
        i0 = int(round(cfg.pag_start * plan.n_step))
        i1 = max(int(round(cfg.pag_end * plan.n_step)), i0 + 1)
        pag = (float(cfg.pag_scale), i0, i1)
    kw = dict(method=method, unet_p=unet_p, use_cfg=use_cfg,
              use_mask=use_mask, dtype=dtype, deepcache=deepcache,
              dc_warm=(max(1, plan.n_step // 10) if deepcache else 0),
              tiling=bool(tiling),
              cfg_rescale=(float(cfg.cfg_rescale) if use_cfg else 0.0),
              freeu=(tuple(float(v) for v in freeu) if freeu else None),
              slg=slg, pag=pag)
    kw_loop = dict(kw)
    decode_params = None
    if decode is not None and step_observer is None:
        # fused decode works on BOTH paths: inside _loop_jit, or riding
        # the final chunk of the stepwise/cancellable path
        kind, decode_params, vae_p = decode
        kw_loop.update(decode_kind=kind, vae_p=vae_p)
    else:
        decode = None
    if encode is not None:
        clip_p, clip_skip, norm_flag = enc_static
        kw_loop.update(clip_p=clip_p, clip_skip=clip_skip, norm=norm_flag,
                       clip2_p=enc_static2)

    if step_callback is None and step_observer is None and preview is None:
        if os.environ.get("MLIS_MEM_ANALYSIS"):
            # Compiled-executable memory analysis: the AOT path reports
            # the executable's argument/temp footprint (a cache hit after
            # the first compile, so this is cheap).
            global LAST_MEMORY_ANALYSIS
            try:
                ma = _loop_jit.lower(params, x, consts, noise0, churn, anc,
                                     sigmas0, decode_params, enc_args,
                                     xscale0,
                                     **kw_loop).compile().memory_analysis()
                LAST_MEMORY_ANALYSIS = {
                    "argument_bytes": ma.argument_size_in_bytes,
                    "output_bytes": ma.output_size_in_bytes,
                    "temp_bytes": ma.temp_size_in_bytes,
                    "peak_estimate_bytes": (ma.argument_size_in_bytes +
                                            ma.output_size_in_bytes +
                                            ma.temp_size_in_bytes),
                }
            except Exception:  # analysis is informational, never fatal
                LAST_MEMORY_ANALYSIS = None
        out = _loop_jit(params, x, consts, noise0, churn, anc, sigmas0,
                        decode_params, enc_args, xscale0, **kw_loop)
        if decode is not None or encode is not None:
            parts = out if isinstance(out, tuple) else (out,)
            xl = parts[0]
            img = parts[1] if decode is not None else None
            cond_dev = parts[-2] if encode is not None else None
            lab_dev = parts[-1] if encode is not None else None
            # each fetch is a host round-trip; skip the latent when the
            # caller doesn't need it (want_latent=False); the fused-encode
            # conditioning stays a LAZY device array (fetched only if the
            # caller ever reads it)
            lat = (np.asarray(xl, np.float32).transpose(0, 3, 1, 2)
                   if want_latent else None)
            res = [lat]
            if decode is not None:
                res.append(np.asarray(img))
            if encode is not None:
                res.append((cond_dev, lab_dev))
            return tuple(res) if len(res) > 1 else res[0]
        x = out
    else:
        carry = _init_jit(x, noise0, sigmas0, lmask_d, x0_keep, xscale0,
                          method=method, use_mask=use_mask)
        if deepcache:
            if enc_args is not None:
                # context token count: fused-encode flux carries the t5
                # rows at enc_args[4]; CLIP specs take the token rows
                s_ctx = (enc_args[4].shape[1]
                         if getattr(unet_p, "flux", False)
                         else enc_args[1].shape[1])
            else:
                s_ctx = cond_all.shape[1]
            carry = carry + (_dc_cache0(x, use_cfg, unet_p, dtype,
                                        s_ctx=s_ctx),)
        chunk = max(1, int(chunk_size if chunk_size is not None else
                           os.environ.get("MLIS_PROGRESS_CHUNK", "1")))
        if step_observer is not None:
            chunk = 1  # observers need every step
        pv_kind = pv_params = pv_vae_p = pv_observer = None
        if preview is not None:
            pv_kind, pv_params, pv_vae_p, pv_observer = preview
        i = 0
        img_u8 = None
        cond_dev = lab_dev = None
        enc_first = enc_args     # text encode rides the FIRST chunk
        while i < plan.n_step:
            k = min(chunk, plan.n_step - i)
            final = decode is not None and i + k == plan.n_step
            frame = None         # this chunk's fused preview/decode image
            if enc_first is not None:
                kwf = dict(kw, clip_p=kw_loop.get("clip_p"),
                           clip_skip=kw_loop.get("clip_skip", 0),
                           norm=kw_loop.get("norm", True),
                           clip2_p=kw_loop.get("clip2_p"))
                dparams = None
                if final:
                    kwf.update(decode_kind=kw_loop["decode_kind"],
                               vae_p=kw_loop["vae_p"])
                    dparams = decode_params
                elif pv_kind is not None:
                    kwf.update(decode_kind=pv_kind, vae_p=pv_vae_p)
                    dparams = pv_params
                out = _chunk_jit(params, carry, jnp.int32(i),
                                 churn[i:i + k], anc[i:i + k], consts,
                                 dparams, enc_first, **kwf)
                if final or pv_kind is not None:
                    carry, frame, cond_dev, lab_dev = out
                else:
                    carry, cond_dev, lab_dev = out
                if final:
                    img_u8 = frame
                # subsequent chunks take the device-resident conditioning
                consts = (cond_dev,
                          lab_dev if lab_dev is not None else consts[1]) \
                    + consts[2:]
                enc_first = None
            elif final:  # decode rides the last chunk's dispatch
                carry, img_u8 = _chunk_jit(
                    params, carry, jnp.int32(i), churn[i:i + k],
                    anc[i:i + k], consts, decode_params,
                    **dict(kw, decode_kind=kw_loop["decode_kind"],
                           vae_p=kw_loop["vae_p"]))
                frame = img_u8
            elif pv_kind is not None:
                # preview decode rides every chunk's dispatch
                carry, frame = _chunk_jit(
                    params, carry, jnp.int32(i), churn[i:i + k],
                    anc[i:i + k], consts, pv_params,
                    **dict(kw, decode_kind=pv_kind, vae_p=pv_vae_p))
            elif k == 1:
                carry = _step_jit(params, carry, jnp.int32(i), churn[i],
                                  anc[i], consts, **kw)
            else:
                carry = _chunk_jit(params, carry, jnp.int32(i),
                                   churn[i:i + k], anc[i:i + k], consts,
                                   **kw)
            i += k
            if pv_observer is not None and frame is not None:
                pv_observer(i, np.asarray(frame))
            if step_observer is not None:
                step_observer(i, np.asarray(
                    carry[0], np.float32).transpose(0, 3, 1, 2))
            if step_callback is not None and step_callback(i, plan.n_step):
                break
        x = carry[0]
        if decode is not None or encode is not None:
            lat = (np.asarray(x, np.float32).transpose(0, 3, 1, 2)
                   if want_latent else None)
            res = [lat]
            if decode is not None:
                # img_u8 is None when the callback aborted before the end
                res.append(np.asarray(img_u8) if img_u8 is not None
                           else None)
            if encode is not None:
                res.append((cond_dev, lab_dev))
            return tuple(res)
    return np.asarray(x, np.float32).transpose(0, 3, 1, 2)
