"""Micro-benchmark: one CFG-batched UNet denoise step, scanned on device.

Times a lax.scan of N identical denoise steps in ONE dispatch and reports
ms/step (per-dispatch latency amortizes over the scan; the result is
fetched to host so the timing covers completion, not just dispatch).

Variants via env (read at trace time):
  MLIS_STEP_MODEL=sd15|sdxl|sd15b8   model/batch config

Usage: python tools/step_bench.py [n_scan_steps]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp
    from mlimgsynth_tpu.utils.compcache import enable as _cc
    _cc()
    from mlimgsynth_tpu.models import blocks as B
    from mlimgsynth_tpu.models import unet as U
    from bench import synth_params

    n_scan = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    which = os.environ.get("MLIS_STEP_MODEL", "sd15")
    if which == "sd15loop":
        return loop_bench(n_scan)
    if which in ("sd3", "sd35-medium", "sd35-large"):
        return mmdit_step_bench(n_scan, which)
    if which.startswith("flux"):
        return flux_step_bench(n_scan, guidance=which == "flux-dev")
    if which.startswith("sdxl"):
        P, res, n = U.UNET_SDXL, 128, 2
    elif which == "sd21":
        P, res, n = U.UNET_SD2, 96, 2    # 768px shape (S=2304 at L1)
    elif which == "sd15b8":
        P, res, n = U.UNET_SD1, 64, 16   # batch-8 images, CFG-doubled
    else:
        P, res, n = U.UNET_SD1, 64, 2    # batch-1, CFG-doubled
    label = (jnp.zeros((1, P.ch_adm_in)) if P.ch_adm_in else None)
    spec = B.trace_spec(
        lambda ctx, x, t, c: U.unet_apply(ctx, x, t, c, label, P),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, P.n_ctx)))
    params = synth_params(spec, 0)
    lab = (jnp.zeros((n, P.ch_adm_in), jnp.float32) if P.ch_adm_in else None)

    def loop(params, x, t, c):
        ctx = B.Ctx(params, dtype=jnp.bfloat16)

        def body(x, _):
            d = U.denoise(ctx, x, jnp.float32(14.6), t, c, lab, P)
            # keep the carry well-scaled so the scan can't be folded away
            return x + 0.01 * d.astype(x.dtype), None

        x, _ = jax.lax.scan(body, x, None, length=n_scan)
        return x

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((n, res, res, 4)).astype(np.float32))
    t = jnp.full((n,), 500.0, jnp.float32)
    c = jnp.asarray(rng.standard_normal((n, 77, P.n_ctx)).astype(np.float32)
                    * 0.3)
    fn = jax.jit(loop)
    t0 = time.time()
    out = np.asarray(fn(params, x, t, c))   # fetch = true completion
    print(f"compile+first: {time.time() - t0:.1f}s "
          f"(finite={np.isfinite(out).all()})", flush=True)
    times = []
    for i in range(4):
        t0 = time.time()
        out = np.asarray(fn(params, x, t, c))
        times.append(time.time() - t0)
    best = min(times)
    cfg = {k: os.environ.get(k, "") for k in
           ("MLIS_ABLATE", "MLIS_STEP_MODEL")}
    print(f"RESULT {which} n={n} res={res} steps={n_scan}: "
          f"{best / n_scan * 1000:.2f} ms/step (total {best:.3f}s, "
          f"runs {['%.3f' % t for t in times]}) env={cfg}", flush=True)


def flux_step_bench(n_scan, guidance=False):
    """One Flux.1 12B int8 evaluation, scanned (1024px shape: 4096 packed
    latent + 256 T5 tokens = S 4352; no CFG batch — schnell is distilled,
    dev rides embedded guidance).  MLIS_ABLATE=attn splits attention out."""
    import jax
    import jax.numpy as jnp
    from mlimgsynth_tpu.models import blocks as B
    from mlimgsynth_tpu.models import flux as FX
    from bench import synth_q8_params

    P = FX.FLUX_DEV if guidance else FX.FLUX_SCHNELL
    n, res, s_t5 = 1, 128, 256
    g = jnp.full((1,), 3.5) if guidance else None
    spec = B.trace_spec(
        lambda ctx, x, t, c, y: FX.flux_apply(ctx, x, t, c, y, P,
                                              guidance=g),
        jnp.zeros((1, 8, 8, P.n_ch_in // 4)), jnp.zeros((1,)),
        jnp.zeros((1, s_t5, P.d_ctx_in)), jnp.zeros((1, P.d_pooled)))
    params = synth_q8_params(spec, 0)

    def loop(params, x, t, c, y):
        ctx = B.Ctx(params, dtype=jnp.bfloat16)

        def body(x, _):
            d = FX.flux_apply(ctx, x, t, c, y, P, guidance=g)
            return x + 0.01 * d.astype(x.dtype), None

        x, _ = jax.lax.scan(body, x, None, length=n_scan)
        return x

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((n, res, res, P.n_ch_in // 4))
                    .astype(np.float32) * 0.5, jnp.bfloat16)
    t = jnp.full((n,), 500.0, jnp.float32)
    c = jnp.asarray(rng.standard_normal((n, s_t5, P.d_ctx_in))
                    .astype(np.float32) * 0.3, jnp.bfloat16)
    y = jnp.asarray(rng.standard_normal((n, P.d_pooled))
                    .astype(np.float32) * 0.3)
    fn = jax.jit(loop)
    t0 = time.time()
    out = np.asarray(fn(params, x, t, c, y))
    print(f"compile+first: {time.time() - t0:.1f}s "
          f"(finite={np.isfinite(out).all()})", flush=True)
    times = []
    for i in range(4):
        t0 = time.time()
        out = np.asarray(fn(params, x, t, c, y))
        times.append(time.time() - t0)
    best = min(times)
    which = "flux-dev" if guidance else "flux"
    print(f"RESULT {which} n={n} res={res} steps={n_scan}: "
          f"{best / n_scan * 1000:.2f} ms/step (total {best:.3f}s, "
          f"runs {['%.3f' % t for t in times]}) "
          f"ablate={os.environ.get('MLIS_ABLATE', '')}", flush=True)


def mmdit_step_bench(n_scan, which="sd3"):
    """One CFG-batched MMDiT evaluation, scanned (1024px shape: 4096
    latent + 154 context tokens).  sd35-medium exercises the MMDiT-X
    dual-attention blocks; sd35-large the 8B qk-norm geometry (bf16
    here — the e2e config runs int8 weights).  MLIS_ABLATE=attn splits
    the joint-attention cost out like the UNet variant."""
    import jax
    import jax.numpy as jnp
    from mlimgsynth_tpu.models import blocks as B
    from mlimgsynth_tpu.models import mmdit as MM
    from bench import synth_params

    P = {"sd3": MM.MMDIT_SD3_MEDIUM,
         "sd35-medium": MM.MMDIT_SD35_MEDIUM,
         "sd35-large": MM.MMDIT_SD35_LARGE}[which]
    n, res, s_ctx = 2, 128, 154
    if which == "sd35-large":
        # the e2e config (bench.py) runs int8 weights — measure the same
        # execution mode here
        from bench import synth_q8_params
    spec = B.trace_spec(
        lambda ctx, x, t, c, y: MM.mmdit_apply(ctx, x, t, c, y, P),
        jnp.zeros((1, 8, 8, P.n_ch_in)), jnp.zeros((1,)),
        jnp.zeros((1, s_ctx, P.d_ctx_in)), jnp.zeros((1, P.d_pooled)))
    if which == "sd35-large":
        params = synth_q8_params(spec, 0)
    else:
        params = synth_params(spec, 0)

    def loop(params, x, t, c, y):
        ctx = B.Ctx(params, dtype=jnp.bfloat16)

        def body(x, _):
            d = MM.mmdit_apply(ctx, x, t, c, y, P)
            return x + 0.01 * d.astype(x.dtype), None

        x, _ = jax.lax.scan(body, x, None, length=n_scan)
        return x

    rng = np.random.default_rng(0)
    # mmdit consumes the UNPACKED 16-ch latent (the 2x2 patchify is the
    # model's own first op) — only flux pre-packs to n_ch_in // 4
    x = jnp.asarray(rng.standard_normal((n, res, res, P.n_ch_in))
                    .astype(np.float32) * 0.5, jnp.bfloat16)
    t = jnp.full((n,), 500.0, jnp.float32)
    c = jnp.asarray(rng.standard_normal((n, s_ctx, P.d_ctx_in))
                    .astype(np.float32) * 0.3)
    y = jnp.asarray(rng.standard_normal((n, P.d_pooled))
                    .astype(np.float32) * 0.3)
    fn = jax.jit(loop)
    t0 = time.time()
    out = np.asarray(fn(params, x, t, c, y))
    print(f"compile+first: {time.time() - t0:.1f}s "
          f"(finite={np.isfinite(out).all()})", flush=True)
    times = []
    for i in range(4):
        t0 = time.time()
        out = np.asarray(fn(params, x, t, c, y))
        times.append(time.time() - t0)
    best = min(times)
    print(f"RESULT {which} n={n} res={res} steps={n_scan}: "
          f"{best / n_scan * 1000:.2f} ms/step (total {best:.3f}s, "
          f"runs {['%.3f' % t for t in times]}) "
          f"ablate={os.environ.get('MLIS_ABLATE', '')}", flush=True)


def loop_bench(n_steps):
    """Time the REAL sampling loop (run_sampler: solver + CFG mixing +
    sigma_to_t + noise handling) to compare against the raw-step number."""
    import jax.numpy as jnp
    from mlimgsynth_tpu.models import blocks as B
    from mlimgsynth_tpu.models import unet as U
    from mlimgsynth_tpu.rng import RngPhilox
    from mlimgsynth_tpu.sampling.sampler import (SamplerConfig, make_plan,
                                                 run_sampler)
    from bench import synth_params

    P = U.UNET_SD1
    spec = B.trace_spec(
        lambda ctx, x, t, c: U.unet_apply(ctx, x, t, c, None, P),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, P.n_ctx)))
    params = synth_params(spec, 0)
    rng = np.random.default_rng(0)
    cond = rng.standard_normal((1, 77, P.n_ctx)).astype(np.float32) * 0.3
    uncond = np.zeros_like(cond)
    cfg = SamplerConfig(method="euler", n_step=n_steps, cfg_scale=7.0)

    def once(seed):
        plan = make_plan(cfg, (1, 4, 64, 64), RngPhilox(seed=seed),
                         nfe_per_dxdt=2)
        return run_sampler(params, np.zeros((1, 4, 64, 64), np.float32),
                           plan, cond, uncond, None, None, None, cfg, P,
                           dtype=jnp.bfloat16)

    t0 = time.time()
    out = once(42)
    print(f"compile+first: {time.time() - t0:.1f}s "
          f"(finite={np.isfinite(out).all()})", flush=True)
    times = []
    for i in range(4):
        t0 = time.time()
        once(42 + i)
        times.append(time.time() - t0)
    best = min(times)
    print(f"RESULT sd15loop steps={n_steps}: {best / n_steps * 1000:.2f} "
          f"ms/step (total {best:.3f}s incl. host plan+transfers, "
          f"runs {['%.3f' % t for t in times]})", flush=True)


if __name__ == "__main__":
    main()
