"""Per-stage device timing: isolates CLIP / denoise-loop / single-NFE / VAE
costs to target optimization.  Run on the GPU (no env overrides)."""
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    import jax
    import jax.numpy as jnp
    from mlimgsynth_tpu.models import blocks as B
    from mlimgsynth_tpu.models import clip as C
    from mlimgsynth_tpu.models import unet as U
    from mlimgsynth_tpu.models import vae as V
    from mlimgsynth_tpu.rng import RngPhilox
    from mlimgsynth_tpu.sampling.sampler import (SamplerConfig, make_plan,
                                                 run_sampler)
    from mlimgsynth_tpu.api import _clip_jit, _vae_decode_jit
    from mlimgsynth_tpu import tokenizer as tok
    from mlimgsynth_tpu.utils.compcache import enable
    from bench import synth_params

    enable()
    which = sys.argv[1] if len(sys.argv) > 1 else "sd15"
    if which == "sdxl":
        size = 1024
        unet_p, vae_p = U.UNET_SDXL, V.VAE_SDXL
    else:
        size = 512
        unet_p, vae_p = U.UNET_SD1, V.VAE_SD1
    clip_p = C.CLIP_VIT_L_14
    lat = size // 8
    dtype = jnp.bfloat16

    def timeit(name, fn, n=5):
        def run_once():
            r = fn()
            # force a host fetch of one leaf to measure true completion
            leaf = jax.tree_util.tree_leaves(r)[0]
            np.asarray(leaf).ravel()[0]
        run_once()  # compile
        ts = []
        for _ in range(n):
            t0 = time.time()
            run_once()
            ts.append(time.time() - t0)
        print(f"{name:24s} {min(ts)*1000:8.1f} ms", flush=True)
        return min(ts)

    spec_u = B.trace_spec(
        lambda ctx, x, t, c: U.unet_apply(
            ctx, x, t, c,
            jnp.zeros((1, unet_p.ch_adm_in)) if unet_p.ch_adm_in else None,
            unet_p),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, unet_p.n_ctx)))
    up = synth_params(spec_u, 0)
    spec_v = B.trace_spec(lambda ctx, x: V.vae_decode_apply(ctx, x, vae_p),
                          jnp.zeros((1, 8, 8, 4)))
    vp = synth_params(spec_v, 1)
    spec_c = B.trace_spec(lambda ctx, t: C.clip_text_apply(ctx, t, clip_p),
                          jnp.zeros((1, 77), jnp.int32))
    cp = synth_params(spec_c, 2)

    toks = np.asarray([tok.wrap_tokens(clip_p, tok.tokenize("a cat"))],
                      np.int32)
    timeit("clip encode", lambda: _clip_jit(
        cp, toks, np.asarray([3], np.int32), clip_p=clip_p, submodel="clip",
        clip_skip=1, norm=True, want_feat=False, dtype=dtype))

    # single CFG-batched UNet denoise eval
    import functools

    @functools.partial(jax.jit, static_argnames=())
    def one_nfe(params, x, cond):
        ctx = B.Ctx(params, dtype=dtype)
        label = (jnp.zeros((2, unet_p.ch_adm_in)) if unet_p.ch_adm_in
                 else None)
        return U.denoise(ctx, x, jnp.float32(10.0), jnp.full((2,), 900.0),
                         cond, label, unet_p)

    x2 = jnp.zeros((2, lat, lat, 4))
    c2 = jnp.zeros((2, 77, unet_p.n_ctx), dtype)
    t_nfe = timeit("unet 1 step (CFG batch2)", lambda: one_nfe(up, x2, c2))

    # full 20-step loop
    cfg = SamplerConfig(method="euler", n_step=20, cfg_scale=7.0)
    plan = make_plan(cfg, (1, 4, lat, lat), RngPhilox(seed=0),
                     nfe_per_dxdt=2)
    cond = np.zeros((1, 77, unet_p.n_ctx), np.float32)
    ncond = np.ones_like(cond) * 0.1
    label = np.zeros((1, max(1, unet_p.ch_adm_in)), np.float32) \
        if unet_p.ch_adm_in else None
    t_loop = timeit("denoise loop (20 steps)", lambda: run_sampler(
        up, np.zeros((1, 4, lat, lat), np.float32), plan, cond, ncond,
        label, label, None, cfg, unet_p, dtype=dtype), n=3)

    latv = np.zeros((1, lat, lat, 4), np.float32)
    t_vae = timeit("vae decode", lambda: _vae_decode_jit(
        vp, latv, vae_p=vae_p, dtype=dtype), n=3)

    print(f"\nloop-20/step: {t_loop/20*1000:.1f} ms; "
          f"1-step jit: {t_nfe*1000:.1f} ms; "
          f"loop overhead vs 20x1step: {(t_loop-20*t_nfe)*1000:+.1f} ms")


if __name__ == "__main__":
    main()
