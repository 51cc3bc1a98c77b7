"""Scanned VAE/TAE decode micro-bench: N decodes in ONE dispatch.

Isolates the decoder's on-device time from the per-dispatch latency the
e2e numbers include.  Compare against the static floor from the conv FLOPs
(VAE-SD1 512px: 2.48 TFLOP, tools/hlo_breakdown.py) over the card's peak.

Usage: [MLIS_DECODE=vae|tae|vaexl] python tools/decode_bench.py [n_scan]

Spatial-batch probe (VERDICT r3 item 2): MLIS_DECODE_BATCH=B and
MLIS_DECODE_LAT=L override the batch/latent size, e.g. B=4 L=32 covers the
same pixel count as the default B=1 L=64 — if the batched small-tile decode
is materially faster, batch-1 big-spatial implicit-GEMM inefficiency is
recoverable by device-side tile batching (with halo overhead on top).
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
    from mlimgsynth_tpu.models import tae as T
    from mlimgsynth_tpu.models import vae as V
    from bench import synth_params

    which = os.environ.get("MLIS_DECODE", "vae")
    n_scan = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    if which == "tae":
        apply_fn = lambda ctx, x: T.tae_decode_apply(ctx, x, T.TAE_SD1)
        lat = 64
    elif which == "vaexl":
        apply_fn = lambda ctx, x: V.vae_decode_apply(ctx, x, V.VAE_SDXL)
        lat = 128
    else:
        apply_fn = lambda ctx, x: V.vae_decode_apply(ctx, x, V.VAE_SD1)
        lat = 64

    spec = B.trace_spec(apply_fn, jnp.zeros((1, 8, 8, 4)))
    params = synth_params(spec, 0)

    def loop(params, x):
        ctx = B.Ctx(params, dtype=jnp.bfloat16)

        def body(x, _):
            img = apply_fn(ctx, x)
            # mix the image back into the latent so the scan can't fold
            down = img[:, ::8, ::8, :3]
            return x + 0.001 * jnp.pad(
                down, ((0, 0), (0, 0), (0, 0), (0, 1))).astype(x.dtype), None

        x, _ = jax.lax.scan(body, x, None, length=n_scan)
        return x

    bat = int(os.environ.get("MLIS_DECODE_BATCH", "1"))
    lat = int(os.environ.get("MLIS_DECODE_LAT", lat))
    rng = np.random.default_rng(0)
    x = jnp.asarray(
        rng.standard_normal((bat, lat, lat, 4)).astype(np.float32))
    fn = jax.jit(loop)
    t0 = time.time()
    out = np.asarray(fn(params, x))
    print(f"compile+first: {time.time() - t0:.1f}s "
          f"(finite={np.isfinite(out).all()})", flush=True)
    times = []
    for _ in range(4):
        t0 = time.time()
        np.asarray(fn(params, x))
        times.append(time.time() - t0)
    best = min(times)
    print(f"RESULT decode {which} b={bat} lat={lat} n_scan={n_scan}: "
          f"{best / n_scan * 1000:.2f} ms/decode (total {best:.3f}s, "
          f"runs {['%.3f' % t for t in times]})", flush=True)


if __name__ == "__main__":
    main()
