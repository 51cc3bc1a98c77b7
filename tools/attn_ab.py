#!/usr/bin/env python3
"""Times the attention routes and the quantised linears on the GPU.

    python tools/attn_ab.py [--e2e] [--reps N]

For every attention shape that chip_smoke.py checks, the median time of
cuDNN's fused kernel (``jax.nn.dot_product_attention(implementation=
"cudnn")``, where cuDNN takes the shape) and of ``attention_xla``, in bf16.
Then ``q8_dot`` and ``q4_dot`` against a bf16 ``jnp.dot`` at one Flux linear
shape, and whether XLA fused the dequantisation into the GEMM (no weight-
sized bf16 buffer among the compiled program's temporaries).  ``--e2e``
times SD1.5 512px 20-step txt2img under the shape rule and with every
attention call forced onto XLA.  Prints the card's name and power limit; refuses to run
off the GPU.
"""
import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import chip_smoke  # noqa: E402


def median_time(fn, *args, reps=20):
    import jax
    jax.block_until_ready(fn(*args))            # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def attention_ab(reps):
    import jax
    import jax.numpy as jnp
    from mlimgsynth_tpu.ops.attention import attention_xla
    for name, (b, sq, sk, h, d) in chip_smoke.ATTN_SHAPES:
        ks = jax.random.split(jax.random.PRNGKey(0), 3)
        q = jax.random.normal(ks[0], (b, sq, h, d), jnp.bfloat16)
        k = jax.random.normal(ks[1], (b, sk, h, d), jnp.bfloat16)
        v = jax.random.normal(ks[2], (b, sk, h, d), jnp.bfloat16)
        t_x = median_time(jax.jit(attention_xla), q, k, v, reps=reps)
        try:
            t_c = median_time(jax.jit(
                lambda q, k, v: jax.nn.dot_product_attention(
                    q, k, v, implementation="cudnn")), q, k, v, reps=reps)
            c = f"{t_c * 1e3:.3f} ms"
            win = "cudnn" if t_c < t_x else "xla"
        except Exception as e:  # noqa: BLE001 - cuDNN refuses the shape
            c = f"refused ({type(e).__name__}: {str(e)[:80]})"
            win = "xla"
        print(f"[attn] {name} B{b} Sq{sq} Sk{sk} H{h} D{d}: cudnn {c}, "
              f"xla {t_x * 1e3:.3f} ms -> {win}", flush=True)


def qlinear_ab(reps):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mlimgsynth_tpu.ops import q4_matmul as q4
    from mlimgsynth_tpu.ops import q8_matmul as q8
    m, k, n = chip_smoke.QLIN_SHAPE
    rng = np.random.default_rng(0)
    w = rng.standard_normal((k, n), dtype=np.float32) / np.sqrt(k)
    x = jax.random.normal(jax.random.PRNGKey(0), (m, k), jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    t_b = median_time(jax.jit(jnp.dot), x, wb, reps=reps)
    print(f"[qlin] bf16 jnp.dot M{m} K{k} N{n}: {t_b * 1e3:.3f} ms "
          f"({2 * m * k * n / t_b / 1e12:.1f} TFLOP/s)", flush=True)
    for tag, (wq, s), fn in (("q8", q8.quantize_weight(w), q8.q8_dot),
                             ("q4", q4.quantize_weight_q4(w), q4.q4_dot)):
        wq, s = jnp.asarray(wq), jnp.asarray(s)
        f = jax.jit(fn)
        t = median_time(f, x, wq, s, reps=reps)
        comp = f.lower(x, wq, s).compile()
        temp = comp.memory_analysis().temp_size_in_bytes
        fused = temp < k * n * 2        # no bf16 copy of the whole weight
        print(f"[qlin] {tag}_dot: {t * 1e3:.3f} ms ({t / t_b:.2f}x bf16); "
              f"temp {temp} bytes vs bf16 weight {k * n * 2}: dequant "
              f"fused into the GEMM: {fused}", flush=True)


def e2e_ab():
    from mlimgsynth_tpu import testing
    from mlimgsynth_tpu.api import _model_types
    from repro_check import forced_route
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    paths = testing.write_synthetic_model(chip_smoke.WORK, "sd1",
                                          _model_types()["sd1"])
    for route in ("rule", "xla", "xla", "rule"):
        with forced_route(route):
            s = chip_smoke.make_session(paths, "sd1", 512, 20, 7.0, 0)
            s.generate()
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                s.generate()
                ts.append(time.perf_counter() - t0)
            del s
        print(f"[e2e] SD1.5 512px 20 steps, attention {route}: "
              f"{statistics.median(ts):.4f} s/image (median of 3: "
              f"{', '.join(f'{t:.4f}' for t in ts)})", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    chip_smoke.phase_device()
    from mlimgsynth_tpu.utils.compcache import enable
    enable()
    attention_ab(args.reps)
    qlinear_ab(args.reps)
    if args.e2e:
        e2e_ab()
    return 0


if __name__ == "__main__":
    sys.exit(main())
