"""Optimized-HLO fusion census for one CFG UNet step.

AOT-compiles the step for the real backend and summarizes the optimized module: how many fusions touch each op family
(reduce = norms' statistics, convolution, dot, custom-call = cuDNN/cuBLAS or a kernel), and the
largest fusions by bytes.  Use to judge whether XLA already fuses the
normalization passes with their neighbors before hand-writing a kernel.

Usage: python tools/hlo_fusions.py [sd15|sdxl] [grep-regex]
"""
import os
import re
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp
    from mlimgsynth_tpu.utils.compcache import enable as _cc
    _cc()
    from mlimgsynth_tpu.models import blocks as B
    from mlimgsynth_tpu.models import unet as U

    which = sys.argv[1] if len(sys.argv) > 1 else "sd15"
    pat = sys.argv[2] if len(sys.argv) > 2 else None
    if which == "vae":
        # VAE decode census (VERDICT r2 item 2/8 decision data)
        from mlimgsynth_tpu.models import vae as V
        spec = B.trace_spec(
            lambda ctx, x: V.vae_decode_apply(ctx, x, V.VAE_SD1),
            jnp.zeros((1, 8, 8, 4)))
        params = {k: jax.ShapeDtypeStruct(ps.shape, ps.dtype)
                  for k, ps in spec.items()}

        def decode(params, x):
            ctx = B.Ctx(params, dtype=jnp.bfloat16)
            return V.vae_decode_apply(ctx, x, V.VAE_SD1)

        txt = jax.jit(decode).lower(
            params, jax.ShapeDtypeStruct((1, 64, 64, 4), np.float32)
        ).compile().as_text()
        _census(txt, pat)
        return
    if which == "sdxl":
        P, res, n = U.UNET_SDXL, 128, 2
    else:
        P, res, n = U.UNET_SD1, 64, 2

    tl = jnp.zeros((1, P.ch_adm_in)) if P.ch_adm_in else None
    spec = B.trace_spec(
        lambda ctx, x, t, c: U.unet_apply(ctx, x, t, c, tl, P),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, P.n_ctx)))
    params = {k: jax.ShapeDtypeStruct(ps.shape, ps.dtype)
              for k, ps in spec.items()}
    lab = (jax.ShapeDtypeStruct((n, P.ch_adm_in), np.float32)
           if P.ch_adm_in else None)

    def step(params, x, t, c, lab=None):
        ctx = B.Ctx(params, dtype=jnp.bfloat16)
        return U.unet_apply(ctx, x, t, c, lab, P)

    args = [params,
            jax.ShapeDtypeStruct((n, res, res, 4), np.float32),
            jax.ShapeDtypeStruct((n,), np.float32),
            jax.ShapeDtypeStruct((n, 77, P.n_ctx), np.float32)]
    if lab is not None:
        args.append(lab)
    txt = jax.jit(step).lower(*args).compile().as_text()
    _census(txt, pat)


def _census(txt, pat=None):
    print(f"optimized HLO: {len(txt.splitlines())} lines", flush=True)

    ops = Counter()
    for mline in re.finditer(r"= \S+ (\w[\w-]*)\(", txt):
        ops[mline.group(1)] += 1
    print("op census:", dict(ops.most_common(15)))

    # count fusion computations containing a reduce (norm statistics) and
    # what else lives in them
    fusions = re.findall(r"%fused_computation[^\n]*\{(?:[^{}]|\{[^{}]*\})*\}",
                         txt)
    n_red = sum(1 for f in fusions if "reduce(" in f or " reduce" in f)
    print(f"fusion computations: {len(fusions)}; containing reduce: {n_red}")

    if pat:
        for line in txt.splitlines():
            if re.search(pat, line):
                print(line.strip()[:200])


if __name__ == "__main__":
    main()
