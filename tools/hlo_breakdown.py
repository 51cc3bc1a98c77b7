"""Static FLOPs breakdown of one CFG-batched UNet denoise step.

Parses the (unoptimized, backend-independent) lowered HLO of a single step
and inventories every convolution / dot with its shapes and FLOPs, grouped
by operator class.  Use to attribute the step's compute between convs,
linears/projections, and attention matmuls — the execution-side counterpart
is tools/step_bench.py with MLIS_ABLATE.  Divide by the card's measured
peak for a time floor.

Runs entirely on host (no device dispatch):
  JAX_PLATFORMS=cpu python tools/hlo_breakdown.py sdxl
"""
import os
import re
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

def shapes_of(line):
    """All tensor<...> shapes in a StableHLO line, in textual order."""
    out = []
    for m in re.findall(r"tensor<([\dx]+)x[a-z]\w*>", line):
        out.append(tuple(int(x) for x in m.split("x")))
    return out


def conv_flops(line):
    # (lhs NHWC, rhs HWIO) -> out; types listed at the end of the line
    shapes = shapes_of(line)
    lhs, rhs, out = shapes[-3], shapes[-2], shapes[-1]
    kh, kw, cin = rhs[0], rhs[1], rhs[2]
    m = re.search(r"batch_group_count\s*=\s*(\d+)", line)
    fgc = re.search(r"feature_group_count\s*=\s*(\d+)", line)
    g = int(fgc.group(1)) if fgc else 1
    return 2 * int(np.prod(out)) * cin * kh * kw // max(g, 1) * max(g, 1) \
        // max(g, 1)


def dot_flops(line):
    shapes = shapes_of(line)
    lhs, rhs, out = shapes[-3], shapes[-2], shapes[-1]
    m = re.search(r"contracting_dims\s*=\s*\[([\d,\s]*)\]", line)
    cdims = ([int(x) for x in m.group(1).split(",") if x.strip()]
             if m else [len(lhs) - 1])
    k = int(np.prod([lhs[d] for d in cdims]))
    return 2 * int(np.prod(out)) * k


def classify(line):
    if "convolution" in line:
        shapes = shapes_of(line)
        rhs = shapes[-2]
        return f"conv{rhs[0]}x{rhs[1]}"
    # dots: attention matmuls have both operands activation-shaped (>=3D
    # batch dims); projections contract a weight (2-3D with a weight side)
    shapes = shapes_of(line)
    lhs, rhs = shapes[-3], shapes[-2]
    m = re.search(r"batching_dims\s*=\s*\[([\d,\s]*)\]", line)
    nbatch = len([x for x in m.group(1).split(",") if x.strip()]) if m else 0
    if nbatch >= 1 and len(lhs) >= 3 and len(rhs) >= 3:
        return "attn-matmul"
    return "linear"


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from mlimgsynth_tpu.models import blocks as B
    from mlimgsynth_tpu.models import unet as U

    which = sys.argv[1] if len(sys.argv) > 1 else "sd15"
    if which.startswith("flux"):
        # one flux NFE at the 1024px shape (4096 img + 256 txt tokens,
        # no CFG batch — schnell/dev run 1 eval/step)
        from mlimgsynth_tpu.models import flux as FX
        PF, res, s_t5 = (FX.FLUX_DEV if which == "flux-dev"
                         else FX.FLUX_SCHNELL), 128, 256
        spec = B.trace_spec(
            lambda ctx, x, t, c, y: FX.flux_apply(
                ctx, x, t, c, y, PF,
                guidance=(jnp.zeros((1,)) if PF.guidance_embed else None)),
            jnp.zeros((1, 8, 8, PF.n_ch_in // 4)), jnp.zeros((1,)),
            jnp.zeros((1, s_t5, PF.d_ctx_in)), jnp.zeros((1, PF.d_pooled)))
        params = {k: jax.ShapeDtypeStruct(ps.shape, ps.dtype)
                  for k, ps in spec.items()}

        def stepf(params, x, t, c, y):
            ctx = B.Ctx(params, dtype=jnp.bfloat16)
            return FX.flux_apply(
                ctx, x, t, c, y, PF,
                guidance=(t * 0.0035 if PF.guidance_embed else None))

        txt = jax.jit(stepf).lower(
            params,
            jax.ShapeDtypeStruct((1, res, res, PF.n_ch_in // 4),
                                 np.float32),
            jax.ShapeDtypeStruct((1,), np.float32),
            jax.ShapeDtypeStruct((1, s_t5, PF.d_ctx_in), np.float32),
            jax.ShapeDtypeStruct((1, PF.d_pooled), np.float32)).as_text()
        return analyze(txt, which)
    if which.startswith("sd3"):
        # MMDiT step at the 1024px shape (4096 latent + 154 ctx tokens)
        from mlimgsynth_tpu.models import mmdit as MM
        P3 = {"sd3": MM.MMDIT_SD3_MEDIUM,
              "sd35-medium": MM.MMDIT_SD35_MEDIUM,
              "sd35-large": MM.MMDIT_SD35_LARGE}[which]
        res, n, s_ctx = 128, 2, 154
        spec = B.trace_spec(
            lambda ctx, x, t, c, y: MM.mmdit_apply(ctx, x, t, c, y, P3),
            jnp.zeros((1, 8, 8, P3.n_ch_in)), jnp.zeros((1,)),
            jnp.zeros((1, s_ctx, P3.d_ctx_in)),
            jnp.zeros((1, P3.d_pooled)))
        params = {k: jax.ShapeDtypeStruct(ps.shape, ps.dtype)
                  for k, ps in spec.items()}

        def step3(params, x, t, c, y):
            ctx = B.Ctx(params, dtype=jnp.bfloat16)
            return MM.mmdit_apply(ctx, x, t, c, y, P3)

        txt = jax.jit(step3).lower(
            params,
            jax.ShapeDtypeStruct((n, res, res, P3.n_ch_in), np.float32),
            jax.ShapeDtypeStruct((n,), np.float32),
            jax.ShapeDtypeStruct((n, s_ctx, P3.d_ctx_in), np.float32),
            jax.ShapeDtypeStruct((n, P3.d_pooled), np.float32)).as_text()
        return analyze(txt, which)
    if which == "sdxl":
        P, res, n = U.UNET_SDXL, 128, 2
    elif which == "sd2":
        P, res, n = U.UNET_SD2, 96, 2
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
    txt = jax.jit(step).lower(*args).as_text()
    return analyze(txt, which)


def analyze(txt, which):
    groups = defaultdict(lambda: [0, 0])       # class -> [flops, count]
    biggest = []
    for line in txt.splitlines():
        ls = line.strip()
        if "stablehlo.convolution" in ls:
            f = conv_flops(ls)
        elif "stablehlo.dot_general" in ls or "stablehlo.dot " in ls:
            f = dot_flops(ls)
        else:
            continue
        cls = classify(ls)
        groups[cls][0] += f
        groups[cls][1] += 1
        biggest.append((f, cls, ls[:140]))

    total = sum(v[0] for v in groups.values())
    print(f"== {which}: CFG step — "
          f"total {total / 1e12:.3f} TFLOP ==")
    for cls, (f, c) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"{cls:12s} {f / 1e12:8.3f} TFLOP  ({100 * f / total:5.1f}%)  "
              f"n={c:4d}")
    print("-- top 12 ops --")
    for f, cls, l in sorted(biggest, key=lambda x: -x[0])[:12]:
        print(f"{f / 1e9:9.2f} GFLOP [{cls}] {l}")


if __name__ == "__main__":
    main()
