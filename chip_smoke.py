#!/usr/bin/env python3
"""Start-up proof on one NVIDIA GPU: the main path at full width, checked.

    python chip_smoke.py                       # SD1.5, the default phases
    python chip_smoke.py --family sdxl         # phase 3 for another family
    python chip_smoke.py --mesh4               # the four-card legs only
    python chip_smoke.py --mesh4 --family sd3  # one family's four-card legs

Default phases, in one process (a JAX process reserves most of the card,
so nothing here starts a second one):

1. device: JAX must report a GPU; prints its kind and ``nvidia-smi``'s name
   and power limit.  There is no CPU fallback.
2. kernels: attention at each model's real widths through the route the
   shape rule picks (cuDNN's fused kernel or XLA), and the int8/int4
   linears, against float32 references under "highest" matmul precision.
3. session: a seeded random SD1.5 checkpoint (CLIP ViT-L/14, the SD1 UNet,
   the VAE; fp16) written with the repo's safetensors writer, loaded
   through ``MLImgSynth``; txt2img 512x512, 20 Euler steps, cfg 7, twice
   with one seed; one UNet step in bf16 against float32.
4. server: the HTTP server on a free port answers three A1111 txt2img
   requests with 512x512 PNGs.

Any failed check exits non-zero.  The last line of standard output is one
JSON object naming the device.
"""
import argparse
import base64
import gc
import json
import os
import shutil
import struct
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".chip_smoke")

# --family -> (model type, image size, steps, cfg scale)
FAMILIES = {
    "sd1": ("sd1", 512, 20, 7.0),
    "sdxl": ("sdxl", 1024, 20, 7.0),
    "sd3": ("sd3", 1024, 20, 7.0),
    "flux-schnell": ("flux_schnell", 1024, 4, 1.0),
}

# Attention shapes (B, Sq, Sk, H, D) of the CFG batch at each model's bench
# size: SD1 level 0 self/cross, SDXL level 1 self/cross and level 2, SD3-medium joint
# (4096 latent + 154 text tokens), Flux joint (4096 + 256), the VAE
# mid-block at 512px and 1024px.
ATTN_SHAPES = [
    ("sd1 self", (2, 4096, 4096, 8, 40)),
    ("sd1 cross", (2, 4096, 77, 8, 40)),
    ("sdxl l1 self", (2, 4096, 4096, 10, 64)),
    ("sdxl l1 cross", (2, 4096, 77, 10, 64)),
    ("sdxl l2 self", (2, 1024, 1024, 20, 64)),
    ("sd3 joint", (2, 4250, 4250, 24, 64)),
    ("flux joint", (1, 4352, 4352, 24, 128)),
    ("vae 512", (1, 4096, 4096, 1, 512)),
    ("vae 1024", (1, 16384, 16384, 1, 512)),
]
# bf16 inputs and output against a float32 softmax: the output rounds to
# bf16 (2^-9 relative) and the probabilities enter the PV product in bf16,
# so the error is a few bf16 ulps of the largest output.
ATTN_TOL = 2e-2
# One Flux linear (M tokens, K, N): int8/int4 weights dequantised to bf16.
QLIN_SHAPE = (4608, 3072, 12288)
QLIN_TOL = 1e-2
# One denoiser step in bf16 against the same step in float32: relative L2
# error.  bf16 keeps 8 mantissa bits; rounding compounds over the ~70
# layers of the UNet, while a wrong kernel or layout gives errors of O(1).
STEP_TOL = 0.1


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def say(msg):
    print(msg, flush=True)


def nvidia_smi():
    """`name, power.limit` of every card, as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device(require_gpu=True):
    import jax
    devs = jax.devices()
    d = devs[0]
    say(f"[device] platform {d.platform}, kind {d.device_kind}, "
        f"count {len(devs)}")
    if require_gpu:
        check(d.platform == "gpu",
              f"JAX found no GPU (platform '{d.platform}')")
    say(f"[device] nvidia-smi: {nvidia_smi()}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _rand(key, shape, dtype, scale=1.0):
    import jax
    return (jax.random.normal(key, shape) * scale).astype(dtype)


def check_attention(name, shape, seed=0):
    """Routed attention in bf16 vs attention_xla in float32 ("highest")."""
    import jax
    import jax.numpy as jnp
    from mlimgsynth_tpu.ops import attention as A
    b, sq, sk, h, d = shape
    kq, kk, kv = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = _rand(kq, (b, sq, h, d), jnp.bfloat16)
    k = _rand(kk, (b, sk, h, d), jnp.bfloat16)
    v = _rand(kv, (b, sk, h, d), jnp.bfloat16)
    route = A.attention_route(d, jnp.bfloat16, jax.default_backend())
    out = jax.jit(A.attention)(q, k, v).astype(jnp.float32)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(A.attention_xla)(q.astype(jnp.float32),
                                       k.astype(jnp.float32),
                                       v.astype(jnp.float32))
    err = float(jnp.max(jnp.abs(out - ref)))
    rel = err / max(float(jnp.max(jnp.abs(ref))), 1e-30)
    ok = bool(jnp.all(jnp.isfinite(out))) and rel <= ATTN_TOL
    say(f"[kernel] attention {name} B{b} Sq{sq} Sk{sk} H{h} D{d}: route "
        f"{route}, bf16 vs f32(highest) max-abs {err:.3e} rel {rel:.3e} "
        f"tol {ATTN_TOL:g} {'ok' if ok else 'FAIL'}")
    check(ok, f"attention {name} out of tolerance")
    return route


def check_qlinear(shape=QLIN_SHAPE, seed=1):
    """q8_dot / q4_dot in bf16 vs x @ dequant(w) in float32 ("highest")."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mlimgsynth_tpu.ops import q4_matmul as q4
    from mlimgsynth_tpu.ops import q8_matmul as q8
    m, k, n = shape
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n), dtype=np.float32) / np.sqrt(k)
    x = _rand(jax.random.PRNGKey(seed), (m, k), jnp.bfloat16)
    for tag, (wq, s), fn in (("q8", q8.quantize_weight(w), q8.q8_dot),
                             ("q4", q4.quantize_weight_q4(w), q4.q4_dot)):
        wq, s = jnp.asarray(wq), jnp.asarray(s)
        out = jax.jit(fn)(x, wq, s).astype(jnp.float32)
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(fn)(x.astype(jnp.float32), wq, s)
        err = float(jnp.max(jnp.abs(out - ref)))
        rel = err / max(float(jnp.max(jnp.abs(ref))), 1e-30)
        ok = rel <= QLIN_TOL
        say(f"[kernel] {tag}_dot M{m} K{k} N{n}: bf16 vs f32(highest) "
            f"max-abs {err:.3e} rel {rel:.3e} tol {QLIN_TOL:g} "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{tag}_dot out of tolerance")


def report_f32_precision(n=2048, seed=2):
    """How far a float32 matmul at the default precision lands from one at
    "highest": ~1e-3 relative means the card ran it in TF32."""
    import jax
    import jax.numpy as jnp
    ka, kb = jax.random.split(jax.random.PRNGKey(seed))
    a = jax.random.normal(ka, (n, n))
    b = jax.random.normal(kb, (n, n))
    out = jax.jit(jnp.dot)(a, b)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jnp.dot)(a, b)
    rel = float(jnp.max(jnp.abs(out - ref)) / jnp.max(jnp.abs(ref)))
    say(f"[kernel] f32 matmul {n}x{n}x{n} at default precision vs "
        f"highest: rel {rel:.3e}")
    return rel


def phase_kernels(attn_shapes=ATTN_SHAPES, qlin_shape=QLIN_SHAPE):
    routes = {name: check_attention(name, shape)
              for name, shape in attn_shapes}
    check_qlinear(qlin_shape)
    report_f32_precision()
    return routes


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def make_session(paths, mt, size, steps, cfg, seed, **opts):
    """A session on the checkpoint ``paths`` with model type ``mt`` (a
    name or a ``ModelTypeDef``)."""
    from mlimgsynth_tpu.api import MLImgSynth
    s = MLImgSynth()
    for key, p in paths.items():
        s.option_set(key, p)
    s.option_set("model-type", mt)
    s.option_set("image-dim", size, size)
    s.option_set("steps", steps)
    s.option_set("cfg-scale", cfg)
    s.option_set("method", "euler")
    s.option_set("seed", seed)
    s.option_set("prompt", "a photograph of a lighthouse at dusk")
    for k, v in opts.items():
        s.option_set(k, v)
    return s


def denoiser_inputs(mt, size, seed):
    """(fn(ctx, x, t), x, t) for one CFG-batch denoiser eval of ``mt``."""
    import jax
    import jax.numpy as jnp
    from mlimgsynth_tpu.models import flux as flux_mod
    from mlimgsynth_tpu.models import mmdit as mmdit_mod
    from mlimgsynth_tpu.models import unet as unet_mod
    P = mt.unet_p
    lat = size // 8
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    if getattr(P, "flux", False):
        x = jax.random.normal(ks[0], (1, lat, lat, P.n_ch_in // 4))
        c = jax.random.normal(ks[1], (1, 256, P.d_ctx_in))
        y = jax.random.normal(ks[2], (1, P.d_pooled))
        t = jnp.full((1,), 0.5)

        def fn(ctx, x, t):
            return flux_mod.flux_apply(ctx, x, t, c, y, P)
    elif getattr(P, "flow", False):
        x = jax.random.normal(ks[0], (2, lat, lat, P.n_ch_in))
        c = jax.random.normal(ks[1], (2, 154, P.d_ctx_in))
        y = jax.random.normal(ks[2], (2, P.d_pooled))
        t = jnp.full((2,), 500.0)

        def fn(ctx, x, t):
            return mmdit_mod.mmdit_apply(ctx, x, t, c, y, P)
    else:
        x = jax.random.normal(ks[0], (2, lat, lat, P.n_ch_in))
        c = jax.random.normal(ks[1], (2, 77, P.n_ctx))
        y = (jax.random.normal(ks[2], (2, P.ch_adm_in)) if P.ch_adm_in
             else None)
        t = jnp.full((2,), 500.0)

        def fn(ctx, x, t):
            return unet_mod.unet_apply(ctx, x, t, c, y, P)
    return fn, x, t


def check_step(session, mt, size, seed, f32_fits=True):
    """One denoiser eval in bf16 vs float32 ("highest"); also returns
    whether the compiled bf16 step holds cuDNN's fused attention call."""
    import jax
    import jax.numpy as jnp
    from mlimgsynth_tpu.models import blocks as B
    params = session._get_params("unet")
    fn, x, t = denoiser_inputs(mt, size, seed)
    step16 = jax.jit(lambda p, x, t: fn(B.Ctx(p, dtype=jnp.bfloat16), x, t))
    compiled = step16.lower(params, x, t).compile()
    has_cudnn = "cudnn$fmha" in compiled.as_text()
    out16 = compiled(params, x, t).astype(jnp.float32)
    check(bool(jnp.all(jnp.isfinite(out16))), "bf16 step is not finite")
    if not f32_fits:
        say("[session] denoiser step f32 comparison not run: float32 "
            "weights do not fit beside the bf16 ones")
        return None, has_cudnn
    p32 = {k: (v.astype(jnp.float32) if jnp.issubdtype(v.dtype, jnp.floating)
               else v) for k, v in params.items()}
    with jax.default_matmul_precision("highest"):
        out32 = jax.jit(lambda p, x, t: fn(
            B.Ctx(p, dtype=jnp.float32), x, t))(p32, x, t)
    del p32
    rel = float(jnp.linalg.norm(out16 - out32)
                / max(float(jnp.linalg.norm(out32)), 1e-30))
    say(f"[session] denoiser step bf16 vs f32(highest): rel-L2 {rel:.3e} "
        f"tol {STEP_TOL:g} {'ok' if rel <= STEP_TOL else 'FAIL'}")
    check(rel <= STEP_TOL, "bf16 denoiser step out of tolerance")
    return rel, has_cudnn


def head_dims(P):
    """The attention head dims of a denoiser's parameters."""
    if getattr(P, "flux", False):
        return {P.d_head}
    if getattr(P, "flow", False):
        return {P.width // P.heads}
    return {P.d_head or P.n_ch * m // P.n_head for m in P.ch_mult}


def to_u8(img):
    from mlimgsynth_tpu.utils import image as image_mod
    return image_mod.tensor_to_image_arr(img, 0)


def phase_session(family="sd1", mt=None, size=None, steps=None, cfg=None,
                  seed=0, workdir=WORK, f32_step=True):
    """Write the synthetic checkpoint, generate twice, check the image and
    one denoiser step.  Returns (session, summary)."""
    import jax
    import numpy as np
    from mlimgsynth_tpu import testing
    from mlimgsynth_tpu.api import _model_types
    from mlimgsynth_tpu.ops.attention import attention_route
    from mlimgsynth_tpu.utils import image as image_mod
    mt_name, size0, steps0, cfg0 = FAMILIES[family]
    mt = mt or _model_types()[mt_name]
    size, steps = size or size0, steps or steps0
    cfg = cfg0 if cfg is None else cfg
    os.makedirs(workdir, exist_ok=True)
    t0 = time.time()
    paths = testing.write_synthetic_model(workdir, mt_name, mt, seed=seed)
    gc.collect()
    say(f"[session] {family}: synthetic fp16 checkpoint written in "
        f"{time.time() - t0:.1f} s ({', '.join(sorted(paths))})")
    s = make_session(paths, mt, size, steps, cfg, seed)
    t0 = time.time()
    img = s.generate()
    cold = time.time() - t0
    check(img.shape[-2:] == (size, size), f"image shape {img.shape}")
    check(bool(np.isfinite(img).all()), "image is not finite")
    u8 = to_u8(img)
    check(int(u8.max()) != int(u8.min()), "image is constant")
    png = os.path.join(workdir, f"{family}.png")
    image_mod.image_save(png, u8, s.infotext)
    check(image_mod.png_read_parameters(png) == s.infotext,
          "PNG parameters chunk did not round-trip")
    s.option_set("seed", seed)          # a generation advances the seed
    t0 = time.time()
    img2 = s.generate()
    warm = time.time() - t0
    same = bool(np.array_equal(u8, to_u8(img2)))
    dk = jax.devices()[0].device_kind
    say(f"[session] {family} {size}x{size} {steps} steps cfg {cfg:g}: "
        f"cold {cold:.2f} s (load + compile + run), warm {warm:.3f} s/image; "
        f"same seed twice identical: {same}; card {dk}")
    rel, has_cudnn = check_step(s, mt, size, seed, f32_fits=f32_step)
    want_cudnn = any(
        attention_route(d, "bfloat16", jax.default_backend()) == "cudnn"
        for d in head_dims(mt.unet_p))
    say(f"[session] compiled bf16 denoiser step holds cuDNN fused "
        f"attention: {has_cudnn} (shape rule expects {want_cudnn})")
    check(has_cudnn == want_cudnn,
          "cuDNN fused attention presence does not match the shape rule")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    say(f"[session] peak_bytes_in_use {peak} "
        f"({(peak or 0) / 2**30:.2f} GiB); nvidia-smi: {nvidia_smi()}")
    return s, {"cold_s": cold, "warm_s": warm, "identical": same,
               "step_rel_l2": rel, "peak_bytes": peak}


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def png_size(data):
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "response is not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    return w, h


def phase_server(session, size, steps, cfg, n_req=3):
    from mlimgsynth_tpu import server
    httpd = server.make_server(session, port=0)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        for i in range(n_req):
            body = json.dumps({"prompt": f"a red bicycle, variation {i}",
                               "width": size, "height": size,
                               "steps": steps, "cfg_scale": cfg,
                               "seed": 100 + i}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/sdapi/v1/txt2img", data=body,
                headers={"Content-Type": "application/json"})
            t0 = time.time()
            with urllib.request.urlopen(req, timeout=600) as r:
                out = json.loads(r.read())
            dt = time.time() - t0
            png = base64.b64decode(out["images"][0])
            w, h = png_size(png)
            check((w, h) == (size, size), f"PNG is {w}x{h}")
            say(f"[server] txt2img request {i}: {w}x{h} PNG, {len(png)} "
                f"bytes, {dt:.3f} s")
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

MESH_LEGS = [  # (family, size, steps, [(name, session options)])
    ("sdxl", 1024, 4, [("sdxl dp2 x tp2", {"dp": 2, "tp": 2})]),
    ("sd3", 1024, 4, [("sd3 sp4", {"sp": 4}), ("sd3 pp4", {"pp": 4})]),
]
# Same seed on one card and on the mesh: the reduction order differs, so
# the bf16 images differ a little; a broken sharding gives an unrelated
# image.  The mesh image must sit much closer to the one-card image than
# the one-card image of the next seed does.
MESH_REL_TOL = 0.25


def _timed_image(paths, mt, size, steps, cfg, seed, **opts):
    """(session, image of ``seed``, warm seconds) after one compile run."""
    s = make_session(paths, mt, size, steps, cfg, seed, **opts)
    s.generate()                           # compile
    s.option_set("seed", seed)
    t0 = time.time()
    img = s.generate()
    return s, img, time.time() - t0


def mesh_model_types():
    """The mesh legs' model types: published widths, depth cut to fit the
    four-card time budget (SDXL: one transformer block per attention level
    instead of 2 and 10; SD3-medium: 8 of its 24 joint blocks at width
    1536, 24 heads)."""
    import dataclasses as dc
    from mlimgsynth_tpu.api import _model_types
    mts = _model_types()
    xl, s3 = mts["sdxl"], mts["sd3"]
    return {**mts,
            "sdxl": dc.replace(xl, unet_p=dc.replace(
                xl.unet_p, transf_depth=(1, 1, 1))),
            "sd3": dc.replace(s3, unet_p=dc.replace(
                s3.unet_p, depth=8, d_model=s3.unet_p.width,
                n_head=s3.unet_p.heads))}


def phase_mesh(legs=MESH_LEGS, workdir=WORK, mts=None, seed=0):
    """Each mesh configuration against the same seed on one card, in one
    process; one checkpoint and one one-card baseline per family."""
    import numpy as np
    from mlimgsynth_tpu import testing
    mts = mts or mesh_model_types()
    os.makedirs(workdir, exist_ok=True)
    results = []
    for family, size, steps, configs in legs:
        mt_name, _, _, cfg = FAMILIES[family]
        mt = mts[mt_name]
        paths = testing.write_synthetic_model(workdir, mt_name, mt,
                                              seed=seed)
        s, base, t_base = _timed_image(paths, mt, size, steps, cfg, seed)
        s.option_set("seed", seed + 1)
        unrelated = float(np.abs(s.generate() - base).mean())
        del s
        gc.collect()
        for name, opts in configs:
            s, img, t = _timed_image(paths, mt, size, steps, cfg, seed,
                                     **opts)
            del s
            gc.collect()
            diff = float(np.abs(img - base).mean())
            ok = (diff <= MESH_REL_TOL * unrelated
                  and bool(np.isfinite(img).all()))
            say(f"[mesh] {name} {size}px {steps} steps: one card "
                f"{t_base:.3f} s, mesh {t:.3f} s; mean |diff| vs one card "
                f"{diff:.2e}, vs the next seed {unrelated:.2e}, tol "
                f"{MESH_REL_TOL:g}x {'ok' if ok else 'FAIL'}; "
                f"nvidia-smi: {nvidia_smi().splitlines()[0]}")
            check(ok, f"{name} differs from the one-card image")
            results.append((name, diff))
    return results


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--family", choices=sorted(FAMILIES),
                    help="run phase 3 for this family at its bench size "
                    "(default sd1); with --mesh4, only this family's legs")
    ap.add_argument("--mesh4", action="store_true",
                    help="run only the four-card legs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    try:
        import mlimgsynth_tpu
    except ImportError as e:
        print(f"FAIL: the mlimgsynth_tpu package is not here ({e})",
              file=sys.stderr)
        return 2
    pkg = os.path.dirname(os.path.abspath(mlimgsynth_tpu.__file__))
    if os.path.dirname(pkg) != REPO:
        print(f"FAIL: mlimgsynth_tpu comes from {pkg}, not this checkout",
              file=sys.stderr)
        return 2
    from mlimgsynth_tpu.utils.compcache import enable
    try:
        dev = phase_device()
        enable()
        if args.mesh4:
            check(dev["count"] >= 4, f"--mesh4 needs 4 GPUs, "
                  f"have {dev['count']}")
            legs = [leg for leg in MESH_LEGS
                    if args.family in (None, leg[0])]
            check(legs, f"no four-card legs for {args.family}")
            phase_mesh(legs, seed=args.seed)
        elif args.family not in (None, "sd1"):
            phase_session(args.family, seed=args.seed,
                          f32_step=args.family != "flux-schnell")
        else:
            phase_kernels()
            s, _ = phase_session("sd1", seed=args.seed)
            _, size, steps, cfg = FAMILIES["sd1"]
            phase_server(s, size, steps, cfg)
            for mod in ("PIL", "safetensors"):
                check(mod not in sys.modules,
                      f"the SD1.5 path imported {mod}")
    except SmokeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
