"""ESRGAN / Real-ESRGAN (RRDBNet) image upscaler.

Beyond-reference addition (the reference has no upscaler; A1111's
highres-fix and "Extras" tab use these models, and our serving layer
exposes the matching endpoints).  Architecture follows the public
basicsr ``RRDBNet``: a conv stem, ``n_block`` Residual-in-Residual
Dense Blocks, a trunk conv with a global residual, two nearest-2x +
conv upsample stages, and an HR head — all 3x3 convs with LeakyReLU(0.2)
activations and 0.2 residual scaling.

Device notes: the whole network is 3x3 convs at full image resolution —
pure conv work in NHWC/bf16, one fused XLA program, no attention and
no normalization layers at all.  x2/x1 checkpoints keep the same trunk
but feed a space-to-depth (pixel-unshuffle) input so the fixed 4x
upsampler nets out at 2x/1x.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from . import blocks as B


@dataclass(frozen=True)
class EsrganParams:
    n_feat: int = 64       # trunk width (conv_first out channels)
    n_block: int = 23      # RRDB count (x4plus: 23; anime-6B: 6)
    growth: int = 32       # dense-block growth channels
    unshuffle: int = 1     # input space-to-depth factor (1: x4, 2: x2, 4: x1)
    ch_img: int = 3

    @property
    def scale(self) -> int:
        return 4 // self.unshuffle


ESRGAN_X4 = EsrganParams()


def _lrelu(x):
    return jnp.where(x >= 0, x, 0.2 * x)


def _rdb(ctx: B.Ctx, pre: str, x, growth: int):
    """Residual dense block: 5 convs over dense concats, 0.2 residual."""
    feats = [x]
    for k in range(1, 5):
        h = B.conv2d(ctx, f"{pre}.conv{k}",
                     jnp.concatenate(feats, -1) if len(feats) > 1
                     else feats[0], growth)
        feats.append(_lrelu(h))
    out = B.conv2d(ctx, f"{pre}.conv5", jnp.concatenate(feats, -1),
                   x.shape[-1])
    return x + 0.2 * out


def _rrdb(ctx: B.Ctx, pre: str, x, growth: int):
    h = x
    for j in (1, 2, 3):
        h = _rdb(ctx, f"{pre}.rdb{j}", h, growth)
    return x + 0.2 * h


def _nearest2x(x):
    n, h, w, c = x.shape
    x = jnp.broadcast_to(x[:, :, None, :, None, :], (n, h, 2, w, 2, c))
    return x.reshape(n, h * 2, w * 2, c)


def _space_to_depth(x, f: int):
    n, h, w, c = x.shape
    x = x.reshape(n, h // f, f, w // f, f, c)
    # basicsr pixel_unshuffle channel order: [c, fh, fw]
    x = x.transpose(0, 1, 3, 5, 2, 4)
    return x.reshape(n, h // f, w // f, c * f * f)


def esrgan_apply(ctx: B.Ctx, img, P: EsrganParams):
    """img [N,H,W,3] in [0,1] -> [N,scale*H,scale*W,3] in [0,1]."""
    x = img.astype(ctx.dtype)
    if P.unshuffle > 1:
        x = _space_to_depth(x, P.unshuffle)
    fea = B.conv2d(ctx, "conv_first", x, P.n_feat)
    h = fea
    for i in range(P.n_block):
        h = _rrdb(ctx, f"body.{i}", h, P.growth)
    fea = fea + B.conv2d(ctx, "conv_body", h, P.n_feat)
    fea = _lrelu(B.conv2d(ctx, "conv_up1", _nearest2x(fea), P.n_feat))
    fea = _lrelu(B.conv2d(ctx, "conv_up2", _nearest2x(fea), P.n_feat))
    out = B.conv2d(ctx, "conv_last", _lrelu(
        B.conv2d(ctx, "conv_hr", fea, P.n_feat)), P.ch_img)
    return jnp.clip(out, 0.0, 1.0)


# ---------------------------------------------------------------------------
# checkpoint loading
# ---------------------------------------------------------------------------

# old-arch ESRGAN (sequential "model.N" naming) -> basicsr RRDBNet names
_OLD_FIXED = {
    "model.0": "conv_first",
    "model.3": "conv_up1",
    "model.6": "conv_up2",
    "model.8": "conv_hr",
    "model.10": "conv_last",
}


def _canon_name(name: str, n_block_hint: int) -> str:
    """Map an old-arch key prefix onto the basicsr name; new names pass
    through unchanged."""
    if not name.startswith("model."):
        return name
    for old, new in _OLD_FIXED.items():
        if name.startswith(old + "."):
            return new + name[len(old):]
    if name.startswith("model.1.sub."):
        rest = name[len("model.1.sub."):]
        idx, _, tail = rest.partition(".")
        if int(idx) == n_block_hint:          # trailing trunk conv
            return "conv_body." + tail
        tail = tail.replace(".0.", ".")       # convN.0.weight -> convN.weight
        return f"body.{idx}." + tail.replace("RDB", "rdb")
    return name


def load_esrgan_state(path: str) -> Dict[str, np.ndarray]:
    """Read a .safetensors or torch .pth ESRGAN checkpoint into a flat
    f32 {basicsr_name: array} dict (torch layouts, OIHW convs)."""
    raw: Dict[str, np.ndarray] = {}
    if path.endswith((".pth", ".pt", ".ckpt")):
        import torch
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for k in ("params_ema", "params", "state_dict"):
            if isinstance(sd, dict) and k in sd:
                sd = sd[k]
                break
        for k, v in sd.items():
            raw[k] = np.asarray(v.to(torch.float32).numpy())
    else:
        from ..io.tensorstore import TensorStore
        st = TensorStore.open(path)
        try:
            for name in st.names():
                # copy: reads are zero-copy views into the mmap
                raw[name] = np.array(st.read(name, "f32"))
        finally:
            st.close()
    n_block_hint = -1
    subs = [k for k in raw if k.startswith("model.1.sub.")]
    if subs:
        n_block_hint = max(int(k.split(".")[3]) for k in subs)
    return {_canon_name(k, n_block_hint): v for k, v in raw.items()}


def infer_params(state: Dict[str, np.ndarray]) -> EsrganParams:
    """Geometry from checkpoint shapes (conv weights are OIHW here)."""
    try:
        first = state["conv_first.weight"]
        g = state["body.0.rdb1.conv1.weight"].shape[0]
    except KeyError as e:
        raise ValueError(f"not an ESRGAN/RRDBNet checkpoint: missing {e}")
    n_feat, ch_in = first.shape[0], first.shape[1]
    n_block = 1 + max(int(k.split(".")[1]) for k in state
                      if k.startswith("body."))
    if ch_in % 3 != 0 or int((ch_in // 3) ** 0.5) ** 2 * 3 != ch_in:
        raise ValueError(f"unsupported ESRGAN input channels {ch_in}")
    return EsrganParams(n_feat=n_feat, n_block=n_block, growth=g,
                        unshuffle=int((ch_in // 3) ** 0.5))


def load_esrgan(path: str, dtype=jnp.bfloat16
                ) -> Tuple[Dict[str, np.ndarray], EsrganParams]:
    """Checkpoint -> (model-ready param dict, params).  Convs go
    OIHW -> HWIO; everything is cast to ``dtype`` except biases."""
    import jax

    from ..weights import _to_layout
    state = load_esrgan_state(path)
    if "conv_first.weight" in state:
        P = infer_params(state)
    elif "body.0.weight" in state:          # SRVGGNetCompact
        P = _infer_srvgg(state)
    else:
        raise ValueError("not an ESRGAN/RRDBNet/SRVGG checkpoint")
    ctx = B.Ctx(record=True, dtype=dtype)
    jax.eval_shape(lambda x: upscaler_apply(ctx, x, P),
                   jnp.zeros((1, 8 * P.unshuffle, 8 * P.unshuffle,
                              P.ch_img)))
    spec = ctx.spec
    params: Dict[str, np.ndarray] = {}
    missing = []
    for name, ps in spec.items():
        if name not in state:
            missing.append(name)
            continue
        x = _to_layout(state[name], ps, name)
        params[name] = x.astype(np.dtype(ps.dtype))
    if missing:
        raise ValueError(
            f"{len(missing)} tensors missing from ESRGAN checkpoint, "
            "e.g. " + ", ".join(missing[:5]))
    return params, P


@functools.lru_cache(maxsize=None)
def _make_jit():
    import jax

    @functools.partial(jax.jit, static_argnames=("P", "dtype"))
    def f(params, x, *, P, dtype):
        ctx = B.Ctx(params, dtype=dtype)
        return upscaler_apply(ctx, x, P)

    return f


def esrgan_run(params, x, P: EsrganParams, dtype=jnp.bfloat16):
    """Jitted NHWC forward (module-level cache, shared across sessions)."""
    return _make_jit()(params, x, P=P, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _make_tiled_jit():
    import jax
    from jax import lax

    @functools.partial(jax.jit, static_argnames=("P", "dtype", "tn1",
                                                 "tn0"))
    def up_tiled(params, img, origins, boxes, *, P, dtype, tn1, tn0):
        """One-dispatch tiled upscale (same design as the VAE tiling
        scan, api._make_tiled_vae_jits): img NHWC [n,h,w,3]; origins
        [T,2] (y,x px); boxes [T,4] (y0,y1,x0,x1 tile-relative px).
        Seams are approximate: the RRDB receptive field exceeds any
        practical overlap margin, so tiles blend by inner-region
        ownership like every ESRGAN tiler."""
        ctx = B.Ctx(params, dtype=dtype)
        s = P.scale
        n, h, w, _ = img.shape
        out = jnp.zeros((n, h * s, w * s, 3), jnp.float32)
        ys = lax.broadcasted_iota(jnp.int32, (tn1 * s, tn0 * s), 0)
        xs = lax.broadcasted_iota(jnp.int32, (tn1 * s, tn0 * s), 1)

        def body(out, inp):
            org, box = inp
            sub = lax.dynamic_slice(img, (0, org[0], org[1], 0),
                                    (n, tn1, tn0, 3))
            up = upscaler_apply(ctx, sub, P).astype(jnp.float32)
            m = ((ys >= box[0] * s) & (ys < box[1] * s) &
                 (xs >= box[2] * s) & (xs < box[3] * s))
            m = m[None, :, :, None].astype(jnp.float32)
            cur = lax.dynamic_slice(out, (0, org[0] * s, org[1] * s, 0),
                                    (n, tn1 * s, tn0 * s, 3))
            out = lax.dynamic_update_slice(
                out, cur * (1.0 - m) + up * m,
                (0, org[0] * s, org[1] * s, 0))
            return out, None

        out, _ = lax.scan(body, out, (origins, boxes))
        return out

    return up_tiled


def esrgan_run_tiled(params, x, origins, boxes, P: EsrganParams,
                     tn1: int, tn0: int, dtype=jnp.bfloat16):
    return _make_tiled_jit()(params, x, origins, boxes, P=P, dtype=dtype,
                             tn1=tn1, tn0=tn0)


# ---------------------------------------------------------------------------
# SRVGGNetCompact (realesr-general-x4v3 family): a plain conv+PReLU stack
# with a pixel-shuffle tail over a nearest-upsampled base.  Shares the
# loader/runner surface with RRDBNet above.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SrvggParams:
    n_feat: int = 64
    n_conv: int = 32
    scale: int = 4
    ch_img: int = 3
    unshuffle: int = 1      # surface parity with EsrganParams


def _prelu(ctx: B.Ctx, pre: str, x):
    a = ctx.param(pre + ".weight", (x.shape[-1],), "vec",
                  dtype=jnp.float32).astype(x.dtype)
    return jnp.maximum(x, 0) + a * jnp.minimum(x, 0)


def _depth_to_space(x, r: int):
    """torch PixelShuffle channel order: [c, fh, fw]."""
    n, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(n, h, w, c, r, r)
    x = x.transpose(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, c)


def srvgg_apply(ctx: B.Ctx, img, P: SrvggParams):
    """img [N,H,W,3] in [0,1] -> [N,scale*H,scale*W,3] in [0,1]."""
    x = img.astype(ctx.dtype)
    h = _prelu(ctx, "body.1", B.conv2d(ctx, "body.0", x, P.n_feat))
    for i in range(P.n_conv):
        h = _prelu(ctx, f"body.{2 * i + 3}",
                   B.conv2d(ctx, f"body.{2 * i + 2}", h, P.n_feat))
    h = B.conv2d(ctx, f"body.{2 * P.n_conv + 2}", h,
                 P.ch_img * P.scale * P.scale)
    out = _depth_to_space(h, P.scale)
    base = img.astype(out.dtype)
    for _ in range(P.scale.bit_length() - 1):
        base = _nearest2x(base)
    if P.scale == 3:  # non-pow2: generic repeat
        n, hh, ww, c = img.shape
        base = jnp.broadcast_to(
            img.astype(out.dtype)[:, :, None, :, None, :],
            (n, hh, 3, ww, 3, c)).reshape(n, hh * 3, ww * 3, c)
    return jnp.clip(out + base, 0.0, 1.0)


def upscaler_apply(ctx: B.Ctx, img, P):
    """Arch dispatch shared by the jitted runners."""
    if isinstance(P, SrvggParams):
        return srvgg_apply(ctx, img, P)
    return esrgan_apply(ctx, img, P)


def _infer_srvgg(state: Dict[str, np.ndarray]) -> SrvggParams:
    idx = sorted(int(k.split(".")[1]) for k in state
                 if k.startswith("body.") and k.endswith(".weight"))
    last = idx[-1]
    n_conv = (last - 2) // 2
    n_feat = state["body.0.weight"].shape[0]
    out_ch = state[f"body.{last}.weight"].shape[0]
    ch_img = state["body.0.weight"].shape[1]
    r2 = out_ch // ch_img
    return SrvggParams(n_feat=n_feat, n_conv=n_conv,
                       scale=int(round(r2 ** 0.5)), ch_img=ch_img)
