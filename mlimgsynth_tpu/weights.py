"""Checkpoint -> model parameter loading.

Bridges the tensorstore (raw checkpoint names, torch layouts) to the model
param dicts (internal names, device layouts):

* name normalization + OpenCLIP fused-qkv splitting
  (reference: tensor_callback_main + open_clip_attn_conv,
  src/mlimgsynth.c:990-1055),
* model-type identification by probing UNet tensor shapes
  (reference: mlis_model_identify, src/mlimgsynth.c:1207-1249),
* layout transforms keyed by the param spec kinds recorded by the model code
  (linear [out,in]->[in,out], conv OIHW->HWIO),
* LoRA weight merging into the store's tensor cache
  (reference: src/lora.c).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

import ml_dtypes

from .io.tensorstore import TensorStore
from .models.blocks import CONV_W, LINEAR_W, ParamSpec
from .nameconv import QKV, TProj, normalize_lora_name, normalize_name

BF16 = ml_dtypes.bfloat16


@dataclass
class NameRef:
    raw: str              # raw checkpoint tensor name
    split: Optional[int] = None  # 0/1/2 = q/k/v third of a fused tensor
    transpose: bool = False      # HF Linear-stored text_projection.weight


def register_name(out: Dict[str, NameRef], raw: str, r) -> None:
    """Register one normalize_name result (str / QKV / TProj) for ``raw``;
    first mapping wins."""
    if r is None:
        return
    if isinstance(r, QKV):
        base = r.name
        if base.endswith("in_proj_weight"):
            stem, suffix = base[:-len("in_proj_weight")], "weight"
        else:
            stem, suffix = base[:-len("in_proj_bias")], "bias"
        for i, which in enumerate(("q_proj", "k_proj", "v_proj")):
            out.setdefault(f"{stem}{which}.{suffix}", NameRef(raw, split=i))
    elif isinstance(r, TProj):
        out.setdefault(r.name, NameRef(raw, transpose=True))
    else:
        out.setdefault(r, NameRef(raw))
        if r.startswith("mmdit.final_layer."):
            # final_layer.* is name-identical in the MMDiT and Flux
            # layouts; alias so either family's spec keys resolve
            out.setdefault("flux." + r[len("mmdit."):], NameRef(raw))


def build_name_map(store: TensorStore) -> Dict[str, NameRef]:
    """Map internal names -> checkpoint entries, splitting fused qkv."""
    out: Dict[str, NameRef] = {}
    for raw in store.tensors:
        register_name(out, raw, normalize_name(raw))
    return out


def merge_prefixed(name_map: Dict[str, NameRef], store: TensorStore,
                   prefix: str, transform) -> int:
    """Map aux-file tensors (read under ``prefix``) into ``name_map``
    through ``transform(tail) -> normalize_name-style result``; returns
    how many mapped."""
    n0 = len(name_map)
    for raw in store.tensors:
        if not raw.startswith(prefix):
            continue
        register_name(name_map, raw, transform(raw[len(prefix):]))
    return len(name_map) - n0


def identify_model(store: TensorStore, name_map: Dict[str, NameRef],
                   width_table: Optional[Dict[int, str]] = None
                   ) -> Tuple[Optional[str], Optional[str]]:
    """Probe model type from the UNet cross-attn K width
    (reference: src/mlimgsynth.c:1207-1249).  Returns (model_type, dtype).
    ``width_table`` maps n_ctx -> type name; defaults to the SD families."""
    if width_table is None:
        width_table = {768: "sd1", 1024: "sd2", 2048: "sdxl",
                       1280: "sdxl_refiner"}
    for probe in ("unet.in.1.1.transf.0.attn2.k_proj.weight",
                  "unet.in.4.1.transf.0.attn2.k_proj.weight"):
        ref = name_map.get(probe)
        if ref is None:
            continue
        e = store.tensors[ref.raw]
        return width_table.get(int(e.shape[-1])), e.dtype
    # SD3 family: MMDiT joint blocks; width distinguishes 3.5-large, the
    # MMDiT-X dual-attention tensor distinguishes 3.5-medium from 3-medium
    ref = name_map.get("mmdit.joint_blocks.0.x_block.attn.qkv.weight")
    if ref is not None:
        e = store.tensors[ref.raw]
        if int(e.shape[-1]) == 2432:
            return "sd35_large", e.dtype
        if "mmdit.joint_blocks.0.x_block.attn2.qkv.weight" in name_map:
            return "sd35_medium", e.dtype
        return "sd3", e.dtype
    # Flux: double/single-stream transformer; dev carries guidance_in
    ref = name_map.get("flux.double_blocks.0.img_attn.qkv.weight")
    if ref is not None:
        e = store.tensors[ref.raw]
        dev = "flux.guidance_in.in_layer.weight" in name_map
        return ("flux_dev" if dev else "flux_schnell"), e.dtype
    return None, None


def read_entry(store: TensorStore, ref: NameRef) -> np.ndarray:
    """Read a (possibly split) checkpoint tensor as f32, honoring the cache."""
    x = store.read(ref.raw, "f32")
    if ref.split is not None:
        d = x.shape[0] // 3
        x = x[ref.split * d:(ref.split + 1) * d]
    if ref.transpose:
        x = np.ascontiguousarray(x.T)
    return x


def _to_layout(x: np.ndarray, spec: ParamSpec, name: str) -> np.ndarray:
    shape = spec.shape
    if spec.kind == LINEAR_W:
        if x.ndim == 4:  # conv-stored 1x1 used as linear
            x = x.reshape(x.shape[0], x.shape[1])
        if x.ndim != 2:
            raise ValueError(f"{name}: expected 2-D linear weight, got {x.shape}")
        x = x.T  # [out,in] -> [in,out]
    elif spec.kind == CONV_W:
        if x.ndim == 2:  # linear-stored weight used as 1x1 conv
            x = x.reshape(x.shape[0], x.shape[1], 1, 1)
        if x.ndim != 4:
            raise ValueError(f"{name}: expected 4-D conv weight, got {x.shape}")
        x = x.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    else:
        x = x.reshape(shape) if x.size == np.prod(shape) else x
    if tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name}: shape {tuple(x.shape)} does not match spec {shape}")
    return np.ascontiguousarray(x)


def _np_dtype(jdt) -> np.dtype:
    # jnp.bfloat16 is ml_dtypes.bfloat16, which numpy understands directly
    return np.dtype(jdt)


def load_params(store: TensorStore, spec: Dict[str, ParamSpec],
                name_map: Dict[str, NameRef]) -> Dict[str, np.ndarray]:
    """Materialize all params required by ``spec`` in model-ready layout."""
    params: Dict[str, np.ndarray] = {}
    missing = []
    for name, ps in spec.items():
        ref = name_map.get(name)
        if ref is None:
            missing.append(name)
            continue
        x = read_entry(store, ref)
        x = _to_layout(x, ps, name)
        dt = _np_dtype(ps.dtype)
        params[name] = x.astype(dt) if x.dtype != dt else x
    if missing:
        raise KeyError(
            f"{len(missing)} tensors missing from checkpoint, e.g. "
            + ", ".join(missing[:8]))
    return params


def pack_to_device(host_params: Dict[str, np.ndarray]) -> Dict[str, object]:
    """Upload a param dict in a handful of large transfers.

    Per-array uploads cost one dispatch each; a single large transfer per
    dtype followed by one jitted on-device unpack is faster.  Returns a
    dict of device arrays.
    """
    import jax
    import jax.numpy as jnp

    groups: Dict[np.dtype, list] = {}
    for name in sorted(host_params):
        arr = host_params[name]
        groups.setdefault(arr.dtype, []).append(name)

    out = {}
    for dt, names in groups.items():
        flats = [np.ascontiguousarray(host_params[n]).reshape(-1)
                 for n in names]
        big = np.concatenate(flats) if len(flats) > 1 else flats[0]
        shapes = [host_params[n].shape for n in names]
        sizes = [f.size for f in flats]

        @jax.jit
        def unpack(buf, shapes=tuple(map(tuple, shapes)),
                   sizes=tuple(sizes)):
            res = []
            off = 0
            for shp, n in zip(shapes, sizes):
                res.append(buf[off:off + n].reshape(shp))
                off += n
            return res
        parts = unpack(jnp.asarray(big))
        out.update(dict(zip(names, parts)))
    return out


# ---------------------------------------------------------------------------
# LoRA merging (reference: src/lora.c)
# ---------------------------------------------------------------------------

def lora_apply(model_store: TensorStore, model_map: Dict[str, NameRef],
               lora_store: TensorStore, mult: float) -> int:
    """Merge ``dst += scale * up @ down`` into the model store's cache for
    every ``*.lora_down.weight`` in the lora file.  Returns patch count.

    diffusers-peft DiT LoRA stems may carry an ``@num/span/den`` fragment:
    the delta targets rows ``[num*d, (num+span)*d)`` of the fused raw
    [out,in] tensor, ``d = out // den`` (flux/SD3 split to_q/to_k/to_v —
    and flux's single-block proj_mlp — out of fused linears)."""
    # the loaded model's family disambiguates the shared diffusers
    # "transformer_blocks" layout (flux double vs SD3 joint blocks)
    family = "sd"
    for k in model_map:
        if k.startswith("flux.double_blocks."):
            family = "flux"
            break
        if k.startswith("mmdit.joint_blocks."):
            family = "mmdit"
            break
    # normalize lora names once
    lora_map: Dict[str, str] = {}
    for raw in lora_store.tensors:
        r = normalize_lora_name(raw, family)
        if isinstance(r, str):
            lora_map[r] = raw
    n = 0
    for internal, raw in lora_map.items():
        if not internal.endswith(".lora_down.weight"):
            continue
        stem = internal[:-len(".lora_down.weight")]
        base, frac = stem, None
        if "@" in stem:
            base, f = stem.split("@", 1)
            num, span, den = (int(v) for v in f.split("/"))
            frac = (num, span, den)
        dst_ref = model_map.get(base + ".weight")
        if dst_ref is None:
            raise KeyError(f"lora tensor not found in model: {base}.weight")
        up_raw = lora_map.get(stem + ".lora_up.weight")
        if up_raw is None:
            raise KeyError(f"lora up tensor not found: {stem}.lora_up.weight")
        down = lora_store.read(raw, "f32")
        up = lora_store.read(up_raw, "f32")
        rank = down.shape[0]
        scale = 1.0
        if stem + ".scale" in lora_map:
            scale = float(lora_store.read(lora_map[stem + ".scale"], "f32").reshape(-1)[0])
        elif stem + ".alpha" in lora_map:
            scale = float(lora_store.read(lora_map[stem + ".alpha"], "f32").reshape(-1)[0]) / rank
        scale *= mult
        delta = (up.reshape(up.shape[0], -1) @
                 down.reshape(down.shape[0], -1) * scale)
        if frac is not None:
            # fused-weight row slice (diffusers-peft DiT LoRA)
            full = model_store.read(dst_ref.raw, "f32").copy()
            num_, span_, den_ = frac
            if full.shape[0] % den_:
                raise KeyError(f"lora slice {stem}: out dim "
                               f"{full.shape[0]} not divisible by {den_}")
            d = full.shape[0] // den_
            sl = slice(num_ * d, (num_ + span_) * d)
            full[sl] = full[sl] + delta.reshape(full[sl].shape)
        elif dst_ref.split is None:
            base = read_entry(model_store, dst_ref)
            full = base + delta.reshape(base.shape)
        else:
            # Fused qkv: patch the addressed third of the stacked raw tensor
            # (reference handles any named tensor, src/lora.c:36-78; our
            # split entries come from open_clip in_proj splitting).
            full = model_store.read(dst_ref.raw, "f32").copy()
            d = full.shape[0] // 3
            sl = slice(dst_ref.split * d, (dst_ref.split + 1) * d)
            full[sl] = full[sl] + delta.reshape(full[sl].shape)
        # full-tensor finite check (reference: src/lora.c:81-87)
        if not np.isfinite(full).all():
            raise FloatingPointError(f"NaN in LoRA result for {stem}")
        model_store.cache_set(dst_ref.raw, full)
        n += 1
    return n


def quantize_linear_weights(host_params: Dict[str, np.ndarray],
                            spec: Dict[str, ParamSpec],
                            bits: int = 8) -> int:
    """Replace eligible linear weights with int8 (``bits=8``) or packed
    int4 (``bits=4``) + scale pairs in place (weight-only quantized
    execution; see ops/q8_matmul.py and ops/q4_matmul.py).  Returns the
    number of weights quantized."""
    from .models.blocks import LINEAR_W
    from .ops.q8_matmul import KBLOCK, quantize_weight
    from .ops.q4_matmul import quantize_weight_q4
    n = 0
    for name, ps in list(spec.items()):
        if ps.kind != LINEAR_W or name not in host_params:
            continue
        k, _ = ps.shape
        if k % KBLOCK != 0:
            continue  # stays in the compute dtype
        w = np.asarray(host_params[name], np.float32)
        if bits == 4:
            q, scale = quantize_weight_q4(w)
            host_params[name + "_q4"] = q
        else:
            q, scale = quantize_weight(w)
            host_params[name + "_q8"] = q
        del host_params[name]
        host_params[name + "_scale"] = scale
        n += 1
    return n
