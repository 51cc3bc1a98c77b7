"""Test support: tiny model types and synthetic checkpoint writers.

Used by the test-suite and the native-shim tests; also handy for users who
want fast structural experiments without real weights.  Enable the tiny
model types at runtime by setting MLIS_TINY_MODELS=1 (read by the session
layer).
"""

import numpy as np
import jax.numpy as jnp

from mlimgsynth_tpu import nameconv
from mlimgsynth_tpu.api import ModelTypeDef
from mlimgsynth_tpu.models import blocks as B
from mlimgsynth_tpu.models import clip as clip_mod
from mlimgsynth_tpu.models import unet as unet_mod
from mlimgsynth_tpu.models import vae as vae_mod
from mlimgsynth_tpu.tokenizer import ClipParams

TINY_CLIP = ClipParams(n_vocab=49408, n_token=77, d_embed=32, n_interm=64,
                       n_head=4, n_layer=2)
TINY_UNET = unet_mod.UnetParams(
    n_ch=32, ch_mult=(1, 2), transf_depth=(1, 1), attn_res=(1, 2),
    n_head=4, n_te=64, n_ctx=32)
TINY_VAE = vae_mod.VaeParams(ch=32, ch_mult=(1, 1, 2, 2))

TINY_MODEL_TYPE = ModelTypeDef("sd1", TINY_CLIP, None, TINY_UNET, TINY_VAE,
                               64, 1)


def tiny_specs():
    spec = {}
    spec.update(B.trace_spec(
        lambda ctx, toks: clip_mod.clip_text_apply(ctx, toks, TINY_CLIP),
        jnp.zeros((1, 77), jnp.int32)))
    spec.update(B.trace_spec(
        lambda ctx, x, t, c: unet_mod.unet_apply(ctx, x, t, c, None,
                                                 TINY_UNET),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 32))))
    spec.update(B.trace_spec(
        lambda ctx, x: vae_mod.vae_encode_apply(ctx, x, TINY_VAE),
        jnp.zeros((1, 64, 64, 3))))
    spec.update(B.trace_spec(
        lambda ctx, x: vae_mod.vae_decode_apply(ctx, x, TINY_VAE),
        jnp.zeros((1, 8, 8, 4))))
    return spec


def spec_to_checkpoint_arrays(spec, seed=0, scale=0.05):
    """Random torch-layout arrays keyed by CompVis checkpoint names."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, ps in spec.items():
        cv = nameconv.internal_to_compvis(name)
        assert cv is not None, f"no CompVis name for {name}"
        back = nameconv.normalize_name(cv)
        assert back == name, f"roundtrip failed: {name} -> {cv} -> {back}"
        shape = ps.shape
        if ps.kind == B.LINEAR_W:
            shape = (shape[1], shape[0])
        elif ps.kind == B.CONV_W:
            kh, kw, ci, co = shape
            shape = (co, ci, kh, kw)
        out[cv] = (rng.standard_normal(shape) * scale).astype(np.float32)
    return out


def write_tiny_checkpoint(path, seed=0, dtype=np.float32):
    from mlimgsynth_tpu.io.tensorstore import save_arrays as save_file
    spec = tiny_specs()
    arrays = spec_to_checkpoint_arrays(spec, seed=seed)
    if dtype != np.float32:
        arrays = {k: v.astype(dtype) for k, v in arrays.items()}
    save_file(arrays, str(path))
    return arrays


def tiny_model_types():
    return {"sd1": TINY_MODEL_TYPE, "sd2": TINY_MODEL_TYPE_SD2,
            "sdxl": TINY_MODEL_TYPE_XL, "sd3": TINY_MODEL_TYPE_SD3,
            "flux_schnell": TINY_MODEL_TYPE_FLUX}


# ---------------------------------------------------------------------------
# SD2-like (v-param, OpenCLIP fused qkv) and SDXL-like (dual encoder) tinies
# ---------------------------------------------------------------------------

TINY_UNET_V = unet_mod.UnetParams(
    n_ch=32, ch_mult=(1, 2), transf_depth=(1, 1), attn_res=(1, 2),
    n_head=4, n_te=64, n_ctx=32, vparam=True)
TINY_MODEL_TYPE_SD2 = ModelTypeDef("sd2", TINY_CLIP, None, TINY_UNET_V,
                                   TINY_VAE, 64, 2)

TINY_CLIP2 = ClipParams(n_vocab=49408, n_token=77, d_embed=32, n_interm=64,
                        n_head=4, n_layer=2, tok_pad=0)
TINY_UNET_XL = unet_mod.UnetParams(
    n_ch=32, ch_mult=(1, 2), transf_depth=(1, 1), attn_res=(1, 2),
    n_head=4, n_te=64, n_ctx=64, ch_adm_in=32 + 1536, clip_norm=False,
    cond_label=True, uncond_empty_zero=True)
TINY_MODEL_TYPE_XL = ModelTypeDef("sdxl", TINY_CLIP, TINY_CLIP2,
                                  TINY_UNET_XL, TINY_VAE, 64, 2)


def _to_ckpt_layout(ps, arr_internal):
    """Model-layout random array -> torch checkpoint layout."""
    return arr_internal


def _random_for_spec(rng, ps, scale):
    shape = ps.shape
    if ps.kind == B.LINEAR_W:
        shape = (shape[1], shape[0])
    elif ps.kind == B.CONV_W:
        kh, kw, ci, co = shape
        shape = (co, ci, kh, kw)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def openclip_name(internal: str, root=None):
    """Internal clip/clip2 name -> OpenCLIP checkpoint layout
    (the layout SD2 and SDXL's second encoder use).  Attention q/k/v map to
    the fused in_proj tensors (handled by the caller).  ``root`` overrides
    the checkpoint prefix (e.g. the refiner's
    ``conditioner.embedders.0.model.``)."""
    pre = root or ("cond_stage_model.model."
                   if internal.startswith("clip.text.")
                   else "conditioner.embedders.1.model.")
    t = internal.split(".text.", 1)[1]
    if t == "embed.token.weight":
        return pre + "token_embedding.weight"
    if t == "embed.position.weight":
        return pre + "positional_embedding"
    if t == "text_proj":
        return pre + "text_projection"
    if t.startswith("ln_final."):
        return pre + t
    import re
    m = re.match(r"encoder\.layers\.(\d+)\.(.*)", t)
    if m:
        n, tail = m.group(1), m.group(2)
        tail = (tail.replace("norm1.", "ln_1.").replace("norm2.", "ln_2.")
                .replace("mlp.fc1.", "mlp.c_fc.")
                .replace("mlp.fc2.", "mlp.c_proj.")
                .replace("attn.out_proj.", "attn.out_proj."))
        return f"{pre}transformer.resblocks.{n}.{tail}"
    return None


def spec_to_openclip_arrays(spec, prefix, seed=0, scale=0.05, root=None):
    """Random arrays for a clip submodel in OpenCLIP layout with fused qkv."""
    import re
    rng = np.random.default_rng(seed)
    out = {}
    fused = {}
    for name, ps in spec.items():
        if not name.startswith(prefix):
            continue
        m = re.match(r"(.*\.attn)\.(q_proj|k_proj|v_proj)\.(weight|bias)$",
                     name)
        arr = _random_for_spec(rng, ps, scale)
        if m:
            key = (m.group(1), m.group(3))
            fused.setdefault(key, {})[m.group(2)] = arr
        else:
            cv = openclip_name(name, root)
            assert cv, name
            out[cv] = arr
    for (stem, kind), parts in fused.items():
        cat = np.concatenate([parts["q_proj"], parts["k_proj"],
                              parts["v_proj"]], axis=0)
        base = openclip_name(stem + ".out_proj.weight", root)
        base = base[:-len("out_proj.weight")]
        out[base + ("in_proj_weight" if kind == "weight" else "in_proj_bias")
            ] = cat
    return out


def write_checkpoint_sd2(path, seed=0):
    """Tiny v-param model with OpenCLIP-layout text encoder (fused qkv)."""
    from mlimgsynth_tpu.io.tensorstore import save_arrays as save_file
    spec = {}
    spec.update(B.trace_spec(
        lambda ctx, toks: clip_mod.clip_text_apply(ctx, toks, TINY_CLIP),
        jnp.zeros((1, 77), jnp.int32)))
    spec.update(B.trace_spec(
        lambda ctx, x, t, c: unet_mod.unet_apply(ctx, x, t, c, None,
                                                 TINY_UNET_V),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 32))))
    spec.update(B.trace_spec(
        lambda ctx, x: vae_mod.vae_encode_apply(ctx, x, TINY_VAE),
        jnp.zeros((1, 64, 64, 3))))
    spec.update(B.trace_spec(
        lambda ctx, x: vae_mod.vae_decode_apply(ctx, x, TINY_VAE),
        jnp.zeros((1, 8, 8, 4))))
    arrays = {}
    arrays.update(spec_to_openclip_arrays(spec, "clip.", seed=seed))
    rest = {k: v for k, v in spec.items() if not k.startswith("clip.")}
    arrays.update(spec_to_checkpoint_arrays(rest, seed=seed + 1))
    save_file(arrays, str(path))
    return arrays


def write_checkpoint_sdxl(path, seed=0):
    """Tiny dual-encoder model: CompVis clip + OpenCLIP clip2 (fused qkv,
    with text_projection), labeled UNet."""
    from mlimgsynth_tpu.io.tensorstore import save_arrays as save_file
    spec = {}
    spec.update(B.trace_spec(
        lambda ctx, toks: clip_mod.clip_text_apply(ctx, toks, TINY_CLIP),
        jnp.zeros((1, 77), jnp.int32)))
    spec.update(B.trace_spec(
        lambda ctx, toks: clip_mod.clip_text_apply(
            ctx, toks, TINY_CLIP2, feat_tok_idx=jnp.zeros((1,), jnp.int32),
            pre="clip2"),
        jnp.zeros((1, 77), jnp.int32)))
    spec.update(B.trace_spec(
        lambda ctx, x, t, c, l: unet_mod.unet_apply(ctx, x, t, c, l,
                                                    TINY_UNET_XL),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 64)),
        jnp.zeros((1, TINY_UNET_XL.ch_adm_in))))
    spec.update(B.trace_spec(
        lambda ctx, x: vae_mod.vae_encode_apply(ctx, x, TINY_VAE),
        jnp.zeros((1, 64, 64, 3))))
    spec.update(B.trace_spec(
        lambda ctx, x: vae_mod.vae_decode_apply(ctx, x, TINY_VAE),
        jnp.zeros((1, 8, 8, 4))))
    arrays = {}
    arrays.update(spec_to_openclip_arrays(spec, "clip2.", seed=seed))
    rest = {k: v for k, v in spec.items() if not k.startswith("clip2.")}
    arrays.update(spec_to_checkpoint_arrays(rest, seed=seed + 1))
    save_file(arrays, str(path))
    return arrays


def write_tiny_tae(path, seed=0, ch_z=4):
    """Tiny taesd-format file (diffusers AutoencoderTiny names, no prefix).
    ``ch_z=16`` makes the taesd3/taef1 flow-family shape."""
    from mlimgsynth_tpu.io.tensorstore import save_arrays as save_file
    from mlimgsynth_tpu.models import tae as tae_mod
    P = tae_mod.TaeParams(ch_inner=16, n_blk=1, ch_z=ch_z)
    spec = {}
    spec.update(B.trace_spec(
        lambda ctx, x: tae_mod.tae_encode_apply(ctx, x, P),
        jnp.zeros((1, 64, 64, 3))))
    spec.update(B.trace_spec(
        lambda ctx, x: tae_mod.tae_decode_apply(ctx, x, P),
        jnp.zeros((1, 8, 8, ch_z))))
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, ps in spec.items():
        assert name.startswith("tae.")
        arrays[name[4:]] = _random_for_spec(rng, ps, 0.05)
    save_file(arrays, str(path))
    return P


def write_tiny_inpaint_checkpoint(path, seed=0):
    """Tiny SD1-style checkpoint whose UNet takes 9 input channels
    (latent + repaint mask + masked-image latent), like
    sd-v1-5-inpainting.  The session auto-detects n_ch_in from the
    in.conv weight shape."""
    import dataclasses
    from mlimgsynth_tpu.io.tensorstore import save_arrays as save_file
    P9 = dataclasses.replace(TINY_UNET, n_ch_in=9)
    spec = {}
    spec.update(B.trace_spec(
        lambda ctx, toks: clip_mod.clip_text_apply(ctx, toks, TINY_CLIP),
        jnp.zeros((1, 77), jnp.int32)))
    spec.update(B.trace_spec(
        lambda ctx, x, t, c: unet_mod.unet_apply(ctx, x, t, c, None, P9),
        jnp.zeros((1, 8, 8, 9)), jnp.zeros((1,)), jnp.zeros((1, 77, 32))))
    spec.update(B.trace_spec(
        lambda ctx, x: vae_mod.vae_encode_apply(ctx, x, TINY_VAE),
        jnp.zeros((1, 64, 64, 3))))
    spec.update(B.trace_spec(
        lambda ctx, x: vae_mod.vae_decode_apply(ctx, x, TINY_VAE),
        jnp.zeros((1, 8, 8, 4))))
    arrays = spec_to_checkpoint_arrays(spec, seed=seed)
    save_file(arrays, str(path))
    return arrays


def tiny_cnet_spec(P=None):
    """Param spec of the tiny ControlNet matching TINY_UNET."""
    from mlimgsynth_tpu.models import controlnet as cnet_mod
    P = P or TINY_UNET

    def f(ctx, x, t, c):
        feat = cnet_mod.hint_apply(ctx, jnp.zeros((1, 64, 64, 3)), P)
        return cnet_mod.controlnet_apply(ctx, x, t, c, None, feat, P)

    return B.trace_spec(f, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                        jnp.zeros((1, 77, P.n_ctx)))


def write_tiny_controlnet(path, seed=7, scale=0.05, zero_scale=0.05):
    """Synthesize a tiny ControlNet file in the CompVis ``control_model.*``
    layout.  Real ControlNets have zero-INITIALIZED zc/mid.out convs that
    train away from zero; ``zero_scale`` keeps them nonzero so the control
    path has a visible effect in tests (pass 0.0 for a no-op ControlNet)."""
    from mlimgsynth_tpu.io.tensorstore import save_arrays as save_file
    spec = tiny_cnet_spec()
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, ps in spec.items():
        ck = nameconv.internal_to_cnet_ckpt(name)
        assert ck is not None, f"no control_model name for {name}"
        back = nameconv.normalize_cnet_name(ck)
        assert back == name, f"roundtrip failed: {name} -> {ck} -> {back}"
        s = zero_scale if (".zc." in name or ".mid.out." in name) else scale
        arrays[ck] = _random_for_spec(rng, ps, s)
    save_file(arrays, str(path))
    return arrays


def write_tiny_lora(path, target_names, spec, rank=2, seed=0, alpha=None):
    """LoRA file patching the given internal '<stem>.weight' tensors."""
    from mlimgsynth_tpu.io.tensorstore import save_arrays as save_file
    from mlimgsynth_tpu.nameconv import internal_to_compvis
    rng = np.random.default_rng(seed)
    arrays = {}
    for stem in target_names:
        ps = spec[stem + ".weight"]
        if ps.kind == B.LINEAR_W:
            out_d, in_d = ps.shape[1], ps.shape[0]
        else:
            kh, kw, ci, co = ps.shape
            out_d, in_d = co, ci * kh * kw
        cv = internal_to_compvis(stem + ".weight")
        assert cv
        base = "lora_" + cv[:-len(".weight")]
        arrays[base + ".lora_down.weight"] = \
            (rng.standard_normal((rank, in_d)) * 0.1).astype(np.float32)
        arrays[base + ".lora_up.weight"] = \
            (rng.standard_normal((out_d, rank)) * 0.1).astype(np.float32)
        if alpha is not None:
            arrays[base + ".alpha"] = np.array(alpha, np.float32)
    save_file(arrays, str(path))
    return arrays


# ---------------------------------------------------------------------------
# SDXL-refiner-like tiny (single OpenCLIP tower + aesthetic-score label)
# ---------------------------------------------------------------------------

TINY_UNET_REFINER = unet_mod.UnetParams(
    n_ch=32, ch_mult=(1, 2), transf_depth=(2, 2), attn_res=(2,),
    n_head=4, n_te=64, n_ctx=32, ch_adm_in=32 + 5 * 256, clip_norm=False,
    cond_label=True, uncond_empty_zero=True)
TINY_MODEL_TYPE_REFINER = ModelTypeDef(
    "sdxl_refiner", TINY_CLIP2, None, TINY_UNET_REFINER, TINY_VAE, 64, 2)


def write_checkpoint_refiner(path, seed=0):
    """Tiny SDXL-refiner-like model: a single OpenCLIP-layout tower under
    ``conditioner.embedders.0.model.`` (fused qkv, with text_projection),
    labeled UNet with no level-0 attention."""
    from mlimgsynth_tpu.io.tensorstore import save_arrays as save_file
    spec = {}
    spec.update(B.trace_spec(
        lambda ctx, toks: clip_mod.clip_text_apply(
            ctx, toks, TINY_CLIP2, feat_tok_idx=jnp.zeros((1,), jnp.int32)),
        jnp.zeros((1, 77), jnp.int32)))
    spec.update(B.trace_spec(
        lambda ctx, x, t, c, l: unet_mod.unet_apply(ctx, x, t, c, l,
                                                    TINY_UNET_REFINER),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 32)),
        jnp.zeros((1, TINY_UNET_REFINER.ch_adm_in))))
    spec.update(B.trace_spec(
        lambda ctx, x: vae_mod.vae_encode_apply(ctx, x, TINY_VAE),
        jnp.zeros((1, 64, 64, 3))))
    spec.update(B.trace_spec(
        lambda ctx, x: vae_mod.vae_decode_apply(ctx, x, TINY_VAE),
        jnp.zeros((1, 8, 8, 4))))
    arrays = spec_to_openclip_arrays(
        spec, "clip.", seed=seed, root="conditioner.embedders.0.model.")
    rest = {k: v for k, v in spec.items() if not k.startswith("clip.")}
    arrays.update(spec_to_checkpoint_arrays(rest, seed=seed + 1))
    save_file(arrays, str(path))
    return arrays


# ---------------------------------------------------------------------------
# SD3-like tiny (MMDiT rectified flow, dual HF-layout towers, 4-ch flow VAE)
# ---------------------------------------------------------------------------

def _tiny_mmdit():
    from mlimgsynth_tpu.models import mmdit as mmdit_mod
    return mmdit_mod.MmditParams(
        depth=2, d_model=32, n_head=2, patch=2, n_ch_in=4, n_ch_out=4,
        d_ctx_in=80, d_pooled=64, pos_embed_max=8, d_t_embed=16,
        n_ctx=80, ch_adm_in=64)


TINY_MMDIT = _tiny_mmdit()


def _tiny_mmdit_x():
    import dataclasses
    return dataclasses.replace(_tiny_mmdit(), qk_norm=True,
                               x_self_attn_layers=(0,))


TINY_MMDIT_X = _tiny_mmdit_x()
TINY_VAE_SD3 = vae_mod.VaeParams(ch=32, ch_mult=(1, 1, 2, 2),
                                 scale_factor=1.5305, shift_factor=0.0609,
                                 quant_conv=False)
TINY_MODEL_TYPE_SD3 = ModelTypeDef("sd3", TINY_CLIP, TINY_CLIP2, TINY_MMDIT,
                                   TINY_VAE_SD3, 64, 2)


def _sd3_ckpt_name(internal: str):
    """Internal name -> sd3 single-file checkpoint name (the layout
    normalize_name's SD3 rules consume).  text_proj returns a marker tuple
    ('tproj', name) — the caller writes the TRANSPOSED Linear weight."""
    if internal.startswith("mmdit."):
        return "model.diffusion_model." + internal[len("mmdit."):]
    if internal.startswith("clip.text.") or internal.startswith("clip2.text."):
        tower = "clip_l" if internal.startswith("clip.") else "clip_g"
        t = "text_model." + internal.split(".text.", 1)[1]
        t = t.replace("embed.position.", "embeddings.position_embedding.")
        t = t.replace("embed.token.", "embeddings.token_embedding.")
        t = t.replace(".norm1.", ".layer_norm1.")
        t = t.replace(".norm2.", ".layer_norm2.")
        t = t.replace(".attn.", ".self_attn.")
        t = t.replace("text_model.ln_final.", "text_model.final_layer_norm.")
        pre = f"text_encoders.{tower}.transformer."
        if t == "text_model.text_proj":
            return ("tproj", pre + "text_model.text_projection.weight")
        return pre + t
    cv = nameconv.internal_to_compvis(internal)
    return cv  # vae.*


def write_checkpoint_sd3(path, seed=0, P=None):
    """Tiny SD3-like single-file checkpoint: MMDiT + dual HF-layout text
    towers (incl. Linear-stored text_projection) + 4-channel flow VAE
    (shift factor, no quant convs).  ``P`` swaps the MMDiT geometry (e.g.
    TINY_MMDIT_X for an SD3.5-medium-style dual-attention file)."""
    from mlimgsynth_tpu.io.tensorstore import save_arrays as save_file
    from mlimgsynth_tpu.models import mmdit as mmdit_mod
    P = P or TINY_MMDIT
    spec = {}
    spec.update(B.trace_spec(
        lambda ctx, toks: clip_mod.clip_text_apply(
            ctx, toks, TINY_CLIP, feat_tok_idx=jnp.zeros((1,), jnp.int32)),
        jnp.zeros((1, 77), jnp.int32)))
    spec.update(B.trace_spec(
        lambda ctx, toks: clip_mod.clip_text_apply(
            ctx, toks, TINY_CLIP2, feat_tok_idx=jnp.zeros((1,), jnp.int32),
            pre="clip2"),
        jnp.zeros((1, 77), jnp.int32)))
    spec.update(B.trace_spec(
        lambda ctx, x, t, c, y: mmdit_mod.mmdit_apply(ctx, x, t, c, y, P),
        jnp.zeros((1, 8, 8, P.n_ch_in)), jnp.zeros((1,)),
        jnp.zeros((1, 10, P.d_ctx_in)), jnp.zeros((1, P.d_pooled))))
    spec.update(B.trace_spec(
        lambda ctx, x: vae_mod.vae_encode_apply(ctx, x, TINY_VAE_SD3),
        jnp.zeros((1, 64, 64, 3))))
    spec.update(B.trace_spec(
        lambda ctx, x: vae_mod.vae_decode_apply(ctx, x, TINY_VAE_SD3),
        jnp.zeros((1, 8, 8, 4))))
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, ps in spec.items():
        ck = _sd3_ckpt_name(name)
        assert ck is not None, f"no sd3 checkpoint name for {name}"
        arr = _random_for_spec(rng, ps, 0.05)
        if isinstance(ck, tuple):       # HF Linear-stored text_projection
            ck = ck[1]
            arr = np.ascontiguousarray(arr.T)
        arrays[ck] = arr
    save_file(arrays, str(path))
    return arrays


def write_tiny_t5(path, seed=0):
    """Tiny T5 v1.1 encoder file in the bare HF layout (shared.weight,
    encoder.block.N...) for the --t5 option."""
    from mlimgsynth_tpu.io.tensorstore import save_arrays as save_file
    from mlimgsynth_tpu.models import t5 as t5_mod
    P = t5_mod.T5Params(d_model=32, d_kv=8, n_head=4, d_ff=36, n_layer=2,
                        n_vocab=64)
    spec = B.trace_spec(
        lambda ctx, toks: t5_mod.t5_encode_apply(ctx, toks, P),
        jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, ps in spec.items():
        assert name.startswith("t5.")
        arrays[name[3:]] = _random_for_spec(rng, ps, 0.05)
    save_file(arrays, str(path))
    return P


def write_tiny_t5_tokenizer(path):
    """Minimal tokenizers-format WordLevel tokenizer for T5 tests."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    for i, w in enumerate(("a", "cat", "dog", "photo", "of", "the", "cats",
                           "more", "flow", "model", "x", "q")):
        vocab[w] = 3 + i
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(path))
    return vocab


# ---------------------------------------------------------------------------
# Flux-like tiny (double/single-stream DiT, aux clip/vae files)
# ---------------------------------------------------------------------------

def _tiny_flux(guidance=False):
    from mlimgsynth_tpu.models import flux as flux_mod
    return flux_mod.FluxParams(
        depth_double=1, depth_single=1, d_model=32, n_head=2,
        axes_dim=(4, 6, 6), n_ch_in=16, n_ch_out=16, d_ctx_in=48,
        d_pooled=32, n_ctx=48, ch_adm_in=32, guidance_embed=guidance,
        dynamic_shift=guidance)


TINY_FLUX_SCHNELL = _tiny_flux(False)
TINY_FLUX_DEV = _tiny_flux(True)
TINY_VAE_FLUX = vae_mod.VaeParams(ch=32, ch_mult=(1, 1, 2, 2),
                                  scale_factor=0.3611, shift_factor=0.1159,
                                  quant_conv=False)
TINY_MODEL_TYPE_FLUX = ModelTypeDef("flux_schnell", TINY_CLIP, None,
                                    TINY_FLUX_SCHNELL, TINY_VAE_FLUX, 64, 1)


def _hf_clip_name(internal):
    """Internal clip.text.* -> bare HF CLIPTextModel tail (text_model.*)."""
    t = "text_model." + internal.split(".text.", 1)[1]
    t = t.replace("embed.position.", "embeddings.position_embedding.")
    t = t.replace("embed.token.", "embeddings.token_embedding.")
    t = t.replace(".norm1.", ".layer_norm1.")
    t = t.replace(".norm2.", ".layer_norm2.")
    t = t.replace(".attn.", ".self_attn.")
    t = t.replace("text_model.ln_final.", "text_model.final_layer_norm.")
    return t


def write_tiny_flux_files(dirpath, P=None, seed=0, return_arrays=False):
    """Tiny flux distribution: transformer-only model file (bare
    double_blocks.* tails), a bare-HF clip file (text_model.*, no
    text_projection — flux pools without it) and a bare VAE file
    (encoder./decoder.).  Returns {model, clip, vae} paths; with
    ``return_arrays`` also the {internal_name: ckpt-layout array} dict
    (for torch-transcription oracles)."""
    import os
    from mlimgsynth_tpu.io.tensorstore import save_arrays as save_file
    from mlimgsynth_tpu.models import flux as flux_mod
    P = P or TINY_FLUX_SCHNELL
    rng = np.random.default_rng(seed)

    internal = {}
    spec_f = B.trace_spec(
        lambda ctx, x, t, c, y: flux_mod.flux_apply(
            ctx, x, t, c, y, P,
            guidance=(jnp.zeros((1,)) if P.guidance_embed else None)),
        jnp.zeros((1, 8, 8, P.n_ch_in // 4)), jnp.zeros((1,)),
        jnp.zeros((1, 7, P.d_ctx_in)), jnp.zeros((1, P.d_pooled)))
    model = {}
    for name, ps in spec_f.items():
        internal[name] = model[name[len("flux."):]] = \
            _random_for_spec(rng, ps, 0.05)

    spec_c = B.trace_spec(
        lambda ctx, toks: clip_mod.clip_text_apply(
            ctx, toks, TINY_CLIP, feat_tok_idx=jnp.zeros((1,), jnp.int32),
            feat_proj=False),
        jnp.zeros((1, 77), jnp.int32))
    clip = {}
    for name, ps in spec_c.items():
        internal[name] = clip[_hf_clip_name(name)] = \
            _random_for_spec(rng, ps, 0.05)

    spec_v = {}
    spec_v.update(B.trace_spec(
        lambda ctx, x: vae_mod.vae_encode_apply(ctx, x, TINY_VAE_FLUX),
        jnp.zeros((1, 64, 64, 3))))
    spec_v.update(B.trace_spec(
        lambda ctx, x: vae_mod.vae_decode_apply(ctx, x, TINY_VAE_FLUX),
        jnp.zeros((1, 8, 8, 4))))
    vae = {}
    for name, ps in spec_v.items():
        cv = nameconv.internal_to_compvis(name)
        internal[name] = vae[cv[len("first_stage_model."):]] = \
            _random_for_spec(rng, ps, 0.05)

    paths = {}
    for key, arrays in (("model", model), ("clip", clip), ("vae", vae)):
        p = os.path.join(str(dirpath), f"tiny-flux-{key}.safetensors")
        save_file(arrays, p)
        paths[key] = p
    if return_arrays:
        return paths, internal
    return paths


# ---------------------------------------------------------------------------
# Synthetic checkpoints at any width (full-size models for on-card smoke runs)
# ---------------------------------------------------------------------------

def synthetic_init(rng, name: str, ps):
    """Seeded random array for one param, in checkpoint (torch) layout.

    Matrices and convs draw N(0, 1/fan_in) so activations keep their scale
    through a full-depth stack; norm scales are 1 + small noise, biases and
    embeddings small noise.  float32."""
    shape = ps.shape
    if ps.kind == B.LINEAR_W:
        shape = (shape[1], shape[0])
        std = 1.0 / np.sqrt(shape[1])
    elif ps.kind == B.CONV_W:
        kh, kw, ci, co = shape
        shape = (co, ci, kh, kw)
        std = 1.0 / np.sqrt(ci * kh * kw)
    else:
        std = 0.02
    a = rng.standard_normal(shape, dtype=np.float32)
    a *= np.float32(std)
    if ps.kind == B.VEC and not name.endswith(".bias"):
        a += np.float32(1.0)
    return a


def model_specs(mt):
    """{component: param spec} of a model type, traced as the session
    traces them (clip towers with the feature head where the family has
    one, the denoiser, the VAE)."""
    from mlimgsynth_tpu.models import flux as flux_mod
    from mlimgsynth_tpu.models import mmdit as mmdit_mod
    P = mt.unet_p
    flux = getattr(P, "flux", False)
    flow = getattr(P, "flow", False)
    idx = jnp.zeros((1,), jnp.int32)
    out = {}
    out["clip"] = B.trace_spec(
        lambda ctx, toks: clip_mod.clip_text_apply(
            ctx, toks, mt.clip_p, feat_tok_idx=idx if (flux or flow) else None,
            feat_proj=not flux),
        jnp.zeros((1, mt.clip_p.n_token), jnp.int32))
    if mt.clip2_p is not None:
        out["clip2"] = B.trace_spec(
            lambda ctx, toks: clip_mod.clip_text_apply(
                ctx, toks, mt.clip2_p, feat_tok_idx=idx, pre="clip2"),
            jnp.zeros((1, mt.clip2_p.n_token), jnp.int32))
    if flux:
        out["unet"] = B.trace_spec(
            lambda ctx, x, t, c, y: flux_mod.flux_apply(
                ctx, x, t, c, y, P,
                guidance=(jnp.zeros((1,)) if P.guidance_embed else None)),
            jnp.zeros((1, 8, 8, P.n_ch_in // 4)), jnp.zeros((1,)),
            jnp.zeros((1, 7, P.d_ctx_in)), jnp.zeros((1, P.d_pooled)))
    elif flow:
        out["unet"] = B.trace_spec(
            lambda ctx, x, t, c, y: mmdit_mod.mmdit_apply(ctx, x, t, c, y, P),
            jnp.zeros((1, 8, 8, P.n_ch_in)), jnp.zeros((1,)),
            jnp.zeros((1, 10, P.d_ctx_in)), jnp.zeros((1, P.d_pooled)))
    else:
        label = jnp.zeros((1, P.ch_adm_in)) if P.ch_adm_in else None
        out["unet"] = B.trace_spec(
            lambda ctx, x, t, c: unet_mod.unet_apply(ctx, x, t, c, label, P),
            jnp.zeros((1, 8, 8, P.n_ch_in)), jnp.zeros((1,)),
            jnp.zeros((1, 77, P.n_ctx)))
    V = mt.vae_p
    out["vae"] = B.trace_spec(
        lambda ctx, x: vae_mod.vae_encode_apply(ctx, x, V),
        jnp.zeros((1, 64, 64, 3)))
    out["vae"].update(B.trace_spec(
        lambda ctx, x: vae_mod.vae_decode_apply(ctx, x, V),
        jnp.zeros((1, 8, 8, V.ch_z))))
    return out


def _synthetic_ckpt_name(family: str, comp: str, name: str):
    """Internal name -> (file, checkpoint name, transpose) in the layout
    the family's published files use: one CompVis/SGM file for sd1/sdxl
    (SDXL's bigG tower in OpenCLIP layout, fused by the caller), the sd3
    single file, and Flux's separate model/clip/vae files."""
    if family == "flux_schnell" or family == "flux_dev":
        if comp == "unet":
            return "model", name[len("flux."):], False
        if comp == "clip":
            return "clip", _hf_clip_name(name), False
        return ("vae", nameconv.internal_to_compvis(name)[
            len("first_stage_model."):], False)
    if family.startswith("sd3"):
        ck = _sd3_ckpt_name(name)
        if isinstance(ck, tuple):
            return "model", ck[1], True
        return "model", ck, False
    if comp == "clip2":
        return "model", openclip_name(name), False
    return "model", nameconv.internal_to_compvis(name), False


def write_synthetic_model(dirpath, family: str, mt, seed: int = 0,
                          dtype=np.float16):
    """Write a seeded random checkpoint of model type ``mt`` (any width, up
    to the published ones) in ``family``'s file layout with the repo's own
    safetensors writer.  Returns {session option: path} ("model", plus
    "clip" and "vae" for Flux's separate files)."""
    import os
    import re
    from mlimgsynth_tpu.io.tensorstore import save_arrays
    rng = np.random.default_rng(seed)
    files = {}
    for comp, spec in model_specs(mt).items():
        fused = {}
        for name in sorted(spec):
            arr = synthetic_init(rng, name, spec[name])
            m = re.match(r"(.*\.attn)\.(q_proj|k_proj|v_proj)\.(weight|bias)$",
                         name) if comp == "clip2" and not \
                family.startswith("sd3") else None
            if m:       # OpenCLIP stores q/k/v fused as in_proj
                fused.setdefault((m.group(1), m.group(3)), {})[
                    m.group(2)] = arr
                continue
            f, ck, tr = _synthetic_ckpt_name(family, comp, name)
            assert ck is not None, f"no checkpoint name for {name}"
            files.setdefault(f, {})[ck] = np.ascontiguousarray(
                arr.T if tr else arr).astype(dtype)
        for (stem, kind), parts in fused.items():
            base = openclip_name(stem + ".out_proj.weight")[
                :-len("out_proj.weight")]
            files["model"][base + ("in_proj_weight" if kind == "weight"
                                   else "in_proj_bias")] = np.concatenate(
                [parts["q_proj"], parts["k_proj"], parts["v_proj"]],
                axis=0).astype(dtype)
    paths = {}
    for f, arrays in files.items():
        p = os.path.join(str(dirpath), f"synthetic-{family}-{f}.safetensors")
        save_arrays(arrays, p)
        paths[f] = p
    return paths
