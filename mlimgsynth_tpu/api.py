"""Session / library API: the JAX counterpart of ``libmlimgsynth``.

Mirrors the reference session semantics (reference: src/mlimgsynth.c,
include/mlimgsynth.h): lazy setup with ready-flags, the 35-option config
system with string parsing, model-type identification and per-type defaults,
txt2img / img2img / inpainting generation, SDXL dual-encoder conditioning,
LoRA loading (incl. ``<lora:...>`` prompt tags), named tensor slots, progress
callbacks, A1111-style infotext.

Array convention at this boundary: float32 numpy NCHW ``[n,c,h,w]`` (the
row-major view of the reference's ggml layout) so TENSOR files, Philox draw
order and slice semantics are byte-compatible.  Device code is NHWC; the
conversion happens inside the jitted wrappers.
"""
from __future__ import annotations

import functools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import __version__ as _pkg_version
from . import prompt as prompt_mod
from . import tokenizer as tok_mod
from . import weights as weights_mod
from .io.tensorstore import TensorStore
from .rng import RngPhilox
from .sampling.sampler import SamplerConfig, make_plan, run_sampler
from .sampling.solvers import get_solver
from .utils import image as image_mod
from .utils.log import LVL_DEBUG, g_logger as log


class MlisError(Exception):
    """Error with a negative code matching MLIS_ErrCode
    (include/mlimgsynth.h:68-77)."""
    E_UNKNOWN = -1
    E_VERSION = -2
    E_UNK_OPT = -3
    E_OPT_VALUE = -4
    E_PROMPT_PARSE = -5
    E_FILE_NOT_FOUND = -6
    E_NAN = -7
    E_IMAGE = -8

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


class Aborted(Exception):
    pass


# Stages (include/mlimgsynth.h MLIS_Stage)
STAGE_IDLE = 0
STAGE_COND_ENCODE = 1
STAGE_IMAGE_ENCODE = 2
STAGE_IMAGE_DECODE = 3
STAGE_DENOISE = 4

STAGE_NAMES = ["idle", "cond_encode", "image_encode", "image_decode",
               "denoise"]

METHOD_NAMES = ["none", "euler", "heun", "taylor3", "dpmpp2m",
                "dpmpp2s", "dpmpp2m_sde", "lcm", "unipc"]
SCHED_NAMES = ["none", "uniform", "karras", "lcm",
               "exponential", "sgm_uniform", "beta"]
MODEL_TYPE_NAMES = ["none", "sd1", "sd2", "sdxl", "sdxl_refiner", "sd3",
                    "sd35_large", "sd35_medium", "flux_schnell", "flux_dev"]

# Tensor-use flags (include/mlimgsynth.h:277-283)
TUF_IMAGE = 1
TUF_MASK = 2
TUF_LATENT = 4
TUF_LMASK = 8
TUF_CONDITIONING = 16


def _id_cmp(a: str, b: str) -> bool:
    """Case/hyphen-insensitive option/enum name compare, '+' matches 'p'
    (reference: strsl_cmpz_id, src/mlimgsynth.c:157-170)."""
    def norm(s):
        return s.lower().replace("-", "_").replace("+", "p")
    return norm(a) == norm(b)


def _enum_from_str(names: List[str], s: str) -> int:
    for i, n in enumerate(names):
        if _id_cmp(s, n):
            return i
    return -1


@dataclass
class ModelTypeDef:
    name: str
    clip_p: tok_mod.ClipParams
    clip2_p: Optional[tok_mod.ClipParams]
    unet_p: "object"
    vae_p: "object"
    default_dim: int
    default_clip_skip: int


def _model_types():
    if os.environ.get("MLIS_TINY_MODELS"):
        from .testing import tiny_model_types
        return tiny_model_types()
    from .models import clip as clip_mod
    from .models import flux as flux_mod
    from .models import mmdit as mmdit_mod
    from .models import unet as unet_mod
    from .models import vae as vae_mod
    return {
        "sd1": ModelTypeDef("sd1", clip_mod.CLIP_VIT_L_14, None,
                            unet_mod.UNET_SD1, vae_mod.VAE_SD1, 512, 1),
        "sd2": ModelTypeDef("sd2", clip_mod.CLIP_VIT_H_14, None,
                            unet_mod.UNET_SD2, vae_mod.VAE_SD1, 768, 2),
        "sdxl": ModelTypeDef("sdxl", clip_mod.CLIP_VIT_L_14,
                             clip_mod.CLIP_VIT_BIGG_14, unet_mod.UNET_SDXL,
                             vae_mod.VAE_SDXL, 1024, 2),
        # beyond-reference: SDXL-refiner — single bigG tower ("clip."
        # internally; checkpoint conditioner.embedders.0.model.*), label =
        # pooled feature + size/aesthetic embeddings (2560)
        "sdxl_refiner": ModelTypeDef(
            "sdxl_refiner", clip_mod.CLIP_VIT_BIGG_14, None,
            unet_mod.UNET_SDXL_REFINER, vae_mod.VAE_SDXL, 1024, 2),
        # beyond-reference: SD3 family — MMDiT rectified-flow transformer,
        # dual CLIP conditioning (L + bigG penultimate hidden concat, padded
        # to the t5 width; pooled projections as the adaLN vector), optional
        # T5-XXL context (--t5), 16-channel VAE
        "sd3": ModelTypeDef("sd3", clip_mod.CLIP_VIT_L_14,
                            clip_mod.CLIP_VIT_BIGG_14,
                            mmdit_mod.MMDIT_SD3_MEDIUM, vae_mod.VAE_SD3,
                            1024, 2),
        "sd35_large": ModelTypeDef("sd35_large", clip_mod.CLIP_VIT_L_14,
                                   clip_mod.CLIP_VIT_BIGG_14,
                                   mmdit_mod.MMDIT_SD35_LARGE,
                                   vae_mod.VAE_SD3, 1024, 2),
        "sd35_medium": ModelTypeDef("sd35_medium", clip_mod.CLIP_VIT_L_14,
                                    clip_mod.CLIP_VIT_BIGG_14,
                                    mmdit_mod.MMDIT_SD35_MEDIUM,
                                    vae_mod.VAE_SD3, 1024, 2),
        # beyond-reference: Flux.1 — double/single-stream rectified-flow
        # DiT with RoPE; T5 context (--t5) + CLIP-L pooled conditioning;
        # dev replaces CFG with an embedded guidance input.  Weights
        # usually ship as transformer-only files: pair with --clip/--vae.
        "flux_schnell": ModelTypeDef("flux_schnell", clip_mod.CLIP_VIT_L_14,
                                     None, flux_mod.FLUX_SCHNELL,
                                     vae_mod.VAE_FLUX, 1024, 1),
        "flux_dev": ModelTypeDef("flux_dev", clip_mod.CLIP_VIT_L_14, None,
                                 flux_mod.FLUX_DEV, vae_mod.VAE_FLUX,
                                 1024, 1),
    }


def _split_args(value: str) -> List[str]:
    """Split a ','-separated option value with double-quote quoting
    (reference: value_str_next, src/mlimgsynth.c:845-863)."""
    out, cur, i, n = [], [], 0, len(value)
    in_q = False
    while i < n:
        c = value[i]
        if in_q:
            if c == '"':
                in_q = False
            else:
                cur.append(c)
        elif c == '"':
            in_q = True
        elif c == ",":
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    out.append("".join(cur))
    return out



def _int(v, default=0):
    if isinstance(v, str):
        v = v.strip()
        return default if v == "" else int(v)
    return int(v)


def _float(v, default=0.0):
    if isinstance(v, str):
        v = v.strip()
        return default if v == "" else float(v)
    return float(v)


_BOOL = {"true": 1, "yes": 1, "y": 1, "1": 1,
         "false": 0, "no": 0, "n": 0, "0": 0}


def _parse_bool(s: str) -> int:
    v = _BOOL.get(s.strip().lower())
    if v is None:
        raise ValueError(f"invalid boolean '{s}'")
    return v


class MLImgSynth:
    """The session object (reference: MLIS_Ctx)."""

    def __init__(self):
        import jax.numpy as jnp
        self.c = {
            "backend": "", "be_params": "",
            "model": "", "tae": "", "lora_dir": "", "embed_dir": "",
            "aux_dir": "",
            "prompt_raw": "", "nprompt_raw": "",
            "width": 0, "height": 0, "clip_skip": 0,
            "cfg_scale": 7.0, "cfg_rescale": 0.0,
            "slg_scale": 0.0, "slg_layers": "7,8,9",
            "slg_start": 0.01, "slg_end": 0.2,
            "pag_scale": 0.0, "pag_start": 0.0, "pag_end": 1.0,
            "method": "euler", "scheduler": "uniform",
            "steps": 0, "f_t_ini": 1.0, "f_t_end": 0.0,
            "s_noise": 0.0, "s_ancestral": 0.0,
            "n_batch": 1, "vae_tile": 0, "unet_split": False,
            "tp": 1, "dp": 1, "sp": 1, "pp": 1,
            "threads": 0, "dump_flags": 0,
            "no_decode": False, "no_prompt_parse": False,
            "model_type": "", "weight_type": "",
            "tuflags": 0,
            "control_net": "", "control_strength": 1.0,
            "hires_fix": 0.0, "hires_denoise": 0.7, "hires_steps": 0,
            "upscaler": "", "hires_upscaler": "",
            "subseed": -1, "subseed_strength": 0.0,
            "inpaint_full_res": 0, "inpaint_full_res_padding": 32,
            "mask_blur": 0.0, "deepcache": 0, "tiling": False,
            "freeu": "",
            "refiner": "", "refiner_switch": 0.8,
            "t5": "", "t5_tokenizer": "", "t5_tokens": 77,
            "clip": "", "vae": "",
        }
        self.prompt = prompt_mod.PromptText()
        self.nprompt = prompt_mod.PromptText()
        self.loras: List[Tuple[str, float, bool]] = []  # (path, mult, from_prompt)
        self.rng = RngPhilox(seed=int(time.time() * 1000) & 0xFFFFFFFFFFFF)
        self.callback: Optional[Callable] = None
        self.error_handler: Optional[Callable] = None
        # optional per-step latent observer (i_step, latent_nchw);
        # forces step-at-a-time execution (used by tools/latent_trace)
        self.step_observer: Optional[Callable] = None
        self.errstr = ""
        self.infotext = ""
        # named tensor slots (NCHW numpy): reference MLIS_TensorId
        self.tensors: Dict[str, Optional[np.ndarray]] = {
            k: None for k in ("image", "mask", "latent", "lmask", "cond",
                              "label", "ncond", "nlabel",
                              "tmp0", "tmp1", "tmp2", "tmp3")}
        self.progress = {"stage": STAGE_IDLE, "step": 0, "step_end": 0,
                         "nfe": 0, "step_time": 0.0}
        # per-submodel stats (reference: MLCtxInfo, src/mlblock.h:75-79)
        self.stats: Dict[str, dict] = {}
        # runtime
        self._dtype = jnp.bfloat16
        self._store: Optional[TensorStore] = None
        self._name_map = None
        self._tae_p = None  # inferred TaeParams (16-ch for taesd3/taef1)
        self._mt: Optional[ModelTypeDef] = None
        self._params: Dict[str, dict] = {}   # submodel -> device params
        # textual-inversion registry: name -> {"ids": [int], "tables":
        # {submodel: np.ndarray [k, d_embed]}}; appended to the CLIP token
        # tables in registration order, token id = n_vocab + row offset
        self._embeds: Dict[str, dict] = {}
        self._embed_order: List[str] = []
        self._mesh = None                    # jax.sharding.Mesh when tp/dp>1
        self._in_hires = False               # inside a highres-fix stage
        self._in_refiner = False             # inside an ensemble stage
        self._refiner: Optional["MLImgSynth"] = None  # stage-2 sub-session
        self._refiner_path = ""
        self._t5_p = None                    # inferred T5 geometry
        self._upscaler = None                # (device params, EsrganParams)
        self._in_fullres = False             # inside a crop-inpaint stage
        self._subseed_eff = -1               # effective variation seed
        self._keep_tail = False              # stop at sigma(f_t_end)
        self._noise_add = True               # add noise at sigma(f_t_ini)
        self._ready = set()
        self._nfe = 0
        self._wtype_set = False
        self._model_type_set = False
        self._weights_q8 = False
        self._weights_qbits = 8
        # pipeline entry points are serialized; sessions are safe to
        # drive from multiple threads (the reference is documented
        # not thread-safe, include/mlimgsynth.h:9)
        self._lock = threading.RLock()

    # ------------------------------------------------------------------
    # Options (reference: src/mlimgsynth_options_set.c.h)
    # ------------------------------------------------------------------

    def option_set(self, name: str, *args) -> None:
        try:
            self._option_set(name, *args)
        except MlisError:
            raise
        except Exception as e:
            raise MlisError(MlisError.E_OPT_VALUE,
                            f"invalid argument for option '{name}': {e}")

    def _find_option(self, name: str) -> str:
        for opt in _OPTIONS:
            if _id_cmp(name, opt):
                return opt
        raise MlisError(MlisError.E_UNK_OPT, f"unknown option '{name}'")

    def _option_set(self, name: str, *args) -> None:
        opt = self._find_option(name)
        c = self.c
        if opt == "backend":
            c["backend"] = str(args[0]) if args else ""
            c["be_params"] = str(args[1]) if len(args) > 1 else ""
            self._ready.discard("backend")
        elif opt == "model":
            c["model"] = str(args[0])
            self._ready.discard("model")
        elif opt == "tae":
            c["tae"] = str(args[0]) if args else ""
        elif opt == "lora_dir":
            c["lora_dir"] = str(args[0])
        elif opt == "embed_dir":
            if str(args[0]) != c["embed_dir"]:
                c["embed_dir"] = str(args[0])
                self._embeds_clear()
        elif opt == "lora":
            path = str(args[0])
            mult = float(args[1]) if len(args) > 1 and args[1] != "" else 1.0
            self._lora_add(path, mult, from_prompt=False)
        elif opt == "lora_clear":
            self.loras.clear()
            self._ready.discard("loras")
        elif opt == "prompt":
            self._prompt_set("prompt_raw", self.prompt, str(args[0]))
        elif opt == "nprompt":
            self._prompt_set("nprompt_raw", self.nprompt, str(args[0]))
        elif opt == "no_prompt_parse":
            c["no_prompt_parse"] = bool(_parse_bool(str(args[0]))
                                        if isinstance(args[0], str)
                                        else args[0])
        elif opt == "image_dim":
            c["width"] = _int(args[0])
            c["height"] = (_int(args[1]) if len(args) > 1 and
                           str(args[1]) != "" else c["width"])
        elif opt == "batch_size":
            c["n_batch"] = max(1, _int(args[0], 1))
        elif opt == "clip_skip":
            c["clip_skip"] = _int(args[0])
        elif opt == "cfg_scale":
            c["cfg_scale"] = _float(args[0], 7.0)
        elif opt == "method":
            m = args[0]
            if isinstance(m, str) and m.strip() == "":
                return
            if isinstance(m, str):
                s = m
                if s.lower().endswith("_a") or s.lower().endswith("-a"):
                    s = s[:-2]
                    c["s_ancestral"] = 1.0
                i = _enum_from_str(METHOD_NAMES, s)
                if i <= 0:
                    raise MlisError(MlisError.E_OPT_VALUE,
                                    f"invalid method name '{m}'")
                c["method"] = METHOD_NAMES[i]
            else:
                c["method"] = METHOD_NAMES[int(m)]
        elif opt == "scheduler":
            s = args[0]
            if isinstance(s, str) and s.strip() == "":
                return
            if isinstance(s, str):
                i = _enum_from_str(SCHED_NAMES, s)
                if i <= 0:
                    raise MlisError(MlisError.E_OPT_VALUE,
                                    f"invalid scheduler '{s}'")
                c["scheduler"] = SCHED_NAMES[i]
            else:
                c["scheduler"] = SCHED_NAMES[int(s)]
        elif opt == "steps":
            c["steps"] = _int(args[0])
        elif opt == "f_t_ini":
            c["f_t_ini"] = _float(args[0], 1.0)
        elif opt == "f_t_end":
            c["f_t_end"] = _float(args[0])
        elif opt == "cfg_rescale":
            v = _float(args[0])
            if not 0.0 <= v <= 1.0:
                raise MlisError(MlisError.E_OPT_VALUE,
                                "cfg-rescale must be in [0, 1]")
            c["cfg_rescale"] = v
        elif opt == "slg_scale":
            v = _float(args[0])
            if v < 0:
                raise MlisError(MlisError.E_OPT_VALUE,
                                "slg-scale must be >= 0")
            c["slg_scale"] = v
        elif opt == "pag_scale":
            v = _float(args[0])
            if v < 0:
                raise MlisError(MlisError.E_OPT_VALUE,
                                "pag-scale must be >= 0")
            c["pag_scale"] = v
        elif opt == "slg_layers":
            # rejoin: option_set_str splits "7,8,9" into three args
            s = ",".join(str(a) for a in args)
            try:
                layers = tuple(int(v) for v in s.split(",") if v.strip())
            except ValueError:
                raise MlisError(MlisError.E_OPT_VALUE,
                                f"invalid slg-layers '{s}'")
            if not layers:
                raise MlisError(MlisError.E_OPT_VALUE,
                                "slg-layers must name at least one block")
            c["slg_layers"] = ",".join(str(v) for v in layers)
        elif opt in ("slg_start", "slg_end", "pag_start", "pag_end"):
            v = _float(args[0])
            if not 0.0 <= v <= 1.0:
                raise MlisError(MlisError.E_OPT_VALUE,
                                f"{opt} must be in [0, 1]")
            c[opt] = v
        elif opt == "s_noise":
            c["s_noise"] = _float(args[0])
        elif opt == "s_ancestral":
            c["s_ancestral"] = _float(args[0])
        elif opt == "image":
            self._image_set(args[0])
        elif opt == "image_mask":
            t = args[0]
            if t.shape[1] != 1:
                raise MlisError(MlisError.E_IMAGE,
                                "mask must have one channel")
            self.tensors["mask"] = np.asarray(t, np.float32)
            c["tuflags"] |= TUF_MASK
        elif opt == "no_decode":
            c["no_decode"] = bool(_parse_bool(str(args[0]))
                                  if isinstance(args[0], str) else args[0])
        elif opt == "tensor_use_flags":
            c["tuflags"] = _int(args[0])
        elif opt == "seed":
            if args and str(args[0]) != "":
                self.rng.seed = int(args[0])
                self.rng.offset = 0
        elif opt == "vae_tile":
            c["vae_tile"] = _int(args[0])
        elif opt == "unet_split":
            c["unet_split"] = bool(_parse_bool(str(args[0]))
                                   if isinstance(args[0], str) else args[0])
        elif opt in ("tp", "dp", "sp", "pp"):
            v = max(1, _int(args[0], 1))
            if c[opt] != v:
                c[opt] = v
                self._params.clear()  # shardings change with the mesh
                self._ready.discard("backend")
        elif opt == "threads":
            c["threads"] = _int(args[0])
        elif opt == "dump_flags":
            c["dump_flags"] = _int(args[0])
        elif opt == "aux_dir":
            c["aux_dir"] = str(args[0])
        elif opt == "control_net":
            v = str(args[0]) if args else ""
            if v != c["control_net"]:
                c["control_net"] = v
                self._params.pop("cnet", None)
                self._ready.discard("model")  # weights ride the model store
        elif opt == "control_image":
            t = args[0]
            if t is None or (isinstance(t, str) and t == ""):
                self.tensors["control_image"] = None
                return
            if t.dtype == np.uint8:
                t = image_mod.tensor_from_image_arr(t)
            t = np.asarray(t, np.float32)
            if t.ndim != 4 or t.shape[1] != 3:
                raise MlisError(MlisError.E_IMAGE,
                                "control image must be [n,3,h,w] or u8 hwc")
            self.tensors["control_image"] = t
        elif opt == "control_strength":
            c["control_strength"] = _float(args[0], 1.0)
        elif opt == "hires_fix":
            c["hires_fix"] = _float(args[0], 0.0)
        elif opt == "hires_denoise":
            c["hires_denoise"] = _float(args[0], 0.7)
        elif opt == "hires_steps":
            c["hires_steps"] = _int(args[0], 0)
        elif opt == "upscaler":
            path = str(args[0]) if args else ""
            if path != c["upscaler"]:
                c["upscaler"] = path
                self._upscaler = None
        elif opt == "hires_upscaler":
            c["hires_upscaler"] = str(args[0]) if args else ""
        elif opt == "subseed":
            c["subseed"] = _int(args[0], -1)
        elif opt == "subseed_strength":
            c["subseed_strength"] = _float(args[0], 0.0)
        elif opt == "inpaint_full_res":
            c["inpaint_full_res"] = _int(args[0], 0)
        elif opt == "inpaint_full_res_padding":
            c["inpaint_full_res_padding"] = _int(args[0], 32)
        elif opt == "mask_blur":
            c["mask_blur"] = _float(args[0], 0.0)
        elif opt == "deepcache":
            c["deepcache"] = _int(args[0], 0)
        elif opt == "freeu":
            # rejoin: option_set_str splits "B1,B2,S1,S2" into four args
            c["freeu"] = ",".join(str(a) for a in args).strip()
            self._freeu_parse(c["freeu"])  # fail fast on bad syntax
        elif opt == "tiling":
            c["tiling"] = bool(_int(args[0], 0))
        elif opt == "refiner":
            v = str(args[0]) if args else ""
            c["refiner"] = v
        elif opt == "refiner_switch":
            c["refiner_switch"] = _float(args[0], 0.8)
        elif opt == "t5":
            v = str(args[0]) if args else ""
            if v != c["t5"]:
                c["t5"] = v
                self._params.pop("t5", None)
                self._ready.discard("model")  # weights ride the model store
        elif opt == "t5_tokenizer":
            c["t5_tokenizer"] = str(args[0]) if args else ""
        elif opt == "t5_tokens":
            c["t5_tokens"] = _int(args[0], 77)
        elif opt in ("clip", "vae"):
            # aux weight files for transformer-only distributions (flux):
            # a CLIP text tower / a standalone VAE merged into the store
            v = str(args[0]) if args else ""
            if v != c[opt]:
                c[opt] = v
                self._params.pop("clip" if opt == "clip" else "vae", None)
                self._ready.discard("model")
        elif opt == "callback":
            self.callback = args[0]
        elif opt == "error_handler":
            self.error_handler = args[0]
        elif opt == "log_level":
            from .utils.log import level_from_str
            log.level = level_from_str(str(args[0]))
        elif opt == "model_type":
            mt = args[0]
            if isinstance(mt, int):
                mt = MODEL_TYPE_NAMES[mt]
            self._model_type_apply(mt)
        elif opt == "weight_type":
            self._weight_type_set(str(args[0]))
        else:
            raise MlisError(MlisError.E_UNK_OPT, f"unknown option '{name}'")

    def option_set_str(self, name: str, value: Optional[str]) -> None:
        """Set an option from its string form (reference:
        mlis_option_set_str)."""
        opt = self._find_option(name)
        value = value if value is not None else ""
        if opt in ("model", "tae", "lora_dir", "aux_dir", "prompt",
                   "nprompt", "control_net", "t5", "t5_tokenizer",
                   "clip", "vae", "upscaler", "hires_upscaler"):
            self.option_set(opt, value)  # no comma-splitting for paths/text
        elif opt in ("callback", "error_handler", "image", "image_mask",
                     "control_image"):
            raise MlisError(
                MlisError.E_OPT_VALUE,
                f"option '{opt}' cannot be set with a string value")
        else:
            self.option_set(opt, *_split_args(value))

    def option_get(self, name: str):
        """(reference: mlis_option_get, mlimgsynth_options_get.c.h)."""
        opt = self._find_option(name)
        if opt == "model_type":
            return self.c["model_type"] or "none"
        if opt in ("prompt", "nprompt"):
            return self.c[opt + "_raw"]
        if opt == "seed":
            return self.rng.seed
        return self.c.get(opt)

    # ------------------------------------------------------------------

    def _prompt_set(self, key: str, pt: prompt_mod.PromptText, text: str):
        self.c[key] = text
        if self.c["no_prompt_parse"]:
            parsed = prompt_mod.prompt_set_raw(text)
        else:
            # prompt editing ([from:to:when] / [a|b]): probe first — the
            # emphasis parser sees editing colons as weight syntax.  The
            # parsed fields hold the step-0 expansion; generate re-expands
            # per step once the schedule length is known.
            t0, edited = prompt_mod.expand_editing(text, 0, 1000)
            try:
                parsed = prompt_mod.prompt_set_parse(t0 if edited
                                                     else text)
            except prompt_mod.PromptParseError as e:
                raise MlisError(MlisError.E_PROMPT_PARSE, str(e))
            parsed.editing = bool(edited)
            if key == "prompt_raw":
                # drop prompt-tag loras left applied by a previous
                # generate_batch (the batch path keeps them patched as a
                # cache across same-tag batches)
                kept = [l for l in self.loras if not l[2]]
                if len(kept) != len(self.loras):
                    self.loras = kept
                    self._ready.discard("loras")
            for lname, lmult in parsed.loras:
                self._lora_add(lname, lmult, from_prompt=True)
        pt.text = parsed.text
        pt.chunks = parsed.chunks
        pt.loras = parsed.loras
        pt.editing = getattr(parsed, "editing", False)

    def _aux_find(self, path: str) -> str:
        """Resolve an auxiliary file (TAE weights, lora) through ``aux_dir``
        when it does not exist relative to the cwd.  Implements the search
        the reference declares for its aux path ("Path to auxiliary file",
        src/mlimgsynth.c:378 and the mlis_file_find sketch :711-737); its CLI
        seeds aux_dir from the binary location (main_mlimgsynth.c:642-652),
        ours does the same."""
        if path and not os.path.exists(path) and self.c["aux_dir"]:
            cand = os.path.join(self.c["aux_dir"], path)
            if os.path.exists(cand):
                return cand
        return path

    def _lora_find(self, name: str) -> str:
        """(reference: mlis_lora_path_find, src/mlimgsynth.c:631-668)."""
        if os.path.exists(name):
            return name
        base = self.c["lora_dir"]
        path = os.path.join(base, name + ".safetensors") if base else \
            name + ".safetensors"
        if os.path.exists(path):
            return path
        aux = self._aux_find(path)
        if aux != path and os.path.exists(aux):
            return aux
        raise MlisError(MlisError.E_FILE_NOT_FOUND,
                        f"lora model file not found '{path}'")

    def _lora_add(self, name: str, mult: float, from_prompt: bool):
        path = self._lora_find(name)
        self.loras.append((path, mult, from_prompt))
        self._ready.discard("loras")

    # ------------------------------------------------------------------
    # Textual-inversion embeddings (additive extension; the reference has
    # no equivalent).  ``<emb:NAME>`` in a prompt loads
    # ``{embed_dir}/NAME.safetensors`` (or ``.pt``), appends its learned
    # vectors to the CLIP token-embedding table(s), and splices the new
    # token ids into the stream at the tag position.
    # ------------------------------------------------------------------

    def _embeds_clear(self):
        if self._embeds:
            self._embeds.clear()
            self._embed_order.clear()
            self._params.pop("clip", None)
            self._params.pop("clip2", None)

    def _embed_find(self, name: str) -> str:
        if os.path.exists(name) and not os.path.isdir(name):
            return name
        base = self.c["embed_dir"]
        for ext in (".safetensors", ".pt"):
            path = os.path.join(base, name + ext) if base else name + ext
            if os.path.exists(path):
                return path
            aux = self._aux_find(path)
            if aux != path and os.path.exists(aux):
                return aux
        raise MlisError(MlisError.E_FILE_NOT_FOUND,
                        f"embedding file not found '{name}'")

    @staticmethod
    def _embed_read_tables(path: str) -> Dict[str, np.ndarray]:
        """Read an embedding file into {"clip": [k,d]} and/or
        {"clip2": [k,d2]} float32 tables.  Supported layouts: safetensors
        with "emb_params" (A1111 single-encoder) or "clip_l"/"clip_g"
        (SDXL), and torch ``.pt`` with {"string_to_param": {"*": t}}."""
        tables: Dict[str, np.ndarray] = {}
        if path.endswith(".pt"):
            import torch
            obj = torch.load(path, map_location="cpu", weights_only=True)
            stp = obj.get("string_to_param") if isinstance(obj, dict) \
                else None
            t = None
            if isinstance(stp, dict) and stp:
                t = next(iter(stp.values()))
            elif isinstance(obj, dict) and "emb_params" in obj:
                t = obj["emb_params"]
            if t is None:
                raise MlisError(-1, f"unrecognized embedding layout '{path}'")
            tables["clip"] = np.asarray(t.detach().float().numpy())
        else:
            st = TensorStore.open(path)
            try:
                names = set(st.names())
                # copies: read() may return views into the store's mmap
                if "emb_params" in names:
                    tables["clip"] = np.array(st.read("emb_params", "f32"))
                if "clip_l" in names:
                    tables["clip"] = np.array(st.read("clip_l", "f32"))
                if "clip_g" in names:
                    tables["clip2"] = np.array(st.read("clip_g", "f32"))
                if not tables:
                    raise MlisError(
                        -1, f"unrecognized embedding layout '{path}' "
                        f"(keys: {sorted(names)[:8]})")
            finally:
                st.close()
        for k, t in tables.items():
            tables[k] = np.atleast_2d(np.asarray(t, np.float32))
        return tables

    def _embed_token_ids(self, name: str) -> List[int]:
        """ids for a named embedding, loading + registering on first use."""
        reg = self._embeds.get(name)
        if reg is not None:
            return reg["ids"]
        path = self._embed_find(name)
        tables = self._embed_read_tables(path)
        mt = self._mt
        need = ["clip"] + (["clip2"] if mt.clip2_p is not None else [])
        for sub in need:
            P = mt.clip_p if sub == "clip" else mt.clip2_p
            t = tables.get(sub)
            if t is None:
                raise MlisError(
                    -1, f"embedding '{name}' has no table for {sub} "
                    f"(model type {self.c['model_type']})")
            if t.shape[1] != P.d_embed:
                raise MlisError(
                    -1, f"embedding '{name}' {sub} width {t.shape[1]} != "
                    f"model d_embed {P.d_embed}")
        ks = {tables[s].shape[0] for s in need}
        if len(ks) != 1:
            raise MlisError(-1, f"embedding '{name}' per-encoder vector "
                            f"counts differ: {sorted(ks)}")
        base = mt.clip_p.n_vocab + sum(
            len(self._embeds[n]["ids"]) for n in self._embed_order)
        ids = list(range(base, base + ks.pop()))
        self._embeds[name] = {"ids": ids,
                              "tables": {s: tables[s] for s in need}}
        self._embed_order.append(name)
        # the CLIP token tables grow: cached device params are stale
        self._params.pop("clip", None)
        self._params.pop("clip2", None)
        log.info2(f"embedding '{name}': {len(ids)} vector(s) from {path}")
        return ids

    def _embed_rows(self, submodel: str) -> Optional[np.ndarray]:
        """The appended token-table rows for one encoder, in id order."""
        if not self._embed_order:
            return None
        return np.concatenate(
            [self._embeds[n]["tables"][submodel] for n in self._embed_order],
            axis=0)

    def _image_set(self, img):
        """Accepts uint8 [h,w,c] or float NCHW tensor; alpha becomes mask
        (reference: OPTION(IMAGE))."""
        if img.dtype == np.uint8:
            t = image_mod.tensor_from_image_arr(img)
        else:
            t = np.asarray(img, np.float32)
        if t.shape[1] == 4:
            rgb, mask = image_mod.image_alpha_split(t)
            self.tensors["mask"] = np.ascontiguousarray(mask)
            t = np.ascontiguousarray(rgb)
            self.c["tuflags"] |= TUF_MASK
        elif t.shape[1] != 3:
            raise MlisError(MlisError.E_IMAGE,
                            f"invalid number of channels: {t.shape[1]}")
        self.tensors["image"] = t
        self.c["tuflags"] |= TUF_IMAGE

    def _model_type_apply(self, mt):
        """``mt``: a type name, or a ``ModelTypeDef`` (a custom definition,
        e.g. a published family with its depth cut)."""
        if isinstance(mt, ModelTypeDef):
            defn, mt = mt, mt.name
        else:
            # names are case/separator-insensitive like option names
            # (reference: strsl_cmpz_id, src/mlimgsynth.c:157-170)
            mt = mt.lower().replace("-", "_")
            if mt in ("", "none"):
                self._mt = None
                self.c["model_type"] = ""
                self._model_type_set = False
                return
            defn = _model_types().get(mt)
            if defn is None:
                raise MlisError(MlisError.E_OPT_VALUE,
                                f"invalid model type {mt}")
        self._mt = defn
        self.c["model_type"] = mt
        self._model_type_set = True
        # defaults applied only if unset (reference: IFNPOSSET)
        if self.c["width"] <= 0:
            self.c["width"] = self._mt.default_dim
        if self.c["height"] <= 0:
            self.c["height"] = self.c["width"]
        if self.c["clip_skip"] <= 0:
            self.c["clip_skip"] = self._mt.default_clip_skip

    def _weight_type_set(self, wt: str):
        import jax.numpy as jnp
        if wt in ("", "none", "-1"):
            self._dtype = jnp.bfloat16
            self._wtype_set = False
            self._weights_q8 = False
            self._weights_qbits = 8
            return
        m = {"f32": jnp.float32, "f16": jnp.bfloat16, "bf16": jnp.bfloat16,
             "q8_0": jnp.bfloat16, "q4_0": jnp.bfloat16, "q4_1": jnp.bfloat16,
             "q4_k": jnp.bfloat16, "q5_k": jnp.bfloat16,
             "q6_k": jnp.bfloat16}
        key = wt.lower()
        if key == "f32":
            self._dtype = jnp.float32
        elif key in m:
            self._dtype = m[key]
        else:
            raise MlisError(MlisError.E_OPT_VALUE,
                            f"unknown weight type '{wt}'")
        # quantized weight types execute linears weight-only quantized
        # (Pallas dequant-matmul); convs/norms stay in the compute dtype.
        # 4-bit families run the packed-int4 path (1/4 the bf16 weight
        # bytes resident), the rest int8 (1/2).
        self._weights_q8 = key.startswith("q")
        self._weights_qbits = 4 if key.startswith("q4") else 8
        self.c["weight_type"] = key
        self._wtype_set = True

    def _err(self, e: "MlisError"):
        """Record the error and invoke the user error handler
        (reference: mlis_error_handle, src/mlimgsynth.c:619-629)."""
        self.errstr = str(e)
        if self.error_handler is not None:
            self.error_handler(self, {"code": e.code, "desc": str(e)})
        raise e

    # ------------------------------------------------------------------
    # Setup (reference: mlis_setup, src/mlimgsynth.c:1251-1302)
    # ------------------------------------------------------------------

    def setup(self):
        if "rng" not in self._ready:
            log.info(f"Seed: {self.rng.seed}")
            self._ready.add("rng")
        if "backend" not in self._ready:
            self._backend_init()
            self._ready.add("backend")
        else:
            # the mesh/pipeline globals are trace-time inputs shared by all
            # sessions in the process; another session's _backend_init may
            # have clobbered them since ours ran — re-assert every setup so
            # a later re-trace (image-dim change etc.) sees OUR plan
            self._publish_mesh_globals()
        if "model" not in self._ready:
            self._model_load()
            self._ready.add("model")
        if "loras" not in self._ready:
            self._loras_apply()
            self._ready.add("loras")

    def _backend_init(self):
        import jax
        want = self.c["backend"]
        backend = jax.default_backend()
        if want and want not in ("best", backend):
            platforms = {d.platform for d in jax.devices()}
            if want not in platforms:
                raise MlisError(
                    -1, f"backend '{want}' not available (have {backend})")
        log.info(f"Backend: {backend}, {jax.devices()[0].device_kind} "
                 f"({len(jax.devices())} device(s))")
        tp, dp, sp = self.c["tp"], self.c["dp"], self.c["sp"]
        pp = self.c["pp"]
        if pp > 1 and (tp > 1 or dp > 1 or sp > 1):
            # v1 pipeline restriction: the stage slabs shard only over
            # 'pp' and the pipeline body replicates over the other axes,
            # so combining would silently burn devices for no block-stack
            # speedup — refuse loudly instead
            raise MlisError(
                MlisError.E_OPT_VALUE,
                "--pp does not compose with --tp/--dp/--sp yet; "
                "use pp alone")
        if tp * dp * sp * pp > 1:
            from .parallel import mesh as pmesh
            n = tp * dp * sp * pp
            if len(jax.devices()) < n:
                raise MlisError(
                    MlisError.E_OPT_VALUE,
                    f"tp={tp} x dp={dp} x sp={sp} x pp={pp} needs {n} "
                    f"devices, have {len(jax.devices())}")
            self._mesh = pmesh.make_mesh(n, tp=tp, sp=sp, pp=pp)
            log.info(f"Mesh: dp={dp} pp={pp} sp={sp} tp={tp} over {n} "
                     "devices (collectives inserted by XLA)")
        else:
            self._mesh = None
        self._publish_mesh_globals()

    def _publish_mesh_globals(self):
        """Publish this session's mesh + pipeline plan to the trace-time
        module globals (ops.attention.MESH, parallel.pipeline.PLAN).  They
        are process-wide; setup() re-asserts them so the last session to
        run wins, not the last one to construct."""
        pp = self.c["pp"]
        from .parallel import pipeline as pl
        pl.PLAN = (pl.PipelinePlan(
            self._mesh, pp,
            int(os.environ.get("MLIS_PP_MICRO", "0")))
            if pp > 1 and self._mesh is not None else None)
        from .ops import attention as attn_mod
        attn_mod.MESH = self._mesh

    def _model_load(self):
        if not self.c["model"]:
            if self._model_type_set:
                # weight-less mode for tokenize-only use
                self._store = None
                self._name_map = {}
                return
            raise MlisError(MlisError.E_UNKNOWN, "No model file set")
        if not os.path.exists(self.c["model"]):
            raise MlisError(MlisError.E_FILE_NOT_FOUND,
                            f"model file not found '{self.c['model']}'")
        t0 = time.time()
        self._embeds_clear()  # token ids / dims are per-model
        store = TensorStore.open(self.c["model"])
        if self.c["tae"]:
            store.read_file(self._aux_find(self.c["tae"]), prefix="tae.")
        if self.c["t5"]:
            # standalone T5 weights file (bare HF names); bundled-in-model
            # t5 tensors route through nameconv instead
            t5_path = self._aux_find(self.c["t5"])
            if not os.path.exists(t5_path):
                raise MlisError(MlisError.E_FILE_NOT_FOUND,
                                f"t5 file not found '{self.c['t5']}'")
            store.read_file(t5_path, prefix="t5_ckpt.")
        for aux in ("clip", "vae"):
            if self.c[aux]:
                p = self._aux_find(self.c[aux])
                if not os.path.exists(p):
                    raise MlisError(
                        MlisError.E_FILE_NOT_FOUND,
                        f"{aux} file not found '{self.c[aux]}'")
                store.read_file(p, prefix=f"{aux}_ckpt.")
        self._store = store
        if self.c["dump_flags"] & 1:  # MLIS_DUMP_MODEL
            with open("dump-tensors-model.txt", "w") as f:
                for name in store.names():
                    e = store.tensors[name]
                    f.write(f"{name}: {e.dtype} {list(e.shape)}\n")
        if self.c["control_net"]:
            cn_path = self._aux_find(self.c["control_net"])
            if not os.path.exists(cn_path):
                raise MlisError(
                    MlisError.E_FILE_NOT_FOUND,
                    f"control-net file not found '{self.c['control_net']}'")
            store.read_file(cn_path, prefix="cnet_ckpt.")
        self._name_map = weights_mod.build_name_map(store)
        # keep raw tae names accessible under the tae. prefix
        for raw in store.tensors:
            if raw.startswith("tae.") and raw not in self._name_map:
                self._name_map[raw] = weights_mod.NameRef(raw)
        if self.c["t5"]:
            # standalone T5 file: bare HF names (optionally under
            # text_encoders.t5xxl./transformer.) -> internal t5. prefix
            n_t5 = 0
            for raw in store.tensors:
                if not raw.startswith("t5_ckpt."):
                    continue
                t = raw[len("t5_ckpt."):]
                for pre in ("text_encoders.t5xxl.", "transformer."):
                    if t.startswith(pre):
                        t = t[len(pre):]
                name = "t5." + t
                if name not in self._name_map:
                    self._name_map[name] = weights_mod.NameRef(raw)
                    n_t5 += 1
            if not n_t5:
                raise MlisError(-1, "no T5 tensors recognized in "
                                f"'{self.c['t5']}'")
            log.info2(f"T5: {n_t5} tensors mapped")
        if self.c["clip"]:
            # HF CLIPTextModel layout (text_model.*), possibly nested
            from .nameconv import normalize_name as _nn

            def _clip_tf(t):
                if t.startswith("text_model."):
                    return _nn("cond_stage_model.transformer." + t)
                return _nn(t)
            n_c = weights_mod.merge_prefixed(self._name_map, store,
                                             "clip_ckpt.", _clip_tf)
            if not n_c:
                raise MlisError(-1, "no CLIP tensors recognized in "
                                f"'{self.c['clip']}'")
            log.info2(f"clip file: {n_c} tensors mapped")
        if self.c["vae"]:
            from .nameconv import normalize_name as _nn

            def _vae_tf(t):
                if t.startswith("first_stage_model."):
                    return _nn(t)
                return _nn("first_stage_model." + t)
            n_v = weights_mod.merge_prefixed(self._name_map, store,
                                             "vae_ckpt.", _vae_tf)
            if not n_v:
                raise MlisError(-1, "no VAE tensors recognized in "
                                f"'{self.c['vae']}'")
            log.info2(f"vae file: {n_v} tensors mapped")
        if self.c["control_net"]:
            from .nameconv import normalize_cnet_name
            n_cn = 0
            for raw in store.tensors:
                if not raw.startswith("cnet_ckpt."):
                    continue
                r = normalize_cnet_name(raw[len("cnet_ckpt."):])
                if r is not None and r not in self._name_map:
                    self._name_map[r] = weights_mod.NameRef(raw)
                    n_cn += 1
            if not n_cn:
                raise MlisError(
                    -1, "no ControlNet tensors recognized in "
                    f"'{self.c['control_net']}'")
            log.info2(f"ControlNet: {n_cn} tensors mapped")
        log.info2(f"Model header loaded {{{time.time() - t0:.3f}s}}")
        width_table = {d.unet_p.n_ctx: name
                       for name, d in _model_types().items()}
        mt, wt = weights_mod.identify_model(store, self._name_map,
                                            width_table)
        if mt and not self._model_type_set:
            # identification must not override an explicit --model-type
            self._model_type_apply(mt)
        elif mt and self._model_type_set and mt != self.c["model_type"]:
            log.warning(f"model looks like {mt}, keeping user-set "
                        f"{self.c['model_type']}")
        elif not mt and not self._model_type_set:
            raise MlisError(-1, "could not detect the model type")
        log.info(f"Model type: {self.c['model_type']}")
        # inpaint-variant UNets (e.g. sd-v1-5-inpainting) carry extra input
        # channels on the first conv: adapt n_ch_in from the checkpoint
        ref = self._name_map.get("unet.in.conv.weight")
        if ref is not None and self._mt is not None:
            n_in = int(store.tensors[ref.raw].shape[1])
            if n_in != self._mt.unet_p.n_ch_in:
                import dataclasses
                self._mt = dataclasses.replace(
                    self._mt,
                    unet_p=dataclasses.replace(self._mt.unet_p,
                                               n_ch_in=n_in))
                log.info(f"UNet input channels: {n_in} "
                         f"(inpaint-variant model)")
        if wt and not self._wtype_set:
            self._weight_type_set(wt)
            self._wtype_set = False  # identification, not user choice
        log.info2(f"Weight type: {self.c.get('weight_type') or 'f16'}")

    def _loras_apply(self):
        if self._store is None:
            return
        self._store.cache_clear()
        self._params.clear()  # cached device params are stale after unpatch
        if not self.loras:
            return
        t0 = time.time()
        for path, mult, _ in self.loras:
            lstore = TensorStore.open(path)
            if self.c["dump_flags"] & 2:  # MLIS_DUMP_LORA
                with open("dump-tensors-lora.txt", "w") as f:
                    for name in lstore.names():
                        e = lstore.tensors[name]
                        f.write(f"{name}: {e.dtype} {list(e.shape)}\n")
            try:
                n = weights_mod.lora_apply(self._store, self._name_map,
                                           lstore, mult)
            except FloatingPointError as e:
                raise MlisError(MlisError.E_NAN, str(e))
            log.debug(f"lora '{path}' patched {n} tensors")
            lstore.close()
        log.info(f"LoRA's applied: {len(self.loras)} "
                 f"{{{time.time() - t0:.3f}s}}")

    # ------------------------------------------------------------------
    # Submodel params
    # ------------------------------------------------------------------

    def _get_params(self, submodel: str) -> dict:
        """Load (and device-cache) one submodel's params."""
        if submodel in self._params:
            return self._params[submodel]
        if self._store is None:
            raise MlisError(-1, "no model loaded")
        import jax.numpy as jnp
        from .models import blocks as B
        from .models import clip as clip_mod
        from .models import tae as tae_mod
        from .models import unet as unet_mod
        from .models import vae as vae_mod
        mt = self._mt
        t0 = time.time()
        if submodel in ("clip", "clip2"):
            P = mt.clip_p if submodel == "clip" else mt.clip2_p
            has_proj = (f"{submodel}.text.text_proj" in self._name_map)
            # flux conditions on the UNPROJECTED pooled row (HF
            # pooler_output), so its clip tower wants the feat head even
            # when the file ships no text_projection tensor
            is_flux = getattr(mt.unet_p, "flux", False)
            want_feat = has_proj or (is_flux and submodel == "clip")
            spec = B.trace_spec(
                lambda ctx, toks: clip_mod.clip_text_apply(
                    ctx, toks, P, feat_tok_idx=(
                        jnp.zeros((1,), jnp.int32) if want_feat else None),
                    pre=submodel, feat_proj=not is_flux),
                jnp.zeros((1, P.n_token), jnp.int32))
        elif submodel == "unet":
            P = mt.unet_p
            if getattr(P, "flux", False):
                from .models import flux as flux_mod
                spec = B.trace_spec(
                    lambda ctx, x, t, c, y: flux_mod.flux_apply(
                        ctx, x, t, c, y, P,
                        guidance=(jnp.zeros((1,)) if P.guidance_embed
                                  else None)),
                    jnp.zeros((1, 8, 8, P.n_ch_in // 4)), jnp.zeros((1,)),
                    jnp.zeros((1, 77, P.d_ctx_in)),
                    jnp.zeros((1, P.d_pooled)))
            elif getattr(P, "flow", False):
                from .models import mmdit as mmdit_mod
                spec = B.trace_spec(
                    lambda ctx, x, t, c, y: mmdit_mod.mmdit_apply(
                        ctx, x, t, c, y, P),
                    jnp.zeros((1, 8, 8, P.n_ch_in)), jnp.zeros((1,)),
                    jnp.zeros((1, 77, P.d_ctx_in)),
                    jnp.zeros((1, P.d_pooled)))
            else:
                label = (jnp.zeros((1, P.ch_adm_in)) if P.ch_adm_in
                         else None)
                spec = B.trace_spec(
                    lambda ctx, x, t, c: unet_mod.unet_apply(
                        ctx, x, t, c, label, P),
                    jnp.zeros((1, 8, 8, P.n_ch_in)), jnp.zeros((1,)),
                    jnp.zeros((1, 77, P.n_ctx)))
        elif submodel == "vae":
            P = mt.vae_p
            spec = B.trace_spec(
                lambda ctx, x: vae_mod.vae_encode_apply(ctx, x, P),
                jnp.zeros((1, 64, 64, 3)))
            spec.update(B.trace_spec(
                lambda ctx, x: vae_mod.vae_decode_apply(ctx, x, P),
                jnp.zeros((1, 8, 8, P.ch_z))))
        elif submodel == "tae":
            # latent channel count inferred from the checkpoint (taesd is
            # 4-ch; taesd3/taef1 are the 16-ch flow-family variants —
            # decoder.layers.0.weight is [64, ch_z, 3, 3])
            P = tae_mod.TAE_SD1
            ref = self._name_map.get("tae.decoder.layers.0.weight")
            if ref is not None:
                ch_z = int(self._store.tensors[ref.raw].shape[1])
                if ch_z != P.ch_z:
                    import dataclasses
                    P = dataclasses.replace(P, ch_z=ch_z)
            if mt is not None and P.ch_z != mt.vae_p.ch_z:
                raise MlisError(
                    MlisError.E_IMAGE,
                    f"TAE latent channels ({P.ch_z}) do not match the "
                    f"model family's ({mt.vae_p.ch_z}) — e.g. taesd is "
                    "for SD, taesd3 for SD3, taef1 for Flux")
            self._tae_p = P
            spec = B.trace_spec(
                lambda ctx, x: tae_mod.tae_encode_apply(ctx, x, P),
                jnp.zeros((1, 64, 64, 3)))
            spec.update(B.trace_spec(
                lambda ctx, x: tae_mod.tae_decode_apply(ctx, x, P),
                jnp.zeros((1, 8, 8, P.ch_z))))
        elif submodel == "t5":
            from .models import t5 as t5_mod
            shapes = {n: tuple(self._store.tensors[r.raw].shape)
                      for n, r in self._name_map.items()
                      if n.startswith("t5.") and r.split is None}
            P = t5_mod.params_from_spec_shapes(shapes)
            self._t5_p = P
            log.info2(f"T5 geometry: d_model {P.d_model}, {P.n_layer} "
                      f"layers, {P.n_head} heads")
            spec = B.trace_spec(
                lambda ctx, toks: t5_mod.t5_encode_apply(ctx, toks, P),
                jnp.zeros((1, 8), jnp.int32))
        elif submodel == "cnet":
            from .models import controlnet as cnet_mod
            P = mt.unet_p
            label = (jnp.zeros((1, P.ch_adm_in)) if P.ch_adm_in else None)

            def _cn(ctx, x, t, cond, hint):
                feat = cnet_mod.hint_apply(ctx, hint, P)
                return cnet_mod.controlnet_apply(ctx, x, t, cond, label,
                                                 feat, P)

            spec = B.trace_spec(
                _cn, jnp.zeros((1, 8, 8, P.n_ch_in)), jnp.zeros((1,)),
                jnp.zeros((1, 77, P.n_ctx)), jnp.zeros((1, 64, 64, 3)))
        else:
            raise MlisError(-1, f"unknown submodel '{submodel}'")
        # re-dtype the spec to the session weight type
        for k, ps in spec.items():
            if ps.dtype == jnp.bfloat16 and self._dtype != jnp.bfloat16:
                spec[k] = B.ParamSpec(ps.shape, ps.kind, self._dtype)
        host = weights_mod.load_params(self._store, spec, self._name_map)
        if submodel in ("clip", "clip2"):
            rows = self._embed_rows(submodel)
            if rows is not None:
                key = f"{submodel}.text.embed.token.weight"
                tw = np.asarray(host[key])
                host[key] = np.concatenate(
                    [tw, rows.astype(tw.dtype)], axis=0)
                log.debug(f"{submodel}: token table +{rows.shape[0]} "
                          "textual-inversion rows")
        if self._weights_q8 and submodel != "t5":
            # (T5's attention projections consume weights directly as
            # head-split einsums — no q8 route; T5 stays in compute dtype)
            n_q = weights_mod.quantize_linear_weights(
                host, spec, bits=self._weights_qbits)
            log.info2(f"{submodel}: {n_q} linear weights quantized to "
                      f"int{self._weights_qbits}")
        if self.c["dump_flags"] & 4 and submodel == "unet":  # MLIS_DUMP_GRAPH
            self._dump_graph(spec)
        if submodel == "unet" and self.c["pp"] > 1:
            host = self._stack_pipeline_blocks(host)
        dev = weights_mod.pack_to_device(host)
        if self._mesh is not None:
            # UNet/DiT matmuls get Megatron tp shardings (so do the T5
            # tower's — at SD3 scale the 4.7B encoder is worth sharding);
            # everything else is replicated over the mesh (dp parallelism
            # comes from batch sharding of the sampler inputs).
            from .parallel import mesh as pmesh
            dev = pmesh.shard_params(dev, self._mesh,
                                     tp=(submodel in ("unet", "cnet", "t5")))
        self._params[submodel] = dev
        t_load = time.time() - t0
        mem = sum(int(np.prod(ps.shape)) * np.dtype(ps.dtype).itemsize
                  for ps in spec.values())
        self.stats[submodel] = {"mem_params": mem, "t_load": t_load,
                                "n_tensors": len(spec), "n_compute": 0}
        log.info(f"{submodel}: {len(spec)} tensors, "
                 f"{mem / 1024**2:.1f} MiB params {{{t_load:.3f}s}}")
        return dev

    def _stack_pipeline_blocks(self, host):
        """Restack the MMDiT block params for pipeline parallelism (--pp):
        all ``depth`` blocks become ``mmdit.joint_blocks_p.*`` slabs of
        shape [pp, depth/pp, ...] (sharded over the 'pp' mesh axis by
        parallel/mesh.param_spec).  The final pre_only block's missing
        context-side tensors (attn.proj, mlp, the 6-chunk adaLN tail) are
        zero-filled so every block runs the uniform joint_block: the zero
        gates make the extra context-side compute a no-op.  See
        parallel/pipeline.py for the runtime."""
        import re

        P = self._mt.unet_p
        pp = self.c["pp"]
        if getattr(P, "flux", False):
            return self._stack_pipeline_blocks_flux(host)
        if not getattr(P, "flow", False):
            raise MlisError(
                MlisError.E_OPT_VALUE,
                "--pp is currently supported for MMDiT (SD3-family) and "
                "Flux models")
        if getattr(P, "x_self_attn_layers", ()):
            raise MlisError(
                MlisError.E_OPT_VALUE,
                "--pp needs a uniform block stack; MMDiT-X (SD3.5-medium) "
                "dual-attention blocks are not stackable")
        if P.depth % pp != 0:
            raise MlisError(
                MlisError.E_OPT_VALUE,
                f"--pp {pp} must divide the block count ({P.depth})")
        pat = re.compile(r"^mmdit\.joint_blocks\.(\d+)(\..+)$")
        rels = []
        extra = []
        for k in list(host):
            m = pat.match(k)
            if not m:
                continue
            if int(m.group(1)) == 0:
                rels.append(m.group(2))
            elif f"mmdit.joint_blocks.0{m.group(2)}" not in host:
                extra.append(k)
        if extra:
            # a tensor block 0 lacks would be silently dropped from the
            # stacked forward — refuse rather than compute with zeros
            raise MlisError(
                MlisError.E_OPT_VALUE,
                f"--pp needs a uniform block stack; block tensors not in "
                f"block 0: {extra[:3]}")

        def _final_tail(rel):
            # the pre_only final block legitimately lacks exactly the
            # context-side output projection and MLP (reference:
            # DismantledBlock pre_only, sd3 checkpoints)
            return rel.startswith(".context_block.") and (
                ".attn.proj" in rel or ".mlp." in rel)

        for rel in rels:
            ref = host[f"mmdit.joint_blocks.0{rel}"]
            per = []
            for i in range(P.depth):
                a = host.pop(f"mmdit.joint_blocks.{i}{rel}", None)
                last = (i == P.depth - 1)
                if a is None:
                    if not (last and _final_tail(rel)):
                        raise MlisError(
                            MlisError.E_OPT_VALUE,
                            f"--pp: block {i} is missing {rel!r} — "
                            "non-uniform checkpoint")
                    a = np.zeros(ref.shape, ref.dtype)
                elif a.shape != ref.shape:
                    # final block's 2-chunk adaLN -> zero-pad to 6 chunks
                    # (chunk order is shift, scale first, so a prefix copy
                    # preserves them and zeroes the gates)
                    if not (last and ".adaLN_modulation." in rel
                            and all(x <= y for x, y in
                                    zip(a.shape, ref.shape))):
                        raise MlisError(
                            MlisError.E_OPT_VALUE,
                            f"--pp: block {i} {rel!r} shape {a.shape} != "
                            f"block 0 {ref.shape} — non-uniform checkpoint")
                    pad = np.zeros(ref.shape, ref.dtype)
                    pad[tuple(slice(0, d) for d in a.shape)] = a
                    a = pad
                per.append(a)
            host[f"mmdit.joint_blocks_p{rel}"] = np.stack(per).reshape(
                pp, P.depth // pp, *ref.shape)
        log.info(f"unet: {len(rels)} block tensors restacked into "
                 f"{pp}-stage pipeline slabs")
        return host

    def _stack_pipeline_blocks_flux(self, host):
        """Flux --pp: both block stacks (double-stream, single-stream) are
        zero-padded up to a ``pp`` multiple and restacked as [pp, L, ...]
        slabs (``flux.double_blocks_p.*`` / ``flux.single_blocks_p.*``) —
        the runtime chains two pipeline_apply passes (models/flux.py).  A
        zero-filled flux block is an exact identity: every residual branch
        is gated by a modulation output that reads 0 (and rms-norm of the
        zero qkv is 0, not NaN), so padded ticks pass activations through
        unchanged.  Cost: <= pp-1 identity blocks per stack (flux.1 at
        pp=2: 1 pad block of 57).  This lifts the uniform-slab restriction —
        flux is exactly the model whose bf16 weight residency (24 GiB)
        motivates pp."""
        P = self._mt.unet_p
        pp = self.c["pp"]
        n = 0
        for stack, depth in (("double_blocks", P.depth_double),
                             ("single_blocks", P.depth_single)):
            n += self._stack_uniform(host, f"flux.{stack}.",
                                     f"flux.{stack}_p", depth, pp)
        log.info(f"unet: {n} flux block tensors restacked into "
                 f"{pp}-stage pipeline slabs (zero-padded to pp multiples)")
        return host

    @staticmethod
    def _stack_uniform(host, pre_in, pre_out, depth, pp):
        """Restack ``pre_in{i}rel`` (i in [0, depth)) into ``pre_out`` +
        rel slabs of shape [pp, ceil(depth/pp), ...], zero-filling the pad
        indices.  Quantized pairs (.weight_q8/.weight_q4 + .weight_scale)
        stack like any other key; their zero fill dequants to 0."""
        import re
        pat = re.compile(re.escape(pre_in) + r"(\d+)(\..+)$")
        rels, extra = [], []
        for k in list(host):
            m = pat.match(k)
            if not m:
                continue
            if int(m.group(1)) == 0:
                rels.append(m.group(2))
            elif f"{pre_in}0{m.group(2)}" not in host:
                extra.append(k)
        if extra:
            raise MlisError(
                MlisError.E_OPT_VALUE,
                f"--pp needs a uniform block stack; block tensors not in "
                f"block 0: {extra[:3]}")
        n_pad = -(-depth // pp) * pp
        for rel in rels:
            ref = host[f"{pre_in}0{rel}"]
            per = []
            for i in range(n_pad):
                if i < depth:
                    a = host.pop(f"{pre_in}{i}{rel}", None)
                    if a is None or a.shape != ref.shape:
                        raise MlisError(
                            MlisError.E_OPT_VALUE,
                            f"--pp: block {i} {rel!r} missing or shaped "
                            f"unlike block 0 — non-uniform checkpoint")
                else:
                    a = np.zeros(ref.shape, ref.dtype)
                per.append(a)
            host[f"{pre_out}{rel}"] = np.stack(per).reshape(
                pp, n_pad // pp, *ref.shape)
        return len(rels)

    def _dump_graph(self, spec):
        """Write the UNet jaxpr to dump-graph.txt (MLIS_DUMP_GRAPH
        equivalent of the reference's ggml graph dump)."""
        import jax
        import jax.numpy as jnp
        from .models import blocks as B
        from .models import unet as unet_mod
        P = self._mt.unet_p
        zeros = {k: jnp.zeros(ps.shape, ps.dtype) for k, ps in spec.items()}
        if getattr(P, "flow", False):
            from .models import mmdit as mmdit_mod

            def f(params, x, t, c, y):
                return mmdit_mod.mmdit_apply(
                    B.Ctx(params, dtype=self._dtype), x, t, c, y, P)
            jaxpr = jax.make_jaxpr(f)(
                zeros, jnp.zeros((1, 8, 8, P.n_ch_in)), jnp.zeros((1,)),
                jnp.zeros((1, 77, P.d_ctx_in)), jnp.zeros((1, P.d_pooled)))
            with open("dump-graph.txt", "w") as fo:
                fo.write(str(jaxpr))
            return
        label = jnp.zeros((1, P.ch_adm_in)) if P.ch_adm_in else None

        def f(params, x, t, c):
            return unet_mod.unet_apply(B.Ctx(params, dtype=self._dtype),
                                       x, t, c, label, P)
        jaxpr = jax.make_jaxpr(f)(zeros, jnp.zeros((1, 8, 8, P.n_ch_in)),
                                  jnp.zeros((1,)),
                                  jnp.zeros((1, 77, P.n_ctx)))
        with open("dump-graph.txt", "w") as fo:
            fo.write(str(jaxpr))

    def _free_params(self, submodel: str):
        self._params.pop(submodel, None)

    # ------------------------------------------------------------------
    # Progress / callbacks
    # ------------------------------------------------------------------

    def _cb(self, stage: int, step: int, step_end: int):
        now = time.time()
        p = self.progress
        p["step_time"] = now - p.get("_t", now)
        p["_t"] = now
        p.update(stage=stage, step=step, step_end=step_end, nfe=self._nfe)
        if self.callback is not None:
            if self.callback(self, dict(p)):
                raise Aborted("generation cancelled by callback")

    # ------------------------------------------------------------------
    # Text encoding (reference: mlis_text_cond_encode etc.)
    # ------------------------------------------------------------------

    def text_tokenize(self, text: str, submodel: str = "clip") -> List[int]:
        self.setup() if self._mt is None else None
        if self._mt is None:
            raise MlisError(-1, "model type not set")
        return tok_mod.tokenize(text)

    def _prompt_tokens(self, pt: prompt_mod.PromptText
                       ) -> Tuple[List[int], List[float]]:
        toks: List[int] = []
        wts: List[float] = []
        chunks = pt.chunks if pt.chunks else [(pt.text, 1.0)]
        for text, w in chunks:
            if text == prompt_mod.BREAK_MARK:
                toks.append(tok_mod.BREAK_TOKEN)
                wts.append(w)
                continue
            if text.startswith(prompt_mod.EMBED_MARK):
                t = self._embed_token_ids(text[len(prompt_mod.EMBED_MARK):])
            else:
                t = tok_mod.tokenize(text)
            toks.extend(t)
            wts.extend([w] * len(t))
        n_real = sum(1 for t in toks if t != tok_mod.BREAK_TOKEN)
        log.info(f"Prompt: {n_real} tokens")
        return toks, wts

    def _clip_encode_rows(self, rows, weights_rows, submodel: str,
                          want_feat: bool, norm: bool, clip_skip: int):
        """Encode several token lists as ONE batched CLIP call; apply
        per-token emphasis weights per row (reference:
        mlis_clip_tokens_encode, src/mlimgsynth.c:1424-1467 — which runs
        once per prompt; batching rows halves the text-encode dispatches
        for CFG and amortizes them across merged serving requests)."""
        P = self._mt.clip_p if submodel == "clip" else self._mt.clip2_p
        wrs = weights_rows if weights_rows is not None \
            else [None] * len(rows)
        W = self._window_count(P, list(zip(rows, wrs)))
        wrapped, wrows, fidx = [], [], []
        for toks, wts in zip(rows, wrs):
            wins, wmats, f0 = tok_mod.split_windows(P, toks, wts,
                                                    n_window=W)
            wrapped.append(wins[0] if W == 1 else wins[:W])
            wrows.append(wmats[0] if W == 1
                         else np.concatenate(wmats[:W]))
            fidx.append(f0)
        wrapped = np.asarray(wrapped, np.int32)
        fidx = np.asarray(fidx, np.int32)
        params = self._get_params(submodel)
        embed, feat = _clip_jit(
            params, wrapped, fidx, clip_p=P, submodel=submodel,
            clip_skip=clip_skip, norm=norm, want_feat=want_feat,
            feat_proj=not getattr(self._mt.unet_p, "flux", False),
            dtype=self._dtype)
        embed = np.asarray(embed, np.float32)
        if weights_rows is not None:
            embed = embed * np.asarray(wrows, np.float32)[:, :, None]
        return embed, (np.asarray(feat, np.float32) if feat is not None
                       else None)

    def _clip_encode(self, toks: List[int], weights: Optional[List[float]],
                     submodel: str, want_feat: bool, norm: bool,
                     clip_skip: int):
        embed, feat = self._clip_encode_rows(
            [toks], None if weights is None else [weights], submodel,
            want_feat, norm, clip_skip)
        return embed, feat

    def clip_text_encode(self, text: str, submodel: str = "clip",
                         want_feat: bool = False, norm: bool = True):
        """Public text-embedding utility (reference: mlis_clip_text_encode)."""
        self.setup()
        pt = prompt_mod.prompt_set_raw(text)
        toks, _ = self._prompt_tokens(pt)
        return self._clip_encode(toks, None, submodel, want_feat, norm,
                                 self.c["clip_skip"] if not want_feat else 0)

    def _deepcache_check(self, unet_p, control_spec, extra_spec, edit_steps):
        """Deepcache composes with the plain SD-UNet, (flow) MMDiT and
        Flux loops; ControlNet/inpaint-variant inputs, prompt editing,
        mesh execution and multi-eval solvers are out."""
        if self.c["deepcache"] <= 1:
            return
        from .sampling.sampler import DC_METHODS
        if (control_spec is not None or extra_spec is not None
                or edit_steps is not None or self._mesh is not None
                or self.c["method"] not in DC_METHODS):
            raise MlisError(
                MlisError.E_OPT_VALUE,
                "deepcache supports SD-UNet, SD3/MMDiT and Flux families "
                "(no ControlNet/inpaint-variant/editing/mesh), 1-eval "
                "solvers only: " + ", ".join(DC_METHODS))
        if getattr(unet_p, "flow", False) and self.c["slg_scale"] > 0:
            raise MlisError(MlisError.E_OPT_VALUE,
                            "deepcache is not supported with slg-scale")

    def _edit_cond_bank(self, edit_segs, eff_cfg: float, n_batch: int):
        """Prompt editing: encode every distinct per-step prompt text as
        one batched encoder call (the conditioning BANK) and build the
        [S, rows] index matrix the fused loop gathers from per step.
        Bank layout: prompt segments first, then negative segments."""
        ep, en, n_plan = edit_segs
        c = self.c
        p_texts, p_idx = (ep if ep is not None
                          else ([c["prompt_raw"]], [0] * n_plan))
        u_texts, u_idx = [], None
        if eff_cfg > 1:
            u_texts, u_idx = (en if en is not None
                              else ([c["nprompt_raw"]], [0] * n_plan))
        pts = [self._parse_prompt_text(t, allow_loras=True)
               for t in p_texts + u_texts]
        rows, lrows = self._text_cond_encode_rows(
            pts, uncond_rows=len(u_texts))
        rows = np.asarray(rows, np.float32)
        k = len(p_texts)
        if eff_cfg > 1 and self._mt.unet_p.uncond_empty_zero:
            # zero every edited-to-empty negative segment (same rule as
            # _batch_edit_cond_bank: empty uncond text => zero rows)
            for j, t in enumerate(u_texts):
                if not t:
                    rows[k + j] = 0.0
        ncols = (2 if eff_cfg > 1 else 1) * n_batch
        idx = np.empty((n_plan, ncols), np.int32)
        for s in range(n_plan):
            idx[s, :n_batch] = p_idx[s]
            if eff_cfg > 1:
                idx[s, n_batch:] = k + u_idx[s]
        log.info(f"Prompt editing: {k} prompt"
                 + (f" + {len(u_texts)} negative" if eff_cfg > 1 else "")
                 + f" segment(s) over {n_plan} steps")
        return rows, lrows, idx

    def _batch_edit_cond_bank(self, requests, use_cfg: bool,
                              img2img: bool):
        """Prompt editing on the batched path: per-request per-step text
        segments (editing-free requests contribute one segment) index one
        shared conditioning bank, encoded in a single batched call."""
        c = self.c
        from .sampling.sampler import plan_n_step
        n_plan = plan_n_step(SamplerConfig(
            method=c["method"], sched=c["scheduler"], n_step=c["steps"],
            cfg_scale=(c["cfg_scale"] if use_cfg else 1.0),
            s_ancestral=c["s_ancestral"], s_noise=c["s_noise"],
            f_t_ini=c["f_t_ini"] if img2img else 1.0,
            f_t_end=c["f_t_end"], keep_tail=self._keep_tail,
            noise_add=self._noise_add), 2 if use_cfg else 1)
        n = len(requests)

        def maps_for(raws):
            texts, tindex, maps = [], {}, []

            def row_of(t):
                k = tindex.get(t)
                if k is None:
                    k = tindex[t] = len(texts)
                    texts.append(t)
                return k

            for raw in raws:
                segs = prompt_mod.editing_segments(raw, n_plan)
                if segs is None:
                    maps.append([row_of(raw)] * n_plan)
                else:
                    ts, idxs = segs
                    base = [row_of(t) for t in ts]
                    maps.append([base[i] for i in idxs])
            return texts, maps

        p_texts, p_maps = maps_for(
            [str(r.get("prompt", "")) for r in requests])
        u_texts, u_maps = [], []
        if use_cfg:
            u_texts, u_maps = maps_for(
                [str(r.get("nprompt", "")) for r in requests])
        bank_pts = ([self._parse_prompt_text(t, allow_loras=True)
                     for t in p_texts]
                    + [self._parse_prompt_text(t) for t in u_texts])
        rows, lrows = self._text_cond_encode_rows(
            bank_pts, uncond_rows=len(u_texts))
        rows = np.asarray(rows, np.float32)
        k = len(p_texts)
        if use_cfg and self._mt.unet_p.uncond_empty_zero:
            for j, t in enumerate(u_texts):
                if not t:
                    rows[k + j] = 0.0
        idx = np.empty((n_plan, (2 * n) if use_cfg else n), np.int32)
        for s in range(n_plan):
            for r in range(n):
                idx[s, r] = p_maps[r][s]
                if use_cfg:
                    idx[s, n + r] = k + u_maps[r][s]
        log.info(f"Prompt editing (batch): {k} prompt"
                 + (f" + {len(u_texts)} negative" if use_cfg else "")
                 + f" segment(s) over {n_plan} steps")
        return rows, lrows, idx

    def _text_cond_encode_rows(self, pts: List[prompt_mod.PromptText],
                               uncond_rows: int = 0):
        """Full conditioning for several prompts in batched encoder calls,
        incl. SDXL dual-encoder + size labels (reference:
        mlis_text_cond_encode, src/mlimgsynth.c:1486-1563).  Returns
        (cond [n,77,d], label [n,ch_adm_in] or None).  ``uncond_rows``:
        the LAST k rows are uncond (only the SDXL-refiner's aesthetic
        score differs per row)."""
        mt = self._mt
        norm = mt.unet_p.clip_norm
        flow = getattr(mt.unet_p, "flow", False)
        flux = getattr(mt.unet_p, "flux", False)
        single_label = mt.unet_p.cond_label and mt.clip2_p is None \
            and not flow
        rows, wrows = [], []
        for pt in pts:
            toks, wts = self._prompt_tokens(pt)
            rows.append(toks)
            wrows.append(wts)
        # for single-tower label models (SDXL-refiner) the SAME pass yields
        # the skip-layer embedding and the projected pooled feature
        cond, feat1 = self._clip_encode_rows(rows, wrows, "clip",
                                             single_label or flow, norm,
                                             self.c["clip_skip"])
        label = None
        if flux:
            # Flux: context = T5 rows only; label = the clip tower's
            # unprojected pooled row (the guidance column, if any, is
            # appended by the caller — it is generation-scoped)
            label = feat1
            cond = self._t5_encode_rows(pts, mt.unet_p.d_ctx_in)
        elif flow:
            # SD3 conditioning: both towers' skip-layer hiddens concat on
            # the feature axis, zero-padded to the t5 width, then the T5
            # context rows (zeros when no --t5 file is loaded — the same
            # convention the public SD3 pipelines use); the adaLN "label"
            # vector is the concat of the projected pooled features.
            emb2, feat2 = self._clip_encode_rows(rows, wrows, "clip2",
                                                 True, norm,
                                                 self.c["clip_skip"])
            d_ctx = mt.unet_p.d_ctx_in
            clip_part = np.concatenate([cond, emb2], axis=-1)
            pad = d_ctx - clip_part.shape[-1]
            clip_part = np.pad(clip_part.astype(np.float32),
                               ((0, 0), (0, 0), (0, pad)))
            t5_part = self._t5_encode_rows(pts, d_ctx)
            cond = np.concatenate([clip_part, t5_part], axis=1)
            label = np.concatenate([feat1, feat2], axis=-1)
        elif mt.unet_p.cond_label:
            from .models.blocks import timestep_embedding
            import jax.numpy as jnp
            h, w = self.c["height"], self.c["width"]
            if mt.clip2_p is not None:
                # ONE clip2 (bigG) pass yields both the skip-layer embedding
                # and the full-stack projected feature (clip_text_apply
                # captures the skip hidden mid-stack): one dispatch + half
                # the encoder cost vs running the tower twice
                emb2, feat = self._clip_encode_rows(rows, wrows, "clip2",
                                                    True, norm,
                                                    self.c["clip_skip"])
                cond = np.concatenate([cond, emb2], axis=-1)
                sizes = np.array([h, w, 0, 0, h, w], np.float32)
                se = np.asarray(timestep_embedding(jnp.asarray(sizes), 256),
                                np.float32).reshape(-1)
                serows = np.tile(se, (len(pts), 1))
            else:
                # SDXL-refiner: [orig_h, orig_w, crop_top, crop_left,
                # aesthetic_score] per row (sgm GeneralConditioner)
                feat = feat1
                from .models.unet import AESTHETIC_SCORE, AESTHETIC_NSCORE
                n = len(pts)
                scores = [AESTHETIC_NSCORE if i >= n - uncond_rows
                          else AESTHETIC_SCORE for i in range(n)]
                sizes = np.asarray([[h, w, 0, 0, s] for s in scores],
                                   np.float32)
                serows = np.asarray(
                    timestep_embedding(jnp.asarray(sizes.reshape(-1)), 256),
                    np.float32).reshape(n, -1)
            label = np.concatenate([feat, serows], axis=-1)
        return cond, label

    def _text_cond_encode(self, pt: prompt_mod.PromptText):
        cond, label = self._text_cond_encode_rows([pt])
        return cond, label

    def _t5_encode_rows(self, pts: List[prompt_mod.PromptText],
                        d_ctx: int) -> np.ndarray:
        """T5 context rows for flow (SD3) conditioning: the T5 encoder
        output when T5 weights are available (bundled in the model file or
        via ``--t5``) AND a ``--t5-tokenizer`` tokenizer.json is set; else
        zero rows of the CLIP token length (the public SD3 pipelines'
        no-T5 mode)."""
        n = len(pts)
        have = bool(self.c["t5"]) or \
            "t5.shared.weight" in (self._name_map or {})
        if not have or not self.c["t5_tokenizer"]:
            if have and not self.c["t5_tokenizer"]:
                log.warning("T5 weights present but no t5-tokenizer set; "
                            "using zero T5 context rows")
            return np.zeros((n, self._mt.clip_p.n_token, d_ctx), np.float32)
        import jax.numpy as jnp
        from .models import t5 as t5_mod
        params = self._get_params("t5")
        texts = [pt.text for pt in pts]
        toks = t5_mod.tokenize(texts, n_token=int(self.c["t5_tokens"] or 77),
                               tokenizer_json=self._aux_find(
                                   self.c["t5_tokenizer"]))
        emb = _t5_jit(params, jnp.asarray(toks, jnp.int32),
                      t5_p=self._t5_p, dtype=self._dtype)
        emb = np.asarray(emb, np.float32)
        if emb.shape[-1] < d_ctx:
            emb = np.pad(emb, ((0, 0), (0, 0), (0, d_ctx - emb.shape[-1])))
        return emb

    def _cond_token_rows(self, pts: List[prompt_mod.PromptText],
                         submodel: str = "clip", want_fidx: bool = False):
        """Wrapped token rows + emphasis-weight rows for the fused-encode
        path (CLIP forward runs inside the loop program).  With
        ``want_fidx`` returns feature-token indices instead of weights
        (the SDXL clip2 feature head reads the end-token position)."""
        P = self._mt.clip_p if submodel == "clip" else self._mt.clip2_p
        raw = [self._prompt_tokens(pt) for pt in pts]
        W = self._window_count(P, raw)
        toks_rows, wrows, fidx = [], [], []
        for toks, wts in raw:
            wins, wmats, f0 = tok_mod.split_windows(P, toks, wts,
                                                    n_window=W)
            toks_rows.append(wins[0] if W == 1 else wins[:W])
            wrows.append(wmats[0] if W == 1
                         else np.concatenate(wmats[:W]))
            fidx.append(f0)
        if want_fidx:
            return (np.asarray(toks_rows, np.int32),
                    np.asarray(fidx, np.int32))
        return (np.asarray(toks_rows, np.int32),
                np.asarray(wrows, np.float32))

    def _window_count(self, P, raw) -> int:
        """Shared encoder-window count for a batch of token streams
        (A1111 long-prompt chunking: every row of a batched encode is
        padded with empty windows to the longest row's count).  Flow
        models (SD3/Flux) condition their CLIP towers on a single
        window: longer prompts truncate with a warning (the T5 context
        carries the full text up to --t5-tokens)."""
        W = max(len(tok_mod.split_windows(P, t, w)[0]) for t, w in raw)
        if W > 1 and getattr(self._mt.unet_p, "flow", False):
            log.warning(
                f"prompt exceeds {P.n_token - 2} CLIP tokens; flow-model "
                "CLIP towers use the first window only")
            W = 1
        if W > 1:
            log.info(f"Long prompt: {W} encoder windows "
                     f"({W * P.n_token}-token context)")
        return W

    # per-family FreeU v1 defaults (the FreeU README's recommended ranges)
    _FREEU_DEFAULTS = {"sd1": (1.5, 1.6, 0.9, 0.2),
                       "sd2": (1.4, 1.6, 0.9, 0.2),
                       "sdxl": (1.3, 1.4, 0.9, 0.2)}

    @staticmethod
    def _freeu_parse(v: str):
        """Parse a --freeu value: falsy -> None, truthy -> "auto",
        explicit "B1,B2,S1,S2" -> a 4-tuple."""
        v = str(v).strip()
        if not v or v.lower() in ("0", "n", "no", "false", "off"):
            return None
        if v.lower() in ("1", "y", "yes", "true", "on", "auto"):
            return "auto"
        try:
            parts = tuple(float(x) for x in v.replace(";", ",").split(","))
        except ValueError:
            parts = ()
        if len(parts) != 4:
            raise MlisError(MlisError.E_OPT_VALUE,
                            "freeu: expected y/n or B1,B2,S1,S2")
        return parts

    def _freeu_resolve(self):
        """The effective FreeU (b1, b2, s1, s2) for the loaded model, or
        None.  "auto" picks the per-family recommended values."""
        fu = self._freeu_parse(self.c["freeu"])
        if fu is None:
            return None
        mt = self._mt
        if getattr(mt.unet_p, "flow", False):
            raise MlisError(MlisError.E_OPT_VALUE,
                            "freeu applies to UNet families only")
        if fu != "auto":
            return fu
        fam = ("sdxl" if mt.unet_p.ch_adm_in
               else "sd2" if mt.unet_p.n_ctx >= 1024 else "sd1")
        return self._FREEU_DEFAULTS[fam]

    # ------------------------------------------------------------------
    # Image encode/decode (reference: mlis_image_encode/decode)
    # ------------------------------------------------------------------

    def image_encode(self, img: np.ndarray, sample: bool = True
                     ) -> np.ndarray:
        """img NCHW [n,3,h,w] in [0,1] -> scaled latent [n,4,h/8,w/8]."""
        self.setup()
        if self.c["tae"]:
            lat = self._tae_encode(img)
        else:
            lat = self._vae_encode(img, sample=sample)
        if not np.isfinite(lat).all():
            raise MlisError(MlisError.E_NAN, "NaN found in encoded latent")
        self._cb(STAGE_IMAGE_ENCODE, 1, 1)
        return lat

    def image_decode(self, latent: np.ndarray) -> np.ndarray:
        """latent NCHW [n,4,h,w] (scaled) -> image [n,3,8h,8w] in [0,1]."""
        self.setup()
        if self.c["tae"]:
            img = self._tae_decode(latent)
        else:
            img = self._vae_decode(latent)
        if not np.isfinite(img).all():
            raise MlisError(MlisError.E_NAN, "NaN found in decoded image")
        self._cb(STAGE_IMAGE_DECODE, 1, 1)
        return img

    def mask_encode(self, mask: np.ndarray) -> np.ndarray:
        """Image mask -> latent mask by block-mean downsize
        (reference: mlis_mask_encode)."""
        f = self._mt.vae_p.f_down if self._mt else 8
        return image_mod.mask_downsize(mask, f)

    # ------------------------------------------------------------------
    # ESRGAN upscaler (beyond-reference; A1111 "Extras"/hr_upscaler)
    # ------------------------------------------------------------------

    def _upscaler_get(self):
        if not self.c["upscaler"]:
            raise MlisError(
                MlisError.E_OPT_VALUE,
                "no upscaler model configured (option 'upscaler')")
        if self._upscaler is None:
            from .models import esrgan as esr_mod
            path = self._aux_find(self.c["upscaler"])
            t0 = time.time()
            params, P = esr_mod.load_esrgan(path, dtype=self._dtype)
            self._upscaler = (params, P)
            arch = type(P).__name__.replace("Params", "")
            depth = getattr(P, "n_block", None) or getattr(P, "n_conv", 0)
            log.info(f"Upscaler: {os.path.basename(path)} x{P.scale} "
                     f"({arch} f{P.n_feat} d{depth}) "
                     f"{{{time.time() - t0:.3f}s}}")
        return self._upscaler

    def upscale(self, img: np.ndarray, resize: Optional[float] = None,
                tile: int = 0) -> np.ndarray:
        """Upscale images NCHW [n,3,h,w] in [0,1] with the configured
        ESRGAN model.  ``resize`` requests a final scale factor; the
        model's native-factor output is Lanczos-resized when they differ
        (A1111 ``upscaling_resize`` semantics).  ``tile`` bounds the
        per-dispatch activation size (edge px; 0 = whole image): the
        tiled pass is ONE device dispatch (same scan design as VAE
        tiling), seams blended by inner-region ownership."""
        with self._lock:
            import jax.numpy as jnp

            from .models import esrgan as esr_mod
            params, P = self._upscaler_get()
            img = np.asarray(img, np.float32)
            h, w = img.shape[2], img.shape[3]
            u = P.unshuffle
            ph, pw = (-h) % u, (-w) % u
            if ph or pw:   # x2/x1 models space-to-depth the input: pad
                img = np.pad(img, ((0, 0), (0, 0), (0, ph), (0, pw)),
                             mode="edge")
            x = jnp.asarray(img.transpose(0, 2, 3, 1))
            hp, wp = img.shape[2], img.shape[3]   # padded dims
            k = max(P.unshuffle, 16 // P.unshuffle * P.unshuffle)
            if tile and (tile + 2 * k < wp or tile + 2 * k < hp):
                t = max(u, (tile + u - 1) // u * u)
                n0 = min((t + 2 * k), wp) // u * u
                n1 = min((t + 2 * k), hp) // u * u
                origins, boxes = _tile_geometry(wp, hp, n0, n1, k)
                log.info(f"ESRGAN tiled upscale: {len(origins)} tiles "
                         f"of {n0}x{n1}px in one dispatch")
                out = np.asarray(esr_mod.esrgan_run_tiled(
                    params, x, origins, boxes, P, tn1=n1, tn0=n0,
                    dtype=self._dtype), np.float32).transpose(0, 3, 1, 2)
            else:
                out = np.asarray(
                    esr_mod.esrgan_run(params, x, P, dtype=self._dtype),
                    np.float32).transpose(0, 3, 1, 2)
            out = out[:, :, :h * P.scale, :w * P.scale]  # drop pad
            if resize and abs(float(resize) - P.scale) > 1e-6:
                out = _lanczos_resize(out, int(round(h * float(resize))),
                                      int(round(w * float(resize))))
            return out

    def _vae_encode(self, img: np.ndarray, sample: bool) -> np.ndarray:
        params = self._get_params("vae")
        P = self._mt.vae_p
        tile = self.c["vae_tile"]
        x = np.asarray(img, np.float32) * 2.0 - 1.0  # [0,1] -> [-1,1]
        if tile > 0:
            mom = _tiled_encode(params, x, P, tile, self._dtype)
        else:
            mom = np.asarray(_vae_encode_jit(
                params, x.transpose(0, 2, 3, 1), vae_p=P,
                dtype=self._dtype, tiling=self.c["tiling"]),
                np.float32).transpose(0, 3, 1, 2)
        if sample:
            n, _, h, w = mom.shape
            streams = [RngPhilox(self.rng.seed + i, self.rng.offset)
                       for i in range(n)]
            rand = np.stack([st.randn_shaped((P.ch_z, h, w))
                             for st in streams])
            self.rng.offset = streams[0].offset
            mean = mom[:, :P.ch_z]
            logvar = np.clip(mom[:, P.ch_z:], -30, 20)
            return ((mean + np.exp(logvar * 0.5) * rand)
                    * P.scale_factor).astype(np.float32)
        return (mom[:, :P.ch_z] * P.scale_factor).astype(np.float32)

    def _vae_decode(self, latent: np.ndarray) -> np.ndarray:
        params = self._get_params("vae")
        P = self._mt.vae_p
        tile = self.c["vae_tile"]
        lat = np.asarray(latent, np.float32)
        if tile > 0:
            img = _tiled_decode(params, lat, P, tile, self._dtype)
        else:
            img = np.asarray(_vae_decode_jit(
                params, lat.transpose(0, 2, 3, 1), vae_p=P,
                dtype=self._dtype, tiling=self.c["tiling"]),
                np.float32).transpose(0, 3, 1, 2)
        return (img + 1.0) / 2.0

    def _tae_encode(self, img: np.ndarray) -> np.ndarray:
        params = self._get_params("tae")
        lat = np.asarray(_tae_encode_jit(
            params, np.asarray(img, np.float32).transpose(0, 2, 3, 1),
            dtype=self._dtype, tae_p=self._tae_p),
            np.float32).transpose(0, 3, 1, 2)
        return lat

    def _tae_decode(self, latent: np.ndarray) -> np.ndarray:
        params = self._get_params("tae")
        img = np.asarray(_tae_decode_jit(
            params, np.asarray(latent, np.float32).transpose(0, 2, 3, 1),
            dtype=self._dtype, tae_p=self._tae_p),
            np.float32).transpose(0, 3, 1, 2)
        return np.clip(img, 0.0, 1.0)

    # ------------------------------------------------------------------
    # Generate (reference: mlis_generate, src/mlimgsynth.c:1634-1773)
    # ------------------------------------------------------------------

    def _guidance_checks(self, unet_p) -> None:
        """Pre-trace validation of the SLG/PAG guidance options: family
        match, layer range, step window, and unsupported combinations all
        surface as MlisError(E_OPT_VALUE) — the library's option-error
        convention — instead of ValueError/AssertionError mid-sampling
        (reference: every option path returns MLIS_E_OPT_VALUE,
        src/mlimgsynth_options_set.c.h)."""
        c = self.c
        flow = getattr(unet_p, "flow", False)
        if c["slg_scale"]:
            if not flow:
                raise MlisError(MlisError.E_OPT_VALUE,
                                "slg-scale requires a DiT model (SD3/Flux)")
            if c["slg_end"] <= c["slg_start"]:
                raise MlisError(
                    MlisError.E_OPT_VALUE,
                    f"slg window is empty: slg-end ({c['slg_end']:g}) must "
                    f"be > slg-start ({c['slg_start']:g})")
            depth = (getattr(unet_p, "depth", 0)
                     or getattr(unet_p, "depth_double", 0)
                     + getattr(unet_p, "depth_single", 0))
            layers = tuple(int(v) for v in str(c["slg_layers"]).split(",")
                           if str(v).strip())
            if not layers or min(layers) < 0 or max(layers) >= depth:
                raise MlisError(
                    MlisError.E_OPT_VALUE,
                    f"slg-layers out of range for depth {depth}: "
                    f"{c['slg_layers']}")
            if c["pp"] > 1:
                raise MlisError(
                    MlisError.E_OPT_VALUE,
                    "slg-scale is not supported with --pp block stacking")
        if c["pag_scale"]:
            if flow:
                raise MlisError(MlisError.E_OPT_VALUE,
                                "pag-scale requires an SD-UNet model")
            if c["pag_end"] <= c["pag_start"]:
                raise MlisError(
                    MlisError.E_OPT_VALUE,
                    f"pag window is empty: pag-end ({c['pag_end']:g}) must "
                    f"be > pag-start ({c['pag_start']:g})")
            if c["deepcache"] > 1:
                raise MlisError(MlisError.E_OPT_VALUE,
                                "pag-scale is not supported with deepcache")

    def generate(self) -> np.ndarray:
        with self._lock:
            return self._generate_guarded()

    def _generate_guarded(self) -> np.ndarray:
        try:
            trace_dir = os.environ.get("MLIS_TRACE")
            if trace_dir:
                import jax
                with jax.profiler.trace(trace_dir):
                    return self._generate()
            return self._generate()
        except MlisError as e:
            self._err(e)

    def _generate(self) -> np.ndarray:
        self.setup()
        c = self.c
        if (c["inpaint_full_res"] and not self._in_fullres
                and c["tuflags"] & TUF_IMAGE and c["tuflags"] & TUF_MASK):
            return self._inpaint_fullres_generate()
        if self.c["hires_fix"] > 1.0 and not self._in_hires:
            return self._hires_generate()
        if (self.c["refiner"] and not self._in_refiner
                and not self._in_hires):
            return self._refiner_generate()
        t_start = time.time()
        self.progress = {"stage": STAGE_IDLE, "step": 0, "step_end": 0,
                         "nfe": 0, "step_time": 0.0, "_t": t_start}
        self._nfe = 0
        c = self.c
        mt = self._mt
        f = mt.vae_p.f_down
        n_batch = c["n_batch"]
        w = c["width"] // f
        h = c["height"] // f

        # initial latent
        if c["tuflags"] & TUF_IMAGE:
            img = self.tensors["image"]
            if img.shape[0] != n_batch:
                img = np.repeat(img, n_batch // img.shape[0], axis=0)
            self.tensors["latent"] = self.image_encode(img)
            c["tuflags"] |= TUF_LATENT
        if c["tuflags"] & TUF_LATENT:
            latent = np.asarray(self.tensors["latent"], np.float32)
            if latent.shape[0] < n_batch:
                latent = np.repeat(latent, n_batch, axis=0)
            h, w = latent.shape[2], latent.shape[3]
        else:
            log.debug("Empty initial latent")
            latent = np.zeros((n_batch, mt.vae_p.ch_z, h, w), np.float32)
        log.info(f"Output size: {w * f}x{h * f}")

        # masks
        if c["tuflags"] & TUF_MASK:
            mask_in = self.tensors["mask"]
            if c["mask_blur"] > 0:
                mask_in = image_mod.mask_gaussian_blur(
                    np.asarray(mask_in, np.float32), c["mask_blur"])
            self.tensors["lmask"] = self.mask_encode(mask_in)
            c["tuflags"] |= TUF_LMASK
        lmask = (self.tensors["lmask"] if c["tuflags"] & TUF_LMASK else None)
        if lmask is not None:
            log.info("In-painting with mask")

        # inpaint-variant model (n_ch_in > latent channels, e.g.
        # sd-v1-5-inpainting's 9): build the extra UNet input channels —
        # repaint mask (1 - keep) at latent resolution + masked-image
        # latent (deterministic encode of image * keep, diffusers
        # SD-inpaint convention).  The learned conditioning replaces the
        # per-step latent-blend hack, so lmask is consumed here.
        extra_spec = None
        if mt.unet_p.n_ch_in > mt.vae_p.ch_z \
                and not getattr(mt.unet_p, "flow", False):
            if mt.unet_p.n_ch_in != 2 * mt.vae_p.ch_z + 1:
                raise MlisError(
                    -1, f"unsupported UNet input channels "
                    f"{mt.unet_p.n_ch_in} (expected "
                    f"{2 * mt.vae_p.ch_z + 1} for an inpaint variant)")
            keep_lat = (np.asarray(lmask[:1], np.float32)
                        if lmask is not None
                        else np.zeros((1, 1, h, w), np.float32))
            mlat = np.zeros((1, mt.vae_p.ch_z, h, w), np.float32)
            if c["tuflags"] & TUF_IMAGE and \
                    self.tensors.get("image") is not None:
                img_in = np.asarray(self.tensors["image"][:1], np.float32)
                if (c["tuflags"] & TUF_MASK and
                        self.tensors.get("mask") is not None):
                    keep_img = np.asarray(self.tensors["mask"][:1],
                                          np.float32)
                else:  # latent-res keep mask upsampled to image res
                    fk = img_in.shape[2] // keep_lat.shape[2]
                    keep_img = np.repeat(np.repeat(keep_lat, fk, 2), fk, 3)
                # encode in [-1,1]; repainted area = 0.5 maps to 0 (gray)
                masked = img_in * keep_img + 0.5 * (1.0 - keep_img)
                mlat = self.image_encode(masked, sample=False)[:1]
            extra_spec = np.concatenate([1.0 - keep_lat, mlat], axis=1)
            lmask = None
            log.info("Inpaint-variant conditioning "
                     f"({mt.unet_p.n_ch_in} input channels)")

        # conditioning.  The CLIP forward(s) fuse INTO the loop program
        # (encode_spec below) and only tokens are prepared here — on the
        # single-dispatch path AND on the cancellable (step-callback) path,
        # where the encode rides the first chunk's dispatch.  SDXL
        # additionally fuses the bigG tower, the feature head, and the
        # size-label concat.
        flow = getattr(mt.unet_p, "flow", False)
        flux = getattr(mt.unet_p, "flux", False)
        # guidance-distilled models (flux dev): cfg_scale becomes the
        # EMBEDDED guidance value — no uncond pass, NFE per step is 1
        guidance_embed = getattr(mt.unet_p, "guidance_embed", False)
        eff_cfg = 1.0 if guidance_embed else c["cfg_scale"]
        # prompt editing ([from:to:when] / [a|b]): expand per schedule
        # step, encode every distinct text once, gather per-step rows
        # from the conditioning bank inside the loop
        edit_segs = edit_steps = None
        if (not c["no_prompt_parse"]
                and not (c["tuflags"] & TUF_CONDITIONING)
                and (self.prompt.editing
                     or (eff_cfg > 1 and self.nprompt.editing))):
            if flow:
                raise MlisError(
                    MlisError.E_OPT_VALUE,
                    "prompt editing is not supported for flow models")
            from .sampling.sampler import plan_n_step
            n_plan = plan_n_step(SamplerConfig(
                method=c["method"], sched=c["scheduler"],
                n_step=c["steps"], cfg_scale=eff_cfg,
                s_ancestral=c["s_ancestral"], s_noise=c["s_noise"],
                f_t_ini=c["f_t_ini"], f_t_end=c["f_t_end"],
                keep_tail=self._keep_tail, noise_add=self._noise_add),
                2 if eff_cfg > 1 else 1)
            ep = prompt_mod.editing_segments(c["prompt_raw"], n_plan)
            en = (prompt_mod.editing_segments(c["nprompt_raw"], n_plan)
                  if eff_cfg > 1 else None)
            if ep is not None or en is not None:
                edit_segs = (ep, en, n_plan)
        fuse_encode = (self.step_observer is None and self._mesh is None
                       and not c["unet_split"] and edit_segs is None
                       and not (c["tuflags"] & TUF_CONDITIONING))
        encode_spec = None
        if fuse_encode:
            pts = [self.prompt] + ([self.nprompt] if eff_cfg > 1
                                   else [])
            tokens, wmat = self._cond_token_rows(pts)
            if (mt.unet_p.uncond_empty_zero and eff_cfg > 1
                    and not c["nprompt_raw"]):
                # zero uncond embedding rows via the weight matrix
                # (reference: src/mlimgsynth.c:1702)
                wmat[1] = 0.0
            if n_batch > 1:  # [cond x n ; uncond x n] row layout
                tokens = np.repeat(tokens, n_batch, axis=0)
                wmat = np.repeat(wmat, n_batch, axis=0)
            encode_spec = (self._get_params("clip"), tokens, wmat,
                           mt.clip_p, c["clip_skip"], mt.unet_p.clip_norm)
            if flux:
                # Flux: T5 rows are the whole context; the clip pooled
                # head fuses into the loop, with the embedded-guidance
                # column for dev models
                _, fidx = self._cond_token_rows(pts, want_fidx=True)
                t5_rows = self._t5_encode_rows(pts, mt.unet_p.d_ctx_in)
                grow = (np.full((len(pts), 1), c["cfg_scale"], np.float32)
                        if guidance_embed else None)
                if n_batch > 1:
                    fidx = np.repeat(fidx, n_batch, axis=0)
                    t5_rows = np.repeat(t5_rows, n_batch, axis=0)
                    grow = (np.repeat(grow, n_batch, axis=0)
                            if grow is not None else None)
                encode_spec = encode_spec + (fidx, t5_rows, grow)
            elif flow:
                # SD3: both towers + pooled heads fuse into the loop
                # program; T5 rows are precomputed (zeros without --t5)
                _, fidx = self._cond_token_rows(pts, want_fidx=True)
                tokens2, fidx2 = self._cond_token_rows(pts, submodel="clip2",
                                                       want_fidx=True)
                t5_rows = self._t5_encode_rows(pts, mt.unet_p.d_ctx_in)
                if n_batch > 1:
                    tokens2 = np.repeat(tokens2, n_batch, axis=0)
                    fidx = np.repeat(fidx, n_batch, axis=0)
                    fidx2 = np.repeat(fidx2, n_batch, axis=0)
                    t5_rows = np.repeat(t5_rows, n_batch, axis=0)
                encode_spec = encode_spec + (
                    self._get_params("clip2"), tokens2, fidx, fidx2,
                    t5_rows, mt.clip2_p)
            elif mt.unet_p.cond_label and mt.clip2_p is not None:
                tokens2, fidx = self._cond_token_rows(pts, submodel="clip2",
                                                      want_fidx=True)
                if n_batch > 1:
                    tokens2 = np.repeat(tokens2, n_batch, axis=0)
                    fidx = np.repeat(fidx, n_batch, axis=0)
                h_, w_ = self.c["height"], self.c["width"]
                from .models.blocks import timestep_embedding
                import jax.numpy as jnp
                sizes = np.array([h_, w_, 0, 0, h_, w_], np.float32)
                size_emb = np.asarray(
                    timestep_embedding(jnp.asarray(sizes), 256),
                    np.float32).reshape(-1)
                encode_spec = encode_spec + (
                    self._get_params("clip2"), tokens2, fidx, size_emb,
                    mt.clip2_p)
            elif mt.unet_p.cond_label:
                # SDXL-refiner: the single tower's feature head reads the
                # end-token row; label rows = feat + per-row size/aesthetic
                # embeddings (the uncond row carries the negative score)
                _, fidx = self._cond_token_rows(pts, want_fidx=True)
                h_, w_ = self.c["height"], self.c["width"]
                from .models.blocks import timestep_embedding
                from .models.unet import AESTHETIC_SCORE, AESTHETIC_NSCORE
                import jax.numpy as jnp
                scores = [AESTHETIC_SCORE] + (
                    [AESTHETIC_NSCORE] if len(pts) > 1 else [])
                sizes = np.asarray([[h_, w_, 0, 0, s] for s in scores],
                                   np.float32)
                serows = np.asarray(
                    timestep_embedding(jnp.asarray(sizes.reshape(-1)), 256),
                    np.float32).reshape(len(pts), -1)
                if n_batch > 1:
                    fidx = np.repeat(fidx, n_batch, axis=0)
                    serows = np.repeat(serows, n_batch, axis=0)
                encode_spec = encode_spec + (fidx, serows)
            cond = ncond = label = nlabel = None
            # the encode compute rides the first loop dispatch; the stage
            # event still fires for callback clients (reference contract)
            self._cb(STAGE_COND_ENCODE, 1, 1)
        elif not (c["tuflags"] & TUF_CONDITIONING):
            ncond = nlabel = None
            if edit_segs is not None:
                cond, label, edit_steps = self._edit_cond_bank(
                    edit_segs, eff_cfg, n_batch)
                self.tensors["cond"], self.tensors["label"] = cond, label
                self.tensors["ncond"] = self.tensors["nlabel"] = None
                self._cb(STAGE_COND_ENCODE, 1, 1)
            elif eff_cfg > 1:
                # prompt + nprompt ride one batched encoder call
                both, lboth = self._text_cond_encode_rows(
                    [self.prompt, self.nprompt], uncond_rows=1)
                cond, ncond = both[0:1], both[1:2]
                label = lboth[0:1] if lboth is not None else None
                nlabel = lboth[1:2] if lboth is not None else None
                if mt.unet_p.uncond_empty_zero and not c["nprompt_raw"]:
                    ncond = np.zeros_like(ncond)
            else:
                cond, label = self._text_cond_encode(self.prompt)
            self.tensors["cond"], self.tensors["label"] = cond, label
            self.tensors["ncond"], self.tensors["nlabel"] = ncond, nlabel
            self._cb(STAGE_COND_ENCODE, 1, 1)
        if not fuse_encode:
            cond = self.tensors["cond"]
            ncond = self.tensors["ncond"]
            label, nlabel = self.tensors["label"], self.tensors["nlabel"]
            if guidance_embed and label is not None \
                    and label.shape[-1] == mt.unet_p.d_pooled:
                # append the generation-scoped embedded-guidance column
                gcol = np.full((label.shape[0], 1), c["cfg_scale"],
                               np.float32)
                label = np.concatenate([np.asarray(label, np.float32),
                                        gcol], axis=-1)
                if nlabel is not None:
                    nlabel = np.concatenate(
                        [np.asarray(nlabel, np.float32),
                         gcol[:nlabel.shape[0]]], axis=-1)
            if log.check(LVL_DEBUG):
                from .utils.tensorstat import stat_line
                log.debug(stat_line(cond, "cond"))
                log.debug(stat_line(label, "label"))
                if c["cfg_scale"] > 1 and ncond is not None:
                    log.debug(stat_line(ncond, "uncond"))
                    log.debug(stat_line(nlabel, "unlabel"))
            if edit_steps is None and cond.shape[0] < n_batch:
                cond = np.repeat(cond, n_batch, axis=0)
                ncond = np.repeat(ncond, n_batch, axis=0) \
                    if ncond is not None else None
                label = np.repeat(label, n_batch, axis=0) \
                    if label is not None else None
                nlabel = np.repeat(nlabel, n_batch, axis=0) \
                    if nlabel is not None else None

        # sampling
        self._guidance_checks(mt.unet_p)
        flow_shift = getattr(mt.unet_p, "flow_shift", 0.0) if flow else 0.0
        if flow and getattr(mt.unet_p, "dynamic_shift", False):
            from .models.flux import dynamic_flow_shift
            flow_shift = dynamic_flow_shift(mt.unet_p, h, w)
        scfg = SamplerConfig(
            method=c["method"], sched=c["scheduler"], n_step=c["steps"],
            cfg_scale=eff_cfg, s_ancestral=c["s_ancestral"],
            s_noise=c["s_noise"], f_t_ini=c["f_t_ini"], f_t_end=c["f_t_end"],
            keep_tail=self._keep_tail, noise_add=self._noise_add,
            flow_shift=flow_shift, cfg_rescale=c["cfg_rescale"],
            **_slg_kw(c))
        nfe_per_dxdt = 2 if eff_cfg > 1 else 1
        subseeds = None
        if c["subseed_strength"] > 0:
            # default: offset far from the seed streams (seed+i), so row
            # i's variation noise never equals row i+1's base noise
            sub0 = (c["subseed"] if c["subseed"] >= 0
                    else self.rng.seed + (1 << 31))
            self._subseed_eff = sub0  # for the infotext; option untouched
            subseeds = [sub0 + i for i in range(n_batch)]
        plan = make_plan(scfg, latent.shape, self.rng, nfe_per_dxdt,
                         subseeds=subseeds,
                         subseed_strength=c["subseed_strength"])
        log.info(
            f"Generating (solver: {c['method']}, sched: {c['scheduler']}, "
            f"ancestral: {c['s_ancestral']:g}, snoise: {c['s_noise']:g}, "
            f"cfg-s: {c['cfg_scale']:g}, steps: {plan.n_step}, "
            f"nfe/s: {plan.nfe_per_step})")

        params = self._get_params("unet")
        control_spec = None
        if c["control_net"]:
            hint = self.tensors.get("control_image")
            if hint is None:
                raise MlisError(
                    MlisError.E_IMAGE,
                    "control-net is set but no control-image was given")
            if hint.shape[2:] != (h * f, w * f):
                raise MlisError(
                    MlisError.E_IMAGE,
                    f"control image size {hint.shape[3]}x{hint.shape[2]} "
                    f"does not match output {w * f}x{h * f}")
            # ControlNet params join the UNet dict (flat namespaces are
            # disjoint: cnet.* vs unet.*) so the loop program sees both
            params = {**params, **self._get_params("cnet")}
            control_spec = (hint[:1], c["control_strength"])
            log.info(f"ControlNet active (strength: "
                     f"{c['control_strength']:g})")
        if c["unet_split"]:
            # stage-wise residency: drop text-encoder weights during the loop
            self._free_params("clip")
            self._free_params("clip2")

        step_cb = None
        if self.callback is not None:
            def step_cb(i, n):
                # i is the completed step count (chunked progress may skip
                # intermediate callbacks)
                self._nfe = i * plan.nfe_per_step
                try:
                    self._cb(STAGE_DENOISE, i, n)
                except Aborted:
                    return True
                return False

        # Fused decode: run loop + VAE/TAE + u8 quantize in ONE compiled
        # program.  On the single-dispatch path that makes the whole
        # generation one dispatch + one image fetch; on the cancellable
        # (step-callback) path the decode rides the final chunk's dispatch.
        decode_spec = None
        if (self.step_observer is None and not c["no_decode"]
                and c["vae_tile"] <= 0 and not c["unet_split"]):
            if c["tae"]:
                decode_spec = ("tae", self._get_params("tae"), self._tae_p)
            else:
                decode_spec = ("vae", self._get_params("vae"), mt.vae_p)

        t_comp = time.time()
        u8 = None
        self._deepcache_check(mt.unet_p, control_spec, extra_spec,
                              edit_steps)
        out = run_sampler(params, latent, plan, cond, ncond, label,
                          nlabel, lmask, scfg, mt.unet_p,
                          dtype=self._dtype, step_callback=step_cb,
                          step_observer=self.step_observer,
                          mesh=self._mesh, decode=decode_spec,
                          encode=encode_spec, control=control_spec,
                          extra_channels=extra_spec,
                          cond_steps=edit_steps,
                          deepcache=c["deepcache"], tiling=c["tiling"],
                          freeu=self._freeu_resolve())
        if encode_spec is not None:
            if decode_spec is not None:
                latent, u8, (cond_dev, lab_dev) = out
            else:
                latent, (cond_dev, lab_dev) = out
            # lazy device arrays: fetched only if a caller reads the slots
            n = latent.shape[0]
            self.tensors["cond"] = cond_dev[:n]
            self.tensors["ncond"] = (cond_dev[n:] if eff_cfg > 1
                                     else None)
            if lab_dev is not None:   # SDXL size labels computed in-loop
                self.tensors["label"] = lab_dev[:n]
                self.tensors["nlabel"] = (lab_dev[n:] if eff_cfg > 1
                                          else None)
        elif decode_spec is not None:
            latent, u8 = out
        else:
            latent = out
        if "unet" in self.stats:
            st = self.stats["unet"]
            st["n_compute"] = st.get("n_compute", 0) + plan.n_step
            st["t_compute"] = st.get("t_compute", 0.0) + time.time() - t_comp
        solver_nfe = get_solver(c["method"]).n_fe
        exact_nfe = ((plan.n_step * solver_nfe - (solver_nfe - 1))
                     * nfe_per_dxdt)
        if step_cb is None:
            self._nfe = exact_nfe
        else:
            self._nfe = min(self._nfe, exact_nfe)
        if not np.isfinite(latent).all():
            raise MlisError(MlisError.E_NAN, "NaN found in UNet output")
        self.tensors["latent"] = latent
        if log.check(LVL_DEBUG):
            from .utils.tensorstat import stat_line
            log.debug(stat_line(latent, "x"))
        if c["unet_split"]:
            self._free_params("unet")

        # decode
        if not c["no_decode"]:
            if u8 is not None:  # fused into the loop program above
                self.tensors["image"] = \
                    u8.astype(np.float32).transpose(0, 3, 1, 2) / 255.0
                self._cb(STAGE_IMAGE_DECODE, 1, 1)
            elif c["tae"]:
                u8 = np.asarray(_tae_decode_u8_jit(
                    self._get_params("tae"), latent.transpose(0, 2, 3, 1),
                    dtype=self._dtype, tae_p=self._tae_p))
                self.tensors["image"] = \
                    u8.astype(np.float32).transpose(0, 3, 1, 2) / 255.0
                self._cb(STAGE_IMAGE_DECODE, 1, 1)
            elif c["vae_tile"] <= 0:
                # fused decode + u8 quantize on device (4x less transfer)
                u8 = np.asarray(_vae_decode_u8_jit(
                    self._get_params("vae"), latent.transpose(0, 2, 3, 1),
                    vae_p=mt.vae_p, dtype=self._dtype))
                self.tensors["image"] = \
                    u8.astype(np.float32).transpose(0, 3, 1, 2) / 255.0
                self._cb(STAGE_IMAGE_DECODE, 1, 1)
            else:
                self.tensors["image"] = self.image_decode(latent)

        self._infotext_update(w * f, h * f, plan)
        self._prompt_clear()
        log.info(f"Generation done {{{time.time() - t_start:.3f}s}}")
        return self.tensors["image"] if not c["no_decode"] else latent

    def _inpaint_fullres_generate(self) -> np.ndarray:
        """Crop-around-mask inpainting (beyond-reference; A1111 "inpaint
        at full resolution"): the padded mask bounding box — expanded
        toward the processing aspect — is cropped out, Lanczos-resized to
        the session dims, inpainted there, resized back, and blended into
        the original image under the mask."""
        c = self.c
        img = np.asarray(self.tensors["image"], np.float32)
        mask = np.asarray(self.tensors["mask"], np.float32)
        saved_blur = c["mask_blur"]
        if saved_blur > 0:   # blur once here (paste seam + inner use)
            mask = image_mod.mask_gaussian_blur(mask, saved_blur)
        # library masks are 1 = KEEP (reference alpha convention); the
        # crop/paste helpers take white = repaint
        repaint = 1.0 - mask
        w = c["width"] or img.shape[3]
        h = c["height"] or img.shape[2]
        pad = int(c["inpaint_full_res_padding"])
        box = image_mod.inpaint_crop_region(
            repaint, w, h, pad, mult=self._mt.vae_p.f_down)
        if box is None:        # empty mask: plain img2img
            self._in_fullres = True   # don't re-enter this dispatch
            try:
                return self._generate()
            finally:
                self._in_fullres = False
        x0, y0, x1, y1 = box
        crop_img = image_mod._resize_float_nchw(
            img[:, :, y0:y1, x0:x1], h, w)
        crop_mask = np.clip(image_mod._resize_float_nchw(
            mask[:, :, y0:y1, x0:x1], h, w), 0.0, 1.0)
        self._in_fullres = True
        try:
            c["mask_blur"] = 0.0   # already applied above
            self.tensors["image"] = crop_img
            self.tensors["mask"] = crop_mask
            out = self._generate()
            final = image_mod.inpaint_paste(img, out, repaint, box)
            self.tensors["image"] = final
            self.infotext += (f", Inpaint area: only masked, "
                              f"Masked padding: {pad}")
            log.info(f"Inpaint full res: box {x1 - x0}x{y1 - y0}+"
                     f"{x0}+{y0} processed at {w}x{h}")
            return final
        finally:
            self._in_fullres = False
            c["mask_blur"] = saved_blur

    def _hires_generate(self) -> np.ndarray:
        """Two-stage highres-fix (beyond-reference; A1111 semantics): a
        base pass at ``image_dim``, a bilinear latent upscale by the
        ``hires_fix`` factor (A1111's "Latent" upscaler), then an img2img
        refine pass at strength ``hires_denoise`` (``hires_steps`` steps,
        0 = same as ``steps``).  The refine pass operates on the upscaled
        latent only: init image/mask consumed by the base pass do not
        carry into it (their information is already in the latent).

        With ``hires_upscaler`` set to anything but ""/"latent", the
        upscale runs in IMAGE space instead: stage 1 decodes, the
        configured ESRGAN model (option ``upscaler``) upscales the image
        (Lanczos-trimmed to the final dims), and the refine pass starts
        from its VAE re-encode — A1111's non-latent hr_upscaler mode."""
        c = self.c
        factor = float(c["hires_fix"])
        base_w, base_h = c["width"], c["height"]
        f = self._mt.vae_p.f_down
        # final dims: multiples of f*8 px (VAE /f + 3 UNet downsamples)
        mult = f * 8
        fin_w = max(mult, int(round(base_w * factor / mult)) * mult)
        fin_h = max(mult, int(round(base_h * factor / mult)) * mult)
        denoise = float(c["hires_denoise"])
        steps2 = int(c["hires_steps"]) or c["steps"]
        # stage 1 clears the one-shot options; save what stage 2 re-uses
        saved_prompt = (c["prompt_raw"], c["nprompt_raw"])
        saved_steps, saved_nodec = c["steps"], c["no_decode"]
        saved_loras = list(self.loras)
        up_name = str(c["hires_upscaler"]).strip()
        use_img_up = up_name.lower() not in ("", "latent")
        self._in_hires = True
        try:
            if use_img_up:
                c["no_decode"] = False
                img1 = np.asarray(self._generate(), np.float32)
                up = self.upscale(img1)
                if up.shape[2] != fin_h or up.shape[3] != fin_w:
                    up = _lanczos_resize(up, fin_h, fin_w)
                lat2 = self.image_encode(up)
            else:
                c["no_decode"] = True
                lat = np.asarray(self._generate(), np.float32)  # base pass
                import jax
                import jax.numpy as jnp
                lat2 = np.asarray(jax.image.resize(
                    jnp.asarray(lat),
                    (lat.shape[0], lat.shape[1], fin_h // f, fin_w // f),
                    "bilinear"), np.float32)
            # stage 2: img2img refine at the final resolution
            c["prompt_raw"], c["nprompt_raw"] = saved_prompt
            if saved_loras != self.loras:   # re-pin <lora:...> tag loras
                self.loras = saved_loras
                self._ready.discard("loras")
            c["steps"] = steps2
            c["no_decode"] = saved_nodec
            c["width"], c["height"] = fin_w, fin_h
            c["f_t_ini"], c["f_t_end"] = denoise, 0.0
            c["tuflags"] = TUF_LATENT
            self.tensors["latent"] = lat2
            out = self._generate()
            self.infotext += (f", Hires upscale: {factor:g}, "
                              f"Hires steps: {steps2}, "
                              f"Denoising strength: {denoise:g}")
            if use_img_up:
                self.infotext += f", Hires upscaler: {up_name}"
            return out
        finally:
            self._in_hires = False
            c["width"], c["height"] = base_w, base_h
            c["steps"] = saved_steps
            c["no_decode"] = saved_nodec

    def _refiner_get(self) -> "MLImgSynth":
        """The stage-2 sub-session holding the refiner model (lazily
        created, cached until the ``refiner`` path changes).  Static aux
        options are inherited at creation; per-generate options are
        forwarded on every call."""
        c = self.c
        rs = self._refiner
        if rs is None or self._refiner_path != c["refiner"]:
            rs = MLImgSynth()
            rs._dtype = self._dtype
            for o in ("tae", "lora_dir", "embed_dir", "aux_dir",
                      "weight_type"):
                rs.c[o] = c[o]
            rs.option_set("model", c["refiner"])
            self._refiner = rs
            self._refiner_path = c["refiner"]
        for o in ("width", "height", "cfg_scale", "cfg_rescale", "method",
                  "scheduler", "s_noise", "s_ancestral", "clip_skip",
                  "n_batch", "no_prompt_parse", "vae_tile", "no_decode",
                  "freeu"):
            rs.c[o] = c[o]
        # one continuous logical noise stream across the two stages
        rs.rng.seed = self.rng.seed
        rs.rng.offset = self.rng.offset
        return rs

    def _refiner_generate(self) -> np.ndarray:
        """Base->refiner ensemble-of-experts pipeline (beyond-reference;
        SDXL-paper / diffusers denoising_end+denoising_start semantics):
        the base model denoises from ``f_t_ini`` down to the switch point
        ``1 - refiner_switch`` and STOPS THERE (keep_tail: the latent still
        carries sigma(cut) noise); the refiner model — any checkpoint
        sharing the latent space, typically the SDXL refiner — continues
        from that exact sigma without re-adding noise and finishes +
        decodes.  ``refiner_switch`` is the fraction of the denoising done
        by the base (A1111's "switch at").  Masks are consumed by the base
        stage; their effect rides the handoff latent."""
        c = self.c
        switch = min(max(float(c["refiner_switch"]), 0.0), 1.0)
        f_cut = 1.0 - switch
        saved_prompt = (c["prompt_raw"], c["nprompt_raw"])
        saved_end, saved_nodec = c["f_t_end"], c["no_decode"]
        f_ini = c["f_t_ini"] if c["tuflags"] & (TUF_LATENT | TUF_IMAGE) \
            else 1.0
        rs = self._refiner_get()
        base_steps = int(c["steps"] * (f_ini - f_cut) + 0.5)
        self._in_refiner = True
        try:
            if saved_end >= f_cut or f_ini <= f_cut or base_steps < 2:
                # nothing (meaningful) below the cut for the base model:
                # degenerate to a single stage.  Ends-before-cut runs the
                # base alone; starts-below-cut (img2img at low strength)
                # runs the refiner alone, with the normal noise add.
                if saved_end >= f_cut:
                    return self._generate()
                rs.c["steps"] = c["steps"]
                rs.c["f_t_ini"], rs.c["f_t_end"] = c["f_t_ini"], saved_end
                rs.c["tuflags"] = c["tuflags"]
                for t in ("image", "latent", "mask", "lmask"):
                    rs.tensors[t] = self.tensors.get(t)
                rs.option_set("prompt", saved_prompt[0])
                rs.option_set("nprompt", saved_prompt[1])
                out = rs.generate()
                self._prompt_clear()     # the base session's one-shots
                base_info = rs.infotext  # refiner-alone: its params
            else:
                # stage 1: base model, [f_ini .. f_cut], latent handoff
                # (stage 1's completion clears the base session's one-shot
                # options, exactly like a plain generate)
                c["no_decode"] = True
                c["f_t_end"] = f_cut
                self._keep_tail = True
                lat = np.asarray(self._generate(), np.float32)
                # stage 2: refiner continues at sigma(f_cut), no noise add
                rs.c["steps"] = c["steps"]
                rs.c["f_t_ini"], rs.c["f_t_end"] = f_cut, saved_end
                rs.c["tuflags"] = TUF_LATENT
                rs.tensors["latent"] = lat
                rs.option_set("prompt", saved_prompt[0])
                rs.option_set("nprompt", saved_prompt[1])
                rs.rng.offset = self.rng.offset
                rs._noise_add = False
                base_info = self.infotext   # stage-1 params (base model)
                try:
                    out = rs.generate()
                finally:
                    rs._noise_add = True
            self.tensors["latent"] = rs.tensors["latent"]
            self.tensors["image"] = rs.tensors["image"]
            self.infotext = base_info + (
                f", Refiner: {os.path.basename(c['refiner'])}, "
                f"Refiner switch: {switch:g}")
            return out
        finally:
            self._in_refiner = False
            self._keep_tail = False
            c["no_decode"] = saved_nodec

    def _prompt_clear(self):
        """One-shot options cleared after generate
        (reference: mlis_prompt_clear, src/mlimgsynth.c:697-709)."""
        self.c["prompt_raw"] = ""
        self.c["nprompt_raw"] = ""
        self.c["f_t_ini"] = 1.0
        self.c["f_t_end"] = 0.0
        self.c["tuflags"] = 0
        kept = [l for l in self.loras if not l[2]]
        if len(kept) != len(self.loras):
            self.loras = kept
            self._ready.discard("loras")

    # ------------------------------------------------------------------
    # Batched serving path (beyond the reference, which is strictly
    # one-image-per-call, src/mlimgsynth.c:1640-1641)
    # ------------------------------------------------------------------

    def _parse_prompt_text(self, text: str,
                           allow_loras: bool = False
                           ) -> prompt_mod.PromptText:
        """Parse a prompt without mutating session state."""
        if self.c["no_prompt_parse"]:
            return prompt_mod.prompt_set_raw(text)
        t0, edited = prompt_mod.expand_editing(text, 0, 1000)
        try:
            parsed = prompt_mod.prompt_set_parse(t0 if edited else text)
        except prompt_mod.PromptParseError as e:
            raise MlisError(MlisError.E_PROMPT_PARSE, str(e))
        parsed.editing = bool(edited)
        if parsed.loras and not allow_loras:
            raise MlisError(
                MlisError.E_OPT_VALUE,
                "<lora:...> tags are not supported in batched negative "
                "prompts")
        return parsed

    def _batch_loras_apply(self, pts: List[prompt_mod.PromptText]):
        """Apply the ``<lora:...>`` tag set shared by a merged device
        batch.  Weights are one set per batch, so every request must
        carry the SAME tag list (the server's merge key guarantees this
        for serving traffic).  The patched store persists across batches
        with identical tags — repeat traffic pays the patch cost once."""
        tags = list(pts[0].loras) if pts else []
        for p in pts[1:]:
            if list(p.loras) != tags:
                raise MlisError(
                    MlisError.E_OPT_VALUE,
                    "all requests in a device batch must share the same "
                    "<lora:...> tags")
        wanted = [(self._lora_find(name), float(mult))
                  for name, mult in tags]
        cur = [(p_, m_) for p_, m_, fp in self.loras if fp]
        if cur != wanted:
            self.loras = ([l for l in self.loras if not l[2]]
                          + [(p_, m_, True) for p_, m_ in wanted])
            self._ready.discard("loras")
            self.setup()

    def generate_batch(self, requests: List[dict], step_callback=None,
                       init_latents: Optional[np.ndarray] = None,
                       init_lmask: Optional[np.ndarray] = None,
                       preview_callback=None, preview_chunk: int = 0,
                       _latent_only: bool = False
                       ) -> Tuple[np.ndarray, List[str]]:
        """Run several txt2img (or img2img) requests as ONE device batch.

        Each request dict brings its own ``prompt``/``nprompt``/``seed``;
        every other sampling option comes from the session state (callers
        must only merge requests whose shared options match).  Returns
        (images NCHW [N,3,H,W] in [0,1], per-request infotext list).

        ``init_latents`` (NCHW [N,4,h,w], one row per request) enables
        img2img: combine with the session ``f_t_ini`` option.
        ``init_lmask`` (NCHW [N,1,h,w] latent masks) additionally enables
        inpainting (requires ``init_latents``).

        ``step_callback(i_step, n_step) -> bool`` aborts the whole batch
        when truthy (used for serving cancellation).

        ``preview_callback(i_step, n_step, imgs_u8_nhwc)`` streams a
        preview frame after every chunk of ``preview_chunk`` steps (default:
        the cancellable path's chunk size): TAE-decoded when the session has
        a TAE, else the ~free linear latent->RGB approximation.  The
        preview decode is fused into the chunk dispatch, so previews cost
        zero extra dispatches over the plain cancellable path."""
        with self._lock:
            self.setup()
            c, mt = self.c, self._mt
            if (c["hires_fix"] > 1.0 and not self._in_hires
                    and not _latent_only):
                return self._generate_batch_hires(
                    requests, step_callback, init_latents, init_lmask,
                    preview_callback, preview_chunk)
            if (c["refiner"] and not self._in_refiner
                    and not self._in_hires):
                return self._generate_batch_refiner(
                    requests, step_callback, init_latents, init_lmask,
                    preview_callback, preview_chunk)
            f = mt.vae_p.f_down
            w, h = c["width"] // f, c["height"] // f
            n = len(requests)
            if init_latents is not None:
                if init_latents.shape[0] != n:
                    raise MlisError(
                        MlisError.E_OPT_VALUE,
                        f"init_latents batch {init_latents.shape[0]} != "
                        f"{n} requests")
                h, w = init_latents.shape[2], init_latents.shape[3]
            guidance_embed = getattr(mt.unet_p, "guidance_embed", False)
            use_cfg = c["cfg_scale"] > 1 and not guidance_embed
            # ALL requests' prompts ride one batched encoder call (ditto
            # nprompts): 2 text-encode dispatches per merged batch total
            pts = [self._parse_prompt_text(str(r.get("prompt", "")),
                                           allow_loras=True)
                   for r in requests]
            self._batch_loras_apply(pts)
            # seedless entries get seed+i (matching generate()'s per-row
            # streams) so they don't share one noise stream
            seeds = [int(r["seed"]) if r.get("seed") is not None
                     else self.rng.seed + i
                     for i, r in enumerate(requests)]
            cond = ncond = label = nlabel = None
            npts = ([self._parse_prompt_text(str(r.get("nprompt", "")))
                     for r in requests] if use_cfg else [])
            # prompt editing in batched requests: per-request per-step
            # segments index one shared conditioning bank (see
            # _batch_edit_cond_bank)
            edit_steps = None
            if (not c["no_prompt_parse"]
                    and (any(p.editing for p in pts)
                         or any(q.editing for q in npts))):
                if getattr(mt.unet_p, "flow", False):
                    raise MlisError(
                        MlisError.E_OPT_VALUE,
                        "prompt editing is not supported for flow models")
                cond, label, edit_steps = self._batch_edit_cond_bank(
                    requests, use_cfg, init_latents is not None)
            fuse_encode = (self._mesh is None and not c["unet_split"]
                           and edit_steps is None)
            encode_spec = None
            if fuse_encode:
                # text encode rides the batch's FIRST chunk dispatch; rows
                # follow the loop's [cond xN ; uncond xN] layout
                rows_pts = pts + npts
                tokens, wmat = self._cond_token_rows(rows_pts)
                if use_cfg and mt.unet_p.uncond_empty_zero:
                    for i, r in enumerate(requests):
                        if not r.get("nprompt"):
                            wmat[n + i] = 0.0
                encode_spec = (self._get_params("clip"), tokens, wmat,
                               mt.clip_p, c["clip_skip"],
                               mt.unet_p.clip_norm)
                if getattr(mt.unet_p, "flux", False):
                    # Flux: T5-only context + fused pooled head (+ the
                    # embedded-guidance column for dev)
                    _, fidx = self._cond_token_rows(rows_pts,
                                                    want_fidx=True)
                    t5_rows = self._t5_encode_rows(rows_pts,
                                                   mt.unet_p.d_ctx_in)
                    grow = (np.full((len(rows_pts), 1), c["cfg_scale"],
                                    np.float32) if guidance_embed else None)
                    encode_spec = encode_spec + (fidx, t5_rows, grow)
                elif getattr(mt.unet_p, "flow", False):
                    # SD3 flow: dual towers + pooled heads fused (see
                    # _generate); T5 rows precomputed per request row
                    _, fidx = self._cond_token_rows(rows_pts,
                                                    want_fidx=True)
                    tokens2, fidx2 = self._cond_token_rows(
                        rows_pts, submodel="clip2", want_fidx=True)
                    t5_rows = self._t5_encode_rows(rows_pts,
                                                   mt.unet_p.d_ctx_in)
                    encode_spec = encode_spec + (
                        self._get_params("clip2"), tokens2, fidx, fidx2,
                        t5_rows, mt.clip2_p)
                elif mt.unet_p.cond_label and mt.clip2_p is not None:
                    tokens2, fidx = self._cond_token_rows(
                        rows_pts, submodel="clip2", want_fidx=True)
                    h_, w_ = c["height"], c["width"]
                    from .models.blocks import timestep_embedding
                    import jax.numpy as jnp
                    sizes = np.array([h_, w_, 0, 0, h_, w_], np.float32)
                    size_emb = np.asarray(
                        timestep_embedding(jnp.asarray(sizes), 256),
                        np.float32).reshape(-1)
                    encode_spec = encode_spec + (
                        self._get_params("clip2"), tokens2, fidx, size_emb,
                        mt.clip2_p)
                elif mt.unet_p.cond_label:
                    # SDXL-refiner single tower (see _generate)
                    _, fidx = self._cond_token_rows(rows_pts,
                                                    want_fidx=True)
                    h_, w_ = c["height"], c["width"]
                    from .models.blocks import timestep_embedding
                    from .models.unet import (AESTHETIC_SCORE,
                                              AESTHETIC_NSCORE)
                    import jax.numpy as jnp
                    scores = ([AESTHETIC_SCORE] * n
                              + [AESTHETIC_NSCORE] * len(npts))
                    sizes = np.asarray([[h_, w_, 0, 0, s] for s in scores],
                                       np.float32)
                    serows = np.asarray(
                        timestep_embedding(
                            jnp.asarray(sizes.reshape(-1)), 256),
                        np.float32).reshape(len(rows_pts), -1)
                    encode_spec = encode_spec + (fidx, serows)
            elif edit_steps is not None:
                pass  # conditioning bank built above
            elif use_cfg:
                # prompts AND nprompts ride the same batched encoder
                # call(s): one dispatch per tower for the whole merged batch
                both, lboth = self._text_cond_encode_rows(
                    pts + npts, uncond_rows=len(npts))
                cond, ncond = both[:n], both[n:]
                label = lboth[:n] if lboth is not None else None
                nlabel = lboth[n:] if lboth is not None else None
                if mt.unet_p.uncond_empty_zero:
                    for i, r in enumerate(requests):
                        if not r.get("nprompt"):
                            ncond[i] = 0.0
            else:
                cond, label = self._text_cond_encode_rows(pts)
            if guidance_embed and label is not None \
                    and label.shape[-1] == mt.unet_p.d_pooled:
                gcol = np.full((label.shape[0], 1), c["cfg_scale"],
                               np.float32)
                label = np.concatenate([np.asarray(label, np.float32),
                                        gcol], axis=-1)

            self._guidance_checks(mt.unet_p)
            flow_shift = (getattr(mt.unet_p, "flow_shift", 0.0)
                          if getattr(mt.unet_p, "flow", False) else 0.0)
            if getattr(mt.unet_p, "dynamic_shift", False):
                from .models.flux import dynamic_flow_shift
                flow_shift = dynamic_flow_shift(mt.unet_p, h, w)
            scfg = SamplerConfig(
                method=c["method"], sched=c["scheduler"], n_step=c["steps"],
                cfg_scale=(1.0 if guidance_embed else c["cfg_scale"]),
                s_ancestral=c["s_ancestral"],
                s_noise=c["s_noise"],
                f_t_ini=c["f_t_ini"] if init_latents is not None else 1.0,
                f_t_end=c["f_t_end"],
                keep_tail=self._keep_tail, noise_add=self._noise_add,
                flow_shift=flow_shift, cfg_rescale=c["cfg_rescale"],
                **_slg_kw(c))
            nfe_per_dxdt = 2 if use_cfg else 1
            latent = (np.asarray(init_latents, np.float32)
                      if init_latents is not None
                      else np.zeros((n, mt.vae_p.ch_z, h, w),
                                    np.float32))
            subseeds = None
            if c["subseed_strength"] > 0:
                subseeds = [int(r["subseed"])
                            if r.get("subseed") is not None
                            else seeds[j] + (1 << 31)
                            for j, r in enumerate(requests)]
            plan = make_plan(scfg, latent.shape, RngPhilox(seeds[0], 0),
                             nfe_per_dxdt, seeds=seeds, subseeds=subseeds,
                             subseed_strength=c["subseed_strength"])
            log.info(f"Generating batch of {n} requests "
                     f"(seeds {seeds}, steps {plan.n_step})")
            params = self._get_params("unet")
            # session-level ControlNet applies to the whole merged batch
            # (like every other shared sampling option)
            control_spec = None
            if c["control_net"]:
                hint = self.tensors.get("control_image")
                if hint is None:
                    raise MlisError(
                        MlisError.E_IMAGE,
                        "control-net is set but no control-image was given")
                if hint.shape[2:] != (h * f, w * f):
                    raise MlisError(
                        MlisError.E_IMAGE,
                        f"control image size {hint.shape[3]}x"
                        f"{hint.shape[2]} does not match output "
                        f"{w * f}x{h * f}")
                params = {**params, **self._get_params("cnet")}
                control_spec = (hint[:1], c["control_strength"])
            if init_lmask is not None and init_latents is None:
                raise MlisError(MlisError.E_OPT_VALUE,
                                "inpainting masks need init images")
            extra_spec = None
            if mt.unet_p.n_ch_in > mt.vae_p.ch_z \
                    and not getattr(mt.unet_p, "flow", False):
                if init_latents is not None:
                    raise MlisError(
                        MlisError.E_OPT_VALUE,
                        "inpaint-variant models do not support merged "
                        "img2img batches (use generate())")
                # txt2img with an inpaint variant: repaint everything
                extra_spec = np.concatenate(
                    [np.ones((1, 1, h, w), np.float32),
                     np.zeros((1, mt.vae_p.ch_z, h, w), np.float32)], 1)
            # decode rides the final chunk's dispatch even on this
            # cancellable (step-callback) path.  ``_latent_only`` (the
            # ensemble base stage) skips it and returns latents.
            decode_spec = None if _latent_only else (
                ("tae", self._get_params("tae"), self._tae_p)
                if c["tae"] else
                ("vae", self._get_params("vae"), mt.vae_p))
            preview_spec = None
            if preview_callback is not None:
                pv = (("tae", self._get_params("tae"), self._tae_p) if c["tae"]
                      else ("latent", {}, None))
                n_total = plan.n_step
                preview_spec = pv + (
                    lambda i, imgs: preview_callback(i, n_total, imgs),)
            self._deepcache_check(mt.unet_p, control_spec, extra_spec,
                                  edit_steps)
            out = run_sampler(params, latent, plan, cond, ncond,
                              label, nlabel, init_lmask, scfg,
                              mt.unet_p, dtype=self._dtype,
                              step_callback=step_callback,
                              mesh=self._mesh, decode=decode_spec,
                              encode=encode_spec, preview=preview_spec,
                              chunk_size=preview_chunk or None,
                              control=control_spec,
                              extra_channels=extra_spec,
                              cond_steps=edit_steps,
                              deepcache=c["deepcache"],
                              tiling=c["tiling"],
                              freeu=self._freeu_resolve())
            u8 = None
            if decode_spec is None:   # _latent_only
                if encode_spec is not None:
                    latent, _cond_pair = out
                else:
                    latent = out
            elif encode_spec is not None:
                latent, u8, _cond_pair = out
            else:
                latent, u8 = out
            if u8 is None and not _latent_only:
                # aborted by the callback before the last chunk
                raise Aborted("generation cancelled")
            if not np.isfinite(latent).all():
                raise MlisError(MlisError.E_NAN, "NaN found in UNet output")
            imgs = latent if _latent_only else \
                u8.astype(np.float32).transpose(0, 3, 1, 2) / 255.0

            solver_nfe = get_solver(c["method"]).n_fe
            self._nfe = ((plan.n_step * solver_nfe - (solver_nfe - 1))
                         * nfe_per_dxdt)
            infotexts = []
            save = (c["prompt_raw"], c["nprompt_raw"], self.rng.seed,
                    self.infotext, self.tensors.get("lmask"))
            try:
                self.tensors["lmask"] = init_lmask  # Mode: inpaint label
                for i, r in enumerate(requests):
                    c["prompt_raw"] = str(r.get("prompt", ""))
                    c["nprompt_raw"] = str(r.get("nprompt", ""))
                    self.rng.seed = seeds[i]
                    if subseeds is not None:
                        self._subseed_eff = subseeds[i]
                    self._infotext_update(w * f, h * f, plan)
                    infotexts.append(self.infotext)
            finally:
                (c["prompt_raw"], c["nprompt_raw"], self.rng.seed,
                 self.infotext, self.tensors["lmask"]) = save
            return imgs, infotexts

    def _generate_batch_hires(self, requests, step_callback, init_latents,
                              init_lmask, preview_callback, preview_chunk
                              ) -> Tuple[np.ndarray, List[str]]:
        """Two-stage highres-fix on the batched serving path (A1111
        ``enable_hr`` semantics, mirroring :meth:`_hires_generate`): a
        latent-only base-stage batch at ``image_dim``, a bilinear latent
        upscale by ``hires_fix``, then an img2img refine-stage batch at
        strength ``hires_denoise``.  Request seeds are reused per stage
        (each stage draws its own Philox streams), matching A1111's
        same-seed hires pass.  Stage-1 infotexts are kept with the Hires
        fields appended."""
        c = self.c
        factor = float(c["hires_fix"])
        base_w, base_h = c["width"], c["height"]
        f = self._mt.vae_p.f_down
        mult = f * 8
        fin_w = max(mult, int(round(base_w * factor / mult)) * mult)
        fin_h = max(mult, int(round(base_h * factor / mult)) * mult)
        denoise = float(c["hires_denoise"])
        steps2 = int(c["hires_steps"]) or c["steps"]
        saved_steps = c["steps"]
        saved_ini, saved_end = c["f_t_ini"], c["f_t_end"]
        aborted = []

        def cb1(i_step, n_step):
            r = bool(step_callback(i_step, n_step)) \
                if step_callback else False
            if r:
                aborted.append(1)
            return r

        up_name = str(c["hires_upscaler"]).strip()
        use_img_up = up_name.lower() not in ("", "latent")
        self._in_hires = True
        try:
            if use_img_up:
                imgs1, infos = self.generate_batch(
                    requests, cb1, init_latents, init_lmask,
                    preview_callback, preview_chunk)
                if aborted:
                    raise Aborted("generation cancelled")
                up = self.upscale(np.asarray(imgs1, np.float32))
                if up.shape[2] != fin_h or up.shape[3] != fin_w:
                    up = _lanczos_resize(up, fin_h, fin_w)
                lat2 = self.image_encode(up)
            else:
                lats, infos = self.generate_batch(
                    requests, cb1, init_latents, init_lmask,
                    preview_callback, preview_chunk, _latent_only=True)
                if aborted:
                    raise Aborted("generation cancelled")
                import jax
                import jax.numpy as jnp
                lat = np.asarray(lats, np.float32)
                lat2 = np.asarray(jax.image.resize(
                    jnp.asarray(lat),
                    (lat.shape[0], lat.shape[1], fin_h // f, fin_w // f),
                    "bilinear"), np.float32)
            c["width"], c["height"] = fin_w, fin_h
            c["steps"] = steps2
            c["f_t_ini"], c["f_t_end"] = denoise, 0.0
            imgs, _ = self.generate_batch(
                requests, step_callback, lat2, None,
                preview_callback, preview_chunk)
            extra = (f", Hires upscaler: {up_name}" if use_img_up else "")
            infos = [t + f", Hires upscale: {factor:g}, "
                     f"Hires steps: {steps2}, "
                     f"Denoising strength: {denoise:g}" + extra
                     for t in infos]
            return imgs, infos
        finally:
            self._in_hires = False
            c["width"], c["height"] = base_w, base_h
            c["steps"] = saved_steps
            c["f_t_ini"], c["f_t_end"] = saved_ini, saved_end

    def _generate_batch_refiner(self, requests, step_callback, init_latents,
                                init_lmask, preview_callback, preview_chunk
                                ) -> Tuple[np.ndarray, List[str]]:
        """Ensemble-of-experts on the batched serving path: a latent-only
        base-stage batch (keep_tail stops at sigma(cut)), then a refiner-
        stage batch continuing from the same sigma (no noise re-add).
        Request seeds are reused per stage (each stage draws its own
        Philox streams from them; only ancestral/churn methods draw after
        init, and the sigma ranges of the stages are disjoint).  Stage-1
        infotexts (the base model's parameters) are kept, with the
        Refiner fields appended."""
        c = self.c
        switch = min(max(float(c["refiner_switch"]), 0.0), 1.0)
        f_cut = 1.0 - switch
        saved_end = c["f_t_end"]
        f_ini = c["f_t_ini"] if init_latents is not None else 1.0
        rs = self._refiner_get()
        base_steps = int(c["steps"] * (f_ini - f_cut) + 0.5)
        self._in_refiner = True
        try:
            if saved_end >= f_cut:      # base alone covers [ini, end]
                return self.generate_batch(
                    requests, step_callback, init_latents, init_lmask,
                    preview_callback, preview_chunk)
            if f_ini <= f_cut or base_steps < 2:
                # img2img below the cut: the whole denoise belongs to the
                # refiner, with the normal noise add
                rs.c["steps"] = c["steps"]
                rs.c["f_t_ini"], rs.c["f_t_end"] = c["f_t_ini"], saved_end
                imgs, infos = rs.generate_batch(
                    requests, step_callback, init_latents, init_lmask,
                    preview_callback, preview_chunk)
            else:
                aborted = []

                def cb1(i_step, n_step):
                    r = bool(step_callback(i_step, n_step)) \
                        if step_callback else False
                    if r:
                        aborted.append(1)
                    return r

                c["f_t_end"] = f_cut
                self._keep_tail = True
                try:
                    lats, infos = self.generate_batch(
                        requests, cb1, init_latents, init_lmask,
                        preview_callback, preview_chunk, _latent_only=True)
                finally:
                    self._keep_tail = False
                    c["f_t_end"] = saved_end
                if aborted:
                    raise Aborted("generation cancelled")
                rs.c["steps"] = c["steps"]
                rs.c["f_t_ini"], rs.c["f_t_end"] = f_cut, saved_end
                rs._noise_add = False
                try:
                    imgs, _ = rs.generate_batch(
                        requests, step_callback, np.asarray(lats), None,
                        preview_callback, preview_chunk)
                finally:
                    rs._noise_add = True
            infos = [t + f", Refiner: {os.path.basename(c['refiner'])}, "
                     f"Refiner switch: {switch:g}" for t in infos]
            return imgs, infos
        finally:
            self._in_refiner = False

    def _infotext_update(self, w: int, h: int, plan):
        """A1111-compatible 'parameters' text
        (reference: mlis_infotext_update, src/mlimgsynth.c:1592-1632)."""
        c = self.c
        out = [c["prompt_raw"] + "\n"]
        if c["nprompt_raw"]:
            out.append(f"Negative prompt: {c['nprompt_raw']}\n")
        out.append(f"Seed: {self.rng.seed}")
        if c["subseed_strength"] > 0:
            out.append(f", Variation seed: {self._subseed_eff}, "
                       f"Variation seed strength: "
                       f"{c['subseed_strength']:g}")
        m = c["method"]
        out.append(f", Sampler: {m}")
        if c["s_ancestral"] == 1:
            out.append(" ancestral")
        # the lcm method implies the lcm grid unless a schedule was chosen
        # explicitly (make_plan) — report what actually ran
        sched = ("lcm" if m == "lcm" and c["scheduler"] == "uniform"
                 else c["scheduler"])
        out.append(f", Schedule type: {sched}")
        if c["s_ancestral"] > 0:
            out.append(f", Ancestral: {c['s_ancestral']:g}")
        if c["s_noise"] > 0:
            out.append(f", SNoise: {c['s_noise']:g}")
        if c["cfg_scale"] > 1:
            out.append(f", CFG scale: {c['cfg_scale']:g}")
        if c["cfg_rescale"] > 0 and c["cfg_scale"] > 1:
            out.append(f", CFG Rescale: {c['cfg_rescale']:g}")
        if c["slg_scale"] > 0:
            out.append(f", SLG scale: {c['slg_scale']:g}"
                       f", SLG layers: {c['slg_layers']}"
                       f", SLG start: {c['slg_start']:g}"
                       f", SLG end: {c['slg_end']:g}")
        if c["pag_scale"] > 0:
            out.append(f", PAG scale: {c['pag_scale']:g}")
            if c["pag_start"] > 0 or c["pag_end"] < 1:
                out.append(f", PAG start: {c['pag_start']:g}"
                           f", PAG end: {c['pag_end']:g}")
        if c["deepcache"] > 1:
            out.append(f", DeepCache: {c['deepcache']}")
        if c["freeu"] and self._freeu_parse(c["freeu"]) is not None:
            fu = self._freeu_resolve()
            out.append(", FreeU: " + ",".join(f"{v:g}" for v in fu))
        if c["f_t_ini"] < 1:
            mode = "inpaint" if self.tensors.get("lmask") is not None \
                else "img2img"
            out.append(f", Mode: {mode}, f_t_ini: {c['f_t_ini']:g}")
        out.append(f", Steps: {plan.n_step}")
        out.append(f", NFE: {self._nfe}")
        out.append(f", Size: {w}x{h}")
        out.append(f", Clip skip: {c['clip_skip']}")
        model = os.path.splitext(os.path.basename(c["model"]))[0]
        out.append(f", Model: {model}")
        if c["tae"]:
            out.append(", VAE: tae")
        if c["control_net"]:
            cn = os.path.splitext(os.path.basename(c["control_net"]))[0]
            out.append(f", ControlNet: {cn}, "
                       f"ControlNet strength: {c['control_strength']:g}")
        out.append(f", Version: MLImgSynth-TPU v{_pkg_version}")
        self.infotext = "".join(out)

    # ------------------------------------------------------------------

    def backend_info(self) -> dict:
        """Device enumeration (reference: mlis_backend_info_get)."""
        import jax
        devs = []
        for d in jax.devices():
            mem = {}
            try:
                stats = d.memory_stats() or {}
                mem = {"mem_free": stats.get("bytes_limit", 0)
                       - stats.get("bytes_in_use", 0),
                       "mem_total": stats.get("bytes_limit", 0)}
            except Exception:
                pass
            devs.append({"name": str(d), "desc": d.device_kind, **mem})
        return {"name": jax.default_backend(), "n_dev": len(devs),
                "devs": devs}



def _slg_kw(c):
    """SamplerConfig kwargs for skip-layer / perturbed-attention guidance
    from the option dict."""
    kw = {}
    if c["slg_scale"]:
        kw.update(
            slg_scale=float(c["slg_scale"]),
            slg_layers=tuple(int(v) for v in str(c["slg_layers"]).split(",")
                             if v.strip()),
            slg_start=float(c["slg_start"]), slg_end=float(c["slg_end"]))
    if c["pag_scale"]:
        kw.update(pag_scale=float(c["pag_scale"]),
                  pag_start=float(c["pag_start"]),
                  pag_end=float(c["pag_end"]))
    return kw


_OPTIONS = [
    "backend", "model", "tae", "lora_dir", "lora", "lora_clear", "prompt",
    "nprompt", "image_dim", "batch_size", "clip_skip", "cfg_scale", "method",
    "scheduler", "steps", "f_t_ini", "f_t_end", "s_noise", "s_ancestral",
    "image", "image_mask", "no_decode", "tensor_use_flags", "seed",
    "vae_tile", "unet_split", "tp", "dp", "sp", "pp", "threads", "dump_flags",
    "aux_dir", "callback",
    "error_handler", "log_level", "model_type", "weight_type",
    "no_prompt_parse",
    # additive extensions (beyond the reference option enum): ControlNet,
    # textual-inversion embeddings, two-stage highres-fix
    "control_net", "control_image", "control_strength", "embed_dir",
    "hires_fix", "hires_denoise", "hires_steps",
    # ESRGAN/RRDBNet upscaler model + image-space highres-fix mode
    "upscaler", "hires_upscaler",
    # seed variations (A1111 subseed slerp)
    "subseed", "subseed_strength",
    # CFG rescale phi (Lin et al. 2023; counters v-pred over-exposure)
    "cfg_rescale",
    # skip-layer guidance (SD3.5-medium recommended sampling mode)
    "slg_scale", "slg_layers", "slg_start", "slg_end",
    # perturbed-attention guidance (identity mid-block self-attention)
    "pag_scale", "pag_start", "pag_end",
    # crop-around-mask inpainting (A1111 "inpaint at full resolution")
    "inpaint_full_res", "inpaint_full_res_padding", "mask_blur",
    # UNet encoder caching (DeepCache-style; opt-in approximation)
    "deepcache",
    # FreeU backbone/skip reweighting ("FreeU: Free Lunch in Diffusion
    # U-Net"; "1" = per-family defaults or explicit "B1,B2,S1,S2")
    "freeu",
    # seamless tiling (circular conv padding, A1111 "tiling")
    "tiling",
    # base->refiner ensemble-of-experts pipeline
    "refiner", "refiner_switch",
    # SD3 T5-XXL context tower (optional third text encoder)
    "t5", "t5_tokenizer", "t5_tokens",
    # aux weight files for transformer-only distributions (flux)
    "clip", "vae",
]


# ---------------------------------------------------------------------------
# Jitted stage wrappers (module-level so jax.jit caches across sessions)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _make_clip_jit():
    import jax

    @functools.partial(jax.jit, static_argnames=(
        "clip_p", "submodel", "clip_skip", "norm", "want_feat", "dtype",
        "feat_proj"))
    def f(params, tokens, feat_idx, *, clip_p, submodel, clip_skip, norm,
          want_feat, dtype, feat_proj=True):
        from .models import blocks as B
        from .models import clip as clip_mod
        ctx = B.Ctx(params, dtype=dtype)
        return clip_mod.clip_text_apply_nd(
            ctx, tokens, clip_p, clip_skip=clip_skip, norm=norm,
            feat_tok_idx=(feat_idx if want_feat else None), pre=submodel,
            feat_proj=feat_proj)
    return f


def _clip_jit(params, tokens, feat_idx, **kw):
    return _make_clip_jit()(params, tokens, feat_idx, **kw)


@functools.lru_cache(maxsize=None)
def _make_t5_jit():
    import jax

    @functools.partial(jax.jit, static_argnames=("t5_p", "dtype"))
    def f(params, tokens, *, t5_p, dtype):
        from .models import blocks as B
        from .models import t5 as t5_mod
        ctx = B.Ctx(params, dtype=dtype)
        return t5_mod.t5_encode_apply(ctx, tokens, t5_p)
    return f


def _t5_jit(params, tokens, **kw):
    return _make_t5_jit()(params, tokens, **kw)


@functools.lru_cache(maxsize=None)
def _make_vae_jits():
    import jax

    @functools.partial(jax.jit, static_argnames=("vae_p", "dtype",
                                                  "tiling"))
    def enc(params, img, *, vae_p, dtype, tiling=False):
        from .models import blocks as B
        from .models import vae as vae_mod
        ctx = B.Ctx(params, dtype=dtype, tiling=tiling)
        return vae_mod.vae_encode_apply(ctx, img, vae_p)

    @functools.partial(jax.jit, static_argnames=("vae_p", "dtype",
                                                  "tiling"))
    def dec(params, lat, *, vae_p, dtype, tiling=False):
        from .models import blocks as B
        from .models import vae as vae_mod
        ctx = B.Ctx(params, dtype=dtype, tiling=tiling)
        return vae_mod.vae_decode_apply(ctx, lat, vae_p)

    @functools.partial(jax.jit, static_argnames=("vae_p", "dtype"))
    def dec_u8(params, lat, *, vae_p, dtype):
        # decode + [-1,1] -> uint8 on device (4x less host transfer);
        # shared with the fused-loop path so the quantize semantics can
        # never diverge (C-cast truncation, ref: mlis_tensor_to_image)
        from .sampling.sampler import _decode_u8
        return _decode_u8(params, lat, "vae", vae_p, dtype)

    return enc, dec, dec_u8


def _vae_encode_jit(params, img, **kw):
    return _make_vae_jits()[0](params, img, **kw)


def _vae_decode_jit(params, lat, **kw):
    return _make_vae_jits()[1](params, lat, **kw)


def _vae_decode_u8_jit(params, lat, **kw):
    return _make_vae_jits()[2](params, lat, **kw)


@functools.lru_cache(maxsize=None)
def _make_tae_jits():
    import jax

    @functools.partial(jax.jit, static_argnames=("dtype", "tae_p"))
    def enc(params, img, *, dtype, tae_p=None):
        from .models import blocks as B
        from .models import tae as tae_mod
        ctx = B.Ctx(params, dtype=dtype)
        return tae_mod.tae_encode_apply(ctx, img, tae_p or tae_mod.TAE_SD1)

    @functools.partial(jax.jit, static_argnames=("dtype", "tae_p"))
    def dec(params, lat, *, dtype, tae_p=None):
        from .models import blocks as B
        from .models import tae as tae_mod
        ctx = B.Ctx(params, dtype=dtype)
        return tae_mod.tae_decode_apply(ctx, lat, tae_p or tae_mod.TAE_SD1)

    @functools.partial(jax.jit, static_argnames=("dtype", "tae_p"))
    def dec_u8(params, lat, *, dtype, tae_p=None):
        from .sampling.sampler import _decode_u8
        return _decode_u8(params, lat, "tae", tae_p, dtype)

    return enc, dec, dec_u8


def _tae_encode_jit(params, img, **kw):
    return _make_tae_jits()[0](params, img, **kw)


def _tae_decode_jit(params, lat, **kw):
    return _make_tae_jits()[1](params, lat, **kw)


def _tae_decode_u8_jit(params, lat, **kw):
    return _make_tae_jits()[2](params, lat, **kw)


# ---------------------------------------------------------------------------
# VAE tiling (reference: sdvae_encode/decode tiling, src/vae.c:222-411)
#
# The reference runs a host loop with one device round-trip per tile; here
# the whole tiled pass is ONE dispatch: a jitted lax.scan over tiles whose
# body dynamic-slices the tile, runs the codec, and blends the tile's inner
# region into a device-resident canvas with an iota mask.  Memory stays at
# one-tile activations (the point of tiling) while dispatch overhead stops
# scaling with the tile count.
# ---------------------------------------------------------------------------

def _lanczos_resize(img_nchw: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Host-side Lanczos resize of float [n,c,h,w] images, clipped to
    [0,1] (shared per-channel PIL 'F' loop lives in utils/image)."""
    out = image_mod._resize_float_nchw(img_nchw, th, tw)
    return np.clip(out, 0.0, 1.0, out)


def _tile_geometry(full0, full1, n0, n1, k):
    """Row-major tile origins + inner write boxes (tile-relative), matching
    the reference's stitch rule: skip the k-margin on non-edge sides
    (src/vae.c:365-385)."""
    step0, step1 = n0 - k * 2, n1 - k * 2
    n_t0 = (full0 + step0 - 1) // step0
    n_t1 = (full1 + step1 - 1) // step1
    origins, boxes = [], []
    for t1 in range(n_t1):
        i1 = min(t1 * step1, full1 - n1)
        for t0 in range(n_t0):
            i0 = min(t0 * step0, full0 - n0)
            d0 = k if i0 else 0
            d1 = k if i1 else 0
            ty1 = n1 - k if i1 + n1 < full1 else n1
            tx1 = n0 - k if i0 + n0 < full0 else n0
            origins.append((i1, i0))
            boxes.append((d1, ty1, d0, tx1))
    return np.asarray(origins, np.int32), np.asarray(boxes, np.int32)


@functools.lru_cache(maxsize=None)
def _make_tiled_vae_jits():
    import jax
    import jax.numpy as jnp
    from jax import lax

    @functools.partial(jax.jit,
                       static_argnames=("vae_p", "dtype", "tn1", "tn0"))
    def dec_tiled(params, lat, origins, boxes, *, vae_p, dtype, tn1, tn0):
        """lat NHWC [n,lh,lw,cz]; origins [T,2] (y,x latent units); boxes
        [T,4] (ty0,ty1,tx0,tx1 latent units, tile-relative)."""
        from .models import blocks as B
        from .models import vae as vae_mod
        ctx = B.Ctx(params, dtype=dtype)
        f = vae_p.f_down
        n, lh, lw, cz = lat.shape
        img = jnp.zeros((n, lh * f, lw * f, 3), jnp.float32)
        ys = lax.broadcasted_iota(jnp.int32, (tn1 * f, tn0 * f), 0)
        xs = lax.broadcasted_iota(jnp.int32, (tn1 * f, tn0 * f), 1)

        def body(img, inp):
            org, box = inp
            sub = lax.dynamic_slice(lat, (0, org[0], org[1], 0),
                                    (n, tn1, tn0, cz))
            dec = vae_mod.vae_decode_apply(ctx, sub, vae_p).astype(
                jnp.float32)
            m = ((ys >= box[0] * f) & (ys < box[1] * f) &
                 (xs >= box[2] * f) & (xs < box[3] * f))
            m = m[None, :, :, None].astype(jnp.float32)
            cur = lax.dynamic_slice(img, (0, org[0] * f, org[1] * f, 0),
                                    (n, tn1 * f, tn0 * f, 3))
            img = lax.dynamic_update_slice(
                img, cur * (1.0 - m) + dec * m, (0, org[0] * f, org[1] * f, 0))
            return img, None

        img, _ = lax.scan(body, img, (origins, boxes))
        return img

    @functools.partial(jax.jit,
                       static_argnames=("vae_p", "dtype", "tn1", "tn0"))
    def enc_tiled(params, img, origins, boxes, *, vae_p, dtype, tn1, tn0):
        """img NHWC [n,ih,iw,3]; origins/boxes in image pixels (multiples of
        f); returns the moments canvas [n, ih/f, iw/f, 2*ch_z]."""
        from .models import blocks as B
        from .models import vae as vae_mod
        ctx = B.Ctx(params, dtype=dtype)
        f = vae_p.f_down
        n, ih, iw, _ = img.shape
        ln1, ln0 = tn1 // f, tn0 // f
        mom = jnp.zeros((n, ih // f, iw // f, vae_p.ch_z * 2), jnp.float32)
        ys = lax.broadcasted_iota(jnp.int32, (ln1, ln0), 0)
        xs = lax.broadcasted_iota(jnp.int32, (ln1, ln0), 1)

        def body(mom, inp):
            org, box = inp
            sub = lax.dynamic_slice(img, (0, org[0], org[1], 0),
                                    (n, tn1, tn0, 3))
            enc = vae_mod.vae_encode_apply(ctx, sub, vae_p).astype(
                jnp.float32)
            m = ((ys >= box[0] // f) & (ys < box[1] // f) &
                 (xs >= box[2] // f) & (xs < box[3] // f))
            m = m[None, :, :, None].astype(jnp.float32)
            cur = lax.dynamic_slice(mom, (0, org[0] // f, org[1] // f, 0),
                                    (n, ln1, ln0, enc.shape[-1]))
            mom = lax.dynamic_update_slice(
                mom, cur * (1.0 - m) + enc * m,
                (0, org[0] // f, org[1] // f, 0))
            return mom, None

        mom, _ = lax.scan(body, mom, (origins, boxes))
        return mom

    return dec_tiled, enc_tiled


# Filled by _tiled_decode under MLIS_MEM_ANALYSIS=1 (bench memory
# reporting for the two-program low-memory path; same contract as
# sampling.sampler.LAST_MEMORY_ANALYSIS).
LAST_DECODE_MEMORY_ANALYSIS = None

def _decode_mem_analysis(jitted, *args, **kw):
    global LAST_DECODE_MEMORY_ANALYSIS
    try:
        ma = jitted.lower(*args, **kw).compile().memory_analysis()
        LAST_DECODE_MEMORY_ANALYSIS = {
            "argument_bytes": ma.argument_size_in_bytes,
            "output_bytes": ma.output_size_in_bytes,
            "temp_bytes": ma.temp_size_in_bytes,
            "peak_estimate_bytes": (ma.argument_size_in_bytes +
                                    ma.output_size_in_bytes +
                                    ma.temp_size_in_bytes),
        }
    except Exception:  # analysis is informational, never fatal
        LAST_DECODE_MEMORY_ANALYSIS = None


def _tiled_decode(params, lat: np.ndarray, P, tile_px: int, dtype
                  ) -> np.ndarray:
    f = P.f_down
    k = 8  # latent-px overlap margin
    n, cz, lh, lw = lat.shape
    tile_px = (tile_px + 63) // 64 * 64
    n0 = min(tile_px // f + k * 2, lw)
    n1 = min(tile_px // f + k * 2, lh)
    if n0 == lw and n1 == lh:
        if os.environ.get("MLIS_MEM_ANALYSIS"):
            _decode_mem_analysis(_make_vae_jits()[1],
                                 params, lat.transpose(0, 2, 3, 1),
                                 vae_p=P, dtype=dtype)
        out = np.asarray(_vae_decode_jit(
            params, lat.transpose(0, 2, 3, 1), vae_p=P, dtype=dtype),
            np.float32)
        return out.transpose(0, 3, 1, 2)
    origins, boxes = _tile_geometry(lw, lh, n0, n1, k)
    log.info(f"VAE tiled decode: {len(origins)} tiles of "
             f"{n0 * f}x{n1 * f}px in one dispatch")
    if os.environ.get("MLIS_MEM_ANALYSIS"):
        _decode_mem_analysis(_make_tiled_vae_jits()[0],
                             params, lat.transpose(0, 2, 3, 1), origins,
                             boxes, vae_p=P, dtype=dtype, tn1=n1, tn0=n0)
    out = np.asarray(_make_tiled_vae_jits()[0](
        params, lat.transpose(0, 2, 3, 1), origins, boxes,
        vae_p=P, dtype=dtype, tn1=n1, tn0=n0), np.float32)
    return out.transpose(0, 3, 1, 2)


def _tiled_encode(params, img: np.ndarray, P, tile_px: int, dtype
                  ) -> np.ndarray:
    f = P.f_down
    k = f * 8  # image-px overlap margin
    n, _, ih, iw = img.shape
    tile_px = (tile_px + 63) // 64 * 64
    n0 = min(tile_px + k * 2, iw)
    n1 = min(tile_px + k * 2, ih)
    if n0 == iw and n1 == ih:
        out = np.asarray(_vae_encode_jit(
            params, img.transpose(0, 2, 3, 1), vae_p=P, dtype=dtype),
            np.float32)
        return out.transpose(0, 3, 1, 2)
    origins, boxes = _tile_geometry(iw, ih, n0, n1, k)
    log.info(f"VAE tiled encode: {len(origins)} tiles of "
             f"{n0}x{n1}px in one dispatch")
    mom = np.asarray(_make_tiled_vae_jits()[1](
        params, img.transpose(0, 2, 3, 1), origins, boxes,
        vae_p=P, dtype=dtype, tn1=n1, tn0=n0), np.float32)
    return mom.transpose(0, 3, 1, 2)
