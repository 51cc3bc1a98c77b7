"""Python wrapper with the reference binding's exact surface.

Drop-in replacement for the reference's ctypes wrapper
(reference: python/mlimgsynth.py): same class name, constants, and method
signatures (``option_set`` joining args with ','; ``image_get`` returning an
object with ``.d/.w/.h/.c``; ``clip_text_encode(features=, no_norm=,
model_idx=)``; tensor ``.similarity``), backed by the JAX core instead
of ``libmlimgsynth.so``.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from mlimgsynth_tpu import api as _api  # noqa: E402

# Constants (include/mlimgsynth.h)
MLIS_VERSION = 0x000500
MLIS_VERSION_STR = "0.5.0"

MLIS_E_UNKNOWN = -1
MLIS_E_VERSION = -2
MLIS_E_UNK_OPT = -3
MLIS_E_OPT_VALUE = -4
MLIS_E_PROMPT_PARSE = -5
MLIS_E_FILE_NOT_FOUND = -6
MLIS_E_NAN = -7
MLIS_E_IMAGE = -8

MLIS_STAGE_IDLE = 0
MLIS_STAGE_COND_ENCODE = 1
MLIS_STAGE_IMAGE_ENCODE = 2
MLIS_STAGE_IMAGE_DECODE = 3
MLIS_STAGE_DENOISE = 4

MLIS_METHOD_NONE = 0
MLIS_METHOD_EULER = 1
MLIS_METHOD_HEUN = 2
MLIS_METHOD_TAYLOR3 = 3
MLIS_METHOD_DPMPP2M = 4
MLIS_METHOD_DPMPP2S = 5
MLIS_METHOD_DPMPP2MSDE = 6  # beyond-reference addition (DPM++ 2M SDE)
MLIS_METHOD_LCM = 7         # beyond-reference addition (latent consistency)
MLIS_METHOD_UNIPC = 8       # beyond-reference addition (UniPC order-2 bh2)
MLIS_METHOD__LAST = 8

MLIS_SCHED_NONE = 0
MLIS_SCHED_UNIFORM = 1
MLIS_SCHED_KARRAS = 2
MLIS_SCHED_LCM = 3          # beyond-reference additions, see the header
MLIS_SCHED_EXPONENTIAL = 4
MLIS_SCHED_SGM_UNIFORM = 5
MLIS_SCHED_BETA = 6
MLIS_SCHED__LAST = 6

MLIS_LOGLVL_NONE = 0
MLIS_LOGLVL_ERROR = 10
MLIS_LOGLVL_WARNING = 20
MLIS_LOGLVL_INFO = 30
MLIS_LOGLVL_VERBOSE = 40
MLIS_LOGLVL_DEBUG = 50
MLIS_LOGLVL_MAX = 255

MLIS_TENSOR_IMAGE = 1
MLIS_TENSOR_MASK = 2
MLIS_TENSOR_LATENT = 3
MLIS_TENSOR_LMASK = 4
MLIS_TENSOR_COND = 5
MLIS_TENSOR_LABEL = 6
MLIS_TENSOR_NCOND = 7
MLIS_TENSOR_NLABEL = 8
MLIS_TENSOR_TMP = 0x100

MLIS_MODEL_CLIP = 1
MLIS_MODEL_CLIP2 = 2

MLIS_CTEF_NO_NORM = 1

# Option ids in reference enum order (include/mlimgsynth.h MLIS_Option)
_OPTION_NAMES = [
    "none", "backend", "model", "tae", "lora-dir", "lora", "lora-clear",
    "prompt", "nprompt", "image-dim", "batch-size", "clip-skip", "cfg-scale",
    "method", "scheduler", "steps", "f-t-ini", "f-t-end", "s-noise",
    "s-ancestral", "image", "image-mask", "no-decode", "tensor-use-flags",
    "seed", "vae-tile", "unet-split", "threads", "dump-flags", "aux-dir",
    "callback", "error-handler", "log-level", "model-type", "weight-type",
    "no-prompt-parse",
    # beyond-reference additions (ControlNet, embeddings, highres-fix,
    # refiner, SD3/Flux aux weights, guidance/caching/variation) — keep
    # in lockstep with include/mlimgsynth.h MLIS_Option
    "control-net", "control-image", "control-strength", "embed-dir",
    "hires-fix", "hires-denoise", "hires-steps",
    "refiner", "refiner-switch", "t5", "t5-tokenizer", "t5-tokens",
    "clip", "vae",
    "cfg-rescale", "slg-scale", "slg-layers", "slg-start", "slg-end",
    "pag-scale", "pag-start", "pag-end", "freeu", "deepcache",
    "subseed", "subseed-strength",
]
for _i, _n in enumerate(_OPTION_NAMES):
    if _i:
        globals()["MLIS_OPT_" + _n.upper().replace("-", "_")] = _i


class MLIS_Tensor:
    """Tensor view: ``.d`` flat data, ``.n`` shape in ggml order (w,h,c,n)."""

    def __init__(self, arr: np.ndarray):
        self._arr = np.asarray(arr, np.float32)
        s = self._arr.shape
        while len(s) < 4:
            s = (1,) + s
        self.n = tuple(reversed(s))
        self.d = self._arr.reshape(-1)

    @property
    def data(self):
        return self.d

    def similarity(self, other: "MLIS_Tensor") -> float:
        a = self.d
        b = other.d
        if a.size != b.size:
            return float("nan")
        denom = np.sqrt(float(a @ a) * float(b @ b))
        return float(a @ b) / denom if denom else float("nan")


class MLIS_Image:
    """Image view: ``.d`` uint8 HWC data plus ``.w/.h/.c``."""

    def __init__(self, arr_u8: np.ndarray):
        self.d = arr_u8
        self.h, self.w, self.c = arr_u8.shape
        self.sz = arr_u8.size

    @property
    def data(self):
        return self.d.reshape(-1)


class MLImgSynth:
    def __init__(self):
        self._ctx = _api.MLImgSynth()

    def option_set(self, option, *args):
        if isinstance(option, str):
            self._ctx.option_set_str(option,
                                     ",".join(str(x) for x in args))
        elif isinstance(option, int):
            self._ctx.option_set(_OPTION_NAMES[option], *args)
        else:
            raise RuntimeError("'option' must be str or int")

    def setup(self):
        "Set up the backend and model. Optional."
        self._ctx.setup()

    def generate(self):
        "Generate images."
        self._ctx.generate()

    def image_get(self, idx=0):
        "Get generated images data."
        from mlimgsynth_tpu.utils import image as image_mod
        img = self._ctx.tensors["image"]
        if img is None:
            raise RuntimeError("image not ready")
        return MLIS_Image(image_mod.tensor_to_image_arr(img, idx))

    def infotext_get(self, idx=0):
        "Get text describing the generation parameters."
        return self._ctx.infotext

    def errstr_get(self):
        "Return a string describing the last error."
        return self._ctx.errstr

    def tensor_get(self, tid):
        names = {MLIS_TENSOR_IMAGE: "image", MLIS_TENSOR_MASK: "mask",
                 MLIS_TENSOR_LATENT: "latent", MLIS_TENSOR_LMASK: "lmask",
                 MLIS_TENSOR_COND: "cond", MLIS_TENSOR_LABEL: "label",
                 MLIS_TENSOR_NCOND: "ncond", MLIS_TENSOR_NLABEL: "nlabel"}
        key = names.get(tid, f"tmp{tid - MLIS_TENSOR_TMP}" if
                        tid >= MLIS_TENSOR_TMP else None)
        arr = self._ctx.tensors.get(key)
        return MLIS_Tensor(arr) if arr is not None else None

    def clip_text_encode(self, text, features=False, no_norm=True,
                         model_idx=MLIS_MODEL_CLIP):
        submodel = "clip" if model_idx == MLIS_MODEL_CLIP else "clip2"
        embed, feat = self._ctx.clip_text_encode(
            text, submodel=submodel, want_feat=features, norm=not no_norm)
        if features:
            return MLIS_Tensor(embed), MLIS_Tensor(feat)
        return MLIS_Tensor(embed)


# Simple test
if __name__ == "__main__":
    mlis = MLImgSynth()
    mlis.option_set(MLIS_OPT_IMAGE_DIM, 512, 512)
    mlis.option_set("cfg-scale", 7.0)
    print("MLImgSynth binding OK")
