/* MLImgSynth-TPU - stable C ABI.
 *
 * ABI-compatible with the reference libmlimgsynth interface
 * (reference: include/mlimgsynth.h) so existing C/ctypes clients work
 * unchanged; the implementation runs the JAX core through an
 * embedded Python interpreter (src shim: native/mlis_shim.c).
 *
 * Sessions serialize their pipeline entry points internally; one
 * MLIS_Ctx may be driven from multiple threads (unlike the reference).
 */
#ifndef MLIMGSYNTH_TPU_H
#define MLIMGSYNTH_TPU_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

#define MLIS_VERSION_MAJOR 0
#define MLIS_VERSION_MINOR 5
#define MLIS_VERSION_PATCH 0
#define MLIS_VERSION \
	(MLIS_VERSION_MAJOR*0x10000 + MLIS_VERSION_MINOR*0x100 + MLIS_VERSION_PATCH)

typedef enum MLIS_ErrCode {
	MLIS_E_UNKNOWN        = -1,
	MLIS_E_VERSION        = -2,
	MLIS_E_UNK_OPT        = -3,
	MLIS_E_OPT_VALUE      = -4,
	MLIS_E_PROMPT_PARSE   = -5,
	MLIS_E_FILE_NOT_FOUND = -6,
	MLIS_E_NAN            = -7,
	MLIS_E_IMAGE          = -8,
} MLIS_ErrCode;

typedef enum MLIS_Stage {
	MLIS_STAGE_IDLE = 0,
	MLIS_STAGE_COND_ENCODE,
	MLIS_STAGE_IMAGE_ENCODE,
	MLIS_STAGE_IMAGE_DECODE,
	MLIS_STAGE_DENOISE,
} MLIS_Stage;

typedef enum MLIS_Method {
	MLIS_METHOD_NONE = 0,
	MLIS_METHOD_EULER,
	MLIS_METHOD_HEUN,
	MLIS_METHOD_TAYLOR3,
	MLIS_METHOD_DPMPP2M,
	MLIS_METHOD_DPMPP2S,
	/* beyond-reference addition: DPM++(2M) SDE, midpoint variant
	 * (reference future-plans item; noise from the Philox stream) */
	MLIS_METHOD_DPMPP2MSDE,
	/* beyond-reference addition: latent-consistency sampling (LCM /
	 * LCM-LoRA distilled models; diffusers LCMScheduler semantics) */
	MLIS_METHOD_LCM,
	/* beyond-reference addition: UniPC order-2 (bh2, data prediction,
	 * predictor-corrector; arXiv:2302.04867) */
	MLIS_METHOD_UNIPC,
	MLIS_METHOD__LAST = MLIS_METHOD_UNIPC,
} MLIS_Method;

typedef enum MLIS_Scheduler {
	MLIS_SCHED_NONE = 0,
	MLIS_SCHED_UNIFORM,
	MLIS_SCHED_KARRAS,
	/* beyond-reference: the LCM distillation timestep grid (implied by
	 * MLIS_METHOD_LCM unless a schedule is set explicitly) */
	MLIS_SCHED_LCM,
	/* beyond-reference (round 4, additive): the remaining string-side
	 * schedules gain ids so the by-id/by-string option-surface parity
	 * property holds for every schedule (reference design:
	 * src/mlimgsynth_options_set.c.h). */
	MLIS_SCHED_EXPONENTIAL,     /* k-diffusion log-uniform sigma grid */
	MLIS_SCHED_SGM_UNIFORM,     /* sgm / A1111 "SGM Uniform" */
	MLIS_SCHED_BETA,            /* A1111 "Beta" (needs scipy) */
	MLIS_SCHED__LAST = MLIS_SCHED_BETA,
} MLIS_Scheduler;

typedef enum MLIS_ModelType {
	MLIS_MODEL_TYPE_NONE = 0,
	MLIS_MODEL_TYPE_SD1,
	MLIS_MODEL_TYPE_SD2,
	MLIS_MODEL_TYPE_SDXL,
	/* beyond-reference: the SDXL refiner model (single OpenCLIP-bigG
	 * text tower + aesthetic-score conditioning). */
	MLIS_MODEL_TYPE_SDXL_REFINER,
	/* beyond-reference: the SD3 family (MMDiT rectified-flow
	 * transformer, dual CLIP towers + optional T5, 16-channel VAE). */
	MLIS_MODEL_TYPE_SD3,
	MLIS_MODEL_TYPE_SD35_LARGE,
	MLIS_MODEL_TYPE_SD35_MEDIUM,  /* MMDiT-X (dual attention) */
	/* beyond-reference: Flux.1 (double/single-stream rectified-flow DiT
	 * with rotary embeddings; dev embeds the guidance instead of CFG). */
	MLIS_MODEL_TYPE_FLUX_SCHNELL,
	MLIS_MODEL_TYPE_FLUX_DEV,
	MLIS_MODEL_TYPE__LAST = MLIS_MODEL_TYPE_FLUX_DEV,
} MLIS_ModelType;

typedef enum MLIS_SubModel {
	MLIS_SUBMODEL_NONE = 0,
	MLIS_SUBMODEL_CLIP,
	MLIS_SUBMODEL_CLIP2,
	MLIS_SUBMODEL_UNET,
	MLIS_SUBMODEL_VAE,
	MLIS_SUBMODEL_TAE,
} MLIS_SubModel;

typedef enum MLIS_LogLvl {
	MLIS_LOGLVL_NONE     = 0,
	MLIS_LOGLVL_ERROR    = 10,
	MLIS_LOGLVL_WARNING  = 20,
	MLIS_LOGLVL_INFO     = 30,
	MLIS_LOGLVL_VERBOSE  = 40,
	MLIS_LOGLVL_DEBUG    = 50,
	MLIS_LOGLVL_MAX      = 255,
	MLIS_LOGLVL__INCREASE = 0x100 | 10,
	MLIS_LOGLVL__DECREASE = 0x200 | 10,
} MLIS_LogLvl;

typedef enum MLIS_Option {
	MLIS_OPT_NONE = 0,
	MLIS_OPT_BACKEND,           /* (const char* name, const char* params) */
	MLIS_OPT_MODEL,             /* (const char* path) */
	MLIS_OPT_TAE,               /* (const char* path) */
	MLIS_OPT_LORA_DIR,          /* (const char* path) */
	MLIS_OPT_LORA,              /* (const char* path, double mult) */
	MLIS_OPT_LORA_CLEAR,        /* () */
	MLIS_OPT_PROMPT,            /* (const char* text) */
	MLIS_OPT_NPROMPT,           /* (const char* text) */
	MLIS_OPT_IMAGE_DIM,         /* (int w, int h) */
	MLIS_OPT_BATCH_SIZE,        /* (int n) */
	MLIS_OPT_CLIP_SKIP,         /* (int n) */
	MLIS_OPT_CFG_SCALE,         /* (double f) */
	MLIS_OPT_METHOD,            /* (MLIS_Method) */
	MLIS_OPT_SCHEDULER,         /* (MLIS_Scheduler) */
	MLIS_OPT_STEPS,             /* (int n) */
	MLIS_OPT_F_T_INI,           /* (double f) */
	MLIS_OPT_F_T_END,           /* (double f) */
	MLIS_OPT_S_NOISE,           /* (double f) */
	MLIS_OPT_S_ANCESTRAL,       /* (double f) */
	MLIS_OPT_IMAGE,             /* (const MLIS_Image*) */
	MLIS_OPT_IMAGE_MASK,        /* (const MLIS_Image*) */
	MLIS_OPT_NO_DECODE,         /* (int bool) */
	MLIS_OPT_TENSOR_USE_FLAGS,  /* (int MLIS_TUF_*) */
	MLIS_OPT_SEED,              /* (uint64_t) */
	MLIS_OPT_VAE_TILE,          /* (int px) */
	MLIS_OPT_UNET_SPLIT,        /* (int bool) */
	MLIS_OPT_THREADS,           /* (int n) */
	MLIS_OPT_DUMP_FLAGS,        /* (int flags) */
	MLIS_OPT_AUX_DIR,           /* (const char* path) */
	MLIS_OPT_CALLBACK,          /* (MLIS_Callback, void* user) */
	MLIS_OPT_ERROR_HANDLER,     /* (MLIS_ErrorHandler, void* user) */
	MLIS_OPT_LOG_LEVEL,         /* (int lvl) */
	MLIS_OPT_MODEL_TYPE,        /* (MLIS_ModelType) */
	MLIS_OPT_WEIGHT_TYPE,       /* (int type id / name via _str) */
	MLIS_OPT_NO_PROMPT_PARSE,   /* (int bool) */
	/* beyond-reference additions: ControlNet (reference future-plans
	 * item).  Appended after the reference enum so existing ids match. */
	MLIS_OPT_CONTROL_NET,       /* (const char* path) */
	MLIS_OPT_CONTROL_IMAGE,     /* (const MLIS_Image*) */
	MLIS_OPT_CONTROL_STRENGTH,  /* (double f) */
	/* textual-inversion embeddings: directory searched for <emb:NAME>
	 * prompt tags (NAME.safetensors or NAME.pt). */
	MLIS_OPT_EMBED_DIR,         /* (const char* path) */
	/* two-stage highres-fix: base pass at image_dim, latent bilinear
	 * upscale by the factor, img2img refine pass. */
	MLIS_OPT_HIRES_FIX,         /* (double factor; <=1 disables) */
	MLIS_OPT_HIRES_DENOISE,     /* (double f_t for the refine pass) */
	MLIS_OPT_HIRES_STEPS,       /* (int steps; 0 = same as steps) */
	/* base->refiner ensemble-of-experts pipeline: the base model denoises
	 * down to 1-refiner_switch of the noise schedule and hands the still-
	 * noisy latent to the refiner model, which continues at that exact
	 * sigma (no re-noising) and decodes. */
	MLIS_OPT_REFINER,           /* (const char* model path; "" disables) */
	MLIS_OPT_REFINER_SWITCH,    /* (double base fraction, default 0.8) */
	/* Additive extension: SD3's optional T5 context tower (weights file,
	 * HF-tokenizers tokenizer.json, context token count). */
	MLIS_OPT_T5,                /* (const char* weights path) */
	MLIS_OPT_T5_TOKENIZER,      /* (const char* tokenizer.json path) */
	MLIS_OPT_T5_TOKENS,         /* (int n, default 77) */
	/* Additive extension: aux weight files for transformer-only
	 * distributions (flux): a CLIP text tower / a standalone VAE. */
	MLIS_OPT_CLIP,              /* (const char* weights path) */
	MLIS_OPT_VAE,               /* (const char* weights path) */
	/* beyond-reference (round 4, additive): ids for every option that
	 * previously existed string-side only, restoring the reference's
	 * "settable by id AND by string with identical validation" design
	 * property (src/mlimgsynth_options_set.c.h) for the round-3
	 * guidance/caching/variation features. */
	MLIS_OPT_CFG_RESCALE,       /* (double f in [0,1]) */
	MLIS_OPT_SLG_SCALE,         /* (double f >= 0; DiT models only) */
	MLIS_OPT_SLG_LAYERS,        /* (const char* "7,8,9") */
	MLIS_OPT_SLG_START,         /* (double step fraction in [0,1]) */
	MLIS_OPT_SLG_END,           /* (double step fraction in [0,1]) */
	MLIS_OPT_PAG_SCALE,         /* (double f >= 0; UNet models only) */
	MLIS_OPT_PAG_START,         /* (double step fraction in [0,1]) */
	MLIS_OPT_PAG_END,           /* (double step fraction in [0,1]) */
	MLIS_OPT_FREEU,             /* (const char* "y"/"n"/"B1,B2,S1,S2") */
	MLIS_OPT_DEEPCACHE,         /* (int interval N; <=1 disables) */
	MLIS_OPT_SUBSEED,           /* (uint64_t variation seed) */
	MLIS_OPT_SUBSEED_STRENGTH,  /* (double f in [0,1]; 0 disables) */
	MLIS_OPT__LAST = MLIS_OPT_SUBSEED_STRENGTH,
} MLIS_Option;

enum MLIS_TensorUseFlag {
	MLIS_TUF_IMAGE        = 1,
	MLIS_TUF_MASK         = 2,
	MLIS_TUF_LATENT       = 4,
	MLIS_TUF_LMASK        = 8,
	MLIS_TUF_CONDITIONING = 16,
};

typedef enum MLIS_TensorId {
	MLIS_TENSOR_NONE = 0,
	MLIS_TENSOR_IMAGE,
	MLIS_TENSOR_MASK,
	MLIS_TENSOR_LATENT,
	MLIS_TENSOR_LMASK,
	MLIS_TENSOR_COND,
	MLIS_TENSOR_LABEL,
	MLIS_TENSOR_NCOND,
	MLIS_TENSOR_NLABEL,
	MLIS_TENSOR_TMP = 0x100,
} MLIS_TensorId;

enum MLIS_ClipTextEncodeFlag {
	MLIS_CTEF_NO_NORM = 1,
};

/* Host tensor: float32, ggml dim order (n[0] innermost). */
typedef struct MLIS_Tensor {
	int n[4];
	float *d;
	int flags;
} MLIS_Tensor;

/* 8-bit interleaved image. */
typedef struct MLIS_Image {
	uint8_t *d;
	uint32_t w, h, c;
	size_t sz;
	int flags;
} MLIS_Image;

typedef struct MLIS_Progress {
	MLIS_Stage stage;
	int step, step_end;
	int nfe;
	double step_time;
} MLIS_Progress;

typedef struct MLIS_ErrorInfo {
	int code;
	const char *desc;
} MLIS_ErrorInfo;

typedef struct MLIS_BackendDevInfo {
	const char *name, *desc;
	size_t mem_free, mem_total;
} MLIS_BackendDevInfo;

typedef struct MLIS_BackendInfo {
	const char *name;
	unsigned n_dev;
	const MLIS_BackendDevInfo *devs;
} MLIS_BackendInfo;

typedef struct MLIS_Ctx MLIS_Ctx;

typedef int (*MLIS_Callback)(void* user, MLIS_Ctx* ctx,
	const MLIS_Progress* prg);
typedef void (*MLIS_ErrorHandler)(void* user, MLIS_Ctx* ctx,
	const MLIS_ErrorInfo* ei);

/* Context lifecycle */
MLIS_Ctx* mlis_ctx_create_i(int version);
#define mlis_ctx_create()  mlis_ctx_create_i(MLIS_VERSION)
void mlis_ctx_destroy(MLIS_Ctx** pctx);
const char* mlis_errstr_get(const MLIS_Ctx* ctx);

/* Options */
int mlis_option_set(MLIS_Ctx* ctx, MLIS_Option id, ...);
int mlis_option_set_str(MLIS_Ctx* ctx, const char* name, const char* value);
int mlis_option_get(MLIS_Ctx* ctx, MLIS_Option id, ...);

/* Pipeline */
int mlis_setup(MLIS_Ctx* ctx);
int mlis_generate(MLIS_Ctx* ctx);
int mlis_image_encode(MLIS_Ctx* ctx, const MLIS_Tensor* image,
	MLIS_Tensor* latent, int flags);
int mlis_image_decode(MLIS_Ctx* ctx, const MLIS_Tensor* latent,
	MLIS_Tensor* image, int flags);
int mlis_mask_encode(MLIS_Ctx* ctx, const MLIS_Tensor* mask,
	MLIS_Tensor* lmask, int flags);
int mlis_text_tokenize(MLIS_Ctx* ctx, const char* text, int32_t** ptokens,
	MLIS_SubModel submodel);
int mlis_clip_text_encode(MLIS_Ctx* ctx, const char* text,
	MLIS_Tensor* embed, MLIS_Tensor* feat, MLIS_SubModel submodel, int flags);

/* Results */
MLIS_Image* mlis_image_get(MLIS_Ctx* ctx, int idx);
const char* mlis_infotext_get(MLIS_Ctx* ctx, int idx);
MLIS_Tensor* mlis_tensor_get(MLIS_Ctx* ctx, MLIS_TensorId id);
const MLIS_BackendInfo* mlis_backend_info_get(MLIS_Ctx* ctx, unsigned idx,
	int flags);

/* Tensor utilities */
void mlis_tensor_free(MLIS_Tensor* t);
size_t mlis_tensor_count(const MLIS_Tensor* t);
void mlis_tensor_resize(MLIS_Tensor* t, int n0, int n1, int n2, int n3);
void mlis_tensor_resize_like(MLIS_Tensor* t, const MLIS_Tensor* src);
void mlis_tensor_copy(MLIS_Tensor* t, const MLIS_Tensor* src);
float mlis_tensor_similarity(const MLIS_Tensor* a, const MLIS_Tensor* b);

/* Enum string conversions.
 * _str returns the canonical lower-case name ("???" if out of range);
 * _desc returns a pretty description; _fromz parses a name
 * case/hyphen-insensitively ("DPM++2M" == "dpmpp2m") returning the id or
 * -1 (reference: include/mlimgsynth.h:490-509). */
const char* mlis_stage_str(MLIS_Stage x);
const char* mlis_stage_desc(MLIS_Stage x);  /* Pretty description */
MLIS_Stage mlis_stage_fromz(const char* s);

const char* mlis_method_str(MLIS_Method x);
MLIS_Method mlis_method_fromz(const char* s);

const char* mlis_sched_str(MLIS_Scheduler x);
MLIS_Scheduler mlis_sched_fromz(const char* s);

const char* mlis_loglvl_str(MLIS_LogLvl x);
MLIS_LogLvl mlis_loglvl_fromz(const char* s);

const char* mlis_model_type_str(MLIS_ModelType x);
const char* mlis_model_type_desc(MLIS_ModelType x);
MLIS_ModelType mlis_model_type_fromz(const char* s);

const char* mlis_option_str(MLIS_Option x);
MLIS_Option mlis_option_fromz(const char* s);

/* Compatibility alias: the reference header's progress-callback example
 * (include/mlimgsynth.h:17) calls mlis_state_str on the progress stage;
 * provided so that code written against that example links. */
const char* mlis_state_str(MLIS_Stage x);

/* Iteration over the four dimensions of a tensor T (innermost first).
 * Declares L##p (flat index) and L##0..L##3 (per-dim indices).
 * Example:
 *   MLIS_Tensor ten = {0};
 *   mlis_tensor_resize(&ten, 32, 32, 32, 32);
 *   mlis_tensor_for(ten, i) { ten.d[ip] = i0 + i1 + i2 + i3; }
 */
#define mlis_tensor_for(T, L) \
	for (int L##p=0, L##0=0, L##1=0, L##2=0, L##3=0, \
		L##0n=(T).n[0], L##1n=(T).n[1], L##2n=(T).n[2], L##3n=(T).n[3]; \
		(L##0 < L##0n) || \
		(L##0=0, L##1++, L##1 < L##1n) || \
		(L##1=0, L##2++, L##2 < L##2n) || \
		(L##2=0, L##3++, L##3 < L##3n) ; \
		++L##0, ++L##p)

#ifdef __cplusplus
}
#endif
#endif /* MLIMGSYNTH_TPU_H */
