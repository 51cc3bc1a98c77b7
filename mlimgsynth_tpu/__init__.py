"""mlimgsynth_tpu: a JAX Stable Diffusion inference framework.

A from-scratch JAX/XLA/Pallas rebuild with the capabilities of mlimgsynth
(SD1/SD2/SDXL txt2img, img2img, inpainting, LoRA, TAE, k-diffusion samplers)
designed for one accelerator or a mesh of them: NHWC bf16 compute,
fully-jitted sampling loops, batched CFG, fused attention, and multi-device
sharding via jax.sharding.
"""

__version__ = "0.1.0"

MLIS_VERSION = (0, 5, 0)  # tracks the reference API version it mirrors


def __getattr__(name):
    # lazy imports keep `import mlimgsynth_tpu` light (no jax init)
    if name == "MLImgSynth":
        from .api import MLImgSynth
        return MLImgSynth
    if name == "MlisError":
        from .api import MlisError
        return MlisError
    raise AttributeError(name)
