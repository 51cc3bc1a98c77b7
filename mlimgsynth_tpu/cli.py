"""mlimgsynth command-line interface.

Command and flag surface mirrors the reference CLI
(reference: src/main_mlimgsynth.c): commands generate / list-backends /
vae-encode / vae-decode / vae-test / clip-encode / tokenize / check, short
options, unknown long options forwarded to the library option system (so the
CLI automatically tracks every library option), ``-`` as stdin/stdout pipes,
progress printing with ETA, latent tensor I/O via --olatent/--ilatent, and
PNG infotext metadata.
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np

HELP = """mlimgsynth-tpu v{version}
Image synthesis using AI, on JAX/XLA.
Currently Stable Diffusion 1, 2, XL, XL-refiner, 3 / 3.5 (MMDiT) and
Flux.1 are implemented.

Usage: mlimgsynth [COMMAND] [OPTIONS]

Commands:
  generate             Generate an image.
  serve                Run an HTTP image-generation server (--port 8188).
  list-backends        List available JAX backends/devices.
  vae-encode           Encode an image to a latent.
  vae-decode           Decode a latent to an image.
  vae-test             Encode and decode an image.
  clip-encode          Encode a prompt with the CLIP tokenizer and model.
  tokenize             Tokenize text (testing).
  upscale              Upscale an image with the --upscaler ESRGAN model.
  check                Check that all operations (models) are working.

Generation options:
  -p --prompt TEXT     Prompt for text conditioning.
  -n --nprompt TEXT    Negative prompt.
  -d --image-dim W,H   Image dimensions. Default: 512 (SD1), 768 (SD2),
                       1024 (SDXL).
  -i --input PATH      Input image for img2img or inpainting.
                       An alpha channel is used as the inpainting mask.
  --imask PATH         Input image mask for inpainting (reference/alpha
                       convention: white/opaque = KEEP, black = repaint;
                       the HTTP serving API uses the inverse A1111
                       convention, white = repaint).
  --mask-blur R        Gaussian-blur the inpainting mask (A1111 seam
                       softening; default 0).
  --inpaint-full-res B Crop-around-mask inpainting: process the padded
                       mask region at full model resolution, paste back
                       (--inpaint-full-res-padding N, default 32).
  --subseed N          Variation seed (with --subseed-strength F: the
                       initial noise slerps toward this stream).
  --tiling B           Seamless tiling: circular conv padding in UNet
                       and VAE, output wraps without seams (textures).
  --deepcache N        DeepCache-style model caching: refresh the deep
                       part every N steps, reuse it in between (~1.5-2x
                       faster, slight quality cost).  UNets cache the
                       deep levels + mid transformer; SD3/Flux cache the
                       deep block tail.  1-eval solvers only (euler,
                       dpm++2m[_sde], taylor3, unipc).
  --ilatent PATH       Input latent tensor.
  --ilmask PATH        Input latent mask tensor.
  -o --output PATH     Output image path.
  --olatent PATH       Output latent tensor path.
  --no-prompt-parse B  Use the prompt as raw text (no emphasis/lora parsing).
                       Prompts support A1111 emphasis ((x:1.5), [x]),
                       <lora:NAME:MULT>, <emb:NAME>, and prompt editing
                       ([from:to:when], [add:when], [gone::when], [a|b]).

Models and backend:
  -m --model PATH      Model file (safetensors or GGUF).
  --tae PATH           TAE model file. Enables TAE instead of VAE.
  --lora PATH,MULT     Apply a LoRA (multiplier optional; repeatable).
  --lora-dir PATH      Directory searched for <lora:NAME:MULT> prompt tags.
  --embed-dir PATH     Directory searched for <emb:NAME> textual-inversion
                       embeddings (NAME.safetensors or NAME.pt).
  --control-net PATH   ControlNet model file (control_model.* / diffusers).
  --control-image PATH Hint image (edge/pose/depth map; output-sized).
  --control-strength F ControlNet residual strength (default 1).
  --upscaler PATH      ESRGAN/RRDBNet upscaler model (.safetensors/.pth);
                       used by the upscale command and the image-space
                       highres-fix (--hires-upscaler NAME).
  --upscale-factor F   upscale command: final scale factor (default: the
                       model's native factor, usually 4).
  --upscale-tile N     upscale command: bound per-dispatch memory by
                       tiling the input at N px (0 = whole image).
  --refiner PATH       Ensemble-of-experts refiner model: the base model
                       stops at the switch point and this model (e.g. the
                       SDXL refiner) finishes from the same noise level.
  --refiner-switch F   Fraction of the denoising done by the base model
                       before the refiner takes over (default 0.8).
  --hires-fix F        Two-stage highres-fix: latent upscale factor (>1
                       enables; base pass at --image-dim).
  --hires-denoise F    Highres refine-pass strength (default 0.7).
  --hires-steps INT    Highres refine-pass steps (0 = same as --steps).
  -b --backend NAME    Computation backend (gpu, cpu; default: best).
  -t --threads INT     Host thread count (accepted for compatibility).
  --unet-split BOOL    Stage-wise weight residency to reduce memory usage.
  --vae-tile INT       Tiled VAE encode/decode with NxN pixel tiles.
  --weight-type NAME   Weight dtype (f32, f16/bf16, q8_0, ...).
  --batch-size INT     Images per batch (one batched device program).
  --dp INT             Data-parallel devices: shards the batch over a device
                       mesh (batch-size must be a multiple; multi-device).
  --tp INT             Tensor-parallel devices: Megatron-style sharding of
                       the UNet attention/FF matmuls over the mesh.
  --sp INT             Sequence-parallel devices: shards the attention token
                       axis over the mesh (ring attention over the mesh; for the
                       long-sequence DiT families).
  --pp INT             Pipeline-parallel stages: cuts the MMDiT block stack
                       into stages with microbatches streamed between devices
                       (each stage holds 1/pp of the block weights).

Sampling:
  -S --seed INT        RNG seed.
  -s --steps INT       Denoising steps with UNet.
  --method NAME        euler, euler_a, heun, taylor3, dpm++2m, dpm++2s,
                       dpm++2s_a, dpm++2m_sde, lcm, unipc (default euler;
                       lcm is consistency sampling for LCM/LCM-LoRA models;
                       unipc is order-2 bh2 predictor-corrector).
  --scheduler NAME     uniform (default), karras, exponential, sgm_uniform,
                       beta, lcm (implied by --method lcm).
  --s-noise FLOAT      Per-step noise injection (try 1).
  --s-ancestral FLOAT  Ancestral sampling noise level (try 1).
  --cfg-scale FLOAT    Classifier-free guidance scale (default: 1).
  --cfg-rescale FLOAT  CFG std-rescale phi in [0,1] (Lin et al. 2023;
                       counters v-pred over-exposure, try 0.7; default 0).
  --freeu VAL          FreeU backbone/skip reweighting: y = per-family
                       defaults, or explicit B1,B2,S1,S2 (UNet models).
  --slg-scale FLOAT    Skip-layer guidance scale (SD3/SD3.5 MMDiT only;
                       SD3.5-medium recommends 2.5-3; default 0 = off).
  --slg-layers LIST    Joint blocks elided in the SLG pass (default 7,8,9).
  --slg-start FLOAT    SLG window start, fraction of steps (default 0.01).
  --slg-end FLOAT      SLG window end, fraction of steps (default 0.2).
  --pag-scale FLOAT    Perturbed-attention guidance scale (SD-UNet models;
                       try 3; extra eval with identity mid self-attention).
  --pag-start FLOAT    PAG window start, fraction of steps (default 0).
  --pag-end FLOAT      PAG window end, fraction of steps (default 1).
  --clip-skip INT      CLIP layers to skip. Default: 1 (SD1), 2 (SD2/XL).
  --f-t-ini FLOAT      Initial time factor (img2img strength; default 1).
  --f-t-end FLOAT      End time factor (default 0).

Output control:
  -v --verbose         More information output (repeatable).
  -q --quiet           Output only errors.
  --silent             No terminal output.
  --debug              Debug output.
  -h --help            Print this message and exit.
  -V --version         Print the version and exit.
"""

SHORT_OPTS = {
    "h": "help", "V": "version", "v": "verbose", "q": "quiet",
    "b": "backend", "m": "model", "p": "prompt", "n": "nprompt",
    "d": "image-dim", "s": "steps", "S": "seed", "t": "threads",
    "i": "input", "o": "output",
}

# long options handled by the CLI itself; everything else forwards to the
# library option table (reference: main_mlimgsynth.c:243-251)
CLI_PATH_OPTS = ("input", "imask", "ilatent", "ilmask", "output", "olatent",
                 "port", "control-image", "upscale-factor", "upscale-tile",
                 "model-dir")


class CliState:
    def __init__(self):
        self.cmd: Optional[str] = None
        self.paths = {k: None for k in CLI_PATH_OPTS}
        self.opts: List = []
        self.done = False
        self.verbosity = 0


def parse_args(argv: List[str]) -> CliState:
    st = CliState()
    i = 0
    n = len(argv)

    def handle(name: str) -> bool:
        """Returns True if the next argv element was consumed as a value."""
        nonlocal i
        nxt = argv[i + 1] if i + 1 < n else ""
        if name == "help":
            st.cmd = "help"
            st.done = True
        elif name == "version":
            st.cmd = "version"
            st.done = True
        elif name == "verbose":
            st.verbosity += 1
        elif name == "quiet":
            st.verbosity = -1
        elif name == "silent":
            st.verbosity = -2
        elif name == "debug":
            st.verbosity = 2
        elif name in CLI_PATH_OPTS:
            st.paths[name] = nxt
            return True
        else:
            st.opts.append((name, nxt))
            return True
        return False

    while i < n:
        arg = argv[i]
        if arg.startswith("--"):
            if handle(arg[2:]):
                i += 1
        elif arg.startswith("-") and len(arg) > 1:
            for ch in arg[1:]:
                name = SHORT_OPTS.get(ch)
                if name is None:
                    raise SystemExit(f"Unknown short option '{ch}'")
                if handle(name):
                    i += 1
        elif st.cmd is None:
            st.cmd = arg
        else:
            raise SystemExit("Excess of positional arguments")
        if st.done:
            break
        i += 1
    return st


def _load_image(path: str) -> np.ndarray:
    from .utils import image as image_mod
    if path == "-":
        from PIL import Image
        import io
        return np.asarray(Image.open(io.BytesIO(sys.stdin.buffer.read())))
    return image_mod.image_load(path)


def _save_image(img_u8: np.ndarray, infotext: Optional[str], path: str):
    from .utils import image as image_mod
    if path == "-":
        from PIL import Image
        im = Image.fromarray(img_u8)
        im.save(sys.stdout.buffer, format="PPM")
        return
    image_mod.image_save(path, img_u8, infotext)


def _progress_printer(state: CliState):
    from .api import STAGE_DENOISE, STAGE_NAMES
    from .utils.log import g_logger as log

    def cb(session, prg):
        if log.check(30):
            line = (f"{STAGE_NAMES[prg['stage']]} {prg['step']}/"
                    f"{prg['step_end']} {{{prg['step_time']:.3f}s}}")
            if prg["stage"] == STAGE_DENOISE:
                line += f" nfe:{prg['nfe']}"
            if 1 < prg["step"] < prg["step_end"]:
                etc = (prg["step_end"] - prg["step"]) * prg["step_time"]
                line += f" etc:{etc:.0f}s"
            sys.stderr.write(line + "\n")
        return 0

    return cb


def cmd_generate(session, state: CliState):
    from .api import TUF_LATENT, TUF_LMASK
    from .utils import image as image_mod
    tuflags = 0
    if state.paths["input"]:
        session.option_set("image", _load_image(state.paths["input"]))
    if state.paths["imask"]:
        m = _load_image(state.paths["imask"])
        session.option_set("image_mask",
                           image_mod.tensor_from_image_arr(m)[:, :1])
    if state.paths["ilatent"]:
        session.tensors["latent"] = image_mod.tensor_load(
            state.paths["ilatent"])
        tuflags |= TUF_LATENT
    if state.paths["ilmask"]:
        session.tensors["lmask"] = image_mod.tensor_load(
            state.paths["ilmask"])
        tuflags |= TUF_LMASK
    if state.paths["control-image"]:
        session.option_set("control_image",
                           _load_image(state.paths["control-image"]))
    if tuflags:
        session.c["tuflags"] |= tuflags

    session.generate()

    if state.paths["olatent"]:
        image_mod.tensor_save(state.paths["olatent"],
                              session.tensors["latent"])
    if state.paths["output"]:
        img = session.tensors["image"]
        for idx in range(img.shape[0]):
            path = state.paths["output"]
            if img.shape[0] > 1 and path != "-":
                import os
                stem, ext = os.path.splitext(path)
                path = f"{stem}-{idx}{ext}"
            _save_image(image_mod.tensor_to_image_arr(img, idx),
                        session.infotext, path)
    return 0


def cmd_vae(session, state: CliState, encode: bool, decode: bool):
    from .utils import image as image_mod
    orig = None
    if encode:
        if not state.paths["input"]:
            raise SystemExit("You must set the input image path.")
        img = _load_image(state.paths["input"])
        t = image_mod.tensor_from_image_arr(img)[:, :3]
        orig = t.copy()
        latent = session.image_encode(t)
        session.tensors["latent"] = latent
        if state.paths["olatent"]:
            image_mod.tensor_save(state.paths["olatent"], latent)
    else:
        if not state.paths["ilatent"]:
            raise SystemExit("You must set the input latent path.")
        session.tensors["latent"] = image_mod.tensor_load(
            state.paths["ilatent"])
    if decode:
        img_t = session.image_decode(session.tensors["latent"])
        session.tensors["image"] = img_t
        if state.paths["output"]:
            _save_image(image_mod.tensor_to_image_arr(img_t), None,
                        state.paths["output"])
    if encode and decode:
        img_t = session.tensors["image"]
        rmse = float(np.sqrt(np.mean((orig - img_t) ** 2)))
        psnr = 20 * np.log10(1.0 / rmse) if rmse > 0 else float("inf")
        sys.stderr.write(f"Image encode/decode mse: {rmse:.3f} "
                         f"(PSNR {psnr:.1f} dB)\n")
    return 0


def cmd_upscale(session, state: CliState):
    from .utils import image as image_mod
    if not state.paths["input"]:
        raise SystemExit("You must set the input image path.")
    img = _load_image(state.paths["input"])
    t = image_mod.tensor_from_image_arr(img)[:, :3]
    factor = state.paths["upscale-factor"]
    tile = state.paths["upscale-tile"]
    out = session.upscale(t, resize=float(factor) if factor else None,
                          tile=int(tile) if tile else 0)
    if not state.paths["output"]:
        raise SystemExit("You must set the output image path.")
    _save_image(image_mod.tensor_to_image_arr(out), None,
                state.paths["output"])
    return 0


def cmd_clip_encode(session, state: CliState):
    from .utils import image as image_mod
    text = session.c["prompt_raw"]
    has_proj = True
    try:
        embed, feat = session.clip_text_encode(text, want_feat=True)
    except KeyError:
        has_proj = False
        embed, feat = session.clip_text_encode(text, want_feat=False)
    image_mod.tensor_save("clip-embed.tensor",
                          embed[:, :, :, None].transpose(0, 3, 1, 2))
    if has_proj and feat is not None:
        image_mod.tensor_save("clip-feat.tensor",
                              feat[:, :, None, None].transpose(0, 2, 3, 1))
    return 0


def cmd_tokenize(session, state: CliState):
    toks = session.text_tokenize(session.c["prompt_raw"])
    print(" ".join(str(t) for t in toks))
    return 0


def cmd_check(session, state: CliState) -> int:
    """Run small computations through every op family and report status
    (the reference declares this command but leaves it unimplemented,
    main_mlimgsynth.c:605-611)."""
    import jax
    import jax.numpy as jnp
    from .models import blocks as B
    from .ops.attention import attention

    checks = []

    def check(name, fn):
        t0 = time.time()
        try:
            fn()
            checks.append((name, True, time.time() - t0))
        except Exception as e:  # noqa
            checks.append((name, False, time.time() - t0))
            print(f"  {name}: FAIL ({e})")

    check("matmul", lambda: jnp.dot(jnp.ones((128, 128), jnp.bfloat16),
                                    jnp.ones((128, 128), jnp.bfloat16)
                                    ).block_until_ready())
    check("conv2d", lambda: jax.lax.conv_general_dilated(
        jnp.ones((1, 16, 16, 8)), jnp.ones((3, 3, 8, 8)), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")).block_until_ready())
    check("attention", lambda: attention(
        jnp.ones((1, 2, 64, 64)), jnp.ones((1, 2, 64, 64)),
        jnp.ones((1, 2, 64, 64))).block_until_ready())
    check("groupnorm", lambda: B.group_norm(
        B.Ctx({"g.weight": jnp.ones(32), "g.bias": jnp.zeros(32)},
              dtype=jnp.float32), "g",
        jnp.ones((1, 4, 4, 32))).block_until_ready())
    check("philox", lambda: __import__(
        "mlimgsynth_tpu.rng", fromlist=["philox_randn"]
        ).philox_randn(0, 0, 1000))
    check("tokenizer", lambda: __import__(
        "mlimgsynth_tpu.tokenizer", fromlist=["tokenize"]
        ).tokenize("check"))

    # with a model set, run every submodel once on tiny inputs
    # (the reference declares this but leaves it unimplemented)
    if session.c["model"]:
        def check_clip():
            emb, _ = session.clip_text_encode("check")
            assert np.isfinite(emb).all()

        def check_vae():
            lat = session.image_encode(
                np.full((1, 3, 64, 64), 0.5, np.float32), sample=False)
            img = session.image_decode(lat)
            assert np.isfinite(img).all()

        def check_unet():
            session.option_set("steps", 1)
            session.option_set("no-decode", True)
            session.option_set("image-dim", 64)
            session.option_set("prompt", "check")
            lat = session.generate()
            assert np.isfinite(lat).all()
            session.option_set("no-decode", False)

        check("model:clip", check_clip)
        check("model:vae", check_vae)
        check("model:unet", check_unet)
    ok = all(c[1] for c in checks)
    for name, good, dt in checks:
        print(f"  {name:12s} {'OK' if good else 'FAIL'} {{{dt:.3f}s}}")
    print("CHECK OK" if ok else "CHECK FAILED")
    return 0 if ok else 1


def cmd_list_backends(session, state: CliState):
    info = session.backend_info()
    print(info["name"])
    for d in info["devs"]:
        line = f"\t{d['name']} '{d['desc']}'"
        if "mem_total" in d and d["mem_total"]:
            gib = 1 / (1024 ** 3)
            line += (f" {d.get('mem_free', 0) * gib:.1f}"
                     f"/{d['mem_total'] * gib:.1f}GiB")
        print(line)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    from . import __version__
    from .api import Aborted, MLImgSynth, MlisError
    from .utils.log import g_logger as log

    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        state = parse_args(argv)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 1

    if state.cmd == "help":
        print(HELP.format(version=__version__))
        return 0
    if state.cmd == "version":
        print(f"mlimgsynth-tpu v{__version__}")
        return 0

    if state.verbosity == -2:
        log.level = 0
    elif state.verbosity == -1:
        log.level = 10
    elif state.verbosity == 2:
        log.level = 50
    elif state.verbosity > 0:
        log.level = 30 + 10 * state.verbosity

    from .utils.compcache import enable as _cc
    _cc()
    session = MLImgSynth()
    # Default the auxiliary directory to the one holding the launcher, like
    # the reference CLI (main_mlimgsynth.c:642-652); an explicit --aux-dir
    # in state.opts overrides it below.
    import os as _os
    bin_dir = _os.path.dirname(_os.path.abspath(sys.argv[0] or "."))
    session.option_set_str("aux-dir", bin_dir)
    try:
        for name, value in state.opts:
            session.option_set_str(name, value)
    except MlisError as e:
        print(f"failed to set option: {e}", file=sys.stderr)
        return 1

    # per-step progress forces step-at-a-time dispatch; skip it when quiet
    # so the fused single-dispatch loop runs
    if state.verbosity >= 0:
        session.option_set("callback", _progress_printer(state))

    def cmd_serve(session, st):
        from .server import serve
        serve(session, port=int(st.paths["port"] or 8188),
              model_dir=st.paths["model-dir"] or "")
        return 0

    commands = {
        "generate": cmd_generate,
        "serve": cmd_serve,
        "list-backends": cmd_list_backends,
        "vae-encode": lambda s, st: cmd_vae(s, st, True, False),
        "vae-decode": lambda s, st: cmd_vae(s, st, False, True),
        "vae-test": lambda s, st: cmd_vae(s, st, True, True),
        "clip-encode": cmd_clip_encode,
        "tokenize": cmd_tokenize,
        "upscale": cmd_upscale,
        "check": cmd_check,
    }
    if state.cmd is None:
        print("No command. Use -h for help.")
        return 0
    fn = commands.get(state.cmd)
    if fn is None:
        print(f"Unknown command '{state.cmd}'", file=sys.stderr)
        return 1
    try:
        return fn(session, state) or 0
    except (MlisError,) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except Aborted:
        return 130


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # stdout reader closed early (e.g. `... --help | head`): exit
        # quietly like the C tool would under SIGPIPE.
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(141)
