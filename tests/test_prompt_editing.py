"""A1111 prompt editing on the fused pipeline: per-step conditioning bank
gathered inside the fused scan."""
import numpy as np
import pytest
import jax.numpy as jnp

from mlimgsynth_tpu.api import MLImgSynth, MlisError
from helpers import (TINY_MODEL_TYPE, TINY_MODEL_TYPE_XL,
                     patch_tiny_model_types, write_tiny_checkpoint,
                     write_checkpoint_sdxl)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny_edit.safetensors"
    write_tiny_checkpoint(path)
    return str(path)


def make(ckpt, mt="sd1"):
    s = MLImgSynth()
    s._dtype = jnp.float32
    s.option_set("model", ckpt)
    s.option_set("model-type", mt)
    s.option_set("image-dim", 64)
    s.option_set("steps", 4)
    s.option_set("seed", 21)
    return s


def test_editing_identity_equivalence(ckpt, monkeypatch):
    """[cat:cat:2] collapses to one segment; the bank-gather path must be
    bit-identical to the plain static-conditioning path."""
    patch_tiny_model_types(monkeypatch)
    s = make(ckpt)
    s.option_set("prompt", "a cat photo")
    base = s.generate()

    s2 = make(ckpt)
    s2.option_set("prompt", "a [cat:cat:2] photo")
    assert s2.prompt.editing
    out = s2.generate()
    np.testing.assert_array_equal(base, out)


def test_editing_switch_changes_output(ckpt, monkeypatch):
    """Compared at the latent (pre-u8) level: the tiny random model's
    cond deltas are far below image quantization."""
    patch_tiny_model_types(monkeypatch)
    s = make(ckpt)
    s.option_set("no-decode", 1)

    def gen(prompt):  # session rng continues across generates: re-seed
        s.option_set("seed", 21)
        s.option_set("prompt", prompt)
        return np.asarray(s.generate())

    a = gen("a [cat:dog:2] photo")
    assert np.isfinite(a).all()
    b = gen("a cat photo")
    d = gen("a dog photo")
    # the edited run is its own trajectory: differs from both pure runs
    assert not np.array_equal(a, b)
    assert not np.array_equal(a, d)
    # same editing prompt reproduces exactly
    np.testing.assert_array_equal(a, gen("a [cat:dog:2] photo"))


def test_editing_negative_prompt(ckpt, monkeypatch):
    patch_tiny_model_types(monkeypatch)
    s = make(ckpt)
    s.option_set("prompt", "a photo")
    s.option_set("nprompt", "[blurry|noisy]")
    assert s.nprompt.editing
    img = s.generate()
    assert np.isfinite(img).all()


def test_editing_chunked_path_parity(ckpt, monkeypatch):
    """The cancellable (step-callback) path gathers from the same bank:
    results match the single-dispatch editing run exactly."""
    patch_tiny_model_types(monkeypatch)
    s = make(ckpt)
    s.option_set("prompt", "a [cat:dog:2] photo")
    fused = s.generate()
    s2 = make(ckpt)
    s2.option_set("callback", lambda *a: 0)
    s2.option_set("prompt", "a [cat:dog:2] photo")
    np.testing.assert_array_equal(fused, s2.generate())


def test_editing_sdxl_labels(tmp_path, monkeypatch):
    """SDXL: per-segment pooled features ride the label bank."""
    patch_tiny_model_types(monkeypatch, {"sdxl": TINY_MODEL_TYPE_XL})
    path = tmp_path / "xl.safetensors"
    write_checkpoint_sdxl(path)
    s = make(str(path), mt="sdxl")
    s.option_set("prompt", "a [cat:cat:2] photo")
    out = s.generate()
    s2 = make(str(path), mt="sdxl")
    s2.option_set("prompt", "a cat photo")
    np.testing.assert_array_equal(out, s2.generate())


def test_editing_batch_path(ckpt, monkeypatch):
    """Batched serving path: editing requests merge with plain ones; a
    collapsing edit ([cat:cat:2]) is bit-identical to its plain twin and
    per-request results are batch-invariant."""
    patch_tiny_model_types(monkeypatch)
    s = make(ckpt)
    reqs = [{"prompt": "a [cat:cat:2] photo", "seed": 5},
            {"prompt": "a [red|red] ball", "seed": 6}]
    plain = [{"prompt": "a cat photo", "seed": 5},
             {"prompt": "a red ball", "seed": 6}]
    imgs, infos = s.generate_batch(reqs)
    base, _ = s.generate_batch(plain)
    np.testing.assert_array_equal(imgs, base)

    # real switch: still batch-invariant per request
    mixed = [{"prompt": "a [cat:dog:2] photo", "seed": 5},
             {"prompt": "a red ball", "seed": 6}]
    out, _ = s.generate_batch(mixed)
    solo, _ = s.generate_batch([mixed[0]])
    np.testing.assert_array_equal(out[0], solo[0])
    np.testing.assert_array_equal(out[1], base[1])
