"""The standard-library PNG writer: pixels and the A1111 'parameters' text
chunk (tEXt, or iTXt beyond Latin-1) round-trip through an independent decoder (Pillow) and through the
repo's own chunk reader."""
import io

import numpy as np
import pytest
from PIL import Image

from mlimgsynth_tpu.utils import image as image_mod

INFO = ("a cat, <lora:x:0.5>\nNegative prompt: blurry\nSteps: 20, "
        "Sampler: Euler, CFG scale: 7, Seed: 42, Size: 64x48")


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("hw", [(1, 1), (48, 64), (7, 13)])
def test_png_encode_pixels_roundtrip(c, hw):
    rng = np.random.default_rng(c * 100 + hw[0])
    img = rng.integers(0, 256, hw + (c,), dtype=np.uint8)
    data = image_mod.png_encode(img, INFO)
    im = Image.open(io.BytesIO(data))
    assert im.size == (hw[1], hw[0])
    assert im.mode == {1: "L", 3: "RGB", 4: "RGBA"}[c]
    got = np.asarray(im)
    np.testing.assert_array_equal(got.reshape(img.shape), img)
    assert im.info["parameters"] == INFO


def test_png_text_chunks_reads_pillow_output():
    """The chunk reader is not tied to our writer: Pillow's tEXt chunks
    come back too."""
    from PIL.PngImagePlugin import PngInfo
    info = PngInfo()
    info.add_text("parameters", INFO)
    info.add_text("Software", "test")
    buf = io.BytesIO()
    Image.new("RGB", (4, 4)).save(buf, format="PNG", pnginfo=info)
    assert image_mod.png_text_chunks(buf.getvalue()) == {
        "parameters": INFO, "Software": "test"}


def test_png_text_chunks_rejects_non_png():
    with pytest.raises(ValueError):
        image_mod.png_text_chunks(b"GIF89a" + b"\0" * 20)


NON_LATIN1 = "a lighthouse \u201cat dusk\u201d, \u6d77, \U0001f30a\nSteps: 20"


@pytest.mark.parametrize("infotext", [None, "", INFO, "café ☃", NON_LATIN1])
def test_image_save_png_parameters(tmp_path, infotext):
    img = np.full((8, 8, 3), 128, np.uint8)
    p = str(tmp_path / "x.png")
    image_mod.image_save(p, img, infotext)
    got = image_mod.png_read_parameters(p)
    # Latin-1 text goes to tEXt, anything else to a UTF-8 iTXt chunk
    assert got == (infotext or None)
    im = Image.open(p)
    np.testing.assert_array_equal(np.asarray(im), img)
    if infotext:
        assert im.info["parameters"] == infotext


@pytest.mark.parametrize("infotext,chunk", [(INFO, b"tEXt"),
                                            (NON_LATIN1, b"iTXt")])
def test_png_encode_text_chunk_type(infotext, chunk):
    data = image_mod.png_encode(np.zeros((2, 2, 3), np.uint8), infotext)
    assert chunk + b"parameters\0" in data


@pytest.mark.parametrize("value,zip_", [(INFO, True), (NON_LATIN1, False),
                                        (NON_LATIN1, True)])
def test_png_text_chunks_reads_pillow_ztxt_itxt(value, zip_):
    """Pillow writes zTXt for compressed Latin-1 text and iTXt (plain or
    compressed) for other text; the reader takes all three."""
    from PIL.PngImagePlugin import PngInfo
    info = PngInfo()
    info.add_text("parameters", value, zip=zip_)
    info.add_itxt("Comment", "\u00e9t\u00e9", lang="fr", tkey="Commentaire")
    buf = io.BytesIO()
    Image.new("RGB", (4, 4)).save(buf, format="PNG", pnginfo=info)
    data = buf.getvalue()
    assert (b"zTXt" if value == INFO else b"iTXt") in data
    assert image_mod.png_text_chunks(data) == {
        "parameters": value, "Comment": "\u00e9t\u00e9"}
