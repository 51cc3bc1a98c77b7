"""Image buffers and codecs.

Counterpart of the reference's image + codec layer
(reference: src/ccommon/image*.{h,c}): 8-bit images, PNG with the A1111
``parameters`` tEXt metadata chunk (image_io_png.c:310), JPEG, PNM; plus the
tensor<->image converters (reference: src/mlimgsynth.c:100-152) and the
trivial ``TENSOR`` file format used for latent save/load
(reference: src/localtensor.c:196-253).

Tensors at this boundary are numpy float32 in NCHW-like order ``[n,c,h,w]``
(the row-major view of the reference's ggml ``[w,h,c,n]`` layout) so TENSOR
files are byte-compatible.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np


def tensor_from_image_arr(img: np.ndarray) -> np.ndarray:
    """uint8 [h,w,c] -> float32 [1,c,h,w] in [0,1]."""
    if img.ndim == 2:
        img = img[:, :, None]
    x = img.astype(np.float32) / 255.0
    return x.transpose(2, 0, 1)[None]


def tensor_to_image_arr(t: np.ndarray, idx: int = 0) -> np.ndarray:
    """float32 [n,c,h,w] in [0,1] -> uint8 [h,w,c]."""
    x = np.clip(t[idx] * 255.0, 0, 255).astype(np.uint8)
    return x.transpose(1, 2, 0)


_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_encode(img: np.ndarray, infotext: Optional[str] = None) -> bytes:
    """uint8 [h,w,c] (c in 1, 3, 4) -> PNG bytes, with the standard library
    only (zlib, struct).  ``infotext`` goes into the A1111 ``parameters``
    chunk: tEXt when it is Latin-1, else an uncompressed UTF-8 iTXt (as
    Pillow's ``PngInfo.add_text`` writes it)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    # every scanline gets filter byte 0 (none)
    raw = np.zeros((h, 1 + w * c), np.uint8)
    raw[:, 1:] = img.reshape(h, w * c)
    out = [_PNG_SIG,
           _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                           0, 0, 0))]
    if infotext:
        try:
            out.append(_png_chunk(
                b"tEXt", b"parameters\0" + infotext.encode("latin-1")))
        except UnicodeEncodeError:
            # keyword, no compression, no language tag or translated key
            out.append(_png_chunk(
                b"iTXt", b"parameters\0\0\0\0\0" + infotext.encode("utf-8")))
    out.append(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
    out.append(_png_chunk(b"IEND", b""))
    return b"".join(out)


def _png_text(tag: bytes, body: bytes) -> Optional[Tuple[str, str]]:
    """(key, text) of one tEXt, zTXt or iTXt chunk body; None for other
    chunks and malformed ones."""
    if b"\0" not in body:
        return None
    key, rest = body.split(b"\0", 1)
    key = key.decode("latin-1")
    if tag == b"tEXt":
        return key, rest.decode("latin-1")
    if tag == b"zTXt" and rest[:1] == b"\0":          # method 0: zlib
        return key, zlib.decompress(rest[1:]).decode("latin-1")
    if tag == b"iTXt" and len(rest) >= 2 and rest.count(b"\0", 2) >= 2:
        compressed = rest[0] == 1
        # skip the language tag and the translated keyword
        text = rest[2:].split(b"\0", 2)[2]
        if compressed:
            text = zlib.decompress(text)
        return key, text.decode("utf-8")
    return None


def png_text_chunks(data: bytes) -> Dict[str, str]:
    """All tEXt, zTXt and iTXt key/value pairs of a PNG byte string."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    out: Dict[str, str] = {}
    pos = 8
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IEND":
            break
        kv = _png_text(tag, data[pos + 8:pos + 8 + n])
        if kv is not None:
            out[kv[0]] = kv[1]
        pos += 12 + n
    return out


def image_save(path: str, img: np.ndarray, infotext: Optional[str] = None
               ) -> None:
    """Save uint8 [h,w,c]; PNG embeds infotext as the A1111 'parameters'
    text key.  PNG is written with the standard library; other formats
    need Pillow."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        with open(path, "wb") as f:
            f.write(png_encode(img, infotext))
        return
    from PIL import Image
    if img.shape[2] == 1:
        img = img[:, :, 0]
    im = Image.fromarray(img)
    if ext in (".jpg", ".jpeg"):
        im.save(path, quality=95)
    else:
        im.save(path)


def image_load(path: str) -> np.ndarray:
    """Load an image as uint8 [h,w,c] (keeps alpha if present)."""
    from PIL import Image
    im = Image.open(path)
    if im.mode not in ("RGB", "RGBA", "L"):
        im = im.convert("RGBA" if "A" in im.mode else "RGB")
    arr = np.asarray(im)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


# ---------------------------------------------------------------------------
# TENSOR file format (reference: src/localtensor.c:196-253)
# "TENSOR F32 n0 n1 n2 n3\n" + raw float32 data, ggml dim order (w h c n).
# ---------------------------------------------------------------------------

def tensor_save(path: str, t: np.ndarray) -> None:
    """t: float32 [n,c,h,w]."""
    t = np.ascontiguousarray(t, dtype=np.float32)
    n, c, h, w = t.shape
    with open(path, "wb") as f:
        f.write(f"TENSOR F32 {w} {h} {c} {n}\n".encode())
        f.write(t.tobytes())


def tensor_load(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"\n"):
            ch = f.read(1)
            if not ch or len(header) > 128:
                raise ValueError("invalid TENSOR file header")
            header += ch
        parts = header.decode().split()
        if len(parts) != 6 or parts[0] != "TENSOR" or parts[1] != "F32":
            raise ValueError(f"invalid TENSOR header: {header!r}")
        w, h, c, n = (int(x) for x in parts[2:6])
        data = np.frombuffer(f.read(), np.float32, n * c * h * w)
        return data.reshape(n, c, h, w).copy()


def mask_downsize(mask: np.ndarray, f: int) -> np.ndarray:
    """Block-mean downsize of a [n,1,h,w] mask by factor f
    (reference: ltensor_downsize, src/localtensor.c:161-194)."""
    n, c, h, w = mask.shape
    assert h % f == 0 and w % f == 0
    return mask.reshape(n, c, h // f, f, w // f, f).mean(axis=(3, 5))


def image_alpha_split(t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[n,4,h,w] -> rgb [n,3,h,w], mask [n,1,h,w]
    (reference: OPTION(IMAGE) alpha split, mlimgsynth_options_set.c.h)."""
    return t[:, :3], t[:, 3:4]


def png_read_parameters(path: str) -> Optional[str]:
    """Read back the A1111 'parameters' text metadata from a PNG."""
    with open(path, "rb") as f:
        return png_text_chunks(f.read()).get("parameters")


def tensor_img_redblue(t2d: np.ndarray) -> np.ndarray:
    """Red/blue visualization of a single-channel 2-D tensor: negative values
    red, positive blue, scaled by the max magnitude
    (reference: ltensor_img_redblue, src/localtensor.c:305-344).
    Input [h,w]; returns uint8 [h,w,3]."""
    v = np.asarray(t2d, np.float32)
    scale = max(float(v.max(initial=0.0)), float(-v.min(initial=0.0)), 1e-12)
    img = np.zeros(v.shape + (3,), np.uint8)
    img[..., 0] = np.clip(-v, 0, None) * (255.0 / scale)
    img[..., 2] = np.clip(v, 0, None) * (255.0 / scale)
    return img


def _resize_float_nchw(t: np.ndarray, th: int, tw: int,
                       resample=None) -> np.ndarray:
    """Per-channel PIL resize of float NCHW [n,c,h,w] (mode 'F', default
    Lanczos; no u8 round-trip)."""
    from PIL import Image
    if resample is None:
        resample = Image.LANCZOS
    n, c = t.shape[:2]
    out = np.empty((n, c, th, tw), np.float32)
    for i in range(n):
        for j in range(c):
            im = Image.fromarray(np.asarray(t[i, j], np.float32), mode="F")
            out[i, j] = np.asarray(im.resize((tw, th), resample),
                                   np.float32)
    return out


def inpaint_crop_region(mask: np.ndarray, w: int, h: int, pad: int,
                        mult: int = 8):
    """A1111 "inpaint at full resolution": padded bounding box of the
    mask (NCHW [1,1,H,W], white = repaint), expanded toward the target
    w:h aspect and clamped to the image.  Returns (x0, y0, x1, y1) in
    image pixels (multiples of ``mult``), or None for an empty mask."""
    m = np.asarray(mask[0, 0]) > 0.5
    ys, xs = np.nonzero(m)
    if ys.size == 0:
        return None
    H, W = m.shape
    y0, y1 = max(0, int(ys.min()) - pad), min(H, int(ys.max()) + 1 + pad)
    x0, x1 = max(0, int(xs.min()) - pad), min(W, int(xs.max()) + 1 + pad)
    # expand the short side toward the processing aspect ratio
    want = w / h
    cw, ch = x1 - x0, y1 - y0
    if cw / ch < want:     # too narrow: widen
        need = min(int(round(ch * want)), W) - cw
        x0 = max(0, x0 - need // 2)
        x1 = min(W, x0 + cw + need)
        x0 = max(0, x1 - min(int(round(ch * want)), W))
    elif cw / ch > want:   # too short: heighten
        need = min(int(round(cw / want)), H) - ch
        y0 = max(0, y0 - need // 2)
        y1 = min(H, y0 + ch + need)
        y0 = max(0, y1 - min(int(round(cw / want)), H))
    # round the box out to multiples of mult (clamped)
    x0, y0 = (x0 // mult) * mult, (y0 // mult) * mult
    x1, y1 = min(W, -(-x1 // mult) * mult), min(H, -(-y1 // mult) * mult)
    return x0, y0, x1, y1


def inpaint_paste(orig: np.ndarray, result: np.ndarray, mask: np.ndarray,
                  box) -> np.ndarray:
    """Resize the processed crop back to the box and blend it into the
    original image under the mask (float NCHW, [0,1])."""
    x0, y0, x1, y1 = box
    res = _resize_float_nchw(result, y1 - y0, x1 - x0)
    out = np.array(orig, np.float32, copy=True)
    m = np.asarray(mask[:, :1, y0:y1, x0:x1], np.float32)
    out[:, :, y0:y1, x0:x1] = (res * m
                               + out[:, :, y0:y1, x0:x1] * (1.0 - m))
    return np.clip(out, 0.0, 1.0)


def mask_gaussian_blur(mask: np.ndarray, radius: float) -> np.ndarray:
    """Gaussian-blur a float NCHW [n,1,H,W] mask (A1111 ``mask_blur``:
    softens inpaint seams).  Separable numpy convolution with
    edge-replicate padding (PIL's GaussianBlur rejects mode-'F')."""
    sigma = max(float(radius), 1e-3)
    r = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()

    def blur1d(a, axis):
        p = [(0, 0)] * a.ndim
        p[axis] = (r, r)
        a = np.pad(a, p, mode="edge")
        return np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="valid"), axis, a)

    out = np.asarray(mask, np.float32)
    out = blur1d(out, 2)
    out = blur1d(out, 3)
    return np.clip(out, 0.0, 1.0, out)
