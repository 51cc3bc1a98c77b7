"""Checkpoint tensor store: lazy, mmap-backed safetensors / GGUF access.

Counterpart of the reference tensorstore
(reference: src/ccompute/tensorstore.{h,c}, tensorstore_safet.c,
tensorstore_gguf.c):

* only headers are parsed at open; tensor bytes stay memory-mapped until
  requested,
* ``TensorEntry.read(dtype)`` returns a numpy array, zero-copy when the
  on-disk dtype matches, converting otherwise (f16/f32/bf16/f64/ints and the
  ggml quantized formats q8_0/q4_1/q4_K/q5_K/q6_K),
* a per-store cache holds patched tensors (LoRA merges) that override the
  mmap data on subsequent reads,
* ``write_safetensors`` emits an aligned safetensors file (the ``tstore-util
  convert`` path).

Shapes are kept in row-major (torch) order, unlike the reference's
reversed ggml order — the natural layout for numpy/JAX.
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import gquant

# numpy-representable dtypes
_NP_DTYPES = {
    "f64": np.float64,
    "f32": np.float32,
    "f16": np.float16,
    "i64": np.int64,
    "i32": np.int32,
    "i16": np.int16,
    "i8": np.int8,
    "u8": np.uint8,
    "bool": np.bool_,
}

_SAFET_DTYPES = {  # safetensors header name -> internal name
    "F64": "f64", "F32": "f32", "F16": "f16", "BF16": "bf16",
    "I64": "i64", "I32": "i32", "I16": "i16", "I8": "i8",
    "U8": "u8", "BOOL": "bool",
    # ggml-quantized extension dtypes (as written by tstore-util convert;
    # the reference reads/writes the same lowercase names)
    "Q8_0": "q8_0", "Q4_1": "q4_1", "Q4_K": "q4_k", "Q5_K": "q5_k",
    "Q6_K": "q6_k",
}
_SAFET_DTYPES_INV = {v: k for k, v in _SAFET_DTYPES.items()}

# ggml dtype id <-> internal name (reference: tensorstore.c:29-96)
GGML_DTYPES = {
    0: "f32", 1: "f16", 3: "q4_1", 8: "q8_0", 12: "q4_k", 13: "q5_k",
    14: "q6_k", 24: "i8", 25: "i16", 26: "i32", 27: "i64", 28: "f64",
    30: "bf16",
}
GGML_DTYPES_INV = {v: k for k, v in GGML_DTYPES.items()}


def dtype_size(dtype: str, n_elem: int) -> int:
    if dtype in _NP_DTYPES:
        return n_elem * np.dtype(_NP_DTYPES[dtype]).itemsize
    if dtype == "bf16":
        return n_elem * 2
    if dtype in gquant.BLOCK_SIZES:
        return gquant.nbytes(dtype, n_elem)
    raise ValueError(f"unknown dtype '{dtype}'")


def bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    u16 = raw.view(np.uint16).astype(np.uint32) << 16
    return u16.view(np.float32)


def f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16, returned as uint16 words."""
    u = x.astype(np.float32).view(np.uint32)
    rounding = ((u >> 16) & 1) + 0x7FFF
    return ((u + rounding) >> 16).astype(np.uint16)


@dataclass
class TensorEntry:
    name: str
    dtype: str
    shape: Tuple[int, ...]        # row-major (torch) order
    offset: int                   # absolute byte offset in the file
    size: int                     # byte size on disk
    store: "TensorStore" = field(repr=False, default=None)

    @property
    def n_elem(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def raw(self) -> np.ndarray:
        """Raw on-disk bytes as a uint8 view (zero-copy into the mmap)."""
        return np.frombuffer(self.store.data, np.uint8, self.size, self.offset)

    def read(self, dtype: Optional[str] = None) -> np.ndarray:
        """Read the tensor, converting to ``dtype`` ('f32' etc) if given.
        ``None`` returns f32 for quantized/bf16 data, native otherwise."""
        cached = self.store.cache.get(self.name)
        if cached is not None:
            x = cached
        elif self.dtype in _NP_DTYPES:
            x = np.frombuffer(self.store.data, _NP_DTYPES[self.dtype],
                              self.n_elem, self.offset).reshape(self.shape)
        elif self.dtype == "bf16":
            x = bf16_to_f32(self.raw()).reshape(self.shape)
        elif self.dtype in gquant.DEQUANT:
            x = gquant.DEQUANT[self.dtype](self.raw(), self.n_elem)
            x = x.reshape(self.shape)
        else:
            raise ValueError(f"cannot read dtype '{self.dtype}'")
        if dtype is not None and dtype in _NP_DTYPES:
            x = np.ascontiguousarray(x, dtype=_NP_DTYPES[dtype])
        return x


class TensorStore:
    """A set of named tensor entries over one or more mapped files."""

    def __init__(self):
        self.tensors: Dict[str, TensorEntry] = {}
        self.meta: Dict[str, str] = {}
        self.cache: Dict[str, np.ndarray] = {}
        self._files: List = []
        self.data: Optional[memoryview] = None
        self.format: Optional[str] = None

    # -- open / detect ------------------------------------------------------

    @classmethod
    def open(cls, path: str) -> "TensorStore":
        st = cls()
        st.read_file(path)
        return st

    def read_file(self, path: str, prefix: str = "") -> None:
        f = open(path, "rb")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._files.append((f, mm))
        data = memoryview(mm)
        magic = bytes(data[:8])
        if magic[:4] == b"GGUF":
            self._read_gguf(data, prefix)
            self.format = self.format or "gguf"
        else:
            hlen = struct.unpack("<Q", magic)[0]
            if hlen < 2 or hlen > len(data) - 8 or data[8:9] != b"{":
                raise ValueError(f"unknown checkpoint format: {path}")
            self._read_safetensors(data, prefix)
            self.format = self.format or "safetensors"
        if self.data is None:
            self.data = data
        elif len(self._files) > 1:
            # Multi-file stores keep per-entry file references via offset
            # into their own map; entries created below point at `data`.
            pass

    # -- safetensors --------------------------------------------------------

    def _read_safetensors(self, data: memoryview, prefix: str = "") -> None:
        hlen = struct.unpack("<Q", data[:8])[0]
        header = json.loads(bytes(data[8:8 + hlen]).decode("utf-8"))
        base = 8 + hlen
        store_for_entries = self._entry_store(data)
        for name, info in header.items():
            if name == "__metadata__":
                for k, v in info.items():
                    self.meta[k] = v
                continue
            dt = _SAFET_DTYPES.get(info["dtype"])
            if dt is None:
                raise ValueError(f"unknown dtype '{info['dtype']}' in '{name}'")
            shape = tuple(int(s) for s in info["shape"])
            beg, end = info["data_offsets"]
            e = TensorEntry(name=prefix + name, dtype=dt, shape=shape,
                            offset=base + int(beg), size=int(end) - int(beg),
                            store=store_for_entries)
            if dtype_size(dt, e.n_elem) != e.size:
                raise ValueError(f"invalid size {e.size} for '{name}'")
            self.tensors[e.name] = e

    # -- GGUF ---------------------------------------------------------------

    _GGUF_SIMPLE = {
        0: ("<B", 1), 1: ("<b", 1), 2: ("<H", 2), 3: ("<h", 2),
        4: ("<I", 4), 5: ("<i", 4), 6: ("<f", 4), 7: ("<?", 1),
        10: ("<Q", 8), 11: ("<q", 8), 12: ("<d", 8),
    }

    def _read_gguf(self, data: memoryview, prefix: str = "") -> None:
        pos = 4
        version, = struct.unpack_from("<I", data, pos); pos += 4
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors, = struct.unpack_from("<Q", data, pos); pos += 8
        n_kv, = struct.unpack_from("<Q", data, pos); pos += 8

        def read_str():
            nonlocal pos
            n, = struct.unpack_from("<Q", data, pos); pos += 8
            s = bytes(data[pos:pos + n]).decode("utf-8", errors="replace")
            pos += n
            return s

        def read_val(t):
            nonlocal pos
            if t in self._GGUF_SIMPLE:
                fmt, sz = self._GGUF_SIMPLE[t]
                v, = struct.unpack_from(fmt, data, pos); pos += sz
                return v
            if t == 8:
                return read_str()
            if t == 9:
                at, = struct.unpack_from("<I", data, pos); pos += 4
                n, = struct.unpack_from("<Q", data, pos); pos += 8
                return [read_val(at) for _ in range(n)]
            raise ValueError(f"bad GGUF metadata type {t}")

        alignment = 32
        for _ in range(n_kv):
            key = read_str()
            t, = struct.unpack_from("<I", data, pos); pos += 4
            v = read_val(t)
            if key == "general.alignment":
                alignment = int(v)
            self.meta[key] = v if isinstance(v, str) else json.dumps(v)

        entries = []
        store_for_entries = self._entry_store(data)
        for _ in range(n_tensors):
            name = read_str()
            nd, = struct.unpack_from("<I", data, pos); pos += 4
            dims = struct.unpack_from("<" + "Q" * nd, data, pos); pos += 8 * nd
            gtype, = struct.unpack_from("<I", data, pos); pos += 4
            off, = struct.unpack_from("<Q", data, pos); pos += 8
            dt = GGML_DTYPES.get(gtype)
            if dt is None:
                raise ValueError(f"unsupported GGUF tensor type {gtype} "
                                 f"for '{name}'")
            # GGUF dims are in ggml order (innermost first) -> reverse
            shape = tuple(int(d) for d in reversed(dims))
            entries.append((prefix + name, dt, shape, off))

        data_base = (pos + alignment - 1) // alignment * alignment
        for name, dt, shape, off in entries:
            n_elem = int(np.prod(shape)) if shape else 1
            e = TensorEntry(name=name, dtype=dt, shape=shape,
                            offset=data_base + off,
                            size=dtype_size(dt, n_elem),
                            store=store_for_entries)
            self.tensors[e.name] = e

    def _entry_store(self, data: memoryview) -> "TensorStore":
        # entries need `.store.data` to point at the file they came from
        if self.data is None or self.data.obj is data.obj:
            self.data = data
            return self
        sub = TensorStore.__new__(TensorStore)
        sub.data = data
        sub.cache = self.cache
        return sub

    # -- access -------------------------------------------------------------

    def get(self, name: str) -> Optional[TensorEntry]:
        return self.tensors.get(name)

    def read(self, name: str, dtype: Optional[str] = None) -> np.ndarray:
        e = self.tensors.get(name)
        if e is None:
            raise KeyError(name)
        return e.read(dtype)

    def cache_set(self, name: str, value: np.ndarray) -> None:
        """Override a tensor's data (used by LoRA patching)."""
        self.cache[name] = value

    def cache_clear(self) -> None:
        self.cache.clear()

    def names(self) -> List[str]:
        return sorted(self.tensors)

    def close(self) -> None:
        self.data = None
        for f, mm in self._files:
            mm.close()
            f.close()
        self._files.clear()

    # -- write --------------------------------------------------------------

    def write_safetensors(self, path: str, dtype: Optional[str] = None,
                          names: Optional[List[str]] = None) -> None:
        """Write entries to a new safetensors file, optionally converting all
        float tensors to ``dtype`` (reference: tstore_write_safet +
        tsu_dtype_convert, main_tstore_util.c:141-199).  Tensor data is
        packed back to back, as the safetensors format requires."""
        names = names if names is not None else self.names()
        header: Dict[str, dict] = {}
        if self.meta:
            header["__metadata__"] = {
                k: v for k, v in self.meta.items() if isinstance(v, str)}
        plans = []
        offset = 0
        for name in names:
            e = self.tensors[name]
            out_dt = e.dtype
            if dtype is not None and e.dtype not in ("i64", "i32", "i16", "i8",
                                                     "u8", "bool"):
                out_dt = dtype
                if out_dt in gquant.BLOCK_ELEMS and (
                        len(e.shape) < 2 or
                        e.shape[-1] % gquant.BLOCK_ELEMS[out_dt] != 0):
                    # small/odd tensors (biases, norms) can't be
                    # block-quantized; keep them in f16
                    out_dt = "f16"
            size = dtype_size(out_dt, e.n_elem)
            header[name] = {
                "dtype": _SAFET_DTYPES_INV.get(out_dt, out_dt.upper()),
                "shape": list(e.shape),
                "data_offsets": [offset, offset + size],
            }
            plans.append((e, out_dt, offset, size))
            offset += size

        hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
        hjson += b" " * ((-len(hjson)) % 8)
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", len(hjson)))
            f.write(hjson)
            base = f.tell()
            for e, out_dt, off, size in plans:
                f.seek(base + off)
                f.write(convert_bytes(e, out_dt))


def _gguf_pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def write_gguf(store: "TensorStore", path: str,
               dtype: Optional[str] = None,
               names: Optional[List[str]] = None) -> None:
    """Write entries to a GGUF v3 file (the reference leaves GGUF writing
    as a TODO, tensorstore_gguf.c:237).  Optionally converts float tensors
    to ``dtype``."""
    align = 32
    names = names if names is not None else store.names()
    header = b"GGUF" + struct.pack("<IQQ", 3, len(names),
                                   1 + len(store.meta))
    header += _gguf_pack_str("general.alignment") + struct.pack("<I", 4) \
        + struct.pack("<I", align)
    for k, v in store.meta.items():
        header += _gguf_pack_str(k) + struct.pack("<I", 8) \
            + _gguf_pack_str(str(v))

    plans = []
    infos = b""
    offset = 0
    for name in names:
        e = store.tensors[name]
        out_dt = e.dtype
        if dtype is not None and e.dtype not in ("i64", "i32", "i16", "i8",
                                                 "u8", "bool"):
            out_dt = dtype
            if out_dt in gquant.BLOCK_ELEMS and (
                    len(e.shape) < 2 or
                    e.shape[-1] % gquant.BLOCK_ELEMS[out_dt] != 0):
                out_dt = "f16"
        gid = GGML_DTYPES_INV.get(out_dt)
        if gid is None:
            raise ValueError(f"dtype '{out_dt}' has no GGUF representation")
        offset = (offset + align - 1) // align * align
        dims = tuple(reversed(e.shape)) or (1,)
        infos += _gguf_pack_str(name) + struct.pack("<I", len(dims))
        infos += struct.pack("<" + "Q" * len(dims), *dims)
        infos += struct.pack("<IQ", gid, offset)
        plans.append((e, out_dt, offset))
        offset += dtype_size(out_dt, e.n_elem)

    with open(path, "wb") as f:
        f.write(header + infos)
        pad = (-f.tell()) % align
        f.write(b"\0" * pad)
        base = f.tell()
        for e, out_dt, off in plans:
            f.seek(base + off)
            f.write(convert_bytes(e, out_dt))


TensorStore.write_gguf = write_gguf


_NP_TO_NAME = {np.dtype(v): k for k, v in _NP_DTYPES.items()}


def save_arrays(arrays: Dict[str, np.ndarray], path: str,
                dtype: Optional[str] = None) -> None:
    """Write numpy arrays to a safetensors file through
    :meth:`TensorStore.write_safetensors` (no ``safetensors`` package
    needed).  ``dtype`` ('f16', 'bf16', ...) converts every float tensor."""
    st = TensorStore()
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        dt = _NP_TO_NAME[a.dtype]
        st.tensors[name] = TensorEntry(name=name, dtype=dt,
                                       shape=tuple(a.shape), offset=0,
                                       size=a.nbytes, store=st)
        st.cache[name] = a
    st.write_safetensors(str(path), dtype=dtype)


def convert_bytes(e: TensorEntry, out_dt: str) -> bytes:
    """Tensor entry -> raw bytes in ``out_dt``."""
    if out_dt == e.dtype and e.name not in e.store.cache:
        return e.raw().tobytes()
    if out_dt in _NP_DTYPES:
        return e.read(out_dt).tobytes()
    x = e.read("f32").reshape(-1)
    if out_dt == "bf16":
        return f32_to_bf16(x).tobytes()
    if out_dt in gquant.QUANT:
        return gquant.QUANT[out_dt](x).tobytes()
    raise ValueError(f"cannot convert to dtype '{out_dt}'")
