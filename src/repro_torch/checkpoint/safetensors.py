"""A reader and a writer of the safetensors format, in numpy.

The JAX package reads and writes HF checkpoints through the
``safetensors`` package; the port keeps its own copy of the format so
that the converter runs where only torch and numpy are installed.

The format: an 8-byte little-endian header length ``n``, ``n`` bytes of
JSON (per tensor ``{"dtype", "shape", "data_offsets": [begin, end]}``,
offsets into the byte buffer that follows; an optional
``"__metadata__"`` dict of strings), then the raw little-endian bytes.

:func:`iter_tensors` yields one tensor at a time, each read by a seek
and a read of its own bytes, so a converter holds one tensor of a shard
at a time.  BF16 is widened exactly to float32 (``uint16 << 16``); F32,
F16, F64 and the integer and bool types come back as themselves.  The
bfloat16 rounding and the C-order copies of strided arrays run as torch
CPU ops, which use every core (numpy's run on one).

:func:`save_file` writes what the ``safetensors`` package writes, byte
for byte: tensors ordered by dtype (widest first, the package's order)
then by name, the header JSON without spaces, ``__metadata__`` first,
padded with spaces to a multiple of 8 bytes.  ``dtype="BF16"`` stores
float tensors as bfloat16, rounded to nearest even.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

# safetensors dtype name -> numpy dtype of the stored bytes
_NP = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
    "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1", "BOOL": "?",
}
_NAME = {np.dtype(v).str: k for k, v in _NP.items() if k not in ("BF16",)}
# the safetensors package's write order: its dtype enum, widest first
_ORDER = ("U64", "I64", "F64", "F32", "U32", "I32", "BF16", "F16", "U16",
          "I16", "I8", "U8", "BOOL")


class SafetensorsError(ValueError):
    """A file that is not a well-formed safetensors file."""


def _header(f, path: str) -> Tuple[dict, int]:
    raw = f.read(8)
    if len(raw) != 8:
        raise SafetensorsError(f"{path!r}: shorter than a safetensors "
                               f"header")
    (n,) = struct.unpack("<Q", raw)
    size = os.fstat(f.fileno()).st_size
    if n > size - 8:
        raise SafetensorsError(f"{path!r}: header length {n} runs past the "
                               f"end of the file ({size} bytes)")
    try:
        header = json.loads(f.read(n).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SafetensorsError(f"{path!r}: header is not JSON ({e})") \
            from None
    return header, 8 + n


def read_header(path: str) -> Tuple[Dict[str, dict], Dict[str, str]]:
    """(tensors' entries by name, ``__metadata__`` or {})."""
    with open(path, "rb") as f:
        header, _ = _header(f, path)
    meta = header.pop("__metadata__", None) or {}
    return header, meta


def _decode(buf: bytearray, entry: dict, key: str, path: str) -> np.ndarray:
    dt = entry["dtype"]
    if dt not in _NP:
        raise SafetensorsError(f"{path!r}: tensor {key!r} has dtype {dt!r}, "
                               f"which this reader does not take")
    arr = np.frombuffer(buf, dtype=_NP[dt])
    shape = tuple(int(s) for s in entry["shape"])
    if arr.size != int(np.prod(shape, dtype=np.int64)):
        raise SafetensorsError(
            f"{path!r}: tensor {key!r} holds {len(buf)} bytes, not the "
            f"{dt} shape {list(shape)}")
    if dt == "BF16":
        arr = np.left_shift(arr, 16, dtype=np.uint32).view(np.float32)
    return arr.reshape(shape)


def iter_tensors(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield ``(name, array)`` for every tensor of one file, in name order
    (the order the ``safetensors`` package's ``keys()`` gives), each read
    from the file on its own."""
    with open(path, "rb") as f:
        header, base = _header(f, path)
        header.pop("__metadata__", None)
        for key in sorted(header):
            entry = header[key]
            begin, end = (int(o) for o in entry["data_offsets"])
            buf = bytearray(end - begin)
            f.seek(base + begin)
            if f.readinto(buf) != end - begin:
                raise SafetensorsError(f"{path!r}: tensor {key!r} runs past "
                                       f"the end of the file")
            yield key, _decode(buf, entry, key, path)


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of one file, by name."""
    return dict(iter_tensors(path))


def _to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """float -> bfloat16 bits, rounded to nearest even (torch's cast)."""
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _c_order(a: np.ndarray, dtype: str) -> np.ndarray:
    """``a`` as a C-contiguous array of ``dtype`` (the bytes to store)."""
    a = np.asarray(a)
    if a.flags["C_CONTIGUOUS"] or a.dtype.kind not in "fiu" \
            or a.dtype.byteorder == ">":
        return np.ascontiguousarray(a, dtype)
    return torch.from_numpy(a).contiguous().numpy().astype(dtype,
                                                           copy=False)


def save_file(tensors: Dict[str, np.ndarray], path: str,
              metadata: Optional[Dict[str, str]] = None,
              dtype: Optional[str] = None) -> None:
    """Write ``tensors`` as one safetensors file.

    ``dtype`` None stores each array in its own dtype; ``"BF16"`` stores
    every floating array as bfloat16 (integer arrays as themselves)."""
    if dtype not in (None, "BF16"):
        raise ValueError(f"dtype must be None or 'BF16', got {dtype!r}")
    entries: List[Tuple[str, str, np.ndarray]] = []
    for key, a in tensors.items():
        a = np.asarray(a)
        if dtype == "BF16" and a.dtype.kind == "f":
            name = "BF16"
        else:
            name = _NAME.get(a.dtype.newbyteorder("<").str)
            if name is None:
                raise SafetensorsError(f"tensor {key!r}: dtype {a.dtype} "
                                       f"has no safetensors name")
        entries.append((key, name, a))
    entries.sort(key=lambda e: (_ORDER.index(e[1]), e[0].encode("utf-8")))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off = 0
    for key, name, a in entries:
        nbytes = a.size * np.dtype(_NP[name]).itemsize
        header[key] = {"dtype": name, "shape": list(a.shape),
                       "data_offsets": [off, off + nbytes]}
        off += nbytes
    text = json.dumps(header, separators=(",", ":"),
                      ensure_ascii=False).encode("utf-8")
    text += b" " * (-len(text) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for _, name, a in entries:        # one stored copy at a time
            stored = (_to_bf16_bits(a) if name == "BF16" else
                      _c_order(a, _NP[name]))
            f.write(stored.reshape(-1).view(np.uint8))
    os.replace(tmp, path)
