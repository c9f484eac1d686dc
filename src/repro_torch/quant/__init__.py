"""Quantized weight / KV-cache storage dtypes (port of ``repro/quant``).

Serving memory is the resident weights plus the KV pool; this package
holds the storage formats of both:

  * **int8 weights**, per output channel: each matmul weight ``w`` is
    stored as ``{"q": int8, "scale": f32}``, the scale of ``w``'s shape
    with the contraction axis reduced to 1 (keepdims), so dequantizing
    is one broadcast ``q * scale``.
  * **fp8-e4m3 weights**: the same layout, payload ``float8_e4m3fn``
    scaled so each channel's absmax maps to the format's max (448).
  * **int8 KV pages**, one f32 scale per (page, KV head): the paged
    kernel (``kernels/csrc/paged_attention.cu``) dequantizes inside its
    page walk, ``kernels/ref.py`` carries the oracle.

A quantized leaf is a plain ``{"q", "scale"}`` dict, as in the JAX
package, so the params tree stays nested dicts and only the matmul call
sites in ``models/nn.py`` / ``models/lm_head.py`` call
:func:`maybe_dequant`.  The JAX package's pspec twin has no counterpart:
the port shards nothing.  Numerics follow the JAX package exactly: the
absmax of the weight in f32 with a zero channel's replaced by 1, ``w /
scale``, round half to even, clip to ±127; dequantizing multiplies in
f32 and casts once.

``weight_byte_cost`` / ``kv_byte_cost`` price the formats as the JAX
planner does: payload bytes plus the f32 scales amortized per element.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

WEIGHT_DTYPES = ("fp32", "bf16", "fp8", "int8")
KV_DTYPES = ("fp32", "bf16", "int8")
ACT_BYTES = 2.0   # bf16 activations: the pricing default without a kv dtype

_STORAGE_BYTES = {"fp32": 4.0, "bf16": 2.0, "fp16": 2.0,
                  "fp8": 1.0, "int8": 1.0}
_INT8_MAX = 127.0
_FP8_MAX = 448.0          # float8_e4m3fn finite max


def storage_bytes(name: str) -> float:
    """Payload bytes per element for a storage dtype name."""
    return _STORAGE_BYTES[name]


def is_quantized(leaf) -> bool:
    """True for the ``{"q", "scale"}`` dict encoding of a quantized leaf."""
    return isinstance(leaf, dict) and set(leaf) == {"q", "scale"}


# --------------------------------------------------------------------------
# Leaf-level quantize / dequantize
# --------------------------------------------------------------------------

def _absmax(x, dims):
    """f32 absmax over ``dims`` (keepdims), a zero absmax replaced by 1."""
    amax = x.float().abs().amax(dim=dims, keepdim=True)
    return torch.where(amax > 0, amax, torch.ones_like(amax))


def quantize(w, dtype_name: str, axis: int) -> Dict[str, torch.Tensor]:
    """Quantize one weight along its contraction ``axis``: ``{"q":
    payload, "scale": f32}`` with a keepdims scale."""
    if dtype_name == "int8":
        scale = _absmax(w, axis) / _INT8_MAX
        q = torch.round(w.float() / scale)
        q = q.clamp(-_INT8_MAX, _INT8_MAX).to(torch.int8)
    elif dtype_name == "fp8":
        scale = _absmax(w, axis) / _FP8_MAX
        q = (w.float() / scale).to(torch.float8_e4m3fn)
    else:
        raise ValueError(f"unknown quantized weight dtype {dtype_name!r}; "
                         f"expected one of ('int8', 'fp8')")
    return {"q": q, "scale": scale}


def dequantize(w: Dict[str, torch.Tensor], dtype=None):
    """``q * scale`` in f32, cast to ``dtype``.  An int8 payload promotes
    inside the multiply (one kernel, exact: int8 values are f32
    values); PyTorch does not promote fp8, so an fp8 payload is widened
    first."""
    q = w["q"]
    if q.is_floating_point():
        q = q.float()
    out = q * w["scale"]
    return out if dtype is None else out.to(dtype)


def maybe_dequant(w, dtype=None):
    """Dequantize a ``{"q", "scale"}`` leaf; pass plain tensors through
    (cast to ``dtype`` when given).  Every matmul site wraps its weight
    in this, so only the weight in use exists at full precision."""
    if is_quantized(w):
        return dequantize(w, dtype)
    return w if dtype is None or w.dtype == dtype else w.to(dtype)


# --------------------------------------------------------------------------
# Whole-tree quantization
# --------------------------------------------------------------------------

# (parent key, leaf key) -> contraction axis of the stage-stacked array.
# Only the attn / dense-mlp / moe matmul families quantize: norms,
# routers, rope scalars and the Mamba / RWKV mixers stay in compute dtype.
_STAGE_RULES = {
    ("attn", "wq"): 1, ("attn", "wk"): 1, ("attn", "wv"): 1,
    ("attn", "wo"): 1,
    ("xattn", "wq"): 1, ("xattn", "wk"): 1, ("xattn", "wv"): 1,
    ("xattn", "wo"): 1,
    ("mlp", "w1"): 1, ("mlp", "w2"): 1, ("mlp", "w3"): 1,
    ("shared", "w1"): 1, ("shared", "w2"): 1, ("shared", "w3"): 1,
    ("moe", "w1"): 2, ("moe", "w2"): 2, ("moe", "w3"): 2,
}


def quantized_axis(path: Tuple[str, ...]) -> Optional[int]:
    """Contraction axis for a stages-tree leaf path, or None (skip)."""
    if len(path) >= 2:
        return _STAGE_RULES.get((path[-2], path[-1]))
    return None


def quantize_params(params: Dict, dtype_name: Optional[str]) -> Dict:
    """Quantize a serving params tree **in place** and return it.

    Stage matmuls follow ``_STAGE_RULES``; ``embed`` quantizes per
    vocab row (axis 1), ``head`` per vocab column (axis 0); everything
    else stays.  Leaves are replaced one at a time in ``params``' own
    dicts, so each full-precision leaf is freed as soon as its payload
    exists: the largest transient is one leaf's f32 copy, not a second
    tree (the JAX package returns a new tree; under jit XLA frees the
    same way).  "fp32", "bf16" and None leave the tree as it is.
    """
    if dtype_name in ("fp32", "bf16", None):
        return params
    if dtype_name not in WEIGHT_DTYPES:
        raise ValueError(f"unknown weight dtype {dtype_name!r}; expected "
                         f"one of {WEIGHT_DTYPES}")

    def walk(node: Dict, path: Tuple[str, ...]) -> None:
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            axis = quantized_axis(path + (k,))
            if axis is not None:
                node[k] = quantize(v, dtype_name, axis)

    walk(params["stages"], ())
    for name, axis in (("embed", 1), ("head", 0)):
        if name in params:
            params[name] = quantize(params[name], dtype_name, axis)
    return params


# --------------------------------------------------------------------------
# int8 KV pages (write side; the read side is the paged kernel's page
# walk and its plain version)
# --------------------------------------------------------------------------

def quantize_kv_page_batched(pages):
    """(B, page, KV, Dh) -> (int8 payload, (B, KV) f32 scale): one scale
    per (page, KV head), the absmax over the page's tokens and Dh."""
    scale = (_absmax(pages, (1, 3)) / _INT8_MAX)       # (B, 1, KV, 1)
    q = torch.round(pages.float() / scale)
    q = q.clamp(-_INT8_MAX, _INT8_MAX).to(torch.int8)
    return q, scale[:, 0, :, 0]


def dequantize_kv_pages(q_pages, scales, dtype=torch.float32):
    """(P, page, KV, Dh) int8 + (P, KV) f32 -> dequantized pages."""
    return (q_pages.float() * scales[:, None, :, None]).to(dtype)


# --------------------------------------------------------------------------
# Analytic pricing
# --------------------------------------------------------------------------

def weight_byte_cost(dtype_name: Optional[str], spec, hw) -> float:
    """Bytes per weight parameter under a storage dtype.

    None / "auto" is ``hw.param_bytes``; int8 and fp8 add the f32
    per-output-channel scale amortized over a d_model fan-in.
    """
    if dtype_name in (None, "auto"):
        return hw.param_bytes
    b = storage_bytes(dtype_name)
    if dtype_name in ("int8", "fp8"):
        b += 4.0 / spec.d_model
    return b


def kv_byte_cost(dtype_name: Optional[str], spec, page_size: int = 0) -> float:
    """Bytes per KV-cache element.  None / "auto" is ``ACT_BYTES``; int8
    adds the per-(page, KV head) f32 scale amortized over the ``page_size
    · d_head`` elements it covers (``d_head`` for a dense cache)."""
    if dtype_name in (None, "auto"):
        return ACT_BYTES
    b = storage_bytes(dtype_name)
    if dtype_name == "int8":
        span = (page_size if page_size else 1) * spec.d_head
        b += 4.0 / span
    return b
