"""RWKV6 WKV recurrence: the CUDA kernel (``csrc/wkv6.cu``), its plain
PyTorch version, and the kernel's launch counter.

Replaces ``repro/kernels/wkv6.py::wkv6`` (the Pallas TPU kernel).  Per
(row, head), with per-channel decay ``w`` (read clipped to [1e-8, 1])
and bonus ``u``::

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

Without ``s0`` the state starts at zero and ``(y, s_last)`` is what the
TPU kernel returns.  With ``s0`` the recurrence continues from it, as
the JAX engine's prefill and decode do through ``nn.wkv6_chunked``, and
the state advances in place: the returned ``s_last`` is ``s0``,
overwritten (the engine's per-slot state needs no copy).  The stepwise
form has no exp(±cumulative decay) term, so it stays finite at any decay
where the chunked TPU form overflows f32, and takes any S >= 1 unpadded.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (4, 8, 16, 32, 64)   # instantiated in csrc/wkv6.cu


def wkv6_plain(r, k, v, w, u, s0=None):
    """The kernel's arithmetic in plain PyTorch (CPU tests, card checks):
    the stepwise oracle on w clipped to [1e-8, 1] in f32.  Same arguments
    and result as :func:`wkv6`, ``s0`` advanced in place included."""
    y, s_last = ref.wkv6_ref(r, k, v, w.float().clamp(1e-8, 1.0), u, s0)
    if s0 is None:
        return y, s_last
    return y, s0.copy_(s_last)


def _bind():
    lib = _build.library("wkv6")
    fn = lib.wkv6_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def wkv6(r, k, v, w, u, s0=None):
    """Launch the CUDA kernel on PyTorch's current stream.

    r, k, v, w: (B, S, H, Dh) with S >= 1 and Dh in 4, 8, 16, 32 or 64;
    u: (H, Dh); all of one dtype, float32 or bfloat16.  s0: None or
    (B, H, Dh, Dh) float32, advanced in place.  All contiguous on one
    CUDA device; anything else raises.  Returns (y (B, S, H, Dh) in r's
    dtype, s_last (B, H, Dh, Dh) float32, which is ``s0`` when given).
    """
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"r, k, v, w must share one (B, S, H, Dh) shape, "
                         f"got {[tuple(t.shape) for t in (r, k, v, w)]}")
    b, s, h, dh = r.shape
    if tuple(u.shape) != (h, dh):
        raise ValueError(f"u {tuple(u.shape)} must be (H, Dh) = {(h, dh)}")
    if s < 1 or dh not in _HEAD_DIMS:
        raise ValueError(f"wkv6's kernel takes S >= 1 and Dh in "
                         f"{_HEAD_DIMS}, got S={s}, Dh={dh}")
    tensors = (r, k, v, w, u) + (() if s0 is None else (s0,))
    if r.device.type != "cuda" or any(t.device != r.device for t in tensors):
        raise ValueError("wkv6's kernel takes CUDA tensors on one device")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype
                                     for t in (k, v, w, u)):
        raise TypeError(f"r, k, v, w, u must share float32 or bfloat16, got "
                        f"{[t.dtype for t in (r, k, v, w, u)]}")
    if s0 is not None and (s0.dtype != torch.float32
                           or tuple(s0.shape) != (b, h, dh, dh)):
        raise TypeError(f"s0 must be float32 (B, H, Dh, Dh) = "
                        f"{(b, h, dh, dh)}, got {s0.dtype} {tuple(s0.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("wkv6's kernel takes contiguous tensors")
    lib = _bind()
    y = torch.empty_like(r)
    s_last = (s0 if s0 is not None
              else torch.empty((b, h, dh, dh), dtype=torch.float32,
                               device=r.device))
    err = lib.wkv6_launch(
        _DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), None if s0 is None else s0.data_ptr(),
        y.data_ptr(), s_last.data_ptr(), b, s, h, dh,
        _build.stream_handle(r.device))
    if err:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    wkv6.launches += 1
    return y, s_last


wkv6.launches = 0
