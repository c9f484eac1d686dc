"""Mamba-1 selective scan: the CUDA kernel (``csrc/mamba_scan.cu``), its
plain PyTorch version, and the kernel's launch counter.

Replaces ``repro/kernels/mamba_scan.py::mamba_scan`` (the Pallas TPU
kernel).  Per row and channel, with an (N,) f32 state::

    h_t = exp(dt_t ⊙ A) ⊙ h_{t-1} + (dt_t u_t) ⊗ B_t
    y_t = h_t · C_t + D ⊙ u_t

Without ``h0`` the state starts at zero and ``(y, h_last)`` is what the
TPU kernel returns.  With ``h0`` the recurrence continues from it, as
the JAX engine's prefill and decode do through ``nn.selective_scan``,
and the state advances in place: the returned ``h_last`` is ``h0``,
overwritten (the engine's per-slot state needs no copy).  The kernel
takes any S >= 1 unpadded, so the TPU wrapper's dt = 0 padding is not
needed.  It splits a channel's N state entries over N / 8 lanes (one
lane at N = 4 or 8) and streams u, dt, B and C through shared memory
(``csrc/mamba_scan.cu`` says why).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_D_STATES = (4, 8, 16)   # instantiated in csrc/mamba_scan.cu


def mamba_scan_plain(u, dt, A, B, C, D, h0=None):
    """The kernel's arithmetic in plain PyTorch (CPU tests, card checks):
    the stepwise oracle.  Same arguments and result as
    :func:`mamba_scan`, ``h0`` advanced in place included."""
    y, h_last = ref.mamba_scan_ref(u, dt, A, B, C, D, h0)
    if h0 is None:
        return y, h_last
    return y, h0.copy_(h_last)


def _bind():
    lib = _build.library("mamba_scan")
    fn = lib.mamba_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mamba_scan_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.mamba_scan_smem_bytes.restype = ctypes.c_size_t
    return lib


def mamba_scan(u, dt, A, B, C, D, h0=None):
    """Launch the CUDA kernel on PyTorch's current stream.

    u, dt: (B, S, Ci) and B, C: (B, S, N), all of one dtype, float32 or
    bfloat16, with S >= 1 and N in 4, 8 or 16; A: (Ci, N) and D: (Ci,)
    float32; h0: None or (B, Ci, N) float32, advanced in place.  All
    contiguous on one CUDA device; anything else raises.  Returns (y
    (B, S, Ci) in u's dtype, h_last (B, Ci, N) float32, which is ``h0``
    when given).  Raises under autograd: the kernel has no backward yet.
    """
    _build.refuse_grad("mamba_scan", u, dt, A, B, C, D, h0)
    if u.dim() != 3 or dt.shape != u.shape:
        raise ValueError(f"u and dt must share one (B, S, Ci) shape, got "
                         f"{tuple(u.shape)} and {tuple(dt.shape)}")
    b, s, ci = u.shape
    if A.dim() != 2 or A.shape[0] != ci:
        raise ValueError(f"A {tuple(A.shape)} must be (Ci={ci}, N)")
    n = A.shape[1]
    if B.shape != (b, s, n) or C.shape != (b, s, n):
        raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} must "
                         f"be (B, S, N) = {(b, s, n)}")
    if tuple(D.shape) != (ci,):
        raise ValueError(f"D {tuple(D.shape)} must be (Ci,) = {(ci,)}")
    if s < 1 or n not in _D_STATES:
        raise ValueError(f"mamba_scan's kernel takes S >= 1 and N in "
                         f"{_D_STATES}, got S={s}, N={n}")
    tensors = (u, dt, A, B, C, D) + (() if h0 is None else (h0,))
    if u.device.type != "cuda" or any(t.device != u.device for t in tensors):
        raise ValueError("mamba_scan's kernel takes CUDA tensors on one "
                         "device")
    if u.dtype not in _DTYPES or any(t.dtype != u.dtype for t in (dt, B, C)):
        raise TypeError(f"u, dt, B, C must share float32 or bfloat16, got "
                        f"{[t.dtype for t in (u, dt, B, C)]}")
    if A.dtype != torch.float32 or D.dtype != torch.float32:
        raise TypeError(f"A and D must be float32, got {A.dtype}, {D.dtype}")
    if h0 is not None and (h0.dtype != torch.float32
                           or tuple(h0.shape) != (b, ci, n)):
        raise TypeError(f"h0 must be float32 (B, Ci, N) = {(b, ci, n)}, "
                        f"got {h0.dtype} {tuple(h0.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mamba_scan's kernel takes contiguous tensors")
    lib = _bind()
    y = torch.empty_like(u)
    h_last = (h0 if h0 is not None
              else torch.empty((b, ci, n), dtype=torch.float32,
                               device=u.device))
    err = lib.mamba_scan_launch(
        _DTYPES[u.dtype], u.data_ptr(), dt.data_ptr(), A.data_ptr(),
        B.data_ptr(), C.data_ptr(), D.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), b, s, ci, n, _build.stream_handle(u.device))
    if err:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{err}")
    mamba_scan.launches += 1
    return y, h_last


mamba_scan.launches = 0
