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
overwritten (the engine's per-slot state needs no copy).  The plain
version is the stepwise form: it has no exp(±cumulative decay) term, so
it stays finite at any decay where the chunked TPU form overflows f32.
Both CUDA designs stay finite too and take any S >= 1 unpadded.

Two CUDA designs share the counter ``wkv6.launches``; the wrapper picks
one by shape and dtype alone (:func:`design`): bf16 calls with S >= 16
and Dh in 16, 32 or 64 (the rwkv6 prefill) run the chunked tensor-core
kernel (``wkv6.launches_chunked``), every other call (f32, the S = 1
decode step, Dh 4 or 8) the stepwise kernel (``wkv6.launches_stepwise``).
:func:`wkv6_chunked_plain` is the chunked arithmetic in plain PyTorch,
for the CPU tests; it only ever forms products of w over an interval,
never exp(-cumulative log decay), so it stays finite at any decay too.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (4, 8, 16, 32, 64)   # instantiated in csrc/wkv6.cu
_CHUNKED_HEAD_DIMS = (16, 32, 64)  # the chunked kernel's instantiations
CHUNK = 16                         # tokens a chunk of the chunked kernel


def wkv6_plain(r, k, v, w, u, s0=None):
    """The kernel's arithmetic in plain PyTorch (CPU tests, card checks):
    the stepwise oracle on w clipped to [1e-8, 1] in f32.  Same arguments
    and result as :func:`wkv6`, ``s0`` advanced in place included."""
    y, s_last = ref.wkv6_ref(r, k, v, w.float().clamp(1e-8, 1.0), u, s0)
    if s0 is None:
        return y, s_last
    return y, s0.copy_(s_last)


def _excl_cumprod(w):
    """out[:, t] = Π_{τ<t} w[:, τ] along dim 1 (1 at t = 0)."""
    ones = torch.ones_like(w[:, :1])
    return torch.cumprod(torch.cat([ones, w[:, :-1]], dim=1), dim=1)


def _excl_rev_cumprod(w):
    """out[:, t] = Π_{τ>t} w[:, τ] along dim 1 (1 at the last t)."""
    return _excl_cumprod(w.flip(1)).flip(1)


def wkv6_chunked_plain(r, k, v, w, u, s0=None, *, chunk: int = CHUNK,
                       sub: int = 8):
    """The chunked form in plain f32 PyTorch (CPU tests; nothing on the
    main path calls it).  Same arguments and result as :func:`wkv6_plain`.

    Chunks of ``chunk`` tokens (the last one ragged), sub-blocks of
    ``sub``; with P(a, b) = Π_{τ=a..b} w_τ (1 when a > b), per chunk
    c0 .. c1 with state S_in:

    - inter: y_t += (r_t ⊙ P(c0, t-1)) · S_in;
    - a sub-block's own keys, directly by running products:
      y_t += Σ_{s<t} (Σ_d r_t k_s P(s+1, t-1)) v_s;
    - keys of earlier sub-blocks, factored at the sub-block's start a:
      (r_t ⊙ P(a, t-1)) · (k_s ⊙ P(s+1, a-1)), both factors <= 1;
    - the bonus (r_t · (u ⊙ k_t)) v_t;
    - S_out = diag(P(c0, c1)) S_in + Σ_s (k_s ⊙ P(s+1, c1)) v_sᵀ.

    The defaults are the CUDA kernel's: chunks of 16 tokens, sub-blocks
    of 8 (a sub-block's own keys on the CUDA cores, the earlier
    sub-block's on the tensor cores).
    """
    b, s, h, dh = r.shape
    rf, kf, vf = (t.float() for t in (r, k, v))
    wc = w.float().clamp(1e-8, 1.0)
    uf = u.float()
    state = (torch.zeros((b, h, dh, dh), dtype=torch.float32,
                         device=r.device) if s0 is None
             else s0.float().clone())
    y = torch.empty((b, s, h, dh), dtype=torch.float32, device=r.device)
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        rc, kc, vc, wcc = (t[:, c0:c1] for t in (rf, kf, vf, wc))
        yc = torch.einsum("blhd,bhde->blhe", rc * _excl_cumprod(wcc), state)
        yc = yc + (rc * uf * kc).sum(-1, keepdim=True) * vc
        for a in range(0, c1 - c0, sub):
            end = min(a + sub, c1 - c0)
            for j in range(a, end - 1):          # own keys: running products
                q = kc[:, j:j + 1] * _excl_cumprod(wcc[:, j + 1:end])
                att = (rc[:, j + 1:end] * q).sum(-1)           # (B, L, H)
                yc[:, j + 1:end] += att[..., None] * vc[:, j:j + 1]
            if a:                                # earlier keys, factored at a
                rq = rc[:, a:end] * _excl_cumprod(wcc[:, a:end])
                kq = kc[:, :a] * _excl_rev_cumprod(wcc[:, :a])
                att = torch.einsum("bthd,bshd->bhts", rq, kq)
                yc[:, a:end] += torch.einsum("bhts,bshe->bthe", att,
                                             vc[:, :a])
        y[:, c0:c1] = yc
        total = torch.prod(wcc, dim=1)                          # (B, H, Dh)
        state = total[..., None] * state + torch.einsum(
            "bshd,bshe->bhde", kc * _excl_rev_cumprod(wcc), vc)
    y = y.to(r.dtype)
    if s0 is None:
        return y, state
    return y, s0.copy_(state)


def design(s: int, dh: int, dtype) -> str:
    """The CUDA design a call of S tokens, head size Dh and ``dtype``
    runs: ``"chunked"`` (bf16, S >= CHUNK, Dh 16, 32 or 64) or
    ``"stepwise"``."""
    if dtype == torch.bfloat16 and s >= CHUNK and dh in _CHUNKED_HEAD_DIMS:
        return "chunked"
    return "stepwise"


def _bind():
    lib = _build.library("wkv6")
    fn = lib.wkv6_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.wkv6_chunked_launch.argtypes = ([ctypes.c_void_p] * 8
                                            + [ctypes.c_int] * 4
                                            + [ctypes.c_void_p])
        lib.wkv6_chunked_launch.restype = ctypes.c_int
        lib.wkv6_chunked_smem_bytes.argtypes = [ctypes.c_int]
        lib.wkv6_chunked_smem_bytes.restype = ctypes.c_size_t
    return lib


def wkv6(r, k, v, w, u, s0=None):
    """Launch the CUDA kernel on PyTorch's current stream.

    r, k, v, w: (B, S, H, Dh) with S >= 1 and Dh in 4, 8, 16, 32 or 64;
    u: (H, Dh); all of one dtype, float32 or bfloat16; the chunked
    design (:func:`design`) also needs r, k, v, w 16-byte aligned.  s0: None or
    (B, H, Dh, Dh) float32, advanced in place.  All contiguous on one
    CUDA device; anything else raises.  Returns (y (B, S, H, Dh) in r's
    dtype, s_last (B, H, Dh, Dh) float32, which is ``s0`` when given).
    Raises under autograd: the kernel has no backward yet.
    """
    _build.refuse_grad("wkv6", r, k, v, w, u, s0)
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
    chunked = design(s, dh, r.dtype) == "chunked"
    if chunked and any(t.data_ptr() % 16 for t in (r, k, v, w)):
        raise ValueError("wkv6's chunked kernel takes 16-byte aligned r, "
                         "k, v, w")
    lib = _bind()
    y = torch.empty_like(r)
    s_last = (s0 if s0 is not None
              else torch.empty((b, h, dh, dh), dtype=torch.float32,
                               device=r.device))
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            y.data_ptr(), s_last.data_ptr(), b, s, h, dh,
            _build.stream_handle(r.device))
    if chunked:
        err = lib.wkv6_chunked_launch(*ptrs)
    else:
        err = lib.wkv6_launch(_DTYPES[r.dtype], *ptrs)
    if err:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    if chunked:
        wkv6.launches_chunked += 1
    else:
        wkv6.launches_stepwise += 1
    wkv6.launches += 1
    return y, s_last


wkv6.launches = 0            # every launch: the sum of the two below
wkv6.launches_chunked = 0
wkv6.launches_stepwise = 0
