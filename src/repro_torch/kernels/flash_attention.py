"""Flash attention: the forward CUDA kernel (``csrc/flash_attention.cu``),
the backward CUDA kernel (``csrc/flash_attention_bwd.cu``), their plain
PyTorch versions, the autograd function that joins them, and the
kernels' launch counters.

The forward replaces ``repro/kernels/flash_attention.py::flash_attention``
(the Pallas TPU kernel): blocked online-softmax attention, causal or
not, with a sliding window (<= 0 means global; a key is visible when
``qpos - kpos < window``) and GQA (query head h reads KV head
h // (H // KV)).  Query and key positions are the array indices.

The backward has no TPU kernel to replace: the JAX package trains
through the jnp twin and lets XLA differentiate it.  It computes that
gradient, the FlashAttention-2 recurrence, from the forward's output and
its row log-sum-exp ``lse``: (B, H, Sq) f32, base 2, over the scaled
scores, lse = log2 Σ_j 2^(s_j · scale · log2 e); +inf for a row that
sees no key.  :class:`FlashAttention` is the autograd function:
kernels for CUDA tensors, plain versions for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block can use
_MAX_DH = 256                 # the bf16 kernels' and the f32 backward's


def _mask(sq, sk, causal, window, device):
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int = -1, return_lse: bool = False):
    """The kernel's arithmetic in plain PyTorch (CPU tests, card checks).

    f32 scores masked to -1e30, p rounded to the value dtype before the
    PV product, out = acc / max(l, 1e-30) in q's dtype.  Materializes the
    (Sq, Sk) score matrix per head, which the kernel never does.  With
    ``return_lse``, also the rows' log-sum-exp (B, H, Sq), as the
    kernel writes it.
    """
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    group = h // kv
    qg = q.reshape(b, sq, kv, group, dh).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) / math.sqrt(dh)
    mask = _mask(sq, sk, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype).float(), v.float())
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, (m[..., 0] + torch.log(l)) * LOG2E,
                      float("inf"))
    return out, lse.reshape(b, h, sq)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = -1):
    """The backward kernel's arithmetic in plain PyTorch (CPU path and
    card checks; never on the card's training path).

    The FlashAttention-2 recurrence in f32 from the forward's ``o`` and
    ``lse``: D = rowsum(dO ∘ O), P = 2^(s·scale·log2 e − lse) on the
    visible keys, dV = Pᵀ dO, dP = dO Vᵀ, dS = P ∘ (dP − D), dQ = dS K ·
    scale, dK = dSᵀ Q · scale; dK and dV summed over each KV head's
    query heads.  P and dS are rounded to the inputs' dtype before the
    products that use them, as the bf16 kernel feeds them to the tensor
    cores (the forward's "p in the value dtype"; nothing changes in
    f32).  Returns (dq, dk, dv) in the inputs' dtypes.
    """
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(dh)
    qf = q.reshape(b, sq, kv, g, dh).float()
    dof = do.reshape(b, sq, kv, g, dh).float()
    kf, vf = k.float(), v.float()
    mask = _mask(sq, sk, causal, window, q.device)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, kf)
    lse_ = lse.reshape(b, kv, g, sq)[..., None]
    p = torch.where(mask, torch.exp2(s * (scale * LOG2E) - lse_), 0.0)
    delta = (do.float() * o.float()).sum(-1)                  # (b, sq, h)
    delta = delta.reshape(b, sq, kv, g).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bqkgd,btkd->bkgqt", dof, vf)
    ds = (p * (dp - delta)).to(q.dtype).float()
    p = p.to(q.dtype).float()
    dv = torch.einsum("bkgqt,bqkgd->btkd", p, dof)
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds, qf) * scale
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, kf) * scale
    return (dq.reshape(b, sq, h, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bind():
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check(q, k, v, name):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    _, sk, kv, dh_k = k.shape
    if k.shape[0] != b or dh != dh_k or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (batch, Dh, H % KV)")
    if any(t.device != q.device for t in (k, v)) or q.device.type != "cuda":
        raise ValueError(f"{name}'s kernel takes CUDA tensors on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError(f"{name}'s kernel takes contiguous, 16-byte "
                         "aligned tensors")


def flash_attention(q, k, v, *, causal: bool = True, window: int = -1,
                    return_lse: bool = False):
    """Launch the CUDA kernel on PyTorch's current stream.

    q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh); float32 or bfloat16, one
    dtype, contiguous, 16-byte aligned, on one CUDA device (anything
    else raises); H % KV == 0.  bfloat16 runs on the tensor cores and
    takes Dh a multiple of 8 up to 256 (zero-padded inside the kernel to
    64, 128 or 256 columns; past 128 each CTA owns a 128-column half of
    the output); float32 runs on CUDA cores and takes any Dh whose tiles
    fit in shared memory.  window: Python int.  Returns (B, Sq, H, Dh) in q's
    dtype, and with ``return_lse`` also the rows' log-sum-exp (B, H, Sq)
    f32 that the backward needs (otherwise the kernel skips it).
    """
    _check(q, k, v, "flash_attention")
    b, sq, h, dh = q.shape
    _, sk, kv, _ = k.shape
    if q.dtype == torch.bfloat16 and (dh % 8 or dh > _MAX_DH):
        raise ValueError(f"the bf16 kernel takes Dh a multiple of 8 up to "
                         f"{_MAX_DH}, got {dh}")
    lib = _bind()
    smem = lib.flash_attention_smem_bytes(_DTYPES[q.dtype], dh)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"Dh={dh} needs {smem} bytes of shared memory "
                         f"(limit {_SMEM_LIMIT})")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = lib.flash_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), b, sq, sk,
        h, kv, dh, int(causal), int(window), 1.0 / math.sqrt(dh),
        _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def _bind_bwd():
    lib = _build.library("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = -1):
    """Launch the backward kernels on PyTorch's current stream: D =
    rowsum(dO ∘ O), then dK / dV over key tiles, then dQ over query
    tiles (csrc/flash_attention_bwd.cu); deterministic, no atomics.

    q, o, do: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh); lse (B, H, Sq) f32
    from :func:`flash_attention` with ``return_lse``.  float32 or
    bfloat16, contiguous, on one CUDA device; q, k, v and do 16-byte
    aligned.  bfloat16 runs on the tensor cores and takes Dh a multiple
    of 8 up to 256 (zero-padded inside the kernels; past 128 the two
    warpgroups of a CTA each own a 128-column half of the gradients), as
    the forward does; float32 runs on CUDA cores and takes any Dh up to
    256 (past 128 in two column passes).  Returns (dq, dk, dv) in the
    inputs' dtype.
    """
    _check(q, k, v, "flash_attention_bwd")
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q")
    b, sq, h, dh = q.shape
    _, sk, kv, _ = k.shape
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {h}, {sq}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not all(t.is_contiguous() and t.device == q.device
               for t in (o, do, lse)) or do.data_ptr() % 16:
        raise ValueError("o, lse and do must be contiguous on q's device, "
                         "do 16-byte aligned")
    if q.dtype == torch.bfloat16 and (dh % 8 or dh > _MAX_DH):
        raise ValueError(f"the bf16 backward kernel takes Dh a multiple of "
                         f"8 up to {_MAX_DH}, got {dh}")
    if dh > _MAX_DH:
        raise ValueError(f"the backward kernel takes Dh up to {_MAX_DH}, "
                         f"got {dh}")
    lib = _bind_bwd()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = lib.flash_attention_bwd_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), b, sq, sk, h, kv, dh,
        int(causal), int(window), 1.0 / math.sqrt(dh),
        _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel (with ``lse``)
    and the backward kernel for CUDA tensors; the plain forward and
    :func:`flash_attention_bwd_plain` for CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        fwd = flash_attention if q.is_cuda else flash_attention_plain
        out, lse = fwd(q, k, v, causal=causal, window=window,
                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd if do.is_cuda else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, out, lse, do.contiguous(),
                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None
