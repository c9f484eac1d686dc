"""Flash attention forward: the CUDA kernel (``csrc/flash_attention.cu``),
its plain PyTorch version, and the kernel's launch counter.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the
Pallas TPU kernel): blocked online-softmax attention, causal or not,
with a sliding window (<= 0 means global; a key is visible when
``qpos - kpos < window``) and GQA (query head h reads KV head
h // (H // KV)).  Query and key positions are the array indices.  The
backward comes with the training slice.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block can use


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int = -1):
    """The kernel's arithmetic in plain PyTorch (CPU tests, card checks).

    f32 scores masked to -1e30, p rounded to the value dtype before the
    PV product, out = acc / max(l, 1e-30) in q's dtype.  Materializes the
    (Sq, Sk) score matrix per head, which the kernel never does.
    """
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    group = h // kv
    qg = q.reshape(b, sq, kv, group, dh).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) / math.sqrt(dh)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype).float(), v.float())
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def _bind():
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
    return lib


def flash_attention(q, k, v, *, causal: bool = True, window: int = -1):
    """Launch the CUDA kernel on PyTorch's current stream.

    q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh); float32 or bfloat16, one
    dtype, contiguous, 16-byte aligned, on one CUDA device (anything
    else raises); H % KV == 0.  bfloat16 runs on the tensor cores and
    takes Dh a multiple of 8 up to 128 (zero-padded inside the kernel);
    float32 runs on CUDA cores and takes any Dh whose tiles fit in
    shared memory.  window: Python int.  Returns (B, Sq, H, Dh) in q's
    dtype.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    _, sk, kv, dh_k = k.shape
    if k.shape[0] != b or dh != dh_k or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (batch, Dh, H % KV)")
    if any(t.device != q.device for t in (k, v)) or q.device.type != "cuda":
        raise ValueError("flash_attention's kernel takes CUDA tensors on "
                         "one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention's kernel takes contiguous, "
                         "16-byte aligned tensors")
    if q.dtype == torch.bfloat16 and (dh % 8 or dh > 128):
        raise ValueError(f"the bf16 kernel takes Dh a multiple of 8 up to "
                         f"128, got {dh}")
    lib = _bind()
    smem = lib.flash_attention_smem_bytes(_DTYPES[q.dtype], dh)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"Dh={dh} needs {smem} bytes of shared memory "
                         f"(limit {_SMEM_LIMIT})")
    out = torch.empty_like(q)
    err = lib.flash_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, sq, sk, h, kv, dh, int(causal), int(window),
        1.0 / math.sqrt(dh), _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
