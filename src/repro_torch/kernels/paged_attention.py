"""Paged attention over a block-paged KV pool: the CUDA kernel
(``csrc/paged_attention.cu``), its plain PyTorch version, and the
kernel's launch counter.

Replaces ``repro/kernels/paged_attention.py::paged_attention`` (the
Pallas TPU kernel).  Keys and values live in a pool ``(P, page, KV, Dh)``
and each row owns an ordered list of page ids (its table row, -1 =
unallocated); the Q queries of a row sit at positions
``lengths - Q .. lengths - 1`` (Q = 1 decode, Q > 1 verify, causal
among themselves).  int8 pools carry (P, KV) f32 scale planes
(``k_scale`` / ``v_scale``), one per page and KV head, as the TPU
kernel's quantized branch does; launches of that variant are counted
apart, in ``paged_attention.launches_int8``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block can use


def paged_attention_plain(q, k_pages, v_pages, block_tables, lengths, *,
                          window: int = -1, k_scale=None, v_scale=None):
    """The kernel's arithmetic in plain PyTorch (CPU tests, card checks).

    Gathers each row's table into a dense slab, scores in f32 with
    masked scores -1e30, rounds p to the value dtype before the PV
    product, and zeroes the values of keys no query sees (a dead page may
    hold NaN).  int8 pools are dequantized in f32 with their pages'
    scales as they are gathered, so the value dtype, and p, is f32.
    Same arguments and result as :func:`paged_attention`.
    """
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, ql, h, dh = q.shape
    n_pool, page, kv, _ = k_pages.shape
    n_pages = block_tables.shape[1]
    group = h // kv
    tab = block_tables.long()
    safe = tab.clamp(0, n_pool - 1)
    k = k_pages[safe]                                # (B, n, page, KV, Dh)
    v = v_pages[safe]
    if k_scale is not None:
        k = k.float() * k_scale[safe][:, :, None, :, None]
        v = v.float() * v_scale[safe][:, :, None, :, None]
    k = k.reshape(b, n_pages * page, kv, dh)
    v = v.reshape(b, n_pages * page, kv, dh)
    kpos = torch.arange(n_pages * page, device=q.device)
    qpos = (lengths.long()[:, None] - ql
            + torch.arange(ql, device=q.device)[None, :])      # (B, Q)
    mask = kpos[None, None, :] <= qpos[:, :, None]             # (B, Q, K)
    mask &= (tab >= 0).repeat_interleave(page, dim=1)[:, None, :]
    if window > 0:
        mask &= (qpos[:, :, None] - kpos[None, None, :]) < window
    qg = q.reshape(b, ql, kv, group, dh).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) / math.sqrt(dh)
    m5 = mask[:, None, None]                                   # (B,1,1,Q,K)
    s = torch.where(m5, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(m5, p, 0.0)
    l = p.sum(dim=-1)
    v = v.masked_fill(~mask.any(dim=1)[:, :, None, None], 0)
    acc = torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype).float(), v.float())
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, ql, h, dh).to(q.dtype)
    return out[:, 0] if squeeze else out


def _bind():
    lib = _build.library("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn8 = lib.paged_attention_int8_launch
        fn8.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                        + [ctypes.c_int] * 8
                        + [ctypes.c_float, ctypes.c_void_p])
        fn8.restype = ctypes.c_int
        lib.paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check_scales(k_pages, k_scale, v_scale, device):
    """int8 pools need both (P, KV) f32 scale planes; float pools none."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k_scale is None:
        if k_pages.dtype == torch.int8:
            raise TypeError("int8 pools need k_scale and v_scale")
        return ()
    if k_pages.dtype != torch.int8:
        raise TypeError(f"k_scale / v_scale come with int8 pools, got "
                        f"{k_pages.dtype} pools")
    want = (k_pages.shape[0], k_pages.shape[2])
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"{name} must be (P, KV) = {want} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")
    return (k_scale, v_scale)


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    window: int = -1, k_scale=None, v_scale=None):
    """Launch the CUDA kernel on PyTorch's current stream.

    q: (B, H, Dh) or (B, Q, H, Dh), float32 or bfloat16, contiguous;
    k_pages, v_pages: (P, page, KV, Dh) of q's dtype, contiguous, or
    int8 with ``k_scale`` / ``v_scale`` (P, KV) float32 (the int8
    variant, counted in ``paged_attention.launches_int8``);
    block_tables: (B, n_pages) int32; lengths: (B,) int32, each at least
    Q; window: Python int (<= 0 means global).  Returns the query shape
    in q's dtype.  All tensors on one CUDA device; anything else raises.
    """
    squeeze = q.dim() == 3
    q4 = q[:, None] if squeeze else q
    if q4.dim() != 4 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k_pages "
                         f"{tuple(k_pages.shape)} v_pages {tuple(v_pages.shape)}")
    b, ql, h, dh = q4.shape
    n_pool, page, kv, dh_k = k_pages.shape
    if dh != dh_k or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not match pool "
                         f"{tuple(k_pages.shape)} (Dh, H % KV)")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError(f"tables {tuple(block_tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {b}")
    tensors = (q4, k_pages, v_pages, block_tables, lengths)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("paged_attention's kernel takes CUDA tensors on "
                         "one device")
    scales = _check_scales(k_pages, k_scale, v_scale, q.device)
    pool_dtype = torch.int8 if scales else q.dtype
    if q.dtype not in _DTYPES or k_pages.dtype != pool_dtype \
            or v_pages.dtype != pool_dtype:
        raise TypeError(f"q must be float32 or bfloat16 and the pools of "
                        f"its dtype (or int8 with scales), got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention's kernel takes contiguous tensors")
    lib = _bind()
    smem = lib.paged_attention_smem_bytes(ql, h // kv, dh, page)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"Q·G={ql * h // kv} rows × Dh={dh} need {smem} "
                         f"bytes of shared memory (limit {_SMEM_LIMIT})")
    out = torch.empty_like(q4)
    shape = (b, ql, h, kv, dh, page, block_tables.shape[1], int(window),
             1.0 / math.sqrt(dh), _build.stream_handle(q.device))
    if scales:
        err = lib.paged_attention_int8_launch(
            _DTYPES[q.dtype], q4.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            *shape)
    else:
        err = lib.paged_attention_launch(
            _DTYPES[q.dtype], q4.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), *shape)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    if scales:
        paged_attention.launches_int8 += 1
    else:
        paged_attention.launches += 1
    return out[:, 0] if squeeze else out


paged_attention.launches = 0
paged_attention.launches_int8 = 0
