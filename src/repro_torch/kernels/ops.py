"""Dispatch for the kernels (port of ``repro/kernels/ops.py``).

Dispatch goes by device and by nothing else: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to the kernel's plain PyTorch version.
There is no environment gate and no fallback — a kernel that cannot
launch raises.  The TPU wrapper padded Sq/Sk up to block multiples; the
CUDA flash kernel masks its ragged edge itself, so no padding copy is
made here, and the WKV6 and selective-scan kernels take any S unpadded
(the TPU wrapper's w = 1 and dt = 0 padding is not needed).

Only flash attention has a backward.  The paged, WKV6 and selective-scan
kernels raise on the card when autograd would record through them (their
plain versions on the CPU stay differentiable).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import wkv6 as _wkv6


def flash_attention(q, k, v, *, causal: bool = True, window: int = -1):
    """q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh) -> (B, Sq, H, Dh).

    Under autograd (grad mode on, an input requiring grad) the call goes
    through :class:`~repro_torch.kernels.flash_attention.FlashAttention`:
    on the card the forward kernel with its row log-sum-exp and the
    backward kernel, on the CPU the plain forward and plain backward.
    Otherwise the forward alone, which skips the log-sum-exp.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _flash.FlashAttention.apply(q, k, v, causal, window)
    if q.device.type == "cuda":
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    return _flash.flash_attention_plain(q, k, v, causal=causal, window=window)


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    window: int = -1, k_scale=None, v_scale=None):
    """Decode (q (B, H, Dh)) or verify (q (B, Q, H, Dh)) attention over a
    paged pool; ``k_scale`` / ``v_scale`` (P, KV) f32 come with int8
    pools.  See :func:`repro_torch.kernels.paged_attention.paged_attention`.
    """
    if q.device.type == "cuda":
        return _paged.paged_attention(q, k_pages, v_pages, block_tables,
                                      lengths, window=window,
                                      k_scale=k_scale, v_scale=v_scale)
    return _paged.paged_attention_plain(q, k_pages, v_pages, block_tables,
                                        lengths, window=window,
                                        k_scale=k_scale, v_scale=v_scale)


def wkv6(r, k, v, w, u, s0=None):
    """RWKV6 WKV, r/k/v/w (B, S, H, Dh), u (H, Dh); with ``s0`` the state
    advances in place.  See :func:`repro_torch.kernels.wkv6.wkv6`."""
    if r.device.type == "cuda":
        return _wkv6.wkv6(r, k, v, w, u, s0)
    return _wkv6.wkv6_plain(r, k, v, w, u, s0)


def mamba_scan(u, dt, A, B, C, D, h0=None):
    """Mamba-1 selective scan, u/dt (B, S, Ci), A (Ci, N), B/C (B, S, N),
    D (Ci,); with ``h0`` (B, Ci, N) f32 the state advances in place.  See
    :func:`repro_torch.kernels.mamba_scan.mamba_scan`."""
    if u.device.type == "cuda":
        return _mamba.mamba_scan(u, dt, A, B, C, D, h0)
    return _mamba.mamba_scan_plain(u, dt, A, B, C, D, h0)
