"""Naive PyTorch oracles for the kernels (port of ``repro/kernels/ref.py``).

Deliberately the O(S²) attention formulations and the step-by-step WKV6
and selective-scan recurrences: independent of the CUDA kernels and of the blockwise twins
in models/nn.py, so a bug in shared tiling logic cannot hide.  Softmax
in f32, ``-inf`` masking, outputs in q.dtype.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = -1):
    """q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh) with H % KV == 0."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dh)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones(sq, k.shape[1], dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        window: int = -1, k_scale=None, v_scale=None):
    """Attention over a paged KV pool, decode or verify.

    q: (B, H, Dh) decode, or (B, Q, H, Dh) with the Q queries at
    positions ``lengths - Q .. lengths - 1`` (causal among themselves);
    k_pages, v_pages: (P, page, KV, Dh); block_tables: (B, n_pages)
    page ids (-1 = unallocated); lengths: (B,) valid keys.  Gathers every
    table entry into a dense (B, n_pages·page, KV, Dh) slab, masks the
    invalid keys and runs the naive f32 softmax.  The JAX oracle covers
    Q = 1 only; Q > 1 is the port's addition.

    int8 pools: ``k_scale`` / ``v_scale`` (P, KV) f32 per-page scales
    dequantize the whole pool up front, as the JAX oracle does.
    """
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, ql, h, dh = q.shape
    n_pool, page, kv, _ = k_pages.shape
    n_pages = block_tables.shape[1]
    if k_scale is not None:
        k_pages = k_pages.float() * k_scale[:, None, :, None]
    if v_scale is not None:
        v_pages = v_pages.float() * v_scale[:, None, :, None]
    tab = block_tables.long()
    safe = tab.clamp(0, n_pool - 1)
    k = k_pages[safe].reshape(b, n_pages * page, kv, dh).float()
    v = v_pages[safe].reshape(b, n_pages * page, kv, dh).float()
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(dh)
    kpos = torch.arange(n_pages * page, device=q.device)
    qpos = (lengths.long()[:, None] - ql
            + torch.arange(ql, device=q.device)[None, :])      # (B, Q)
    mask = kpos[None, None, :] <= qpos[:, :, None]             # (B, Q, K)
    mask &= (tab >= 0).repeat_interleave(page, dim=1)[:, None, :]
    if window > 0:
        mask &= (qpos[:, :, None] - kpos[None, None, :]) < window
    s = s.masked_fill(~mask[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    # zero the values of keys no query sees: a dead page may hold
    # garbage (even NaN), and 0 * NaN would poison the weighted sum
    v = v.masked_fill(~mask.any(dim=1)[:, :, None, None], 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)
    return out[:, 0] if squeeze else out


def wkv6_ref(r, k, v, w, u, s0=None):
    """RWKV6 WKV recurrence, step by step (the paper's definition).

    r, k, v, w: (B, S, H, Dh); w is the per-channel decay in (0, 1];
    u: (H, Dh) bonus; s0: optional (B, H, Dh, Dh) start state (zero when
    None), left untouched.  Returns (y (B, S, H, Dh) in r.dtype,
    s_last (B, H, Dh, Dh) f32); arithmetic in f32:

        y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
        S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    """
    b, s, h, dh = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    state = (torch.zeros((b, h, dh, dh), dtype=torch.float32,
                         device=r.device) if s0 is None else s0.float())
    ys = []
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # (B,H,Dh,Dh)
        ys.append(torch.einsum("bhd,bhde->bhe", rf[:, t], state + uf * kv))
        state = wf[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1).to(r.dtype), state


def mamba_scan_ref(u, dt, A, B, C, D, h0=None):
    """Diagonal selective-SSM recurrence (Mamba-1), step by step.

    u, dt: (B, S, Ci); A: (Ci, N); B, C: (B, S, N); D: (Ci,); h0:
    optional (B, Ci, N) start state (zero when None), left untouched.
    Returns (y (B, S, Ci) in u.dtype, h_last (B, Ci, N) f32); arithmetic
    in f32:

        h_t = exp(dt_t ⊙ A) ⊙ h_{t-1} + (dt_t u_t) ⊗ B_t
        y_t = h_t · C_t + D ⊙ u_t
    """
    b, s, ci = u.shape
    uf, dtf, bf, cf = (t.float() for t in (u, dt, B, C))
    af, df = A.float(), D.float()
    h = (torch.zeros((b, ci, A.shape[-1]), dtype=torch.float32,
                     device=u.device) if h0 is None else h0.float())
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t, :, None] * af)                # (B,Ci,N)
        h = da * h + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bcn,bn->bc", h, cf[:, t]) + df * uf[:, t])
    return torch.stack(ys, dim=1).to(u.dtype), h
