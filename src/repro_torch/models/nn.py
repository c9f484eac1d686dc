"""Layers of the dense decoder, RWKV6 and jamba (Mamba + MoE) (port of
``repro/models/nn.py``).

Plain functions on tensors, in the JAX package's layouts: activations
(B, S, d), q (B, S, H, Dh), ``wq`` (d, H, Dh), ``wo`` (H·Dh, d).  A
stage cut over a tensor group (``tp``, a ``parallel/dist.py::Group`` or
None) holds this rank's shard of every sharded weight
(``models/init.py::tp_shard``: heads, FFN columns, experts, Mamba
channels) and runs the layer on it; the collectives sit at JAX's
sites: ``tp_exit`` where JAX calls ``maybe_psum``, ``tp_enter`` where a
tensor every rank holds whole enters sharded work (so its cotangent is
summed), ``tp_all_gather`` at the MoE combine.  Without a group each is
the identity.  Per-layer scalars (window, rope theta) are Python numbers
on the host: the JAX package traces them as data because every stage
runs one SPMD program, the port runs each stage's layers itself.

Caches and recurrent states are updated in place.  The JAX code is
functional (``dynamic_update_slice`` + ``where``) and XLA updates in
place under buffer donation; a literal port would copy a whole KV pool
at every layer of every tick, gigabytes at full width.

Quantized weights (``repro_torch.quant``) are dequantized at each
matmul site of attention, the dense FFN and the MoE experts, as in JAX;
int8 paged pools carry per-(page, KV head) f32 scale planes and are
requantized page by page where a key is written.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.parallel.dist import (tensor_index, tp_all_gather, tp_enter,
                                       tp_exit)
from repro_torch.quant import maybe_dequant, quantize_kv_page_batched

# Sequence-length product above which attention over a cache switches to
# the blockwise twin to keep activation memory O(S · block).
_FLASH_THRESHOLD = 4 * 1024 * 1024
_FLASH_BLOCK = 1024
_INVALID_POS = -(10 ** 9)   # sentinel for padded / not-yet-written KV slots
NEG_INF = -1e30


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    """Normalize in f32, cast back, then scale (the JAX order of ops)."""
    h = x.float()
    var = (h * h).mean(dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x, scale, bias, eps: float = 1e-5):
    h = x.float()
    mu = h.mean(dim=-1, keepdim=True)
    var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((h - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def apply_norm(p, x, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def groupnorm_heads(x, scale, bias, eps: float = 1e-5):
    """GroupNorm over the head dim of (B, S, H, Dh) -> (B, S, H·Dh)."""
    h = x.float()
    mu = h.mean(dim=-1, keepdim=True)
    var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
    b, s, nh, dh = x.shape
    out = ((h - mu) * torch.rsqrt(var + eps)).reshape(b, s, nh * dh)
    return out.to(x.dtype) * scale + bias


# --------------------------------------------------------------------------
# Rotary embeddings (neox rotate-half; chatglm "2d" = half-rotary)
# --------------------------------------------------------------------------

def rope_frequencies(d_rot: int, theta: float, device=None):
    exponent = torch.arange(0, d_rot, 2, dtype=torch.float32,
                            device=device) / d_rot
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exponent)


def apply_rope(q, k, positions, theta: float, *, rope_2d: bool = False):
    """q: (B,S,H,Dh), k: (B,S,KV,Dh), positions: (B,S) int; angles in f32."""
    dh = q.shape[-1]
    d_rot = dh // 2 if rope_2d else dh
    inv = rope_frequencies(d_rot, theta, q.device)
    ang = positions.float()[..., None] * inv                # (B,S,d_rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]

    def rot(x):
        rx, keep = x[..., :d_rot], x[..., d_rot:]
        x1, x2 = rx[..., : d_rot // 2], rx[..., d_rot // 2:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                        dim=-1).to(x.dtype)
        return torch.cat([out, keep], dim=-1) if rope_2d else out

    return rot(q), rot(k)


# --------------------------------------------------------------------------
# Attention (GQA + qk-norm + sliding window + dense or paged KV cache)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnStatic:
    """Static attention configuration for one device."""

    n_heads_local: int
    n_kv_local: int
    d_head: int
    kv_sharded: bool
    kv_groups_per_device: int
    qk_norm: bool
    rope_2d: bool
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class PageRow:
    """One microbatch slot's page table, shared by all its paged layers.

    ``ids`` are the page ids on the host (-1 = unallocated): the write
    addresses, read without a device sync.  ``ids_dev`` is the same row
    on the device (the prefill gather); ``lane_tables`` (rows, n_pages)
    int32 addresses the pool flattened as ``(pool_pages·rows, page, KV,
    Dh)`` — entry ``pid·rows + lane``, a view with no copy — and
    ``lengths`` (rows,) int32 is every lane's key count for the paged
    kernel.  Built once per step by :func:`page_row`.
    """

    ids: np.ndarray
    ids_dev: torch.Tensor
    lane_tables: torch.Tensor
    lengths: torch.Tensor


def page_row(ids, rows: int, n_keys: int, device) -> PageRow:
    """The :class:`PageRow` of a slot whose lanes hold ``n_keys`` keys."""
    ids = np.asarray(ids, np.int32)
    lane = np.arange(rows, dtype=np.int64)[:, None]
    lanes = np.where(ids[None, :] >= 0, ids[None, :] * rows + lane, -1)
    return PageRow(
        ids=ids,
        ids_dev=torch.from_numpy(ids.copy()).to(device),
        lane_tables=torch.from_numpy(lanes.astype(np.int32)).to(device),
        lengths=torch.full((rows,), n_keys, dtype=torch.int32, device=device))


def _attn_mask(q_pos, k_pos, window: int, causal: bool):
    """(Q, K) bool mask from positions and a window (<= 0: global)."""
    dq = q_pos[:, None] - k_pos[None, :]
    m = (dq >= 0) if causal else torch.ones_like(dq, dtype=torch.bool)
    if window > 0:
        m = m & (dq < window)
    return m & (k_pos > _INVALID_POS // 2)[None, :]


def _sdpa_naive(q, k, v, mask):
    """q (B,Sq,H,Dh), k/v (B,Sk,H,Dh), mask broadcastable to (B,H,Sq,Sk)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _sdpa_flash(q, k, v, q_pos, k_pos, window: int, causal: bool,
                block: int = _FLASH_BLOCK):
    """Blockwise (flash) attention in plain PyTorch: O(S·block) memory.

    Twin of the JAX package's ``_sdpa_flash_jnp``: loops over KV blocks
    carrying running (max, sum, acc).  q (B,Sq,H,Dh), k/v (B,Sk,H,Dh).
    """
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    m_run = torch.full((b, h, sq), float("-inf"), device=q.device)
    l_run = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, dh), device=q.device)
    for lo in range(0, sk, block):
        kb, vb, kp = k[:, lo:lo + block], v[:, lo:lo + block], k_pos[lo:lo + block]
        s = torch.einsum("bqhd,bkhd->bhqk", q, kb).float() * scale
        s = torch.where(_attn_mask(q_pos, kp, window, causal)[None, None],
                        s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vb.dtype), vb).float()
        m_run = m_new
    out = acc / l_run.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _sdpa_decode_seq_sharded(q, k, v, q_pos, k_pos, window: int, group):
    """Decode attention over a sequence-sharded KV cache (SP decode; JAX
    ``nn.py:203-222``): each rank of ``group`` holds a shard of the keys,
    and the partial softmax statistics combine over the group, a max of
    the scores' row maxima, then one sum of the row sums and the
    unnormalized outputs together.  q (B, 1, H, Dh); k / v (B, L_local,
    KV, Dh), this rank's shard, at key positions ``k_pos`` (L_local,).
    GQA on grouped views: a KV head's G query heads meet its keys in one
    product, and no key is copied (at B 1)."""
    b, _, h, dh = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, n_kv, h // n_kv, dh)
    scale = 1.0 / math.sqrt(dh)
    s = torch.matmul(qg, k.permute(0, 2, 3, 1)).float() * scale
    mask = _attn_mask(q_pos, k_pos, window, causal=True)[0]
    s = torch.where(mask, s, NEG_INF)                   # (B, KV, G, L)
    m = group.all_reduce_(s.amax(dim=-1), op="max")
    p = torch.exp(s - m[..., None])
    acc = torch.matmul(p.to(v.dtype), v.permute(0, 2, 1, 3)).float()
    stats = group.all_reduce_(torch.cat([p.sum(dim=-1)[..., None], acc],
                                        dim=-1))
    out = stats[..., 1:] / stats[..., :1].clamp_min(1e-30)
    return out.reshape(b, 1, h, dh).to(q.dtype)


def _project_kv_weights(p, x, st: AttnStatic, tp):
    """``wk`` / ``wv`` as this rank uses them: its shard, or with KV heads
    replicated over the tensor group (n_kv < tp) its KV group's slice of
    the whole weight, whose cotangent the group sums (JAX
    ``_project_kv``)."""
    wk = maybe_dequant(p["wk"], x.dtype)
    wv = maybe_dequant(p["wv"], x.dtype)
    if not st.kv_sharded and tp is not None:
        grp = (tensor_index(tp) // st.kv_groups_per_device
               if st.kv_groups_per_device else 0)
        lo, n = grp * st.n_kv_local, st.n_kv_local
        wk = tp_enter(wk, tp).narrow(1, lo, n)
        wv = tp_enter(wv, tp).narrow(1, lo, n)
    return wk, wv


def attention(p, x, st: AttnStatic, *, positions, window: int, theta: float,
              kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_pos: int = 0, paged_kv=None, cross_x=None, tp=None,
              seq_group=None):
    """Self-attention of x (B, S, d), or with ``cross_x`` (B, T_src, d)
    cross-attention into it; returns (B, S, d).

    ``cross_x``: K and V are projected from it, neither side is rotated,
    its keys sit at positions 0 .. T_src − 1 and every query sees every
    key (JAX ``nn.py:241-244, :485``); it takes no cache.  It goes
    through the plain path below, never the flash kernel, as in JAX
    (``:492-493``).

    ``kv_cache``: this slot's dense (k, v) cache views (B, L, KV, Dh),
    written in place; a cache of another dtype than x is read as JAX
    promotes it, and the attention output is cast back to x's dtype
    before ``wo`` (JAX lets a wider output promote the residual).
    ``paged_kv``: ``(k_pool, v_pool, row)`` with the stage's pools
    (pool_pages, B, page, KV, Dh), or ``(k_pool, v_pool, k_scale,
    v_scale, row)`` for int8 pools with their (pool_pages, B, KV) f32
    scale planes, written in place, and the slot's :class:`PageRow`.
    Paged keys are written token by token for decode (s = 1) and for
    s > 1 from ``cache_pos`` > 0 (a speculative verify round); these
    queries read through the paged kernel at Q = s.  A prefill (s > 1
    from ``cache_pos`` 0) writes page-aligned slabs.  ``cache_pos`` is
    the host position of the first query.  Neither: the
    cache-less causal forward, which runs the flash kernel.  The engine
    runs only valid (microbatch, stage) cells — bubbles are skipped — so
    the JAX ``valid`` write gate is the engine's skip, and writes here
    are gated by page liveness only.

    ``seq_group``: sequence-parallel decode (JAX ``:259-280``): the
    ``kv_cache`` views are this rank's shard of a cache sharded along the
    sequence over the group (rank d of the group holds positions [d·L,
    (d + 1)·L) of a shard of L); the new key is written on the shard that
    owns ``cache_pos`` only, and :func:`_sdpa_decode_seq_sharded`
    combines the shards' softmax statistics.  One token a row (s = 1)
    only.

    ``tp``: the stage's tensor group: this rank runs its ``n_heads_local``
    query heads and their KV heads, and the output projection's partial
    sums leave through ``tp_exit`` (JAX ``nn.py:280`` / ``:423`` /
    ``:501`` / ``:517``); the replicated qk-norm scales enter through
    ``tp_enter``, each rank normalizing its own heads with them.
    """
    b, s, _ = x.shape
    d = x.shape[-1]
    hd = st.n_heads_local * st.d_head
    kvd = st.n_kv_local * st.d_head
    x = tp_enter(x, tp)
    wq = maybe_dequant(p["wq"], x.dtype).reshape(d, hd)
    q = (x @ wq).view(b, s, st.n_heads_local, st.d_head)
    kv_src = x if cross_x is None else tp_enter(cross_x, tp)
    sk = kv_src.shape[1]
    wk, wv = _project_kv_weights(p, kv_src, st, tp)
    k = (kv_src @ wk.reshape(d, kvd)).view(b, sk, st.n_kv_local, st.d_head)
    v = (kv_src @ wv.reshape(d, kvd)).view(b, sk, st.n_kv_local, st.d_head)
    if st.qk_norm:
        q = rmsnorm(q, tp_enter(p["q_norm"], tp))
        k = rmsnorm(k, tp_enter(p["k_norm"], tp))
    if cross_x is None:
        q, k = apply_rope(q, k, positions, theta, rope_2d=st.rope_2d)

    def project_out(o):
        return tp_exit(o.reshape(b, s, hd).to(x.dtype)
                       @ maybe_dequant(p["wo"], x.dtype), tp)

    causal = st.causal and cross_x is None
    if cross_x is not None:
        assert kv_cache is None and paged_kv is None
        k_pos = torch.arange(sk, device=x.device)
    elif paged_kv is not None:
        assert kv_cache is None
        *pools, row = paged_kv
        kq = len(pools) == 4          # int8 pools carry scale planes
        k_pool, v_pool = pools[:2]
        ks_pool, vs_pool = pools[2:] if kq else (None, None)
        n_pool, _, ps, n_kv, dh = k_pool.shape
        if s == 1 or cache_pos > 0:
            # decode / verify: key t lands at offset (cache_pos + t) % ps
            # of the slot's page (cache_pos + t) // ps, token by token: a
            # write that starts mid-sequence is a verify round, and starts
            # mid-page, where the slab write below would clobber the
            # page's earlier keys
            for t in range(s):
                posn = cache_pos + t
                pid, off = int(row.ids[posn // ps]), posn % ps
                if pid >= 0 and kq:
                    _write_token_int8(k_pool, ks_pool, pid, off, k[:, t])
                    _write_token_int8(v_pool, vs_pool, pid, off, v[:, t])
                elif pid >= 0:
                    k_pool[pid, :, off] = k[:, t]
                    v_pool[pid, :, off] = v[:, t]
            if st.causal:
                # paged kernel over the (page, lane)-flattened pool: lane
                # l of page pid is flat page pid·b + l, every lane holds
                # cache_pos + s keys (row.lengths) and its s queries sit
                # at cache_pos .. cache_pos + s - 1; the scale planes
                # flatten the same way
                ks = vs = None
                if kq:
                    ks = ks_pool.reshape(n_pool * b, n_kv)
                    vs = vs_pool.reshape(n_pool * b, n_kv)
                out = kernel_ops.paged_attention(
                    q[:, 0] if s == 1 else q,
                    k_pool.reshape(n_pool * b, ps, n_kv, dh),
                    v_pool.reshape(n_pool * b, ps, n_kv, dh),
                    row.lane_tables, row.lengths, window=window,
                    k_scale=ks, v_scale=vs)
                return project_out(out)
        elif kq:
            _write_slab_int8(k_pool, ks_pool, row.ids, cache_pos, k)
            _write_slab_int8(v_pool, vs_pool, row.ids, cache_pos, v)
        else:
            # prefill: write the fresh slab page by page; unallocated
            # pages of ragged slots are skipped
            for ii in range(-(-s // ps)):
                lo = ii * ps
                width = min(ps, s - lo)
                pid = int(row.ids[cache_pos // ps + ii])
                if pid >= 0:
                    k_pool[pid, :, :width] = k[:, lo:lo + width]
                    v_pool[pid, :, :width] = v[:, lo:lo + width]
        # gather the pages that hold the first cache_pos + s keys into a
        # dense slab (int8 pages dequantized in f32, int8 · f32
        # promoting, and cast to q's dtype, as JAX reads them); the keys
        # past them are masked and would contribute exact zeros, as on
        # the dense path, so they are not read
        ids = row.ids_dev[:-(-(cache_pos + s) // ps)]
        L = ids.shape[0] * ps
        safe = ids.long().clamp(0, n_pool - 1)
        k, v = k_pool[safe], v_pool[safe]
        if kq:
            k = (k * ks_pool[safe][:, :, None, :, None]).to(q.dtype)
            v = (v * vs_pool[safe][:, :, None, :, None]).to(q.dtype)
        k = k.transpose(0, 1).reshape(b, L, n_kv, dh)
        v = v.transpose(0, 1).reshape(b, L, n_kv, dh)
        j = torch.arange(L, device=x.device)
        alive = (ids >= 0).repeat_interleave(ps)
        k_pos = torch.where((j < cache_pos + s) & alive, j, _INVALID_POS)
    elif kv_cache is not None and seq_group is not None:
        if s != 1:
            raise ValueError(
                f"a sequence-sharded cache takes decode only (one token a "
                f"row), got {s} tokens")
        ck, cv = kv_cache
        L = ck.shape[1]
        off = seq_group.index * L
        if off <= cache_pos < off + L:
            ck[:, cache_pos - off] = k[:, 0]
            cv[:, cache_pos - off] = v[:, 0]
        j = off + torch.arange(L, device=x.device)
        k_pos = torch.where(j <= cache_pos, j, _INVALID_POS)
        ct = torch.promote_types(q.dtype, ck.dtype)
        return project_out(_sdpa_decode_seq_sharded(
            q.to(ct), ck.to(ct), cv, positions[0], k_pos, window, seq_group))
    elif kv_cache is not None:
        ck, cv = kv_cache
        L = ck.shape[1]
        j = torch.arange(L, device=x.device)
        if s == 1:
            # decode: ring-buffer write (an append for full-length caches)
            ck[:, cache_pos % L] = k[:, 0]
            cv[:, cache_pos % L] = v[:, 0]
            k_pos = cache_pos - torch.remainder(cache_pos - j, L)
            k_pos = torch.where(k_pos >= 0, k_pos, _INVALID_POS)
        else:
            ck[:, cache_pos:cache_pos + s] = k
            cv[:, cache_pos:cache_pos + s] = v
            k_pos = torch.where(j < cache_pos + s, j, _INVALID_POS)
        # a cache re-typed by the kv dtype is read as JAX's einsums
        # promote it: scores in the wider of q's and the cache's dtypes,
        # p cast to the cache's dtype for the PV product
        ct = torch.promote_types(q.dtype, ck.dtype)
        q, k, v = q.to(ct), ck.to(ct), cv
    elif causal:
        # cache-less causal forward: the flash kernel (GQA inside)
        out = kernel_ops.flash_attention(q, k, v, causal=True, window=window)
        return project_out(out)
    else:
        k_pos = positions[0]

    groups = st.n_heads_local // k.shape[2]
    k = k.repeat_interleave(groups, dim=2)
    v = v.repeat_interleave(groups, dim=2)
    q_pos = positions[0]
    if s * k.shape[1] <= _FLASH_THRESHOLD:
        mask = _attn_mask(q_pos, k_pos, window, causal)
        out = _sdpa_naive(q, k, v, mask[None, None])
    else:
        out = _sdpa_flash(q, k, v, q_pos, k_pos, window, causal)
    return project_out(out)


def _write_token_int8(pool, spool, pid: int, off: int, new):
    """int8 decode write of one key per lane, ``new`` (B, KV, Dh), at
    offset ``off`` of page ``pid``: dequantize the whole page, insert
    the key, requantize the page and its scales (the JAX order; one
    scale per page stays valid under any new key's magnitude)."""
    page = pool[pid] * spool[pid][:, None, :, None]     # f32 (promotes)
    page[:, off] = new.float()
    pool[pid], spool[pid] = quantize_kv_page_batched(page)


def _write_slab_int8(pool, spool, ids, cache_pos: int, new):
    """int8 prefill write of the slab ``new`` (B, S, KV, Dh) from the
    page-aligned ``cache_pos``: every page the slab touches is built
    fresh, zero past the slab's end, and quantized (as JAX's per-page
    write, over all pages at once); unallocated pages are skipped."""
    b, s, n_kv, dh = new.shape
    ps = pool.shape[2]
    n = -(-s // ps)
    pids = np.asarray(ids[cache_pos // ps:cache_pos // ps + n], np.int64)
    pages = new.new_zeros((b, n * ps, n_kv, dh), dtype=torch.float32)
    pages[:, :s] = new.float()
    pages = pages.view(b, n, ps, n_kv, dh).transpose(0, 1)
    q, scale = quantize_kv_page_batched(pages.reshape(n * b, ps, n_kv, dh))
    live = np.flatnonzero(pids >= 0)
    dst = torch.from_numpy(pids[live]).to(pool.device)
    src = torch.from_numpy(live).to(pool.device)
    pool[dst] = q.view(n, b, ps, n_kv, dh)[src]
    spool[dst] = scale.view(n, b, n_kv)[src]


# --------------------------------------------------------------------------
# Dense FFN (SwiGLU / GELU)
# --------------------------------------------------------------------------

def mlp(p, x, act: str, tp=None):
    """The FFN on this rank's columns of ``w1`` / ``w3`` and rows of
    ``w2``; the partial sums leave through ``tp_exit`` (JAX ``:531``)."""
    x = tp_enter(x, tp)
    w1 = maybe_dequant(p["w1"], x.dtype)
    if act == "silu":
        h = F.silu(x @ w1) * (x @ maybe_dequant(p["w3"], x.dtype))
    else:
        h = F.gelu(x @ w1, approximate="tanh")
    return tp_exit(h @ maybe_dequant(p["w2"], x.dtype), tp)


# --------------------------------------------------------------------------
# Mixture of Experts (GShard-style capacity dispatch)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEStatic:
    n_experts: int
    n_local: int               # experts on this device
    top_k: int
    capacity: int              # per-expert token slots
    n_shared: int


def moe_dispatch_indices(gate_idx, n_experts: int, capacity: int):
    """Sort-based dispatch of the flat (N·K,) expert ids, JAX's rule:
    a stable argsort by expert, each pair's position among its expert's
    pairs in flat (token·K + choice) order, kept while the position is
    below ``capacity``.  Returns (slot_id, keep) with slot_id =
    expert·capacity + position, clipped to the expert's last slot for a
    dropped pair (which must then write and read nothing).  Every shape
    is fixed by the input's (the per-expert counts a ``scatter_add_``
    into ``zeros(E)``), so the dispatch also runs on ``meta``."""
    nk = gate_idx.shape[0]
    order = torch.argsort(gate_idx, stable=True)
    sorted_e = gate_idx[order]
    counts = torch.zeros(n_experts, dtype=gate_idx.dtype,
                         device=gate_idx.device).scatter_add_(
        0, gate_idx, torch.ones_like(gate_idx))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(nk, device=gate_idx.device) - starts[sorted_e]
    keep_sorted = pos_in_e < capacity
    slot_sorted = sorted_e * capacity + pos_in_e.clamp(max=capacity - 1)
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(0, order, keep_sorted)
    return slot, keep


def moe(p, x, ms: MoEStatic, act: str, tp=None):
    """MoE FFN of x (B, S, d); returns (out (B, S, d), aux_loss).

    Routing and the drop rule are the JAX package's: f32 softmax over
    ``x @ router``, top-k renormalized, capacity dispatch by
    :func:`moe_dispatch_indices` over the flat (token·K + choice) order.
    The expert products run over the whole (E, capacity, d) buffer, as
    JAX does (at decode most rows are empty).  The scatter is not JAX's:
    the JAX buffer write ``.at[slot].set`` also writes a zero row for
    every dropped pair into the slot of its expert's last kept pair, so
    on overflow that kept token loses its expert output (ROADMAP Queue
    3).  Here only kept pairs write and read the buffer: every kept pair
    contributes its gate-weighted output, a dropped pair nothing.  A
    token's K contributions are summed in choice order in x's dtype, as
    JAX's ``.at[token_of].add`` does.

    With ``tp`` (JAX ``:595-614``) the router and the dispatch buffer are
    every rank's; each rank runs its ``n_local`` experts on its slice of
    the buffer and ``tp_all_gather`` combines the outputs in rank (=
    expert) order.  ``tp_enter`` sits on the buffer the slices are cut
    from, so its cotangent, each rank's experts' share, is summed; on
    ``x`` it would also sum the router's cotangent, which every rank
    already holds whole.

    Shared experts (``ms.n_shared``, deepseek) are one MLP of width
    ``n_shared · d_shared`` over every token, ``p["shared"]``, added to
    the routed output (JAX ``:621-622``): :func:`mlp`, with its own
    tensor sums.
    """
    b, s, d = x.shape
    n, k, e = b * s, ms.top_k, ms.n_experts
    xf = x.reshape(n, d)
    logits = (xf @ p["router"]).float()                       # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)               # (N, K)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch-style load-balancing auxiliary loss
    me = probs.mean(dim=0)
    ce = F.one_hot(top_i[:, 0], e).float().mean(dim=0)
    aux = e * (me * ce).sum()

    slot, keep = moe_dispatch_indices(top_i.reshape(-1), e, ms.capacity)
    token_of = torch.arange(n, device=x.device).repeat_interleave(k)
    # a fixed-shape write: a dropped pair lands on one spare row past the
    # buffer, cut off below, so only kept pairs fill the experts' slots
    spare = e * ms.capacity
    buf = x.new_zeros((spare + 1, d))
    buf[torch.where(keep, slot, spare)] = xf[token_of]
    buf = tp_enter(buf[:spare], tp).view(e, ms.capacity, d)
    local = buf.narrow(0, tensor_index(tp) * ms.n_local, ms.n_local)
    w1 = maybe_dequant(p["w1"], x.dtype)
    if act == "silu":
        h = F.silu(torch.bmm(local, w1)) * torch.bmm(
            local, maybe_dequant(p["w3"], x.dtype))
    else:
        h = F.gelu(torch.bmm(local, w1), approximate="tanh")
    y = tp_all_gather(torch.bmm(h, maybe_dequant(p["w2"], x.dtype)), tp, 0)
    y = y.reshape(e * ms.capacity, d)

    w = top_p.reshape(-1).to(x.dtype)[:, None]
    gathered = torch.where(keep[:, None], y[slot] * w, 0).view(n, k, d)
    out = gathered[:, 0]
    for j in range(1, k):
        out = out + gathered[:, j]
    out = out.view(b, s, d)
    if ms.n_shared:
        out = out + mlp(p["shared"], x, act, tp)
    return out, aux


# --------------------------------------------------------------------------
# Mamba (selective state space; jamba's mixer)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MambaStatic:
    """Static Mamba configuration for one device.  The JAX static also
    carries the jnp twin's chunk length; the CUDA kernel is stepwise and
    has none."""

    d_inner_local: int
    d_state: int
    d_conv: int
    dt_rank: int


def _causal_conv1d(x, w):
    """Depthwise causal conv via shifts; x: (B, S, C), w: (C, K).  The
    shifted terms are summed in the JAX order (last tap first)."""
    k = w.shape[-1]
    out = x * w[:, -1]
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[:, : x.shape[1]]
        out = out + shifted * w[:, -1 - i]
    return out


def mamba_block(p, x, ms: MambaStatic, state=None, tp=None):
    """Mamba mixer of x (B, S, d); returns (B, S, d).

    ``state``: this slot's ``(conv_tail (B, d_conv-1, Ci) in x's dtype,
    h (B, Ci, N) f32)`` views, read as the start and advanced in place:
    the tail by ``copy_``, h by the scan kernel.  The conv reads the
    held tail concatenated before the new inputs, so a prompt shorter
    than d_conv - 1 keeps part of the old tail, as in JAX.  Without a
    state the conv is zero-padded and the scan starts from zero.  Every
    call goes through ``ops.mamba_scan`` (the CUDA kernel on the card;
    under autograd its forward and backward kernels), with JAX's casts:
    xc, dt, B and C enter the scan in f32 and y is cast back to x's
    dtype before the ``silu(z)`` gate.

    With ``tp`` the rank holds its ``d_inner_local`` channels: the
    ``x_proj`` partial sums leave through ``tp_exit`` and the summed
    (dt, B, C) enter the rank's channels again (JAX ``:714``), and the
    output projection's sums leave through ``tp_exit`` (``:731``).
    """
    x = tp_enter(x, tp)
    xi = x @ p["in_x"]                                       # (B, S, Ci)
    z = x @ p["in_z"]
    if state is not None:
        conv_tail, h0 = state
        xi_cat = torch.cat([conv_tail, xi], dim=1)
        xc = _causal_conv1d(xi_cat, p["conv_w"])[:, -xi.shape[1]:]
        conv_tail.copy_(xi_cat[:, -(ms.d_conv - 1):])
    else:
        h0 = None
        xc = _causal_conv1d(xi, p["conv_w"])
    xc = F.silu(xc)
    proj = tp_enter(tp_exit(xc @ p["x_proj"], tp), tp)      # (B,S,R+2N)
    dt_in, bm, cm = torch.split(proj, [ms.dt_rank, ms.d_state, ms.d_state],
                                dim=-1)
    # dt_bias is f32 (as in the JAX init): dt is formed in f32
    dt = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    y, _ = kernel_ops.mamba_scan(
        xc.float().contiguous(), dt.float().contiguous(), A,
        bm.float().contiguous(), cm.float().contiguous(), p["D"], h0)
    return tp_exit((y.to(x.dtype) * F.silu(z)) @ p["out_proj"], tp)


# --------------------------------------------------------------------------
# RWKV6 (Finch): time-mix with data-dependent decay + channel-mix
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RWKVStatic:
    """Static time-mix configuration for one device.  The JAX static also
    carries the TPU kernel's chunk length; the CUDA kernel is stepwise
    and has none."""

    n_heads_local: int
    d_head: int


def _token_shift(x, prev=None):
    """x_{t-1} per position; ``prev`` (B, d) carries the last token of the
    previous call (zero without one)."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, : x.shape[1]]
    return torch.cat([prev[:, None], x], dim=1)[:, : x.shape[1]]


def rwkv_time_mix(p, x, rst: RWKVStatic, state=None, tp=None):
    """RWKV6 time-mix of x (B, S, d); returns (B, S, d).

    ``state``: this slot's ``(x_prev (B, d), wkv (B, H, Dh, Dh) f32)``
    views, read as the start and advanced in place (the WKV kernel
    writes its last state over ``wkv``).  Without a state the WKV runs
    from zero, as the TPU kernel does.  Every path goes through
    ``ops.wkv6``: the CUDA kernel on the card (under autograd, training,
    its forward and backward kernels).

    With ``tp`` the rank holds its ``n_heads_local`` heads: the token
    shift and the five lerps stay whole on every rank, each mixed input
    enters the rank's heads through ``tp_enter`` (and the decay LoRA's
    hidden layer before its sharded second matrix), and the output's
    partial sums leave through ``tp_exit`` (JAX ``:847``).
    """
    prev_tok, s0 = state if state is not None else (None, None)
    dx = _token_shift(x, prev_tok) - x
    xxx = x + dx * p["maa_x"]
    low = torch.tanh(xxx @ p["tmix_w1"])                     # (B,S,5·r)
    low = low.reshape(*low.shape[:-1], 5, -1)
    mids = torch.einsum("bsfr,frd->bsfd", low, p["tmix_w2"])  # (B,S,5,d)
    mw, mk, mv, mr, mg = mids.unbind(dim=2)
    xw = x + dx * (p["maa_w"] + mw)
    xk = x + dx * (p["maa_k"] + mk)
    xv = x + dx * (p["maa_v"] + mv)
    xr = x + dx * (p["maa_r"] + mr)
    xg = x + dx * (p["maa_g"] + mg)

    b, s, _ = x.shape
    h, dh = rst.n_heads_local, rst.d_head
    r = (tp_enter(xr, tp) @ p["wr"]).view(b, s, h, dh)
    k = (tp_enter(xk, tp) @ p["wk"]).view(b, s, h, dh)
    v = (tp_enter(xv, tp) @ p["wv"]).view(b, s, h, dh)
    g = F.silu(tp_enter(xg, tp) @ p["wg"])
    # w0 is f32 (as in the JAX init): the decay logit is formed in f32
    dec = p["w0"] + tp_enter(torch.tanh(xw @ p["decay_w1"]),
                             tp) @ p["decay_w2"]
    w = torch.exp(-torch.exp(dec.float())).view(b, s, h, dh).to(r.dtype)
    y, _ = kernel_ops.wkv6(r, k, v, w, p["u"].view(h, dh), s0)
    if prev_tok is not None:
        prev_tok.copy_(x[:, -1])
    y = groupnorm_heads(y, p["gn_scale"], p["gn_bias"])
    return tp_exit((y * g) @ p["wo"], tp)


def rwkv_channel_mix(p, x, state=None, tp=None):
    """RWKV6 channel-mix of x (B, S, d); ``state`` is this slot's x_prev
    (B, d) view, read and advanced in place.  With ``tp`` the key path
    runs on the rank's columns of ``wk`` and rows of ``wv`` and its sums
    leave through ``tp_exit`` (JAX ``:859``); the receptance gate stays
    whole."""
    dx = _token_shift(x, state) - x
    xk = x + dx * p["maa_k"]
    xr = x + dx * p["maa_r"]
    k = torch.square(F.relu(tp_enter(xk, tp) @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr_gate"]) * tp_exit(k @ p["wv"], tp)
    if state is not None:
        state.copy_(x[:, -1])
    return out
