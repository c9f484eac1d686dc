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
apart, in ``paged_attention.launches_int8``, and launches of either
variant by their query count in ``paged_attention.launches_by_q``.

The kernel splits each row's pages across the SMs (flash-decoding):
:func:`plan_splits` picks the split count from static shapes, each
split writes an f32 partial ``(m, l, acc)`` (:func:`paged_partial_plain`
is its plain version) and a second kernel merges them
(:func:`combine_splits_plain`).
"""
from __future__ import annotations

import ctypes
import functools
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
    squeeze, q, k, v, mask, _ = _row_view(q, k_pages, v_pages,
                                          block_tables, lengths, window,
                                          k_scale, v_scale)
    b, ql, h, dh = q.shape
    kv = k_pages.shape[2]
    group = h // kv
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


def plan_splits(n_pages: int, batch: int, n_kv: int, n_sm: int):
    """(splits, pages_per_split) for a call over tables ``n_pages`` wide.

    Static quantities only (never ``lengths``, which would cost a host
    sync a call): about two blocks per SM over batch × KV heads × splits,
    at least one page a split; split j walks pages
    ``[j · pages_per_split, min((j + 1) · pages_per_split, n_pages))``.
    """
    n_pages = max(1, n_pages)
    want = max(1, -(-2 * n_sm // max(1, batch * n_kv)))
    per = -(-n_pages // min(n_pages, want))
    return -(-n_pages // per), per


def _row_view(q, k_pages, v_pages, block_tables, lengths, window, k_scale,
              v_scale):
    """Shared set-up of the plain versions: q with its Q axis, each
    row's gathered keys and values (f32 for int8 pools), the visibility
    mask (B, Q, K) and the page liveness (B, n_pages)."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, ql, h, dh = q.shape
    n_pool, page, kv, _ = k_pages.shape
    n_pages = block_tables.shape[1]
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
    # the kernels' page-level test: allocated, not past the length, not
    # wholly outside the oldest query's window
    first = torch.arange(n_pages, device=q.device) * page
    live = (tab >= 0) & (first[None, :] < lengths.long()[:, None])
    if window > 0:
        live &= (qpos[:, :1] - (first[None, :] + page - 1)) < window
    return squeeze, q, k, v, mask, live


def paged_partial_plain(q, k_pages, v_pages, block_tables, lengths, lo, hi,
                        *, window: int = -1, k_scale=None, v_scale=None):
    """One split's partial over pages ``[lo, hi)`` of every row, in f32:
    ``(m, l, acc)`` of shapes (B, KV, Q·G), (B, KV, Q·G), (B, KV, Q·G, Dh)
    with row r = query r // G of head kvh · G + r % G, as the kernel's
    split writes them.  m is the max of the scores (masked -1e30) over
    the split's live pages, -inf with none; p = exp(s - m) is 0 where
    masked and rounded to the value dtype (float pools); l = Σ p and
    acc = p · v, unnormalized."""
    _, q, k, v, mask, live = _row_view(q, k_pages, v_pages, block_tables,
                                       lengths, window, k_scale, v_scale)
    b, ql, h, dh = q.shape
    page, kv = k_pages.shape[1], k_pages.shape[2]
    group = h // kv
    in_split = torch.zeros_like(live)
    in_split[:, lo:hi] = True
    keys = (live & in_split).repeat_interleave(page, dim=1)    # (B, K)
    mask = mask & keys[:, None, :]
    qg = q.reshape(b, ql, kv, group, dh).float()
    s = torch.einsum("bqkgd,btkd->bkqgt", qg, k.float()) / math.sqrt(dh)
    m5 = mask[:, None, :, None, :]                             # (B,1,Q,1,K)
    s = torch.where(m5, s, NEG_INF)
    s = torch.where(keys[:, None, None, None, :], s, -math.inf)
    m = s.amax(dim=-1)                                         # (B,KV,Q,G)
    p = torch.where(m5, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    v = v.masked_fill(~mask.any(dim=1)[:, :, None, None], 0)
    acc = torch.einsum("bkqgt,btkd->bkqgd", p.to(v.dtype).float(), v.float())
    rows = ql * group
    return (m.reshape(b, kv, rows), l.reshape(b, kv, rows),
            acc.reshape(b, kv, rows, dh))


def combine_splits_plain(m, l, acc, q_len: int, dtype):
    """The merge kernel's arithmetic: splits stacked on dim 2 of ``m``,
    ``l`` (B, KV, S, Q·G) and ``acc`` (B, KV, S, Q·G, Dh) -> (B, Q, H,
    Dh) in ``dtype``.  Weights exp(m_j - M) with M the max over splits;
    a split with m_j = -inf weighs 0, a row with no live key gives 0."""
    b, kv, _, rows = m.shape
    dh = acc.shape[-1]
    m_max = m.amax(dim=2, keepdim=True)
    w = torch.where(m == -math.inf, 0.0,
                    torch.exp(m - torch.where(m_max == -math.inf, 0.0,
                                              m_max)))
    num = (acc * w[..., None]).sum(dim=2)
    den = (l * w).sum(dim=2)
    out = num / den.clamp_min(1e-30)[..., None]                # (B,KV,R,Dh)
    group = rows // q_len
    out = out.reshape(b, kv, q_len, group, dh).permute(0, 2, 1, 3, 4)
    return out.reshape(b, q_len, kv * group, dh).to(dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launch_plan(q_len, group, dh, page, pool_bytes, n_pages, batch, n_kv,
                 index):
    """(splits, pages_per_split) of a call shape, after checking its
    shared memory against the card's limit (cached: one host lookup a
    call)."""
    smem = _bind().paged_attention_smem_bytes(q_len, group, dh, page,
                                              pool_bytes)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"Q·G={q_len * group} rows × Dh={dh}, page {page} "
                         f"need {smem} bytes of shared memory (limit "
                         f"{_SMEM_LIMIT})")
    return plan_splits(n_pages, batch, n_kv, _sm_count(index))


def _bind():
    lib = _build.library("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn8 = lib.paged_attention_int8_launch
        fn8.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                        + [ctypes.c_int] * 10
                        + [ctypes.c_float, ctypes.c_void_p])
        fn8.restype = ctypes.c_int
        lib.paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 5
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
    Raises under autograd: the kernel has no backward (it serves decode).
    """
    _build.refuse_grad("paged_attention", q, k_pages, v_pages)
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
    row_bytes = dh * k_pages.element_size()
    if (dh % 4 or row_bytes % 8 or k_pages.data_ptr() % 16
            or v_pages.data_ptr() % 16):
        raise ValueError(f"the kernel copies 16- or 8-byte chunks: Dh={dh} "
                         f"must be a multiple of 4, Dh × "
                         f"{k_pages.element_size()} bytes of 8 and the pools "
                         f"16-byte aligned")
    lib = _bind()
    index = (q.device.index if q.device.index is not None
             else torch.cuda.current_device())
    n_pages, rows = block_tables.shape[1], ql * (h // kv)
    splits, per = _launch_plan(ql, h // kv, dh, page, k_pages.element_size(),
                               n_pages, b, kv, index)
    # f32 scratch: (B, KV, splits, Q·G, 2) of (m, l), then
    # (B, KV, splits, Q·G, Dh) of acc
    n_ml = b * kv * splits * rows * 2
    part = torch.empty(n_ml + n_ml // 2 * dh, dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q4)
    tail = (part.data_ptr(), part.data_ptr() + 4 * n_ml, out.data_ptr(), b,
            ql, h, kv, dh, page, n_pages, splits, per, int(window),
            1.0 / math.sqrt(dh), _build.stream_handle(q.device))
    if scales:
        err = lib.paged_attention_int8_launch(
            _DTYPES[q.dtype], q4.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), *tail)
    else:
        err = lib.paged_attention_launch(
            _DTYPES[q.dtype], q4.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            *tail)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    if scales:
        paged_attention.launches_int8 += 1
    else:
        paged_attention.launches += 1
    by_q = paged_attention.launches_by_q
    by_q[ql] = by_q.get(ql, 0) + 1
    return out[:, 0] if squeeze else out


paged_attention.launches = 0
paged_attention.launches_int8 = 0
#: launches of either variant by query count Q (1 decode, spec_k + 1 verify)
paged_attention.launches_by_q = {}
