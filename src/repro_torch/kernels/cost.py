"""The work of one call of each hand-written kernel, from its arguments.

A :class:`KernelCost` is the FLOPs a call does, the bytes it must move
(each input read once, each output written once) and, for the scans, the
exps it takes at the SFU rate.  Where the work depends on the data (the
paged walk reads only the pages its lengths make live), it is what the
call's data needs; on ``meta`` tensors, which hold no data, every page
of the table.

One source serves two uses: ``chip_smoke.py``'s kernels line (each
kernel's bound against the card's peaks, :meth:`KernelCost.bound`) and
``launch/op_analysis.py``.  There each kernel entry point
(``kernels/ops.py`` and the autograd Functions' backwards) runs as a
*kernel region* (:func:`counted`): the region adds this module's count
to every active counter and stops the ATen counting inside itself, so
the plain version on the CPU and the kernel on the card count the same
work.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class KernelCost:
    flops: float
    bytes: float
    peak: str               # the operations' peak: "bfloat16" or "float32"
    exps: float = 0.0       # exps at the SFU rate

    def bound(self, hw=None) -> Tuple[float, str, str]:
        """(seconds, "bytes" | "operations", unit): the larger of the
        bytes over the HBM rate, the operations over the peak of their
        type and the exps over the SFU rate (``hw`` defaults to
        :data:`~repro_torch.core.profiler.H100_SXM`)."""
        if hw is None:
            from repro_torch.core.profiler import H100_SXM as hw
        terms = [(self.bytes / hw.hbm_bw, "bytes", "bytes"),
                 (self.flops / hw.peak(self.peak), "operations",
                  "fp32" if self.peak == "float32" else "bf16")]
        if self.exps:
            terms.append((self.exps / hw.exp_rate, "operations", "sfu_exp"))
        return max(terms, key=lambda term: term[0])


def _peak(t: torch.Tensor) -> str:
    return "float32" if t.dtype == torch.float32 else "bfloat16"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def attention_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the flash kernels' mask keeps: query i sees key
    j when i >= j (causal) and i - j < window (window > 0)."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq,
                                                                   np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_fwd(q, k, v, *, causal: bool = True, window: int = -1
              ) -> KernelCost:
    """The forward: QKᵀ and PV over the visible pairs (4·Dh a pair and
    query head); q, k, v read, out written."""
    b, sq, h, dh = q.shape
    pairs = attention_pairs(sq, k.shape[1], causal, window)
    nbytes = 2 * _nbytes(q) + _nbytes(k) + _nbytes(v)
    return KernelCost(4 * b * h * dh * pairs, nbytes, _peak(q))


def flash_bwd(q, k, v, *, causal: bool = True, window: int = -1
              ) -> KernelCost:
    """The FA-2 backward's five products over the visible pairs (S = QKᵀ
    recomputed from lse, dP = dO Vᵀ, dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS K);
    q, o, dO read and dq written, k, v read and dk, dv written, lse
    read."""
    b, sq, h, dh = q.shape
    pairs = attention_pairs(sq, k.shape[1], causal, window)
    nbytes = 4 * _nbytes(q) + 2 * (_nbytes(k) + _nbytes(v)) + b * h * sq * 4
    return KernelCost(10 * b * h * dh * pairs, nbytes, _peak(q))


def _host_lengths(lengths, block_tables, page: int) -> List[int]:
    if lengths.device.type == "meta":
        return [block_tables.shape[1] * page] * block_tables.shape[0]
    return [int(n) for n in lengths.tolist()]


def paged(q, k_pages, v_pages, block_tables, lengths, *, window: int = -1,
          k_scale=None, v_scale=None) -> KernelCost:
    """Decode (q (B, H, Dh)) or verify (q (B, Q, H, Dh)) over the pool:
    q read and out written, each row's live K and V pages (and, for
    int8 pools, their (page, KV head) f32 scales), the tables and the
    lengths read; 4·Dh operations a visible (query, key) pair and query
    head, at the fp32 peak for int8 pools (dequantized on the CUDA
    cores)."""
    del v_pages, v_scale
    ql = q.shape[1] if q.dim() == 4 else 1
    b, h, dh = q.shape[0], q.shape[-2], q.shape[-1]
    page, kv = k_pages.shape[1], k_pages.shape[2]
    pages, pairs = 0, 0
    for ln in _host_lengths(lengths, block_tables, page):
        lo = max(0, ln - ql - window + 1) if window > 0 else 0
        pages += len(range(lo // page, -(-ln // page)))
        for qi in range(ql):
            qpos = ln - ql + qi
            pairs += qpos + 1 - (max(0, qpos - window + 1) if window > 0
                                 else 0)
    kv_bytes = 2 * pages * page * kv * dh * k_pages.element_size()
    if k_scale is not None:
        kv_bytes += 2 * pages * kv * 4
    nbytes = 2 * _nbytes(q) + kv_bytes + block_tables.numel() * 4 + b * 4
    peak = "float32" if k_scale is not None else _peak(q)
    return KernelCost(4 * pairs * h * dh, nbytes, peak)


def wkv6(r, k, v, w, u, s0=None) -> KernelCost:
    """r, k, v, w, u read and y written, the state read and written (or
    only written from a zero start); 4·Dh² operations a token and
    head."""
    b, s, h, dh = r.shape
    state = b * h * dh * dh * 4
    nbytes = (5 * r.numel() + u.numel()) * r.element_size() + state * (
        1 if s0 is None else 2)
    return KernelCost(4 * b * s * h * dh * dh, nbytes, _peak(r))


def mamba_scan(u, dt, A, B, C, D, h0=None) -> KernelCost:
    """u, dt, B, C, A, D read and y written, the state read and written
    (or only written from a zero start); f32 operations, 6 a state entry
    and token (dt·A, the decay FMA, dt·u·B, the C FMA) and 3 a channel
    and token (dt·u and the D FMA), and one exp a state entry and
    token."""
    b, s, ci = u.shape
    n = A.shape[1]
    state = b * ci * n * 4
    nbytes = (3 * u.numel() + 2 * b * s * n) * u.element_size() \
        + (ci * n + ci) * 4 + state * (1 if h0 is None else 2)
    return KernelCost(b * s * ci * (6 * n + 3), nbytes, "float32",
                      exps=b * s * ci * n)


def wkv6_bwd(r, k, v, w, u) -> KernelCost:
    """r, k, v, w, dy and u read, dr, dk, dv, dw and du written; 12 f32
    operations a (token, d, e) of a head (the state's forward update,
    G's update, and one multiply-add each of dr, dk, dv and dw)."""
    dh = r.shape[-1]
    return KernelCost(12 * r.numel() * dh,
                      (9 * r.numel() + 2 * u.numel()) * r.element_size(),
                      "float32")


def mamba_scan_bwd(u, dt, A, B, C, D) -> KernelCost:
    """u, dt, dy, B, C read and du, ddt, dB, dC written, A, D read and
    dA, dD written; 24 f32 operations a (token, channel, entry) (the
    state's recompute 4, dh 2, du 2, ddt 4, dA 3, dB 2, dC 4, the two
    decays 2, the sums 1) and one exp."""
    b, s, ci = u.shape
    n = A.shape[1]
    nbytes = (5 * u.numel() + 4 * b * s * n) * u.element_size() \
        + (2 * ci * n + 2 * ci) * 4
    return KernelCost(24 * b * s * ci * n, nbytes, "float32",
                      exps=b * s * ci * n)


# ---- kernel regions (launch/op_analysis.py) -------------------------------

#: the active op counters: each has ``add_kernel(name, KernelCost)``
COUNTERS: List = []
_depth = 0


def in_region() -> bool:
    """Whether a kernel region is open (its ATen ops are not counted)."""
    return _depth > 0


def counted(name: str, cost_fn: Callable[[], KernelCost],
            run: Callable[[], object]):
    """``run()`` as kernel ``name``'s region: with a counter active, the
    outermost region adds ``cost_fn()`` to every counter, and no ATen op
    inside it is counted.  With none active, ``run()`` alone."""
    global _depth
    if not COUNTERS:
        return run()
    if _depth == 0:
        c = cost_fn()
        for counter in COUNTERS:
            counter.add_kernel(name, c)
    _depth += 1
    try:
        return run()
    finally:
        _depth -= 1


def kernel_region(name: str, cost_fn: Callable[..., KernelCost]):
    """Decorate a kernel entry point whose arguments ``cost_fn`` takes as
    they are: each call runs as :func:`counted`'s region."""
    def wrap(fn):
        def entry(*args, **kwargs):
            if not COUNTERS:
                return fn(*args, **kwargs)
            return counted(name, lambda: cost_fn(*args, **kwargs),
                           lambda: fn(*args, **kwargs))
        entry.__name__, entry.__doc__ = fn.__name__, fn.__doc__
        entry.__qualname__, entry.__module__ = fn.__qualname__, fn.__module__
        entry.__wrapped__ = fn
        return entry
    return wrap

