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

Training goes through :class:`MambaScan` (from a zero state): the
forward kernel, then the backward kernels of ``csrc/mamba_scan_bwd.cu``
(:func:`mamba_scan_bwd`, counter ``mamba_scan_bwd.launches``), whose
plain version is :func:`mamba_scan_bwd_plain`.  They split the sequence
into segments of ``BWD_SEG`` tokens: each segment's local sums, an
ordered combine of the boundary states and gradient carries, then every
segment's gradients from sub-chunk checkpoints in shared memory;
:func:`mamba_scan_bwd_segmented_plain` is that arithmetic in plain
PyTorch, for the CPU tests.  The TPU kernel has no backward (JAX
differentiates its jnp twin ``nn.selective_scan``), so they replace
none.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cost as _cost
from repro_torch.kernels import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_D_STATES = (4, 8, 16)   # instantiated in csrc/mamba_scan.cu
BWD_SEG, BWD_SUB = 128, 8   # the backward kernel's segment, sub-chunk


def mamba_scan_plain(u, dt, A, B, C, D, h0=None):
    """The kernel's arithmetic in plain PyTorch (CPU tests, card checks):
    the stepwise oracle.  Same arguments and result as
    :func:`mamba_scan`, ``h0`` advanced in place included.  On ``meta``
    (the dry run's counts) the result's shapes alone: the walk would be S
    steps of ops that compute nothing."""
    if u.is_meta:
        b, _, ci = u.shape
        return torch.empty_like(u), (h0 if h0 is not None else torch.empty(
            (b, ci, A.shape[-1]), dtype=torch.float32, device="meta"))
    y, h_last = ref.mamba_scan_ref(u, dt, A, B, C, D, h0)
    if h0 is None:
        return y, h_last
    return y, h0.copy_(h_last)


def mamba_scan_bwd_plain(u, dt, A, B, C, D, dy):
    """The backward of :func:`mamba_scan` from a zero state, in plain
    PyTorch (CPU training, card checks): the reverse recurrence written
    out in f32, not autograd of the forward.  With a_t = exp(dt_t A),
    h_t = a_t ⊙ h_{t-1} + dt_t u_t B_t and dh_t = dL/dh_t (the last state
    carries no gradient)::

        dh_t = C_t dy_t + a_{t+1} ⊙ dh_{t+1}
        du_t = dt_t Σ_n dh_t ⊙ B_t + D dy_t
        ddt_t = Σ_n dh_t ⊙ (A ⊙ a_t ⊙ h_{t-1} + u_t B_t)
        dA = Σ_{b,t} dh_t ⊙ dt_t a_t ⊙ h_{t-1}
        dB_t = Σ_c dh_t dt_t u_t,   dC_t = Σ_c h_t dy_t
        dD = Σ_{b,t} dy_t u_t

    h_{t-1} comes from the forward recurrence, never from dividing h_t
    by a_t.  Returns (du, ddt, dA, dB, dC, dD) in the inputs' dtypes (on
    ``meta``, their shapes alone, as :func:`mamba_scan_plain`)."""
    if u.is_meta:
        return tuple(torch.empty_like(t) for t in (u, dt, A, B, C, D))
    b, s, ci = u.shape
    uf, dtf, bf, cf, dyf = (t.float() for t in (u, dt, B, C, dy))
    af, df = A.float(), D.float()
    h = torch.zeros((b, ci, A.shape[-1]), dtype=torch.float32,
                    device=u.device)
    before = []                                  # h_{t-1} for every t
    for t in range(s):
        before.append(h)
        h = (torch.exp(dtf[:, t, :, None] * af) * h
             + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :])
    du, ddt = (torch.empty((b, s, ci), dtype=torch.float32, device=u.device)
               for _ in range(2))
    dB, dC = (torch.empty((b, s, A.shape[-1]), dtype=torch.float32,
                          device=u.device) for _ in range(2))
    dA = torch.zeros_like(af)
    dh = torch.zeros_like(h)
    for t in reversed(range(s)):
        dtt, ut, dyt = dtf[:, t], uf[:, t], dyf[:, t]
        at = torch.exp(dtt[..., None] * af)                    # (B, Ci, N)
        ah = at * before[t]
        ub = ut[..., None] * bf[:, t, None, :]
        dh = dh + dyt[..., None] * cf[:, t, None, :]
        dC[:, t] = torch.einsum("bcn,bc->bn", ah + dtt[..., None] * ub, dyt)
        dB[:, t] = torch.einsum("bcn,bc->bn", dh, dtt * ut)
        du[:, t] = dtt * (dh * bf[:, t, None, :]).sum(-1) + df * dyt
        ddt[:, t] = (dh * (af * ah + ub)).sum(-1)
        dA += (dh * dtt[..., None] * ah).sum(0)
        dh = at * dh
    dD = (dyf * uf).sum((0, 1))
    return (du.to(u.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(B.dtype), dC.to(C.dtype), dD.to(D.dtype))


def mamba_scan_bwd_segmented_plain(u, dt, A, B, C, D, dy, *,
                                   seg: int = BWD_SEG, sub: int = BWD_SUB):
    """The backward kernel's passes in plain f32 PyTorch (CPU tests;
    nothing on the main path calls it).  Same arguments and result as
    :func:`mamba_scan_bwd_plain`.

    Segments of ``seg`` tokens t0 .. t1 (the last one ragged); with a_t =
    exp(dt_t A) and P_s = Π_{t in s} a_t:

    - A, every segment on its own: P_s, the local end state hloc_s (the
      walk from h = 0) and the local carry gloc_s = Σ_{t in s}
      (Π_{τ=t0..t} a_τ) C_t dy_t;
    - B, in segment order: h_in from h_s = P_s h_{s-1} + hloc_s, and in
      reverse the carry g_s into each segment, g_{s-1} = gloc_s + P_s g_s;
    - C, every segment on its own: h walked forward from h_in, kept at
      the start of every ``sub``-token sub-chunk; the sub-chunks in
      reverse, a_t and h_{t-1} recomputed from the checkpoint, then dh
      walked back from the carry (du, ddt, dB, dC, and dA and dD per
      (row, segment), summed over rows and segments).

    The defaults are the CUDA kernel's (``BWD_SEG``, ``BWD_SUB``).
    """
    b, s, ci = u.shape
    n = A.shape[-1]
    uf, dtf, bf, cf, dyf = (t.float() for t in (u, dt, B, C, dy))
    af, df = A.float(), D.float()
    spans = [(s0, min(s0 + seg, s)) for s0 in range(0, s, seg)]

    def decay(t):
        return torch.exp(dtf[:, t, :, None] * af)            # (B, Ci, N)

    def drive(t):
        return (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]

    # A: the segments' decays and local sums
    pseg, hloc, gloc = [], [], []
    for s0, s1 in spans:
        h = torch.zeros((b, ci, n), dtype=torch.float32, device=u.device)
        p, g = torch.ones_like(h), torch.zeros_like(h)
        for t in range(s0, s1):
            a = decay(t)
            h = a * h + drive(t)
            p = p * a
            g = g + p * cf[:, t, None, :] * dyf[:, t, :, None]
        pseg.append(p)
        hloc.append(h)
        gloc.append(g)
    # B: h_in and the carries, in a fixed order
    zero = torch.zeros((b, ci, n), dtype=torch.float32, device=u.device)
    h_in, carry = [zero] * len(spans), [zero] * len(spans)
    h = g = zero
    for i in range(len(spans)):
        h_in[i] = h
        h = pseg[i] * h + hloc[i]
    for i in reversed(range(len(spans))):
        carry[i] = g
        g = pseg[i] * g + gloc[i]
    # C: every segment's gradients
    du, ddt = (torch.empty((b, s, ci), dtype=torch.float32, device=u.device)
               for _ in range(2))
    dB, dC = (torch.empty((b, s, n), dtype=torch.float32, device=u.device)
              for _ in range(2))
    da_parts, dd_parts = [], []
    for i, (s0, s1) in enumerate(spans):
        ckpt, h = {}, h_in[i]
        for t in range(s0, s1):
            if (t - s0) % sub == 0:
                ckpt[t] = h
            h = decay(t) * h + drive(t)
        dh = carry[i]
        da = torch.zeros_like(h)
        for a0 in reversed(range(s0, s1, sub)):
            a1 = min(a0 + sub, s1)
            h, hist = ckpt[a0], []
            for t in range(a0, a1):                  # a_t, h_{t-1}
                a = decay(t)
                hist.append((a, h))
                h = a * h + drive(t)
            for t in reversed(range(a0, a1)):
                a, hp = hist[t - a0]
                ht = a * hp + drive(t)
                dtt, ut, dyt = dtf[:, t], uf[:, t], dyf[:, t]
                dh = dh + cf[:, t, None, :] * dyt[..., None]
                m = dh * (a * hp)
                sb = (dh * bf[:, t, None, :]).sum(-1)
                du[:, t] = dtt * sb + df * dyt
                ddt[:, t] = (af * m).sum(-1) + ut * sb
                da = da + dtt[..., None] * m
                dB[:, t] = torch.einsum("bcn,bc->bn", dh, dtt * ut)
                dC[:, t] = torch.einsum("bcn,bc->bn", ht, dyt)
                dh = a * dh
        da_parts.append(da)
        dd_parts.append((dyf[:, s0:s1] * uf[:, s0:s1]).sum(1))   # (B, Ci)
    dA = torch.stack(da_parts, 1).sum((0, 1))
    dD = torch.stack(dd_parts, 1).sum((0, 1))
    return (du.to(u.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(B.dtype), dC.to(C.dtype), dD.to(D.dtype))


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
    when given).  Raises under autograd: training goes through
    :class:`MambaScan`.
    """
    _build.refuse_grad("mamba_scan", u, dt, A, B, C, D, h0, via="MambaScan")
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


def _bind_bwd():
    lib = _build.library("mamba_scan_bwd")
    fn = lib.mamba_scan_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 14
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mamba_scan_bwd_scratch_floats.argtypes = [ctypes.c_int] * 4
        lib.mamba_scan_bwd_scratch_floats.restype = ctypes.c_size_t
    return lib


def mamba_scan_bwd(u, dt, A, B, C, D, dy):
    """Launch the backward kernels (``csrc/mamba_scan_bwd.cu``) on
    PyTorch's current stream: the gradients of :func:`mamba_scan` from a
    zero state, as :func:`mamba_scan_bwd_plain` defines them;
    deterministic, no atomics.

    u, dt, dy: (B, S, Ci) and B, C: (B, S, N), all of one dtype, float32
    or bfloat16, with S >= 1 and N in 4, 8 or 16; A: (Ci, N) and D: (Ci,)
    float32.  All contiguous on one CUDA device; anything else raises.
    Returns (du, ddt, dA, dB, dC, dD) in the inputs' dtypes; the
    arithmetic is f32.
    """
    _build.refuse_grad("mamba_scan_bwd", u, dt, A, B, C, D, dy)
    if u.dim() != 3 or dt.shape != u.shape or dy.shape != u.shape:
        raise ValueError(f"u, dt and dy must share one (B, S, Ci) shape, "
                         f"got {[tuple(t.shape) for t in (u, dt, dy)]}")
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
        raise ValueError(f"mamba_scan's backward kernel takes S >= 1 and N "
                         f"in {_D_STATES}, got S={s}, N={n}")
    tensors = (u, dt, A, B, C, D, dy)
    if u.device.type != "cuda" or any(t.device != u.device for t in tensors):
        raise ValueError("mamba_scan's backward kernel takes CUDA tensors on "
                         "one device")
    if u.dtype not in _DTYPES or any(t.dtype != u.dtype
                                     for t in (dt, B, C, dy)):
        raise TypeError(f"u, dt, B, C, dy must share float32 or bfloat16, "
                        f"got {[t.dtype for t in (u, dt, B, C, dy)]}")
    if A.dtype != torch.float32 or D.dtype != torch.float32:
        raise TypeError(f"A and D must be float32, got {A.dtype}, {D.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mamba_scan's backward kernel takes contiguous "
                         "tensors")
    lib = _bind_bwd()
    du, ddt = torch.empty_like(u), torch.empty_like(dt)
    dA, dB, dC, dD = (torch.empty_like(t) for t in (A, B, C, D))
    scratch = torch.empty(lib.mamba_scan_bwd_scratch_floats(b, s, ci, n),
                          dtype=torch.float32, device=u.device)
    err = lib.mamba_scan_bwd_launch(
        _DTYPES[u.dtype], *(t.data_ptr() for t in (
            u, dt, A, B, C, D, dy, du, ddt, dA, dB, dC, dD, scratch)),
        b, s, ci, n, _build.stream_handle(u.device))
    if err:
        raise RuntimeError(f"mamba_scan_bwd kernel launch failed: CUDA "
                           f"error {err}")
    mamba_scan_bwd.launches += 1
    return du, ddt, dA, dB, dC, dD


mamba_scan_bwd.launches = 0


class MambaScan(torch.autograd.Function):
    """Differentiable selective scan from a zero state: :func:`mamba_scan`
    and :func:`mamba_scan_bwd` for CUDA tensors, :func:`mamba_scan_plain`
    and :func:`mamba_scan_bwd_plain` for CPU tensors.  Returns (y,
    h_last); h_last carries no gradient (no path reads it under
    autograd)."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, D):
        fwd = mamba_scan if u.is_cuda else mamba_scan_plain
        y, h_last = fwd(u, dt, A, B, C, D)
        ctx.save_for_backward(u, dt, A, B, C, D)
        ctx.mark_non_differentiable(h_last)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, _dh_last):
        bwd = mamba_scan_bwd if dy.is_cuda else mamba_scan_bwd_plain
        saved = ctx.saved_tensors
        return _cost.counted("mamba_scan_bwd",
                             lambda: _cost.mamba_scan_bwd(*saved),
                             lambda: bwd(*saved, dy.contiguous()))
