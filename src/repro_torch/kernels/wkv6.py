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

Training goes through :class:`WKV6` (from a zero state): the forward
kernel, then the backward kernels of ``csrc/wkv6_bwd.cu``
(:func:`wkv6_bwd`, counter ``wkv6_bwd.launches``), whose plain version
is :func:`wkv6_bwd_plain`.  They split the sequence into chunks of
``BWD_CHUNK`` tokens: each chunk's local sums, an ordered combine of the
boundary states, then every chunk's gradients from sub-chunk
checkpoints in shared memory; :func:`wkv6_bwd_chunked_plain` is that
arithmetic in plain PyTorch, for the CPU tests.  The TPU kernel has no
backward (JAX differentiates its jnp twin ``nn.wkv6_chunked``), so they
replace none.

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
from repro_torch.kernels import cost as _cost
from repro_torch.kernels import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (4, 8, 16, 32, 64)   # instantiated in csrc/wkv6.cu
_CHUNKED_HEAD_DIMS = (16, 32, 64)  # the chunked kernel's instantiations
CHUNK = 16                         # tokens a chunk of the chunked kernel
BWD_CHUNK, BWD_SUB = 64, 8         # the backward kernel's chunk, sub-chunk


def wkv6_plain(r, k, v, w, u, s0=None):
    """The kernel's arithmetic in plain PyTorch (CPU tests, card checks):
    the stepwise oracle on w clipped to [1e-8, 1] in f32.  Same arguments
    and result as :func:`wkv6`, ``s0`` advanced in place included.  On
    ``meta`` (the dry run's counts) the result's shapes alone: the walk
    would be S steps of ops that compute nothing."""
    if r.is_meta:
        b, _, h, dh = r.shape
        return torch.empty_like(r), (s0 if s0 is not None else torch.empty(
            (b, h, dh, dh), dtype=torch.float32, device="meta"))
    y, s_last = ref.wkv6_ref(r, k, v, w.float().clamp(1e-8, 1.0), u, s0)
    if s0 is None:
        return y, s_last
    return y, s0.copy_(s_last)


def wkv6_bwd_plain(r, k, v, w, u, dy):
    """The backward of :func:`wkv6` from a zero state, in plain PyTorch
    (CPU training, card checks): the reverse recurrence written out in
    f32, not autograd of the forward.  With S_t = diag(w_t) S_{t-1} +
    k_t v_tᵀ, y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ) and G_t = dL/dS_t
    (G_S = 0: the last state carries no gradient)::

        G_{t-1} = diag(w_t) G_t + r_t dy_tᵀ
        dr_t = (S_{t-1} + diag(u) k_t v_tᵀ) dy_t
        dk_t = G_t v_t + u ⊙ r_t (v_t · dy_t)
        dv_t = G_tᵀ k_t + (Σ r_t ⊙ u ⊙ k_t) dy_t
        dw_t = rowsum(G_t ⊙ S_{t-1})
        du = Σ_{b,t} r_t ⊙ k_t (v_t · dy_t)

    The recurrence runs on w clipped to [1e-8, 1], as the forward does,
    and dw is its derivative there: the clip passes the gradient through
    (at w = 0 it is the derivative at w = 1e-8, finite).  dw is formed
    from the states themselves, never as d(log w) / w, which is 0 / 0
    where w underflows.  Returns (dr, dk, dv, dw, du) in the inputs'
    dtypes (on ``meta``, their shapes alone, as :func:`wkv6_plain`)."""
    if r.is_meta:
        return tuple(torch.empty_like(t) for t in (r, k, v, w, u))
    b, s, h, dh = r.shape
    rf, kf, vf, dyf = (t.float() for t in (r, k, v, dy))
    wf = w.float().clamp(1e-8, 1.0)
    uf = u.float()
    state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    before = []                                  # S_{t-1} for every t
    for t in range(s):
        before.append(state)
        state = (wf[:, t, :, :, None] * state
                 + kf[:, t, :, :, None] * vf[:, t, :, None, :])
    grads = [torch.empty((b, s, h, dh), dtype=torch.float32, device=r.device)
             for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros((h, dh), dtype=torch.float32, device=r.device)
    g = torch.zeros_like(state)                  # G_t
    for t in reversed(range(s)):
        rt, kt, vt, dyt = rf[:, t], kf[:, t], vf[:, t], dyf[:, t]
        vdy = (vt * dyt).sum(-1, keepdim=True)                 # (B, H, 1)
        dr[:, t] = (torch.einsum("bhde,bhe->bhd", before[t], dyt)
                    + uf * kt * vdy)
        dk[:, t] = torch.einsum("bhde,bhe->bhd", g, vt) + uf * rt * vdy
        dv[:, t] = (torch.einsum("bhde,bhd->bhe", g, kt)
                    + (rt * uf * kt).sum(-1, keepdim=True) * dyt)
        dw[:, t] = (g * before[t]).sum(-1)
        du += (rt * kt * vdy).sum(0)
        g = wf[:, t, :, :, None] * g + rt[..., None] * dyt[:, :, None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype))


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


def wkv6_bwd_chunked_plain(r, k, v, w, u, dy, *, chunk: int = BWD_CHUNK,
                           sub: int = BWD_SUB):
    """The backward kernel's passes in plain f32 PyTorch (CPU tests;
    nothing on the main path calls it).  Same arguments and result as
    :func:`wkv6_bwd_plain`.

    Chunks of ``chunk`` tokens c0 .. c1 (the last one ragged); with
    P(a, b) = Π_{τ=a..b} w_τ (1 when a > b):

    - A, every chunk on its own: P_c = P(c0, c1), ΔS_c = Σ_s (k_s ⊙
      P(s+1, c1)) v_sᵀ and ΔG_c = Σ_t (r_t ⊙ P(c0, t-1)) dy_tᵀ;
    - B, in chunk order: S_in from S_c = diag(P_c) S_{c-1} + ΔS_c, and
      in reverse G_out from G_{c-1} = diag(P_c) G_c + ΔG_c;
    - C, every chunk on its own: S walked forward from S_in, kept at the
      start of every ``sub``-token sub-chunk; the sub-chunks in reverse,
      their states recomputed from the checkpoint (dr on the way), then
      G walked back from G_out (dk, dv, dw); du summed per chunk, then
      over chunks and rows.

    The defaults are the CUDA kernel's (``BWD_CHUNK``, ``BWD_SUB``).
    Every decay factor is a product of clipped w over an interval:
    nothing divides, so w = 0 and strong decay stay finite.
    """
    b, s, h, dh = r.shape
    rf, kf, vf, dyf = (t.float() for t in (r, k, v, dy))
    wc = w.float().clamp(1e-8, 1.0)
    uf = u.float()
    starts = list(range(0, s, chunk))
    spans = [(c0, min(c0 + chunk, s)) for c0 in starts]
    # A: the chunks' decays and local sums
    pc, dS, dG = [], [], []
    for c0, c1 in spans:
        wcc = wc[:, c0:c1]
        pc.append(torch.prod(wcc, dim=1)[..., None])          # (B, H, Dh, 1)
        dS.append(torch.einsum("bshd,bshe->bhde",
                               kf[:, c0:c1] * _excl_rev_cumprod(wcc),
                               vf[:, c0:c1]))
        dG.append(torch.einsum("bthd,bthe->bhde",
                               rf[:, c0:c1] * _excl_cumprod(wcc),
                               dyf[:, c0:c1]))
    # B: the boundary states, in a fixed order
    zero = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    s_in, g_out = [zero] * len(spans), [zero] * len(spans)
    state = grad = zero
    for c in range(len(spans)):
        s_in[c] = state
        state = pc[c] * state + dS[c]
    for c in reversed(range(len(spans))):
        g_out[c] = grad
        grad = pc[c] * grad + dG[c]
    # C: every chunk's gradients from its S_in and G_out
    dr, dk, dv, dw = (torch.empty((b, s, h, dh), dtype=torch.float32,
                                  device=r.device) for _ in range(4))
    vdy = (vf * dyf).sum(-1, keepdim=True)                    # (B, S, H, 1)
    ruk = (rf * uf * kf).sum(-1, keepdim=True)
    du_parts = []

    def step(st, t):
        return (wc[:, t, :, :, None] * st
                + kf[:, t, :, :, None] * vf[:, t, :, None, :])

    for c, (c0, c1) in enumerate(spans):
        ckpt, st = {}, s_in[c]
        for t in range(c0, c1):
            if (t - c0) % sub == 0:
                ckpt[t] = st
            st = step(st, t)
        g = g_out[c]
        for a0 in reversed(range(c0, c1, sub)):
            a1 = min(a0 + sub, c1)
            st, hist = ckpt[a0], []
            for t in range(a0, a1):                 # S_{t-1}, and dr
                hist.append(st)
                dr[:, t] = (torch.einsum("bhde,bhe->bhd", st, dyf[:, t])
                            + uf * kf[:, t] * vdy[:, t])
                st = step(st, t)
            for t in reversed(range(a0, a1)):       # G_t: dk, dv, dw
                dk[:, t] = (torch.einsum("bhde,bhe->bhd", g, vf[:, t])
                            + uf * rf[:, t] * vdy[:, t])
                dv[:, t] = (torch.einsum("bhde,bhd->bhe", g, kf[:, t])
                            + ruk[:, t] * dyf[:, t])
                dw[:, t] = (g * hist[t - a0]).sum(-1)
                g = (wc[:, t, :, :, None] * g
                     + rf[:, t, :, :, None] * dyf[:, t, :, None, :])
        du_parts.append((rf[:, c0:c1] * kf[:, c0:c1] * vdy[:, c0:c1]).sum(1))
    du = torch.stack(du_parts, 1).sum((0, 1))          # (H, Dh)
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype))


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
    Raises under autograd: training goes through :class:`WKV6`.
    """
    _build.refuse_grad("wkv6", r, k, v, w, u, s0, via="WKV6")
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


def _bind_bwd():
    lib = _build.library("wkv6_bwd")
    fn = lib.wkv6_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 12
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.wkv6_bwd_scratch_floats.argtypes = [ctypes.c_int] * 4
        lib.wkv6_bwd_scratch_floats.restype = ctypes.c_size_t
    return lib


def wkv6_bwd(r, k, v, w, u, dy):
    """Launch the backward kernels (``csrc/wkv6_bwd.cu``) on PyTorch's
    current stream: the gradients of :func:`wkv6` from a zero state, as
    :func:`wkv6_bwd_plain` defines them; deterministic, no atomics.

    r, k, v, w, dy: (B, S, H, Dh) with S >= 1 and Dh in 4, 8, 16, 32 or
    64; u: (H, Dh); all of one dtype, float32 or bfloat16, contiguous on
    one CUDA device (anything else raises).  Returns (dr, dk, dv, dw, du)
    in that dtype; the arithmetic is f32.
    """
    _build.refuse_grad("wkv6_bwd", r, k, v, w, u, dy)
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w, dy)):
        raise ValueError(f"r, k, v, w, dy must share one (B, S, H, Dh) "
                         f"shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w, dy)]}")
    b, s, h, dh = r.shape
    if tuple(u.shape) != (h, dh):
        raise ValueError(f"u {tuple(u.shape)} must be (H, Dh) = {(h, dh)}")
    if s < 1 or dh not in _HEAD_DIMS:
        raise ValueError(f"wkv6's backward kernel takes S >= 1 and Dh in "
                         f"{_HEAD_DIMS}, got S={s}, Dh={dh}")
    tensors = (r, k, v, w, u, dy)
    if r.device.type != "cuda" or any(t.device != r.device for t in tensors):
        raise ValueError("wkv6's backward kernel takes CUDA tensors on one "
                         "device")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in tensors):
        raise TypeError(f"r, k, v, w, u, dy must share float32 or bfloat16, "
                        f"got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("wkv6's backward kernel takes contiguous tensors")
    lib = _bind_bwd()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(u)
    scratch = torch.empty(lib.wkv6_bwd_scratch_floats(b, s, h, dh),
                          dtype=torch.float32, device=r.device)
    err = lib.wkv6_bwd_launch(
        _DTYPES[r.dtype], *(t.data_ptr() for t in (
            r, k, v, w, u, dy, dr, dk, dv, dw, du, scratch)),
        b, s, h, dh, _build.stream_handle(r.device))
    if err:
        raise RuntimeError(f"wkv6_bwd kernel launch failed: CUDA error "
                           f"{err}")
    wkv6_bwd.launches += 1
    return dr, dk, dv, dw, du


wkv6_bwd.launches = 0


class WKV6(torch.autograd.Function):
    """Differentiable WKV6 from a zero state: :func:`wkv6` and
    :func:`wkv6_bwd` for CUDA tensors, :func:`wkv6_plain` and
    :func:`wkv6_bwd_plain` for CPU tensors.  Returns (y, s_last); s_last
    carries no gradient (no path reads it under autograd)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        fwd = wkv6 if r.is_cuda else wkv6_plain
        y, s_last = fwd(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.mark_non_differentiable(s_last)
        return y, s_last

    @staticmethod
    def backward(ctx, dy, _ds_last):
        bwd = wkv6_bwd if dy.is_cuda else wkv6_bwd_plain
        saved = ctx.saved_tensors
        return _cost.counted("wkv6_bwd", lambda: _cost.wkv6_bwd(*saved),
                             lambda: bwd(*saved, dy.contiguous()))
