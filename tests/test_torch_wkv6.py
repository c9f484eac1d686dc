"""The port's WKV6 against the JAX package, on the CPU.

The port's plain version (what ``ops.wkv6`` runs for CPU tensors) is held
against the JAX Pallas kernel in interpret mode, the JAX chunked twin
``nn.wkv6_chunked`` and the stepwise oracle ``ref.wkv6_ref``, on the same
numpy inputs: zero start, a carried state, a one-token decode step, and
strong decays where the chunked form overflows.  The CUDA kernel is held
against the plain version on a card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import nn as jnn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wkv6 as twkv
from test_kernels import WKV_CASES

# (atol, rtol) per dtype: fp32 as tests/test_torch_kernels.py, bf16 an ulp of y
TOL = {torch.float32: (2e-5, 1e-3), torch.bfloat16: (2e-2, 1e-2)}
_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _inputs(b, s, h, dh, dtype, seed, w=None, state=False):
    """r, k, v, w (B, S, H, Dh) and u (H, Dh) in ``dtype``, plus an f32
    start state (or None), as torch tensors; the same values go to JAX
    through :func:`_j`.  w defaults to the test_kernels range (0.49,
    0.99)."""
    rng = np.random.default_rng(seed)
    shape = (b, s, h, dh)
    arrs = [rng.standard_normal(shape), 0.5 * rng.standard_normal(shape),
            rng.standard_normal(shape)]
    if w is None:
        w = 0.5 / (1 + np.exp(-rng.standard_normal(shape))) + 0.49
    arrs.append(np.broadcast_to(w, shape))
    arrs.append(0.1 * rng.standard_normal((h, dh)))
    t = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)
         for a in arrs]
    s0 = (torch.from_numpy(rng.standard_normal((b, h, dh, dh)).astype(
        np.float32)) if state else None)
    return t, s0


def _j(x, dtype=None):
    """The torch tensor's exact values as a JAX array of its dtype."""
    dt = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(x.float().numpy(), dtype or dt)


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("b,s,h,dh,chunk,dt", WKV_CASES)
def test_plain_matches_jax_kernel_and_ref(b, s, h, dh, chunk, dt):
    dtype = _TORCH[dt]
    (r, k, v, w, u), _ = _inputs(b, s, h, dh, dtype, seed=s * h + dh)
    y, s_last = tops.wkv6(r, k, v, w, u)
    assert y.dtype == dtype and s_last.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(s_last).all()
    jargs = [_j(a) for a in (r, k, v, w)] + [_j(u)]
    yk, sk = jops.wkv6(*jargs, chunk=chunk)
    yr, sr = jref.wkv6_ref(*jargs)
    for want_y, want_s in ((yk, sk), (yr, sr)):
        _close(y, want_y, dtype)
        _close(s_last, want_s, dtype)


@pytest.mark.parametrize("s,chunk", [(48, 16), (100, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_from_state_matches_chunked_twin_and_ref(s, chunk, dtype):
    """A carried state (the engine's prefill): against JAX
    ``wkv6_chunked(s0=...)`` and ``wkv6_ref(s0=...)``; the state advances
    in place and the input state is what both JAX functions saw."""
    (r, k, v, w, u), s0 = _inputs(2, s, 3, 16, dtype, seed=s, state=True)
    start = s0.clone()
    y, s_last = tops.wkv6(r, k, v, w, u, s0)
    assert s_last is s0 and not torch.equal(s0, start)
    jargs = [_j(a) for a in (r, k, v, w, u)]
    yc, sc = jnn.wkv6_chunked(*jargs, chunk=chunk, s0=_j(start))
    yr, sr = jref.wkv6_ref(*jargs, s0=_j(start))
    for want_y, want_s in ((yc, sc), (yr, sr)):
        _close(y, want_y, dtype)
        _close(s_last, want_s, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_step_from_state(dtype):
    """S = 1 from a state (one decode step) equals the JAX forms, and a
    prefill split into a prefix and one-token steps equals one pass."""
    (r, k, v, w, u), s0 = _inputs(3, 1, 2, 32, dtype, seed=5, state=True)
    start = s0.clone()
    y, s_last = tops.wkv6(r, k, v, w, u, s0)
    jargs = [_j(a) for a in (r, k, v, w, u)]
    for want_y, want_s in (jnn.wkv6_chunked(*jargs, chunk=16, s0=_j(start)),
                           jref.wkv6_ref(*jargs, s0=_j(start))):
        _close(y, want_y, dtype)
        _close(s_last, want_s, dtype)

    (r, k, v, w, u), _ = _inputs(2, 12, 2, 8, torch.float32, seed=6)
    y_all, s_all = tops.wkv6(r, k, v, w, u)
    y_pre, state = tops.wkv6(r[:, :9], k[:, :9], v[:, :9], w[:, :9], u)
    ys = [y_pre]
    for t in range(9, 12):
        yt, _ = tops.wkv6(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                          w[:, t:t + 1], u, state)
        ys.append(yt)
    torch.testing.assert_close(torch.cat(ys, dim=1), y_all, atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(state, s_all, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("decay", [0.5, 0.4, 1e-8])
def test_strong_decay_stays_finite_where_chunked_form_overflows(decay):
    """Constant strong decay over a 128-token chunk from a state: the
    port matches the stepwise JAX oracle and stays finite.  The JAX
    chunked forms (twin and Pallas kernel) overflow f32 once the
    log-decay summed over the chunk passes ln(FLT_MAX) = 88.72 (ROADMAP
    Queue 3): below w = 0.5, whose 128·ln 2 sits exactly on that edge."""
    (r, k, v, w, u), s0 = _inputs(1, 128, 2, 16, torch.float32, seed=7,
                                  w=decay, state=True)
    start = s0.clone()
    y, s_last = tops.wkv6(r, k, v, w, u, s0)
    assert torch.isfinite(y).all() and torch.isfinite(s_last).all()
    jargs = [_j(a) for a in (r, k, v, w, u)]
    yr, sr = jref.wkv6_ref(*jargs, s0=_j(start))
    _close(y, yr, torch.float32)
    _close(s_last, sr, torch.float32)
    if decay < 0.5:
        yc, _ = jnn.wkv6_chunked(*jargs, chunk=128, s0=_j(start))
        yk, _ = jops.wkv6(*jargs, chunk=128)
        assert not np.isfinite(np.asarray(yc)).all()
        assert not np.isfinite(np.asarray(yk)).all()


def test_plain_clips_decay_and_ref_is_the_jax_oracle():
    """The port's oracle equals the JAX oracle; the plain version reads w
    clipped to [1e-8, 1] as the JAX model does (nn.py's chunked twin and
    the TPU kernel), so w = 0 and w > 1 act as 1e-8 and 1."""
    (r, k, v, w, u), s0 = _inputs(2, 20, 2, 8, torch.float32, seed=8,
                                  state=True)
    jargs = [_j(a) for a in (r, k, v, w, u)]
    yo, so = tref.wkv6_ref(r, k, v, w, u, s0)
    yj, sj = jref.wkv6_ref(*jargs, s0=_j(s0))
    _close(yo, yj, torch.float32)
    _close(so, sj, torch.float32)
    wild = w.clone()
    wild[:, ::3] = 0.0
    wild[:, 1::3] = 1.5
    y, s_last = twkv.wkv6_plain(r, k, v, wild, u)
    ye, se = tref.wkv6_ref(r, k, v, wild.clamp(1e-8, 1.0), u)
    assert torch.equal(y, ye) and torch.equal(s_last, se)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: CPU tensors raise
    before any build is attempted."""
    (r, k, v, w, u), _ = _inputs(1, 4, 2, 8, torch.float32, seed=9)
    with pytest.raises(ValueError, match="CUDA"):
        twkv.wkv6(r, k, v, w, u)
    with pytest.raises(ValueError, match="Dh"):
        twkv.wkv6(*(t[..., :6].contiguous() for t in (r, k, v, w)),
                  u[:, :6].contiguous())
