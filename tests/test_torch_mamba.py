"""The port's selective scan and Mamba mixer against the JAX package, on
the CPU.

The port's plain scan (what ``ops.mamba_scan`` runs for CPU tensors) is
held against the JAX Pallas kernel in interpret mode, the JAX stepwise
oracle and the chunked jnp twin ``nn.selective_scan``, on the same numpy
inputs: zero start, a carried state, one-token decode steps.  The CUDA
kernel is held against the plain version on a card by
tests/test_torch_cuda.py.  ``mamba_block`` is held against JAX
``nn.mamba_block`` without a state and from one, at prefill and decode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import nn as jnn
from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import nn as tnn
from test_kernels import MAMBA_CASES

ATOL, RTOL = 2e-4, 1e-3            # tests/test_kernels.py's mamba tolerance
# (atol, rtol) per dtype for a carried state: fp32 as above, bf16 an ulp
TOL = {torch.float32: (ATOL, RTOL), torch.bfloat16: (2e-2, 1e-2)}


def _inputs(b, s, ci, n, seed, dtype=torch.float32, state=False):
    """u, dt, B, C in ``dtype`` and A, D f32 (the ranges of
    tests/test_kernels.py), plus an f32 start state or None, as torch
    tensors; the same values go to JAX through :func:`_j`."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, s, ci))
    dt = 0.3 * np.log1p(np.exp(rng.standard_normal((b, s, ci))))
    A = -np.exp(0.3 * rng.standard_normal((ci, n)))
    B = rng.standard_normal((b, s, n))
    C = rng.standard_normal((b, s, n))
    D = rng.standard_normal(ci)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    h0 = t(rng.standard_normal((b, ci, n))) if state else None
    return ([t(u).to(dtype), t(dt).to(dtype), t(A), t(B).to(dtype),
             t(C).to(dtype), t(D)], h0)


def _j(x):
    """The torch tensor's exact values as a JAX array of its dtype."""
    dt = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(x.float().numpy(), dt)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("b,s,ci,n,chunk,cib", MAMBA_CASES)
def test_plain_matches_jax_kernel_and_ref(b, s, ci, n, chunk, cib):
    args, _ = _inputs(b, s, ci, n, seed=s * ci + n)
    y, h_last = tops.mamba_scan(*args)
    assert y.dtype == torch.float32 and h_last.dtype == torch.float32
    assert y.shape == (b, s, ci) and h_last.shape == (b, ci, n)
    jargs = [_j(a) for a in args]
    yk, hk = jops.mamba_scan(*jargs, chunk=chunk, ci_block=cib)
    yr, hr = jref.mamba_scan_ref(*jargs)
    for want_y, want_h in ((yk, hk), (yr, hr)):
        _close(y, want_y)
        _close(h_last, want_h)


@pytest.mark.parametrize("s,chunk", [(40, 16), (100, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_from_state_matches_twin_and_ref(s, chunk, dtype):
    """A carried state (the engine's prefill): against JAX
    ``selective_scan(h0=...)`` and ``mamba_scan_ref(h0=...)``; the state
    advances in place and the input state is what JAX saw."""
    args, h0 = _inputs(2, s, 24, 8, seed=s, dtype=dtype, state=True)
    start = h0.clone()
    y, h_last = tops.mamba_scan(*args, h0)
    assert h_last is h0 and not torch.equal(h0, start)
    assert y.dtype == dtype
    jargs = [_j(a) for a in args]
    f32 = [a.astype(jnp.float32) for a in jargs]
    yc, hc = jnn.selective_scan(*f32, chunk=chunk, h0=_j(start))
    yr, hr = jref.mamba_scan_ref(*jargs, h0=_j(start))
    atol, rtol = TOL[dtype]
    for want_y, want_h in ((yc, hc), (yr, hr)):
        _close(y, want_y, atol, rtol)
        _close(h_last, want_h, atol, rtol)


@pytest.mark.parametrize("split", [1, 7, 16])
def test_start_state_splits_a_scan(split):
    """A scan of S tokens from h0 equals a scan of the first ``split``
    tokens from h0 followed by one-token steps (decode) and a scan of
    the rest, each continuing the state in place."""
    (u, dt, A, B, C, D), h0 = _inputs(2, 24, 16, 4, seed=split, state=True)
    y_all, h_all = tops.mamba_scan(u, dt, A, B, C, D, h0.clone())
    state = h0.clone()
    cut = lambda lo, hi: [t[:, lo:hi] for t in (u, dt)] + [A] + [
        t[:, lo:hi] for t in (B, C)] + [D]
    ys = [tops.mamba_scan(*cut(0, split), state)[0]]
    for t in range(split, split + 2):
        ys.append(tops.mamba_scan(*cut(t, t + 1), state)[0])
    ys.append(tops.mamba_scan(*cut(split + 2, 24), state)[0])
    torch.testing.assert_close(torch.cat(ys, dim=1), y_all, atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(state, h_all, atol=1e-6, rtol=1e-6)


def test_port_oracle_is_the_jax_oracle_and_plain_is_the_oracle():
    args, h0 = _inputs(2, 20, 12, 16, seed=8, state=True)
    yo, ho = tref.mamba_scan_ref(*args, h0)
    yj, hj = jref.mamba_scan_ref(*[_j(a) for a in args], h0=_j(h0))
    _close(yo, yj, 1e-5, 1e-5)
    _close(ho, hj, 1e-5, 1e-5)
    y, h_last = tms.mamba_scan_plain(*args)
    assert torch.equal(y, tref.mamba_scan_ref(*args)[0])
    assert torch.equal(h_last, tref.mamba_scan_ref(*args)[1])


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    """The CUDA wrapper never runs the plain version: CPU tensors raise
    before any build is attempted, as do shapes it does not take."""
    args, _ = _inputs(1, 4, 8, 4, seed=9)
    with pytest.raises(ValueError, match="CUDA"):
        tms.mamba_scan(*args)
    u, dt, A, B, C, D = args
    with pytest.raises(ValueError, match="N in"):
        tms.mamba_scan(u, dt, A[:, :3].contiguous(), B[..., :3].contiguous(),
                       C[..., :3].contiguous(), D)
    with pytest.raises(ValueError, match="share"):
        tms.mamba_scan(u, dt[:, :2], A, B, C, D)
    with pytest.raises(ValueError, match="D"):
        tms.mamba_scan(u, dt, A, B, C, D[:4])


# --------------------------------------------------------------------------
# the Mamba mixer
# --------------------------------------------------------------------------

def _block_params(rng, d=16, ci=32, n=4, k=4, r=3):
    g = lambda *s, scale=0.3: (scale * rng.standard_normal(s)).astype(
        np.float32)
    return {"in_x": g(d, ci), "in_z": g(d, ci), "conv_w": g(ci, k),
            "x_proj": g(ci, r + 2 * n), "dt_proj": g(r, ci),
            "dt_bias": np.log(np.expm1(rng.uniform(1e-3, 0.1, ci))).astype(
                np.float32),
            "A_log": np.log(np.tile(np.arange(1, n + 1, dtype=np.float32),
                                    (ci, 1))),
            "D": 1 + g(ci), "out_proj": g(ci, d)}


@pytest.mark.parametrize("seq,with_state", [(9, False), (9, True),
                                            (1, True), (2, True)])
def test_mamba_block_matches_jax(seq, with_state):
    """The mixer against JAX ``nn.mamba_block`` on one numpy tree: without
    a state (zero-padded conv, zero scan start) and from a state (the
    engine's prefill, seq 9; decode, seq 1; and a prompt of 2 tokens,
    shorter than d_conv - 1 = 3, whose new tail keeps one token of the
    old one).  The in-place state update must equal JAX's new state."""
    rng = np.random.default_rng(seq + 10 * with_state)
    b, d, ci, n, k, r = 2, 16, 32, 4, 4, 3
    p = _block_params(rng, d, ci, n, k, r)
    x = rng.standard_normal((b, seq, d)).astype(np.float32)
    state = None
    if with_state:
        state = (rng.standard_normal((b, k - 1, ci)).astype(np.float32),
                 (0.5 * rng.standard_normal((b, ci, n))).astype(np.float32))
    jout, jnew = jnn.mamba_block(
        {kk: jnp.asarray(v) for kk, v in p.items()}, jnp.asarray(x),
        jnn.MambaStatic(ci, n, k, r, chunk=4), None,
        None if state is None else tuple(jnp.asarray(a) for a in state))
    mine = None if state is None else tuple(torch.from_numpy(a.copy())
                                            for a in state)
    tout = tnn.mamba_block({kk: torch.from_numpy(v) for kk, v in p.items()},
                           torch.from_numpy(x), tnn.MambaStatic(ci, n, k, r),
                           state=mine)
    _close(tout, jout)
    if with_state:
        for got, want in zip(mine, jnew):
            _close(got, want)
        if seq < k - 1:
            np.testing.assert_array_equal(mine[0][:, 0].numpy(),
                                          state[0][:, seq])
