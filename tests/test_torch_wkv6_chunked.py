"""The chunked WKV6 arithmetic of the CUDA kernel, in plain PyTorch on the CPU.

``wkv6_chunked_plain`` mirrors the chunked kernel's decomposition: chunks
of C tokens (a ragged last one), sub-blocks of 16 or 8, a sub-block's own
keys by running products and earlier sub-blocks' keys factored at the
sub-block's start, every decay factor a product of w over an interval
(never exp(-cumulative log decay)).  The kernel runs it at C = 16 with
sub-blocks of 8.  Here it is held in fp32 against the stepwise plain
version, against the JAX Pallas kernel in interpret mode (zero start, at
decays where the JAX form is finite) and against the JAX chunked twin
``nn.wkv6_chunked`` (from a state), at atol = rtol = 1e-5: the forms
differ only in the order of their f32 sums.  The JAX forms run at
16-token chunks: their exp(cum) · exp(-cum) factoring loses f32
precision as a chunk's summed log-decay grows (at 64-token chunks their
own error passes 1e-5 at these decays).  At strong decay the chunked
plain form stays finite and equal to the stepwise one where the JAX
chunked forms overflow.  The CUDA kernel is held against the plain
version on a card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import nn as jnn
from repro_torch.kernels import wkv6 as twkv

TOL = 1e-5                     # atol and rtol: f32, sums in another order
CHUNKINGS = [(16, 8), (16, 16), (32, 16), (64, 16)]   # (chunk, sub-block)


def _inputs(b, s, h, dh, seed, w=None, state=False):
    """f32 r, k, v, w (B, S, H, Dh) and u (H, Dh) from a seeded numpy
    generator (w in (0.49, 0.99) unless given) and an f32 state or None."""
    rng = np.random.default_rng(seed)
    shape = (b, s, h, dh)
    if w is None:
        w = 0.5 / (1 + np.exp(-rng.standard_normal(shape))) + 0.49
    arrs = [rng.standard_normal(shape), 0.5 * rng.standard_normal(shape),
            rng.standard_normal(shape), np.broadcast_to(w, shape),
            0.1 * rng.standard_normal((h, dh))]
    t = [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in arrs]
    s0 = (torch.from_numpy(rng.standard_normal((b, h, dh, dh)).astype(
        np.float32)) if state else None)
    return t, s0


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s_of", ["1", "C-1", "C+1", "100"])
@pytest.mark.parametrize("chunk,sub", CHUNKINGS)
def test_chunked_plain_matches_stepwise(chunk, sub, s_of, with_state, dh):
    """Ragged S around the chunk (1, C-1, C+1, 100), with and without a
    start state; the state advances in place as in the stepwise version."""
    s = {"1": 1, "C-1": chunk - 1, "C+1": chunk + 1, "100": 100}[s_of]
    args, s0 = _inputs(2, s, 2, dh, seed=s + dh, state=with_state)
    want_y, want_s = twkv.wkv6_plain(*args, None if s0 is None
                                     else s0.clone())
    start = None if s0 is None else s0.clone()
    y, s_last = twkv.wkv6_chunked_plain(*args, start, chunk=chunk, sub=sub)
    if with_state:
        assert s_last is start
    assert y.dtype == torch.float32 and s_last.dtype == torch.float32
    _close(y, want_y)
    _close(s_last, want_s)


@pytest.mark.parametrize("chunk,sub,dh", [(16, 8, 16), (32, 16, 32),
                                          (64, 16, 64)])
def test_chunked_plain_matches_jax_kernel_and_twin(chunk, sub, dh):
    """Zero start against the Pallas kernel (interpret mode); a carried
    state against the JAX chunked twin; both at 16-token chunks."""
    args, _ = _inputs(1, 100, 2, dh, seed=dh)
    y, s_last = twkv.wkv6_chunked_plain(*args, chunk=chunk, sub=sub)
    yk, sk = jops.wkv6(*[jnp.asarray(a.numpy()) for a in args], chunk=16)
    _close(y, yk)
    _close(s_last, sk)
    args, s0 = _inputs(2, 48, 2, dh, seed=dh + 1, state=True)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    yc, sc = jnn.wkv6_chunked(*jargs, chunk=16, s0=jnp.asarray(s0.numpy()))
    y, s_last = twkv.wkv6_chunked_plain(*args, s0, chunk=chunk, sub=sub)
    _close(y, yc)
    _close(s_last, sc)


@pytest.mark.parametrize("decay", [1e-8, 0.4, 0.5])
def test_chunked_plain_stays_finite_where_jax_chunked_form_overflows(decay):
    """Constant strong decay over 256 tokens from a state: the chunked
    plain form (every chunking, the kernel's included) is finite and
    equals the stepwise version.  The JAX chunked forms (twin and Pallas
    kernel, 128-token chunks) overflow f32 once a chunk's summed log-decay
    passes ln(FLT_MAX) = 88.72: below w = 0.5, whose 128·ln 2 sits on that
    edge (ROADMAP Queue 3)."""
    args, s0 = _inputs(1, 256, 2, 16, seed=7, w=decay, state=True)
    want_y, want_s = twkv.wkv6_plain(*args, s0.clone())
    for chunk, sub in CHUNKINGS:
        y, s_last = twkv.wkv6_chunked_plain(*args, s0.clone(), chunk=chunk,
                                            sub=sub)
        assert torch.isfinite(y).all() and torch.isfinite(s_last).all()
        _close(y, want_y)
        _close(s_last, want_s)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    yc, _ = jnn.wkv6_chunked(*jargs, chunk=128, s0=jnp.asarray(s0.numpy()))
    yk, _ = jops.wkv6(*jargs, chunk=128)
    finite = (np.isfinite(np.asarray(yc)).all()
              and np.isfinite(np.asarray(yk)).all())
    assert finite == (decay >= 0.5)


def test_design_is_chosen_by_shape_and_dtype():
    """bf16 with S >= 16 and Dh 16, 32 or 64 runs the chunked design;
    f32, shorter calls and other Dh the stepwise one."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert twkv.design(1024, 64, bf16) == "chunked"
    assert twkv.design(16, 16, bf16) == "chunked"
    assert twkv.design(17, 32, bf16) == "chunked"
    assert twkv.design(15, 64, bf16) == "stepwise"
    assert twkv.design(1, 64, bf16) == "stepwise"
    assert twkv.design(1024, 64, f32) == "stepwise"
    assert twkv.design(1024, 8, bf16) == "stepwise"
