"""The gradient of the port's WKV6 against the JAX package, on the CPU.

``wkv6_bwd_plain`` (the reverse recurrence the CUDA backward kernel
computes, in plain PyTorch) is held against ``jax.vjp`` of JAX's stepwise
oracle ``repro/kernels/ref.py::wkv6_ref`` at every decay, w = 0 and
constant 1e-8 included, and against ``jax.vjp`` of the chunked twin
``nn.wkv6_chunked`` (what JAX trains through) where that form is finite:
w >= 1e-8 and a chunk's summed log-decay under 88 (ROADMAP Queue 3).
The autograd Function behind ``ops.wkv6`` is held against autograd of
the plain forward.  Same numpy inputs on both sides; fp32 atol 2e-5 /
rtol 1e-3.  The CUDA kernel is held against ``wkv6_bwd_plain`` on a card
by tests/test_torch_cuda.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_jax import one_torch_thread  # noqa: F401
from repro.kernels import ref as jref
from repro.models import nn as jnn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wkv6 as twkv

ATOL, RTOL = 2e-5, 1e-3
NAMES = ("dr", "dk", "dv", "dw", "du")
SHAPES = [(2, 33, 3, 8), (1, 64, 2, 16), (2, 17, 2, 4)]   # b, s, h, dh
# the decays: the model's range, strong (uniform in (0, 1e-3)), a
# quarter exactly 0, and constant 1e-8 (the forward's clip)
DECAYS = ["model", "strong", "zero", "1e-8"]


def _inputs(b, s, h, dh, decay, seed):
    """r, k, v, w, u, dy as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    shape = (b, s, h, dh)
    if decay == "model":
        w = 0.5 / (1 + np.exp(-rng.standard_normal(shape))) + 0.49
    elif decay == "strong":
        w = 1e-3 * rng.random(shape)
    elif decay == "zero":
        w = 0.5 / (1 + np.exp(-rng.standard_normal(shape))) + 0.49
        w[rng.random(shape) < 0.25] = 0.0
    else:
        w = np.full(shape, 1e-8)
    arrs = (rng.standard_normal(shape), 0.5 * rng.standard_normal(shape),
            rng.standard_normal(shape), w,
            0.1 * rng.standard_normal((h, dh)), rng.standard_normal(shape))
    return [a.astype(np.float32) for a in arrs]


def _jax_grads(fn, arrs):
    """``jax.vjp`` of y = fn(r, k, v, w, u)[0] at dy = arrs[-1]."""
    y, pull = jax.vjp(lambda *x: fn(*x)[0], *map(jnp.asarray, arrs[:5]))
    return [np.asarray(g) for g in pull(jnp.asarray(arrs[5]))]


def _close(got, want):
    for name, g, w in zip(NAMES, got, want):
        assert np.isfinite(np.asarray(g)).all(), name
        np.testing.assert_allclose(np.asarray(g), w, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("b,s,h,dh", SHAPES)
def test_bwd_plain_matches_jax_stepwise_oracle(b, s, h, dh, decay):
    arrs = _inputs(b, s, h, dh, decay, seed=s * dh + len(decay))
    want = _jax_grads(jref.wkv6_ref, arrs)
    got = twkv.wkv6_bwd_plain(*map(torch.from_numpy, arrs))
    _close([t.numpy() for t in got], want)


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("b,s,h,dh", SHAPES)
def test_bwd_plain_matches_jax_chunked_twin(b, s, h, dh, chunk):
    """What JAX trains through, at the model's decays (w >= 0.49: a
    chunk's summed log-decay is at most 16 · 0.72, far from 88)."""
    arrs = _inputs(b, s, h, dh, "model", seed=7 * s + dh)
    want = _jax_grads(functools.partial(jnn.wkv6_chunked, chunk=chunk), arrs)
    got = twkv.wkv6_bwd_plain(*map(torch.from_numpy, arrs))
    _close([t.numpy() for t in got], want)


def test_bwd_plain_stays_finite_where_the_decay_underflows():
    """w = 0 everywhere (a bf16 decay that underflowed): every gradient
    finite, dw equal to JAX's stepwise oracle's (a d(log w) / w form is
    0 / 0 here)."""
    arrs = _inputs(2, 40, 2, 8, "model", seed=3)
    arrs[3] = np.zeros_like(arrs[3])
    want = _jax_grads(jref.wkv6_ref, arrs)
    got = twkv.wkv6_bwd_plain(*map(torch.from_numpy, arrs))
    _close([t.numpy() for t in got], want)
    assert np.abs(want[3]).max() > 1.0        # dw is not trivially 0


@pytest.mark.parametrize("b,s,h,dh", SHAPES)
def test_function_matches_autograd_of_the_plain_forward(b, s, h, dh):
    """ops.wkv6 under autograd on CPU tensors runs the WKV6 Function (the
    plain forward and backward); its gradients equal autograd of the
    stepwise forward, and s_last carries no gradient."""
    arrs = _inputs(b, s, h, dh, "model", seed=11 * s + dh)
    dy = torch.from_numpy(arrs[5])
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs[:5]]
    y, s_last = tops.wkv6(*leaves)
    assert type(y.grad_fn).__name__ == "WKV6Backward"
    assert not s_last.requires_grad
    got = torch.autograd.grad(y, leaves, dy)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs[:5]]
    want = torch.autograd.grad(tref.wkv6_ref(*leaves)[0], leaves, dy)
    _close([g.numpy() for g in got], [w.numpy() for w in want])


def test_start_state_under_autograd_raises():
    arrs = _inputs(1, 8, 2, 8, "model", seed=0)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs[:5]]
    s0 = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="start state under autograd"):
        tops.wkv6(*leaves, s0)
    with torch.no_grad():                        # serving: the state runs
        y, s_last = tops.wkv6(*leaves, s0)
    assert s_last is s0 and torch.isfinite(y).all()
