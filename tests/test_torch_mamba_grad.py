"""The gradient of the port's selective scan against the JAX package, on
the CPU.

``mamba_scan_bwd_plain`` (the reverse recurrence the CUDA backward
kernel computes, in plain PyTorch) is held against ``jax.vjp`` of JAX's
stepwise oracle ``repro/kernels/ref.py::mamba_scan_ref`` and of the
chunked twin ``nn.selective_scan`` (what JAX trains through), at the
ranges of tests/test_kernels.py and at strong decay (exp(dt · A) down to
e^-60); the autograd Function behind ``ops.mamba_scan`` is held against
autograd of the plain forward.  Same numpy inputs on both sides; fp32
atol 2e-5 / rtol 1e-3.  The CUDA kernel is held against
``mamba_scan_bwd_plain`` on a card by tests/test_torch_cuda.py.
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
from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ATOL, RTOL = 2e-5, 1e-3
NAMES = ("du", "ddt", "dA", "dB", "dC", "dD")
SHAPES = [(2, 33, 24, 4), (1, 64, 16, 16), (2, 17, 8, 8)]   # b, s, ci, n


def _inputs(b, s, ci, n, seed, strong=False):
    """u, dt, A, B, C, D, dy as float32 numpy arrays (A in [-60, -20] when
    ``strong``)."""
    rng = np.random.default_rng(seed)
    A = (-rng.uniform(20, 60, (ci, n)) if strong
         else -np.exp(0.3 * rng.standard_normal((ci, n))))
    arrs = (rng.standard_normal((b, s, ci)),
            0.3 * np.log1p(np.exp(rng.standard_normal((b, s, ci)))), A,
            rng.standard_normal((b, s, n)), rng.standard_normal((b, s, n)),
            rng.standard_normal(ci), rng.standard_normal((b, s, ci)))
    return [a.astype(np.float32) for a in arrs]


def _jax_grads(fn, arrs):
    """``jax.vjp`` of y = fn(u, dt, A, B, C, D)[0] at dy = arrs[-1]."""
    y, pull = jax.vjp(lambda *x: fn(*x)[0], *map(jnp.asarray, arrs[:6]))
    return [np.asarray(g) for g in pull(jnp.asarray(arrs[6]))]


def _close(got, want):
    for name, g, w in zip(NAMES, got, want):
        assert np.isfinite(np.asarray(g)).all(), name
        np.testing.assert_allclose(np.asarray(g), w, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("b,s,ci,n", SHAPES)
def test_bwd_plain_matches_jax_stepwise_oracle(b, s, ci, n, strong):
    arrs = _inputs(b, s, ci, n, seed=s * ci + n, strong=strong)
    want = _jax_grads(jref.mamba_scan_ref, arrs)
    got = tms.mamba_scan_bwd_plain(*map(torch.from_numpy, arrs))
    _close([t.numpy() for t in got], want)


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("b,s,ci,n", SHAPES)
def test_bwd_plain_matches_jax_chunked_twin(b, s, ci, n, chunk):
    arrs = _inputs(b, s, ci, n, seed=5 * s + ci)
    want = _jax_grads(functools.partial(jnn.selective_scan, chunk=chunk),
                      arrs)
    got = tms.mamba_scan_bwd_plain(*map(torch.from_numpy, arrs))
    _close([t.numpy() for t in got], want)


@pytest.mark.parametrize("b,s,ci,n", SHAPES)
def test_function_matches_autograd_of_the_plain_forward(b, s, ci, n):
    """ops.mamba_scan under autograd on CPU tensors runs the MambaScan
    Function (the plain forward and backward); its gradients equal
    autograd of the stepwise forward, and h_last carries no gradient."""
    arrs = _inputs(b, s, ci, n, seed=3 * s + n)
    dy = torch.from_numpy(arrs[6])
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs[:6]]
    y, h_last = tops.mamba_scan(*leaves)
    assert type(y.grad_fn).__name__ == "MambaScanBackward"
    assert not h_last.requires_grad
    got = torch.autograd.grad(y, leaves, dy)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs[:6]]
    want = torch.autograd.grad(tref.mamba_scan_ref(*leaves)[0], leaves, dy)
    _close([g.numpy() for g in got], [w.numpy() for w in want])


def test_start_state_under_autograd_raises():
    arrs = _inputs(1, 8, 8, 4, seed=0)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs[:6]]
    h0 = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="start state under autograd"):
        tops.mamba_scan(*leaves, h0)
    with torch.no_grad():                        # serving: the state runs
        y, h_last = tops.mamba_scan(*leaves, h0)
    assert h_last is h0 and torch.isfinite(y).all()
