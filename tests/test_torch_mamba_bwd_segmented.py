"""The selective scan's backward kernel passes, in plain PyTorch, against
the JAX package, on the CPU.

``mamba_scan_bwd_segmented_plain`` is the arithmetic of the CUDA
backward kernel (``csrc/mamba_scan_bwd.cu``) in plain f32 PyTorch: each
segment's decay, local end state and local gradient carry (pass A), the
ordered combine (pass B), and every segment's gradients recomputed from
sub-chunk checkpoints (pass C).  It is held against ``jax.vjp`` of JAX's
stepwise oracle ``repro/kernels/ref.py::mamba_scan_ref`` at the ranges
of tests/test_torch_mamba_grad.py and at strong decay, and against
``mamba_scan_bwd_plain`` across segment and sub-chunk edges (ragged S,
S below one sub-chunk, B > 1), at small segments and at the kernel's
own (128 / 8).  Same numpy inputs on both sides; fp32 atol 2e-5 / rtol
1e-3.  The CUDA kernel is held against ``mamba_scan_bwd_plain`` on a
card by tests/test_torch_cuda.py.
"""
import functools

import pytest
import torch

from _torch_train_jax import one_torch_thread  # noqa: F401
from repro.kernels import ref as jref
from repro_torch.kernels import mamba_scan as tms
from test_torch_mamba_grad import _close, _inputs, _jax_grads

# b, s, ci, n: S across a 16-token segment and a 4-token sub-chunk
JAX_SHAPES = [(2, 37, 24, 4), (1, 33, 16, 16)]
EDGE_S = [1, 3, 4, 5, 16, 17, 33]


@functools.lru_cache(maxsize=None)
def _case(b, s, ci, n, seed, strong):
    """Numpy inputs and JAX's gradients, once per module."""
    arrs = _inputs(b, s, ci, n, seed, strong=strong)
    return arrs, _jax_grads(jref.mamba_scan_ref, arrs)


def _twin(arrs, **kw):
    got = tms.mamba_scan_bwd_segmented_plain(*map(torch.from_numpy, arrs),
                                             **kw)
    return [t.numpy() for t in got]


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("b,s,ci,n", JAX_SHAPES)
def test_segmented_twin_matches_jax_stepwise_oracle(b, s, ci, n, strong):
    arrs, want = _case(b, s, ci, n, s * ci + n, strong)
    _close(_twin(arrs, seg=16, sub=4), want)


@pytest.mark.parametrize("strong", [False, True])
def test_kernel_geometry_matches_jax_and_plain(strong):
    """The kernel's segment of 128 and sub-chunk of 8: S = 300 holds two
    whole segments and a ragged third."""
    arrs, want = _case(2, 300, 8, 16, 9, strong)
    got = _twin(arrs)
    _close(got, want)
    plain = tms.mamba_scan_bwd_plain(*map(torch.from_numpy, arrs))
    _close(got, [t.numpy() for t in plain])


@pytest.mark.parametrize("s", EDGE_S)
def test_segmented_twin_matches_plain_at_every_edge(s):
    """Segments of 16, sub-chunks of 4: S below a sub-chunk, on and past
    sub-chunk and segment edges; B = 3."""
    arrs = _inputs(3, s, 12, 8, seed=50 + s)
    want = tms.mamba_scan_bwd_plain(*map(torch.from_numpy, arrs))
    _close(_twin(arrs, seg=16, sub=4), [t.numpy() for t in want])


def test_segment_of_one_sub_chunk():
    """seg = sub: no checkpoint inside a segment, every h_in and carry
    from the combine."""
    arrs = _inputs(2, 23, 8, 4, seed=3)
    want = tms.mamba_scan_bwd_plain(*map(torch.from_numpy, arrs))
    _close(_twin(arrs, seg=8, sub=8), [t.numpy() for t in want])
