"""The WKV6 backward kernel's passes, in plain PyTorch, against the JAX
package, on the CPU.

``wkv6_bwd_chunked_plain`` is the arithmetic of the CUDA backward kernel
(``csrc/wkv6_bwd.cu``) in plain f32 PyTorch: chunk-local sums (pass A),
the ordered combine of the boundary states (pass B), and every chunk's
gradients recomputed from sub-chunk checkpoints (pass C).  It is held
against ``jax.vjp`` of JAX's stepwise oracle ``repro/kernels/ref.py::
wkv6_ref`` at every decay of tests/test_torch_wkv6_grad.py (the model's
range, strong, a quarter exactly 0, constant 1e-8), and against
``wkv6_bwd_plain`` across chunk and sub-chunk edges (ragged S, S below
one sub-chunk, B > 1), at small chunks and at the kernel's own (64 / 8).
Same numpy inputs on both sides; fp32 atol 2e-5 / rtol 1e-3.  The CUDA
kernel is held against ``wkv6_bwd_plain`` on a card by
tests/test_torch_cuda.py.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_train_jax import one_torch_thread  # noqa: F401
from repro.kernels import ref as jref
from repro_torch.kernels import wkv6 as twkv
from test_torch_wkv6_grad import DECAYS, _close, _inputs, _jax_grads

# b, s, h, dh: S across a 16-token chunk and a 4-token sub-chunk
JAX_SHAPES = [(2, 19, 2, 8), (1, 33, 3, 4)]
EDGE_S = [1, 3, 4, 5, 15, 16, 17, 32]


@functools.lru_cache(maxsize=None)
def _case(b, s, h, dh, decay, seed):
    """Numpy inputs and JAX's gradients, once per module."""
    arrs = _inputs(b, s, h, dh, decay, seed)
    return arrs, _jax_grads(jref.wkv6_ref, arrs)


def _twin(arrs, **kw):
    got = twkv.wkv6_bwd_chunked_plain(*map(torch.from_numpy, arrs), **kw)
    return [t.numpy() for t in got]


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("b,s,h,dh", JAX_SHAPES)
def test_chunked_twin_matches_jax_stepwise_oracle(b, s, h, dh, decay):
    arrs, want = _case(b, s, h, dh, decay, s * dh + len(decay))
    _close(_twin(arrs, chunk=16, sub=4), want)


@pytest.mark.parametrize("decay", DECAYS)
def test_kernel_geometry_matches_jax_and_plain(decay):
    """The kernel's chunk of 64 and sub-chunk of 8: S = 130 holds two
    whole chunks and a ragged third."""
    arrs, want = _case(2, 130, 2, 8, decay, 5 + len(decay))
    got = _twin(arrs)
    _close(got, want)
    plain = twkv.wkv6_bwd_plain(*map(torch.from_numpy, arrs))
    _close(got, [t.numpy() for t in plain])


@pytest.mark.parametrize("s", EDGE_S)
def test_chunked_twin_matches_plain_at_every_edge(s):
    """Chunks of 16, sub-chunks of 4: S below a sub-chunk, on and past
    sub-chunk and chunk edges; B = 3, with a quarter of decays at 0."""
    arrs = _inputs(3, s, 2, 8, "zero", seed=40 + s)
    want = twkv.wkv6_bwd_plain(*map(torch.from_numpy, arrs))
    _close(_twin(arrs, chunk=16, sub=4), [t.numpy() for t in want])


def test_chunk_of_one_sub_chunk():
    """chunk = sub: no checkpoint inside a chunk, every boundary state
    from the combine."""
    arrs = _inputs(2, 23, 2, 4, "model", seed=2)
    want = twkv.wkv6_bwd_plain(*map(torch.from_numpy, arrs))
    _close(_twin(arrs, chunk=4, sub=4), [t.numpy() for t in want])
    assert np.abs(want[3].numpy()).max() > 0.1     # dw is not trivially 0
