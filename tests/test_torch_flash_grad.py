"""The flash attention backward's plain version (the arithmetic of the
CUDA backward kernel, csrc/flash_attention_bwd.cu) against autograd of
the plain forward and against ``jax.vjp`` of the JAX package's naive
oracle ``repro.kernels.ref.attention_ref``, whose gradient is what the
JAX package trains with (XLA differentiates the jnp twin).  Also the
forward's log-sum-exp, and the autograd function the port's dispatch
uses under grad on the CPU.  The plain backward rounds P and dS to the
inputs' dtype before the products, as the bf16 kernel does.
Tolerances: f32 atol 2e-5 / rtol 1e-3, bf16 atol 2e-2 / rtol 1e-2
(tests/test_kernels.py's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_jax import one_torch_thread  # noqa: F401
from repro.kernels.ref import attention_ref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops

CASES = [  # b, sq, sk, h, kv, dh, causal, window
    (2, 16, 16, 4, 2, 16, True, -1),        # the qwen3 smoke spec's call
    (1, 37, 37, 6, 2, 8, True, 7),          # GQA, window, ragged S
    (2, 50, 50, 4, 1, 32, True, 1),         # one visible key a row
    (1, 33, 33, 4, 4, 16, False, -1),       # bidirectional
    (1, 20, 45, 4, 2, 16, False, 10),       # Sq != Sk
    (1, 70, 70, 8, 2, 64, True, 33)]
# bf16 at a longer sequence, at the training shape's head width and
# group (G 5, Dh 128): P and dS rounded to bf16 over up to 512 keys a row.
# The reference is JAX's vjp in f32 of the same bf16 values: in bf16,
# attention_ref repeats k and v over the group before widening them, so
# its vjp rounds each query head's dK / dV share to bf16 before summing
# the group, which alone is off the f32 gradient by more than the
# tolerance at some of these keys (dV by 1.24x at window 200)
LONG_BF16 = [  # b, sq, sk, h, kv, dh, causal, window
    (1, 512, 512, 10, 2, 128, True, -1),
    (1, 512, 512, 10, 2, 128, True, 200)]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5, 1e-3),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2, 1e-2)}


def _inputs(b, sq, sk, h, kv, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh),
                      (b, sq, h, dh))]


def _plain_grads(arrs, dtype, causal, window):
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrs)
    out, lse = tfa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window, return_lse=True)
    return tfa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         causal=causal, window=window)


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _check_against_jax_vjp(b, sq, sk, h, kv, dh, causal, window, dt,
                           jax_dtype=None):
    tdt, jdt, atol, rtol = DTYPES[dt]
    arrs = _inputs(b, sq, sk, h, kv, dh, sq * h + dh)
    got = _plain_grads(arrs, tdt, causal, window)
    q, k, v, do = (jnp.asarray(jnp.asarray(a, jdt), jax_dtype or jdt)
                   for a in arrs)
    _, vjp = jax.vjp(lambda q_, k_, v_: attention_ref(
        q_, k_, v_, causal=causal, window=window), q, k, v)
    want = vjp(do)
    for g, w in zip(got, want):
        _close(g.float().numpy(), np.asarray(w.astype(jnp.float32)), atol,
               rtol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window", CASES)
def test_bwd_plain_matches_jax_vjp_of_attention_ref(b, sq, sk, h, kv, dh,
                                                    causal, window, dt):
    _check_against_jax_vjp(b, sq, sk, h, kv, dh, causal, window, dt)


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window", LONG_BF16)
def test_bwd_plain_bf16_matches_jax_vjp_at_512_keys(b, sq, sk, h, kv, dh,
                                                    causal, window):
    _check_against_jax_vjp(b, sq, sk, h, kv, dh, causal, window, "bfloat16",
                           jax_dtype=jnp.float32)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window", CASES)
def test_bwd_plain_matches_autograd_of_plain_forward(b, sq, sk, h, kv, dh,
                                                     causal, window, dt):
    tdt, _, atol, rtol = DTYPES[dt]
    arrs = _inputs(b, sq, sk, h, kv, dh, 7 + sq)
    got = _plain_grads(arrs, tdt, causal, window)
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrs)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(tfa.flash_attention_plain(
        *leaves, causal=causal, window=window), leaves, do)
    for g, w in zip(got, want):
        assert g.dtype == tdt and g.shape == w.shape
        _close(g.float(), w.float(), atol, rtol)


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window", CASES)
def test_lse_is_the_base2_logsumexp_of_the_scaled_scores(b, sq, sk, h, kv,
                                                         dh, causal, window):
    q, k, v, _ = (torch.from_numpy(a).double()
                  for a in _inputs(b, sq, sk, h, kv, dh, 3))
    _, lse = tfa.flash_attention_plain(q.float(), k.float(), v.float(),
                                       causal=causal, window=window,
                                       return_lse=True)
    kk = k.repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(dh)
    mask = tfa._mask(sq, sk, causal, window, q.device)
    want = torch.logsumexp(s.masked_fill(~mask, -np.inf), -1) / np.log(2)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    _close(lse, want, 2e-5, 1e-6)


def test_lse_of_a_row_that_sees_no_key_is_inf_and_its_gradient_zero():
    # Sq > Sk with a window: queries past the last key's window see none
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 12, 4, 2, 2, 8,
                                                        5))
    out, lse = tfa.flash_attention_plain(q, k, v, causal=True, window=3,
                                         return_lse=True)
    assert torch.isinf(lse[:, :, 6:]).all() and torch.isfinite(
        lse[:, :, :6]).all()
    dq, dk, dv = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                               causal=True, window=3)
    assert (out[:, 6:] == 0).all() and (dq[:, 6:] == 0).all()
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))


@pytest.mark.parametrize("window", [-1, 5])
def test_dispatch_under_grad_runs_the_autograd_function(window):
    """ops.flash_attention on CPU tensors that require grad: the plain
    forward through FlashAttention, whose backward is the plain
    backward; without grad, the plain forward alone (same output)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 24, 24, 4, 2,
                                                        16, 11))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, window=window)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, do)
    o, lse = tfa.flash_attention_plain(q, k, v, window=window,
                                       return_lse=True)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, window=window)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():
        assert torch.equal(ops.flash_attention(*leaves, window=window), o)
    assert torch.equal(out.detach(), o)
