"""The port's attention kernels against the JAX package.

On the CPU the port's plain PyTorch versions (what its dispatch runs for
CPU tensors) are held against the JAX Pallas kernels in interpret mode
and the JAX oracles, on the same numpy inputs; tolerances are those of
tests/test_kernels.py.  The CUDA kernels themselves are held against
the plain versions on a card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from test_kernels import FLASH_CASES, PAGED_CASES

ATOL, RTOL = 2e-5, 1e-3


def _paged_case(b, h, kv, dh, page, n_pages, seed, q_len=1, nan_tail=False):
    """Random pool, permuted tables, ragged lengths (>= q_len); spare pool
    pages hold NaN, and with ``nan_tail`` so do keys past each length."""
    rng = np.random.default_rng(seed)
    n_pool = b * n_pages + 3
    shape = (b, q_len, h, dh) if q_len > 1 else (b, h, dh)
    q = rng.standard_normal(shape).astype(np.float32)
    kp = rng.standard_normal((n_pool, page, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pool, page, kv, dh)).astype(np.float32)
    lengths = rng.integers(q_len, n_pages * page + 1, b).astype(np.int32)
    perm = rng.permutation(n_pool)
    tables = np.full((b, n_pages), -1, np.int32)
    used = 0
    for r in range(b):
        need = -(-int(lengths[r]) // page)
        tables[r, :need] = perm[used:used + need]
        used += need
        if nan_tail and lengths[r] % page:
            pid = tables[r, need - 1]
            kp[pid, lengths[r] % page:] = np.nan
            vp[pid, lengths[r] % page:] = np.nan
    spare = np.setdiff1d(np.arange(n_pool), tables[tables >= 0])
    kp[spare] = np.nan
    vp[spare] = np.nan
    return q, kp, vp, tables, lengths


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("b,h,kv,dh,page,n_pages,window", PAGED_CASES)
def test_paged_plain_matches_jax_kernel_and_ref(b, h, kv, dh, page, n_pages,
                                                window):
    args = _paged_case(b, h, kv, dh, page, n_pages, seed=b * h + page)
    got = tops.paged_attention(*_t(*args), window=window).numpy()
    want_k = np.asarray(jops.paged_attention(*_j(*args), window=window))
    want_r = np.asarray(jref.paged_attention_ref(*_j(*args), window=window))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want_k, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want_r, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window", [-1, 20])
def test_paged_nan_past_length_contributes_exact_zeros(window):
    """Keys past a row's length inside a live page may hold NaN (a page
    only partly written): the port's plain version and oracle ignore
    them, as the JAX oracle does."""
    args = _paged_case(3, 4, 2, 32, 16, 4, seed=3, nan_tail=True)
    got = tops.paged_attention(*_t(*args), window=window).numpy()
    want = np.asarray(jref.paged_attention_ref(*_j(*args), window=window))
    mine = tref.paged_attention_ref(*_t(*args), window=window).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(mine, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("q_len,window", [(2, -1), (3, -1), (3, 20), (5, 9)])
def test_paged_multi_query_matches_jax_kernel(q_len, window):
    """Q > 1 (speculative verify) against the JAX kernel in interpret
    mode; the port's Q > 1 oracle agrees with both."""
    args = _paged_case(2, 4, 2, 16, 16, 4, seed=11 + q_len, q_len=q_len)
    got = tops.paged_attention(*_t(*args), window=window).numpy()
    want = np.asarray(jops.paged_attention(*_j(*args), window=window))
    oracle = tref.paged_attention_ref(*_t(*args), window=window).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(oracle, want, atol=ATOL, rtol=RTOL)


def test_paged_multi_query_last_row_is_decode():
    """Query Q-1 of a verify call is the decode query at the same length."""
    q, kp, vp, tables, lengths = _paged_case(2, 4, 2, 16, 16, 4, seed=2,
                                             q_len=3)
    multi = tref.paged_attention_ref(*_t(q, kp, vp, tables, lengths))
    single = tref.paged_attention_ref(*_t(q[:, -1], kp, vp, tables, lengths))
    torch.testing.assert_close(multi[:, -1], single, atol=1e-6, rtol=1e-5)


# a CPU-cheap subset of the Pallas matrix (interpret mode is slow)
FLASH_SUBSET = [FLASH_CASES[i] for i in (1, 2, 4, 6)]


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,dt,bq,bk",
                         FLASH_SUBSET)
def test_flash_plain_matches_jax_kernel(b, sq, sk, h, kv, dh, causal, window,
                                        dt, bq, bk):
    rng = np.random.default_rng(sq * h + dh)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, dh)).astype(np.float32)
    tdt = torch.bfloat16 if dt == jnp.bfloat16 else torch.float32
    got = tops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                 for a in (q, k, v)),
                               causal=causal, window=window).float().numpy()
    jq, jk, jv = (jnp.asarray(a, dt) for a in (q, k, v))
    want = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal,
                                           window=window, block_q=bq,
                                           block_k=bk), np.float32)
    oracle = np.asarray(jref.attention_ref(jq, jk, jv, causal=causal,
                                           window=window), np.float32)
    atol = 2e-2 if dt == jnp.bfloat16 else ATOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-2)
    np.testing.assert_allclose(got, oracle, atol=atol, rtol=1e-2)


@pytest.mark.parametrize("causal,window", [(True, -1), (True, 7), (False, -1)])
def test_attention_ref_matches_jax_ref(causal, window):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 24, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 8)).astype(np.float32)
    got = tref.attention_ref(*_t(q, k, v), causal=causal, window=window)
    want = jref.attention_ref(*_j(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_dispatch_goes_by_device_and_kernels_reject_cpu_tensors():
    args = _t(*_paged_case(2, 4, 2, 16, 16, 4, seed=1))
    # int8 pools with (P, KV) scales: CPU tensors go to the plain version
    q8 = [torch.zeros(a.shape, dtype=torch.int8) for a in args[1:3]]
    sc = dict(k_scale=torch.ones(args[1].shape[0], 2),
              v_scale=torch.ones(args[1].shape[0], 2))
    int8_args = (args[0], *q8, *args[3:])
    assert torch.equal(tops.paged_attention(*int8_args, **sc),
                       tpa.paged_attention_plain(*int8_args, **sc))
    with pytest.raises(ValueError):
        tpa.paged_attention(*int8_args, **sc)
    with pytest.raises(ValueError):
        tpa.paged_attention(*args)
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)
