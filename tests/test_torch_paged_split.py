"""The paged kernel's split-K arithmetic, in plain PyTorch on the CPU.

The CUDA kernel splits each row's pages into contiguous ranges (one
block a range), writes an f32 partial (m, l, acc) per range and merges
them in a second kernel.  Here the planner, the plain partial walk and
the plain merge are held, split then merged, against the port's
one-pass plain version and against the JAX Pallas kernel in interpret
mode, in fp32 at 1e-6: splitting changes only the order of the sums.
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import paged_attention as tpa
from test_kernels import PAGED_CASES
from test_torch_kernels import _paged_case

TOL = 1e-6


def _ranges(n_pages, per, extra_empty=0):
    """Contiguous page ranges of ``per`` pages, then ``extra_empty``
    ranges past the table (splits with no page at all)."""
    out = [(lo, min(lo + per, n_pages)) for lo in range(0, n_pages, per)]
    return out + [(n_pages, n_pages)] * extra_empty


def _split_merge(args, ranges, window=-1, scales=None):
    q = args[0]
    q4 = q[:, None] if q.dim() == 3 else q
    scales = scales or {}
    parts = [tpa.paged_partial_plain(q4, *args[1:], lo, hi, window=window,
                                     **scales) for lo, hi in ranges]
    m, l, acc = (torch.stack(t, dim=2) for t in zip(*parts))
    out = tpa.combine_splits_plain(m, l, acc, q4.shape[1], q.dtype)
    return (out[:, 0] if q.dim() == 3 else out), m


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("n_pages,batch,n_kv,n_sm", [
    (64, 2, 8, 132), (128, 2, 8, 132), (256, 2, 8, 132), (1, 1, 1, 132),
    (8, 2, 2, 4), (5, 3, 4, 132), (33, 1, 1, 132), (64, 64, 8, 132)])
def test_plan_covers_every_page_once(n_pages, batch, n_kv, n_sm):
    splits, per = tpa.plan_splits(n_pages, batch, n_kv, n_sm)
    seen = np.zeros(n_pages, int)
    for j in range(splits):
        lo, hi = j * per, min((j + 1) * per, n_pages)
        assert lo < hi                     # at least one page a split
        seen[lo:hi] += 1
    assert (seen == 1).all()
    # at least one block per SM where the pages allow it
    assert batch * n_kv * splits >= min(n_sm, batch * n_kv * n_pages)


def test_plan_reads_only_static_quantities():
    params = list(inspect.signature(tpa.plan_splits).parameters)
    assert params == ["n_pages", "batch", "n_kv", "n_sm"]


@pytest.mark.parametrize("n_splits", [1, 2, 3, "more"])
@pytest.mark.parametrize("b,h,kv,dh,page,n_pages,window", PAGED_CASES)
def test_split_merge_matches_plain_and_jax_kernel(b, h, kv, dh, page,
                                                  n_pages, window, n_splits):
    args = _paged_case(b, h, kv, dh, page, n_pages, seed=b * h + page)
    if n_splits == "more":                 # one page a split, then empties
        ranges = _ranges(n_pages, 1, extra_empty=2)
    else:
        ranges = _ranges(n_pages, -(-n_pages // n_splits))
    got, _ = _split_merge(_t(args), ranges, window)
    want = tpa.paged_attention_plain(*_t(args), window=window)
    kernel = np.asarray(jops.paged_attention(*_j(args), window=window))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), kernel, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("q_len,window", [(1, -1), (3, -1), (3, 20),
                                          (5, 9)])
def test_split_merge_multi_query_and_dead_splits(q_len, window):
    """Q > 1 with rows shorter than the table, so the last splits hold no
    live page (m = -inf there), against the plain version and the JAX
    kernel."""
    args = _paged_case(2, 4, 2, 16, 16, 8, seed=21 + q_len, q_len=q_len)
    args[4][:] = [q_len + 3, 40]           # 1 and 3 of 8 pages live
    got, m = _split_merge(_t(args), _ranges(8, 2), window)
    assert (m[:, :, 2:] == -math.inf).all()   # splits 2-3: no live page
    want = tpa.paged_attention_plain(*_t(args), window=window)
    kernel = np.asarray(jops.paged_attention(*_j(args), window=window))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), kernel, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("q_len", [1, 3])
def test_split_merge_window_kills_leading_splits(q_len):
    """A window shorter than a page at a long length: every split but the
    last ones holds no page inside the window."""
    args = _paged_case(2, 4, 2, 32, 16, 8, seed=5, q_len=q_len)
    args[4][:] = [120, 128]
    window = 10
    got, m = _split_merge(_t(args), _ranges(8, 2), window)
    assert (m[:, :, :3] == -math.inf).all()
    want = tpa.paged_attention_plain(*_t(args), window=window)
    kernel = np.asarray(jops.paged_attention(*_j(args), window=window))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), kernel, atol=TOL, rtol=TOL)


def test_split_merge_dead_table_half():
    """A table whose first half is -1 (NaN pages behind the dropped
    entries): the first splits have nothing to walk."""
    q, kp, vp, tables, lengths = _paged_case(2, 4, 2, 16, 16, 8, seed=9)
    rng = np.random.default_rng(9)
    kp, vp = (rng.standard_normal(kp.shape).astype(np.float32)
              for _ in range(2))
    lengths[:] = 128
    tables[:] = np.arange(16).reshape(2, 8)
    kp[tables[:, :4]] = vp[tables[:, :4]] = np.nan
    kp[16:] = vp[16:] = np.nan
    tables[:, :4] = -1
    args = (q, kp, vp, tables, lengths)
    got, m = _split_merge(_t(args), _ranges(8, 2))
    assert (m[:, :, :2] == -math.inf).all()
    want = tpa.paged_attention_plain(*_t(args))
    kernel = np.asarray(jops.paged_attention(*_j(args)))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), kernel, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window", [-1, 20])
def test_split_merge_nan_past_length_contributes_exact_zeros(window):
    """NaN in a live page past a row's length (a page only partly
    written) reaches no split's partial.  Against the plain version only:
    the JAX Pallas kernel forms 0 · NaN there (its oracle does not)."""
    args = _t(_paged_case(3, 4, 2, 32, 16, 4, seed=3, nan_tail=True))
    want = tpa.paged_attention_plain(*args, window=window)
    for per in (1, 2, 3):
        got, _ = _split_merge(args, _ranges(4, per), window)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def _int8_case(q_len, seed):
    """int8 pools with (P, KV) f32 scales; unreferenced pages hold random
    payloads and NaN / inf scales."""
    q, kp, vp, tables, lengths = _paged_case(2, 4, 2, 32, 16, 6, seed=seed,
                                             q_len=q_len)
    rng = np.random.default_rng(seed)
    kq = rng.integers(-127, 128, kp.shape).astype(np.int8)
    vq = rng.integers(-127, 128, vp.shape).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, kp.shape[::2]).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, kp.shape[::2]).astype(np.float32)
    spare = np.setdiff1d(np.arange(kp.shape[0]), tables[tables >= 0])
    ks[spare], vs[spare] = np.nan, np.inf
    return (q, kq, vq, tables, lengths), (ks, vs)


@pytest.mark.parametrize("q_len,window,n_splits", [
    (1, -1, 2), (1, 20, 3), (5, -1, 6), (3, 9, 4)])
def test_split_merge_int8_pools(q_len, window, n_splits):
    args, (ks, vs) = _int8_case(q_len, seed=q_len * 7 + n_splits)
    scales = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    got, _ = _split_merge(_t(args), _ranges(6, -(-6 // n_splits)), window,
                          scales)
    want = tpa.paged_attention_plain(*_t(args), window=window, **scales)
    kernel = np.asarray(jops.paged_attention(
        *_j(args), window=window, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs)))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), kernel, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,h,kv,dh,page,n_pages,window", PAGED_CASES)
def test_planner_split_matches_plain(b, h, kv, dh, page, n_pages, window):
    """The planner's own ranges (small SM counts force several pages a
    split), split then merged, equal the one-pass plain version."""
    args = _t(_paged_case(b, h, kv, dh, page, n_pages, seed=b + page))
    want = tpa.paged_attention_plain(*args, window=window)
    for n_sm in (1, 3, 132):
        splits, per = tpa.plan_splits(n_pages, b, kv, n_sm)
        got, _ = _split_merge(args, _ranges(n_pages, per), window)
        assert len(_ranges(n_pages, per)) == splits
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_merge_of_all_empty_splits_is_zero():
    m = torch.full((1, 1, 3, 2), -math.inf)
    out = tpa.combine_splits_plain(m, torch.zeros(1, 1, 3, 2),
                                   torch.zeros(1, 1, 3, 2, 4), 1,
                                   torch.float32)
    assert torch.equal(out, torch.zeros(1, 1, 2, 4))
