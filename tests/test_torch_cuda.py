"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA card (a
CUDA kernel has no CPU mode).  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The shapes mirror tests/test_kernels.py's PAGED_CASES, FLASH_CASES,
WKV_CASES and MAMBA_CASES, and tests/test_quant.py's int8 paged matrix
(FLASH_BWD: the flash backward at the smoke, GQA and training shapes,
and Dh 120; PAGED and FLASH also at h2o-danube3-4b's Dh 120);
inputs come from a seeded numpy generator, NaN sits in unreferenced
pages and past each row's length (int8 pools: random payloads and NaN /
inf scales in unreferenced pages).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import wkv6 as twkv
from repro_torch.quant import quantize_kv_page_batched

PAGED = [  # b, h, kv, dh, page, n_pages, window
    (2, 4, 2, 64, 16, 8, -1), (3, 4, 4, 32, 16, 4, -1),
    (2, 8, 2, 64, 64, 4, -1), (2, 4, 1, 32, 16, 8, -1),
    (2, 4, 2, 64, 16, 8, 20), (1, 2, 2, 16, 64, 2, 48),
    (2, 40, 8, 128, 16, 64, -1),                       # qwen3-14b decode
    (2, 40, 8, 128, 16, 256, -1),       # 2 x 4096 keys: many pages a split
    (1, 32, 8, 120, 16, 512, 4096),     # h2o-danube3-4b decode, Dh 120
    # gemma3-4b's heads (G 2, Dh 256: two 128-column strides), global and
    # with its 1024-token window over 2048 keys
    (2, 8, 4, 256, 16, 16, -1), (2, 8, 4, 256, 16, 128, 1024)]
FLASH = [  # b, sq, sk, h, kv, dh, causal, window
    (2, 256, 256, 4, 2, 64, True, -1), (1, 128, 128, 4, 4, 64, True, 32),
    (2, 100, 100, 2, 1, 32, True, -1), (1, 256, 256, 8, 2, 128, False, -1),
    (1, 64, 192, 2, 2, 16, True, 48), (1, 192, 192, 2, 2, 64, True, 200),
    (2, 64, 64, 4, 1, 8, True, 1), (2, 528, 528, 40, 8, 128, True, -1),
    # Sq off the 64- and 128-row tiles; Dh 8 and 16 zero-padded in the
    # bf16 kernel; windows that cross key-tile edges; the main shape
    (1, 77, 77, 4, 2, 64, True, -1), (2, 200, 200, 4, 1, 128, True, -1),
    (1, 529, 529, 8, 2, 128, True, -1), (1, 77, 130, 2, 2, 16, False, -1),
    (2, 200, 200, 2, 1, 8, True, 70), (1, 300, 300, 4, 2, 64, True, 100),
    (1, 529, 529, 4, 1, 128, True, 129), (8, 528, 528, 40, 8, 128, True, -1),
    # h2o-danube3-4b's heads (Dh 120, zero-padded to 128 in bf16) with a
    # window that crosses key tiles
    (1, 700, 700, 32, 8, 120, True, 300),
    # qwen3-14b's heads on a tensor rank at tp 2 and tp 8 (training)
    (1, 256, 256, 20, 4, 128, True, -1), (1, 256, 256, 5, 1, 128, True, -1),
    # gemma3-4b's heads (8 / 4, Dh 256: each CTA one 128-column half of
    # O), global and windowed, off the tiles; Dh 200 and 136 zero-padded
    # to 256; the windowed training call
    (1, 300, 300, 8, 4, 256, True, -1), (1, 333, 333, 8, 4, 256, True, 64),
    (2, 77, 130, 2, 2, 256, False, -1), (2, 200, 200, 4, 2, 200, True, -1),
    (1, 129, 129, 2, 1, 136, True, 50),
    (1, 4096, 4096, 8, 4, 256, True, 1024)]
PAGED_INT8 = [  # b, h, kv, dh, page, n_pages, window: tests/test_quant.py's
               # int8 matrix, then qwen3-14b decode, global and windowed,
               # then h2o-danube3-4b's heads (120-byte rows: 8-byte chunks)
    (2, 4, 2, 64, 16, 8, -1), (2, 8, 2, 64, 64, 4, -1),
    (2, 4, 2, 64, 16, 8, 20), (2, 40, 8, 128, 16, 64, -1),
    (2, 40, 8, 128, 16, 64, 100), (2, 32, 8, 120, 16, 64, -1),
    (2, 32, 8, 120, 16, 64, 100),
    # gemma3-4b's heads (256-byte int8 rows), global and windowed
    (2, 8, 4, 256, 16, 16, -1), (2, 8, 4, 256, 16, 128, 1024)]
WKV = [  # b, s, h, dh
    (2, 64, 2, 16), (1, 128, 4, 32), (2, 100, 2, 8), (1, 64, 2, 64),
    (1, 32, 1, 4), (2, 17, 2, 32), (8, 1, 32, 64),       # rwkv6 decode
    (8, 1024, 32, 64),                                  # rwkv6 prefill
    # the chunked design's edge (bf16): one chunk less a token (stepwise),
    # one chunk, one chunk and a token (a ragged chunk and stage)
    (8, 15, 32, 64), (8, 16, 32, 64), (8, 17, 32, 64)]
MAMBA = [  # b, s, ci, n: S not a multiple of the 64-token stage or of the
           # 8-token batch, Ci not a multiple of the 64-channel block
    (2, 64, 32, 8), (1, 128, 64, 16), (2, 100, 48, 4), (1, 48, 512, 16),
    (3, 77, 200, 16), (1, 1, 130, 8), (2, 1, 8192, 16),    # jamba decode
    (2, 1024, 8192, 16),                                  # jamba prefill
    # a partial last block; rows not 16-byte aligned (plain copies)
    (2, 130, 100, 16), (1, 33, 50, 8), (2, 70, 33, 4), (1, 200, 1000, 16)]
FLASH_BWD = [  # b, s, h, kv, dh, window (causal; Sq = Sk)
    (2, 16, 4, 2, 16, -1),                  # the qwen3 smoke spec's call
    (2, 77, 4, 2, 64, -1), (1, 130, 4, 1, 64, 20), (2, 200, 6, 3, 128, -1),
    (1, 300, 8, 8, 40, 50), (1, 64, 2, 2, 8, 1), (1, 129, 5, 1, 128, 65),
    (1, 1024, 40, 8, 128, -1), (1, 1000, 40, 8, 128, 256),
    # Dh 120 zero-padded to 128 in the bf16 kernels; the training shape
    (2, 300, 10, 2, 120, -1), (1, 333, 6, 2, 120, 100),
    (1, 4096, 40, 8, 128, -1),
    # qwen3-14b's heads on a tensor rank at tp 2 and tp 8 (training)
    (1, 256, 20, 4, 128, -1), (1, 256, 5, 1, 128, -1),
    # gemma3-4b's heads (8 / 4, Dh 256: the column-split bf16 kernels,
    # the f32 kernels' two column passes), global and windowed, ragged;
    # Dh 136 and 200 zero-padded to 256; the training calls
    (1, 300, 8, 4, 256, -1), (1, 333, 8, 4, 256, 100),
    (2, 130, 4, 2, 136, -1), (1, 200, 4, 1, 200, 64),
    (1, 4096, 8, 4, 256, -1), (1, 4096, 8, 4, 256, 1024)]
WKV_BWD = [  # b, s, h, dh: every head size, ragged chunks, the training call
    (2, 37, 3, 4), (2, 37, 3, 8), (1, 50, 2, 16), (2, 33, 2, 32),
    (1, 100, 3, 64), (2, 16, 2, 64), (1, 1, 2, 64), (1, 4096, 32, 64),
    # the 64-token chunk and 8-token sub-chunk of the kernel's passes:
    # one chunk less / more a token, below one sub-chunk, B = 3 with
    # several chunks, Dh 32 across a chunk edge
    (1, 63, 2, 64), (1, 65, 2, 64), (2, 7, 2, 64), (3, 200, 2, 64),
    (2, 129, 3, 32)]
MAMBA_BWD = [  # b, s, ci, n: every state size, a partial channel block,
               # ragged chunks, the training call
    (2, 37, 100, 4), (2, 37, 100, 8), (1, 70, 64, 16), (2, 33, 200, 16),
    (1, 16, 8, 16), (2, 1, 130, 16), (1, 4096, 8192, 16),
    # the 128-token segment and 8-token sub-chunk of the kernel's passes:
    # one segment less / more a token, below one sub-chunk, B = 3 with
    # several segments, a partial channel block at a segment edge
    (1, 127, 64, 16), (1, 129, 64, 16), (2, 5, 70, 8), (3, 600, 70, 16),
    (1, 257, 100, 4)]
TOL = {torch.float32: (2e-5, 1e-3), torch.bfloat16: (2e-2, 1e-2)}
# the backward kernels' gradients against their plain versions: (rel,
# rtol), |err| <= rel · max|plain| + rtol · |plain|: sums over up to S x Dh
# products in another order (chip_smoke.py's WKV6_BWD_TOL)
BWD_TOL = {torch.float32: (1e-5, 1e-3), torch.bfloat16: (1e-2, 1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _paged_args(b, h, kv, dh, page, n_pages, q_len, dtype, device, seed,
                lengths=None):
    rng = np.random.default_rng(seed)
    n_pool = b * n_pages + 3
    q = rng.standard_normal((b, q_len, h, dh))
    kp = rng.standard_normal((n_pool, page, kv, dh))
    vp = rng.standard_normal((n_pool, page, kv, dh))
    if lengths is None:
        lengths = rng.integers(q_len, n_pages * page + 1, b)
    lengths = np.asarray(lengths, np.int32)
    tables = np.full((b, n_pages), -1, np.int32)
    perm, used = rng.permutation(n_pool), 0
    for r in range(b):
        need = -(-int(lengths[r]) // page)
        tables[r, :need] = perm[used:used + need]
        used += need
        kp[tables[r, need - 1], (lengths[r] - 1) % page + 1:] = np.nan
        vp[tables[r, need - 1], (lengths[r] - 1) % page + 1:] = np.nan
    spare = np.setdiff1d(np.arange(n_pool), tables[tables >= 0])
    kp[spare] = vp[spare] = np.nan
    f = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)
    return (f(q), f(kp), f(vp), torch.from_numpy(tables).to(device),
            torch.from_numpy(lengths).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_len", [1, 3, 5])
@pytest.mark.parametrize("b,h,kv,dh,page,n_pages,window", PAGED)
def test_paged_kernel_matches_plain(cuda, b, h, kv, dh, page, n_pages,
                                    window, q_len, dtype):
    args = _paged_args(b, h, kv, dh, page, n_pages, q_len, dtype, cuda,
                       seed=b * h + page + q_len)
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(*args, window=window)
    want = tpa.paged_attention_plain(*args, window=window)
    assert tpa.paged_attention.launches == before + 1
    assert torch.isfinite(got).all()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    # decode form: q (B, H, Dh) gives the query-shaped result back
    if q_len == 1:
        got3 = tpa.paged_attention(args[0][:, 0], *args[1:], window=window)
        assert torch.equal(got3, got[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_len", [1, 5])
def test_paged_kernel_jamba_decode(cuda, q_len, dtype):
    """jamba-v0.1-52b's decode call: 32 / 8 heads, 1040 keys a row in a
    2048-key table (65 of 128 pages live)."""
    args = _paged_args(2, 32, 8, 128, 16, 128, q_len, dtype, cuda, seed=7,
                       lengths=[1040, 1040])
    got = tpa.paged_attention(*args)
    want = tpa.paged_attention_plain(*args)
    atol, rtol = TOL[dtype]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [-1, 40])
def test_paged_kernel_dead_first_half(cuda, window, dtype):
    """Tables whose first half is -1, NaN in the pages those entries
    dropped: the leading splits walk nothing and weigh 0 in the merge."""
    q, kp, vp, tab, lens = _paged_args(2, 8, 2, 64, 16, 16, 1, dtype, cuda,
                                       seed=3, lengths=[256, 200])
    dropped = tab[:, :8][tab[:, :8] >= 0].long()
    kp[dropped] = float("nan")
    vp[dropped] = float("nan")
    tab[:, :8] = -1
    got = tpa.paged_attention(q, kp, vp, tab, lens, window=window)
    want = tpa.paged_attention_plain(q, kp, vp, tab, lens, window=window)
    atol, rtol = TOL[dtype]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _paged_int8_args(b, h, kv, dh, page, n_pages, q_len, dtype, device,
                     seed):
    """q, int8 pools, tables, lengths and (P, KV) scales, plus the f32
    pools they quantize; spare pages hold random int8 payloads and NaN /
    inf scales, garbage the kernel must skip."""
    rng = np.random.default_rng(seed)
    n_pool = b * n_pages + 3
    q = torch.from_numpy(rng.standard_normal((b, q_len, h, dh))).to(
        device=device, dtype=dtype)
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (n_pool, page, kv, dh))).to(device=device, dtype=torch.float32)
        for _ in range(2))
    lengths = rng.integers(q_len, n_pages * page + 1, b).astype(np.int32)
    tables = np.full((b, n_pages), -1, np.int32)
    perm, used = rng.permutation(n_pool), 0
    for r in range(b):
        need = -(-int(lengths[r]) // page)
        tables[r, :need] = perm[used:used + need]
        used += need
    (kq, ks), (vq, vs) = (quantize_kv_page_batched(p) for p in (kp, vp))
    spare = torch.from_numpy(np.setdiff1d(
        np.arange(n_pool), tables[tables >= 0])).to(device)
    for pool in (kq, vq):
        pool[spare] = torch.from_numpy(rng.integers(
            -127, 128, pool[spare].shape).astype(np.int8)).to(device)
    ks[spare], vs[spare] = float("nan"), float("inf")
    tab = torch.from_numpy(tables).to(device)
    lens = torch.from_numpy(lengths).to(device)
    return (q, kq, vq, tab, lens), dict(k_scale=ks, v_scale=vs), (kp, vp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_len", [1, 5])
@pytest.mark.parametrize("b,h,kv,dh,page,n_pages,window", PAGED_INT8)
def test_paged_int8_kernel_matches_plain(cuda, b, h, kv, dh, page, n_pages,
                                         window, q_len, dtype):
    args, scales, (kp, vp) = _paged_int8_args(
        b, h, kv, dh, page, n_pages, q_len, dtype, cuda,
        seed=b * h + page + q_len)
    before = (tpa.paged_attention.launches,
              tpa.paged_attention.launches_int8)
    got = tpa.paged_attention(*args, window=window, **scales)
    want = tpa.paged_attention_plain(*args, window=window, **scales)
    assert (tpa.paged_attention.launches,
            tpa.paged_attention.launches_int8) == (before[0], before[1] + 1)
    assert got.dtype == dtype and torch.isfinite(got).all()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    # within int8 rounding of the unquantized pools (tests/test_quant.py)
    full = tpa.paged_attention_plain(args[0].float(), kp, vp, *args[3:],
                                     window=window)
    torch.testing.assert_close(got.float(), full, atol=0.05, rtol=0.05)


@pytest.mark.cuda
def test_paged_int8_dead_page_garbage_does_not_reach_the_output(cuda):
    args, scales, _ = _paged_int8_args(3, 8, 2, 64, 16, 6, 1,
                                       torch.float32, cuda, seed=4)
    got = tpa.paged_attention(*args, window=20, **scales)
    live = args[3][args[3] >= 0].long()
    spare = torch.ones(args[1].shape[0], dtype=torch.bool, device=cuda)
    spare[live] = False
    clean = [t.clone() for t in (args[1], args[2])]
    for t in clean:
        t[spare] = 0
    sc = {k: v.clone() for k, v in scales.items()}
    for v in sc.values():
        v[spare] = 1.0
    again = tpa.paged_attention(args[0], *clean, *args[3:], window=20, **sc)
    assert torch.isfinite(got).all() and torch.equal(got, again)


@pytest.mark.cuda
def test_paged_int8_rejects_what_it_does_not_take(cuda):
    args, scales, (kp, vp) = _paged_int8_args(2, 4, 2, 64, 16, 4, 1,
                                              torch.float32, cuda, seed=1)
    q, kq, vq, tab, lens = args
    ks, vs = scales["k_scale"], scales["v_scale"]
    with pytest.raises(ValueError):            # one scale plane only
        tpa.paged_attention(*args, k_scale=ks)
    with pytest.raises(TypeError):             # int8 pools without scales
        tpa.paged_attention(*args)
    with pytest.raises(TypeError):             # scales with float pools
        tpa.paged_attention(q, kp, vp, tab, lens, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError):            # (P, KV) shape
        tpa.paged_attention(*args, k_scale=ks[:, :1].contiguous(),
                            v_scale=vs)
    with pytest.raises(ValueError):            # f32 scales
        tpa.paged_attention(*args, k_scale=ks.double(), v_scale=vs)
    with pytest.raises(ValueError):            # scales on the card
        tpa.paged_attention(*args, k_scale=ks.cpu(), v_scale=vs)
    with pytest.raises(TypeError):             # both pools int8
        tpa.paged_attention(q, kq, vp, tab, lens, **scales)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window", FLASH)
def test_flash_kernel_matches_plain(cuda, b, sq, sk, h, kv, dh, causal,
                                    window, dtype):
    rng = np.random.default_rng(sq * h + dh)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).to(cuda, dtype)
               for s in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert tfa.flash_attention.launches == before + 1
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(2, 8, 4, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros(2, 8, 4, 16, device=cuda)
    with pytest.raises(ValueError):
        tfa.flash_attention(q.transpose(1, 2), q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q[:, :, :3].contiguous(),
                            q[:, :, :3].contiguous())
    for dh in (12, 264):   # the bf16 kernel: Dh a multiple of 8 up to 256
        q = torch.zeros(1, 8, 2, dh, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            tfa.flash_attention(q, q, q)


def _wkv_args(b, s, h, dh, dtype, device, seed, decay=None):
    rng = np.random.default_rng(seed)
    shape = (b, s, h, dh)
    w = (0.5 / (1 + np.exp(-rng.standard_normal(shape))) + 0.49
         if decay is None else np.full(shape, decay))
    arrs = (rng.standard_normal(shape), 0.5 * rng.standard_normal(shape),
            rng.standard_normal(shape), w, 0.1 * rng.standard_normal((h, dh)))
    f = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)
    s0 = torch.from_numpy(rng.standard_normal((b, h, dh, dh))).to(
        device=device, dtype=torch.float32)
    return [f(a) for a in arrs], s0


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,dh", WKV)
def test_wkv6_kernel_matches_plain(cuda, b, s, h, dh, dtype, with_state):
    args, s0 = _wkv_args(b, s, h, dh, dtype, cuda, seed=s * h + dh)
    before = twkv.wkv6.launches
    design = twkv.design(s, dh, dtype)
    counter = f"launches_{design}"
    before_design = getattr(twkv.wkv6, counter)
    got_s0 = s0.clone() if with_state else None
    y, s_last = twkv.wkv6(*args, got_s0)
    assert twkv.wkv6.launches == before + 1
    assert getattr(twkv.wkv6, counter) == before_design + 1
    assert design == ("chunked" if dtype == torch.bfloat16 and s >= 16
                      and dh in (16, 32, 64) else "stepwise")
    if with_state:
        assert s_last is got_s0        # advanced in place
    want_y, want_s = twkv.wkv6_plain(*args, s0.clone() if with_state
                                     else None)
    atol, rtol = TOL[dtype]
    assert torch.isfinite(y).all() and torch.isfinite(s_last).all()
    torch.testing.assert_close(y.float(), want_y.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(s_last, want_s, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [0.5, 0.4, 1e-8])
def test_wkv6_kernel_stays_finite_at_strong_decay(cuda, decay):
    """Constant strong decay over 256 steps from a state, where the
    chunked TPU form overflows f32: finite, and equal to the plain
    version."""
    args, s0 = _wkv_args(2, 256, 4, 64, torch.float32, cuda, seed=3,
                         decay=decay)
    y, s_last = twkv.wkv6(*args, s0.clone())
    want_y, want_s = twkv.wkv6_plain(*args, s0.clone())
    assert torch.isfinite(y).all() and torch.isfinite(s_last).all()
    atol, rtol = TOL[torch.float32]
    torch.testing.assert_close(y, want_y, atol=atol, rtol=rtol)
    torch.testing.assert_close(s_last, want_s, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [0.5, 1e-8])
def test_wkv6_chunked_kernel_stays_finite_at_strong_decay(cuda, decay):
    """The bf16 chunked design at constant strong decay over 1024 tokens
    from a state (64 chunks of 16): every decay factor it forms is a
    product of w <= 1, so it stays finite where the TPU kernel's chunked
    form overflows f32, and equals the plain version."""
    args, s0 = _wkv_args(2, 1024, 8, 64, torch.bfloat16, cuda, seed=5,
                         decay=decay)
    before = twkv.wkv6.launches_chunked
    y, s_last = twkv.wkv6(*args, s0.clone())
    assert twkv.wkv6.launches_chunked == before + 1
    want_y, want_s = twkv.wkv6_plain(*args, s0.clone())
    assert torch.isfinite(y).all() and torch.isfinite(s_last).all()
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), want_y.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(s_last, want_s, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_wkv6_chunked_kernel_continues_a_state_in_place(cuda):
    """A bf16 prefill split into three calls, each on the chunked design
    and each continuing the state in place, equals one pass (up to the
    bf16 rounding of y, whose f32 sums run in another order)."""
    args, s0 = _wkv_args(2, 150, 4, 64, torch.bfloat16, cuda, seed=6)
    y_all, s_all = twkv.wkv6(*args, s0.clone())
    state = s0.clone()
    ys = []
    for lo, hi in ((0, 70), (70, 100), (100, 150)):
        y, s_last = twkv.wkv6(*(a[:, lo:hi].contiguous() for a in args[:4]),
                              args[4], state)
        assert s_last is state
        ys.append(y)
    torch.cuda.synchronize()
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(torch.cat(ys, dim=1).float(), y_all.float(),
                               atol=atol, rtol=rtol)
    torch.testing.assert_close(state, s_all, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
def test_wkv6_kernel_rejects_what_it_does_not_take(cuda):
    args, s0 = _wkv_args(1, 2, 2, 8, torch.float32, cuda, seed=1)
    with pytest.raises(TypeError):                      # mixed dtypes
        twkv.wkv6(*args[:4], args[4].to(torch.bfloat16))
    with pytest.raises(TypeError):                      # bf16 state
        twkv.wkv6(*args, s0.to(torch.bfloat16))
    with pytest.raises(ValueError):                     # not contiguous
        twkv.wkv6(*(a.transpose(1, 2) for a in args[:4]), args[4])
    with pytest.raises(ValueError):                     # Dh 6
        twkv.wkv6(*(a[..., :6].contiguous() for a in args[:4]),
                  args[4][:, :6].contiguous())


def _mamba_args(b, s, ci, n, dtype, device, seed):
    """u, dt (softplus of a normal, x0.3), B, C in ``dtype``; A = -exp of
    a normal x0.3 and D f32; an f32 start state."""
    rng = np.random.default_rng(seed)
    f = lambda a, dt=dtype: torch.from_numpy(np.asarray(a, np.float32)).to(
        device=device, dtype=dt)
    u = f(rng.standard_normal((b, s, ci)))
    dt = f(0.3 * np.log1p(np.exp(rng.standard_normal((b, s, ci)))))
    A = f(-np.exp(0.3 * rng.standard_normal((ci, n))), torch.float32)
    B = f(rng.standard_normal((b, s, n)))
    C = f(rng.standard_normal((b, s, n)))
    D = f(rng.standard_normal(ci), torch.float32)
    h0 = f(rng.standard_normal((b, ci, n)), torch.float32)
    return [u, dt, A, B, C, D], h0


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,ci,n", MAMBA)
def test_mamba_scan_kernel_matches_plain(cuda, b, s, ci, n, dtype,
                                         with_state):
    args, h0 = _mamba_args(b, s, ci, n, dtype, cuda, seed=s * ci + n)
    before = tms.mamba_scan.launches
    got_h0 = h0.clone() if with_state else None
    y, h_last = tms.mamba_scan(*args, got_h0)
    assert tms.mamba_scan.launches == before + 1
    if with_state:
        assert h_last is got_h0        # advanced in place
    want_y, want_h = tms.mamba_scan_plain(*args, h0.clone() if with_state
                                          else None)
    torch.cuda.synchronize()
    assert y.dtype == dtype and h_last.dtype == torch.float32
    atol, rtol = TOL[dtype]
    assert torch.isfinite(y).all() and torch.isfinite(h_last).all()
    torch.testing.assert_close(y.float(), want_y.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(h_last, want_h, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_mamba_scan_kernel_continues_a_state_in_place(cuda):
    """A prefill split into a prefix, three one-token decode steps and the
    rest, each continuing the state in place, equals one pass."""
    args, h0 = _mamba_args(2, 150, 300, 16, torch.float32, cuda, seed=4)
    y_all, h_all = tms.mamba_scan(*args, h0.clone())
    u, dt, A, B, C, D = args
    state = h0.clone()
    ys = []
    for lo, hi in ((0, 70), (70, 71), (71, 72), (72, 73), (73, 150)):
        y, h = tms.mamba_scan(u[:, lo:hi].contiguous(),
                              dt[:, lo:hi].contiguous(), A,
                              B[:, lo:hi].contiguous(),
                              C[:, lo:hi].contiguous(), D, state)
        assert h is state
        ys.append(y)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat(ys, dim=1), y_all, atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(state, h_all, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 70])
def test_mamba_scan_kernel_takes_unaligned_rows(cuda, s, dtype):
    """u, dt, B, C and the state one element past a 16-byte boundary
    (contiguous views into a larger buffer): the kernel stages them by
    plain copies (prefill) or scalar loads (decode) and equals the plain
    version as with aligned inputs."""
    args, h0 = _mamba_args(2, s, 96, 16, dtype, cuda, seed=9)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    u, dt, A, B, C, D = args
    moved = [shifted(u), shifted(dt), A, shifted(B), shifted(C), D]
    assert all(t.data_ptr() % 16 for t in (moved[0], moved[3]))
    got_h0 = shifted(h0)
    y, h_last = tms.mamba_scan(*moved, got_h0)
    assert h_last is got_h0
    want_y, want_h = tms.mamba_scan_plain(*args, h0.clone())
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(h_last, want_h, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_mamba_scan_kernel_rejects_what_it_does_not_take(cuda):
    args, h0 = _mamba_args(2, 4, 8, 4, torch.float32, cuda, seed=1)
    u, dt, A, B, C, D = args
    with pytest.raises(TypeError):                      # mixed dtypes
        tms.mamba_scan(u, dt.to(torch.bfloat16), A, B, C, D)
    with pytest.raises(TypeError):                      # bf16 A
        tms.mamba_scan(u, dt, A.to(torch.bfloat16), B, C, D)
    with pytest.raises(TypeError):                      # bf16 state
        tms.mamba_scan(*args, h0.to(torch.bfloat16))
    with pytest.raises(ValueError):                     # not contiguous
        tms.mamba_scan(u.transpose(0, 1), dt.transpose(0, 1), A,
                       B.transpose(0, 1), C.transpose(0, 1), D)
    with pytest.raises(ValueError):                     # N 3
        tms.mamba_scan(u, dt, A[:, :3].contiguous(),
                       B[..., :3].contiguous(), C[..., :3].contiguous(), D)
    with pytest.raises(ValueError):                     # CPU state
        tms.mamba_scan(*args, h0.cpu())


def _to(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


@pytest.mark.cuda
@pytest.mark.parametrize("w,kv,page", [("int8", "int8", 16),
                                       ("fp8", "bf16", 0)])
def test_quantized_engine_on_the_card_matches_the_cpu(cuda, w, kv, page):
    """The qwen3 smoke spec in fp32 with quantized storage: the session
    on the card (the int8 page walk, fp8 gathers and dequantization on
    the card) against the same weights served on the CPU.  Tokens and
    positions equal; hidden states within half an int8 step of their
    largest magnitude, as in ``chip_smoke.py``'s quantized consistency
    phase (a payload one step apart moves a later layer's input)."""
    from repro_torch import configs
    from repro_torch.serving.engine import build_serving
    cfg = configs.get("qwen3-14b")
    kw = dict(cache_len=32, global_batch=4, compute_dtype=torch.float32,
              page_size=page, weight_dtype=w, kv_dtype=kv)
    plan = cfg.SMOKE_PLAN.with_(tp=1, decode_microbatches=2)
    card = build_serving(cfg.smoke_spec(), plan, device=cuda, **kw).start(3)
    host = build_serving(cfg.smoke_spec(), plan, device="cpu", **kw
                         ).reset_state()
    host.set_params(_to(card.params, "cpu"))
    prompts = np.random.default_rng(0).integers(1, 256, (2, 2, 12))
    runs = []
    for sess in (card, host):
        nxt = sess.prefill({"tokens": prompts})
        toks, hs = [nxt.cpu()], [sess.last_hidden.cpu()]
        for _ in range(6):
            nxt = sess.decode(nxt)
            toks.append(nxt.cpu())
            hs.append(sess.last_hidden.cpu())
        runs.append((torch.stack(toks), hs))
    assert torch.equal(runs[0][0], runs[1][0])
    assert (card._pos == host._pos).all()
    tol = max(h.abs().max().item() for h in runs[1][1]) / 254
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)
    if page:
        assert card.pages["layer_0"][0].dtype == torch.int8
    else:
        assert card.cache["layer_0"]["kv"][0].dtype == torch.bfloat16
        assert card.params["head"]["q"].dtype == torch.float8_e4m3fn


def _flash_bwd_args(b, s, h, kv, dh, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(sh)).to(device, dtype)
            for sh in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh),
                       (b, s, h, dh))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,dh,window", FLASH_BWD)
def test_flash_bwd_kernel_matches_plain(cuda, b, s, h, kv, dh, window,
                                        dtype):
    """dQ, dK and dV (dK / dV summed over each KV head's query heads) and
    the forward's lse against the plain versions on the same inputs."""
    q, k, v, do = _flash_bwd_args(b, s, h, kv, dh, dtype, cuda, s * h + dh)
    out, lse = tfa.flash_attention(q, k, v, window=window, return_lse=True)
    _, lse_plain = tfa.flash_attention_plain(q, k, v, window=window,
                                             return_lse=True)
    before = tfa.flash_attention_bwd.launches
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         window=window)
    assert tfa.flash_attention_bwd.launches == before + 1
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(lse, lse_plain, atol=atol, rtol=rtol)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,dh", [(40, 8, 128), (8, 4, 256)])
def test_flash_bwd_kernel_is_deterministic(cuda, h, kv, dh, dtype):
    q, k, v, do = _flash_bwd_args(1, 1000, h, kv, dh, dtype, cuda, 7)
    out, lse = tfa.flash_attention(q, k, v, window=256, return_lse=True)
    runs = [tfa.flash_attention_bwd(q, k, v, out, lse, do, window=256)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_flash_kernels_refuse_dh_past_256(cuda):
    """Past Dh 256 the bf16 forward and both backwards raise before any
    launch; the f32 forward takes any Dh whose tiles fit."""
    args = _flash_bwd_args(1, 64, 2, 1, 264, torch.float32, cuda, 9)
    out, lse = tfa.flash_attention(*args[:3], return_lse=True)
    f0, b0 = tfa.flash_attention.launches, tfa.flash_attention_bwd.launches
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (t.to(dtype) for t in args)
        with pytest.raises(ValueError, match="up to 256"):
            tfa.flash_attention_bwd(q, k, v, out.to(dtype), lse, do)
    with pytest.raises(ValueError, match="up to 256"):
        tfa.flash_attention(*(t.to(torch.bfloat16) for t in args[:3]))
    assert (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches) \
        == (f0, b0)


@pytest.mark.cuda
def test_flash_bwd_bf16_takes_dh_a_multiple_of_8(cuda):
    """The bf16 backward (tensor cores, 16-byte rows) raises for a Dh that
    is not a multiple of 8, as the bf16 forward does; f32 takes it."""
    args = _flash_bwd_args(1, 70, 4, 2, 20, torch.float32, cuda, 5)
    out, lse = tfa.flash_attention(*args[:3], return_lse=True)
    got = tfa.flash_attention_bwd(*args[:3], out, lse, args[3])
    want = tfa.flash_attention_bwd_plain(*args[:3], out, lse, args[3])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-3)
    q, k, v, do = (t.to(torch.bfloat16) for t in args)
    before = tfa.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        tfa.flash_attention_bwd(q, k, v, out.to(torch.bfloat16), lse, do)
    assert tfa.flash_attention_bwd.launches == before


@pytest.mark.cuda
def test_flash_autograd_on_the_card_runs_both_kernels(cuda):
    """ops.flash_attention under autograd: the forward kernel with its
    lse, then the backward kernel; the gradient equals autograd of the
    plain forward (f32)."""
    from repro_torch.kernels import ops
    q, k, v, do = _flash_bwd_args(2, 100, 4, 2, 32, torch.float32, cuda, 3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = tfa.flash_attention.launches, tfa.flash_attention_bwd.launches
    out = ops.flash_attention(*leaves, window=30)
    got = torch.autograd.grad(out, leaves, do)
    assert (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches) \
        == (f0 + 1, b0 + 1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        tfa.flash_attention_plain(*leaves, window=30), leaves, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-3)


@pytest.mark.cuda
def test_kernels_without_a_backward_raise_under_grad(cuda):
    """The paged walk has no backward, and the wkv6 and mamba_scan launch
    wrappers record none (training goes through their Functions): under
    autograd on the card they raise instead of losing the gradient; with
    grad off they run."""
    from repro_torch.kernels import ops
    (r, k, v, w, u), _ = _wkv_args(1, 8, 2, 16, torch.float32, cuda, 0)
    with pytest.raises(RuntimeError, match="records no backward.*WKV6"):
        twkv.wkv6(r.requires_grad_(), k, v, w, u)
    with torch.no_grad():
        ops.wkv6(r, k, v, w, u)
    rng = np.random.default_rng(0)
    f = lambda *sh: torch.from_numpy(                            # noqa: E731
        rng.standard_normal(sh).astype(np.float32)).to(cuda)
    u_, dt, A, B, C, D = f(1, 8, 16), f(1, 8, 16).abs(), -f(16, 4).abs(), \
        f(1, 8, 4), f(1, 8, 4), f(16)
    with pytest.raises(RuntimeError, match="records no backward.*MambaScan"):
        tms.mamba_scan(u_.requires_grad_(), dt, A, B, C, D)
    q, kp, vp, tab, lens = _paged_args(2, 4, 2, 16, 16, 2, 1, torch.float32,
                                       cuda, 0)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.paged_attention(q.requires_grad_(), kp, vp, tab, lens)


def _bwd_close(got, want, dtype):
    rel, rtol = BWD_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.isfinite(g).all()
        scale = w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), atol=rel * scale,
                                   rtol=rtol)


def _wkv_bwd_args(b, s, h, dh, dtype, device, seed, decay=None):
    (r, k, v, w, u), _ = _wkv_args(b, s, h, dh, dtype, device, seed, decay)
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.standard_normal((b, s, h, dh))).to(
        device=device, dtype=dtype)
    return [r, k, v, w, u, dy]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,dh", WKV_BWD)
def test_wkv6_bwd_kernel_matches_plain(cuda, b, s, h, dh, dtype):
    args = _wkv_bwd_args(b, s, h, dh, dtype, cuda, seed=s + dh)
    before = twkv.wkv6_bwd.launches
    got = twkv.wkv6_bwd(*args)
    assert twkv.wkv6_bwd.launches == before + 1
    _bwd_close(got, twkv.wkv6_bwd_plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [1e-3, 1e-8, 0.0])
def test_wkv6_bwd_kernel_at_strong_decay_and_zero(cuda, decay):
    """Constant strong decay, and w = 0 (a bf16 decay that underflowed:
    a d(log w) / w form is 0 / 0): finite and equal to the plain
    backward, and deterministic."""
    for dtype in (torch.float32, torch.bfloat16):
        args = _wkv_bwd_args(2, 200, 4, 64, dtype, cuda, seed=9, decay=decay)
        got = twkv.wkv6_bwd(*args)
        _bwd_close(got, twkv.wkv6_bwd_plain(*args), dtype)
        assert all(torch.equal(a, b) for a, b in
                   zip(got, twkv.wkv6_bwd(*args)))


@pytest.mark.cuda
def test_wkv6_bwd_kernel_is_deterministic_at_the_model_decays(cuda):
    """bf16 at the model's range of decays at the rwkv6 training call's
    heads: two calls on one input are bit-identical (every sum across
    threads and blocks runs in a fixed order, no atomics)."""
    args = _wkv_bwd_args(1, 1000, 32, 64, torch.bfloat16, cuda, seed=13)
    runs = [twkv.wkv6_bwd(*args) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _mamba_bwd_args(b, s, ci, n, dtype, device, seed):
    args, _ = _mamba_args(b, s, ci, n, dtype, device, seed)
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.standard_normal((b, s, ci)).astype(
        np.float32)).to(device=device, dtype=dtype)
    return args + [dy]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,ci,n", MAMBA_BWD)
def test_mamba_scan_bwd_kernel_matches_plain(cuda, b, s, ci, n, dtype):
    args = _mamba_bwd_args(b, s, ci, n, dtype, cuda, seed=s * n + ci)
    before = tms.mamba_scan_bwd.launches
    got = tms.mamba_scan_bwd(*args)
    assert tms.mamba_scan_bwd.launches == before + 1
    _bwd_close(got, tms.mamba_scan_bwd_plain(*args), dtype)
    assert all(torch.equal(a, b) for a, b in
               zip(got, tms.mamba_scan_bwd(*args)))


@pytest.mark.cuda
def test_recurrent_autograd_on_the_card_runs_both_kernels(cuda):
    """ops.wkv6 and ops.mamba_scan under autograd: the forward kernel,
    then the backward kernel; the gradients equal autograd of the plain
    forwards (f32)."""
    from repro_torch.kernels import ops
    args = _wkv_bwd_args(2, 50, 2, 32, torch.float32, cuda, seed=5)
    leaves = [t.clone().requires_grad_() for t in args[:5]]
    f0, b0 = twkv.wkv6.launches, twkv.wkv6_bwd.launches
    got = torch.autograd.grad(ops.wkv6(*leaves)[0], leaves, args[5])
    assert (twkv.wkv6.launches, twkv.wkv6_bwd.launches) == (f0 + 1, b0 + 1)
    leaves = [t.clone().requires_grad_() for t in args[:5]]
    want = torch.autograd.grad(twkv.wkv6_plain(*leaves)[0], leaves, args[5])
    _bwd_close(got, want, torch.float32)
    args = _mamba_bwd_args(2, 50, 100, 16, torch.float32, cuda, seed=6)
    leaves = [t.clone().requires_grad_() for t in args[:6]]
    f0, b0 = tms.mamba_scan.launches, tms.mamba_scan_bwd.launches
    got = torch.autograd.grad(ops.mamba_scan(*leaves)[0], leaves, args[6])
    assert (tms.mamba_scan.launches, tms.mamba_scan_bwd.launches) == \
        (f0 + 1, b0 + 1)
    leaves = [t.clone().requires_grad_() for t in args[:6]]
    want = torch.autograd.grad(tms.mamba_scan_plain(*leaves)[0], leaves,
                               args[6])
    _bwd_close(got, want, torch.float32)
    with pytest.raises(ValueError, match="start state under autograd"):
        ops.mamba_scan(*leaves, torch.zeros(2, 100, 16, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["stash", "vertical", "flush", "2bw"])
def test_training_on_the_card_matches_the_cpu(cuda, mode):
    """Two rounds of the qwen3 smoke spec in fp32 (pp 2, R 4, seq 16,
    SGD with momentum) on the card (both flash kernels) and on the CPU
    (the plain versions), from one state: losses and parameters within
    atol 2e-5."""
    _train_card_vs_cpu(cuda, "qwen3-14b", mode)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mode", [("rwkv6-1.6b", "stash"),
                                       ("jamba-v0.1-52b", "flush")])
def test_recurrent_training_on_the_card_matches_the_cpu(cuda, arch, mode):
    """The same for rwkv6's and jamba's smoke specs in their configs'
    modes: on the card every WKV / selective scan runs its forward and
    backward kernels."""
    _train_card_vs_cpu(cuda, arch, mode)


def _train_card_vs_cpu(cuda, arch, mode):
    from repro_torch import configs
    from repro_torch.core.pipeline import build_pipeline
    from repro_torch.data.pipeline import Loader, SyntheticLM
    from repro_torch.optim import SGDM
    cfg = configs.get(arch)
    spec = cfg.smoke_spec()
    plan = cfg.SMOKE_PLAN.with_(microbatches=4, stash_mode=mode)
    init = None
    runs = []
    for dev in (torch.device("cpu"), cuda):
        bundle = build_pipeline(spec, plan, seq_len=16, global_batch=8,
                                optimizer=SGDM(lr=0.05),
                                compute_dtype=torch.float32, device=dev)
        if init is None:
            init = bundle.init_state(torch.Generator().manual_seed(0))
        state = _copy(init, dev)      # the executor writes it in place
        state["stash"]["current"] = state["params"]["stages"]
        loader = Loader(SyntheticLM(spec.vocab, 16), 4, 2, dev)
        losses = []
        for r in range(2):
            state, m = bundle.train_step(state, loader.get(r))
            losses.append(float(m["loss"]))
        runs.append((losses, _to(state["params"], "cpu")))
    (l_cpu, p_cpu), (l_card, p_card) = runs
    np.testing.assert_allclose(l_card, l_cpu, atol=2e-5, rtol=0)
    for a, b in zip(_leaves(p_card), _leaves(p_cpu)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-3)


def _copy(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _copy(v, device) for k, v in tree.items()}
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree] if torch.is_tensor(tree) else []
