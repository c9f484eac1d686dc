"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA card (a
CUDA kernel has no CPU mode).  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The shapes mirror tests/test_kernels.py's PAGED_CASES and FLASH_CASES;
inputs come from a seeded numpy generator, NaN sits in unreferenced
pages and past each row's length.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import paged_attention as tpa

PAGED = [  # b, h, kv, dh, page, n_pages, window
    (2, 4, 2, 64, 16, 8, -1), (3, 4, 4, 32, 16, 4, -1),
    (2, 8, 2, 64, 64, 4, -1), (2, 4, 1, 32, 16, 8, -1),
    (2, 4, 2, 64, 16, 8, 20), (1, 2, 2, 16, 64, 2, 48),
    (2, 40, 8, 128, 16, 64, -1)]                       # qwen3-14b decode
FLASH = [  # b, sq, sk, h, kv, dh, causal, window
    (2, 256, 256, 4, 2, 64, True, -1), (1, 128, 128, 4, 4, 64, True, 32),
    (2, 100, 100, 2, 1, 32, True, -1), (1, 256, 256, 8, 2, 128, False, -1),
    (1, 64, 192, 2, 2, 16, True, 48), (1, 192, 192, 2, 2, 64, True, 200),
    (2, 64, 64, 4, 1, 8, True, 1), (2, 528, 528, 40, 8, 128, True, -1)]
TOL = {torch.float32: (2e-5, 1e-3), torch.bfloat16: (2e-2, 1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _paged_args(b, h, kv, dh, page, n_pages, q_len, dtype, device, seed):
    rng = np.random.default_rng(seed)
    n_pool = b * n_pages + 3
    q = rng.standard_normal((b, q_len, h, dh))
    kp = rng.standard_normal((n_pool, page, kv, dh))
    vp = rng.standard_normal((n_pool, page, kv, dh))
    lengths = rng.integers(q_len, n_pages * page + 1, b).astype(np.int32)
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
@pytest.mark.parametrize("q_len", [1, 3])
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
