"""The launch tools on the card: the Prefetcher's side-stream copies and
the op count of a step (``repro_torch/data/pipeline.py``,
``repro_torch/launch/op_analysis.py``).

Every test here is marked ``cuda`` and skips without an NVIDIA card.  The
file imports neither JAX nor the JAX package: it holds the card against
the CPU.  Run on the card with
``python -m pytest -m cuda tests/test_torch_cuda_launch.py``.
"""
import pytest
import torch

from repro_torch.data.pipeline import Prefetcher
from repro_torch.launch.cell import build_cell
from repro_torch.launch.op_analysis import count
from repro_torch.launch.train import make_loader

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _smoke_cell(device):
    return build_cell("qwen3-14b", "train_4k", smoke=True, seq_len=64,
                      global_batch=4, device=device)


def test_prefetched_rounds_equal_the_loaders(cuda):
    cell = _smoke_cell(cuda)
    loader = make_loader(cell.spec, cell.bundle, 0)
    p = Prefetcher(loader, start_step=2, prefetch=2)
    try:
        for step in range(2, 6):
            got = next(p)
            want = loader.get(step)
            assert all(t.is_cuda for t in got.values())
            for k in want:
                assert torch.equal(got[k], want[k])
    finally:
        p.stop()


def test_card_counts_what_the_cpu_counts(cuda):
    card, cpu = count(_smoke_cell(cuda).run), count(_smoke_cell("cpu").run)
    assert card.flops == cpu.flops > 0
    assert card.kernel_calls == cpu.kernel_calls
    assert card.hbm_bytes == pytest.approx(cpu.hbm_bytes, rel=0.01)
