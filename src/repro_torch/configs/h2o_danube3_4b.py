"""h2o-danube-3-4b [dense]: 24 layers, d_model 3840, 32 heads (GQA kv 8),
d_head 120, d_ff 10240, vocab 32000, a 4096-token sliding window on
every layer, rope theta 5e5.

Same specs and plans as ``repro/configs/h2o_danube3_4b.py`` (pinned by
tests/test_torch_danube3.py).  Every layer is windowed, so a decode-only
session keeps its KV in ring buffers of the window's length
(``core/schedule.py::default_cache_lens``).
"""
from repro_torch.models import spec as S
from repro_torch.parallel.plan import ParallelismPlan

OPTIMIZER = ("adam", 3e-4)

SWA_WINDOW = 4096

PLAN = ParallelismPlan(pp=8, tp=2, microbatches=16, stash_mode="stash",
                       zero1=True, remat=True)
SMOKE_PLAN = ParallelismPlan(pp=2, tp=1, microbatches=2, stash_mode="stash",
                             zero1=False)


def full_spec() -> S.ModelSpec:
    blocks = tuple(S.BlockSpec(mixer="attn", ffn="dense",
                               window=SWA_WINDOW, rope_theta=5e5)
                   for _ in range(24))
    return S.ModelSpec(
        name="h2o-danube-3-4b", d_model=3840, n_layers=24, n_heads=32,
        n_kv=8, d_head=120, d_ff=10240, vocab=32000, blocks=blocks,
        norm="rmsnorm", act="silu",
        family="dense", subquadratic=True)


def smoke_spec() -> S.ModelSpec:
    blocks = tuple(S.BlockSpec(mixer="attn", ffn="dense", window=8)
                   for _ in range(4))
    return S.ModelSpec(
        name="danube3-smoke", d_model=64, n_layers=4, n_heads=4, n_kv=2,
        d_head=16, d_ff=128, vocab=256, blocks=blocks,
        norm="rmsnorm", act="silu",
        family="dense", subquadratic=True)
