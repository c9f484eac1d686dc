"""qwen3-14b [dense]: 40 layers, d_model 5120, 40 heads (GQA kv 8),
d_head 128, d_ff 17408, vocab 151936, qk-norm, rope theta 1e6.

Same specs and plans as ``repro/configs/qwen3_14b.py`` (pinned by
tests/test_torch_spec.py).
"""
from repro_torch.models import spec as S
from repro_torch.parallel.plan import ParallelismPlan

OPTIMIZER = ("adam", 3e-4)

PLAN = ParallelismPlan(pp=2, tp=8, microbatches=8, stash_mode="stash",
                       zero1=True, remat=True)
SMOKE_PLAN = ParallelismPlan(pp=2, tp=1, microbatches=2, stash_mode="stash",
                             zero1=False)
# 40 layers = 4 stages x 2 virtual chunks of 5 layers (flush semantics)
INTERLEAVED_PLAN = ParallelismPlan(pp=4, tp=4, microbatches=8,
                                   stash_mode="flush",
                                   schedule="interleaved", virtual_stages=2,
                                   zero1=True, remat=True)


def full_spec() -> S.ModelSpec:
    blocks = tuple(S.BlockSpec(mixer="attn", ffn="dense",
                               window=S.GLOBAL_WINDOW, rope_theta=1e6)
                   for _ in range(40))
    return S.ModelSpec(
        name="qwen3-14b", d_model=5120, n_layers=40, n_heads=40, n_kv=8,
        d_head=128, d_ff=17408, vocab=151936, blocks=blocks,
        norm="rmsnorm", act="silu", qk_norm=True,
        family="dense", subquadratic=False)


def smoke_spec() -> S.ModelSpec:
    blocks = tuple(S.BlockSpec(mixer="attn", ffn="dense", rope_theta=1e6)
                   for _ in range(4))
    return S.ModelSpec(
        name="qwen3-smoke", d_model=64, n_layers=4, n_heads=4, n_kv=2,
        d_head=16, d_ff=128, vocab=256, blocks=blocks,
        norm="rmsnorm", act="silu", qk_norm=True,
        family="dense", subquadratic=False)
