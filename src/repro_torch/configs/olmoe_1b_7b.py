"""olmoe-1b-7b [moe]: 16 layers, d_model 2048, 16 heads (kv 16: MHA) of
128, expert width 1024, vocab 50304, qk-norm; MoE 64 experts top 8.
[arXiv:2409.02060; hf]

6.9 B parameters (13.8 GB in bf16): all 16 layers serve on one card.
Experts shard over the tensor axis; token dispatch is capacity-bounded
and sort-based (models/nn.py::moe).

Same specs and plans as ``repro/configs/olmoe_1b_7b.py`` (pinned by
tests/test_torch_olmoe.py).
"""
from repro_torch.models import spec as S
from repro_torch.parallel.plan import ParallelismPlan

OPTIMIZER = ("adam", 4e-4)

PLAN = ParallelismPlan(pp=4, tp=4, microbatches=8, stash_mode="stash",
                       zero1=True, remat=True)
SMOKE_PLAN = ParallelismPlan(pp=2, tp=1, microbatches=2, stash_mode="stash",
                             zero1=False)
# 16 layers = 4 stages x 2 virtual chunks of 2 layers (flush semantics)
INTERLEAVED_PLAN = ParallelismPlan(pp=4, tp=4, microbatches=8,
                                   stash_mode="flush",
                                   schedule="interleaved", virtual_stages=2,
                                   zero1=True, remat=True)


def full_spec() -> S.ModelSpec:
    blocks = tuple(S.BlockSpec(mixer="attn", ffn="moe") for _ in range(16))
    return S.ModelSpec(
        name="olmoe-1b-7b", d_model=2048, n_layers=16, n_heads=16, n_kv=16,
        d_head=128, d_ff=1024, vocab=50304, blocks=blocks,
        norm="rmsnorm", act="silu", qk_norm=True,
        moe=S.MoESpec(n_experts=64, top_k=8, d_expert=1024),
        family="moe", subquadratic=False)


def smoke_spec() -> S.ModelSpec:
    blocks = tuple(S.BlockSpec(mixer="attn", ffn="moe") for _ in range(4))
    return S.ModelSpec(
        name="olmoe-smoke", d_model=64, n_layers=4, n_heads=4, n_kv=4,
        d_head=16, d_ff=32, vocab=256, blocks=blocks,
        norm="rmsnorm", act="silu", qk_norm=True,
        moe=S.MoESpec(n_experts=8, top_k=2, d_expert=32),
        family="moe", subquadratic=False)
