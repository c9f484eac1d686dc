"""chatglm3-6b [dense]: 28 layers, d_model 4096, 32 heads (GQA kv 2) of
128, d_ff 13696, vocab 65024, 2d (half-rotary) RoPE.
[arXiv:2406.12793; hf]

kv 2 < tp 4: the KV projections are replicated over the tensor axis and
each rank slices its head group (models/init.py::attn_static).

Same specs and plans as ``repro/configs/chatglm3_6b.py`` (pinned by
tests/test_torch_chatglm3.py).
"""
from repro_torch.models import spec as S
from repro_torch.parallel.plan import ParallelismPlan

OPTIMIZER = ("adam", 3e-4)

PLAN = ParallelismPlan(pp=4, tp=4, microbatches=8, stash_mode="stash",
                       zero1=True, remat=True)
SMOKE_PLAN = ParallelismPlan(pp=2, tp=1, microbatches=2, stash_mode="stash",
                             zero1=False)


def full_spec() -> S.ModelSpec:
    blocks = tuple(S.BlockSpec(mixer="attn", ffn="dense", rope_theta=1e4)
                   for _ in range(28))
    return S.ModelSpec(
        name="chatglm3-6b", d_model=4096, n_layers=28, n_heads=32, n_kv=2,
        d_head=128, d_ff=13696, vocab=65024, blocks=blocks,
        norm="rmsnorm", act="silu", rope_2d=True,
        family="dense", subquadratic=False)


def smoke_spec() -> S.ModelSpec:
    blocks = tuple(S.BlockSpec(mixer="attn", ffn="dense") for _ in range(4))
    return S.ModelSpec(
        name="chatglm3-smoke", d_model=64, n_layers=4, n_heads=4, n_kv=2,
        d_head=16, d_ff=128, vocab=256, blocks=blocks,
        norm="rmsnorm", act="silu", rope_2d=True,
        family="dense", subquadratic=False)
