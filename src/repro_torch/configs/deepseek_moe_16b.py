"""deepseek-moe-16b [moe]: 28 layers, d_model 2048, 16 heads (kv 16:
MHA) of 128, vocab 102400; MoE of 64 routed experts top 6 of width 1408
and 2 shared experts of 1408 (fine-grained expert segmentation).
[arXiv:2401.06066; hf]

The shared experts are one MLP of width n_shared x d_shared added to
the routed experts' output (``moe.shared``, models/nn.py::moe).  As in
the JAX package, all 28 layers are MoE (the released model's layer 0
has a dense FFN; the stage program needs one block pattern; +0.3%
parameters).  16.4 B parameters, 33 GB in bf16.

Same specs and plans as ``repro/configs/deepseek_moe_16b.py`` (pinned
by tests/test_torch_deepseek.py).
"""
from repro_torch.models import spec as S
from repro_torch.parallel.plan import ParallelismPlan

OPTIMIZER = ("adam", 3e-4)

PLAN = ParallelismPlan(pp=2, tp=8, microbatches=8, stash_mode="stash",
                       zero1=True, remat=True)
SMOKE_PLAN = ParallelismPlan(pp=2, tp=1, microbatches=2, stash_mode="stash",
                             zero1=False)


def full_spec() -> S.ModelSpec:
    blocks = tuple(S.BlockSpec(mixer="attn", ffn="moe") for _ in range(28))
    return S.ModelSpec(
        name="deepseek-moe-16b", d_model=2048, n_layers=28, n_heads=16,
        n_kv=16, d_head=128, d_ff=1408, vocab=102400, blocks=blocks,
        norm="rmsnorm", act="silu",
        moe=S.MoESpec(n_experts=64, top_k=6, d_expert=1408,
                      n_shared=2, d_shared=1408),
        family="moe", subquadratic=False)


def smoke_spec() -> S.ModelSpec:
    blocks = tuple(S.BlockSpec(mixer="attn", ffn="moe") for _ in range(4))
    return S.ModelSpec(
        name="dsmoe-smoke", d_model=64, n_layers=4, n_heads=4, n_kv=4,
        d_head=16, d_ff=32, vocab=256, blocks=blocks,
        norm="rmsnorm", act="silu",
        moe=S.MoESpec(n_experts=8, top_k=2, d_expert=32,
                      n_shared=1, d_shared=32),
        family="moe", subquadratic=False)
