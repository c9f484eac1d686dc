"""jamba-v0.1-52b [hybrid]: 32 layers, d_model 4096, 32 heads (GQA kv
8) of 128, d_ff 14336, vocab 65536; MoE 16 experts top-2 of width 14336
on odd layers, dense FFN on even ones; Mamba mixers (d_state 16, d_conv
4, expand 2) with one attention mixer per period of 8 (at position 4).

51.6 B parameters: all 32 layers (103 GB in bf16) do not fit one 80 GB
card, so the card path serves the first two periods (16 layers).

Same specs and plans as ``repro/configs/jamba_v01_52b.py`` (pinned by
tests/test_torch_spec.py).
"""
from repro_torch.models import spec as S
from repro_torch.parallel.plan import ParallelismPlan

OPTIMIZER = ("adam", 1.5e-4)

PLAN = ParallelismPlan(pp=4, tp=4, microbatches=8, stash_mode="flush",
                       zero1=True, remat=True)
SMOKE_PLAN = ParallelismPlan(pp=2, tp=1, microbatches=2, stash_mode="flush",
                             zero1=False)


def _block(i: int) -> S.BlockSpec:
    mixer = "attn" if i % 8 == 4 else "mamba"
    ffn = "moe" if i % 2 == 1 else "dense"
    return S.BlockSpec(mixer=mixer, ffn=ffn)


def full_spec() -> S.ModelSpec:
    return S.ModelSpec(
        name="jamba-v0.1-52b", d_model=4096, n_layers=32, n_heads=32,
        n_kv=8, d_head=128, d_ff=14336, vocab=65536,
        blocks=tuple(_block(i) for i in range(32)),
        norm="rmsnorm", act="silu",
        moe=S.MoESpec(n_experts=16, top_k=2, d_expert=14336),
        mamba=S.MambaSpec(d_state=16, d_conv=4, expand=2),
        family="hybrid", subquadratic=True)


def smoke_spec() -> S.ModelSpec:
    def blk(i):
        return S.BlockSpec(mixer=("attn" if i % 4 == 0 else "mamba"),
                           ffn=("moe" if i % 2 == 1 else "dense"))
    return S.ModelSpec(
        name="jamba-smoke", d_model=64, n_layers=8, n_heads=4, n_kv=2,
        d_head=16, d_ff=128, vocab=256,
        blocks=tuple(blk(i) for i in range(8)),
        norm="rmsnorm", act="silu",
        moe=S.MoESpec(n_experts=4, top_k=2, d_expert=32),
        mamba=S.MambaSpec(d_state=4, d_conv=4, expand=2),
        family="hybrid", subquadratic=True)
