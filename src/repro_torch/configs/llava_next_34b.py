"""llava-next-34b [vlm]: 60 layers, d_model 7168, 56 heads (GQA kv 8) of
128, d_ff 20480, vocab 64000, rope theta 5e6.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

The vision frontend is a stub: a batch carries 576 precomputed patch
embeddings (one 24x24 CLIP tile) at d_model
(``data/pipeline.py::vlm_patch_stub``), prepended to the text with
labels of -1; anyres tiling would change only n_patches.  At 34.3 B
parameters the plan trains under flush (PipeDream-flush) with ZeRO-1.

Same specs and plans as ``repro/configs/llava_next_34b.py`` (pinned by
tests/test_torch_llava.py).
"""
from repro_torch.models import spec as S
from repro_torch.parallel.plan import ParallelismPlan

OPTIMIZER = ("adam", 1.5e-4)

N_PATCHES = 576

PLAN = ParallelismPlan(pp=2, tp=8, microbatches=8, stash_mode="flush",
                       zero1=True, remat=True)
SMOKE_PLAN = ParallelismPlan(pp=2, tp=1, microbatches=2, stash_mode="flush",
                             zero1=False)


def full_spec() -> S.ModelSpec:
    blocks = tuple(S.BlockSpec(mixer="attn", ffn="dense", rope_theta=5e6)
                   for _ in range(60))
    return S.ModelSpec(
        name="llava-next-34b", d_model=7168, n_layers=60, n_heads=56,
        n_kv=8, d_head=128, d_ff=20480, vocab=64000, blocks=blocks,
        norm="rmsnorm", act="silu", frontend="vision", n_patches=N_PATCHES,
        family="vlm", subquadratic=False)


def smoke_spec() -> S.ModelSpec:
    blocks = tuple(S.BlockSpec(mixer="attn", ffn="dense") for _ in range(4))
    return S.ModelSpec(
        name="llava-smoke", d_model=64, n_layers=4, n_heads=4, n_kv=2,
        d_head=16, d_ff=128, vocab=256, blocks=blocks,
        norm="rmsnorm", act="silu", frontend="vision", n_patches=8,
        family="vlm", subquadratic=False)
