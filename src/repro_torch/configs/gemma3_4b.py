"""gemma3-4b [dense]: 34 layers, d_model 2560, 8 heads (GQA kv 4),
d_head 256, d_ff 10240, vocab 262144, gelu MLP, qk-norm, untied head.

Every 6th layer is global (window -1, rope theta 1e6); the other five of
each six keep a 1024-token sliding window (theta 1e4).  Block kinds stay
alike, so any pp divides the layers, and a stage may hold windowed and
global layers at the same position as another stage: a decode-only
session then sizes that position's cache to the largest need
(``core/schedule.py::default_cache_lens``).

Same specs and plans as ``repro/configs/gemma3_4b.py`` (pinned by
tests/test_torch_gemma3.py).
"""
from repro_torch.models import spec as S
from repro_torch.parallel.plan import ParallelismPlan

OPTIMIZER = ("adam", 3e-4)

LOCAL_WINDOW = 1024
GLOBAL_EVERY = 6  # layer i is global iff i % 6 == 5

PLAN = ParallelismPlan(pp=2, tp=8, microbatches=8, stash_mode="stash",
                       zero1=True, remat=True)
SMOKE_PLAN = ParallelismPlan(pp=2, tp=1, microbatches=2, stash_mode="stash",
                             zero1=False)


def _block(i: int) -> S.BlockSpec:
    if i % GLOBAL_EVERY == GLOBAL_EVERY - 1:
        return S.BlockSpec(mixer="attn", ffn="dense",
                           window=S.GLOBAL_WINDOW, rope_theta=1e6)
    return S.BlockSpec(mixer="attn", ffn="dense",
                       window=LOCAL_WINDOW, rope_theta=1e4)


def full_spec() -> S.ModelSpec:
    return S.ModelSpec(
        name="gemma3-4b", d_model=2560, n_layers=34, n_heads=8, n_kv=4,
        d_head=256, d_ff=10240, vocab=262144,
        blocks=tuple(_block(i) for i in range(34)),
        norm="rmsnorm", act="gelu", qk_norm=True, tie_embeddings=False,
        family="dense", subquadratic=True)


def smoke_spec() -> S.ModelSpec:
    return S.ModelSpec(
        name="gemma3-smoke", d_model=64, n_layers=6, n_heads=4, n_kv=2,
        d_head=16, d_ff=128, vocab=256,
        blocks=tuple(
            S.BlockSpec(mixer="attn", ffn="dense",
                        window=(S.GLOBAL_WINDOW if i % 3 == 2 else 8),
                        rope_theta=(1e6 if i % 3 == 2 else 1e4))
            for i in range(6)),
        norm="rmsnorm", act="gelu", qk_norm=True,
        family="dense", subquadratic=True)
