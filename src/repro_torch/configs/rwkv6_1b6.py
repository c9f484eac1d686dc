"""rwkv6-1.6b [ssm]: 24 layers, d_model 2048, attention-free, 32 heads of
64, d_ff 7168, vocab 65536.  Finch time-mix with data-dependent decay
(the WKV6 kernel) + channel-mix; O(1) recurrent decode state.

Same specs and plans as ``repro/configs/rwkv6_1b6.py`` (pinned by
tests/test_torch_spec.py).
"""
from repro_torch.models import spec as S
from repro_torch.parallel.plan import ParallelismPlan

OPTIMIZER = ("adam", 5e-4)

PLAN = ParallelismPlan(pp=8, tp=2, microbatches=16, stash_mode="stash",
                       zero1=True, remat=True)
SMOKE_PLAN = ParallelismPlan(pp=2, tp=1, microbatches=2, stash_mode="stash",
                             zero1=False)


def full_spec() -> S.ModelSpec:
    blocks = tuple(S.BlockSpec(mixer="rwkv", ffn="rwkv_cmix")
                   for _ in range(24))
    return S.ModelSpec(
        name="rwkv6-1.6b", d_model=2048, n_layers=24, n_heads=32, n_kv=0,
        d_head=64, d_ff=7168, vocab=65536, blocks=blocks,
        norm="layernorm", act="silu",
        rwkv=S.RWKVSpec(head_dim=64, decay_lora=64, tmix_lora=32),
        family="ssm", subquadratic=True)


def smoke_spec() -> S.ModelSpec:
    blocks = tuple(S.BlockSpec(mixer="rwkv", ffn="rwkv_cmix")
                   for _ in range(4))
    return S.ModelSpec(
        name="rwkv6-smoke", d_model=64, n_layers=4, n_heads=8, n_kv=0,
        d_head=8, d_ff=224, vocab=256, blocks=blocks,
        norm="layernorm", act="silu",
        rwkv=S.RWKVSpec(head_dim=8, decay_lora=8, tmix_lora=4),
        family="ssm", subquadratic=True)
