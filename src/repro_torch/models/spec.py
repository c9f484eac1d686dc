"""Architecture specification (port of ``repro/models/spec.py``).

A model is a sequence of *blocks* (mixer + ffn) plus embedding and head.
Blocks are grouped into ``pp`` contiguous stages whose block-kind
pattern must be identical; per-layer scalars that differ across stages
(attention window, rope theta) travel as [pp, layers_per_stage] lists.
The field set is pinned to the JAX package by tests/test_torch_spec.py.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

GLOBAL_WINDOW = -1  # window sentinel: full causal attention


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    d_shared: int = 0
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0


@dataclasses.dataclass(frozen=True)
class RWKVSpec:
    head_dim: int = 64
    decay_lora: int = 64
    tmix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    source_len: int


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str = "attn"        # attn | mamba | rwkv | none
    ffn: str = "dense"         # dense | moe | rwkv_cmix | none
    window: int = GLOBAL_WINDOW
    rope_theta: float = 1e4
    cross_attn: bool = False


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    blocks: Tuple[BlockSpec, ...]
    norm: str = "rmsnorm"
    act: str = "silu"
    qk_norm: bool = False
    rope_2d: bool = False
    moe: Optional[MoESpec] = None
    mamba: Optional[MambaSpec] = None
    rwkv: Optional[RWKVSpec] = None
    encoder: Optional[EncoderSpec] = None
    frontend: str = "none"
    n_patches: int = 0
    tie_embeddings: bool = False
    family: str = "dense"
    subquadratic: bool = False

    def __post_init__(self):
        assert len(self.blocks) == self.n_layers, (len(self.blocks), self.n_layers)
        assert self.norm in ("rmsnorm", "layernorm")
        assert self.act in ("silu", "gelu")

    def layers_per_stage(self, pp: int) -> int:
        assert self.n_layers % pp == 0, (
            f"{self.name}: pp={pp} must divide n_layers={self.n_layers}")
        return self.n_layers // pp

    def stage_program(self, pp: int) -> Tuple[BlockSpec, ...]:
        """The (validated) per-stage block pattern."""
        validate_stageability(self, pp)
        return self.blocks[: self.layers_per_stage(pp)]

    @property
    def d_attn(self) -> int:
        return self.n_heads * self.d_head

    def param_count(self) -> int:
        """Exact parameter count (embedding + blocks + head + norms)."""
        n = self.vocab * self.d_model                       # embed
        if not self.tie_embeddings:
            n += self.vocab * self.d_model                  # head
        n += self.d_model                                   # final norm
        for b in self.blocks:
            n += _block_params(self, b)
        if self.encoder is not None:
            e = self.encoder
            per = (4 * e.d_model * e.d_model + 2 * e.d_model * e.d_ff
                   + 4 * e.d_model)
            n += e.n_layers * per + e.d_model
        return n

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        per_expert = 3 * self.d_model * m.d_expert
        n_moe_blocks = sum(1 for b in self.blocks if b.ffn == "moe")
        return (self.param_count()
                - n_moe_blocks * per_expert * (m.n_experts - m.top_k))


def _block_params(spec: ModelSpec, b: BlockSpec) -> int:
    """Parameters of one block (what the planner's profiles and memory
    model count)."""
    n = 0
    d = spec.d_model
    if b.mixer == "attn":
        n += d * spec.d_attn + 2 * d * spec.n_kv * spec.d_head + spec.d_attn * d
        n += d  # mixer norm
        if spec.qk_norm:
            n += 2 * spec.d_head
        if b.cross_attn:
            n += (d * spec.d_attn + 2 * d * spec.n_kv * spec.d_head
                  + spec.d_attn * d + d)
    elif b.mixer == "mamba":
        ms = spec.mamba
        d_in = ms.expand * d
        dt_rank = ms.dt_rank or -(-d // 16)
        n += d * 2 * d_in                      # in_proj (x, z)
        n += d_in * ms.d_conv                  # conv
        n += d_in * (dt_rank + 2 * ms.d_state)  # x -> dt, B, C
        n += dt_rank * d_in + d_in             # dt proj + bias
        n += d_in * ms.d_state + d_in          # A_log, D
        n += d_in * d                          # out proj
        n += d                                 # norm
    elif b.mixer == "rwkv":
        rs = spec.rwkv
        n += 4 * d * d                         # r, k, v, g
        n += d * d                             # output
        n += 5 * d + d * rs.tmix_lora * 2 * 5  # token-shift maa + lora
        n += d * rs.decay_lora + rs.decay_lora * d + d  # decay lora + u
        n += 2 * d                             # group norm
        n += d                                 # block norm
    if b.ffn == "dense":
        n += 3 * d * spec.d_ff if spec.act == "silu" else 2 * d * spec.d_ff
        n += d
    elif b.ffn == "moe":
        m = spec.moe
        n += m.n_experts * 3 * d * m.d_expert
        n += d * m.n_experts                   # router
        n += m.n_shared * 3 * d * m.d_shared
        n += d
    elif b.ffn == "rwkv_cmix":
        n += d * int(3.5 * d) + int(3.5 * d) * d + 2 * d  # wide k, v + maa
        n += d
    return n


def validate_stageability(spec: ModelSpec, pp: int) -> None:
    """Every stage must run the identical block-kind program."""
    lps = spec.layers_per_stage(pp)
    pattern = [(b.mixer, b.ffn, b.cross_attn) for b in spec.blocks[:lps]]
    for s in range(1, pp):
        got = [(b.mixer, b.ffn, b.cross_attn)
               for b in spec.blocks[s * lps:(s + 1) * lps]]
        assert got == pattern, (
            f"{spec.name}: stage {s} block pattern {got} != stage 0 {pattern}; "
            f"choose a pp that aligns with the layer-type period")


def stage_varying_scalars(spec: ModelSpec, pp: int):
    """Per-layer scalars that differ across stages, as [pp, lps] lists."""
    lps = spec.layers_per_stage(pp)
    windows = [[spec.blocks[s * lps + i].window for i in range(lps)]
               for s in range(pp)]
    thetas = [[spec.blocks[s * lps + i].rope_theta for i in range(lps)]
              for s in range(pp)]
    return windows, thetas
