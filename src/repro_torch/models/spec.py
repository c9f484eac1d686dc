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
