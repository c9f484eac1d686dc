"""Architecture registry (port of ``repro/configs``): 10 archs x 4 input
shapes.

Every config module exposes ``full_spec()``, ``smoke_spec()``, ``PLAN``
and ``SMOKE_PLAN``.  Ported: qwen3-14b, rwkv6-1.6b, jamba-v0.1-52b,
h2o-danube3-4b, olmoe-1b-7b, chatglm3-6b, deepseek-moe-16b, whisper-medium
(an encoder and cross-attention), llava-next-34b (a patch prefix) and
gemma3-4b (Dh 256, 5:1 local:global windows): every config of the JAX
registry.

Shapes, as the JAX registry has them:
  train_4k     seq 4 096 x batch 256   -> pipelined train step
  prefill_32k  seq 32 768 x batch 32   -> pipelined prefill
  decode_32k   seq 32 768 x batch 128  -> pipelined decode step (1 new
                                          token, KV cache of seq_len)
  long_500k    seq 524 288 x batch 1   -> decode at 524k tokens; only
                                          sub-quadratic-memory archs
                                          (spec.subquadratic) run it.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Iterator, Tuple

# in the JAX registry's order, which ``cells()`` walks
ARCH_IDS = ("qwen3_14b", "gemma3_4b", "chatglm3_6b", "h2o_danube3_4b",
            "llava_next_34b", "olmoe_1b_7b", "deepseek_moe_16b",
            "whisper_medium", "rwkv6_1b6", "jamba_v01_52b")

# CLI ids (dashes) -> module names, as in the JAX registry
_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES["rwkv6-1.6b"] = "rwkv6_1b6"
_ALIASES["jamba-v0.1-52b"] = "jamba_v01_52b"
_ALIASES["h2o-danube-3-4b"] = "h2o_danube3_4b"


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str            # train | prefill | decode | long_decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "long_decode", 524288, 1),
}


def resolve(arch: str) -> str:
    key = _ALIASES.get(arch, arch)
    if key not in ARCH_IDS:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; "
                       f"ported: {sorted(_ALIASES)}")
    return key


def get(arch: str):
    """Return the config module for an arch id (dash or underscore form)."""
    return importlib.import_module(f"repro_torch.configs.{resolve(arch)}")


def supports(arch: str, shape: str) -> Tuple[bool, str]:
    """(runs?, reason).  long_500k requires sub-quadratic KV memory."""
    spec = get(arch).full_spec()
    if shape == "long_500k" and not spec.subquadratic:
        return False, ("quadratic full-attention KV at 524k tokens "
                       "(skip noted in DESIGN.md §8)")
    return True, ""


def cells() -> Iterator[Tuple[str, str, bool, str]]:
    """All 40 (arch, shape) cells with their skip status."""
    for arch in ARCH_IDS:
        for shape in SHAPES:
            ok, why = supports(arch, shape)
            yield arch, shape, ok, why
