"""Architecture registry (port of ``repro/configs``).

Every config module exposes ``full_spec()``, ``smoke_spec()``, ``PLAN``
and ``SMOKE_PLAN``.  Ported so far: qwen3-14b, rwkv6-1.6b, jamba-v0.1-52b,
h2o-danube3-4b, olmoe-1b-7b, chatglm3-6b, deepseek-moe-16b, whisper-medium
(an encoder and cross-attention), llava-next-34b (a patch prefix) and
gemma3-4b (Dh 256, 5:1 local:global windows): every config of the JAX
registry.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ("qwen3_14b", "gemma3_4b", "chatglm3_6b", "h2o_danube3_4b",
            "olmoe_1b_7b", "deepseek_moe_16b", "rwkv6_1b6", "jamba_v01_52b",
            "whisper_medium", "llava_next_34b")

# CLI ids (dashes) -> module names, as in the JAX registry
_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES["rwkv6-1.6b"] = "rwkv6_1b6"
_ALIASES["jamba-v0.1-52b"] = "jamba_v01_52b"
_ALIASES["h2o-danube-3-4b"] = "h2o_danube3_4b"


def resolve(arch: str) -> str:
    key = _ALIASES.get(arch, arch)
    if key not in ARCH_IDS:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; "
                       f"ported: {sorted(_ALIASES)}")
    return key


def get(arch: str):
    """Return the config module for an arch id (dash or underscore form)."""
    return importlib.import_module(f"repro_torch.configs.{resolve(arch)}")
