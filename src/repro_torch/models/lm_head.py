"""Embedding lookup and greedy head (port of ``repro/models/lm_head.py``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import nn
from repro_torch.quant import is_quantized, maybe_dequant

NEG_INF = -1e30


def embed_tokens(embed, tokens, dtype=None):
    """embed: (Vpad, d); tokens: (..., S) int -> (..., S, d).

    A quantized embed gathers the int8/fp8 rows and their per-row scales
    and multiplies only the gathered slice: the full-precision table
    never exists.
    """
    idx = tokens.long()
    if is_quantized(embed):
        out = (F.embedding(idx, embed["q"]).float()
               * F.embedding(idx, embed["scale"]))
    else:
        out = F.embedding(idx, embed)
    return out if dtype is None else out.to(dtype)


def last_logits(head, final_norm_scale, h, *, norm_kind: str = "rmsnorm",
                norm_bias=None, vocab: Optional[int] = None):
    """f32 logits of the last position, h: (B, S, d) -> (B, Vpad).

    Padded vocab ids get -1e30, so they never win an argmax.
    """
    if norm_kind == "rmsnorm":
        h = nn.rmsnorm(h, final_norm_scale)
    else:
        h = nn.layernorm(h, final_norm_scale, norm_bias)
    logits = (h[:, -1] @ maybe_dequant(head, h.dtype)).float()
    if vocab is not None and vocab < logits.shape[-1]:
        logits[:, vocab:] = NEG_INF
    return logits


def sample_greedy(head, final_norm_scale, h, *, norm_kind: str = "rmsnorm",
                  norm_bias=None, vocab: Optional[int] = None):
    """Greedy next-token ids from the last position. h: (B, S, d)."""
    return last_logits(head, final_norm_scale, h, norm_kind=norm_kind,
                       norm_bias=norm_bias, vocab=vocab
                       ).argmax(dim=-1).to(torch.int32)
