"""Embedding lookup, the loss head and the greedy head (port of
``repro/models/lm_head.py``)."""
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


def _padded_vocab_mask(logits, vocab: Optional[int]):
    """JAX's additive mask: 0 on the vocab, -1e30 on the padded ids."""
    if vocab is None or vocab >= logits.shape[-1]:
        return logits
    mask = torch.zeros(logits.shape[-1], dtype=torch.float32,
                       device=logits.device)
    mask[vocab:] = NEG_INF
    return logits + mask


def head_loss(head, final_norm_scale, h, labels, *, norm_kind: str = "rmsnorm",
              norm_bias=None, valid_mask=None, vocab: Optional[int] = None,
              n_valid=None):
    """Mean cross-entropy of the hidden states exiting the pipeline.

    h: (B, S, d); labels: (B, S) int.  The head product runs in h's
    dtype and the logits are taken to f32, as JAX does; padded vocab ids
    are masked with -1e30; the mean is over ``valid_mask`` (all ones
    when None), at least 1.  ``n_valid`` replaces the divisor: a data
    replica holding part of a microbatch divides by the whole
    microbatch's count, as JAX's head over the global microbatch does.
    Returns (mean_loss, n_tokens).
    """
    if norm_kind == "rmsnorm":
        h = nn.rmsnorm(h, final_norm_scale)
    else:
        h = nn.layernorm(h, final_norm_scale, norm_bias)
    logits = _padded_vocab_mask((h @ maybe_dequant(head, h.dtype)).float(),
                                vocab)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - picked
    if valid_mask is None:
        valid_mask = torch.ones(labels.shape, dtype=torch.float32,
                                device=h.device)
    n = (valid_mask.sum() if n_valid is None else n_valid).clamp_min(1.0)
    return (nll * valid_mask).sum() / n, n


def head_loss_and_grad(head, final_norm_scale, h, labels, *,
                       norm_kind: str = "rmsnorm", norm_bias=None, **kw):
    """(loss, dh, dhead, dnorm_scale): autograd over :func:`head_loss`,
    the output stage's B-phase seed."""
    fn = {"scale": final_norm_scale}
    if norm_bias is not None:
        fn["bias"] = norm_bias
    loss, dh, dhead, dfn = loss_and_grads(head, fn, h, labels,
                                          norm_kind=norm_kind, **kw)
    return loss, dh, dhead, dfn["scale"]


def loss_and_grads(head, final_norm, h, labels, *, norm_kind: str,
                   valid_mask=None, vocab: Optional[int] = None,
                   n_valid=None):
    """:func:`head_loss_and_grad` over the whole final-norm tree (scale,
    and bias for a layernorm): (loss, dh, dhead, dfinal_norm), the
    gradient tree keyed like ``final_norm``, as the JAX executor takes
    ``jax.value_and_grad`` over ``(head, final_norm, h)``."""
    keys = sorted(final_norm)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (head, h, *(final_norm[k] for k in keys))]
        fn = dict(zip(keys, leaves[2:]))
        loss, _ = head_loss(leaves[0], fn["scale"], leaves[1], labels,
                            norm_kind=norm_kind, norm_bias=fn.get("bias"),
                            valid_mask=valid_mask, vocab=vocab,
                            n_valid=n_valid)
        dhead, dh, *dfn = torch.autograd.grad(loss, leaves)
    return loss.detach(), dh, dhead, dict(zip(keys, dfn))


def embed_bwd(embed_shape_like, tokens, d_embeds):
    """d(embedding table) from d(embeds) by a scatter-add over the vocab.

    tokens: (..., S); d_embeds: (..., S, d).  A table of
    ``embed_shape_like``'s shape in ``d_embeds``' dtype.
    """
    flat_d = d_embeds.reshape(-1, d_embeds.shape[-1])
    out = torch.zeros(embed_shape_like.shape, dtype=flat_d.dtype,
                      device=flat_d.device)
    return out.index_add_(0, tokens.reshape(-1).long(), flat_d)


def logits(head, final_norm_scale, h, *, norm_kind: str = "rmsnorm",
           norm_bias=None, vocab: Optional[int] = None):
    """f32 logits at every position, h: (B, S, d) -> (B, S, Vpad).

    Padded vocab ids get -1e30, so they never win an argmax.
    """
    if norm_kind == "rmsnorm":
        h = nn.rmsnorm(h, final_norm_scale)
    else:
        h = nn.layernorm(h, final_norm_scale, norm_bias)
    out = (h @ maybe_dequant(head, h.dtype)).float()
    if vocab is not None and vocab < out.shape[-1]:
        out[..., vocab:] = NEG_INF
    return out


def last_logits(head, final_norm_scale, h, *, norm_kind: str = "rmsnorm",
                norm_bias=None, vocab: Optional[int] = None):
    """f32 logits of the last position, h: (B, S, d) -> (B, Vpad)."""
    return logits(head, final_norm_scale, h[:, -1:], norm_kind=norm_kind,
                  norm_bias=norm_bias, vocab=vocab)[:, 0]


def sample_greedy(head, final_norm_scale, h, *, norm_kind: str = "rmsnorm",
                  norm_bias=None, vocab: Optional[int] = None):
    """Greedy next-token ids from the last position. h: (B, S, d)."""
    return last_logits(head, final_norm_scale, h, norm_kind=norm_kind,
                       norm_bias=norm_bias, vocab=vocab
                       ).argmax(dim=-1).to(torch.int32)


def greedy_tokens(head, final_norm_scale, h, *, norm_kind: str = "rmsnorm",
                  norm_bias=None, vocab: Optional[int] = None):
    """Greedy token ids at every position, h: (B, S, d) -> (B, S) int32:
    position j's argmax is the next token after the prefix ending at j
    (the verify half of speculative decode)."""
    return logits(head, final_norm_scale, h, norm_kind=norm_kind,
                  norm_bias=norm_bias, vocab=vocab
                  ).argmax(dim=-1).to(torch.int32)
