"""Embedding lookup, the loss head and the greedy head (port of
``repro/models/lm_head.py``).

At tp > 1 training shards both tables over the tensor group, as the JAX
init does (``repro/models/init.py``: the embedding on d_model, the head
on the vocabulary): tensor rank t of the first stage holds the columns
``embed[:, t·d/tp : (t+1)·d/tp]`` and gathers its columns of the
tokens' rows, joined by an all-gather (:func:`embed_tokens_sharded`);
rank t of the last stage holds ``head[:, t·V/tp : (t+1)·V/tp]`` of the
padded vocabulary and forms only its own logits (:func:`head_loss_
sharded`).  The final norm is every rank's.  Serving cuts them the
same way: the greedy head over a vocabulary slice takes the group's
largest logit, the lowest id on ties (:func:`greedy_tokens_sharded`),
which is ``torch.argmax`` over the whole row.  At tp 1 the functions
below without a group run as before."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.versioning import table_columns
from repro_torch.models import nn
from repro_torch.parallel.dist import tp_all_gather, tp_enter, tp_exit
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


def embed_tokens_sharded(embed, tokens, group, dtype=None):
    """This tensor rank's columns of the tokens' rows (``embed`` (Vpad,
    d/tp), rank t's slice of d), joined over ``group`` in rank order:
    (..., S, d), the same on every rank.  The all-gather is autograd's
    (``tp_all_gather``): a cotangent of the joined rows gives back this
    rank's columns."""
    return tp_all_gather(embed_tokens(embed, tokens, dtype), group,
                         tokens.dim())


def embed_columns(d_embeds, group):
    """This tensor rank's columns of d(embeds) (..., S, d): what its
    slice of the table is scattered from (:func:`embed_bwd`).  All of
    them without a group."""
    if group is None:
        return d_embeds
    return d_embeds[..., table_columns(d_embeds.shape[-1], group.index,
                                       group.size)]


def _final_norm(h, scale, norm_kind: str, norm_bias):
    """The final norm of the hidden states exiting the pipeline."""
    if norm_kind == "rmsnorm":
        return nn.rmsnorm(h, scale)
    return nn.layernorm(h, scale, norm_bias)


def _padded_vocab_mask(logits, vocab: Optional[int], v0: int = 0):
    """JAX's additive mask: 0 on the vocab, -1e30 on the padded ids, for
    logits of the ids ``v0``, ``v0`` + 1, ... (a vocabulary slice)."""
    n = logits.shape[-1]
    if vocab is None or vocab >= v0 + n:
        return logits
    mask = torch.zeros(n, dtype=torch.float32, device=logits.device)
    mask[max(vocab - v0, 0):] = NEG_INF
    return logits + mask


def _valid_mean(nll, labels, valid_mask, n_valid):
    """(mean of ``nll`` over ``valid_mask``, the divisor): all ones when
    the mask is None, ``n_valid`` in place of its count, at least 1."""
    if valid_mask is None:
        valid_mask = torch.ones(labels.shape, dtype=torch.float32,
                                device=nll.device)
    n = (valid_mask.sum() if n_valid is None else n_valid).clamp_min(1.0)
    return (nll * valid_mask).sum() / n, n


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
    h = _final_norm(h, final_norm_scale, norm_kind, norm_bias)
    logits = _padded_vocab_mask((h @ maybe_dequant(head, h.dtype)).float(),
                                vocab)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return _valid_mean(lse - picked, labels, valid_mask, n_valid)


def head_loss_sharded(head, final_norm_scale, h, labels, *, group,
                      norm_kind: str = "rmsnorm", norm_bias=None,
                      valid_mask=None, vocab: Optional[int] = None,
                      n_valid=None):
    """:func:`head_loss` over a head cut on the vocabulary: ``head`` is
    this rank's (d, Vpad/tp) slice, ids [t·Vpad/tp, (t+1)·Vpad/tp) of
    ``group``'s rank t; ``h`` and the final norm are every rank's.

    Each rank forms its own logits in f32 (the padded ids that fall in
    its slice masked to -1e30); the row's max over the group (a max
    all-reduce, a constant under autograd) and the sum of its exps (a
    sum over the group, ``tp_exit``) give the log-sum-exp, and the
    label's logit comes from the rank that owns the label (the others
    add 0).  The mean over the valid tokens is :func:`head_loss`'s.
    Every rank returns the same loss.  Backward, through the same
    collectives' transposes: each rank's logits get softmax minus
    one-hot on its slice, its head slice its own gradient, and the
    normalized hidden state, which enters the sharded product through
    ``tp_enter``, the sum of the ranks' cotangents, so d(h) and d(final
    norm) are whole and equal on every rank.  Returns (mean_loss,
    n_tokens)."""
    hn = tp_enter(_final_norm(h, final_norm_scale, norm_kind, norm_bias),
                  group)
    w = maybe_dequant(head, hn.dtype)                        # (d, V/tp)
    n_local = w.shape[-1]
    v0 = table_columns(n_local * group.size, group.index, group.size).start
    logits = _padded_vocab_mask((hn @ w).float(), vocab, v0)
    m = group.all_reduce_(logits.detach().amax(dim=-1), op="max")
    sum_exp = tp_exit(torch.exp(logits - m[..., None]).sum(dim=-1), group)
    lse = m + torch.log(sum_exp)
    local = labels.long() - v0
    inside = (local >= 0) & (local < n_local)
    picked = torch.gather(logits, -1,
                          local.clamp(0, n_local - 1)[..., None])[..., 0]
    picked = tp_exit(torch.where(inside, picked, 0.0), group)
    return _valid_mean(lse - picked, labels, valid_mask, n_valid)


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
                   n_valid=None, tensor=None):
    """:func:`head_loss_and_grad` over the whole final-norm tree (scale,
    and bias for a layernorm): (loss, dh, dhead, dfinal_norm), the
    gradient tree keyed like ``final_norm``, as the JAX executor takes
    ``jax.value_and_grad`` over ``(head, final_norm, h)``.  With a
    ``tensor`` group of several ranks, ``head`` is this rank's vocabulary
    slice and the loss :func:`head_loss_sharded`: ``dhead`` is the
    slice's gradient, the rest whole and the same on every rank."""
    keys = sorted(final_norm)
    sharded = tensor is not None and tensor.size > 1
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (head, h, *(final_norm[k] for k in keys))]
        fn = dict(zip(keys, leaves[2:]))
        kw = dict(norm_kind=norm_kind, norm_bias=fn.get("bias"),
                  valid_mask=valid_mask, vocab=vocab, n_valid=n_valid)
        if sharded:
            loss, _ = head_loss_sharded(leaves[0], fn["scale"], leaves[1],
                                        labels, group=tensor, **kw)
        else:
            loss, _ = head_loss(leaves[0], fn["scale"], leaves[1], labels,
                                **kw)
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
    h = _final_norm(h, final_norm_scale, norm_kind, norm_bias)
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


def greedy_tokens_sharded(head, final_norm_scale, h, *, group,
                          norm_kind: str = "rmsnorm", norm_bias=None,
                          vocab: Optional[int] = None):
    """:func:`greedy_tokens` with ``head`` this rank's (d, Vpad/tp)
    vocabulary slice over ``group`` (ids [t·Vpad/tp, (t+1)·Vpad/tp) on
    rank t), ``h`` (B, S, d) every rank's: (B, S) int32, the same on
    every rank.  Each rank takes the argmax of its f32 logits (its
    padded ids masked to -1e30, as :func:`_padded_vocab_mask` masks
    them) and its value; the group's (value, id) pairs are gathered in
    rank order and the largest value wins, the lowest rank on ties, and
    a rank's own argmax is its lowest id among its ties: the lowest id
    of the row's maxima, as ``torch.argmax`` over the whole row picks
    it.  Without a group of several ranks, :func:`greedy_tokens`."""
    if group is None or group.size == 1:
        return greedy_tokens(head, final_norm_scale, h, norm_kind=norm_kind,
                             norm_bias=norm_bias, vocab=vocab)
    hn = _final_norm(h, final_norm_scale, norm_kind, norm_bias)
    w = maybe_dequant(head, hn.dtype)
    n_local = w.shape[-1]
    v0 = table_columns(n_local * group.size, group.index, group.size).start
    logits = _padded_vocab_mask((hn @ w).float(), vocab, v0)
    idx = logits.argmax(dim=-1)
    val = logits.gather(-1, idx[..., None])[..., 0]
    vals = val.new_empty((group.size,) + tuple(val.shape))
    ids = idx.new_empty((group.size,) + tuple(idx.shape))
    group.all_gather_(val[None], vals, 0)
    group.all_gather_((idx + v0)[None], ids, 0)
    win = vals.argmax(dim=0, keepdim=True)
    return ids.gather(0, win)[0].to(torch.int32)


def sample_greedy_sharded(head, final_norm_scale, h, *, group,
                          norm_kind: str = "rmsnorm", norm_bias=None,
                          vocab: Optional[int] = None):
    """:func:`sample_greedy` over a head cut on the vocabulary
    (:func:`greedy_tokens_sharded` at the last position): (B,) int32.
    Without a group of several ranks, :func:`sample_greedy`."""
    if group is None or group.size == 1:
        return sample_greedy(head, final_norm_scale, h, norm_kind=norm_kind,
                             norm_bias=norm_bias, vocab=vocab)
    return greedy_tokens_sharded(head, final_norm_scale, h[:, -1:],
                                 group=group, norm_kind=norm_kind,
                                 norm_bias=norm_bias, vocab=vocab)[:, 0]
