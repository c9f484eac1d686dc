"""Sequential oracle for the pipelined train step (port of
``repro/core/reference.py``).

Executes the same double-tick schedule, weight stashing and
per-microbatch (or round-end) updates with plain Python loops, one list
entry per storage row, driven by the same
:class:`~repro_torch.core.schedule.PipelineSchedule` tables the executor
(core/pipeline.py) walks.  It is functional: the input state is never
written (unless donated).  Virtual-stage plans run natively: storage
row p = s·v + j holds chunk c = j·S + s, chunk hops wrap stage S−1 → 0,
and per-chunk stash rings back the async interleaved schedule's
per-microbatch updates.  Bit-exact (fp32) against the executor; held
against the JAX package's oracle by tests/test_torch_train_oracle*.py
and tests/test_torch_interleaved.py.

The frontends run as in JAX's oracle: a VLM's patch embeddings are
prepended to the text embeddings with labels of −1 and their rows of
d(embeddings) dropped; an encoder-decoder model's encoder runs once a
round before the pipeline, every stage's backward returns its share of
d(encoder output), and the round's sum goes through one encoder
backward into the encoder's own update.  Also ``staleness_formula_run``: the paper's
§3.4 update rule applied directly, a third implementation that 1F1B +
weight stashing must meet:
    w^(t+1) = w^(t) − ν·∇f(w_1^(t−n+1), …, w_n^(t))
"""
from __future__ import annotations

from typing import Any, List

import torch

from repro_torch.core.schedule import (B_CHUNK, B_FROM_HEAD, B_MB,
                                       B_RESID_READ, B_VERSION, F_CHUNK,
                                       F_FROM_EMBEDS, F_MB, F_RESID_WRITE,
                                       F_STASH_WRITE, F_VERSION, make_schedule)
from repro_torch.core.versioning import make_train_state, tree_add
from repro_torch.models import lm_head
from repro_torch.models.init import init_params
from repro_torch.models.stage import (encoder_vjp, make_statics, stage_fwd,
                                     stage_vjp)
from repro_torch.optim.optimizers import tree_map


def model_plan(plan, sched):
    """The plan the model is built and cut with: the S·v chunks of a
    virtual-stage schedule as its stages."""
    if sched.virtual_stages == 1:
        return plan
    return plan.with_(pp=sched.n_chunks, schedule="auto", virtual_stages=1)


def to_storage_order(params, sched):
    """``params`` (chunk-major model order) with the stage rows, windows
    and thetas permuted so that row s·v + j holds chunk j·S + s."""
    if sched.virtual_stages == 1:
        return params
    perm = sched.storage_chunk_order().tolist()
    out = dict(params)
    out["stages"] = tree_map(
        lambda a: a[torch.tensor(perm, device=a.device)], params["stages"])
    out["layer_windows"] = [params["layer_windows"][i] for i in perm]
    out["layer_thetas"] = [params["layer_thetas"][i] for i in perm]
    return out


def reference_init_state(spec, plan, optimizer, gen: torch.Generator,
                         dtype=torch.float32):
    """Single-device state matching core/pipeline.py's ``init_state``
    (stage rows in storage order)."""
    sched = make_schedule(plan)
    params = init_params(spec, model_plan(plan, sched), gen, dtype)
    return make_train_state(to_storage_order(params, sched), sched,
                            optimizer)


def _rows(tree, idxs, donate: bool):
    """One tree per index of ``idxs`` from a stacked tree: views, or with
    ``donate`` copies, each stacked leaf dropped from ``tree`` once its
    rows are copied (so each row's memory goes when the round replaces
    it)."""
    out = [{} for _ in idxs]
    for k in list(tree):
        sub = tree.pop(k) if donate else tree[k]
        parts = (_rows(sub, idxs, donate) if isinstance(sub, dict) else
                 [sub[i].clone() if donate else sub[i] for i in idxs])
        del sub
        for o, part in zip(out, parts):
            o[k] = part
    return out


def _gather(cells, lead, donate: bool):
    """Stack the trees ``cells`` (a list, in row-major order over the
    leading shape ``lead``) leaf by leaf; with ``donate`` each leaf
    leaves the cells once copied."""
    if not isinstance(cells[0], dict):
        out = torch.empty(tuple(lead) + tuple(cells[0].shape),
                          dtype=cells[0].dtype, device=cells[0].device)
        flat = out.view((-1,) + tuple(cells[0].shape))
        for i, c in enumerate(cells):
            flat[i].copy_(c)
        return out
    out = {}
    for k in list(cells[0]):
        subs = [c[k] for c in cells]
        if donate:
            for c in cells:
                c.pop(k, None)
        out[k] = _gather(subs, lead, donate)
        del subs
    return out


def _update_leafwise(optimizer, grads, state, params, step):
    """``optimizer.update(grads, state, params, step)`` leaf by leaf, each
    gradient, parameter and state leaf popped from its dict as its
    update lands: the same arithmetic (the optimizer's per-leaf rule),
    with one leaf's old and new tensors alive at a time instead of the
    whole tree's.  For a donated round's rows, whose dicts nothing else
    holds; the dicts are left empty."""
    def walk(g, p, s):
        new_p, new_s = {}, [{} for _ in s]
        for k in list(g):
            gk, pk, sk = g.pop(k), p.pop(k), [x.pop(k) for x in s]
            if isinstance(gk, dict):
                new_p[k], subs = walk(gk, pk, sk)
            else:
                new_p[k], *subs = optimizer._leaf(gk, tuple(sk), pk, step)
            for d, v in zip(new_s, subs):
                d[k] = v
            del gk, pk, sk
        return new_p, new_s
    new_p, new_s = walk(grads, params, [state[k] for k in optimizer.slots])
    return new_p, dict(zip(optimizer.slots, new_s))


def with_patches(spec, embeds, labels, batch):
    """A VLM's round as JAX's train step builds it (``pipeline.py:
    395-405``): the patch embeddings (R, bmb, n_patches, d) prepended to
    the text embeddings, labels of −1 prepended to the text labels; the
    inputs as they are for other models.  Either may be None (a rank
    that holds no embedding or no head)."""
    if spec.frontend != "vision":
        return embeds, labels
    if embeds is not None:
        embeds = torch.cat([batch["patches"].to(embeds.dtype), embeds],
                           dim=2)
    if labels is not None:
        labels = torch.cat([labels.new_full(
            tuple(labels.shape[:2]) + (spec.n_patches,), -1), labels], dim=2)
    return embeds, labels


def run_encoder(spec, encoder, frames, dtype):
    """(enc_out (R, bmb, T_src, d), pull) of a round's frames (R, bmb,
    T_src, d_enc), run in ``dtype`` through :func:`~repro_torch.models.
    stage.encoder_vjp` (JAX ``pipeline.py:410-417``)."""
    lead = tuple(frames.shape[:2])
    enc, pull = encoder_vjp(encoder, frames.flatten(0, 1).to(dtype), spec)
    return enc.view(lead + tuple(enc.shape[1:])), pull


def encoder_grads(pull, denc, R: int):
    """The encoder's gradient from the stages' d(encoder output)
    ``denc`` (by stage, each (R, bmb, T_src, d) in the compute dtype):
    summed over the stages in f32 in stage order, pulled back once in
    the compute dtype, divided by R in f32 (JAX ``pipeline.py:552-571``)."""
    total = denc[0].float()
    for part in denc[1:]:
        total = total + part.float()
    grads = pull(total.flatten(0, 1).to(denc[0].dtype))
    return tree_map(lambda a: a.float() / R, grads)


def reference_train_step(spec, plan, state, batch, optimizer,
                         aux_weight: float = 0.01, *, donate: bool = False):
    """Mirror of core/pipeline.py's ``train_step``, sequential, one data
    replica.  Returns (new_state, {"loss", "aux"}).  ``state`` rows must
    be in storage order (what :func:`reference_init_state` and the
    executor's ``init_state`` produce).

    ``donate=True`` hands the input state to the step, as a jitted step's
    donated argument: its dicts are emptied and its tensors released as
    the round replaces them, so a full-width state and its successor
    need not fit the card side by side (the round-end update of
    accumulated gradients then runs leaf by leaf where no ring holds the
    rows).  The caller must not use ``state`` afterwards."""
    S, R = plan.pp, plan.microbatches
    sched = make_schedule(plan)
    v = sched.virtual_stages
    L = sched.n_chunks                  # storage rows (S·v)
    tabs = sched.tables()
    V = sched.stash_slots
    accumulate = sched.accumulate or plan.grad_sync == "per_round"
    use_ring = sched.uses_stash_ring
    take = dict.pop if donate else dict.__getitem__
    params = take(state, "params")
    tokens, labels = batch["tokens"], batch["labels"]   # (R, Bmb, S_text)
    step = state["step"]
    bmb = tokens.shape[1]
    seq_len = tokens.shape[2] + (spec.n_patches if spec.frontend == "vision"
                                 else 0)
    statics = make_statics(spec, model_plan(plan.with_(tp=1), sched),
                           tokens_per_mb=bmb * seq_len)
    embed = take(params, "embed")
    has_enc = spec.encoder is not None
    encoder = take(params, "encoder") if has_enc else None
    embeds, labels = with_patches(spec, lm_head.embed_tokens(embed, tokens),
                                  labels, batch)
    if has_enc:
        enc_ring, enc_pull = run_encoder(spec, encoder, batch["frames"],
                                         embeds.dtype)
    # each stage's d(encoder output), its chunks' shares added (v > 1)
    denc = [torch.zeros_like(enc_ring) for _ in range(S)] if has_enc \
        else None
    pos = torch.arange(seq_len, device=tokens.device).expand(bmb, seq_len)
    stage_kw = lambda p: dict(positions=pos,                    # noqa: E731
                              windows=params["layer_windows"][p],
                              thetas=params["layer_thetas"][p])

    stash_in = take(state, "stash")
    take(params, "stages")              # the same tensors as stash current
    weights = _rows(take(stash_in, "current"), range(L), donate)
    stash: List[List[Any]] = [[None] * V for _ in range(L)]
    if use_ring:
        cells = _rows(take(stash_in, "ring"),
                      [(slot, p) for p in range(L) for slot in range(V)],
                      donate)
        stash = [cells[p * V:(p + 1) * V] for p in range(L)]
        del cells
    opt = _rows(take(state, "opt_stages"), range(L), donate)
    head, fnorm = take(params, "head"), take(params, "final_norm")
    head_opt = take(state, "opt_head")
    embed_opt = take(state, "opt_embed")

    recv_f = [None] * S
    recv_b = [None] * S
    resid = [[None] * sched.resid_slots for _ in range(S)]
    gacc = [None] * L
    d_embeds = [None] * R
    loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    aux_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    dhead_acc = dfnorm_acc = None

    for tick in range(sched.n_ticks):
        # ---------------- F phase (all stages, pre-update weights) -------
        new_recv_f = [None] * S
        h_exit = None
        for s in range(S):
            row = tabs.fwd[tick, s]
            f = int(row[F_MB])
            if f < 0:
                continue
            c = int(row[F_CHUNK]) * S + s           # model chunk
            p = s * v + int(row[F_CHUNK])           # storage row
            x_in = embeds[f] if row[F_FROM_EMBEDS] else recv_f[s]
            if use_ring:
                stash[p][int(row[F_STASH_WRITE])] = weights[p]
            w_f = (stash[p][int(row[F_VERSION])] if sched.fwd_from_stash
                   else weights[p])
            with torch.no_grad():
                h, aux = stage_fwd(w_f, x_in, statics, return_aux=True,
                                   cross_x=enc_ring[f] if has_enc else None,
                                   **stage_kw(p))
            aux_sum = aux_sum + aux
            resid[s][int(row[F_RESID_WRITE])] = x_in
            if c == L - 1:
                h_exit = h
            else:                 # chunk hop; wraps stage S−1 -> 0
                new_recv_f[(s + 1) % S] = h
        recv_f = new_recv_f

        # ---------------- head / loss ------------------------------------
        g_exit = None
        m_exit = int(tabs.exit_mb[tick])
        if 0 <= m_exit < R:
            lab = labels[m_exit]
            loss, dh, dhead, dfnorm = lm_head.loss_and_grads(
                head, fnorm, h_exit, lab.clamp_min(0), norm_kind=spec.norm,
                valid_mask=(lab >= 0).float(), vocab=spec.vocab)
            loss_sum = loss_sum + loss
            g_exit = dh.to(h_exit.dtype)
            if not accumulate:
                hf_new, head_opt = optimizer.update(
                    {"h": dhead, "f": dfnorm}, head_opt,
                    {"h": head, "f": fnorm}, step)
                head, fnorm = hf_new["h"], hf_new["f"]
            elif dhead_acc is None:
                dhead_acc, dfnorm_acc = dhead, dfnorm
            else:
                dhead_acc = dhead_acc + dhead
                dfnorm_acc = tree_add(dfnorm_acc, dfnorm)

        # ---------------- B phase -----------------------------------------
        new_recv_b = [None] * S
        for s in range(S):
            row = tabs.bwd[tick, s]
            b = int(row[B_MB])
            if b < 0:
                continue
            c = int(row[B_CHUNK]) * S + s
            p = s * v + int(row[B_CHUNK])
            g_in = g_exit if row[B_FROM_HEAD] else recv_b[s]
            w_used = (stash[p][int(row[B_VERSION])] if use_ring
                      else weights[p])
            x_saved = resid[s][int(row[B_RESID_READ])]
            if has_enc:
                dW, dx, dcx = stage_vjp(w_used, x_saved, statics, g_in,
                                        aux_weight, cross_x=enc_ring[b],
                                        **stage_kw(p))
                denc[s][b] += dcx
            else:
                dW, dx = stage_vjp(w_used, x_saved, statics, g_in,
                                   aux_weight, **stage_kw(p))
            if accumulate:
                gacc[p] = dW if gacc[p] is None else tree_add(gacc[p], dW)
            else:
                weights[p], opt[p] = optimizer.update(dW, opt[p],
                                                      weights[p], step)
            if c == 0:
                d_embeds[b] = dx
            else:                 # gradient hop; wraps stage 0 -> S−1
                new_recv_b[(s - 1) % S] = dx
        recv_b = new_recv_b

    # ---------------- round end -------------------------------------------
    if accumulate:
        for p in range(L):
            g = tree_map(lambda a: a / R, gacc[p])
            gacc[p] = None
            update = (_update_leafwise if donate and not use_ring
                      else type(optimizer).update)
            weights[p], opt[p] = update(optimizer, g, opt[p], weights[p],
                                        step)
        hf_new, head_opt = optimizer.update(
            {"h": dhead_acc / R, "f": tree_map(lambda a: a / R, dfnorm_acc)},
            head_opt, {"h": head, "f": fnorm}, step)
        head, fnorm = hf_new["h"], hf_new["f"]

    demb = torch.stack([d.float() for d in d_embeds])
    if spec.frontend == "vision":
        demb = demb[:, :, spec.n_patches:]
    d_table = lm_head.embed_bwd(embed, tokens, demb) / R
    emb2, eopt2 = optimizer.update(d_table, embed_opt, embed, step)
    del d_table, demb, d_embeds, embed, embed_opt
    if has_enc:
        g_enc = encoder_grads(enc_pull, denc, R)
        del denc, enc_ring, enc_pull
        enc2, encopt2 = optimizer.update(g_enc, take(state, "opt_encoder"),
                                         encoder, step)
        del g_enc

    # the round's rows stacked leaf by leaf; with donate each leaf leaves
    # its rows once copied.  A stash cell may hold the very tree that was
    # live when F recorded it, so each row gets dicts of its own first.
    if donate:
        own = lambda t: tree_map(lambda a: a, t)      # noqa: E731
        weights = [own(w) for w in weights]
        stash = [[None if x is None else own(x) for x in row]
                 for row in stash]
    stages_full = _gather(weights, (L,), donate)
    ring = (_gather([stash[p][slot] for slot in range(V) for p in range(L)],
                    (V, L), donate) if use_ring else None)
    del weights, stash
    opt_full = _gather(opt, (L,), donate)
    new_params = dict(params, embed=emb2, head=head, final_norm=fnorm,
                      stages=stages_full)
    new_state = {"params": new_params, "stash": {"current": stages_full},
                 "opt_stages": opt_full, "opt_head": head_opt,
                 "opt_embed": eopt2, "step": step + 1}
    if has_enc:
        new_params["encoder"] = enc2
        new_state["opt_encoder"] = encopt2
    if use_ring:
        new_state["stash"]["ring"] = ring
    return new_state, {"loss": loss_sum / R, "aux": aux_sum / R}


# --------------------------------------------------------------------------
# Direct §3.4 staleness-formula implementation (straight pipeline)
# --------------------------------------------------------------------------

def staleness_formula_run(spec, plan, init_stage_weights, loss_grad_fn,
                          optimizer, opt_state, n_minibatches: int,
                          mode: str = "stash"):
    """Applies the paper's update rule directly, one minibatch at a time.

    init_stage_weights: list of per-stage weight trees.
    loss_grad_fn(mixed_weights, m) -> list of per-stage grads, where
        mixed_weights[s] is the version stage s uses for minibatch m.
    In 'stash' mode stage s uses the version available after its own
    update for minibatch m − delay(s), delay(s) = 2(S−1−s) in double-tick
    units; in 'vertical' mode every stage uses delay(0).

    Returns (the per-stage weights after n_minibatches updates, the
    optimizer states).  History is kept so delayed versions are exact.
    """
    S = plan.pp
    hist: List[List[Any]] = [[w] for w in init_stage_weights]
    opt = list(opt_state)

    def delay(s):
        return 2 * (S - 1 - s)

    for m in range(n_minibatches):
        mixed = []
        for s in range(S):
            d = delay(s) if mode == "stash" else delay(0)
            ver = min(max(m - d, 0), len(hist[s]) - 1)
            mixed.append(hist[s][ver])
        grads = loss_grad_fn(mixed, m)
        for s in range(S):
            new_w, opt[s] = optimizer.update(grads[s], opt[s],
                                             hist[s][-1], m)
            hist[s].append(new_w)
    return [h[-1] for h in hist], opt
