"""Sequential oracle for the pipelined train step (port of
``repro/core/reference.py``).

Executes the same double-tick schedule, weight stashing and
per-microbatch (or round-end) updates with plain Python loops, one list
entry per stage, driven by the same
:class:`~repro_torch.core.schedule.PipelineSchedule` tables the executor
(core/pipeline.py) walks.  It is functional: the input state is never
written.  Bit-exact (fp32) against the executor; held against the JAX
package's oracle by tests/test_torch_train_oracle*.py.

Ported for decoder-only text models; the encoder (whisper) and VLM
(llava) branches raise, as do virtual-stage plans.  Also
``staleness_formula_run``: the paper's §3.4 update rule applied
directly, a third implementation that 1F1B + weight stashing must meet:
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
from repro_torch.models.stage import make_statics, stage_fwd, stage_vjp
from repro_torch.optim.optimizers import tree_map


def check_trainable(spec, sched) -> None:
    """Raise for what the port's training round does not run yet."""
    if spec.encoder is not None or spec.frontend == "vision":
        raise NotImplementedError(
            f"{spec.name}: training of encoder (whisper) and VLM (llava) "
            "models is not ported yet")
    if sched.virtual_stages > 1:
        raise NotImplementedError(
            f"schedule {sched.name!r}: virtual-stage schedules are not "
            "ported yet")


def reference_init_state(spec, plan, optimizer, gen: torch.Generator,
                         dtype=torch.float32):
    """Single-device state matching core/pipeline.py's ``init_state``."""
    sched = make_schedule(plan)
    check_trainable(spec, sched)
    return make_train_state(init_params(spec, plan, gen, dtype), sched,
                            optimizer)


def _slice(tree, p):
    return tree_map(lambda a: a[p], tree)


def _stack(trees):
    return tree_map(lambda *a: torch.stack(a), *trees)


def reference_train_step(spec, plan, state, batch, optimizer,
                         aux_weight: float = 0.01):
    """Mirror of core/pipeline.py's ``train_step``, sequential, one data
    replica.  Returns (new_state, {"loss", "aux"})."""
    S, R = plan.pp, plan.microbatches
    sched = make_schedule(plan)
    check_trainable(spec, sched)
    tabs = sched.tables()
    V = sched.stash_slots
    accumulate = sched.accumulate or plan.grad_sync == "per_round"
    use_ring = sched.uses_stash_ring
    params = state["params"]
    tokens, labels = batch["tokens"], batch["labels"]   # (R, Bmb, S_text)
    step = state["step"]
    bmb, seq_len = tokens.shape[1], tokens.shape[2]
    statics = make_statics(spec, plan.with_(tp=1),
                           tokens_per_mb=bmb * seq_len)
    embeds = lm_head.embed_tokens(params["embed"], tokens)
    pos = torch.arange(seq_len, device=tokens.device).expand(bmb, seq_len)
    stage_kw = lambda s: dict(positions=pos,                    # noqa: E731
                              windows=params["layer_windows"][s],
                              thetas=params["layer_thetas"][s])

    weights = [_slice(state["stash"]["current"], s) for s in range(S)]
    stash: List[List[Any]] = (
        [[_slice(_slice(state["stash"]["ring"], slot), s)
          for slot in range(V)] for s in range(S)] if use_ring
        else [[None] * V for _ in range(S)])
    opt = [_slice(state["opt_stages"], s) for s in range(S)]
    head, fnorm = params["head"], params["final_norm"]
    head_opt = state["opt_head"]

    recv_f = [None] * S
    recv_b = [None] * S
    resid = [[None] * sched.resid_slots for _ in range(S)]
    gacc = [None] * S
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
            x_in = embeds[f] if row[F_FROM_EMBEDS] else recv_f[s]
            if use_ring:
                stash[s][int(row[F_STASH_WRITE])] = weights[s]
            w_f = (stash[s][int(row[F_VERSION])] if sched.fwd_from_stash
                   else weights[s])
            with torch.no_grad():
                h, aux = stage_fwd(w_f, x_in, statics, return_aux=True,
                                   **stage_kw(s))
            aux_sum = aux_sum + aux
            resid[s][int(row[F_RESID_WRITE])] = x_in
            if int(row[F_CHUNK]) * S + s == S - 1:
                h_exit = h
            else:
                new_recv_f[s + 1] = h
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
            g_in = g_exit if row[B_FROM_HEAD] else recv_b[s]
            w_used = (stash[s][int(row[B_VERSION])] if use_ring
                      else weights[s])
            x_saved = resid[s][int(row[B_RESID_READ])]
            dW, dx = stage_vjp(w_used, x_saved, statics, g_in, aux_weight,
                               **stage_kw(s))
            if accumulate:
                gacc[s] = dW if gacc[s] is None else tree_add(gacc[s], dW)
            else:
                weights[s], opt[s] = optimizer.update(dW, opt[s],
                                                      weights[s], step)
            if int(row[B_CHUNK]) * S + s == 0:
                d_embeds[b] = dx
            else:
                new_recv_b[s - 1] = dx
        recv_b = new_recv_b

    # ---------------- round end -------------------------------------------
    if accumulate:
        for s in range(S):
            g = tree_map(lambda a: a / R, gacc[s])
            weights[s], opt[s] = optimizer.update(g, opt[s], weights[s],
                                                  step)
        hf_new, head_opt = optimizer.update(
            {"h": dhead_acc / R, "f": tree_map(lambda a: a / R, dfnorm_acc)},
            head_opt, {"h": head, "f": fnorm}, step)
        head, fnorm = hf_new["h"], hf_new["f"]

    demb = torch.stack([d.float() for d in d_embeds])
    d_table = lm_head.embed_bwd(params["embed"], tokens, demb) / R
    emb2, eopt2 = optimizer.update(d_table, state["opt_embed"],
                                   params["embed"], step)

    stages_full = _stack(weights)
    new_params = dict(params, embed=emb2, head=head, final_norm=fnorm,
                      stages=stages_full)
    new_state = dict(state, params=new_params, opt_stages=_stack(opt),
                     opt_head=head_opt, opt_embed=eopt2, step=step + 1)
    new_state["stash"] = {"current": stages_full}
    if use_ring:
        new_state["stash"]["ring"] = _stack([_stack([stash[s][slot]
                                                     for s in range(S)])
                                             for slot in range(V)])
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
