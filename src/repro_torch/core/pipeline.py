"""PipeDream pipelined training, one round per ``train_step`` (port of
``repro/core/pipeline.py::build_pipeline``).

One ``train_step`` is one *round* of R microbatches through a
:class:`~repro_torch.core.schedule.PipelineSchedule`, tick by tick:

  F phase   every stage takes its row of the forward table — (microbatch,
            input source, stash slot, weight-version slot, residual
            slot) — records its weights and its input into the slots the
            row names, forwards, and hands its output to the next stage.
  head      the microbatch the exit table names gets its loss and
            d(loss)/d(hidden); the head and final norm update at once
            (or accumulate), and the last stage starts its backward in
            the same tick (paper Figure 8).
  B phase   every stage takes its row of the backward table, re-runs its
            forward under autograd with the *table-named* weight version
            and saved residual (stage-granular remat), and either updates
            its weights at once (per-microbatch updates) or accumulates
            for the round-end flush, then hands d(input) upstream.
  round end flush-family updates; the embedding's update from the
            d(embeddings) the d(embeddings) table collected.

All stages run on one device, one after another within a phase; the
state is held as JAX's executor holds it: stage-stacked ``[L, ...]``
weights and optimizer states, a ``[V, L, ...]`` weight-version ring and
a ``[Vr, S, ...]`` residual ring, all written in place.  With virtual
stages (the interleaved family) the model is cut into L = S·v chunks
held in storage order (row s·v + j is chunk j·S + s); a row's chunk
column picks the storage row, the hand-off wraps from the last stage
back to stage 0 between chunks, the async variant's ring is chunk-major
and a per-microbatch update touches only the chunk its B row names.
Every microbatch, slot and version index comes from a table row; a
bubble row is skipped (JAX runs it on masked data).  Data replicas (the
gradient all-reduce, ZeRO-1) and stages on several devices are not
ported yet.  Bit-exact (fp32) against the sequential oracle
core/reference.py.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.core.reference import (check_trainable, model_plan,
                                        to_storage_order)
from repro_torch.core.schedule import (B_CHUNK, B_FROM_HEAD, B_MB,
                                       B_RESID_READ, B_VERSION, F_CHUNK,
                                       F_FROM_EMBEDS, F_MB, F_RESID_WRITE,
                                       F_STASH_WRITE, F_VERSION,
                                       PipelineSchedule, make_schedule)
from repro_torch.core.versioning import (make_train_state,
                                         replicated_microbatch_update,
                                         tree_add_, tree_chunk,
                                         tree_chunk_add,
                                         tree_chunk_ring_read,
                                         tree_chunk_ring_write)
from repro_torch.models import lm_head
from repro_torch.models import spec as spec_lib
from repro_torch.models.init import init_params
from repro_torch.models.stage import (StageStatics, make_statics, stage_fwd,
                                      stage_vjp)
from repro_torch.optim.optimizers import tree_map


@dataclasses.dataclass
class PipelineBundle:
    spec: spec_lib.ModelSpec
    plan: object
    statics: StageStatics
    sched: PipelineSchedule
    train_step: Callable            # (state, batch) -> (state, metrics)
    init_state: Callable            # (torch.Generator) -> state
    seq_len: int
    microbatch_size: int
    device: torch.device


def build_pipeline(spec: spec_lib.ModelSpec, plan, *, seq_len: int,
                   global_batch: int, optimizer, aux_weight: float = 0.01,
                   compute_dtype=torch.bfloat16, device=None
                   ) -> PipelineBundle:
    """The pipelined train step for one (arch, plan), all stages on
    ``device`` (``cuda`` unless told otherwise)."""
    dev = resolve_device(device)
    S, R = plan.pp, plan.microbatches
    if plan.tp != 1:
        raise NotImplementedError(
            f"tp={plan.tp}: tensor parallelism is not ported; run tp=1")
    if global_batch % R:
        raise ValueError(f"global_batch={global_batch} is not a multiple "
                         f"of R={R} microbatches")
    mb = global_batch // R
    sched = make_schedule(plan)
    if sched.is_serving:
        raise ValueError(f"schedule {sched.name!r} is forward-only: it has "
                         "no backward slots to train with")
    check_trainable(spec, sched)
    sched.validate()
    vs = sched.virtual_stages               # local chunks per stage
    L = sched.n_chunks                      # storage rows
    Vr = sched.resid_slots
    use_ring = sched.uses_stash_ring
    accumulate = sched.accumulate or plan.grad_sync == "per_round"
    # no schedule forwards from the stash at virtual stages
    assert not (sched.fwd_from_stash and vs > 1), sched.name
    tabs = sched.tables()
    # the model is cut into L chunks: init and statics see them as stages
    mplan = model_plan(plan, sched)
    statics = make_statics(spec, mplan, tokens_per_mb=mb * seq_len)
    d = spec.d_model

    def init_state(gen: torch.Generator):
        if gen.device != dev:
            raise ValueError(f"generator on {gen.device}, pipeline on {dev}")
        params = init_params(spec, mplan, gen, compute_dtype)
        return make_train_state(to_storage_order(params, sched), sched,
                                optimizer)

    def train_step(state, batch):
        params = state["params"]
        tokens, labels = batch["tokens"], batch["labels"]   # (R, Bmb, S)
        step = state["step"]
        pos = torch.arange(seq_len, device=dev).expand(mb, seq_len)
        kw = [dict(positions=pos, windows=params["layer_windows"][p],
                   thetas=params["layer_thetas"][p]) for p in range(L)]
        embeds = lm_head.embed_tokens(params["embed"], tokens, compute_dtype)
        weights = state["stash"]["current"]
        ring = state["stash"].get("ring")
        opt = state["opt_stages"]
        head, fnorm = params["head"], params["final_norm"]
        w_at = [tree_chunk(weights, p) for p in range(L)]
        opt_at = [tree_chunk(opt, p) for p in range(L)]

        resid = torch.zeros((Vr, S, mb, seq_len, d), dtype=compute_dtype,
                            device=dev)
        recv_f = [None] * S          # one-tick hand-off, stage s-1 -> s
        recv_b = [None] * S          # one-tick hand-off, stage s+1 -> s
        f32 = lambda a: torch.zeros(a.shape, dtype=torch.float32,  # noqa
                                    device=dev)
        if accumulate:
            gacc = tree_map(f32, weights)
            dhead_acc, dfnorm_acc = f32(head), tree_map(f32, fnorm)
        d_embeds = torch.zeros((R, mb, seq_len, d), dtype=compute_dtype,
                               device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        aux_sum = torch.zeros((), dtype=torch.float32, device=dev)

        for tick in range(sched.n_ticks):
            # ---- F phase ----------------------------------------------
            h_out = [None] * S
            for s in range(S):
                row = [int(c) for c in tabs.fwd[tick, s]]
                if row[F_MB] < 0:
                    continue
                p = s * vs + row[F_CHUNK]             # storage row
                x_in = embeds[row[F_MB]] if row[F_FROM_EMBEDS] else recv_f[s]
                if use_ring:
                    tree_chunk_ring_write(ring, row[F_STASH_WRITE], p,
                                          w_at[p])
                w_f = (tree_chunk_ring_read(ring, row[F_VERSION], p)
                       if sched.fwd_from_stash else w_at[p])
                with torch.no_grad():
                    h_out[s], aux = stage_fwd(w_f, x_in, statics,
                                              return_aux=True, **kw[p])
                resid[row[F_RESID_WRITE], s].copy_(x_in)
                aux_sum += aux
            # chunk hops wrap from the last stage back to stage 0
            recv_f = [h_out[S - 1] if vs > 1 else None] + h_out[:-1]

            # ---- head + loss for the exiting microbatch -----------------
            g_exit = None
            m_exit = int(tabs.exit_mb[tick])
            if m_exit >= 0:
                lab = labels[m_exit]
                loss, dh, dhead, dfnorm = lm_head.loss_and_grads(
                    head, fnorm, h_out[S - 1], lab.clamp_min(0),
                    norm_kind=spec.norm, valid_mask=(lab >= 0).float(),
                    vocab=spec.vocab)
                loss_sum += loss
                g_exit = dh.to(compute_dtype)
                if accumulate:
                    dhead_acc.add_(dhead)
                    tree_add_(dfnorm_acc, dfnorm)
                else:
                    optimizer.update_({"h": dhead, "f": dfnorm},
                                      state["opt_head"],
                                      {"h": head, "f": fnorm}, step)

            # ---- B phase ----------------------------------------------
            dx_out = [None] * S
            for s in range(S):
                row = [int(c) for c in tabs.bwd[tick, s]]
                if row[B_MB] < 0:
                    continue
                p = s * vs + row[B_CHUNK]
                g_in = g_exit if row[B_FROM_HEAD] else recv_b[s]
                w_used = (tree_chunk_ring_read(ring, row[B_VERSION], p)
                          if use_ring else w_at[p])
                x_saved = resid[row[B_RESID_READ], s]
                dW, dx_out[s] = stage_vjp(w_used, x_saved, statics, g_in,
                                          aux_weight, **kw[p])
                if accumulate:
                    tree_chunk_add(gacc, dW, p)
                else:
                    # only the chunk this row names moves
                    replicated_microbatch_update(optimizer, dW, opt_at[p],
                                                 w_at[p], step, True)
            recv_b = dx_out[1:] + [dx_out[0] if vs > 1 else None]
            b0 = int(tabs.demb_mb[tick])
            if b0 >= 0:
                d_embeds[b0].copy_(dx_out[0])

        # ---- round end ------------------------------------------------
        if accumulate:
            optimizer.update_(tree_map(lambda a: a / R, gacc), opt, weights,
                              step)
            optimizer.update_({"h": dhead_acc / R,
                               "f": tree_map(lambda a: a / R, dfnorm_acc)},
                              state["opt_head"], {"h": head, "f": fnorm},
                              step)
        d_table = lm_head.embed_bwd(params["embed"], tokens,
                                    d_embeds.float()).div_(R)
        optimizer.update_(d_table, state["opt_embed"], params["embed"], step)
        state["step"] = step + 1
        return state, {"loss": loss_sum / R, "aux": aux_sum / R}

    return PipelineBundle(
        spec=spec, plan=plan, statics=statics, sched=sched,
        train_step=train_step, init_state=init_state, seq_len=seq_len,
        microbatch_size=mb, device=dev)
