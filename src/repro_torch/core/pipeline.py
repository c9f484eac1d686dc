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

With no process grid, all stages run on one device, one after another
within a phase; the state is held as JAX's executor holds it:
stage-stacked ``[L, ...]`` weights and optimizer states, a ``[V, L,
...]`` weight-version ring and a ``[Vr, S, ...]`` residual ring, all
written in place.  With virtual stages (the interleaved family) the
model is cut into L = S·v chunks held in storage order (row s·v + j is
chunk j·S + s); a row's chunk column picks the storage row, the
hand-off wraps from the last stage back to stage 0 between chunks, the
async variant's ring is chunk-major and a per-microbatch update touches
only the chunk its B row names.  Every microbatch, slot and version
index comes from a table row; a bubble row is skipped (JAX runs it on
masked data).  Bit-exact (fp32) against the sequential oracle
core/reference.py.

With a :class:`~repro_torch.parallel.dist.RankGrid` (``grid=``) each
process is one rank (replica d, stage s) of a ``data × pp`` grid, the
counterpart of JAX's shard_map over a ``(data, stage)`` mesh: it holds
its stage's storage rows (s·v … s·v+v−1), their ring and optimizer
state, the embedding on stage 0, head and final norm on stage S−1 (its
``init_state`` draws only those, ``models/init.py::init_rank_params``),
and walks its own column of the same tables.  The hand-offs of a tick are
derived on both ends from :func:`handoffs` and posted as one
``batch_isend_irecv`` a phase.  Replica d trains on its block of every
microbatch (mb = global_batch / (dp·R) rows); the head divides by the
microbatch's valid-token count summed over the last stage's replicas
(JAX's head runs on the global microbatch), the aux cotangent is
``aux_weight / dp``, and every gradient is summed over its stage's data
group before its update — per microbatch, or the round's accumulator —
or with ``plan.zero1`` reduce-scattered onto a 1/dp shard of the
optimizer state and all-gathered back (core/versioning.py).  ``loss``
and ``aux`` are summed over the world, the same number on every rank.
At dp 1 the split alone changes no bit of the single-process executor.

At ``plan.tp`` > 1 (a ``data × pp × tp`` grid, JAX's ``tp_axis``) each
stage is cut over its tensor group: a rank holds tensor shard t of its
stage's sharded leaves (``models/init.py::tp_shard``) — and of their
ring and optimizer state — and runs its blocks with the group's
collectives (``models/nn.py``); the activations and their hand-offs
are whole on every tensor rank (rank (d, s, t) hands to (d, s ± 1, t)).
The embedding (stage 0) and the head (the last stage) are cut over the
tensor group as JAX cuts them (``models/lm_head.py``): rank t holds the
embedding's columns t·d/tp … and the head's vocabulary slice t·V/tp …,
and the optimizer state of its slice only; the final norm is every
rank's.  Every rank of stage 0 gathers its columns of a round's tokens
and the group joins them (an all-gather); every rank of the last stage
forms its slice of an exiting microbatch's logits, and the loss and
d(loss)/d(h) come out of the group's sums whole on every rank
(``lm_head.head_loss_sharded``); the metrics are t = 0's.  Data sums
and ZeRO-1 run over the data group of each (stage, tensor index).  A replicated leaf that a rank uses in part (the qk-norm
scales, KV weights replicated at n_kv < tp) has its ranks' shares
summed by its ``tp_enter`` inside B, so every replicated leaf gets one
gradient on every tensor rank and stays equal across them.  One process
runs tp 1 only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.core.reference import (encoder_grads, model_plan,
                                        run_encoder, with_patches)
from repro_torch.core.schedule import (B_CHUNK, B_FROM_HEAD, B_MB,
                                       B_RESID_READ, B_VERSION, F_CHUNK,
                                       F_FROM_EMBEDS, F_MB, F_RESID_WRITE,
                                       F_STASH_WRITE, F_VERSION,
                                       PipelineSchedule, make_schedule)
from repro_torch.core.versioning import (make_train_state,
                                         replicated_microbatch_update,
                                         row_axes, tree_add_, tree_chunk,
                                         tree_chunk_add,
                                         tree_chunk_ring_read,
                                         tree_chunk_ring_write,
                                         zero1_axes,
                                         zero1_microbatch_update)
from repro_torch.models import lm_head
from repro_torch.models import spec as spec_lib
from repro_torch.models.init import init_rank_params
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
    seq_len: int                    # positions a row: patches + text
    microbatch_size: int            # rows of a microbatch on one replica
    device: torch.device
    grid: object = None             # this rank's RankGrid, None: one process
    # observability (repro_torch.obs.Observability or None = off): the
    # driver reports one on_round("train", sched, ...) per executed round
    obs: object = None
    # a round's batch over every replica, key -> shape (JAX's
    # ``batch_shapes``): tokens / labels (R, rows, text_len), and the
    # frontends' patches (R, rows, n_patches, d) / frames (R, rows,
    # T_src, d_enc)
    batch_shapes: dict = None

    @property
    def text_len(self) -> int:
        return self.batch_shapes["tokens"][2]


def handoffs(tabs, tick: int):
    """The hand-offs from ``tick`` to ``tick + 1``: ``(forward, backward)``
    lists of (source stage, destination stage).  A forward pair is an
    activation the source's F row made at ``tick`` that the destination's
    F row at ``tick + 1`` reads (chunk hops wrap stage S−1 → 0); a
    backward pair a gradient the source's B row made that the
    destination's B row reads (wrapping 0 → S−1).  Sender and receiver
    both post from this list, so every send has its receive."""
    T, S = tabs.fwd.shape[:2]
    fwd, bwd = [], []
    if tick + 1 < T:
        for s in range(S):
            f, b = tabs.fwd[tick + 1, s], tabs.bwd[tick + 1, s]
            if f[F_MB] >= 0 and not f[F_FROM_EMBEDS]:
                fwd.append(((s - 1) % S, s))
            if b[B_MB] >= 0 and not b[B_FROM_HEAD]:
                bwd.append(((s + 1) % S, s))
    return fwd, bwd


def build_pipeline(spec: spec_lib.ModelSpec, plan, *, seq_len: int,
                   global_batch: int, optimizer, aux_weight: float = 0.01,
                   compute_dtype=torch.bfloat16, device=None, grid=None,
                   obs=None) -> PipelineBundle:
    """The pipelined train step for one (arch, plan): every stage on
    ``device`` (``cuda`` unless told otherwise), or with ``grid`` (a
    :class:`~repro_torch.parallel.dist.RankGrid` of ``data × plan.pp ×
    plan.tp`` ranks) this rank's tensor shard of this rank's stage of
    this rank's replica on the grid's device.  ``obs`` rides on the
    bundle for the driver to report into."""
    S, R, tp = plan.pp, plan.microbatches, plan.tp
    dp = 1
    if grid is None and tp != 1:
        raise ValueError(
            f"tp={tp}: a stage cut over {tp} tensor ranks runs on a grid of "
            f"data x pp x tp ranks, one process each: launch with torchrun "
            f"--nproc-per-node {S * tp} (x data replicas) or pass grid= "
            "(parallel/dist.py::init_grid)")
    if grid is not None:
        if (grid.topo.pp, grid.topo.tp) != (S, tp):
            raise ValueError(f"grid of {grid.topo.pp} stages x "
                             f"{grid.topo.tp} tensor ranks for a plan of "
                             f"pp={S}, tp={tp}")
        dp, dev = grid.topo.data, grid.device
    else:
        dev = resolve_device(device)
    if global_batch % (dp * R):
        raise ValueError(f"global_batch={global_batch} is not a multiple "
                         f"of {dp} replicas x R={R} microbatches")
    mb = global_batch // (dp * R)            # rows a replica's microbatch
    sched = make_schedule(plan)
    if sched.is_serving:
        raise ValueError(f"schedule {sched.name!r} is forward-only: it has "
                         "no backward slots to train with")
    sched.validate()
    vs = sched.virtual_stages               # local chunks per stage
    Vr = sched.resid_slots
    use_ring = sched.uses_stash_ring
    accumulate = sched.accumulate or plan.grad_sync == "per_round"
    # no schedule forwards from the stash at virtual stages
    assert not (sched.fwd_from_stash and vs > 1), sched.name
    tabs = sched.tables()
    moves = [handoffs(tabs, t) for t in range(sched.n_ticks)]
    # the model is cut into S·v chunks: init and statics see them as stages
    mplan = model_plan(plan, sched)
    # the frontends: a VLM's patch prefix, an encoder before the pipeline
    n_patch = spec.n_patches if spec.frontend == "vision" else 0
    has_enc = spec.encoder is not None
    if seq_len <= n_patch:
        raise ValueError(f"seq_len={seq_len} leaves no text after "
                         f"{n_patch} patches")
    batch_shapes = {k: (R, global_batch // R, seq_len - n_patch)
                    for k in ("tokens", "labels")}
    if n_patch:
        batch_shapes["patches"] = (R, global_batch // R, n_patch,
                                   spec.d_model)
    if has_enc:
        e = spec.encoder
        batch_shapes["frames"] = (R, global_batch // R, e.source_len,
                                  e.d_model)
    statics = make_statics(spec, mplan, tokens_per_mb=mb * seq_len)
    d = spec.d_model
    # the stages this process runs, and its storage rows: (s - s0)·v + j
    mine = list(range(S)) if grid is None else [grid.s]
    s0 = mine[0]
    first, last = 0 in mine, S - 1 in mine
    # this stage's data replicas: gradients are summed over them; its
    # tensor ranks: the blocks' collectives run over them
    group = grid.data_group if dp > 1 else None
    tensor = grid.tensor_group if tp > 1 else None
    t_index = 0 if grid is None else grid.t
    # every tensor rank of the first stage holds its columns of the
    # embedding, every one of the last stage its slice of the head
    embed_here, head_here = first, last
    zero1 = plan.zero1 and dp > 1
    aux_ct = aux_weight / dp

    def init_state(gen: torch.Generator):
        if gen.device != dev:
            raise ValueError(f"generator on {gen.device}, pipeline on {dev}")
        # this rank's rows only (every row in one process), drawn leaf by
        # leaf: a rank's tensors equal the single-process state's, bit for
        # bit
        params = init_rank_params(spec, mplan, gen, sched,
                                  None if grid is None else grid.s,
                                  compute_dtype, t=t_index)
        z1 = (zero1_axes(params["stages"], dp), grid.d, dp) if zero1 else None
        return make_train_state(params, sched, optimizer, zero1=z1)

    # a forward hand-off goes to the next stage (the last stage's to stage
    # 0 between chunks), a backward one to the previous
    down = up = None
    if grid is not None:
        down = grid.topo.downstream(grid.rank, wrap=vs > 1)
        up = grid.topo.upstream(grid.rank, wrap=vs > 1)

    def pass_on(pairs, outs, send_to, recv_from):
        """The hand-offs ``pairs`` of this tick's outputs ``outs`` (by
        stage): the local ones by reference, the others to rank
        ``send_to`` and from rank ``recv_from``, posted at once; the
        inputs of the next tick, by stage."""
        got, sends, recvs = {}, [], []
        for src, dst in pairs:
            if src in mine and dst in mine:
                got[dst] = outs[src]
            elif src in mine:
                sends.append((send_to, outs[src].contiguous()))
            elif dst in mine:
                got[dst] = torch.empty((mb, seq_len, d), dtype=compute_dtype,
                                       device=dev)
                recvs.append((recv_from, got[dst]))
        if sends or recvs:
            grid.exchange(sends, recvs)
        return got

    def train_step(state, batch):
        params = state["params"]
        tokens, labels = batch["tokens"], batch["labels"]   # (R, mb, S)
        step = state["step"]
        _, labels = with_patches(spec, None, labels, batch)
        if has_enc:
            # every rank runs the encoder on its replica's frames; each
            # stage writes its d(encoder output) a microbatch, and the
            # stages' shares meet once the round ends
            enc_ring, enc_pull = run_encoder(spec, params["encoder"],
                                             batch["frames"], compute_dtype)
            denc = torch.zeros((len(mine),) + tuple(enc_ring.shape),
                               dtype=compute_dtype, device=dev)
        pos = torch.arange(seq_len, device=dev).expand(mb, seq_len)
        n_rows = len(mine) * vs
        kw = [dict(positions=pos, windows=params["layer_windows"][q],
                   thetas=params["layer_thetas"][q]) for q in range(n_rows)]
        weights = state["stash"]["current"]
        ring = state["stash"].get("ring")
        opt = state["opt_stages"]
        w_at = [tree_chunk(weights, q) for q in range(n_rows)]
        opt_at = [tree_chunk(opt, q) for q in range(n_rows)]
        z1 = zero1_axes(weights, dp) if zero1 else None
        z1_row = row_axes(z1) if zero1 else None

        def update(grads, opt_state, w, axes):
            """An update of ``w`` from this replica's ``grads``, summed
            (or with ZeRO-1 reduce-scattered) over the data group."""
            if axes is None:
                replicated_microbatch_update(optimizer, grads, opt_state, w,
                                             step, True, group=group)
            else:
                zero1_microbatch_update(optimizer, grads, opt_state, w,
                                        step, True, axes=axes, group=group)

        resid = torch.zeros((Vr, len(mine), mb, seq_len, d),
                            dtype=compute_dtype, device=dev)
        recv_f, recv_b = {}, {}      # one-tick hand-offs, by stage
        f32 = lambda a: torch.zeros(a.shape, dtype=torch.float32,  # noqa
                                    device=dev)
        if embed_here:
            text = (lm_head.embed_tokens(params["embed"], tokens,
                                         compute_dtype) if tensor is None
                    else lm_head.embed_tokens_sharded(
                        params["embed"], tokens, tensor, compute_dtype))
            embeds, _ = with_patches(spec, text, None, batch)
            del text
            d_embeds = torch.zeros((R, mb, seq_len, d), dtype=compute_dtype,
                                   device=dev)
        if head_here:
            head, fnorm = params["head"], params["final_norm"]
            # the valid tokens of each microbatch over all replicas
            n_valid = None
            if group is not None:
                n_valid = group.all_reduce_((labels >= 0).sum(
                    dim=(1, 2), dtype=torch.float32))
        if accumulate:
            gacc = tree_map(f32, weights)
            if head_here:
                dhead_acc, dfnorm_acc = f32(head), tree_map(f32, fnorm)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        aux_sum = torch.zeros((), dtype=torch.float32, device=dev)

        for tick in range(sched.n_ticks):
            f_moves, b_moves = moves[tick]
            # ---- F phase ----------------------------------------------
            h_out = {}
            for s in mine:
                row = [int(c) for c in tabs.fwd[tick, s]]
                if row[F_MB] < 0:
                    continue
                q = (s - s0) * vs + row[F_CHUNK]      # storage row
                x_in = embeds[row[F_MB]] if row[F_FROM_EMBEDS] else recv_f[s]
                if use_ring:
                    tree_chunk_ring_write(ring, row[F_STASH_WRITE], q,
                                          w_at[q])
                w_f = (tree_chunk_ring_read(ring, row[F_VERSION], q)
                       if sched.fwd_from_stash else w_at[q])
                with torch.no_grad():
                    h_out[s], aux = stage_fwd(
                        w_f, x_in, statics, return_aux=True, tp=tensor,
                        cross_x=enc_ring[row[F_MB]] if has_enc else None,
                        **kw[q])
                resid[row[F_RESID_WRITE], s - s0].copy_(x_in)
                aux_sum += aux
            recv_f = pass_on(f_moves, h_out, down, up)

            # ---- head + loss for the exiting microbatch -----------------
            g_exit = None
            m_exit = int(tabs.exit_mb[tick])
            if m_exit >= 0 and head_here:
                lab = labels[m_exit]
                loss, dh, dhead, dfnorm = lm_head.loss_and_grads(
                    head, fnorm, h_out[S - 1], lab.clamp_min(0),
                    norm_kind=spec.norm, valid_mask=(lab >= 0).float(),
                    vocab=spec.vocab,
                    n_valid=None if n_valid is None else n_valid[m_exit],
                    tensor=tensor)
                loss_sum += loss
                g_exit = dh.to(compute_dtype)
                if accumulate:
                    dhead_acc.add_(dhead)
                    tree_add_(dfnorm_acc, dfnorm)
                else:
                    update({"h": dhead, "f": dfnorm}, state["opt_head"],
                           {"h": head, "f": fnorm}, None)

            # ---- B phase ----------------------------------------------
            dx_out = {}
            for s in mine:
                row = [int(c) for c in tabs.bwd[tick, s]]
                if row[B_MB] < 0:
                    continue
                q = (s - s0) * vs + row[B_CHUNK]
                g_in = g_exit if row[B_FROM_HEAD] else recv_b[s]
                w_used = (tree_chunk_ring_read(ring, row[B_VERSION], q)
                          if use_ring else w_at[q])
                x_saved = resid[row[B_RESID_READ], s - s0]
                if has_enc:
                    b = row[B_MB]
                    dW, dx_out[s], dcx = stage_vjp(
                        w_used, x_saved, statics, g_in, aux_ct, tp=tensor,
                        cross_x=enc_ring[b], **kw[q])
                    # a stage's chunks add into its share (v > 1)
                    denc[s - s0, b].add_(dcx)
                else:
                    dW, dx_out[s] = stage_vjp(w_used, x_saved, statics,
                                              g_in, aux_ct, tp=tensor,
                                              **kw[q])
                if accumulate:
                    tree_chunk_add(gacc, dW, q)
                else:
                    # only the chunk this row names moves
                    update(dW, opt_at[q], w_at[q], z1_row)
            recv_b = pass_on(b_moves, dx_out, up, down)
            b0 = int(tabs.demb_mb[tick])
            if b0 >= 0 and embed_here:
                d_embeds[b0].copy_(dx_out[0])

        # ---- round end ------------------------------------------------
        if accumulate:
            update(tree_map(lambda a: a / R, gacc), opt, weights, z1)
            if head_here:
                update({"h": dhead_acc / R,
                        "f": tree_map(lambda a: a / R, dfnorm_acc)},
                       state["opt_head"], {"h": head, "f": fnorm}, None)
        if embed_here:
            d_table = lm_head.embed_bwd(
                params["embed"], tokens, lm_head.embed_columns(
                    d_embeds[:, :, n_patch:], tensor).float()).div_(R)
            update(d_table, state["opt_embed"], params["embed"], None)
        if has_enc:
            if grid is not None and S > 1:
                # every stage's share, gathered over the replica's stages
                # (at this tensor index) and summed in stage order
                every = torch.empty((S,) + tuple(denc.shape[1:]),
                                    dtype=denc.dtype, device=dev)
                grid.pipe_group.all_gather_(denc, every, 0)
                denc = every
            g_enc = encoder_grads(enc_pull, list(denc), R)
            del denc, enc_ring, enc_pull
            update(g_enc, state["opt_encoder"], params["encoder"], None)
        state["step"] = step + 1
        if grid is not None:
            # the replicas' and stages' parts of the round's metrics
            # (every tensor rank holds the same ones: t = 0's count)
            parts = torch.stack([loss_sum, aux_sum])
            if t_index:
                parts.zero_()
            parts = grid.world_group.all_reduce_(parts)
            loss_sum, aux_sum = parts[0], parts[1] / dp
        return state, {"loss": loss_sum / R, "aux": aux_sum / R}

    return PipelineBundle(
        spec=spec, plan=plan, statics=statics, sched=sched,
        train_step=train_step, init_state=init_state, seq_len=seq_len,
        microbatch_size=mb, device=dev, grid=grid, obs=obs,
        batch_shapes=batch_shapes)
