"""Baselines the paper compares against (§5; port of
``repro/core/baselines.py``).

  * BSP data parallelism — the model replicated on every rank of a
    ``(data, 1)`` process grid, the batch split over the replicas, the
    gradients summed over them every minibatch (the paper's main
    baseline).
  * ASP — relaxed sync as local SGD: each replica updates with its own
    gradient and the replicas average their parameters every
    ``sync_every`` minibatches.  (The JAX package computes the same flag
    and does not use it: its ``sync_every > 1`` runs BSP.)
  * Model parallelism without pipelining — the pipeline with R = 1: one
    minibatch in flight, one stage busy at a time (paper Figure 3).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.core.pipeline import build_pipeline
from repro_torch.models import lm_head
from repro_torch.models import spec as spec_lib
from repro_torch.models.init import init_params
from repro_torch.models.stage import make_statics, stage_fwd, stage_params
from repro_torch.optim.optimizers import tree_map
from repro_torch.parallel.plan import ParallelismPlan

_STATIC = ("layer_windows", "layer_thetas")


@dataclasses.dataclass
class BSPBundle:
    train_step: Callable            # (state, batch) -> (state, metrics)
    init_state: Callable            # (torch.Generator) -> state
    device: torch.device


def build_bsp(spec: spec_lib.ModelSpec, grid=None, *, seq_len: int,
              global_batch: int, optimizer, sync_every: int = 1,
              compute_dtype=torch.bfloat16, aux_weight: float = 0.01,
              device=None) -> BSPBundle:
    """Data-parallel BSP (``sync_every`` = 1) or ASP as local SGD (> 1)
    over the data replicas of ``grid`` (a
    :class:`~repro_torch.parallel.dist.RankGrid` with one stage; None: one
    process on ``device``).  A batch is this replica's ``global_batch /
    dp`` rows: ``{"tokens", "labels"}`` of shape (rows, seq_len).

    BSP divides each replica's loss by the valid tokens of the whole
    batch and sums the gradients, so a step equals one whole-batch step;
    its ``loss`` is the whole batch's.  ASP's replicas each take their
    own mean; its ``loss`` is the replicas' mean."""
    if grid is not None and grid.topo.pp != 1:
        raise ValueError(f"BSP replicates the whole model: a grid of one "
                         f"stage, not {grid.topo.pp}")
    dev = grid.device if grid is not None else resolve_device(device)
    dp = grid.topo.data if grid is not None else 1
    if global_batch % dp:
        raise ValueError(f"global_batch={global_batch} does not split over "
                         f"{dp} replicas")
    group = grid.data_group if dp > 1 else None
    plan = ParallelismPlan(pp=1, tp=1, microbatches=1, stash_mode="flush")
    statics = make_statics(spec, plan, tokens_per_mb=seq_len)
    asp = sync_every > 1

    def init_state(gen: torch.Generator):
        params = init_params(spec, plan, gen, compute_dtype)
        diffable = {k: v for k, v in params.items() if k not in _STATIC}
        return {"params": params, "opt": optimizer.init(diffable), "step": 0}

    def train_step(state, batch):
        params, step = state["params"], state["step"]
        tokens, labels = batch["tokens"], batch["labels"]
        diffable = {k: v for k, v in params.items() if k not in _STATIC}
        valid = (labels >= 0).float()
        n_valid = valid.sum()
        if group is not None and not asp:
            group.all_reduce_(n_valid)
        with torch.enable_grad():
            w = tree_map(lambda a: a.detach().requires_grad_(), diffable)
            x = lm_head.embed_tokens(w["embed"], tokens, compute_dtype)
            pos = torch.arange(seq_len, device=dev).expand(tokens.shape)
            x, aux = stage_fwd(stage_params(w, 0), x, statics,
                               positions=pos,
                               windows=params["layer_windows"][0],
                               thetas=params["layer_thetas"][0],
                               return_aux=True)
            loss, _ = lm_head.head_loss(
                w["head"], w["final_norm"]["scale"], x, labels.clamp_min(0),
                norm_kind=spec.norm, norm_bias=w["final_norm"].get("bias"),
                valid_mask=valid, vocab=spec.vocab, n_valid=n_valid)
            total = loss + aux_weight * aux / (1 if asp else dp)
            leaves = []
            tree_map(leaves.append, w)
            grads = iter(torch.autograd.grad(total, leaves,
                                             materialize_grads=True))
        grads = tree_map(lambda _: next(grads), w)
        if group is not None and not asp:
            tree_map(group.all_reduce_, grads)
        optimizer.update_(grads, state["opt"], diffable, step)
        if group is not None and asp and (step + 1) % sync_every == 0:
            tree_map(lambda a: group.all_reduce_(a).div_(dp), diffable)
        metrics = torch.stack([loss.detach(), aux.detach()])
        if group is not None:
            # BSP's losses are parts of one mean; ASP's are the replicas'
            group.all_reduce_(metrics).div_(torch.tensor(
                [dp if asp else 1.0, dp], device=dev))
        state["step"] = step + 1
        return state, {"loss": metrics[0], "aux": metrics[1]}

    return BSPBundle(train_step=train_step, init_state=init_state,
                     device=dev)


def build_model_parallel(spec, plan, **kw):
    """Paper Figure 3: model parallelism without pipelining, the R = 1
    flush pipeline (``kw`` as :func:`~repro_torch.core.pipeline.
    build_pipeline` takes them, ``grid`` included)."""
    return build_pipeline(spec, plan.with_(microbatches=1,
                                           stash_mode="flush"), **kw)
