"""Dry run of (arch x shape) cells at production scale, on ``meta``
(port of ``repro/launch/dryrun.py``).

JAX's dry run lowers and compiles each cell for a 16 x 16 (or 2 x 16 x
16) device mesh on emulated host devices and reads XLA's memory and cost
analyses.  The port allocates nothing instead: for each cell at the
config's ``PLAN`` (or ``--plan-search``'s) over ``--cards`` cards (256:
JAX's 16 x 16 production mesh, so the rows sit beside JAX's; 512: the
two-pod mesh), of which pp x tp hold one replica, it reports

  * memory: one rank's state bytes, counted on ``meta``
    (``models/init.py::MetaGenerator`` makes every leaf's shape without
    drawing): a training rank's stage (tensor shard 0 of the first or
    the last stage, whichever is larger) with its version ring and
    optimizer state, as ``core/pipeline.py`` builds it on a grid; a
    serving replica's weights and caches over its pp x tp cards.  Beside
    them the analytic ``memory_model`` of ``core/schedule.py`` and the
    verdict against an H100's 80 GB;
  * work: the op counts (``launch/op_analysis.py``) of one step of one
    replica run on ``meta`` at tp 1 (``launch/cell.py``), split over its
    pp x tp cards; the collective bytes from the planner's own analytic
    counts: the schedule tables' hand-offs of the busiest stage, the
    data group's weight sync (``ps_factor``·(dp−1)/dp of a stage's
    weights, each microbatch or each round) and the tensor group's
    all-reduces (2(tp−1)/tp of a block's activations, twice a block and
    pass);
  * the roofline row (``launch/roofline.py``) with JAX's model FLOPs.

A cell whose step reads data on the host (a data-dependent shape: the
speculative verify's acceptance) cannot run on ``meta``; the dry run
prints why, as JAX's ``--all`` prints a failed cell.  JSON goes to
``experiments/dryrun_torch/``.  The counts run on ``meta`` whatever the
device; like every entry point it asks for the card unless given
``--device cpu``.

  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k \\
      --device cpu
  python -m repro_torch.launch.dryrun --all --device cpu
  python -m repro_torch.launch.dryrun --arch qwen3-14b \\
      --shape decode_32k --page-size 16 --cards 512 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from types import SimpleNamespace

import torch

from repro_torch import configs, resolve_device
from repro_torch.core import profiler as prof
from repro_torch.launch import roofline as RL

OUT_DIR = "experiments/dryrun_torch"


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def train_rank_bytes(spec, plan, *, seq_len: int, global_batch: int,
                     dp: int, optimizer, dtype) -> int:
    """The larger of the first and the last stage's training state at
    tensor index 0 of replica 0 of a data x pp x tp grid, built on
    ``meta`` as ``core/pipeline.py`` builds a rank's."""
    from repro_torch.core.pipeline import build_pipeline
    from repro_torch.models.init import MetaGenerator
    from repro_torch.parallel.dist import ProcessGrid
    topo = ProcessGrid(dp, plan.pp, plan.tp)
    worst = 0
    for s in sorted({0, plan.pp - 1}):
        rank = SimpleNamespace(
            topo=topo, rank=topo.rank_of(0, s, 0), d=0, s=s, t=0,
            device=torch.device("meta"), data_group=None,
            tensor_group=None, pipe_group=None, world_group=None)
        bundle = build_pipeline(spec, plan, seq_len=seq_len,
                                global_batch=global_batch,
                                optimizer=optimizer, compute_dtype=dtype,
                                grid=rank)
        worst = max(worst, tree_bytes(bundle.init_state(MetaGenerator())))
    return worst


def analytic_collectives(cell, plan, dp: int, hw) -> dict:
    """A card's collective bytes a step from the planner's counts."""
    from repro_torch.core.pipeline import handoffs
    from repro_torch.core.profiler import ACT_BYTES
    from repro_torch.models import spec as spec_lib
    spec, esz = cell.spec, ACT_BYTES
    sched = cell.bundle.sched
    train = cell.kind == "train"
    rows = cell.bundle.microbatch_size if train else cell.bundle.rows
    qlen = cell.seq_len if cell.kind in ("train", "prefill", "admit") else 1
    a_bytes = rows * qlen * spec.d_model * esz
    tabs = sched.tables()
    sends = [0] * sched.n_stages
    if train:
        for t in range(sched.n_ticks):
            fwd, bwd = handoffs(tabs, t)
            for src, _ in fwd + bwd:
                sends[src] += 1
    else:
        sends = [sched.n_microbatches * sched.virtual_stages] * \
            sched.n_stages
        sends[-1] -= sched.n_microbatches
    handoff = max(sends) * a_bytes if sched.n_stages > 1 else 0.0
    sync = 0.0
    if train and dp > 1:
        w_stage = sum(spec_lib._block_params(spec, b)
                      for b in spec.blocks) / plan.pp / plan.tp
        syncs = (1 if sched.accumulate or plan.grad_sync == "per_round"
                 else plan.microbatches)
        sync = syncs * hw.ps_factor * (dp - 1) / dp * w_stage \
            * hw.param_bytes
    tensor = 0.0
    if plan.tp > 1:
        passes = (3 if plan.remat else 2) if train else 1
        blocks = spec.n_layers / plan.pp
        tensor = (2 * passes * blocks * sched.n_microbatches
                  * 2 * (plan.tp - 1) / plan.tp * a_bytes)
    return {"handoff": float(handoff), "data_sync": float(sync),
            "tensor": float(tensor)}


def _data_replicas(cards: int, plan) -> int:
    return max(cards // (plan.pp * plan.tp), 1)


def run_cell(arch: str, shape: str, *, cards: int = 256,
             out_dir: str = OUT_DIR, plan=None,
             do_plan_search: bool = False, hw=prof.H100_SXM,
             page_size: int = 0, spec_k=None, weight_dtype=None,
             kv_dtype=None) -> dict:
    """Dry-run one cell (see the module docstring); its JSON record (the
    roofline's fields, the state bytes a rank, the memory model, the
    verdict, the replica's op count), also written to ``out_dir``."""
    from repro_torch.launch.cell import _fit_microbatches, build_cell
    from repro_torch.launch.op_analysis import count_call
    from repro_torch.optim.optimizers import by_name
    cfg = configs.get(arch)
    spec, base = cfg.full_spec(), plan or cfg.PLAN
    sh = configs.SHAPES[shape]
    tag = f"[{arch} x {shape} @ {cards} cards]"
    if do_plan_search:
        from repro_torch.runtime.driver import plan_search_report
        workload = {"train": "train", "prefill": "prefill",
                    "decode": "decode", "long_decode": "decode"}[sh.kind]
        base = plan_search_report(
            spec, base, hw, seq_len=sh.seq_len,
            global_batch=sh.global_batch,
            data_replicas=_data_replicas(cards, base), prefix=tag + " ",
            workload=workload, sp=sh.kind == "long_decode",
            weight_dtype=None if sh.kind == "train" else weight_dtype,
            kv_dtype=None if sh.kind == "train" else kv_dtype).plan
    if sh.kind not in ("prefill", "decode"):
        page_size = 0
    if sh.kind != "decode":
        spec_k = None
    if sh.kind == "train":
        weight_dtype = kv_dtype = None
    dp = _data_replicas(cards, base)
    gb = max(sh.global_batch // dp, 1)
    t0 = time.perf_counter()
    # memory: one rank's state, and the analytic model
    if sh.kind == "train":
        plan_dp = _fit_microbatches(base, sh.global_batch, dp)
        state = train_rank_bytes(spec, plan_dp, seq_len=sh.seq_len,
                                 global_batch=sh.global_batch, dp=dp,
                                 optimizer=by_name(*cfg.OPTIMIZER),
                                 dtype=torch.bfloat16)
    cell = build_cell(arch, shape, plan=base, global_batch=gb,
                      device="meta", page_size=page_size, spec_k=spec_k)
    sched = cell.bundle.sched
    if cell.kind == "train":
        label = "schedule"
        mm = sched.memory_model(
            spec, base, hw, microbatch_tokens=cell.bundle.microbatch_size
            * cell.seq_len, data_replicas=dp)
    else:
        label = "serve"
        sp = sh.kind == "long_decode"
        mm = sched.memory_model(
            spec, base, hw,
            microbatch_tokens=cell.bundle.rows * (
                sh.seq_len if sh.kind == "prefill" else 1),
            data_replicas=dp, cache_len=cell.cache_len,
            global_batch=sh.global_batch, sp=sp,
            prefill=sh.kind == "prefill",
            page_size=0 if sp else page_size, weight_dtype=weight_dtype,
            kv_dtype=kv_dtype)
        s = cell.bundle
        state = (tree_bytes(s.params) + tree_bytes(s.cache)
                 + tree_bytes(s.pages)) // (base.pp * base.tp)
    fits = mm.fits(hw.hbm_bytes) and state <= hw.hbm_bytes
    # work: one replica's step on meta, split over its cards
    _, cost = count_call(cell.run)
    split = base.pp * base.tp
    per_card = cost.scaled(1.0 / split)
    per_card.per_collective = analytic_collectives(cell, base, dp, hw)
    per_card.coll_operand_bytes = sum(per_card.per_collective.values())
    plan_name = (f"pp{base.pp}xtp{base.tp}x{base.stash_mode}"
                 f"xR{cell.microbatches}"
                 + (f"+iv{base.virtual_stages}" if base.virtual_stages > 1
                    else "") + ("+zero1" if base.zero1 else ""))
    r = RL.from_counts(
        per_card, arch=arch, shape=shape, cards=str(cards), plan=plan_name,
        model_flops_per_device=RL.model_flops_per_device(spec, sh, cards),
        dtype="bfloat16", hw=hw)
    seconds = time.perf_counter() - t0
    print(f"{tag} {cell.kind}: replica of {split} cards (dp {dp}, "
          f"{gb} rows a replica)")
    print(f"  state a rank {state / 1e9:.2f} GB; {label} memory_model "
          f"(analytic): {mm}")
    print(f"  budget {hw.hbm_bytes / 1e9:.1f} GB -> "
          f"{'fits' if fits else 'OVER'}")
    print("  " + RL.fmt_row(r))
    print(f"  collective bytes a card: "
          f"{ {k: f'{v:.3e}' for k, v in r.per_collective.items()} }; "
          f"kernel calls a replica {cost.kernel_calls}; "
          f"{cost.aten_ops} ATen ops; {seconds:.1f}s")
    os.makedirs(out_dir, exist_ok=True)
    rec = {**r.to_json(), "state_bytes_per_rank": state,
           "memory_model": {"total_bytes": mm.total_bytes,
                            "text": str(mm)},
           "fits": fits, "data_replicas": dp, "replica_batch": gb,
           "cuts": {k: list(v) for k, v in cell.cuts.items()},
           "op_count_replica": cost.to_json(), "seconds": seconds}
    with open(os.path.join(out_dir, f"{arch}__{shape}__{cards}.json"),
              "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(configs.SHAPES) + [None])
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell of configs.cells()")
    ap.add_argument("--cards", type=int, default=256,
                    help="256: JAX's 16 x 16 production mesh; 512: two pods")
    ap.add_argument("--out", type=str, default=OUT_DIR)
    ap.add_argument("--plan-search", action="store_true",
                    help="let plan_search pick (pp, tp, schedule, "
                         "virtual_stages) under an H100's memory")
    ap.add_argument("--page-size", type=int, default=0,
                    help="serving shapes: the paged KV cache")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="decode shapes: the speculative verify step")
    ap.add_argument("--weight-dtype", type=str, default=None,
                    choices=[None, "fp32", "bf16", "int8", "fp8"],
                    help="serving shapes: price quantized weights in the "
                         "analytic memory model")
    ap.add_argument("--kv-dtype", type=str, default=None,
                    choices=[None, "fp32", "bf16", "int8"],
                    help="serving shapes: the KV cache's storage dtype in "
                         "the analytic memory model")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the counts run on meta; cuda (default) asks for "
                         "the card like every entry point, cpu does not")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    torch.set_num_threads(1)
    kw = dict(cards=args.cards, out_dir=args.out,
              do_plan_search=args.plan_search, page_size=args.page_size,
              spec_k=args.spec_k, weight_dtype=args.weight_dtype,
              kv_dtype=args.kv_dtype)
    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        run_cell(args.arch, args.shape, **kw)
        return
    failures, uncounted = [], []
    for arch, shape, ok, why in configs.cells():
        if not ok:
            print(f"[{arch} x {shape}] SKIP: {why}")
            continue
        try:
            run_cell(arch, shape, **kw)
        except Exception as e:
            if "meta" in str(e).lower():
                uncounted.append((arch, shape))
                print(f"[{arch} x {shape}] NOT COUNTED on meta: the step "
                      f"reads data on the host ({type(e).__name__}: {e})")
            else:
                failures.append((arch, shape))
                traceback.print_exc()
    if uncounted:
        print(f"cells not countable on meta: {uncounted}")
    if failures:
        print(f"FAILED cells: {failures}")
        sys.exit(1)
    print("every runnable cell counted or explained")


if __name__ == "__main__":
    main()
