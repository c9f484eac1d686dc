"""Pipelined training (port of ``repro/launch/train.py``): ``--steps``
rounds of the paper's schedule on the synthetic LM stream.

One process (no torchrun, or a world of one) runs every stage of the
plan on one device through the fault-tolerant
:class:`~repro_torch.runtime.driver.TrainDriver` (per-stage checkpoints
every ``--ckpt-every`` rounds, restart from the last round every stage
checkpointed); it runs plans of tp 1 (the smoke plans).  Under torchrun
each process is one rank of a ``--data`` x pp x tp grid
(``parallel/dist.py``), tp the plan's: rank (d·pp + s)·tp + t runs
tensor shard t of stage s of replica d on ``cuda:LOCAL_RANK`` when the
machine has a card per rank, or on
``cuda:0`` when it has one card; ``--backend nccl`` needs a card per
rank, ``--backend gloo`` stages hand-offs and collectives through host
memory, so ranks may share one card (or run on the CPU).  Each rank
prints the grid line with its device; rank 0 prints the plan and the
loss.  Several ranks run the same driver, each over its own stage:
every rank writes its own checkpoint rows and rank 0 the shared files
(``checkpoint/manager.py``), into ``--ckpt`` or a temporary directory
of rank 0's.

``--trace-out`` / ``--metrics-out`` write the run's Chrome trace (one
track per stage) and metrics snapshot (``repro_torch.obs``); on several
ranks each rank writes its own, ``.rank<r>`` before the extension, its
registry holding every stage's measured ``stage_round_seconds``.  Every
run prints the ``reconcile`` line (rank 0 on several ranks), and
``--replan`` on several ranks prints what ``replan_from_registry``
makes of the measured stage seconds.

Runs on the card by default (``--device cpu`` runs the plain PyTorch
versions of the kernels).  ``--smoke`` trains the architecture's small
smoke spec in fp32; otherwise the full spec in bf16 (``--layers N``
keeps its first N layers).  ``--plan-search`` lets the planner pick
(pp, tp, schedule, virtual_stages) for the plan's model axis of pp × tp
cards per replica, with ``--data`` replicas, under an H100's memory; as
in the JAX launcher there is no ``--tp``: tp is the plan's (the full
specs' plans cut stages over 2-8 tensor ranks) or the planner's.
Prints the plan line with the predicted bubble, then ``loss a -> b``.
A model with a frontend trains on the stubs' patches or frames beside
the text (``data/pipeline.py``); a VLM's ``--seq-len`` is at least its
patch prefix and 16 text tokens.

  python -m repro_torch.launch.train --arch qwen3-14b --smoke --steps 3 \
      --device cpu
  python -m repro_torch.launch.train --arch qwen3-14b --smoke --steps 4 \
      --device cpu --schedule interleaved_async --virtual-stages 2 \
      --microbatches 4 --ckpt /tmp/ckpt --ckpt-every 2
  python -m repro_torch.launch.train --arch whisper-medium --smoke \
      --steps 3 --device cpu
  python -m repro_torch.launch.train --arch llava-next-34b --smoke \
      --steps 3 --device cpu
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch qwen3-14b --pp 2 --layers 4 --seq-len 4096 --microbatches 4 \
      --global-batch 4 --plan-search     # a pp x tp plan of 4 ranks
  torchrun --standalone --nproc-per-node 8 -m repro_torch.launch.train \
      --arch qwen3-14b --smoke --data 2 --pp 2 --microbatches 4 \
      --device cpu --backend gloo        # the smoke plan at tp 1: 4 ranks
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --arch qwen3-14b --smoke --data 2 --pp 2 --microbatches 4 \
      --device cpu --backend gloo
  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
      --arch qwen3-14b --smoke --pp 2 --microbatches 4 --device cpu \
      --steps 4 --ckpt /tmp/ckpt --ckpt-every 2 --trace-out /tmp/t.json \
      --metrics-out /tmp/m.json --replan
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile

import torch

from repro_torch import configs, resolve_device
from repro_torch.core.pipeline import build_pipeline
from repro_torch.core.schedule import (SCHEDULES, make_schedule,
                                       plan_kwargs_for_schedule,
                                       virtual_stages_error,
                                       weighted_round_time)
from repro_torch.data.pipeline import Loader, SyntheticLM, frontend_stub
from repro_torch.obs import Observability, reconcile, stage_seconds
from repro_torch.optim.optimizers import by_name
from repro_torch.parallel.dist import ProcessGrid, close_grid, init_grid
from repro_torch.runtime.driver import (DriverConfig, TrainDriver,
                                        plan_search_report,
                                        replan_from_registry)


def cut_layers(spec, n: int):
    """The spec's first ``n`` layers at full width."""
    if not 0 < n <= spec.n_layers:
        raise ValueError(f"--layers {n} outside 1..{spec.n_layers}")
    return dataclasses.replace(spec, name=f"{spec.name}-{n}l", n_layers=n,
                               blocks=spec.blocks[:n])


def make_plan(args):
    """(spec, plan, optimizer) for the parsed arguments."""
    cfg = configs.get(args.arch)
    if args.smoke:
        spec, plan = cfg.smoke_spec(), cfg.SMOKE_PLAN
    else:
        spec, plan = cfg.full_spec(), cfg.PLAN
        if args.layers:
            spec = cut_layers(spec, args.layers)
    err = virtual_stages_error(args.schedule, args.virtual_stages)
    if err:
        raise SystemExit(err)
    plan = plan.with_(microbatches=args.microbatches)
    if args.pp:
        plan = plan.with_(pp=args.pp)
    if args.stash_mode:
        plan = plan.with_(stash_mode=args.stash_mode)
    if args.schedule:
        plan = plan.with_(**plan_kwargs_for_schedule(
            args.schedule, virtual_stages=args.virtual_stages,
            stash_mode=plan.stash_mode))
    if spec.frontend == "vision":
        # a row holds the patch prefix and some text (JAX train.py:56-57)
        args.seq_len = max(args.seq_len, spec.n_patches + 16)
    if args.plan_search:
        plan = plan_search_report(spec, plan, seq_len=args.seq_len,
                                  global_batch=args.global_batch,
                                  data_replicas=args.data).plan
    name, lr = cfg.OPTIMIZER
    return spec, plan, by_name(args.optimizer or name, args.lr or lr)


def build(args, grid=None, made=None, obs=None):
    """(spec, bundle) for the parsed arguments: one process, or this rank
    of ``grid``; ``made``: :func:`make_plan`'s result, if it ran."""
    spec, plan, opt = made or make_plan(args)
    bundle = build_pipeline(
        spec, plan, seq_len=args.seq_len, global_batch=args.global_batch,
        optimizer=opt, device=args.device, grid=grid, obs=obs,
        compute_dtype=torch.float32 if args.smoke else torch.bfloat16)
    return spec, bundle


def make_loader(spec, bundle, seed: int) -> Loader:
    """The round's batches: the SyntheticLM text stream from ``seed``
    and, for a model with a frontend, its patches or frames from the
    stubs (``data/pipeline.py``); on a grid, this replica's rows."""
    grid = bundle.grid
    replica, replicas = (0, 1) if grid is None else (grid.d, grid.topo.data)
    extra = {k: v for k, v in bundle.batch_shapes.items()
             if k not in ("tokens", "labels")}
    return Loader(SyntheticLM(spec.vocab, bundle.text_len, seed=seed),
                  bundle.plan.microbatches,
                  bundle.microbatch_size * replicas, bundle.device,
                  replica=replica, replicas=replicas,
                  extra_fn=frontend_stub(seed), extra_shapes=extra)


def make_driver(args, spec, bundle, ckpt_dir: str, failure_hook=None):
    """The TrainDriver for the parsed arguments: :func:`make_loader`'s
    batches from ``--seed``, checkpoints every ``--ckpt-every``
    rounds."""
    loader = make_loader(spec, bundle, args.seed)
    return TrainDriver(bundle, loader, ckpt_dir,
                       DriverConfig(checkpoint_every=args.ckpt_every),
                       failure_hook=failure_hook, seed=args.seed)


def rank_path(path, grid):
    """``path`` with ``.rank<r>`` before its extension on several ranks."""
    if not path or grid is None or grid.topo.world == 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.rank{grid.rank}{ext}"


def plan_line(bundle) -> str:
    plan, sched = bundle.plan, bundle.sched
    _, bubble = weighted_round_time(sched)
    return (f"plan: pp={plan.pp} tp={plan.tp} schedule={sched.name}"
            + (f" v={plan.virtual_stages}" if plan.virtual_stages > 1
               else "")
            + f" stash_mode={plan.stash_mode} R={plan.microbatches} "
            f"predicted_bubble={bubble:.3f}")


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", type=str, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the full spec's first N layers (0 = all)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--pp", type=int, default=0,
                    help="pipeline stages (0 = the config's)")
    ap.add_argument("--schedule", type=str, default=None,
                    choices=[None, *sorted(n for n, c in SCHEDULES.items()
                                           if not c.is_serving)],
                    help="override the plan's pipeline schedule")
    ap.add_argument("--virtual-stages", type=int, default=None,
                    help="model chunks per stage (interleaved schedules)")
    ap.add_argument("--plan-search", action="store_true",
                    help="let plan_search pick (pp, tp, schedule, "
                         "virtual_stages) under an H100's memory")
    ap.add_argument("--stash-mode", type=str, default=None,
                    choices=[None, "stash", "vertical", "flush", "2bw"])
    ap.add_argument("--optimizer", type=str, default=None,
                    choices=[None, "sgdm", "rmsprop", "adam"])
    ap.add_argument("--lr", type=float, default=None,
                    help="learning rate (default: the config's)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the data stream")
    ap.add_argument("--ckpt", type=str, default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at exit)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log", type=str, default=None,
                    help="write {arch, losses, seconds} as JSON here")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="write a Chrome trace-event JSON of every "
                         "training round (one track per stage; open in "
                         "Perfetto / chrome://tracing)")
    ap.add_argument("--metrics-out", type=str, default=None,
                    help="write the metrics-registry snapshot JSON "
                         "(schema-checked by scripts/bench_check.py)")
    ap.add_argument("--replan", action="store_true",
                    help="on several ranks: print replan_from_registry's "
                         "plan for the measured stage seconds")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--data", type=int, default=1,
                    help="data replicas of the pipeline (under torchrun: "
                         "the world is data x pp x tp ranks)")
    ap.add_argument("--backend", type=str, default=None,
                    choices=[None, "nccl", "gloo"],
                    help="torch.distributed backend under torchrun "
                         "(default: nccl on the card, gloo on the CPU); "
                         "gloo lets ranks share one card")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    args.device = str(resolve_device(args.device))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    made = make_plan(args)
    if world > 1 or args.data > 1 or made[1].tp > 1:
        return main_ranks(args, world, made)
    if args.replan:
        raise SystemExit("--replan: stage seconds are measured on several "
                         "ranks (one process runs every stage); launch "
                         "with torchrun")
    obs = Observability(trace=bool(args.trace_out))
    spec, bundle = build(args, made=made, obs=obs)
    print(plan_line(bundle), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        driver = make_driver(args, spec, bundle, args.ckpt or tmp)
        state = bundle.init_state(
            torch.Generator(bundle.device).manual_seed(args.seed))
        with obs.timer("launch_phase_seconds", phase="run") as t:
            state, step = driver.run(state, args.steps)
    losses = [m["loss"] for m in driver.metrics_log]
    report(args, spec, step, t.elapsed, losses)
    finish(args, bundle, obs)
    return losses


def main_ranks(args, world: int, made):
    """This process's rank of a ``--data`` x pp x tp grid under torchrun:
    the driver over this rank's tensor shard of its stage, checkpoints
    rank by rank; rank 0 prints the plan, the loss and the reconcile
    line."""
    plan = made[1]
    need = args.data * plan.pp * plan.tp
    if world != need:
        raise SystemExit(f"--data {args.data} x pp {plan.pp} x tp {plan.tp} "
                         f"needs {need} ranks; the world has {world} "
                         f"(launch with torchrun --nproc-per-node {need})")
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    grid = init_grid(ProcessGrid(args.data, plan.pp, plan.tp), backend,
                     device=args.device)
    tmp = None
    try:
        print(f"grid: {grid.describe()}", flush=True)
        obs = Observability(trace=bool(args.trace_out))
        spec, bundle = build(args, grid, made, obs)
        if grid.rank == 0:
            print(plan_line(bundle) + f" data={args.data}", flush=True)
            if not args.ckpt:
                tmp = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        # one checkpoint directory for every rank: rank 0's
        ckpt = args.ckpt or grid.world_group.all_gather_object(tmp)[0]
        driver = make_driver(args, spec, bundle, ckpt)
        state = bundle.init_state(
            torch.Generator(grid.device).manual_seed(args.seed))
        with obs.timer("launch_phase_seconds", phase="run") as t:
            state, step = driver.run(state, args.steps)
        losses = [m["loss"] for m in driver.metrics_log]
        if grid.rank == 0:
            report(args, spec, step, t.elapsed, losses)
        finish(args, bundle, obs)
        if args.replan and grid.rank == 0:
            mb_tokens = bundle.seq_len * bundle.microbatch_size
            new, changed = replan_from_registry(
                spec, plan, obs.registry, minibatch_tokens=mb_tokens,
                data_replicas=args.data)
            print(f"replan: stage seconds "
                  f"{[round(x, 4) for x in stage_seconds(obs.registry, plan.pp)]}"
                  f" -> pp={new.pp} tp={new.tp} "
                  f"schedule={make_schedule(new).name} "
                  f"v={new.virtual_stages} rebalanced={changed}", flush=True)
        grid.world_group.barrier()
    finally:
        close_grid()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return losses


def finish(args, bundle, obs):
    """The reconcile line (rank 0) and this rank's trace / metrics files."""
    grid = bundle.grid
    if grid is None or grid.rank == 0:
        print(" ", reconcile(bundle.sched, trace=obs.trace,
                             registry=obs.registry, kind="train"),
              flush=True)
    trace_out = rank_path(args.trace_out, grid)
    metrics_out = rank_path(args.metrics_out, grid)
    obs.save(trace_out=trace_out, metrics_out=metrics_out)
    if trace_out:
        print(f"wrote pipeline trace to {trace_out}", flush=True)
    if metrics_out:
        print(f"wrote metrics snapshot to {metrics_out}", flush=True)


def report(args, spec, step, dt, losses):
    print(f"arch={spec.name} steps={step} time={dt:.1f}s "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    if args.log:
        with open(args.log, "w") as f:
            json.dump({"arch": spec.name, "losses": losses,
                       "seconds": dt}, f)


if __name__ == "__main__":
    main()
