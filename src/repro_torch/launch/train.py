"""Pipelined training (port of ``repro/launch/train.py``): ``--steps``
rounds of the paper's schedule on the synthetic LM stream, every stage
of the plan on one device.

Runs on the card by default (``--device cpu`` runs the plain PyTorch
versions of the kernels).  ``--smoke`` trains the architecture's small
smoke spec in fp32; otherwise the full spec in bf16 (``--layers N``
keeps its first N layers).  Prints the plan line with the predicted
bubble, then ``loss a -> b``.

  python -m repro_torch.launch.train --arch qwen3-14b --smoke --steps 3 \
      --device cpu
  python -m repro_torch.launch.train --arch qwen3-14b --smoke --steps 3 \
      --device cpu --schedule gpipe --stash-mode 2bw

The fault-tolerant driver (``TrainDriver``) and its checkpoints wait for
the port of ``checkpoint/manager.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.core.pipeline import build_pipeline
from repro_torch.core.schedule import (plan_kwargs_for_schedule,
                                       weighted_round_time)
from repro_torch.data.pipeline import Loader, SyntheticLM
from repro_torch.optim.optimizers import by_name


def cut_layers(spec, n: int):
    """The spec's first ``n`` layers at full width."""
    if not 0 < n <= spec.n_layers:
        raise ValueError(f"--layers {n} outside 1..{spec.n_layers}")
    return dataclasses.replace(spec, name=f"{spec.name}-{n}l", n_layers=n,
                               blocks=spec.blocks[:n])


def build(args):
    """(spec, bundle) for the parsed arguments."""
    cfg = configs.get(args.arch)
    if args.smoke:
        spec, plan = cfg.smoke_spec(), cfg.SMOKE_PLAN
    else:
        spec, plan = cfg.full_spec(), cfg.PLAN.with_(tp=1)
        if args.layers:
            spec = cut_layers(spec, args.layers)
    plan = plan.with_(microbatches=args.microbatches)
    if args.pp:
        plan = plan.with_(pp=args.pp)
    if args.stash_mode:
        plan = plan.with_(stash_mode=args.stash_mode)
    if args.schedule:
        plan = plan.with_(**plan_kwargs_for_schedule(
            args.schedule, stash_mode=plan.stash_mode))
    name, lr = cfg.OPTIMIZER
    opt = by_name(args.optimizer or name, args.lr or lr)
    bundle = build_pipeline(
        spec, plan, seq_len=args.seq_len, global_batch=args.global_batch,
        optimizer=opt, device=args.device,
        compute_dtype=torch.float32 if args.smoke else torch.bfloat16)
    return spec, bundle


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
                    choices=[None, "1f1b", "gpipe"],
                    help="override the plan's pipeline schedule")
    ap.add_argument("--stash-mode", type=str, default=None,
                    choices=[None, "stash", "vertical", "flush", "2bw"])
    ap.add_argument("--optimizer", type=str, default=None,
                    choices=[None, "sgdm", "rmsprop", "adam"])
    ap.add_argument("--lr", type=float, default=None,
                    help="learning rate (default: the config's)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the data stream")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    args.device = str(resolve_device(args.device))
    spec, bundle = build(args)
    plan, sched = bundle.plan, bundle.sched
    _, bubble = weighted_round_time(sched)
    print(f"plan: pp={plan.pp} tp={plan.tp} schedule={sched.name} "
          f"stash_mode={plan.stash_mode} R={plan.microbatches} "
          f"predicted_bubble={bubble:.3f}", flush=True)
    dev = bundle.device
    state = bundle.init_state(torch.Generator(dev).manual_seed(args.seed))
    loader = Loader(SyntheticLM(spec.vocab, bundle.seq_len, seed=args.seed),
                    plan.microbatches, bundle.microbatch_size, dev)
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        state, metrics = bundle.train_step(state, loader.get(step))
        losses.append(float(metrics["loss"]))
    dt = time.perf_counter() - t0
    print(f"arch={spec.name} steps={args.steps} time={dt:.1f}s "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    return losses


if __name__ == "__main__":
    main()
