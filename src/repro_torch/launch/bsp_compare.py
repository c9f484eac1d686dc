"""BSP against PipeDream's communication, measured on N ranks (port of
``repro/launch/bsp_compare.py``; the paper's §5.2 claim).

The same model trains one step two ways on N ranks:

  * BSP: ``core/baselines.py::build_bsp`` at data N, the model
    replicated on every rank and the gradients summed over the
    replicas every minibatch;
  * PipeDream: ``core/pipeline.py::build_pipeline`` at pp N, a stage a
    rank, activations and gradients handed between neighbours.

It prints each rank's collective bytes (BSP) against its hand-off plus
collective bytes (the pipeline), both from the rank's
``parallel/dist.py::TransportStats`` (and, the same counters, from
``launch/op_analysis.py``'s count of the step), beside the analytic counts
(:func:`bsp_bytes`, :func:`pipeline_bytes`), and the reduction in
percent; the JSON goes to ``--out`` as JAX's does.  JAX compares
compiled collective schedules on 256 emulated devices; the port moves
the bytes.  It runs on the CPU under gloo only: the bytes do not depend
on the device.

  python -m repro_torch.launch.bsp_compare --arch qwen3-14b --smoke
  python -m repro_torch.launch.bsp_compare --arch qwen3-14b --layers 2 \\
      --seq-len 256 --global-batch 4 --ranks 2
  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.bsp_compare \\
      --arch qwen3-14b --smoke

Without torchrun the ranks are spawned here and meet through a file in a
temporary directory.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import tempfile
import time

import numpy as np
import torch

OUT_DIR = "experiments/dryrun_torch"
JOIN_TIMEOUT_S = 600.0


def bsp_bytes(params_bytes: int) -> int:
    """A BSP rank's collective bytes a step: the valid-token count (f32),
    every gradient leaf, the loss and aux (2 x f32)."""
    return 4 + params_bytes + 8


def pipeline_bytes(sched, stage: int, act_bytes: int) -> int:
    """A pipeline rank's bytes a step at data 1: the hand-offs its stage
    sends (``core/pipeline.py::handoffs`` over the schedule's ticks),
    each a microbatch's activations or their gradient, and the round's
    loss and aux (2 x f32) summed over the world."""
    from repro_torch.core.pipeline import handoffs
    tabs = sched.tables()
    sends = 0
    for t in range(sched.n_ticks):
        fwd, bwd = handoffs(tabs, t)
        sends += sum(src == stage for src, _ in fwd + bwd)
    return sends * act_bytes + 8


def _spec_plan(args):
    from repro_torch import configs
    from repro_torch.launch.train import cut_layers
    cfg = configs.get(args.arch)
    spec = cfg.smoke_spec() if args.smoke else cfg.full_spec()
    if args.layers:
        spec = cut_layers(spec, args.layers)
    plan = cfg.SMOKE_PLAN.with_(pp=args.ranks, tp=1,
                                microbatches=args.microbatches,
                                stash_mode="stash", schedule="1f1b",
                                virtual_stages=1, zero1=False)
    return cfg, spec, plan


def rank_job(args, rank: int, world: int, init_files) -> dict:
    """This rank's BSP step, then its pipeline step: bytes moved and the
    analytic counts."""
    from repro_torch.core.baselines import build_bsp
    from repro_torch.core.pipeline import build_pipeline
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.op_analysis import count_call
    from repro_torch.optim.optimizers import by_name
    from repro_torch.parallel.dist import ProcessGrid, close_grid, init_grid
    torch.set_num_threads(1)
    cfg, spec, plan = _spec_plan(args)
    dtype = torch.float32 if args.smoke else torch.bfloat16
    esz = torch.finfo(dtype).bits // 8
    opt = by_name(*cfg.OPTIMIZER)
    gb, seq, R = args.global_batch, args.seq_len, args.microbatches
    out = {"rank": rank}
    # BSP: data N, this replica's block of the batch's rows
    grid = init_grid(ProcessGrid(world, 1), "gloo", device="cpu", rank=rank,
                     world_size=world, init_method=init_files[0])
    try:
        bsp = build_bsp(spec, grid, seq_len=seq, global_batch=gb,
                        optimizer=opt, compute_dtype=dtype, device="cpu")
        state = bsp.init_state(torch.Generator().manual_seed(args.seed))
        rows = gb // world
        b = SyntheticLM(spec.vocab, seq, seed=args.seed).round_batch(0, 1, gb)
        batch = {k: torch.from_numpy(np.ascontiguousarray(
            v[0, rank * rows:(rank + 1) * rows])) for k, v in b.items()}
        grid.stats.collective_bytes = grid.stats.handoff_bytes = 0
        (_, m), op = count_call(bsp.train_step, state, batch, grid=grid)
        params = sum(t.numel() * t.element_size() for k, leaf in
                     state["params"].items() if k not in (
                         "layer_windows", "layer_thetas")
                     for t in _leaves(leaf))
        out["bsp"] = {"collective_bytes": grid.stats.collective_bytes,
                      "handoff_bytes": grid.stats.handoff_bytes,
                      "analytic_bytes": bsp_bytes(params),
                      "op_count_bytes": op.per_collective,
                      "loss": float(m["loss"])}
    finally:
        close_grid()
    # PipeDream: pp N, this rank's stage
    grid = init_grid(ProcessGrid(1, world), "gloo", device="cpu", rank=rank,
                     world_size=world, init_method=init_files[1])
    try:
        bundle = build_pipeline(spec, plan, seq_len=seq, global_batch=gb,
                                optimizer=opt, compute_dtype=dtype,
                                grid=grid)
        state = bundle.init_state(torch.Generator().manual_seed(args.seed))
        b = SyntheticLM(spec.vocab, seq, seed=args.seed).round_batch(
            0, R, gb // R)
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        grid.stats.collective_bytes = grid.stats.handoff_bytes = 0
        (_, m), op = count_call(bundle.train_step, state, batch, grid=grid)
        act = bundle.microbatch_size * seq * spec.d_model * esz
        out["pipeline"] = {
            "collective_bytes": grid.stats.collective_bytes,
            "handoff_bytes": grid.stats.handoff_bytes,
            "analytic_bytes": pipeline_bytes(bundle.sched, rank, act),
            "op_count_bytes": op.per_collective,
            "loss": float(m["loss"])}
    finally:
        close_grid()
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return []


def _child(args, rank, world, init_files, results):
    try:
        results[rank] = rank_job(args, rank, world, init_files)
    except BaseException as e:      # reported by the parent
        results[rank] = {"error": f"{type(e).__name__}: {e}"}
        raise


def spawn(args) -> list:
    """Every rank's result, from ``args.ranks`` spawned processes."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="bsp_compare_") as tmp, \
            ctx.Manager() as mgr:
        files = [f"file://{tmp}/bsp", f"file://{tmp}/pipeline"]
        results = mgr.dict()
        procs = [ctx.Process(target=_child,
                             args=(args, r, args.ranks, files, results))
                 for r in range(args.ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(5)
        out = [results.get(r) for r in range(args.ranks)]
    bad = {r: o for r, o in enumerate(out) if not o or "error" in o}
    if bad:
        raise RuntimeError(f"bsp_compare: rank(s) failed: {bad}")
    return out


def report(args, ranks: list) -> dict:
    bsp = [r["bsp"]["collective_bytes"] + r["bsp"]["handoff_bytes"]
           for r in ranks]
    pp = [r["pipeline"]["collective_bytes"] + r["pipeline"]["handoff_bytes"]
          for r in ranks]
    result = {"arch": args.arch, "smoke": args.smoke, "layers": args.layers,
              "ranks": args.ranks, "seq_len": args.seq_len,
              "global_batch": args.global_batch,
              "microbatches": args.microbatches, "by_rank": ranks,
              "bsp_bytes_per_rank_max": max(bsp),
              "pp_bytes_per_rank_max": max(pp),
              "reduction_pct": 100.0 * (1 - max(pp) / max(bsp))}
    for r, rec in enumerate(ranks):
        print(f"rank {r}: BSP collective bytes {bsp[r]:.4e} (analytic "
              f"{rec['bsp']['analytic_bytes']:.4e}); pipeline hand-off + "
              f"collective bytes {pp[r]:.4e} (analytic "
              f"{rec['pipeline']['analytic_bytes']:.4e})")
    print(f"measured comm reduction: {result['reduction_pct']:.1f}% "
          f"(the busiest rank: BSP {max(bsp):.4e} B, pipeline "
          f"{max(pp):.4e} B a step)")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"bsp_compare__{args.arch}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    print(f"wrote {path}")
    return result


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--smoke", action="store_true",
                    help="the config's smoke spec in fp32")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the spec's first N layers (0 = all)")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=OUT_DIR)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.global_batch % args.ranks or \
            args.global_batch % args.microbatches:
        raise SystemExit(f"--global-batch {args.global_batch} must split "
                         f"over {args.ranks} ranks and {args.microbatches} "
                         "microbatches")
    world = int(os.environ.get("WORLD_SIZE", "0"))
    if world:
        # under torchrun: this process is one rank; torchrun's rendezvous
        rank = int(os.environ["RANK"])
        args.ranks = world
        res = rank_job(args, rank, world, ["env://", "env://"])
        from repro_torch.parallel.dist import ProcessGrid, close_grid, \
            init_grid
        grid = init_grid(ProcessGrid(world, 1), "gloo", device="cpu")
        try:
            ranks = grid.world_group.all_gather_object(res)
        finally:
            close_grid()
        return report(args, ranks) if rank == 0 else None
    return report(args, spawn(args))


if __name__ == "__main__":
    main()
