"""Multi-rank runs of the port for the tests/test_torch_dist*.py files:
spawned processes, one per rank, under gloo on the CPU.

Imports torch and the port only (no jax): each rank is a fresh process
that imports this module.  Ranks meet through a file in the test's
temporary directory (never a fixed TCP port: test workers run side by
side), every process group has a timeout, every rank is joined with a
deadline, and a rank that fails fails the run at once.
"""
from __future__ import annotations

import multiprocessing
import os
import time
import traceback

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.pipeline import build_pipeline
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim import optimizers as topt
from repro_torch.parallel.dist import ProcessGrid, close_grid, init_grid

SEQ, R, MB = 12, 4, 2          # sequence, microbatches, rows a replica
GROUP_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 150.0


def smoke_spec():
    return configs.get("qwen3-14b").smoke_spec()


def smoke_plan(pp, schedule="1f1b", mode="stash", v=1, zero1=False):
    return configs.get("qwen3-14b").SMOKE_PLAN.with_(
        pp=pp, microbatches=R, stash_mode=mode, schedule=schedule,
        virtual_stages=v, zero1=zero1)


def optimizer(name="sgdm"):
    return {"sgdm": topt.SGDM(lr=0.05), "adam": topt.Adam(lr=1e-2)}[name]


def full_batch(step: int, rows: int, masked: bool):
    """A round of ``rows`` rows a microbatch (all replicas) from the
    SyntheticLM stream, numpy.  ``masked``: labels set to -1 unevenly
    over the replicas' blocks — most of the second block of microbatch 0,
    the first block's first positions of microbatch 1, all of the second
    block of microbatch 2 — so each replica holds a different number of
    valid tokens."""
    b = SyntheticLM(smoke_spec().vocab, SEQ, seed=1).round_batch(step, R,
                                                                 rows)
    if masked:
        lab = b["labels"]
        half = rows // 2
        lab[0, half:, 2:] = -1
        lab[1, :half, :5] = -1
        lab[2, half:] = -1
    return b


def rows_of(batch, d: int):
    """Replica ``d``'s block of every microbatch, as torch tensors."""
    sl = slice(d * MB, (d + 1) * MB)
    return {k: torch.from_numpy(np.ascontiguousarray(v[:, sl]))
            for k, v in batch.items()}


# --------------------------------------------------------------------------
# jobs: f(grid, **kw) -> picklable result
# --------------------------------------------------------------------------

def job_pipeline(grid, cases, rounds: int):
    """Each case ``key: (schedule, mode, v, zero1, masked, opt)``:
    ``rounds`` rounds of the smoke spec in fp32 through the rank-local
    executor; (losses, aux, the rank's state) by key."""
    dp = grid.topo.data
    out = {}
    for key, (schedule, mode, v, zero1, masked, opt) in cases.items():
        plan = smoke_plan(grid.topo.pp, schedule, mode, v, zero1)
        bundle = build_pipeline(smoke_spec(), plan, seq_len=SEQ,
                                global_batch=dp * R * MB,
                                optimizer=optimizer(opt),
                                compute_dtype=torch.float32, grid=grid)
        state = bundle.init_state(torch.Generator("cpu").manual_seed(0))
        losses, aux = [], []
        for r in range(rounds):
            batch = rows_of(full_batch(r, dp * MB, masked), grid.d)
            state, m = bundle.train_step(state, batch)
            losses.append(float(m["loss"]))
            aux.append(float(m["aux"]))
        out[key] = {"losses": losses, "aux": aux, "state": state}
    return out


def job_load_and_train(grid, npz: str, rounds: int):
    """A JAX training state (``npz``: flattened ``path -> array``) loaded
    rank by rank, then ``rounds`` rounds of 1f1b / stash with ZeRO-1:
    (losses, the rank's state)."""
    from repro_torch.core.schedule import make_schedule
    from repro_torch.core.versioning import zero1_axes
    from repro_torch.models.init import train_state_from_numpy
    dp = grid.topo.data
    plan = smoke_plan(grid.topo.pp, zero1=True)
    tree = unflatten(dict(np.load(npz)))
    sched = make_schedule(plan)
    axes = zero1_axes(tree["params"]["stages"], dp)
    state = train_state_from_numpy(tree, "cpu", torch.float32, sched=sched,
                                   stage=grid.s, zero1=(axes, grid.d, dp))
    bundle = build_pipeline(smoke_spec(), plan, seq_len=SEQ,
                            global_batch=dp * R * MB, optimizer=optimizer(),
                            compute_dtype=torch.float32, grid=grid)
    losses = []
    for r in range(rounds):
        state, m = bundle.train_step(
            state, rows_of(full_batch(r, dp * MB, False), grid.d))
        losses.append(float(m["loss"]))
    return {"losses": losses, "state": state}


def job_exchange_timeout(grid, idle_s: float):
    """Rank 1 stays ``idle_s`` without sending; rank 0 waits on a receive
    from it: the group's timeout must make rank 0 raise.  (raised?,
    seconds) on rank 0."""
    if grid.rank == 1:
        time.sleep(idle_s)
        return None
    t0 = time.perf_counter()
    try:
        grid.exchange([], [(1, torch.empty(4))])
    except RuntimeError:
        return {"raised": True, "seconds": time.perf_counter() - t0}
    return {"raised": False, "seconds": time.perf_counter() - t0}


def job_fail(grid):
    """Rank 1 raises; rank 0 waits in a sum over the world."""
    if grid.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    grid.world_group.all_reduce_(torch.ones(1))


def job_modules(grid, rounds: int):
    """The small modules over a (dp, 1) grid: BSP and ASP
    (core/baselines.py) and the 1-bit all-reduce (optim/compression.py)."""
    from repro_torch.core.baselines import build_bsp
    from repro_torch.optim.compression import (init_errors,
                                               onebit_compress_all_reduce)
    dp = grid.topo.data
    out = {}
    for name, every in (("bsp", 1), ("asp", 2)):
        b = build_bsp(smoke_spec(), grid, seq_len=SEQ, global_batch=dp * MB,
                      optimizer=optimizer(), sync_every=every,
                      compute_dtype=torch.float32)
        state = b.init_state(torch.Generator("cpu").manual_seed(0))
        losses = []
        for r in range(rounds):
            batch = full_batch(r, dp * MB, masked=True)
            sl = slice(grid.d * MB, (grid.d + 1) * MB)
            state, m = b.train_step(state, {
                k: torch.from_numpy(np.ascontiguousarray(v[0, sl]))
                for k, v in batch.items()})
            losses.append(float(m["loss"]))
        out[name] = {"losses": losses, "state": state}
    rng = np.random.default_rng(7 + grid.d)
    grads = {"a": torch.from_numpy(rng.normal(size=(3, 8)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=5).astype(
            np.float32))}
    errors = init_errors(grads)
    steps = []
    for _ in range(3):
        synced, errors = onebit_compress_all_reduce(grads, errors,
                                                    grid.data_group, dp)
        steps.append({"synced": synced, "errors": errors})
    out["onebit"] = {"grads": grads, "steps": steps}
    return out


def unflatten(flat):
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    out = {}
    for path, value in flat.items():
        node = out
        *head, tail = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[tail] = value
    return out


# --------------------------------------------------------------------------
# spawning
# --------------------------------------------------------------------------

def _rank_main(rank, world, data, pp, init_file, out_dir, jobs,
               group_timeout):
    torch.set_num_threads(1)
    try:
        grid = init_grid(ProcessGrid(data, pp), "gloo",
                         init_method=f"file://{init_file}", rank=rank,
                         world_size=world, device="cpu",
                         timeout=group_timeout)
        result = {name: globals()[f"job_{name}"](grid, **kw)
                  for name, kw in jobs.items()}
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        close_grid()


def run_ranks(tmp_path, data: int, pp: int, jobs,
              timeout: float = JOIN_TIMEOUT_S,
              group_timeout: float = GROUP_TIMEOUT_S):
    """Run ``jobs`` (``{name: kwargs}`` of the ``job_<name>`` functions,
    in order) on a ``data × pp`` grid of spawned ranks; the results by
    rank, each ``{name: result}``.  Raises as soon as a rank fails (the
    others are killed) or when the deadline passes."""
    world = data * pp
    ctx = multiprocessing.get_context("spawn")
    init_file = tmp_path / "rendezvous"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, data, pp, str(init_file),
                               str(tmp_path), jobs, group_timeout))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"{list(jobs)}: rank(s) {failed} failed")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{list(jobs)}: ranks still running "
                                   f"after {timeout} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"{list(jobs)}: rank(s) {failed} failed")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
