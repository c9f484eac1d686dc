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


def job_ckpt_save(grid, out_dir: str, cases, rounds: int):
    """Each case ``key: (schedule, mode, v, zero1, opt)``: ``rounds``
    rounds (fp32, masked labels) through the rank-local executor, then a
    checkpoint of round ``rounds`` rank by rank into ``out_dir/key``, and
    that checkpoint restored rank by rank into a zeroed copy of the
    state: (the rank's state, the restored one) by key."""
    from repro_torch.checkpoint.manager import CheckpointManager
    dp = grid.topo.data
    out = {}
    for key, (schedule, mode, v, zero1, opt) in cases.items():
        plan = smoke_plan(grid.topo.pp, schedule, mode, v, zero1)
        bundle = build_pipeline(smoke_spec(), plan, seq_len=SEQ,
                                global_batch=dp * R * MB,
                                optimizer=optimizer(opt),
                                compute_dtype=torch.float32, grid=grid)
        state = bundle.init_state(torch.Generator("cpu").manual_seed(0))
        for r in range(rounds):
            state, _ = bundle.train_step(
                state, rows_of(full_batch(r, dp * MB, True), grid.d))
        mgr = CheckpointManager(os.path.join(out_dir, key), grid=grid)
        mgr.save(rounds, state, plan.pp * v)
        back = mgr.restore(rounds, zeroed(state))
        out[key] = {"state": state, "restored": back,
                    "aliased": back["stash"]["current"] is
                    back["params"]["stages"]}
    return out


def job_ckpt_restore(grid, ckpt_dir: str, rnd: int, schedule, mode, v):
    """A checkpoint written by one process restored rank by rank into a
    zeroed copy of this rank's fresh state."""
    from repro_torch.checkpoint.manager import CheckpointManager
    plan = smoke_plan(grid.topo.pp, schedule, mode, v)
    bundle = build_pipeline(smoke_spec(), plan, seq_len=SEQ,
                            global_batch=R * MB, optimizer=optimizer("adam"),
                            compute_dtype=torch.float32, grid=grid)
    state = zeroed(bundle.init_state(torch.Generator("cpu").manual_seed(5)))
    return CheckpointManager(ckpt_dir, grid=grid).restore(rnd, state)


def job_driver(grid, out_dir: str, rounds: int, every: int, fail: int,
               torn: int, final: int):
    """TrainDriver on the grid with an Observability, ``rounds`` rounds
    uninterrupted (a), then again with a fault before round ``fail``
    raised on the last rank only and a crash of the last rank in the save
    of round ``torn`` (its rows not written) (b), then ``final`` rounds
    with that crash in the save of the last round (c): each run's state
    and losses, what the torn save left, the metrics snapshot and stage
    seconds, and (c) the latest complete round and run a's checkpoint of
    round ``final``."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import Loader
    from repro_torch.obs import Observability
    from repro_torch.runtime.driver import DriverConfig, TrainDriver
    dp, last = grid.topo.data, grid.rank == grid.topo.world - 1
    plan = smoke_plan(grid.topo.pp)
    armed = {"hook": last, "save": last, "final": last}
    torn_seen = {}

    def run(sub, faults, n=rounds, at=torn, key="save"):
        obs = Observability(trace=True)
        bundle = build_pipeline(smoke_spec(), plan, seq_len=SEQ,
                                global_batch=dp * R * MB,
                                optimizer=optimizer(),
                                compute_dtype=torch.float32, grid=grid,
                                obs=obs)
        loader = Loader(SyntheticLM(smoke_spec().vocab, SEQ, seed=1), R,
                        dp * MB, "cpu", replica=grid.d, replicas=dp)

        def hook(step):
            if faults and key == "save" and step == fail and armed["hook"]:
                armed["hook"] = False
                raise RuntimeError("simulated failure of one rank")

        driver = TrainDriver(bundle, loader, os.path.join(out_dir, sub),
                             DriverConfig(checkpoint_every=every),
                             failure_hook=hook, seed=0)
        save = driver.ckpt.save

        def torn_save(rnd, st, n, fail_after_stage=None):
            if faults and rnd == at and armed[key]:
                armed[key] = False
                save(rnd, st, n, fail_after_stage=grid.s * plan.
                     virtual_stages - 1)
                if key == "save":
                    torn_seen["latest"] = driver.ckpt.latest_complete_round()
                    with open(os.path.join(driver.ckpt._round_dir(rnd),
                                           "MANIFEST.json")) as f:
                        torn_seen["manifest"] = f.read()
                raise RuntimeError("crash in the middle of a save")
            return save(rnd, st, n, fail_after_stage)

        driver.ckpt.save = torn_save
        state = bundle.init_state(torch.Generator("cpu").manual_seed(0))
        state, step = driver.run(state, n)
        return {"state": state, "step": step,
                "latest": driver.ckpt.latest_complete_round(),
                "losses": [m["loss"] for m in driver.metrics_log],
                "snapshot": obs.registry.snapshot(),
                "stage_seconds": driver.stage_seconds,
                "span_counts": obs.trace.span_counts("train"),
                "rounds_traced": len(obs.trace.rounds)}

    out = {"a": run("a", False), "b": run("b", True),
           "c": run("c", True, final, final, "final")}
    out["a_final"] = CheckpointManager(
        os.path.join(out_dir, "a"), grid=grid).restore(
            final, zeroed(out["c"]["state"]))
    out["unfired"] = any(armed.values())
    out["torn"] = torn_seen
    return out


def zeroed(state):
    """A copy of ``state`` with every tensor zeroed, ``stash["current"]``
    the params' stages, ``step`` 0."""
    def z(t):
        if isinstance(t, dict):
            return {k: z(v) for k, v in t.items()}
        return torch.zeros_like(t) if torch.is_tensor(t) else t
    out = z(state)
    out["stash"]["current"] = out["params"]["stages"]
    out["step"] = 0
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
