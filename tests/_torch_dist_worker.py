"""Multi-rank runs of the port for the tests/test_torch_dist*.py files:
spawned processes, one per rank, under gloo on the CPU.

Imports torch and the port only (no jax).  Each rank is a fresh process
forked from a ``forkserver`` that has imported this module once for the
test process: a rank starts in a fraction of a second instead of
importing torch anew (~5 s a four-rank run under ``spawn``), and no
rank inherits the test process's state (its threads, or jax).  Ranks
meet through a file in the test's
temporary directory (never a fixed TCP port: test workers run side by
side), every process group has a timeout, every rank is joined with a
deadline, and a rank that fails fails the run at once.
"""
from __future__ import annotations

import dataclasses
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
# after a rank fails, how long the others get to exit before the spawn
# reports which ranks failed (and kills the rest)
FAIL_GRACE_S = 10.0


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


def job_tp_train(grid, spec, plan, npz: str, rounds: int):
    """A JAX training state (``npz``) loaded as this rank of a (data, pp,
    tp) grid holds it — its stage rows, its tensor shard, its ZeRO-1
    shard of that — then ``rounds`` rounds of ``plan`` (fp32, SGD with
    momentum 0.05 and 0.9) on this replica's rows of the stream: (losses,
    aux, the rank's state)."""
    from repro_torch.core.reference import model_plan
    from repro_torch.core.schedule import make_schedule
    from repro_torch.core.versioning import tensor_cut, zero1_axes
    from repro_torch.models.init import tp_axes, train_state_from_numpy
    dp, tp = grid.topo.data, grid.topo.tp
    tree = unflatten(dict(np.load(npz)))
    sched = make_schedule(plan)
    mplan = model_plan(plan, sched)
    stages = tree["params"]["stages"]
    # ZeRO-1 picks its dims from a tensor shard's shapes
    axes = zero1_axes(tensor_cut(stages, (tp_axes(stages, spec, tp), 0, tp)),
                      dp)
    state = train_state_from_numpy(
        tree, "cpu", torch.float32, sched=sched, stage=grid.s,
        zero1=(axes, grid.d, dp) if plan.zero1 and dp > 1 else None,
        tensor=(spec, mplan, grid.t))
    bundle = build_pipeline(spec, plan, seq_len=SEQ,
                            global_batch=dp * R * MB,
                            optimizer=topt.SGDM(lr=0.05, momentum=0.9),
                            compute_dtype=torch.float32, grid=grid)
    src = SyntheticLM(spec.vocab, SEQ, seed=1)
    losses, aux = [], []
    for r in range(rounds):
        b = src.round_batch(r, R, dp * MB)
        state, m = bundle.train_step(state, rows_of(b, grid.d))
        losses.append(float(m["loss"]))
        aux.append(float(m["aux"]))
    return {"losses": losses, "aux": aux, "state": state,
            "stats": dataclasses.asdict(grid.stats)}


def job_frontend_train(grid, arch: str, plan, rounds: int):
    """``rounds`` rounds of ``arch``'s smoke spec (fp32, SGD with
    momentum 0.05 and 0.9), this rank's part of the state drawn row-wise
    from seed 0, this replica's rows of the launcher's loader (text, and
    a frontend's stubs' patches or frames) from seed 1: (losses, the
    rank's state)."""
    from repro_torch.launch.train import make_loader
    spec = configs.get(arch).smoke_spec()
    n_patch = spec.n_patches if spec.frontend == "vision" else 0
    bundle = build_pipeline(spec, plan, seq_len=SEQ + n_patch,
                            global_batch=grid.topo.data * R * MB,
                            optimizer=topt.SGDM(lr=0.05, momentum=0.9),
                            compute_dtype=torch.float32, grid=grid)
    state = bundle.init_state(torch.Generator().manual_seed(0))
    loader = make_loader(spec, bundle, 1)
    losses = []
    for r in range(rounds):
        state, m = bundle.train_step(state, loader.get(r))
        losses.append(float(m["loss"]))
    return {"losses": losses, "state": state}


def job_train_archs(grid, archs, pp: int, rounds: int, ckpt_dir=None):
    """:func:`job_frontend_train` for each of ``archs`` on this grid (the
    arch's SMOKE_PLAN at the grid's pp and tp, R microbatches): {arch:
    (losses, the rank's state)}; with ``ckpt_dir`` each arch's state is
    also checkpointed there after the rounds (``<ckpt_dir>/<arch>``)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    out = {}
    for arch in archs:
        plan = configs.get(arch).SMOKE_PLAN.with_(pp=pp, tp=grid.topo.tp,
                                                  microbatches=R)
        out[arch] = job_frontend_train(grid, arch, plan, rounds)
        if ckpt_dir is not None:
            spec = configs.get(arch).smoke_spec()
            CheckpointManager(os.path.join(ckpt_dir, arch), grid=grid,
                              spec=spec).save(rounds, out[arch]["state"],
                                              pp * plan.virtual_stages)
    return out


def job_tp_head(grid, npz: str, vocab: int):
    """``lm_head.loss_and_grads`` over this rank's vocabulary slice of
    the head in ``npz`` (h, labels, valid, head, scale; fp32): the loss,
    d(h), the slice's d(head) and d(final-norm scale), and the tensor
    group's counters."""
    from repro_torch.models import lm_head
    a = dict(np.load(npz))
    tp, t = grid.topo.tp, grid.t
    n = a["head"].shape[1] // tp
    loss, dh, dhead, dfn = lm_head.loss_and_grads(
        torch.from_numpy(a["head"][:, t * n:(t + 1) * n].copy()),
        {"scale": torch.from_numpy(a["scale"])}, torch.from_numpy(a["h"]),
        torch.from_numpy(a["labels"]), norm_kind="rmsnorm",
        valid_mask=torch.from_numpy(a["valid"]), vocab=vocab,
        tensor=grid.tensor_group)
    return {"loss": float(loss), "dh": dh, "dhead": dhead,
            "dscale": dfn["scale"], "stats": dataclasses.asdict(grid.stats)}


def job_tp_autograd(grid, seed: int):
    """tp_enter / tp_exit / tp_all_gather over the tensor group on a
    two-layer product cut over the ranks: this rank's output and the
    gradients of its shards and of the replicated input.  ``x`` (4, 6)
    replicated, ``w1`` (6, 8) by columns, ``w2`` (8, 6) by rows, ``a``
    (6, 4) by columns for the gathered branch."""
    from repro_torch.parallel.dist import tp_all_gather, tp_enter, tp_exit
    rng = np.random.default_rng(seed)
    full = {k: torch.from_numpy(rng.normal(size=sh).astype(np.float32))
            for k, sh in (("x", (4, 6)), ("w1", (6, 8)), ("w2", (8, 6)),
                          ("a", (6, 4)), ("c", (4, 6)), ("e", (4, 4)))}
    tp, t = grid.topo.tp, grid.t
    grp = grid.tensor_group
    cut = {"w1": full["w1"].chunk(tp, 1)[t], "w2": full["w2"].chunk(tp, 0)[t],
           "a": full["a"].chunk(tp, 1)[t]}
    leaves = {k: v.clone().requires_grad_() for k, v in
              dict(cut, x=full["x"]).items()}
    xe = tp_enter(leaves["x"], grp)
    y = tp_exit(torch.tanh(xe @ leaves["w1"]) @ leaves["w2"], grp)
    z = tp_all_gather(xe @ leaves["a"], grp, 1)
    loss = (y * full["c"]).sum() + (z * full["e"]).sum()
    loss.backward()
    return {"y": y.detach(), "z": z.detach(), "loss": float(loss),
            "grads": {k: v.grad for k, v in leaves.items()},
            "stats": dataclasses.asdict(grid.stats)}


def job_tp_ckpt(grid, spec, plan, save_dir: str, restore_dir: str,
                rounds: int):
    """On a (data, pp, tp) grid: ``rounds`` rounds from the seed-0 state
    (each replica its rows of the stream), a checkpoint of them into
    ``save_dir``; then a checkpoint of ``rounds`` written elsewhere
    (``restore_dir``, any tp) restored into a zeroed copy of the rank's
    state: (trained state, restored one)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    dp = grid.topo.data
    bundle = build_pipeline(spec, plan, seq_len=SEQ,
                            global_batch=dp * R * MB,
                            optimizer=optimizer("adam"),
                            compute_dtype=torch.float32, grid=grid)
    state = bundle.init_state(torch.Generator("cpu").manual_seed(0))
    src = SyntheticLM(spec.vocab, SEQ, seed=1)
    for r in range(rounds):
        state, _ = bundle.train_step(state, rows_of(src.round_batch(
            r, R, dp * MB), grid.d))
    n_rows = plan.pp * plan.virtual_stages
    CheckpointManager(save_dir, grid=grid, spec=spec).save(rounds, state,
                                                           n_rows)
    back = CheckpointManager(restore_dir, grid=grid, spec=spec).restore(
        rounds, zeroed(state))
    return {"state": state, "restored": back}


def job_tp_driver(grid, spec, plan, out_dir: str, rounds: int, every: int,
                  fail: int):
    """TrainDriver on a grid with tensor ranks (tiny spec, SGD with
    momentum, an Observability): ``rounds`` rounds uninterrupted, then
    again with a failure before round ``fail`` raised on the last rank
    only; each run's losses and final state, the measured stage seconds
    and, on rank 0, ``replan_from_registry``'s plan."""
    from repro_torch.data.pipeline import Loader
    from repro_torch.obs import Observability
    from repro_torch.runtime.driver import (DriverConfig, TrainDriver,
                                            replan_from_registry)
    dp, last = grid.topo.data, grid.rank == grid.topo.world - 1
    armed = {"hook": last}

    def run(sub, faults):
        obs = Observability()
        bundle = build_pipeline(spec, plan, seq_len=SEQ,
                                global_batch=dp * R * MB,
                                optimizer=optimizer(),
                                compute_dtype=torch.float32, grid=grid,
                                obs=obs)
        loader = Loader(SyntheticLM(spec.vocab, SEQ, seed=1), R, dp * MB,
                        "cpu", replica=grid.d, replicas=dp)

        def hook(step):
            if faults and step == fail and armed["hook"]:
                armed["hook"] = False
                raise RuntimeError("simulated failure of one rank")

        driver = TrainDriver(bundle, loader, os.path.join(out_dir, sub),
                             DriverConfig(checkpoint_every=every),
                             failure_hook=hook, seed=0)
        state = bundle.init_state(torch.Generator("cpu").manual_seed(0))
        state, step = driver.run(state, rounds)
        return {"state": state, "step": step, "obs": obs,
                "losses": [m["loss"] for m in driver.metrics_log],
                "stage_seconds": driver.stage_seconds}

    out = {"a": run("a", False), "b": run("b", True)}
    out["unfired"] = any(armed.values())
    if grid.rank == 0:
        new, _ = replan_from_registry(
            spec, plan, out["b"]["obs"].registry,
            minibatch_tokens=SEQ * MB, data_replicas=dp)
        out["replan"] = (new.pp, new.tp)
    for key in ("a", "b"):
        del out[key]["obs"]
    return out


def job_tp_stage(grid, spec, npz: str, tokens_per_mb: int):
    """One stage (pp 1) of ``spec`` at this rank's tensor shard of the
    parameters in ``npz`` (a whole JAX tree, and ``x`` / ``g``): the
    stage's output, and its gradients (stage_vjp) beside the same
    stage's at tp 1 in this process."""
    from repro_torch.models.init import params_from_numpy
    from repro_torch.models.stage import (make_statics, stage_fwd,
                                          stage_params, stage_vjp)
    from repro_torch.parallel.plan import ParallelismPlan
    tp = grid.topo.tp
    flat = dict(np.load(npz))
    x, g = (torch.from_numpy(flat.pop(k)) for k in ("x", "g"))
    tree = unflatten(flat)
    out = {}
    for n, group in ((tp, grid.tensor_group), (1, None)):
        plan = ParallelismPlan(pp=1, tp=n, microbatches=1)
        st = make_statics(spec, plan, tokens_per_mb=tokens_per_mb)
        params = params_from_numpy(tree, "cpu", torch.float32,
                                   tensor=(spec, plan, grid.t))
        sp = stage_params(params, 0)
        pos = torch.arange(x.shape[1]).expand(x.shape[0], -1)
        kw = dict(positions=pos, windows=params["layer_windows"][0],
                  thetas=params["layer_thetas"][0])
        with torch.no_grad():
            h = stage_fwd(sp, x, st, tp=group, **kw)
        dw, dx = stage_vjp(sp, x, st, g, 0.01, tp=group, **kw)
        out[n] = {"h": h, "dW": dw, "dx": dx}
    return out


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
# serving on a grid (tests/test_torch_serve_grid.py): one session a case,
# the same scenario code in one process and on every rank
# --------------------------------------------------------------------------

def serve_plan(case):
    """The case's plan: its arch's SMOKE_PLAN with the case's fields."""
    return configs.get(case["arch"]).SMOKE_PLAN.with_(**case.get("plan", {}))


def serve_session(case, grid=None, device="cpu"):
    """``build_serving`` of ``case`` (fp32), on ``grid`` or in one
    process, with its weights: drawn from ``case["seed"]``, or the
    numpy tree saved at ``case["npz"]`` (flattened ``path -> array``)."""
    from repro_torch.serving.engine import build_serving
    spec = configs.get(case["arch"]).smoke_spec()
    kw = {k: case[k] for k in ("page_size", "prefill_len", "buckets",
                               "spec_k", "weight_dtype", "kv_dtype",
                               "pool_pages") if k in case}
    session = build_serving(spec, serve_plan(case),
                            cache_len=case["cache_len"],
                            global_batch=case["batch"],
                            compute_dtype=torch.float32, device=device,
                            grid=grid, **kw)
    session.start(case.get("seed", 0))
    if case.get("npz"):
        session.load_params(unflatten(dict(np.load(case["npz"]))))
    if case.get("ckpt"):
        from repro_torch.launch.serve import load_checkpoint
        load_checkpoint(session, spec, type("Args", (), {
            "ckpt": case["ckpt"]})())
    return session


def _hidden(session):
    h = session.last_hidden
    return None if h is None else h.detach().cpu().numpy().copy()


def serve_prompts(session, case):
    """A prefill batch of every key of the session's prefill_specs (all
    replicas' rows), drawn from ``case["seed"]`` as the launcher draws
    it; with ``case["replica"] = (d, D)`` the batch of D such sessions
    is drawn and replica d's block of every slot's rows kept."""
    rng = np.random.default_rng(case.get("seed", 0))
    d, n = case.get("replica", (0, 1))
    out = {}
    for k, v in session.prefill_specs.items():
        shape = (v.shape[0], v.shape[1] * n) + tuple(v.shape[2:])
        a = (rng.integers(0, session.spec.vocab, shape).astype(np.int32)
             if v.dtype == torch.int32 else
             rng.standard_normal(shape).astype(np.float32) * 0.02)
        out[k] = np.ascontiguousarray(a[:, d * v.shape[1]:(d + 1)
                                        * v.shape[1]])
    return out


def serve_case(session, case):
    """Run ``case["scenario"]`` on ``session``: the tokens every rank
    sees, this rank's ``last_hidden`` after each round (None off the
    last stage), the allocator digest after each round, and the bytes
    the rank holds."""
    from repro_torch.launch.serve import parse_arrivals
    from repro_torch.serving.batcher import ContinuousBatchingSession, Request
    out = {"tokens": [], "hidden": [], "digests": []}

    def after(tokens):
        out["tokens"].append(np.asarray(tokens.cpu().numpy()
                                        if torch.is_tensor(tokens)
                                        else tokens).copy())
        out["hidden"].append(_hidden(session))
        out["digests"].append(session.host_digest())

    kind = case["scenario"]
    if kind == "arrivals":
        rng = np.random.default_rng(case.get("seed", 0))
        trace = [Request(rid=i, prompt=rng.integers(
                     1, session.spec.vocab,
                     case.get("prompt_len", session.text_len)
                 ).astype(np.int32),
                 max_new_tokens=case["decodes"], arrival=int(t))
                 for i, t in enumerate(parse_arrivals(case["arrivals"]))]
        server = ContinuousBatchingSession(session)
        rounds = []
        orig = session._share

        def share(x, shape=None, gather=True):
            got = orig(x, shape, gather)
            rounds.append(session.host_digest())
            return got
        session._share = share
        report = server.run(trace)
        out["requests"] = {r.rid: list(map(int, r.tokens))
                           for r in report.requests}
        out["digests"] = rounds + [session.host_digest()]
        out["steps"] = report.steps
        out["spec_rounds"] = report.spec_rounds
    else:
        nxt = session.prefill(serve_prompts(session, case))
        after(nxt)
        for _ in range(case["decodes"]):
            if kind == "spec":
                last = nxt.cpu().numpy().astype(np.int32)
                drafts = session.draft(last)
                scores, acc = session.verify(
                    np.concatenate([last[:, None], drafts], axis=1))
                after(np.concatenate([scores, acc.repeat(session.rows)[:, None]],
                                     axis=1))
                nxt = torch.from_numpy(scores[np.arange(scores.shape[0]),
                                              acc.repeat(session.rows)]
                                       .astype(np.int32))
            else:
                nxt = session.decode(nxt)
                after(nxt)
    from repro_torch.serving.engine import _leaves
    nbytes = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                            for t in ts)
    p = session.params
    out["bytes"] = {
        "stages": nbytes(_tree_tensors(p["stages"])),
        "embed": nbytes(_tree_tensors(p.get("embed", {}))),
        "head": nbytes(_tree_tensors(p.get("head", {}))),
        "cache": nbytes(_leaves(session.cache)),
        "pages": nbytes(_tree_tensors(session.pages or {})),
    }
    return out


def _tree_tensors(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _tree_tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


def job_serve(grid, cases):
    """Each case of ``cases`` (``{key: case}``) served on this rank:
    :func:`serve_case`'s results by key, with the files the case's
    session opened with ``np.load`` (``"opened"``: a converted
    checkpoint's chunk files)."""
    out = {}
    load = np.load
    for key, case in cases.items():
        opened = []

        def spy(path, *a, **k):
            opened.append(os.path.basename(str(path)))
            return load(path, *a, **k)
        np.load = spy
        try:
            session = serve_session(case, grid)
        finally:
            np.load = load
        out[key] = serve_case(session, case)
        out[key]["opened"] = opened
    # a session's last collectives are its subgroups': no rank tears its
    # groups down while a peer still uses them
    grid.world_group.barrier()
    return out


# --------------------------------------------------------------------------
# sequence-parallel decode (tests/test_torch_serve_sp.py): one session a
# case, on a data x pp grid and in one process
# --------------------------------------------------------------------------

def sp_spec(name):
    """(arch, spec) of tests/_torch_serve_sp_jax.py::spec_of's names, from
    the port's configs: ``gemma3``, ``jamba`` and ``gemma3x8`` (gemma3's
    smoke spec at 8 layers, windowed and global by turns)."""
    if name == "jamba":
        return "jamba-v0.1-52b", configs.get("jamba-v0.1-52b").smoke_spec()
    spec = configs.get("gemma3-4b").smoke_spec()
    if name == "gemma3x8":
        blocks = tuple(spec.blocks[0 if i % 2 == 0 else 2]
                       for i in range(8))
        spec = dataclasses.replace(spec, name="gemma3-smoke-8l", n_layers=8,
                                   blocks=blocks)
    return "gemma3-4b", spec


def sp_session(case, grid=None, sp=True, **kw):
    """``build_serving`` of an SP case (fp32, pp 2, one row) with the
    weights saved at ``case["npz"]``."""
    from repro_torch.serving.engine import build_serving
    arch, spec = sp_spec(case["name"])
    v = case["v"]
    plan = configs.get(arch).SMOKE_PLAN.with_(
        pp=2, tp=1, decode_microbatches=1, virtual_stages=v,
        schedule="serve_interleaved" if v > 1 else "serve_1f")
    session = build_serving(spec, plan, cache_len=case["cache_len"],
                            global_batch=1, compute_dtype=torch.float32,
                            device="cpu", grid=grid, sp=sp, **kw)
    session.start(0)
    session.load_params(unflatten(dict(np.load(case["npz"]))))
    return session


def sp_run(session, decodes: int):
    """``decodes`` decode steps from position 0, token 1 fed first: the
    tokens, the hidden state each step's head read (None off the last
    stage), the host digest after each step, every cache leaf (path ->
    array) and the cache's bytes."""
    from repro_torch.serving.engine import _leaves
    nxt = torch.ones(1, dtype=torch.int32)
    out = {"tokens": [nxt.numpy().copy()], "hidden": [], "digests": []}
    for _ in range(decodes):
        nxt = session.decode(nxt)
        out["tokens"].append(nxt.numpy().copy())
        out["hidden"].append(_hidden(session))
        out["digests"].append(session.host_digest())
    out["cache"] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(node, tuple):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
        else:
            out["cache"][prefix[:-1]] = node.numpy().copy()
    walk(session.cache, "")
    out["cache_bytes"] = sum(t.numel() * t.element_size()
                             for t in _leaves(session.cache))
    out["cache_lens"] = list(session.cache_lens)
    return out


def job_serve_sp(grid, cases):
    """Each SP case of ``cases`` (``{key: case}``) decoded on this rank:
    :func:`sp_run`'s results by key, and the data group's calls."""
    out = {}
    for key, case in cases.items():
        grid.stats = type(grid.stats)()
        out[key] = sp_run(sp_session(case, grid), case["decodes"])
        out[key]["data_calls"] = grid.stats.data_calls
    grid.world_group.barrier()
    return out


def job_greedy_ties(grid, n_vocab: int, vocab: int, seed: int):
    """The sharded greedy head on this rank's vocabulary slice, over two
    heads built from one block of positive columns ``base`` (and
    positive hidden states, so every logit is positive) laid over the
    vocabulary's four quarters: ``[base, base, base[:, idx], base]``,
    where every row's maximum ties across the shard boundary (quarters
    0 and 3) and the lowest id, on rank 0, wins; and ``[base, base,
    10·base[:, idx], base]``, where the maximum sits in quarter 2, on
    rank 1, tied with itself there (``idx`` takes each column of the
    first half twice).  The ids past ``vocab`` copy real ones and must
    lose.  For each head: the tokens the tensor group agrees on (every
    position, and the last), the whole row's ``torch.argmax`` and the
    logits."""
    from repro_torch.core.versioning import table_columns
    from repro_torch.models import lm_head
    g = torch.Generator().manual_seed(seed)
    d, q = 16, n_vocab // 4
    base = torch.rand((d, q), generator=g) + 0.1
    idx = torch.arange(q // 2).repeat(2)
    h = torch.rand((6, 3, d), generator=g) + 0.1
    scale = torch.ones(d)
    grp = grid.tensor_group
    cols = table_columns(n_vocab, grp.index, grp.size)
    out = []
    for mul in (1.0, 10.0):
        head = torch.cat([base, base, mul * base[:, idx], base], dim=1)
        head[:, vocab:] = head[:, :n_vocab - vocab]
        out.append({
            "got": lm_head.greedy_tokens_sharded(head[:, cols], scale, h,
                                                 group=grp, vocab=vocab),
            "last": lm_head.sample_greedy_sharded(head[:, cols], scale, h,
                                                  group=grp, vocab=vocab),
            "want": lm_head.greedy_tokens(head, scale, h, vocab=vocab),
            "logits": lm_head.logits(head, scale, h, vocab=vocab)})
    grid.world_group.barrier()
    return out


# --------------------------------------------------------------------------
# spawning
# --------------------------------------------------------------------------

def _rank_main(rank, world, data, pp, init_file, out_dir, jobs,
               group_timeout, tp=1):
    torch.set_num_threads(1)
    try:
        grid = init_grid(ProcessGrid(data, pp, tp), "gloo",
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


def _forkserver():
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    return ctx


def _watch(procs, what, timeout: float) -> None:
    """Wait for ``procs``; raise once one fails, naming every one that
    has failed after FAIL_GRACE_S more, or when the deadline passes.
    Every process is ended before this returns."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                # a rank that raises takes its peers down with it: they
                # fail on the closed connection, and one of them may exit
                # before the rank that raised has.  Let the ranks finish
                # exiting for a moment, then name every one that failed.
                grace = time.monotonic() + FAIL_GRACE_S
                while (any(p.is_alive() for p in procs)
                       and time.monotonic() < grace):
                    time.sleep(0.05)
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                raise RuntimeError(f"{what}: rank(s) {failed} failed")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{what}: ranks still running "
                                   f"after {timeout} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"{what}: rank(s) {failed} failed")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)


def run_ranks(tmp_path, data: int, pp: int, jobs,
              timeout: float = JOIN_TIMEOUT_S,
              group_timeout: float = GROUP_TIMEOUT_S, tp: int = 1):
    """Run ``jobs`` (``{name: kwargs}`` of the ``job_<name>`` functions,
    in order) on a ``data × pp × tp`` grid of ranks; the results
    by rank, each ``{name: result}``.  Raises once a rank fails, naming
    every rank that has failed after FAIL_GRACE_S more (the others are
    killed), or when the deadline passes."""
    world = data * pp * tp
    ctx = _forkserver()
    init_file = tmp_path / "rendezvous"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, data, pp, str(init_file),
                               str(tmp_path), jobs, group_timeout, tp))
             for r in range(world)]
    for p in procs:
        p.start()
    _watch(procs, list(jobs), timeout)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _launch_rank(rank, world, tmp, argvs):
    """One rank of ``launch/serve.py`` runs: each argv of ``argvs`` in
    turn under torchrun's environment, rank 0's results saved."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    from repro_torch.launch import serve
    out = [serve.main(list(argv) + ["--init-method",
                                    f"file://{tmp}/rendezvous{i}"])
           for i, argv in enumerate(argvs)]
    if rank == 0:
        torch.save(out, os.path.join(tmp, "launch.pt"))


def run_launcher(tmp_path, world: int, argvs,
                 timeout: float = JOIN_TIMEOUT_S):
    """``python -m repro_torch.launch.serve`` on ``world`` ranks, as
    torchrun starts it, for each argv of ``argvs``: rank 0's return
    values.  The deadline and the failure rules of :func:`run_ranks`."""
    ctx = _forkserver()
    procs = [ctx.Process(target=_launch_rank,
                         args=(r, world, str(tmp_path), argvs))
             for r in range(world)]
    for p in procs:
        p.start()
    _watch(procs, "launch", timeout)
    return torch.load(tmp_path / "launch.pt", weights_only=False)
