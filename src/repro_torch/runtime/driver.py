"""Fault-tolerant training driver (port of ``repro/runtime/driver.py``).

  * periodic per-stage checkpointing (paper §4) + restart from the last
    round checkpointed by *all* stages;
  * failure handling — any exception in a round triggers restore + replay
    (data is deterministic in step, so replayed rounds are identical);
  * elastic scaling — on a world-size change, re-run the planner for the
    new machine count and re-group the stage-stacked parameters
    (checkpoint.reshard_stages, ``reshard_state_for_plan``);
  * straggler mitigation — measured per-stage times feed the
    rectangular partitioner, which proposes a rebalanced (pp, tp) plan
    (the paper's answer to skew: better partitioning, not work stealing);
    :func:`replan_from_registry` re-plans from the seconds a run put in
    its metrics registry.

The port's ``train_step`` updates the state in place, so a round that
fails half way leaves half-updated tensors: a restore overwrites every
one of them from the checkpoint.  The planner's defaults are
:data:`~repro_torch.core.profiler.H100_SXM`.

On a process grid (the bundle's ``grid``) every rank runs a driver over
its own state.  Checkpoints are written rank by rank
(``CheckpointManager(grid=)``).  At the top of each round the ranks
agree, by one flag over the world, whether any rank's ``failure_hook``
raised, and after each save whether any rank's save raised: if one did,
every rank restores the last complete round and replays, so no peer
waits in a hand-off for a rank that went back, and a failed save of the
last round is replayed like any other.  A fault inside a round
(a peer that died, a hand-off that timed out) cannot be agreed on: it
raises, as the process group's timeout makes every peer raise.

Stage seconds.  The JAX step is one fused program, so its host cannot
time stages and takes them from ``stage_seconds_fn``.  On a grid each
rank runs one stage, and the driver measures: a rank's stage seconds
for a round are its wall time over ``train_step`` (ended by a device
synchronise) less the time its hand-offs waited
(``grid.stats.handoff_s``); the largest over a stage's data replicas
and tensor ranks is the stage's (a stage counts once, however many
ranks cut it), and the per-stage vector is all-gathered so that every
rank's registry (rank 0's included) holds every stage's
``stage_round_seconds{stage=}`` series.  These seconds include the
stage's optimizer updates (per microbatch, or the round-end flush and
the embedding's update, all inside ``train_step``), its data-group
gradient sums and the round's metric all-reduce; under NCCL
``handoff_s`` is the posting time only, so a stage's wait on its
stream stays in its seconds.  The round's ``round_seconds`` are the
same wall time, hand-offs included.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager, reshard_stages
from repro_torch.core import profiler as prof
from repro_torch.core.partitioner import PlanChoice, plan_search
from repro_torch.core.schedule import fit_serving_microbatches, make_schedule
from repro_torch.models.spec import stage_varying_scalars
from repro_torch.optim.optimizers import tree_map


@dataclasses.dataclass
class DriverConfig:
    checkpoint_every: int = 10
    max_restarts: int = 3


class TrainDriver:
    """Runs rounds of ``bundle.train_step``, checkpointing every
    ``cfg.checkpoint_every`` rounds; a failed round restores the last
    complete checkpoint (or re-initialises from ``seed`` when there is
    none) and replays from there.

    ``obs`` (default: the bundle's) gets one ``on_round("train", ...)``
    per executed round, replays included; ``stage_seconds_fn`` (round ->
    per-stage seconds) feeds its ``stage_round_seconds{stage=}``
    histograms.  On a grid with ``obs`` and no ``stage_seconds_fn`` the
    driver measures them (module docstring)."""

    def __init__(self, bundle, loader, ckpt_dir: str,
                 cfg: DriverConfig = DriverConfig(),
                 failure_hook: Optional[Callable[[int], None]] = None,
                 seed: int = 0, obs=None,
                 stage_seconds_fn: Optional[Callable[[int], Any]] = None):
        self.bundle = bundle
        self.loader = loader
        self.cfg = cfg
        self.seed = seed
        self.grid = bundle.grid
        self.ckpt = CheckpointManager(ckpt_dir, grid=self.grid,
                                      spec=bundle.spec)
        self.failure_hook = failure_hook or (lambda step: None)
        self.obs = obs if obs is not None else bundle.obs
        self.stage_seconds_fn = stage_seconds_fn
        self.metrics_log: List[Dict[str, float]] = []
        self.round_seconds: List[float] = []
        self.stage_seconds: List[List[float]] = []   # measured, a round

    # ---------------- main loop -------------------------------------------

    def run(self, state, n_rounds: int, start_step: int = 0):
        plan = self.bundle.plan
        n_rows = plan.pp * plan.virtual_stages      # stage-stacked rows
        step = start_step
        restarts = 0
        while step < n_rounds:
            try:
                self.failure_hook(step)          # may raise (simulated fault)
                err = None
            except Exception as e:
                err = e
            if self._failed(err):
                state, step, restarts = self._recover(state, err, restarts)
                continue
            try:
                state = self._round(state, step)
            except Exception as e:
                if self.grid is not None:
                    # peers may wait in a hand-off: the group's timeout
                    # makes them raise too
                    raise
                state, step, restarts = self._recover(state, e, restarts)
                continue
            step += 1
            if step % self.cfg.checkpoint_every == 0:
                try:
                    self.ckpt.save(step, state, n_rows)
                    err = None
                except Exception as e:
                    err = e
                if self._failed(err):
                    # before the next round's hook, and before the loop
                    # can end on the last round's save
                    state, step, restarts = self._recover(state, err,
                                                          restarts)
                    continue
                # durable progress: a complete checkpoint resets the
                # failure budget, so max_restarts bounds *consecutive*
                # failures, not sporadic ones over a long run
                if self.ckpt.latest_complete_round() == step:
                    restarts = 0
        return state, step

    def _failed(self, err) -> bool:
        """Whether this rank's ``err`` (or on a grid any rank's) is set:
        one flag over the world, so every rank restores together."""
        failed = err is not None
        if self.grid is not None:
            failed = self.grid.world_group.any_flag(failed)
        return failed

    def _recover(self, state, err, restarts: int):
        """(state, round, restarts) after a failure: the last complete
        checkpoint restored, or ``err`` (a peer's failure on a rank
        without one) raised once ``cfg.max_restarts`` are spent."""
        restarts += 1
        if restarts > self.cfg.max_restarts:
            if err is not None:
                raise err
            raise RuntimeError(f"a peer rank failed {restarts} times in a "
                               "row")
        state, step = self.restore_latest(state)
        return state, step, restarts

    def _round(self, state, step: int):
        """One executed round, timed and reported."""
        batch = self.loader.get(step)
        clk = self.obs.clock if self.obs is not None else time.perf_counter
        waited = self.grid.stats.handoff_s if self.grid is not None else 0.0
        t0 = clk()
        state, metrics = self.bundle.train_step(state, batch)
        if self.bundle.device.type == "cuda":
            torch.cuda.synchronize(self.bundle.device)
        t1 = clk()
        self.round_seconds.append(t1 - t0)
        self.metrics_log.append({k: float(v) for k, v in metrics.items()})
        if self.obs is not None:
            self.obs.on_round("train", self.bundle.sched, t0, t1)
            seconds = None
            if self.stage_seconds_fn is not None:
                seconds = self.stage_seconds_fn(step)
            elif self.grid is not None:
                own = (t1 - t0) - (self.grid.stats.handoff_s - waited)
                seconds = self._stage_seconds(own)
                self.stage_seconds.append(seconds)
            if seconds is not None:
                hist = self.obs.histogram("stage_round_seconds")
                for s, sec in enumerate(seconds):
                    hist.observe(float(sec), stage=s)
        return state

    def _stage_seconds(self, own: float) -> List[float]:
        """Every stage's seconds from each rank's own: the largest over
        the ranks that hold the stage (its replicas and tensor ranks)."""
        topo = self.grid.topo
        by_rank = [v[0] for v in
                   self.grid.world_group.all_gather_floats([own])]
        stage_of = [topo.coords(r)[1] for r in range(topo.world)]
        return [max(sec for sec, st in zip(by_rank, stage_of) if st == s)
                for s in range(topo.pp)]

    def restore_latest(self, state):
        """(state, round) of the last complete checkpoint, copied into
        ``state``'s tensors; with none, a fresh state from the run's seed
        and round 0."""
        rnd = self.ckpt.latest_complete_round()
        if rnd is None:
            gen = torch.Generator(self.bundle.device).manual_seed(self.seed)
            return self.bundle.init_state(gen), 0
        return self.ckpt.restore(rnd, state), rnd


# --------------------------------------------------------------------------
# Elastic re-planning
# --------------------------------------------------------------------------

def elastic_replan(spec, old_plan, new_model_axis: int, hw=prof.H100_SXM,
                   *, minibatch_tokens: int, data_replicas: int,
                   measured_stage_seconds=None, schedules=None,
                   hbm_bytes=None) -> Any:
    """Choose (pp, tp, schedule, virtual_stages) for a new model axis
    (:func:`~repro_torch.core.partitioner.plan_search`); a shrink may
    re-pick the schedule too, and ``reshard_state_for_plan`` regroups
    the chunks.  ``measured_stage_seconds`` (per physical stage of
    ``old_plan``) calibrates the analytic profile first."""
    return plan_choice(spec, old_plan, new_model_axis, hw,
                       minibatch_tokens=minibatch_tokens,
                       data_replicas=data_replicas,
                       measured_stage_seconds=measured_stage_seconds,
                       schedules=schedules, hbm_bytes=hbm_bytes).plan


def plan_choice(spec, old_plan, new_model_axis: int, hw=prof.H100_SXM, *,
                minibatch_tokens: int, data_replicas: int,
                measured_stage_seconds=None, schedules=None,
                hbm_bytes=None) -> PlanChoice:
    """elastic_replan returning the full scored PlanChoice (round_time,
    bubble, MemoryModel)."""
    profiles = prof.profile_analytic(spec, hw,
                                     minibatch_tokens=minibatch_tokens)
    if measured_stage_seconds is not None:
        profiles = prof.scale_profiles_to_measurements(
            profiles, measured_stage_seconds, n_stages=old_plan.pp,
            virtual_stages=old_plan.virtual_stages)
    return plan_search(spec, old_plan, new_model_axis, hw,
                       minibatch_tokens=minibatch_tokens,
                       data_replicas=data_replicas, profiles=profiles,
                       schedules=schedules, hbm_bytes=hbm_bytes)


def plan_search_report(spec, base_plan, hw=prof.H100_SXM, *, seq_len: int,
                       global_batch: int, data_replicas: int,
                       prefix: str = "", workload: str = "train",
                       sp: bool = False, weight_dtype=None,
                       kv_dtype=None) -> PlanChoice:
    """The launcher's surface: search over the base plan's model axis
    (pp × tp), print the choice and its memory model, return it.

    Serving workloads take the microbatch's tokens from the decode
    microbatch count the engine runs (one query token a row when
    decoding, ``seq_len`` when prefilling) and price the KV / SSM cache
    of ``cache_len = seq_len`` beside the weights."""
    dp = max(data_replicas, 1)
    if workload == "train":
        mb_tokens = seq_len * max(global_batch // dp
                                  // base_plan.microbatches, 1)
        choice = plan_choice(spec, base_plan, base_plan.pp * base_plan.tp,
                             hw, minibatch_tokens=mb_tokens,
                             data_replicas=data_replicas)
    else:
        R = fit_serving_microbatches(base_plan.decode_microbatches,
                                     global_batch, dp, sp=sp)
        rows = global_batch if sp else max(global_batch // dp // R, 1)
        mb_tokens = rows * (seq_len if workload == "prefill" else 1)
        choice = plan_search(spec, base_plan, base_plan.pp * base_plan.tp,
                             hw, minibatch_tokens=mb_tokens,
                             data_replicas=data_replicas,
                             workload=workload, cache_len=seq_len,
                             global_batch=global_batch, sp=sp,
                             weight_dtype=weight_dtype, kv_dtype=kv_dtype)
    print(f"{prefix}plan_search[{workload}]: {choice.describe()}")
    print(f"{prefix}  predicted {choice.memory}")
    return choice


def _storage_perms(plan):
    """(to_layer_major, from_layer_major) row-gather indices, or None.

    Interleaved storage row p = s·v + j holds model chunk j·S + s
    (schedule.storage_chunk_order); layer-major order is what
    ``reshard_stages`` regroups over.
    """
    if plan.virtual_stages == 1:
        return None
    order = np.asarray(make_schedule(plan).storage_chunk_order())
    return np.argsort(order), order


def _take_rows(tree, idx):
    return tree_map(lambda a: a[torch.as_tensor(idx, device=a.device)], tree)


def _regroup_chunks(tree, old_plan, new_plan):
    """Stage-stacked leaves [old_chunks, ...] -> [new_chunks, ...],
    through canonical layer-major chunk order."""
    old_chunks = old_plan.pp * old_plan.virtual_stages
    new_chunks = new_plan.pp * new_plan.virtual_stages
    src = _storage_perms(old_plan)
    if src is not None:
        tree = _take_rows(tree, src[0])
    tree = reshard_stages(tree, old_chunks, new_chunks)
    dst = _storage_perms(new_plan)
    if dst is not None:
        tree = _take_rows(tree, dst[1])
    return tree


def reshard_state_for_plan(state, spec, old_plan, new_plan):
    """Move a training state to a new pipeline layout.

    Handles any (pp, virtual_stages) -> (pp', virtual_stages') move:
    parameters are keyed by global layer, so an interleaved source or
    target is a storage-order permutation around the same layer-major
    regroup.  Whether a stash ring exists, and its size, come from the
    target plan's schedule: a flush / interleaved target drops the ring,
    a 1F1B target rebuilds it at the new 2(S−1)+1 size from the current
    weights, an async-interleaved target rebuilds the chunk-major
    per-chunk ring (the restart is a sync point, so seeding every
    version with the live weights is exact).  Returns a new state; the
    input is not written.
    """
    old_sched, new_sched = make_schedule(old_plan), make_schedule(new_plan)
    same_layout = (old_plan.virtual_stages == new_plan.virtual_stages
                   and old_plan.pp == new_plan.pp)
    has_rings = "stash" in state
    old_ring = old_sched.uses_stash_ring and has_rings
    new_ring = new_sched.uses_stash_ring and has_rings
    if same_layout and old_ring == new_ring \
            and (not new_ring
                 or old_sched.stash_slots == new_sched.stash_slots):
        return state
    # a schedule-only change at the same (pp, v) still falls through: the
    # stash ring must be dropped / rebuilt to the new schedule
    new_chunks = new_plan.pp * new_plan.virtual_stages
    new_stages = (state["params"]["stages"] if same_layout
                  else _regroup_chunks(state["params"]["stages"],
                                       old_plan, new_plan))
    out = dict(state)
    params = dict(state["params"])
    params["stages"] = new_stages
    # windows / thetas re-derive from the spec (rows follow storage order)
    w, t = stage_varying_scalars(spec, new_chunks)
    dst = _storage_perms(new_plan)
    if dst is not None:
        w, t = [w[i] for i in dst[1]], [t[i] for i in dst[1]]
    params["layer_windows"], params["layer_thetas"] = w, t
    out["params"] = params
    if "opt_stages" in state:
        out["opt_stages"] = {
            slot: (sub if same_layout
                   else _regroup_chunks(sub, old_plan, new_plan))
            for slot, sub in state["opt_stages"].items()}
    if has_rings:
        out["stash"] = {"current": new_stages}
        if new_sched.uses_stash_ring:
            V = new_sched.stash_slots
            out["stash"]["ring"] = tree_map(
                lambda a: a[None].expand((V,) + tuple(a.shape)).clone(),
                new_stages)
    return out


# --------------------------------------------------------------------------
# Straggler mitigation: profile-guided rebalancing
# --------------------------------------------------------------------------

def rebalance_from_measurements(spec, plan, measured_stage_seconds,
                                hw=prof.H100_SXM, *, minibatch_tokens: int,
                                data_replicas: int, slack: float = 1.25,
                                schedules=None, hbm_bytes=None):
    """If one stage is >slack× the median (straggler), propose a new plan.

    Returns (new_plan, rebalanced: bool).  The measured per-stage times
    are scaled into the analytic profile
    (profiler.scale_profiles_to_measurements) before the search, so the
    DP sees the straggler's layers as slower.
    """
    times = np.asarray(measured_stage_seconds, float)
    med = float(np.median(times))
    if med <= 0 or float(times.max()) <= slack * med:
        return plan, False
    new_plan = elastic_replan(spec, plan, plan.pp * plan.tp, hw,
                              minibatch_tokens=minibatch_tokens,
                              data_replicas=data_replicas,
                              measured_stage_seconds=measured_stage_seconds,
                              schedules=schedules, hbm_bytes=hbm_bytes)
    same = ((new_plan.pp, new_plan.tp, new_plan.virtual_stages)
            == (plan.pp, plan.tp, plan.virtual_stages)
            and make_schedule(new_plan).name == make_schedule(plan).name)
    if same and plan.pp > 1:
        # fall back: halve pipeline depth, double tensor parallelism —
        # but only if that plan would survive plan_search's own checks
        fb = plan.with_(pp=plan.pp // 2, tp=plan.tp * 2)
        if _plan_is_buildable(spec, fb, hw,
                              minibatch_tokens=minibatch_tokens,
                              data_replicas=data_replicas,
                              hbm_bytes=hbm_bytes):
            new_plan = fb
    return new_plan, True


def replan_from_registry(spec, plan, registry, hw=prof.H100_SXM, *,
                         minibatch_tokens: int, data_replicas: int,
                         slack: float = 1.25, schedules=None,
                         hbm_bytes=None):
    """Rebalance from the telemetry a run collected: the per-stage mean
    seconds of the registry's ``stage_round_seconds{stage=}`` histograms
    (filled by :class:`TrainDriver`, measured on a grid) into
    :func:`rebalance_from_measurements`, the end of the paper's profile →
    plan → measure → replan loop.  Returns ``(new_plan, rebalanced)``;
    raises ``ValueError`` when one of ``plan.pp`` stages has no
    samples."""
    from repro_torch.obs.reconcile import stage_seconds
    measured = stage_seconds(registry, plan.pp)
    return rebalance_from_measurements(
        spec, plan, measured, hw, minibatch_tokens=minibatch_tokens,
        data_replicas=data_replicas, slack=slack, schedules=schedules,
        hbm_bytes=hbm_bytes)


def _plan_is_buildable(spec, plan, hw, *, minibatch_tokens: int,
                       data_replicas: int, hbm_bytes=None) -> bool:
    """Structural + memory feasibility, mirroring plan_search's filters."""
    n_chunks = plan.pp * plan.virtual_stages
    if spec.n_layers % n_chunks:
        return False
    if spec.n_heads and spec.n_heads % plan.tp:
        return False
    if spec.n_kv and spec.n_kv % plan.tp and plan.tp % spec.n_kv:
        return False
    if plan.virtual_stages > 1 and plan.microbatches % plan.pp:
        return False
    try:
        spec.stage_program(n_chunks)
    except AssertionError:
        return False
    mm = make_schedule(plan).memory_model(
        spec, plan, hw, microbatch_tokens=minibatch_tokens,
        data_replicas=data_replicas)
    budget = hw.hbm_bytes if hbm_bytes is None else hbm_bytes
    return mm.fits(budget)
