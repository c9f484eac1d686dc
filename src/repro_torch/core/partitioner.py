"""PipeDream's partitioning algorithm (paper §3.2) — exact DP, and the
schedule-aware, memory-aware plan search (port of
``repro/core/partitioner.py``).

A(j, m): time of the slowest stage in the optimal pipeline over layers
1..j using m machines.  Either one stage replicated m ways (Case 1) or an
optimal sub-pipeline over 1..i with m−m' machines followed by one stage
over i+1..j replicated m' ways (Case 2):

    T(i→j, m) = (1/m) · max(Σ T_l, Σ W_l^m)
    A(j, m)   = min_{i,m'} max( A(i, m−m'), 2·C_i, T(i+1→j, m') )

O(N²M²) as in the paper.  ``general`` mode reproduces the paper's
non-uniform replication configs (e.g. 7-1, 9-5-1-1); ``rectangular`` mode
constrains replication to be uniform (the data axis) and only splits
layers into S balanced stages.  ``plan_search`` plans training, decode
and prefill (the serving schedules under the serving memory model).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.profiler import (H100_SXM, Hardware, LayerProfile,
                                       comm_time_activations,
                                       comm_time_tp_allreduce,
                                       comm_time_weight_sync,
                                       profile_analytic)
from repro_torch.core.schedule import (SCHEDULES, MemoryModel,
                                       bucket_lattice,
                                       fit_serving_microbatches,
                                       make_schedule, make_serving_schedule,
                                       paper_noam, pick_bucket,
                                       plan_kwargs_for_schedule, serve_ttft,
                                       weighted_round_time)


@dataclasses.dataclass(frozen=True)
class Stage:
    start: int                 # first layer index (inclusive)
    end: int                   # last layer index (inclusive)
    replicas: int

    def __str__(self):
        return f"[{self.start}..{self.end}]x{self.replicas}"


@dataclasses.dataclass(frozen=True)
class Partition:
    stages: Tuple[Stage, ...]
    bottleneck_time: float     # A(N, M): slowest-stage time
    noam: int

    @property
    def config_string(self) -> str:
        """Paper notation, e.g. '7-1' = 7 replicas then 1."""
        return "-".join(str(s.replicas) for s in self.stages)


def _prefix_sums(profiles: Sequence[LayerProfile]):
    t = np.concatenate([[0.0], np.cumsum([p.t_total for p in profiles])])
    w = np.concatenate([[0.0], np.cumsum([p.w_params for p in profiles])])
    return t, w


def stage_time(profiles: Sequence[LayerProfile], i: int, j: int, m: int,
               hw: Hardware, prefix=None) -> float:
    """T(i→j, m), layers i..j inclusive (0-indexed)."""
    if prefix is None:
        t_sum = sum(p.t_total for p in profiles[i:j + 1])
        w_sum = sum(p.w_params for p in profiles[i:j + 1])
    else:
        tp, wp = prefix
        t_sum = tp[j + 1] - tp[i]
        w_sum = wp[j + 1] - wp[i]
    sync = comm_time_weight_sync(w_sum, m, hw)
    return max(t_sum, sync) / m


def _stage_time_table(profiles: Sequence[LayerProfile], machines: int,
                      hw: Hardware, prefix) -> np.ndarray:
    """T[i, j, m] = T(i→j, m) for all layer spans and machine counts.

    Vectorized form of :func:`stage_time`: sums from the prefix arrays,
    sync from the closed-form ps_factor·(m−1)·bytes/m/bw (0 at m=1).
    Shape [n, n, M+1]; column m=0 unused.
    """
    n = len(profiles)
    tp, wp = prefix
    t_sum = tp[None, 1:] - tp[:-1, None]            # [i, j] layers i..j
    w_sum = wp[None, 1:] - wp[:-1, None]
    m = np.arange(machines + 1, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        sync = (hw.ps_factor * (m - 1)[None, None, :]
                * w_sum[:, :, None] * hw.param_bytes / np.maximum(m, 1)
                / hw.sync_bw)
    sync[:, :, :2] = 0.0                            # m <= 1: no sync
    T = np.maximum(t_sum[:, :, None], sync) / np.maximum(m, 1)
    T[:, :, 0] = np.inf
    return T


def partition(profiles: Sequence[LayerProfile], machines: int,
              hw: Hardware) -> Partition:
    """The paper's DP (general mode, per-stage replication).

    The O(N²M²) recurrence with the inner machine-split loop vectorized
    over m' in numpy; bit-identical to :func:`partition_scalar` (the
    original pure-Python DP, kept as the benchmark/test oracle) —
    including its first-strict-improvement-by-1e-15 tie-breaking.
    """
    n = len(profiles)
    M = machines
    prefix = _prefix_sums(profiles)
    c = [comm_time_activations(p.a_bytes, hw) for p in profiles]
    T = _stage_time_table(profiles, M, hw, prefix)

    INF = float("inf")
    A = np.full((n + 1, M + 1), INF)
    # split[j][m] = (i, m') chosen, or None for single stage
    split: List[List[Optional[Tuple[int, int]]]] = [
        [None] * (M + 1) for _ in range(n + 1)]

    A[1][1:] = T[0, 0, 1:]
    A[1:, 1] = T[0, :, 1]

    comm = 2.0 * np.asarray(c, np.float64)
    for j in range(2, n + 1):
        for m in range(2, M + 1):
            best = float(T[0, j - 1, m])                        # Case 1
            arg = None
            # Case 2 over all (i, m') at once: one stage i..j-1 on m'
            # machines after an optimal sub-pipeline over 1..i on m - m'.
            cand = np.maximum(A[1:j, m - 1:0:-1],
                              np.maximum(comm[0:j - 1, None],
                                         T[1:j, j - 1, 1:m]))
            flat = cand.ravel()
            # row-major order == the scalar loop's (i asc, m' asc) visit
            # order, so replaying only the improving entries reproduces
            # its running-best tie-breaking exactly.
            for k in np.flatnonzero(flat < best - 1e-15):
                if flat[k] < best - 1e-15:
                    best = float(flat[k])
                    arg = (int(k) // (m - 1) + 1, int(k) % (m - 1) + 1)
            A[j][m] = best
            split[j][m] = arg

    # Reconstruct
    stages: List[Stage] = []
    j, m = n, M
    while j > 0:
        arg = split[j][m]
        if arg is None:
            stages.append(Stage(0, j - 1, m))
            break
        i, mp = arg
        stages.append(Stage(i, j - 1, mp))
        j, m = i, m - mp
    stages.reverse()
    noam = paper_noam(machines, stages[0].replicas)
    return Partition(tuple(stages), float(A[n][M]), noam)


def partition_scalar(profiles: Sequence[LayerProfile], machines: int,
                     hw: Hardware) -> Partition:
    """Original pure-Python O(N²M²) DP — oracle for :func:`partition`."""
    n = len(profiles)
    M = machines
    prefix = _prefix_sums(profiles)
    c = [comm_time_activations(p.a_bytes, hw) for p in profiles]

    INF = float("inf")
    A = np.full((n + 1, M + 1), INF)
    split: List[List[Optional[Tuple[int, int]]]] = [
        [None] * (M + 1) for _ in range(n + 1)]

    for m in range(1, M + 1):
        A[1][m] = stage_time(profiles, 0, 0, m, hw, prefix)
    for j in range(1, n + 1):
        A[j][1] = stage_time(profiles, 0, j - 1, 1, hw, prefix)

    for j in range(2, n + 1):
        for m in range(2, M + 1):
            best = stage_time(profiles, 0, j - 1, m, hw, prefix)  # Case 1
            arg = None
            for i in range(1, j):
                for mp in range(1, m):
                    cand = max(A[i][m - mp],
                               2.0 * c[i - 1],
                               stage_time(profiles, i, j - 1, mp, hw, prefix))
                    if cand < best - 1e-15:
                        best, arg = cand, (i, mp)
            A[j][m] = best
            split[j][m] = arg

    stages: List[Stage] = []
    j, m = n, M
    while j > 0:
        arg = split[j][m]
        if arg is None:
            stages.append(Stage(0, j - 1, m))
            break
        i, mp = arg
        stages.append(Stage(i, j - 1, mp))
        j, m = i, m - mp
    stages.reverse()
    noam = paper_noam(machines, stages[0].replicas)
    return Partition(tuple(stages), float(A[n][M]), noam)


def partition_brute_force(profiles: Sequence[LayerProfile], machines: int,
                          hw: Hardware) -> float:
    """Exhaustive optimum (tiny instances only) — test oracle for the DP."""
    n = len(profiles)
    prefix = _prefix_sums(profiles)
    c = [comm_time_activations(p.a_bytes, hw) for p in profiles]
    best = [float("inf")]

    def rec(layer: int, machines_left: int, cur_max: float):
        if cur_max >= best[0]:
            return
        if layer == n:
            if machines_left == 0:
                best[0] = cur_max
            return
        for j in range(layer, n):
            comm = 2.0 * c[j] if j + 1 < n else 0.0
            for m in range(1, machines_left + 1):
                t = stage_time(profiles, layer, j, m, hw, prefix)
                rec(j + 1, machines_left - m, max(cur_max, t, comm))

    rec(0, machines, 0.0)
    return best[0]


# --------------------------------------------------------------------------
# Rectangular mode: uniform replication (the data axis), S stages
# --------------------------------------------------------------------------

def partition_rectangular(profiles: Sequence[LayerProfile], n_stages: int,
                          data_replicas: int, hw: Hardware) -> Partition:
    """Balanced contiguous split into exactly ``n_stages`` stages.

    Replication is uniform (= the data mesh axis), so the objective is the
    paper's with m' fixed: minimize max(stage compute, uniform sync, 2·C
    at each boundary).  DP over (layer, stage) in O(N²S).
    """
    n = len(profiles)
    prefix = _prefix_sums(profiles)
    c = [comm_time_activations(p.a_bytes, hw) for p in profiles]

    def seg(i, j):  # layers i..j inclusive
        tp, wp = prefix
        t_sum = tp[j + 1] - tp[i]
        sync = comm_time_weight_sync(wp[j + 1] - wp[i], data_replicas, hw)
        return max(t_sum, sync)

    INF = float("inf")
    A = np.full((n + 1, n_stages + 1), INF)
    arg = np.full((n + 1, n_stages + 1), -1, np.int64)
    A[0][0] = 0.0
    for j in range(1, n + 1):
        for k in range(1, min(j, n_stages) + 1):
            for i in range(k - 1, j):
                boundary = 2.0 * c[i - 1] if i > 0 else 0.0
                cand = max(A[i][k - 1], boundary, seg(i, j - 1))
                if cand < A[j][k]:
                    A[j][k] = cand
                    arg[j][k] = i

    stages: List[Stage] = []
    j, k = n, n_stages
    while k > 0:
        i = int(arg[j][k])
        stages.append(Stage(i, j - 1, data_replicas))
        j, k = i, k - 1
    stages.reverse()
    return Partition(tuple(stages), float(A[n][n_stages]),
                     paper_noam(n_stages, 1))


def uniform_layer_split(n_layers: int, n_stages: int) -> List[Tuple[int, int]]:
    """Equal-count contiguous split (what the mesh path uses when all
    blocks are homogeneous — the rectangular DP reduces to this)."""
    assert n_layers % n_stages == 0
    lps = n_layers // n_stages
    return [(s * lps, (s + 1) * lps - 1) for s in range(n_stages)]


# --------------------------------------------------------------------------
# Schedule-aware, memory-aware plan search
# --------------------------------------------------------------------------
#
# The paper's DP minimizes the steady-state bottleneck; with schedules
# pluggable (core/schedule.py) that objective is blind to the two things
# that differ per schedule: the bubble and the memory footprint.
# plan_search sweeps (pp, tp, schedule, virtual_stages) over feasible
# candidates, scores each by the simulated time-weighted round_time of
# its schedule tables over the rectangular-DP partition, and rejects any
# candidate whose MemoryModel exceeds the device's memory — the
# PipeDream-2BW / BaPipe "joint planner" move.

@dataclasses.dataclass(frozen=True)
class PlanChoice:
    """One scored (pp, tp, schedule, v) candidate.

    ``round_time`` is the ranking score for the candidate's workload:
    the simulated train round for ``workload='train'``, the per-token
    decode round for ``'decode'`` (per accepted token when speculative),
    and the weighted time-to-first-token for ``'prefill'``.
    """

    plan: object                   # ParallelismPlan
    partition: Partition           # rectangular split into pp·v chunks
    round_time: float              # simulated wall-clock of one round [s]
    bubble_fraction: float         # time-weighted idle fraction
    memory: MemoryModel
    hbm_bytes: float               # budget the candidate was checked against
    feasible: bool                 # memory.total_bytes <= hbm_bytes
    workload: str = "train"        # train | prefill | decode
    occupancy: float = 1.0         # expected live-slot fraction (decode)
    # the bucket the round was scored on at occupancy < 1 (None: full R)
    bucket: Optional[int] = None
    # the draft depth a speculative candidate was priced at
    spec_k: Optional[int] = None
    # the storage dtypes it was priced at (None: the compute dtype)
    weight_dtype: Optional[str] = None
    kv_dtype: Optional[str] = None

    @property
    def per_microbatch(self) -> float:
        return self.round_time / self.plan.microbatches

    def describe(self) -> str:
        ok = "fits" if self.feasible else "OVER BUDGET"
        score = "ttft" if self.workload == "prefill" else "round"
        v = self.plan.virtual_stages
        return (f"pp={self.plan.pp} tp={self.plan.tp} "
                f"sched={self.plan.schedule}/{self.plan.stash_mode}"
                f"{f' v={v}' if v > 1 else ''}"
                f"{f' k={self.spec_k}' if self.spec_k is not None else ''}"
                f"{f' w={self.weight_dtype}' if self.weight_dtype else ''}"
                f"{f' kv={self.kv_dtype}' if self.kv_dtype else ''}"
                f" {score}={self.round_time * 1e3:.3f} ms"
                f" bubble={self.bubble_fraction:.3f}"
                f" hbm={self.memory.total_bytes / 1e9:.2f}"
                f"/{self.hbm_bytes / 1e9:.1f} GB [{ok}]")


def _candidate_plan(base_plan, pp: int, tp: int, name: str, v: int):
    """base_plan rewritten to one (pp, tp, schedule, v) candidate."""
    kw = plan_kwargs_for_schedule(name, virtual_stages=v,
                                  stash_mode=base_plan.stash_mode)
    return base_plan.with_(pp=pp, tp=tp, **kw)


def stage_phase_times(profiles: Sequence[LayerProfile], part: Partition,
                      pp: int, tp: int, hw: Hardware, *,
                      data_replicas: int = 1):
    """Per-physical-stage (t_fwd, t_bwd) seconds for a chunked partition.

    ``part`` splits the profiles into pp·v chunks (layer order); chunk c
    runs on stage c % pp (the interleaved placement; v=1 reduces to the
    identity).  Compute divides by tp, each layer pays the tp all-reduce
    both directions, and the wait-free weight sync floors the stage's
    total (the paper's max(compute, sync) overlap model).
    """
    tf = np.zeros(pp)
    tb = np.zeros(pp)
    w = np.zeros(pp)
    for c, st in enumerate(part.stages):
        s = c % pp
        span = profiles[st.start:st.end + 1]
        ar = sum(comm_time_tp_allreduce(p.a_bytes, tp, hw) for p in span)
        tf[s] += sum(p.t_fwd for p in span) / tp + ar
        tb[s] += sum(p.t_bwd for p in span) / tp + ar
        w[s] += sum(p.w_params for p in span) / tp
    for s in range(pp):
        sync = comm_time_weight_sync(w[s], data_replicas, hw)
        tot = tf[s] + tb[s]
        if sync > tot > 0:
            tf[s] *= sync / tot
            tb[s] *= sync / tot
    return tf, tb


def plan_search(spec, base_plan, model_axis: int, hw: Hardware = H100_SXM,
                *, minibatch_tokens: int, data_replicas: int = 1,
                profiles: Optional[Sequence[LayerProfile]] = None,
                schedules: Optional[Sequence[str]] = None,
                max_virtual_stages: int = 4,
                hbm_bytes: Optional[float] = None,
                return_all: bool = False,
                workload: str = "train",
                cache_len: Optional[int] = None,
                global_batch: Optional[int] = None,
                sp: bool = False,
                occupancy: float = 1.0,
                page_size: int = 0,
                spec_k: Optional[int] = None,
                spec_acceptance: float = 0.8,
                spec_draft_cost: float = 0.05,
                spec_verify_cost: float = 0.15,
                weight_dtype: Optional[str] = None,
                kv_dtype: Optional[str] = None):
    """Jointly pick (pp, tp, schedule, virtual_stages) for a model axis.

    Enumerates every pp dividing ``model_axis`` whose chunk count
    divides the layer stack (and whose tp divides the heads), builds the
    candidate's schedule tables, and scores it by the simulated
    time-weighted round_time of those tables over the rectangular-DP
    partition.  Candidates whose :class:`~repro_torch.core.schedule.MemoryModel`
    exceeds the memory budget (``hw.hbm_bytes`` unless overridden) are
    rejected outright — a plan that does not fit is not a plan.

    ``workload``: ``"train"`` plans the training schedules by their
    round; ``"decode"`` the serving schedules (``serve_1f``,
    ``serve_interleaved``) by the per-token round with the attention
    span pinned to ``cache_len`` in the analytic profile; ``"prefill"``
    the serving schedules by :func:`~repro_torch.core.schedule.serve_ttft`.
    Serving needs ``cache_len=`` and ``global_batch=`` (and honours
    ``sp=``): the memory model then carries the cache term, and R is the
    one the engine runs (``fit_serving_microbatches``).

    ``occupancy`` (decode, 0 < occupancy <= 1) scores the round on the
    smallest bucket of ``bucket_lattice(R)`` covering ``ceil(occupancy
    · R)`` live slots (``ServingSchedule.bucketed``, recorded on
    :attr:`PlanChoice.bucket`) while memory keeps the full-R capacity;
    with ``page_size`` the full-length attention KV is priced by pages
    in use at that occupancy (``serving_cache_bytes``), so a decode plan
    over budget dense can fit paged at the same R.

    ``spec_k`` (decode) adds the speculative schedules, one candidate
    per draft depth k in 1..spec_k, scored per accepted token: the
    round stretched by ``1 + k·spec_verify_cost`` plus k draft steps of
    ``spec_draft_cost`` of a mean stage forward, over the expected
    advance ``(1 - alpha^(k+1)) / (1 - alpha)`` at ``alpha =
    spec_acceptance``.  Plain schedules stay in the pool.
    ``weight_dtype`` / ``kv_dtype`` price quantized serving storage.

    Pass measured-calibrated ``profiles``
    (profiler.scale_profiles_to_measurements, or profile_measured) to
    make the search respond to measurements.  Tie-breaking is
    deterministic: round_time, then keeping the base plan's schedule,
    then lower memory, then shallower pipe.

    Returns the best :class:`PlanChoice` (``return_all=True``: the full
    ranked candidate list instead, infeasible ones included).
    """
    assert workload in ("train", "prefill", "decode"), workload
    assert 0.0 < occupancy <= 1.0, occupancy
    assert occupancy == 1.0 or workload == "decode", (
        "occupancy < 1 models a partially live decode batch; prefill "
        "and train rounds are full by construction")
    serving = workload != "train"
    if serving:
        assert cache_len is not None and global_batch is not None, (
            f"plan_search(workload={workload!r}) needs cache_len= and "
            "global_batch= to size the KV/SSM cache term")
    assert page_size == 0 or serving, (
        "page_size prices the serving engine's paged KV cache; training "
        "plans have no KV cache")
    assert (weight_dtype is None and kv_dtype is None) or serving, (
        "weight_dtype/kv_dtype price quantized *serving* storage; "
        "training keeps full-precision weights")
    assert not (page_size and sp), (
        "paged KV and sequence-parallel decode are mutually exclusive "
        "(the engine rejects the combination)")
    if spec_k is not None:
        assert workload == "decode", (
            "spec_k prices speculative draft-verify decode; prefill and "
            "train rounds have no draft loop")
        assert spec_k >= 1, f"spec_k must be >= 1, got {spec_k}"
        assert 0.0 < spec_acceptance <= 1.0, spec_acceptance
    if profiles is None:
        profiles = profile_analytic(
            spec, hw, minibatch_tokens=minibatch_tokens,
            kv_len=cache_len if workload == "decode" else None)
    budget = float(hw.hbm_bytes if hbm_bytes is None else hbm_bytes)
    if serving:
        # the R the engine runs: batch-fitted, 1 under sp
        R = fit_serving_microbatches(base_plan.decode_microbatches,
                                     global_batch, max(data_replicas, 1),
                                     sp=sp)
        base_plan = base_plan.with_(decode_microbatches=R)
    else:
        R = base_plan.microbatches
    names = tuple(schedules) if schedules else (
        (("serve_1f", "serve_interleaved")
         + (("serve_spec_1f", "serve_spec_interleaved")
            if workload == "decode" and spec_k else ()))
        if serving
        else ("1f1b", "gpipe", "interleaved", "interleaved_async"))
    if spec_k is None and any(
            getattr(SCHEDULES.get(n), "is_speculative", False)
            for n in names):
        raise ValueError(
            "speculative schedules in schedules= need spec_k= (the max "
            "draft depth to price); got spec_k=None")
    base_name = (make_serving_schedule(base_plan).name if serving
                 else make_schedule(base_plan).name)
    cands: List[PlanChoice] = []
    parts: dict = {}        # n_chunks -> Partition (schedule-independent)
    phases: dict = {}       # (pp, v, tp) -> (t_fwd, t_bwd)
    for pp in range(1, model_axis + 1):
        if model_axis % pp:
            continue
        tp = model_axis // pp
        if spec.n_heads and spec.n_heads % tp:
            continue
        for name in names:
            cls = SCHEDULES.get(name)
            assert cls is not None, (
                f"unknown schedule {name!r}; registered: "
                f"{sorted(SCHEDULES)}")
            assert cls.is_serving == serving, (
                f"schedule {name!r} does not run the {workload!r} "
                "workload")
            vs = (tuple(range(2, max_virtual_stages + 1))
                  if cls.takes_virtual_stages else (1,))
            for v in vs:
                n_chunks = pp * v
                if spec.n_layers % n_chunks:
                    continue
                # the training interleaved family needs microbatch groups
                if cls.takes_virtual_stages \
                        and cls.needs_group_microbatches and R % pp:
                    continue
                try:
                    spec.stage_program(n_chunks)
                except AssertionError:
                    continue
                plan = _candidate_plan(base_plan, pp, tp, name, v)
                base_sched = make_schedule(plan)
                part = parts.get(n_chunks)
                if part is None:
                    part = parts[n_chunks] = partition_rectangular(
                        profiles, n_chunks, data_replicas, hw)
                key = (pp, v, tp)
                if key not in phases:
                    phases[key] = stage_phase_times(
                        profiles, part, pp, tp, hw,
                        data_replicas=data_replicas)
                tf, tb = phases[key]
                # a speculative schedule is one candidate a draft depth
                ks = (tuple(range(1, spec_k + 1)) if cls.is_speculative
                      else (None,))
                for kk in ks:
                    sched = (base_sched if kk is None else
                             dataclasses.replace(base_sched, spec_k=kk))
                    if serving:
                        mm = sched.memory_model(
                            spec, plan, hw,
                            microbatch_tokens=minibatch_tokens,
                            data_replicas=data_replicas,
                            cache_len=cache_len,
                            global_batch=global_batch, sp=sp,
                            prefill=(workload == "prefill"),
                            page_size=page_size, kv_occupancy=occupancy,
                            weight_dtype=weight_dtype, kv_dtype=kv_dtype)
                    else:
                        mm = sched.memory_model(
                            spec, plan, hw,
                            microbatch_tokens=minibatch_tokens,
                            data_replicas=data_replicas)
                    scored = sched
                    bucket = None
                    if serving and occupancy < 1.0:
                        # the bucket the bucketed engine runs
                        n_live = max(1, math.ceil(occupancy * R))
                        bucket = pick_bucket(n_live, bucket_lattice(R))
                        scored = sched.bucketed(bucket)
                    rt, bubble = weighted_round_time(scored, tf, tb)
                    if workload == "prefill":
                        rt = serve_ttft(scored, tf)
                    if kk is not None:
                        # per accepted token
                        alpha = spec_acceptance
                        exp_adv = (float(kk + 1) if alpha >= 1.0 else
                                   (1.0 - alpha ** (kk + 1))
                                   / (1.0 - alpha))
                        rt = (rt * (1.0 + kk * spec_verify_cost)
                              + kk * spec_draft_cost
                              * float(np.mean(tf))) / exp_adv
                    cands.append(PlanChoice(plan, part, rt, bubble, mm,
                                            budget,
                                            feasible=mm.fits(budget),
                                            workload=workload,
                                            occupancy=occupancy,
                                            bucket=bucket, spec_k=kk,
                                            weight_dtype=weight_dtype,
                                            kv_dtype=kv_dtype))
    assert cands, f"no structurally valid plan for model_axis={model_axis}"

    def rank(c: PlanChoice):
        return (c.round_time, c.plan.schedule != base_name,
                c.memory.total_bytes, c.plan.pp, c.plan.virtual_stages)

    cands.sort(key=rank)
    if return_all:
        return cands
    feasible = [c for c in cands if c.feasible]
    assert feasible, (
        f"no plan fits the {budget / 1e9:.1f} GB HBM budget; closest: "
        f"{min(cands, key=lambda c: c.memory.total_bytes).describe()}")
    return feasible[0]
