"""Pipeline schedules as static index tables (port of
``repro/core/schedule.py``).

A schedule describes *when* every (microbatch, chunk) forward and
backward runs on every physical stage, and *where* its weights,
residuals and weight versions live, as dense int32 tables indexed by
``(tick, stage)``.  The training executor (core/pipeline.py), the
sequential oracle (core/reference.py) and the serving engine
(serving/engine.py) only walk these tables; no tick/stage index
arithmetic lives there.

Tick model (double-tick): one tick is one F slot then one B slot on
every stage.  Activations produced at tick t are consumed by the next
stage at tick t + 1; the microbatch leaving the last chunk gets its
head loss and starts its backward in the same tick (paper Figure 8).

Ported: every training schedule — ``1f1b`` (policies ``stash`` and
``vertical``), ``gpipe`` (``flush`` and ``2bw``), and the virtual-stage
family ``interleaved`` (flush) and ``interleaved_async`` (per-chunk
weight-version rings) — with the training memory model, and the
serving family ``serve_1f``, ``serve_interleaved``, ``serve_spec_1f``
and ``serve_spec_interleaved`` with live-slot masking, bucketed
variants, ``serve_ttft``, ``bucket_lattice`` and ``pick_bucket``, and
the serving memory model (``default_cache_lens``, the windowed layers'
ring lengths; ``serving_cache_bytes``; ``ServingSchedule.memory_model``
and its speculative override).  The tables are pinned to the JAX
package by tests/test_torch_spec.py, tests/test_torch_train_schedule.py,
tests/test_torch_interleaved.py and tests/test_torch_serving_slots.py,
the memory model by tests/test_torch_serving_planner.py.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, Iterable, List, Optional, Tuple, Type

import numpy as np

from repro_torch import quant
from repro_torch.core.profiler import ACT_BYTES
from repro_torch.models.spec import _block_params

#: forward-table columns
F_MB, F_CHUNK, F_FROM_EMBEDS, F_STASH_WRITE, F_VERSION, F_RESID_WRITE = \
    range(6)
F_COLS = 6

#: backward-table columns
B_MB, B_CHUNK, B_FROM_HEAD, B_VERSION, B_RESID_READ = range(5)
B_COLS = 5


@dataclasses.dataclass(frozen=True)
class ScheduleTables:
    """Dense static tables; -1 marks bubble slots / unused columns.

    fwd      [n_ticks, n_stages, F_COLS]
    bwd      [n_ticks, n_stages, B_COLS]
    exit_mb  [n_ticks]  microbatch leaving the last chunk this tick
    demb_mb  [n_ticks]  microbatch whose d(embeddings) completes this tick
    """

    fwd: np.ndarray
    bwd: np.ndarray
    exit_mb: np.ndarray
    demb_mb: np.ndarray


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """Analytic per-device memory footprint of one schedule × plan.

    All quantities are bytes on the worst (most loaded) device of the
    (stage, tensor) submesh; data replicas hold copies, so the budget is
    per device.
    """

    schedule: str
    weight_bytes: float        # live stage weights (+ embed/head shard)
    stash_bytes: float         # weight-version ring: stash_slots × stage blocks
    resid_bytes: float         # residual ring: resid_slots × microbatch input
    workspace_bytes: float     # in-flight fwd/bwd activations (remat-aware)
    grad_bytes: float          # gradient accumulator (flush family only)
    optimizer_bytes: float     # Adam moments (ZeRO-1 sharded when plan.zero1)
    cache_bytes: float = 0.0   # serving KV/SSM cache; 0 for training

    @property
    def total_bytes(self) -> float:
        return (self.weight_bytes + self.stash_bytes + self.resid_bytes
                + self.workspace_bytes + self.grad_bytes
                + self.optimizer_bytes + self.cache_bytes)

    def fits(self, hbm_bytes: float) -> bool:
        return self.total_bytes <= hbm_bytes

    def headroom(self, hbm_bytes: float) -> float:
        return hbm_bytes - self.total_bytes

    def __str__(self):
        gb = 1 / 1e9
        cache = (f" cache {self.cache_bytes * gb:.2f}"
                 if self.cache_bytes else "")
        return (f"{self.schedule}: total {self.total_bytes * gb:.2f} GB "
                f"(weights {self.weight_bytes * gb:.2f} "
                f"stash {self.stash_bytes * gb:.2f} "
                f"resid {self.resid_bytes * gb:.2f} "
                f"work {self.workspace_bytes * gb:.2f} "
                f"grad {self.grad_bytes * gb:.2f} "
                f"opt {self.optimizer_bytes * gb:.2f}{cache})")


def _interval_color(intervals: Iterable[Tuple[int, int]]) -> Tuple[List[int],
                                                                   int]:
    """Greedy slot assignment for [write, read] lifetimes.

    Within one tick the F phase (writes) runs before the B phase (reads),
    so a slot read at tick r can only be rewritten at tick > r.  Returns
    (slot per interval in input order, number of slots).
    """
    ivs = list(intervals)
    idx = sorted(range(len(ivs)), key=lambda k: ivs[k][0])
    slots = [0] * len(ivs)
    free: List[Tuple[int, int]] = []   # (read_tick, slot)
    n_slots = 0
    for k in idx:
        w, r = ivs[k]
        if free and free[0][0] < w:
            _, s = heapq.heappop(free)
        else:
            s = n_slots
            n_slots += 1
        slots[k] = s
        heapq.heappush(free, (r, s))
    return slots, max(n_slots, 1)


def stage_weight_params(spec, plan, sched) -> Tuple[float, float]:
    """Worst-stage per-device parameter counts ``(blocks, shared)``.

    ``blocks``: the most loaded physical stage's block parameters (stage
    s owns chunks j·S + s of the S·v-way cut), divided by tp.
    ``shared``: the embed + head + final-norm shard over the full
    (stage, tensor) submesh.
    """
    S, v = sched.n_stages, sched.virtual_stages
    assert plan.pp == S and plan.virtual_stages == v, (
        "memory_model called with a plan that does not describe this "
        f"schedule: plan (pp={plan.pp}, v={plan.virtual_stages}) vs "
        f"schedule (S={S}, v={v})")
    L = sched.n_chunks
    assert spec.n_layers % L == 0, (spec.n_layers, L)
    lps = spec.n_layers // L
    tp = plan.tp
    stage_params = [0.0] * S
    for c in range(L):
        stage_params[c % S] += sum(
            _block_params(spec, spec.blocks[i])
            for i in range(c * lps, (c + 1) * lps))
    blocks = max(stage_params) / tp
    shared = (spec.vocab * spec.d_model
              * (1 if spec.tie_embeddings else 2) + spec.d_model)
    shared /= S * tp
    return blocks, shared


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    """Static description of one pipelined round.

    Subclasses set the class attributes below and implement
    ``_build_tables``.  Instances are frozen and hashable; tables are
    built once and cached.
    """

    n_stages: int
    n_microbatches: int

    #: registry name
    name = "abstract"
    #: grads accumulate across the round; one synchronous update at the end
    accumulate = False
    #: stage weights are stashed in a ring of ``stash_slots`` versions
    uses_stash_ring = False
    #: F reads weights from the ring (vertical sync) instead of latest
    fwd_from_stash = False
    #: virtual chunks per physical stage (Megatron interleaving)
    virtual_stages = 1
    #: plan.stash_mode values this schedule accepts (first = default)
    plan_stash_modes: Tuple[str, ...] = ("stash", "vertical")
    #: schedule consumes plan.virtual_stages (> 1): the interleaved family
    takes_virtual_stages = False
    #: virtual stages require microbatch groups (R % pp == 0)
    needs_group_microbatches = True
    #: forward-only inference schedule (no B slots)
    is_serving = False
    #: speculative draft–verify serving schedule
    is_speculative = False

    def __post_init__(self):
        assert self.n_stages >= 1 and self.n_microbatches >= 1

    @property
    def n_chunks(self) -> int:
        """Model chunks = physical stages × virtual stages."""
        return self.n_stages * self.virtual_stages

    @property
    def n_ticks(self) -> int:
        raise NotImplementedError

    @property
    def stash_slots(self) -> int:
        """Weight versions kept per stage (1 = only the live weights)."""
        raise NotImplementedError

    @property
    def resid_slots(self) -> int:
        """Stage-input (residual) ring size: a liveness bound (the
        residual written at F(m) must survive until B(m)), so it does not
        shrink with the weight-version policy."""
        return 2 * (self.n_stages - 1) + 1

    @classmethod
    def from_plan(cls, plan) -> "PipelineSchedule":
        return cls(plan.pp, plan.microbatches)

    def _build_tables(self) -> ScheduleTables:
        raise NotImplementedError

    def tables(self) -> ScheduleTables:
        # per-instance memo (frozen dataclass: route around __setattr__)
        tabs = self.__dict__.get("_tables")
        if tabs is None:
            tabs = self._build_tables()
            for a in (tabs.fwd, tabs.bwd, tabs.exit_mb, tabs.demb_mb):
                a.setflags(write=False)
            object.__setattr__(self, "_tables", tabs)
        return tabs

    @property
    def bubble_fraction(self) -> float:
        """Fraction of (tick, stage, F/B-slot) triples idle over a round."""
        tabs = self.tables()
        busy = int((tabs.fwd[:, :, F_MB] >= 0).sum()
                   + (tabs.bwd[:, :, B_MB] >= 0).sum())
        return 1.0 - busy / (2 * self.n_ticks * self.n_stages)

    def memory_model(self, spec, plan, hw, *, microbatch_tokens: int,
                     data_replicas: int = 1) -> MemoryModel:
        """Analytic worst-device footprint of this schedule: live
        weights + weight-version ring + residual ring + activation
        workspace + gradient accumulator + optimizer."""
        return self._memory_model(
            spec, plan, hw, microbatch_tokens=microbatch_tokens,
            data_replicas=data_replicas,
            weight_ring_slots=self.stash_slots if self.uses_stash_ring
            else 0,
            grad_accum=self.accumulate)

    def _memory_model(self, spec, plan, hw, *, microbatch_tokens: int,
                      data_replicas: int, weight_ring_slots: int,
                      grad_accum: bool) -> MemoryModel:
        """Shared accounting, parameterized by the schedule's ring terms:
        a stash ring holds ``weight_ring_slots`` block copies besides
        ``stash['current']``; the residual ring ``resid_slots``
        stage inputs; flush-family schedules keep one gradient
        accumulator across the round; Adam moments are fp32 and
        ZeRO-1-sharded over the data replicas when the plan says so."""
        lps = spec.n_layers // self.n_chunks
        blocks, shared = stage_weight_params(spec, plan, self)
        pb = hw.param_bytes
        act = microbatch_tokens * spec.d_model * ACT_BYTES
        # remat keeps ~O(1) layer activations live during the recomputed
        # backward; without it the whole chunk's activations stay resident
        workspace = (4.0 if plan.remat else 2.0 * lps + 2.0) * act
        opt = 2.0 * (blocks + shared) * 4.0          # Adam m, v in fp32
        if plan.zero1:
            opt /= max(int(data_replicas), 1)
        return MemoryModel(
            schedule=self.name,
            weight_bytes=(blocks + shared) * pb,
            stash_bytes=weight_ring_slots * blocks * pb,
            resid_bytes=self.resid_slots * act,
            workspace_bytes=workspace,
            grad_bytes=blocks * pb if grad_accum else 0.0,
            optimizer_bytes=opt)

    def validate(self) -> None:
        """Prove the tables satisfy the executor's dataflow contract:
        one F and one B per (microbatch, chunk), one-tick hops, B of the
        last chunk in the tick of its F, exit / d(embeddings) tables that
        agree, and every residual read before its slot is rewritten."""
        S, R, v = self.n_stages, self.n_microbatches, self.virtual_stages
        tabs = self.tables()
        T = self.n_ticks
        assert tabs.fwd.shape == (T, S, F_COLS), tabs.fwd.shape
        assert tabs.bwd.shape == (T, S, B_COLS), tabs.bwd.shape
        f_time: Dict[Tuple[int, int], int] = {}
        b_time: Dict[Tuple[int, int], int] = {}
        for t in range(T):
            for s in range(S):
                fr, br = tabs.fwd[t, s], tabs.bwd[t, s]
                if fr[F_MB] >= 0:
                    key = (int(fr[F_MB]), int(fr[F_CHUNK] * S + s))
                    assert key not in f_time, f"duplicate F{key}"
                    f_time[key] = t
                if br[B_MB] >= 0:
                    key = (int(br[B_MB]), int(br[B_CHUNK] * S + s))
                    assert key not in b_time, f"duplicate B{key}"
                    b_time[key] = t
        L = S * v
        assert len(f_time) == R * L and len(b_time) == R * L, (
            len(f_time), len(b_time), R * L)
        for m in range(R):
            for c in range(L):
                tf, tb = f_time[(m, c)], b_time[(m, c)]
                if c > 0:
                    assert f_time[(m, c - 1)] == tf - 1, (m, c)
                if c < L - 1:
                    assert b_time[(m, c + 1)] == tb - 1, (m, c)
            assert b_time[(m, L - 1)] == f_time[(m, L - 1)], m
        for t in range(T):
            fr = tabs.fwd[t, S - 1]
            is_exit = fr[F_MB] >= 0 and fr[F_CHUNK] == v - 1
            assert tabs.exit_mb[t] == (fr[F_MB] if is_exit else -1), t
            br = tabs.bwd[t, 0]
            is_demb = br[B_MB] >= 0 and br[B_CHUNK] == 0
            assert tabs.demb_mb[t] == (br[B_MB] if is_demb else -1), t
        for s in range(S):
            live: Dict[int, Tuple[int, int]] = {}
            for t in range(T):
                fr = tabs.fwd[t, s]
                if fr[F_MB] >= 0:
                    slot = int(fr[F_RESID_WRITE])
                    assert 0 <= slot < self.resid_slots, slot
                    live[slot] = (int(fr[F_MB]), int(fr[F_CHUNK]))
                br = tabs.bwd[t, s]
                if br[B_MB] >= 0:
                    slot = int(br[B_RESID_READ])
                    assert live.get(slot) == (int(br[B_MB]),
                                              int(br[B_CHUNK])), (
                        f"stage {s} tick {t}: B reads clobbered residual "
                        f"slot {slot}")


@dataclasses.dataclass(frozen=True)
class Schedule1F1B(PipelineSchedule):
    """The paper's one-forward-one-backward schedule (paper §3.3).

    Stage s forwards microbatch t − s and backwards t − 2(S−1) + s.
    ``policy='stash'``: F uses the latest weights and records them into
    ring slot m % V; B re-reads that slot (weight stashing).
    ``policy='vertical'``: F *and* B use the version the stage had when
    microbatch m − 2s entered it (§3.4 vertical sync).
    """

    policy: str = "stash"

    name = "1f1b"
    accumulate = False
    uses_stash_ring = True
    plan_stash_modes = ("stash", "vertical")

    def __post_init__(self):
        super().__post_init__()
        assert self.policy in ("stash", "vertical"), self.policy

    @classmethod
    def from_plan(cls, plan) -> "Schedule1F1B":
        policy = "vertical" if plan.stash_mode == "vertical" else "stash"
        return cls(plan.pp, plan.microbatches, policy=policy)

    @property
    def fwd_from_stash(self) -> bool:  # type: ignore[override]
        return self.policy == "vertical"

    @property
    def n_ticks(self) -> int:
        return self.n_microbatches + 2 * (self.n_stages - 1)

    @property
    def stash_slots(self) -> int:
        """2(S−1)+1: microbatches in flight at the input stage."""
        return 2 * (self.n_stages - 1) + 1

    def _build_tables(self) -> ScheduleTables:
        S, R, V = self.n_stages, self.n_microbatches, self.stash_slots
        T = self.n_ticks
        fwd = np.full((T, S, F_COLS), -1, np.int32)
        bwd = np.full((T, S, B_COLS), -1, np.int32)
        vertical = self.policy == "vertical"
        for t in range(T):
            for s in range(S):
                f = t - s
                fs = min(max(f, 0), R - 1)
                fwd[t, s, F_MB] = f if 0 <= f < R else -1
                fwd[t, s, F_CHUNK] = 0
                fwd[t, s, F_FROM_EMBEDS] = 1 if s == 0 else 0
                fwd[t, s, F_STASH_WRITE] = fs % V
                fwd[t, s, F_VERSION] = (
                    min(max(f - 2 * s, 0), R - 1) % V if vertical else -1)
                fwd[t, s, F_RESID_WRITE] = fs % V

                b = t - 2 * (S - 1) + s
                bs = min(max(b, 0), R - 1)
                bwd[t, s, B_MB] = b if 0 <= b < R else -1
                bwd[t, s, B_CHUNK] = 0
                bwd[t, s, B_FROM_HEAD] = 1 if s == S - 1 else 0
                bwd[t, s, B_VERSION] = (
                    min(max(b - 2 * s, 0), R - 1) % V if vertical
                    else bs % V)
                bwd[t, s, B_RESID_READ] = bs % V
        ticks = np.arange(T)
        exit_mb = np.where((ticks - (S - 1) >= 0) & (ticks - (S - 1) < R),
                           ticks - (S - 1), -1).astype(np.int32)
        demb = np.where((ticks - 2 * (S - 1) >= 0)
                        & (ticks - 2 * (S - 1) < R),
                        ticks - 2 * (S - 1), -1).astype(np.int32)
        return ScheduleTables(fwd, bwd, exit_mb, demb)


@dataclasses.dataclass(frozen=True)
class ScheduleGPipe(Schedule1F1B):
    """Synchronous flush: 1F1B timing, grads accumulated over the round,
    one update at its end (PipeDream-flush).  ``weight_versions=1``
    keeps no ring (weights cannot change mid-round);
    ``weight_versions=2`` keeps a PipeDream-2BW-style double buffer."""

    weight_versions: int = 1

    name = "gpipe"
    accumulate = True
    plan_stash_modes = ("flush", "2bw")
    policy: str = "stash"

    def __post_init__(self):
        super().__post_init__()
        assert self.weight_versions in (1, 2), self.weight_versions

    @classmethod
    def from_plan(cls, plan) -> "ScheduleGPipe":
        return cls(plan.pp, plan.microbatches,
                   weight_versions=2 if plan.stash_mode == "2bw" else 1)

    @property
    def fwd_from_stash(self) -> bool:  # type: ignore[override]
        return False

    @property
    def uses_stash_ring(self) -> bool:  # type: ignore[override]
        return self.weight_versions > 1

    @property
    def stash_slots(self) -> int:
        return self.weight_versions

    def _build_tables(self) -> ScheduleTables:
        tabs = super()._build_tables()
        R = self.n_microbatches
        W, Vr = self.weight_versions, self.resid_slots
        fwd, bwd = tabs.fwd.copy(), tabs.bwd.copy()
        fs = np.clip(fwd[:, :, F_MB], 0, R - 1)
        bs = np.clip(bwd[:, :, B_MB], 0, R - 1)
        fwd[:, :, F_STASH_WRITE] = fs % W
        fwd[:, :, F_VERSION] = -1
        fwd[:, :, F_RESID_WRITE] = fs % Vr
        bwd[:, :, B_VERSION] = bs % W
        bwd[:, :, B_RESID_READ] = bs % Vr
        return ScheduleTables(fwd, bwd, tabs.exit_mb, tabs.demb_mb)


@dataclasses.dataclass(frozen=True)
class ScheduleInterleaved1F1B(PipelineSchedule):
    """Interleaved (virtual-stage) 1F1B, flush semantics.

    The model is cut into L = S·v chunks; chunk c = j·S + s runs on
    physical stage s as its j-th local chunk (storage row s·v + j, see
    ``storage_chunk_order``).  Microbatches advance in groups of S:
    microbatch m = g·S + o forwards chunk (j, s) at tick

        t_F = s + g·v·S + j·S + o

    so every chunk hop — including the stage-(S−1) → stage-0 wrap
    between chunks — lands exactly one tick downstream.  Backwards
    mirror the pattern, the last chunk's backward sharing the tick of
    its forward (head adjacency):

        t_B = (vS − 1) + (S−1−s) + g·v·S + (v−1−j)·S + o

    and n_ticks = vR + (v+1)S − 2.  Gradients accumulate over the round
    and one update applies at its end (one weight version); the
    per-microbatch variant is :class:`ScheduleInterleavedAsync1F1B`.

    Requires R % S == 0 (microbatch groups) and n_layers % (S·v) == 0.
    """

    virtual_stages: int = 2

    name = "interleaved"
    accumulate = True
    uses_stash_ring = False
    fwd_from_stash = False
    plan_stash_modes = ("flush",)
    takes_virtual_stages = True

    def __post_init__(self):
        super().__post_init__()
        assert self.virtual_stages >= 1, self.virtual_stages
        assert self.n_microbatches % self.n_stages == 0, (
            f"interleaved schedule needs microbatches ({self.n_microbatches})"
            f" divisible by stages ({self.n_stages})")

    @property
    def n_ticks(self) -> int:
        S, R, v = self.n_stages, self.n_microbatches, self.virtual_stages
        return v * R + (v + 1) * S - 2

    @property
    def stash_slots(self) -> int:
        return 1

    @property
    def resid_slots(self) -> int:
        return self._layout()[1]

    def storage_chunk_order(self) -> np.ndarray:
        """Chunk id held by each storage row p = s·v + j (length S·v):
        stage s owns rows [s·v, (s+1)·v), and row s·v + j holds model
        chunk j·S + s."""
        S, v = self.n_stages, self.virtual_stages
        return np.asarray([(p % v) * S + p // v for p in range(S * v)],
                          np.int64)

    @classmethod
    def from_plan(cls, plan) -> "ScheduleInterleaved1F1B":
        assert plan.stash_mode == "flush", (
            "schedule='interleaved' is the flush (accumulate) variant and "
            "needs stash_mode='flush'; for per-microbatch async updates "
            "use schedule='interleaved_async' (per-chunk weight-version "
            f"rings, stash_mode='stash'); got {plan.stash_mode!r}")
        return cls(plan.pp, plan.microbatches,
                   virtual_stages=plan.virtual_stages)

    def _timing(self):
        S, R, v = self.n_stages, self.n_microbatches, self.virtual_stages
        items = []       # (m, c, s, j, t_f, t_b)
        for m in range(R):
            g, o = divmod(m, S)
            for c in range(S * v):
                j, s = divmod(c, S)
                t_f = s + g * v * S + j * S + o
                t_b = (v * S - 1) + (S - 1 - s) + g * v * S \
                    + (v - 1 - j) * S + o
                items.append((m, c, s, j, t_f, t_b))
        return items

    def _layout(self):
        """Residual-slot assignment by interval colouring, per stage
        (memoized per instance)."""
        cached = self.__dict__.get("_layout_memo")
        if cached is not None:
            return cached
        items = self._timing()
        per_stage: Dict[int, List[int]] = {}
        for k, item in enumerate(items):
            per_stage.setdefault(item[2], []).append(k)
        slot_of = [0] * len(items)
        n_slots = 1
        for ks in per_stage.values():
            slots, n = _interval_color(
                [(items[k][4], items[k][5]) for k in ks])
            for k, sl in zip(ks, slots):
                slot_of[k] = sl
            n_slots = max(n_slots, n)
        object.__setattr__(self, "_layout_memo", (slot_of, n_slots))
        return slot_of, n_slots

    def _build_tables(self) -> ScheduleTables:
        S, v = self.n_stages, self.virtual_stages
        T, L = self.n_ticks, S * v
        slot_of, _ = self._layout()
        fwd = np.full((T, S, F_COLS), -1, np.int32)
        bwd = np.full((T, S, B_COLS), -1, np.int32)
        exit_mb = np.full((T,), -1, np.int32)
        demb = np.full((T,), -1, np.int32)
        for k, (m, c, s, j, t_f, t_b) in enumerate(self._timing()):
            assert fwd[t_f, s, F_MB] < 0, ("F slot collision", t_f, s)
            fwd[t_f, s, F_MB] = m
            fwd[t_f, s, F_CHUNK] = j
            fwd[t_f, s, F_FROM_EMBEDS] = 1 if c == 0 else 0
            fwd[t_f, s, F_STASH_WRITE] = 0
            fwd[t_f, s, F_VERSION] = -1
            fwd[t_f, s, F_RESID_WRITE] = slot_of[k]
            assert bwd[t_b, s, B_MB] < 0, ("B slot collision", t_b, s)
            bwd[t_b, s, B_MB] = m
            bwd[t_b, s, B_CHUNK] = j
            bwd[t_b, s, B_FROM_HEAD] = 1 if c == L - 1 else 0
            bwd[t_b, s, B_VERSION] = 0
            bwd[t_b, s, B_RESID_READ] = slot_of[k]
            if c == L - 1:
                exit_mb[t_f] = m
            if c == 0:
                demb[t_b] = m
        return ScheduleTables(fwd, bwd, exit_mb, demb)


@dataclasses.dataclass(frozen=True)
class ScheduleInterleavedAsync1F1B(ScheduleInterleaved1F1B):
    """Interleaved 1F1B with per-microbatch updates and per-chunk rings.

    The timing tables of :class:`ScheduleInterleaved1F1B` with the
    paper's §3.3 weight stashing per chunk: F(m, chunk c) records chunk
    c's current weights into ring slot (m % V, c) and B(m, c) re-reads
    that version while the per-microbatch updates advance the live
    weights in between.  The ring is chunk-major, ``[V, S·v, ...]`` in
    storage order, indexed by the table's (version slot, chunk) columns.

    Ring depth V = min(2S, R) (2S − 1 at v = 1): chunk c is in flight for
    2(S·v − 1 − c) ticks, and the forwards of microbatches m and m + 2S
    of one chunk are 2·v·S ticks apart; V = R never revisits a slot
    within a round.
    """

    name = "interleaved_async"
    accumulate = False
    uses_stash_ring = True
    fwd_from_stash = False
    plan_stash_modes = ("stash",)

    @property
    def stash_slots(self) -> int:
        S, R, v = self.n_stages, self.n_microbatches, self.virtual_stages
        base = 2 * S if v > 1 else 2 * S - 1
        return max(1, min(base, R))

    @classmethod
    def from_plan(cls, plan) -> "ScheduleInterleavedAsync1F1B":
        assert plan.stash_mode == "stash", (
            "schedule='interleaved_async' implements the paper's stash "
            "policy per chunk; set stash_mode='stash' (got "
            f"{plan.stash_mode!r})")
        return cls(plan.pp, plan.microbatches,
                   virtual_stages=plan.virtual_stages)

    def _build_tables(self) -> ScheduleTables:
        tabs = super()._build_tables()
        R, V = self.n_microbatches, self.stash_slots
        fwd, bwd = tabs.fwd.copy(), tabs.bwd.copy()
        fs = np.clip(fwd[:, :, F_MB], 0, R - 1)
        bs = np.clip(bwd[:, :, B_MB], 0, R - 1)
        # slot within the row's own chunk ring
        fwd[:, :, F_STASH_WRITE] = fs % V
        fwd[:, :, F_VERSION] = -1            # F uses the latest weights
        bwd[:, :, B_VERSION] = bs % V
        return ScheduleTables(fwd, bwd, tabs.exit_mb, tabs.demb_mb)

    def validate(self) -> None:
        """Structural contract + per-chunk stash-ring liveness."""
        super().validate()
        tabs = self.tables()
        for s in range(self.n_stages):
            live: Dict[Tuple[int, int], int] = {}   # (chunk, slot) -> mb
            for t in range(self.n_ticks):
                fr = tabs.fwd[t, s]
                if fr[F_MB] >= 0:
                    key = (int(fr[F_CHUNK]), int(fr[F_STASH_WRITE]))
                    assert key not in live, (
                        f"stage {s} tick {t}: F clobbers live version "
                        f"slot {key} (holds mb {live[key]})")
                    live[key] = int(fr[F_MB])
                br = tabs.bwd[t, s]
                if br[B_MB] >= 0:
                    key = (int(br[B_CHUNK]), int(br[B_VERSION]))
                    assert live.pop(key, None) == int(br[B_MB]), (
                        f"stage {s} tick {t}: B reads wrong version "
                        f"slot {key}")
            assert not live, f"stage {s}: versions never read: {live}"


def default_cache_lens(spec, pp: int, cache_len: int) -> List[int]:
    """Per-position KV capacities of a ``pp``-chunk split (pass the
    chunk count for a virtual-stage split): a windowed layer needs
    ``min(window, cache_len)`` slots, a global one ``cache_len``, and a
    position gets the largest need over the chunks that share it (8 at
    least), so every chunk has the same state structure."""
    lps = spec.layers_per_stage(pp)
    lens = []
    for i in range(lps):
        need = 0
        for s in range(pp):
            blk = spec.blocks[s * lps + i]
            if blk.mixer != "attn":
                continue
            w = blk.window
            need = max(need, cache_len if w <= 0 else min(w, cache_len))
        lens.append(max(need, 8))
    return lens


def serving_cache_bytes(spec, plan, sched, *, cache_len: int,
                        global_batch: int, sp: bool = False,
                        prefill: bool = False,
                        data_replicas: int = 1,
                        page_size: int = 0,
                        kv_occupancy: float = 1.0,
                        n_slots: Optional[int] = None,
                        kv_dtype: Optional[str] = None) -> float:
    """Worst-stage per-device KV / SSM / WKV cache bytes of one serve
    state, the engine's cache template (serving/engine.py) term for term.

    Stage s holds its chunks' state for every row it serves; rows shard
    over the data replicas (``global_batch / dp`` a device), or under
    sequence-parallel decode (``sp``) replicate while full-length KV
    positions shard (ring buffers stay replicated); KV heads shard over
    tp when divisible.  Without ``prefill`` windowed layers are priced
    at their ring lengths (:func:`default_cache_lens`); a session that
    prefills allocates full-length caches.

    Paged KV (``page_size > 0``): the full-length attention layers (the
    ones the engine pages) are priced by the pages in use, a
    ``kv_occupancy`` fraction of the slots' capacity, rounded up to
    whole slots with ``n_slots``; ring buffers and recurrent state stay
    dense; the int32 page tables are priced once.  Paged + sp raises.

    ``kv_dtype`` prices the KV storage dtype (``repro_torch.quant``):
    "fp32" / "bf16" re-price every attention cache, "int8" the paged
    layers only (one byte plus the amortized per-page scale; dense
    leftovers stay at ``ACT_BYTES``), the engine's layout.
    """
    def _kv_elt_bytes(paged: bool) -> float:
        if kv_dtype is None:
            return ACT_BYTES
        if kv_dtype == "int8":
            return (quant.kv_byte_cost("int8", spec, page_size) if paged
                    else ACT_BYTES)
        return quant.kv_byte_cost(kv_dtype, spec, page_size)

    S, v = sched.n_stages, sched.virtual_stages
    L = S * v
    assert spec.n_layers % L == 0, (spec.n_layers, L)
    lps = spec.n_layers // L
    dp = max(int(data_replicas), 1)
    tp = plan.tp
    if page_size:
        assert not sp, "paged KV and sequence-parallel decode exclusive"
        assert cache_len % page_size == 0, (cache_len, page_size)
    rows = float(global_batch) if sp else global_batch / dp
    lens = ([cache_len] * lps if prefill
            else default_cache_lens(spec, L, cache_len))
    sp_flags = [sp and ln >= cache_len for ln in lens]
    paged_flags = [page_size > 0 and ln >= cache_len for ln in lens]
    if sp:
        lens = [max(-(-ln // dp), 8) if f else ln
                for ln, f in zip(lens, sp_flags)]
    kv_local = (spec.n_kv // tp if spec.n_kv and spec.n_kv % tp == 0
                else spec.n_kv)
    occ = min(max(float(kv_occupancy), 0.0), 1.0)
    if n_slots:
        # the allocator hands out pages by slot: whole slots' worth
        occ = math.ceil(occ * n_slots) / n_slots
    stage_bytes = [0.0] * S
    any_paged = False
    for c in range(L):
        s = c % S
        for i in range(lps):
            blk = spec.blocks[c * lps + i]
            b = 0.0
            if blk.mixer == "attn":
                rows_eff = rows * occ if paged_flags[i] else rows
                any_paged |= paged_flags[i]
                b += 2.0 * rows_eff * lens[i] * kv_local * spec.d_head \
                    * _kv_elt_bytes(paged_flags[i])
            elif blk.mixer == "mamba":
                ms = spec.mamba
                d_inner = ms.expand * spec.d_model // tp
                b += rows * (ms.d_conv - 1) * d_inner * ACT_BYTES
                b += rows * d_inner * ms.d_state * 4.0        # f32 scan
            elif blk.mixer == "rwkv":
                rs = spec.rwkv
                heads = spec.d_model // rs.head_dim // tp
                b += rows * spec.d_model * ACT_BYTES
                b += rows * heads * rs.head_dim * rs.head_dim * 4.0
            if blk.ffn == "rwkv_cmix":
                b += rows * spec.d_model * ACT_BYTES
            stage_bytes[s] += b
    if any_paged:
        # one int32 (slot, page) table, replicated on every stage
        table_bytes = (n_slots or rows) * (cache_len // page_size) * 4.0
        stage_bytes = [b + table_bytes for b in stage_bytes]
    return max(stage_bytes)


@dataclasses.dataclass(frozen=True)
class ServingSchedule(PipelineSchedule):
    """Forward-only pipelined round: prefill, or one decode step.

    Microbatch m = g·S + o forwards chunk c = j·S + s at
    ``t_F = s + g·v·S + j·S + o`` with no backward slots, so any R ≥ 1
    is valid.  v = 1 is the classic forward-only 1F pipe (stage s
    forwards microbatch t − s, n_ticks = R + S − 1).

    Slot liveness (continuous batching): ``live_slots``, a sorted tuple
    of slot indices, masks the tables to a partly occupied batch: a
    dead slot's F rows and exits become bubbles while live slots keep
    their full-R timing.  ``validate()`` proves the forward-only
    contract over the live slots only.  ``None`` means fully live.
    """

    live_slots: Optional[Tuple[int, ...]] = None

    name = "abstract_serve"
    plan_stash_modes = ("stash", "vertical", "flush", "2bw")
    needs_group_microbatches = False
    is_serving = True

    def __post_init__(self):
        super().__post_init__()
        if self.live_slots is not None:
            R = self.n_microbatches
            assert all(0 <= m < R for m in self.live_slots), (
                f"live_slots {self.live_slots} out of range for R={R}")
            assert list(self.live_slots) == sorted(set(self.live_slots)), (
                f"live_slots must be sorted and unique: {self.live_slots}")

    @property
    def live_count(self) -> int:
        """Number of live microbatch slots (R when unmasked)."""
        return (self.n_microbatches if self.live_slots is None
                else len(self.live_slots))

    def live_mask(self) -> np.ndarray:
        """Boolean [R] mask of live slots."""
        mask = np.ones(self.n_microbatches, bool)
        if self.live_slots is not None:
            mask[:] = False
            mask[list(self.live_slots)] = True
        return mask

    def with_live_slots(self, live) -> "ServingSchedule":
        """This schedule with only ``live`` slots occupied (None
        unmasks); live slots keep their timing, dead ones blank."""
        slots = None if live is None else tuple(sorted(set(int(m)
                                                          for m in live)))
        return dataclasses.replace(self, live_slots=slots)

    def bucketed(self, n_live: int) -> "ServingSchedule":
        """The compacted ``n_live``-slot variant: this schedule with
        ``n_microbatches = n_live``, the short round a compacted batch
        whose live slots fill the prefix ``[0, n_live)`` runs.

        Checked on every call: a slot's timing depends only on its own
        index, so the bucket's tables equal the full-R tables masked to
        ``range(n_live)`` and cut to the bucket's ticks, and the masked
        tail past them is all bubble."""
        R = self.n_microbatches
        if not 1 <= n_live <= R:
            raise ValueError(f"bucket size {n_live} outside [1, R={R}]")
        bucket = dataclasses.replace(self, n_microbatches=n_live,
                                     live_slots=None)
        bucket.validate()
        masked = dataclasses.replace(self, live_slots=None).with_live_slots(
            range(n_live))
        bt, mt = bucket.tables(), masked.tables()
        Tb = bucket.n_ticks
        assert (bt.fwd == mt.fwd[:Tb]).all(), (
            "bucketed fwd table is not the masked full-R table with dead "
            "slots deleted")
        assert (bt.exit_mb == mt.exit_mb[:Tb]).all(), (
            "bucketed exit table diverges from the masked full-R exits")
        assert (mt.fwd[Tb:, :, F_MB] < 0).all() and (
            mt.exit_mb[Tb:] < 0).all(), (
            "masked full-R table still schedules work past the bucket's "
            "last tick")
        return bucket

    @property
    def n_ticks(self) -> int:
        S, R, v = self.n_stages, self.n_microbatches, self.virtual_stages
        g, o = divmod(R - 1, S)
        return (S - 1) + g * v * S + (v - 1) * S + o + 1

    @property
    def stash_slots(self) -> int:
        return 1                     # live weights only; nothing stashed

    @property
    def resid_slots(self) -> int:
        return 1                     # no backward, no residual ring

    def memory_model(self, spec, plan, hw, *, microbatch_tokens: int,
                     data_replicas: int = 1, cache_len: int = None,
                     global_batch: int = None, sp: bool = False,
                     prefill: bool = False, page_size: int = 0,
                     kv_occupancy: float = 1.0,
                     weight_dtype: Optional[str] = None,
                     kv_dtype: Optional[str] = None) -> MemoryModel:
        """Serving footprint: weights + KV / SSM cache + in-flight rings.

        No version ring, residual ring, gradient accumulator or
        optimizer state.  The workspace is the engine's rings: R slots of
        embeddings, R of exiting hidden state and one activation in
        flight a stage (``microbatch_tokens`` rows · qlen each).
        ``weight_dtype`` / ``kv_dtype`` price quantized storage
        (``repro_torch.quant``).
        """
        assert cache_len is not None and global_batch is not None, (
            "serving memory_model needs cache_len= and global_batch= "
            "(the KV/SSM cache term is sized from them)")
        blocks, shared = stage_weight_params(spec, plan, self)
        act = microbatch_tokens * spec.d_model * ACT_BYTES
        cache = serving_cache_bytes(
            spec, plan, self, cache_len=cache_len,
            global_batch=global_batch, sp=sp, prefill=prefill,
            data_replicas=data_replicas, page_size=page_size,
            kv_occupancy=kv_occupancy, n_slots=self.n_microbatches,
            kv_dtype=kv_dtype)
        return MemoryModel(
            schedule=self.name,
            weight_bytes=(blocks + shared)
            * quant.weight_byte_cost(weight_dtype, spec, hw),
            stash_bytes=0.0,
            resid_bytes=0.0,
            workspace_bytes=(2.0 * self.n_microbatches + 2.0) * act,
            grad_bytes=0.0,
            optimizer_bytes=0.0,
            cache_bytes=cache)

    def _build_tables(self) -> ScheduleTables:
        S, R, v = self.n_stages, self.n_microbatches, self.virtual_stages
        T = self.n_ticks
        fwd = np.full((T, S, F_COLS), -1, np.int32)
        bwd = np.full((T, S, B_COLS), -1, np.int32)
        exit_mb = np.full((T,), -1, np.int32)
        demb = np.full((T,), -1, np.int32)
        for m in range(R):
            g, o = divmod(m, S)
            for j in range(v):
                for s in range(S):
                    c = j * S + s
                    t = s + g * v * S + j * S + o
                    assert fwd[t, s, F_MB] < 0, ("F slot collision", t, s)
                    fwd[t, s, F_MB] = m
                    fwd[t, s, F_CHUNK] = j
                    fwd[t, s, F_FROM_EMBEDS] = 1 if c == 0 else 0
                    fwd[t, s, F_STASH_WRITE] = 0
                    fwd[t, s, F_VERSION] = -1
                    fwd[t, s, F_RESID_WRITE] = 0
                    if c == S * v - 1:
                        exit_mb[t] = m
        if self.live_slots is not None:
            # dead slots' rows blank to bubbles; live slots keep their
            # full-R timing
            live = self.live_mask()
            mb = fwd[:, :, F_MB]
            dead = (mb >= 0) & ~live[np.clip(mb, 0, R - 1)]
            fwd[dead] = -1
            edead = (exit_mb >= 0) & ~live[np.clip(exit_mb, 0, R - 1)]
            exit_mb[edead] = -1
        return ScheduleTables(fwd, bwd, exit_mb, demb)

    def validate(self) -> None:
        """Forward-only dataflow contract over the live slots: exactly
        one F per (live microbatch, chunk), one-tick hops across chunk
        boundaries (wraps included), embeds consumed exactly at chunk 0,
        no backward, exit-table agreement; a masked table keeps every
        live slot's exit tick."""
        S, R, v = self.n_stages, self.n_microbatches, self.virtual_stages
        tabs = self.tables()
        T, L = self.n_ticks, S * v
        live = self.live_mask()
        live_mbs = [m for m in range(R) if live[m]]
        assert tabs.fwd.shape == (T, S, F_COLS), tabs.fwd.shape
        assert tabs.bwd.shape == (T, S, B_COLS), tabs.bwd.shape
        assert (tabs.bwd[:, :, B_MB] < 0).all(), "serving is forward-only"
        assert (tabs.demb_mb < 0).all(), "no d(embeddings) when serving"
        f_time: Dict[Tuple[int, int], int] = {}
        for t in range(T):
            for s in range(S):
                fr = tabs.fwd[t, s]
                if fr[F_MB] < 0:
                    continue
                assert live[int(fr[F_MB])], (
                    f"tick {t} stage {s}: dead slot {int(fr[F_MB])} "
                    "scheduled")
                c = int(fr[F_CHUNK]) * S + s
                key = (int(fr[F_MB]), c)
                assert key not in f_time, f"duplicate F{key}"
                assert (fr[F_FROM_EMBEDS] == 1) == (c == 0), (t, s)
                f_time[key] = t
        assert len(f_time) == len(live_mbs) * L, (
            len(f_time), len(live_mbs) * L)
        for m in live_mbs:
            for c in range(1, L):
                assert f_time[(m, c)] == f_time[(m, c - 1)] + 1, (m, c)
        for t in range(T):
            fr = tabs.fwd[t, S - 1]
            is_exit = fr[F_MB] >= 0 and fr[F_CHUNK] == v - 1
            assert tabs.exit_mb[t] == (fr[F_MB] if is_exit else -1), t
        assert int((tabs.exit_mb >= 0).sum()) == len(live_mbs)
        if self.live_slots is None:
            assert tabs.exit_mb[T - 1] >= 0, "round must end on the last exit"
        else:
            full = dataclasses.replace(self, live_slots=None)
            fx = full.tables().exit_mb
            keep = (fx >= 0) & live[np.clip(fx, 0, R - 1)]
            assert (tabs.exit_mb == np.where(keep, fx, -1)).all(), (
                "masked exit table moved a live slot's exit tick")


@dataclasses.dataclass(frozen=True)
class ScheduleServe1F(ServingSchedule):
    """Forward-only 1F serving pipe: stage s forwards microbatch t − s."""

    name = "serve_1f"

    @classmethod
    def from_plan(cls, plan) -> "ScheduleServe1F":
        return cls(plan.pp, plan.decode_microbatches)


@dataclasses.dataclass(frozen=True)
class ScheduleServeInterleaved(ServingSchedule):
    """Forward-only interleaved serving: v chunks per physical stage.

    The training interleaved family's chunk placement and storage order
    (chunk c = j·S + s on stage s as local chunk j, storage row s·v + j),
    so a batch prefill completes in R + (S − 1)/v stage passes instead
    of 1F's R + (S − 1) (:func:`serve_ttft`).
    """

    virtual_stages: int = 2

    name = "serve_interleaved"
    takes_virtual_stages = True

    def __post_init__(self):
        super().__post_init__()
        assert self.virtual_stages >= 1, self.virtual_stages

    storage_chunk_order = ScheduleInterleaved1F1B.storage_chunk_order

    @classmethod
    def from_plan(cls, plan) -> "ScheduleServeInterleaved":
        return cls(plan.pp, plan.decode_microbatches,
                   virtual_stages=getattr(plan, "virtual_stages", 1) or 1)


class _SpeculativeServe:
    """Mixin: the draft–verify accept / rollback contract.

    A round feeds each live slot ``spec_k + 1`` tokens (its current
    token and ``spec_k`` drafts) through the unchanged serve tables;
    greedy verification accepts the longest draft prefix matching the
    verifier's argmax, emits ``accepted + 1`` tokens and rolls the other
    ``spec_k - accepted`` positions back (a position decrement, and in
    paged mode the release of the rejected suffix's pages).
    """

    is_speculative = True

    @property
    def verify_qlen(self) -> int:
        """Positions scored per slot per round: spec_k drafts + 1."""
        return self.spec_k + 1

    def accept_pos_delta(self, accepted: int) -> Tuple[int, int]:
        """(advance, rolled_back) = (accepted + 1, spec_k − accepted) for
        a slot that accepted ``accepted`` drafts; outside [0, spec_k]
        raises."""
        a = int(accepted)
        if not 0 <= a <= self.spec_k:
            raise ValueError(
                f"accepted={accepted} outside [0, spec_k={self.spec_k}]")
        return a + 1, self.spec_k - a

    def rollback_table(self) -> np.ndarray:
        """Tick -> slot whose rejected suffix resolves: a slot's
        acceptance is known the tick its last chunk exits, so this
        mirrors ``tables().exit_mb``."""
        return np.asarray(self.tables().exit_mb).copy()

    def validate(self) -> None:
        """Forward-only contract plus the accept / rollback contract."""
        super().validate()
        k = self.spec_k
        assert k >= 1, f"spec_k={k} must be >= 1 for a speculative schedule"
        rb = self.rollback_table()
        tabs = self.tables()
        assert rb.shape == tabs.exit_mb.shape and (rb == tabs.exit_mb).all(), (
            "rollback table must resolve each slot at its exit tick")
        live = self.live_mask()
        counts = np.bincount(rb[rb >= 0], minlength=self.n_microbatches)
        for m in range(self.n_microbatches):
            assert counts[m] == (1 if live[m] else 0), (
                f"slot {m} resolves {counts[m]} times per round")
        for a in range(k + 1):
            adv, rolled = self.accept_pos_delta(a)
            assert adv == a + 1 and rolled == k - a, (a, adv, rolled)
            assert adv + rolled == self.verify_qlen and adv >= 1
        try:
            self.accept_pos_delta(k + 1)
            raise AssertionError("accept_pos_delta(k+1) must raise")
        except ValueError:
            pass

    def memory_model(self, spec, plan, hw, *, microbatch_tokens: int,
                     data_replicas: int = 1, cache_len: int = None,
                     global_batch: int = None, sp: bool = False,
                     prefill: bool = False, page_size: int = 0,
                     kv_occupancy: float = 1.0,
                     weight_dtype: Optional[str] = None,
                     kv_dtype: Optional[str] = None) -> MemoryModel:
        """The serving footprint with the verify width and the draft
        state: the in-flight rings hold ``verify_qlen`` positions a slot
        (the workspace scales by spec_k + 1), plus the slots' draft
        tokens and one drafter row in flight.  Unlike the JAX package's
        override, which drops them (ROADMAP Queue 3), the storage dtypes
        pass on to the plain model."""
        mm = super().memory_model(
            spec, plan, hw, microbatch_tokens=microbatch_tokens,
            data_replicas=data_replicas, cache_len=cache_len,
            global_batch=global_batch, sp=sp, prefill=prefill,
            page_size=page_size, kv_occupancy=kv_occupancy,
            weight_dtype=weight_dtype, kv_dtype=kv_dtype)
        act = microbatch_tokens * spec.d_model * ACT_BYTES
        draft_bytes = self.n_microbatches * self.spec_k * 4.0 + act
        return dataclasses.replace(
            mm,
            workspace_bytes=mm.workspace_bytes * self.verify_qlen
            + draft_bytes)


@dataclasses.dataclass(frozen=True)
class ScheduleServeSpec1F(_SpeculativeServe, ScheduleServe1F):
    """Speculative draft–verify decode on the 1F serving pipe: the
    ``serve_1f`` tick program with rows ``spec_k + 1`` positions wide."""

    spec_k: int = 4

    name = "serve_spec_1f"

    def __post_init__(self):
        super().__post_init__()
        assert self.spec_k >= 1, (
            f"spec_k={self.spec_k} must be >= 1 (0 drafts is plain "
            "serve_1f)")


@dataclasses.dataclass(frozen=True)
class ScheduleServeSpecInterleaved(_SpeculativeServe,
                                   ScheduleServeInterleaved):
    """Speculative draft–verify decode on the interleaved serving pipe."""

    spec_k: int = 4

    name = "serve_spec_interleaved"

    def __post_init__(self):
        super().__post_init__()
        assert self.spec_k >= 1, (
            f"spec_k={self.spec_k} must be >= 1 (0 drafts is plain "
            "serve_interleaved)")


def serve_ttft(sched: PipelineSchedule, t_fwd=1.0) -> float:
    """Weighted time-to-first-token of a prefill round: the F-phase walk
    (each tick costs its slowest active stage's forward, a chunk slot
    1/v of a stage pass) through the tick where the last microbatch
    exits."""
    tabs = sched.tables()
    S, v = sched.n_stages, sched.virtual_stages
    tf = np.broadcast_to(np.asarray(t_fwd, float), (S,))
    fbusy = tabs.fwd[:, :, F_MB] >= 0
    f_phase = np.where(fbusy, tf[None, :], 0.0).max(axis=1) / v
    exits = np.flatnonzero(tabs.exit_mb >= 0)
    assert exits.size, "schedule has no exit ticks"
    return float(f_phase[: int(exits[-1]) + 1].sum())


def bucket_lattice(R: int) -> Tuple[int, ...]:
    """The compacted-variant sizes a bucketed engine runs: powers of two
    below R, and R itself (R = 6 -> (1, 2, 4, 6))."""
    if R < 1:
        raise ValueError(f"R={R} must be >= 1")
    lat = []
    b = 1
    while b < R:
        lat.append(b)
        b *= 2
    lat.append(R)
    return tuple(lat)


def pick_bucket(n_live: int, lattice: Iterable[int]) -> int:
    """Smallest lattice entry that fits ``n_live`` live slots (an empty
    batch runs the smallest bucket)."""
    fits = sorted(b for b in lattice if b >= max(1, int(n_live)))
    if not fits:
        raise ValueError(
            f"no bucket in {sorted(lattice)} fits {n_live} live slots")
    return fits[0]


def weighted_round_time(sched: PipelineSchedule, t_fwd=1.0, t_bwd=2.0
                        ) -> Tuple[float, float]:
    """Wall-clock of one round with per-direction (and per-stage) costs.

    Each tick runs a synchronized F phase then B phase across all
    stages, so a tick's F phase costs the slowest active stage's forward
    (0 when no stage forwards), and a chunk slot costs 1/v of its
    stage's full pass.  ``t_fwd`` / ``t_bwd`` are scalars or
    per-stage arrays of full-stage seconds.  Returns ``(round_time,
    weighted_bubble_fraction)``: idle time over ``n_stages ×
    round_time``.
    """
    tabs = sched.tables()
    S, v = sched.n_stages, sched.virtual_stages
    tf = np.broadcast_to(np.asarray(t_fwd, float), (S,))
    tb = np.broadcast_to(np.asarray(t_bwd, float), (S,))
    fbusy = tabs.fwd[:, :, F_MB] >= 0
    bbusy = tabs.bwd[:, :, B_MB] >= 0
    f_phase = np.where(fbusy, tf[None, :], 0.0).max(axis=1) / v
    b_phase = np.where(bbusy, tb[None, :], 0.0).max(axis=1) / v
    round_time = float(f_phase.sum() + b_phase.sum())
    if round_time <= 0.0:
        return 0.0, 0.0
    busy_time = float((fbusy * (tf[None, :] / v)).sum()
                      + (bbusy * (tb[None, :] / v)).sum())
    return round_time, 1.0 - busy_time / (S * round_time)


SCHEDULES: Dict[str, Type[PipelineSchedule]] = {
    "1f1b": Schedule1F1B,
    "gpipe": ScheduleGPipe,
    "interleaved": ScheduleInterleaved1F1B,
    "interleaved_async": ScheduleInterleavedAsync1F1B,
    "serve_1f": ScheduleServe1F,
    "serve_interleaved": ScheduleServeInterleaved,
    "serve_spec_1f": ScheduleServeSpec1F,
    "serve_spec_interleaved": ScheduleServeSpecInterleaved,
}
#: registered in the JAX package, still to port
NOT_PORTED: Tuple[str, ...] = ()


def _lookup(name: str) -> Type[PipelineSchedule]:
    cls = SCHEDULES.get(name)
    if cls is None:
        why = ("is not ported yet" if name in NOT_PORTED
               else "is not a registered schedule")
        raise KeyError(f"schedule {name!r} {why}; the port's registry: "
                       f"{sorted(SCHEDULES)}")
    return cls


def plan_kwargs_for_schedule(name: str, *, virtual_stages=None,
                             stash_mode=None) -> Dict[str, object]:
    """``ParallelismPlan.with_()`` kwargs that put a plan onto ``name``:
    keeps ``stash_mode`` when the class accepts it, else the class
    default; ``virtual_stages`` defaults to 2 for the interleaved family
    and is 1 for single-chunk schedules."""
    cls = _lookup(name)
    kw: Dict[str, object] = {"schedule": name}
    if stash_mode not in cls.plan_stash_modes:
        kw["stash_mode"] = cls.plan_stash_modes[0]
    kw["virtual_stages"] = ((virtual_stages or 2)
                            if cls.takes_virtual_stages else 1)
    return kw


def virtual_stages_error(schedule_name, virtual_stages) -> str | None:
    """None when the combination is valid, else the CLI error message."""
    if not virtual_stages or virtual_stages <= 1:
        return None
    cls = SCHEDULES.get(schedule_name) if schedule_name else None
    if cls is not None and cls.takes_virtual_stages:
        return None
    return ("--virtual-stages > 1 requires --schedule in "
            f"{sorted(n for n, c in SCHEDULES.items() if c.takes_virtual_stages)}")


def make_schedule(plan) -> PipelineSchedule:
    """The schedule a plan asks for.

    ``plan.schedule='auto'`` derives it from ``stash_mode``:
    stash / vertical -> 1f1b, flush / 2bw -> gpipe.  A name the
    registry does not hold raises KeyError.
    """
    name = getattr(plan, "schedule", "auto")
    if name == "auto":
        name = "gpipe" if plan.stash_mode in ("flush", "2bw") else "1f1b"
    return _lookup(name).from_plan(plan)


def fit_serving_microbatches(decode_microbatches: int, global_batch: int,
                             dp: int, *, sp: bool = False) -> int:
    """Largest R ≤ ``decode_microbatches`` with dp·R | global_batch."""
    if sp:
        return 1
    if decode_microbatches < 1:
        raise ValueError(
            f"decode_microbatches={decode_microbatches} must be >= 1")
    if dp < 1 or global_batch % dp:
        raise ValueError(
            f"global_batch={global_batch} is not divisible by the "
            f"data-parallel degree dp={dp}; no microbatch count can tile "
            "it — pick a batch divisible by dp or reshape the mesh")
    R = min(decode_microbatches, max(global_batch // dp, 1))
    while global_batch % (dp * R):
        R -= 1
    return R


def make_serving_schedule(plan, n_microbatches: int = None,
                          spec_k: int = None) -> ServingSchedule:
    """The forward-only schedule a plan asks for, from the registry.

    A plan naming a serving schedule gets it; ``'auto'`` and a
    registered training schedule map onto the serving analogue of their
    chunking: ``serve_interleaved`` at ``virtual_stages > 1``, else
    ``serve_1f``.  ``n_microbatches`` overrides
    ``plan.decode_microbatches`` (the engine passes its batch-fitted R).
    ``spec_k`` overrides the draft depth of a speculative schedule and
    raises for any other.  Unknown names raise KeyError.
    """
    name = getattr(plan, "schedule", "auto")
    cls = SCHEDULES.get(name)
    if name == "auto" or (cls is not None and not cls.is_serving):
        name = ("serve_interleaved" if plan.virtual_stages > 1
                else "serve_1f")
        cls = SCHEDULES[name]
    if cls is None or not cls.is_serving:
        raise KeyError(
            f"no serving schedule {name!r} in the registry; registered "
            f"serving schedules: "
            f"{sorted(n for n, c in SCHEDULES.items() if c.is_serving)}")
    if spec_k is not None and not cls.is_speculative:
        raise ValueError(
            f"spec_k={spec_k} passed but schedule {name!r} is not "
            "speculative; speculative serving schedules: "
            f"{sorted(n for n, c in SCHEDULES.items() if c.is_speculative)}")
    R = (n_microbatches if n_microbatches is not None
         else plan.decode_microbatches)
    kw = {}
    if cls.takes_virtual_stages:
        kw["virtual_stages"] = plan.virtual_stages
    if spec_k is not None:
        kw["spec_k"] = int(spec_k)
    return cls(plan.pp, R, **kw)


def paper_noam(total_machines: int, input_stage_machines: int) -> int:
    """NUM_OPT_ACTIVE_MINIBATCHES = ceil(#machines / #machines input stage)."""
    return math.ceil(total_machines / input_stage_machines)
