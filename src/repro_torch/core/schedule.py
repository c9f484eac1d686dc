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

Ported: the training schedules ``1f1b`` (policies ``stash`` and
``vertical``) and ``gpipe`` (``flush`` and ``2bw``), and the serving
schedule ``serve_1f``.  ``interleaved``, ``interleaved_async``,
``serve_interleaved``, the speculative family, live-slot masking and
the memory model come with later slices; a plan that names them
raises.  The tables are pinned to the JAX package by
tests/test_torch_spec.py and tests/test_torch_train_schedule.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Type

import numpy as np

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
    #: virtual chunks per physical stage (interleaving: not ported yet)
    virtual_stages = 1
    #: plan.stash_mode values this schedule accepts (first = default)
    plan_stash_modes: Tuple[str, ...] = ("stash", "vertical")
    #: schedule consumes plan.virtual_stages (> 1): the interleaved family
    takes_virtual_stages = False
    #: forward-only inference schedule (no B slots)
    is_serving = False

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
class ServingSchedule(PipelineSchedule):
    """Forward-only pipelined round: prefill, or one decode step.

    Microbatch m = g·S + o forwards chunk c = j·S + s at
    ``t_F = s + g·v·S + j·S + o`` with no backward slots, so any R ≥ 1
    is valid.  v = 1 is the classic forward-only 1F pipe (stage s
    forwards microbatch t − s, n_ticks = R + S − 1).
    """

    name = "abstract_serve"
    plan_stash_modes = ("stash", "vertical", "flush", "2bw")
    is_serving = True

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
        return ScheduleTables(fwd, bwd, exit_mb, demb)

    def validate(self) -> None:
        """Forward-only dataflow contract: exactly one F per (microbatch,
        chunk), one-tick hops across chunk boundaries, embeds consumed
        exactly at chunk 0, no backward, exit-table agreement."""
        S, R, v = self.n_stages, self.n_microbatches, self.virtual_stages
        tabs = self.tables()
        T, L = self.n_ticks, S * v
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
                c = int(fr[F_CHUNK]) * S + s
                key = (int(fr[F_MB]), c)
                assert key not in f_time, f"duplicate F{key}"
                assert (fr[F_FROM_EMBEDS] == 1) == (c == 0), (t, s)
                f_time[key] = t
        assert len(f_time) == R * L, (len(f_time), R * L)
        for m in range(R):
            for c in range(1, L):
                assert f_time[(m, c)] == f_time[(m, c - 1)] + 1, (m, c)
        for t in range(T):
            fr = tabs.fwd[t, S - 1]
            is_exit = fr[F_MB] >= 0 and fr[F_CHUNK] == v - 1
            assert tabs.exit_mb[t] == (fr[F_MB] if is_exit else -1), t
        assert int((tabs.exit_mb >= 0).sum()) == R
        assert tabs.exit_mb[T - 1] >= 0, "round must end on the last exit"


@dataclasses.dataclass(frozen=True)
class ScheduleServe1F(ServingSchedule):
    """Forward-only 1F serving pipe: stage s forwards microbatch t − s."""

    name = "serve_1f"


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
    "serve_1f": ScheduleServe1F,
}
#: registered in the JAX package, still to port
NOT_PORTED = ("interleaved", "interleaved_async", "serve_interleaved",
              "serve_spec_1f", "serve_spec_interleaved")


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
    default; ``virtual_stages`` is 1 for every ported schedule."""
    cls = _lookup(name)
    kw: Dict[str, object] = {"schedule": name}
    if stash_mode not in cls.plan_stash_modes:
        kw["stash_mode"] = cls.plan_stash_modes[0]
    kw["virtual_stages"] = ((virtual_stages or 2)
                            if cls.takes_virtual_stages else 1)
    return kw


def make_schedule(plan) -> PipelineSchedule:
    """The training schedule a plan asks for.

    ``plan.schedule='auto'`` derives it from ``stash_mode``:
    stash / vertical -> 1f1b, flush / 2bw -> gpipe.  A name the port
    does not have (interleaved, interleaved_async) raises KeyError.
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


def make_serving_schedule(plan, n_microbatches: int = None
                          ) -> ServingSchedule:
    """The forward-only schedule a plan asks for.

    A plan naming a serving schedule gets it; ``'auto'`` and a
    registered training schedule map onto ``serve_1f`` (single-chunk
    plans; the interleaved serving analogue is not ported yet).
    ``n_microbatches`` overrides ``plan.decode_microbatches`` (the engine
    passes its batch-fitted R).  Other names raise: the interleaved and
    speculative serving schedules are not ported yet.
    """
    name = getattr(plan, "schedule", "auto")
    cls = SCHEDULES.get(name)
    if (name == "auto" or (cls is not None and not cls.is_serving)) \
            and plan.virtual_stages == 1:
        name, cls = "serve_1f", SCHEDULES["serve_1f"]
    if cls is None or not cls.is_serving:
        raise KeyError(
            f"no serving schedule {name!r} (virtual_stages="
            f"{plan.virtual_stages}) in the port's registry; registered: "
            f"{sorted(SCHEDULES)}")
    R = (n_microbatches if n_microbatches is not None
         else plan.decode_microbatches)
    return cls(plan.pp, R)
