"""Pipeline schedules as static index tables (port of the serving part
of ``repro/core/schedule.py``).

A schedule describes *when* every (microbatch, chunk) forward runs on
every physical stage as dense int32 tables indexed by ``(tick, stage)``.
The serving engine (serving/engine.py) only walks these tables; no
tick/stage index arithmetic lives there.  Activations produced at tick
t are consumed by the next stage at tick t + 1.

This slice ports the forward-only serving family's ``serve_1f``; the
training schedules, ``serve_interleaved``, the speculative family and
live-slot masking come with later slices.  The tables are pinned to the
JAX package by tests/test_torch_spec.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

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
    """Static description of one pipelined round (the part serving uses)."""

    n_stages: int
    n_microbatches: int

    name = "abstract"
    virtual_stages = 1
    takes_virtual_stages = False

    def __post_init__(self):
        assert self.n_stages >= 1 and self.n_microbatches >= 1

    @property
    def n_chunks(self) -> int:
        """Model chunks = physical stages × virtual stages."""
        return self.n_stages * self.virtual_stages

    @property
    def n_ticks(self) -> int:
        raise NotImplementedError

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


@dataclasses.dataclass(frozen=True)
class ServingSchedule(PipelineSchedule):
    """Forward-only pipelined round: prefill, or one decode step.

    Microbatch m = g·S + o forwards chunk c = j·S + s at
    ``t_F = s + g·v·S + j·S + o`` with no backward slots, so any R ≥ 1
    is valid.  v = 1 is the classic forward-only 1F pipe (stage s
    forwards microbatch t − s, n_ticks = R + S − 1).
    """

    name = "abstract_serve"

    @property
    def n_ticks(self) -> int:
        S, R, v = self.n_stages, self.n_microbatches, self.virtual_stages
        g, o = divmod(R - 1, S)
        return (S - 1) + g * v * S + (v - 1) * S + o + 1

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


SCHEDULES: Dict[str, type] = {"serve_1f": ScheduleServe1F}


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

    ``'auto'`` (and an explicit ``'serve_1f'``) resolve to ``serve_1f``;
    ``n_microbatches`` overrides ``plan.decode_microbatches`` (the engine
    passes its batch-fitted R).  Other names raise: the interleaved and
    speculative serving schedules are not ported yet.
    """
    name = getattr(plan, "schedule", "auto")
    if name == "auto" and plan.virtual_stages == 1:
        name = "serve_1f"
    cls = SCHEDULES.get(name)
    if cls is None:
        raise KeyError(
            f"no serving schedule {name!r} (virtual_stages="
            f"{plan.virtual_stages}) in the port's registry; registered: "
            f"{sorted(SCHEDULES)}")
    R = (n_microbatches if n_microbatches is not None
         else plan.decode_microbatches)
    return cls(plan.pp, R)
