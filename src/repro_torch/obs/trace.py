"""Per-tick pipeline trace → Chrome trace-event JSON (port of
``repro/obs/trace.py``, numpy only).

The host observes one wall interval per executed round (one
``train_step``, ``prefill`` or ``decode`` call).  What it knows without
timing anything is the schedule table: which (tick, stage, microbatch,
chunk) cells are busy and which are bubbles.  :meth:`TraceRecorder.
record_round` synthesizes the per-tick spans from the table and splits
the measured round over the tick phases with the max-active-stage
weighting of ``core/schedule.py::weighted_round_time``, which gives two
invariants:

  * a stage's F / B span count equals the table's non-bubble cells of
    that stage, every round;
  * the bubble fraction measured off the spans equals the table's
    weighted bubble fraction (under the same per-stage costs), so
    measured-vs-predicted reconciliation has its fixed point at ratio
    1.0 on an analytic clock.

The port's executor walks the same tables on the host, and with a
process grid each rank knows its own stage's seconds
(``runtime/driver.py``); the spans stay synthesized from the table so
that one rank's trace shows every stage, as JAX's does.

Output: ``{"traceEvents": [...]}``, ``ph="X"`` complete events (ts / dur
in µs), one ``tid`` track per physical stage under one ``pid``, named by
``ph="M"`` metadata; loadable in Perfetto / ``chrome://tracing``.  Span
``args`` carry (kind, round, tick, stage, phase[, bucket, microbatch,
chunk]); bubble cells are spans too (``phase="bubble"``), never counted
by :meth:`TraceRecorder.span_counts`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.schedule import B_CHUNK, B_MB, F_CHUNK, F_MB

__all__ = ["RoundRecord", "TraceRecorder"]

_PID = 1          # one process track: the pipeline


@dataclasses.dataclass(frozen=True)
class RoundRecord:
    """Host-side summary of one executed round (one table walk)."""

    kind: str                     # train / prefill / decode / ...
    bucket: Optional[int]         # bucketed table size, None when full-R
    t0: float                     # host clock, seconds
    t1: float
    n_spans: int                  # non-bubble cells emitted
    bubble_fraction: float        # idle span time / (S * duration)


class TraceRecorder:
    """Accumulates rounds; saves one Perfetto-loadable trace file."""

    def __init__(self):
        self.events: List[dict] = []
        self.rounds: List[RoundRecord] = []
        self._epoch: Optional[float] = None
        self._named_tracks: set = set()

    def _us(self, t: float) -> float:
        if self._epoch is None:
            self._epoch = t
        return (t - self._epoch) * 1e6

    def _name_track(self, stage: int) -> None:
        if stage in self._named_tracks:
            return
        self._named_tracks.add(stage)
        if not self.events:
            self.events.append({"ph": "M", "name": "process_name",
                                "pid": _PID, "tid": 0,
                                "args": {"name": "pipeline"}})
        self.events.append({"ph": "M", "name": "thread_name", "pid": _PID,
                            "tid": stage,
                            "args": {"name": f"stage {stage}"}})

    def record_round(self, kind: str, sched, t0: float, t1: float, *,
                     bucket: Optional[int] = None,
                     t_fwd=1.0, t_bwd=1.0) -> RoundRecord:
        """Expand one measured round ``[t0, t1)`` over ``sched``'s table.

        ``t_fwd`` / ``t_bwd`` are ``weighted_round_time``'s scalar or
        per-stage relative costs; they shape how the duration is split
        over the ticks (uniform by default).  The span set depends on
        the table alone."""
        tabs = sched.tables()
        S, v = sched.n_stages, sched.virtual_stages
        tf = np.broadcast_to(np.asarray(t_fwd, float), (S,))
        tb = np.broadcast_to(np.asarray(t_bwd, float), (S,))
        fbusy = tabs.fwd[:, :, F_MB] >= 0           # [T, S]
        bbusy = tabs.bwd[:, :, B_MB] >= 0
        f_phase = np.where(fbusy, tf[None, :], 0.0).max(axis=1) / v
        b_phase = np.where(bbusy, tb[None, :], 0.0).max(axis=1) / v
        total_w = float(f_phase.sum() + b_phase.sum())
        duration = max(float(t1 - t0), 0.0)
        # model weight -> measured seconds; an all-bubble table still
        # records the round, with no spans
        scale = duration / total_w if total_w > 0 else 0.0

        for s in range(S):
            self._name_track(s)
        round_idx = len(self.rounds)
        n_spans = 0
        busy_time = 0.0
        cursor = t0
        for t in range(tabs.fwd.shape[0]):
            for phase, tab, busy, cost, plen in (
                    ("F", tabs.fwd, fbusy, tf, f_phase[t]),
                    ("B", tabs.bwd, bbusy, tb, b_phase[t])):
                if plen <= 0.0:
                    continue
                phase_len = plen * scale
                mb_col = F_MB if phase == "F" else B_MB
                ck_col = F_CHUNK if phase == "F" else B_CHUNK
                for s in range(S):
                    args = {"kind": kind, "round": round_idx, "tick": t,
                            "stage": s, "phase": phase}
                    if bucket is not None:
                        args["bucket"] = int(bucket)
                    if busy[t, s]:
                        dur = (cost[s] / v) * scale
                        args["microbatch"] = int(tab[t, s, mb_col])
                        args["chunk"] = int(tab[t, s, ck_col])
                        name = (f"{phase} mb{args['microbatch']}"
                                f".c{args['chunk']}")
                        cat = phase
                        n_spans += 1
                        busy_time += dur
                    else:
                        dur = phase_len
                        args["phase"] = "bubble"
                        name, cat = "bubble", "bubble"
                    self.events.append({
                        "ph": "X", "pid": _PID, "tid": s, "name": name,
                        "cat": cat, "ts": self._us(cursor),
                        "dur": dur * 1e6, "args": args})
                cursor += phase_len
        bubble = (1.0 - busy_time / (S * duration)) if duration > 0 else 0.0
        rec = RoundRecord(kind=kind, bucket=bucket, t0=t0, t1=t1,
                          n_spans=n_spans, bubble_fraction=bubble)
        self.rounds.append(rec)
        return rec

    def span_counts(self, kind: Optional[str] = None) -> Dict[int, int]:
        """Non-bubble span count per stage track (optionally one kind)."""
        counts: Dict[int, int] = {}
        for e in self.events:
            if e["ph"] != "X" or e["cat"] == "bubble":
                continue
            if kind is not None and e["args"]["kind"] != kind:
                continue
            counts[e["tid"]] = counts.get(e["tid"], 0) + 1
        return counts

    def measured_bubble_fraction(self, kind: Optional[str] = None) -> float:
        """Duration-weighted mean bubble fraction over recorded rounds."""
        recs = [r for r in self.rounds
                if (kind is None or r.kind == kind) and r.t1 > r.t0]
        if not recs:
            return 0.0
        dur = np.array([r.t1 - r.t0 for r in recs])
        bub = np.array([r.bubble_fraction for r in recs])
        return float((dur * bub).sum() / dur.sum())

    def measured_round_seconds(self, kind: Optional[str] = None) -> float:
        """Mean measured wall seconds per recorded round."""
        recs = [r for r in self.rounds if kind is None or r.kind == kind]
        if not recs:
            return 0.0
        return float(np.mean([r.t1 - r.t0 for r in recs]))

    def to_json(self) -> dict:
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
