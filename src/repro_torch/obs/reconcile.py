"""Measured against predicted: the end of the replan loop (port of
``repro/obs/reconcile.py``, numpy only).

The planner's prediction (``core/schedule.py::weighted_round_time``)
and the executor's measurements (:class:`~repro_torch.obs.trace.
TraceRecorder` rounds, the ``round_seconds`` / ``stage_round_seconds``
series) describe one quantity, wall seconds per schedule round; a ratio
far from 1.0 says the cost model the planner searched over does not
describe the machine it planned for.

  * :func:`reconcile` → :class:`ReconcileReport`: measured round time
    and span-measured bubble beside the table's predictions, printed by
    the launchers;
  * :func:`stage_seconds`: the per-stage mean wall seconds out of a
    :class:`~repro_torch.obs.metrics.Registry`, in the shape
    ``core/profiler.py::scale_profiles_to_measurements`` takes, which
    ``runtime/driver.py::replan_from_registry`` re-plans from.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.schedule import weighted_round_time

__all__ = ["ReconcileReport", "reconcile", "stage_seconds"]


@dataclasses.dataclass(frozen=True)
class ReconcileReport:
    """Measured against predicted for one round kind on one schedule."""

    kind: Optional[str]
    rounds: int                            # measured rounds folded in
    measured_round_s: Optional[float]      # mean wall seconds a round
    predicted_round_s: Optional[float]     # None without absolute costs
    round_ratio: Optional[float]           # measured / predicted
    measured_bubble: Optional[float]       # from the trace's spans
    predicted_bubble: float                # weighted_round_time's bubble

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        ratio = ("n/a" if self.round_ratio is None
                 else f"{self.round_ratio:.3f}")
        meas = ("n/a" if self.measured_round_s is None
                else f"{self.measured_round_s * 1e3:.3f} ms")
        bub = ("n/a" if self.measured_bubble is None
               else f"{self.measured_bubble:.3f}")
        return (f"reconcile[{self.kind or 'all'}]: "
                f"round {meas} measured vs ratio {ratio}; "
                f"bubble {bub} measured vs "
                f"{self.predicted_bubble:.3f} predicted "
                f"({self.rounds} rounds)")


def reconcile(sched, *, trace=None, registry=None,
              kind: Optional[str] = None,
              t_fwd=None, t_bwd=None) -> ReconcileReport:
    """Measured rounds of ``sched`` against its table's prediction.

    Measurements come from ``trace`` (round durations and the
    span-measured bubble) or, without a trace, from ``registry``'s
    ``round_seconds{kind=}`` histogram.  ``t_fwd`` / ``t_bwd`` are
    scalar or per-stage absolute seconds as ``weighted_round_time``
    takes them: with them the report has a predicted round time and a
    ratio; without, only the unit-free bubbles are compared (the
    prediction under uniform costs).  ``t_fwd`` without ``t_bwd`` is a
    forward-only (serving) table, whose backward costs nothing."""
    measured_round = None
    measured_bubble = None
    n_rounds = 0
    if trace is not None:
        recs = [r for r in trace.rounds if kind is None or r.kind == kind]
        n_rounds = len(recs)
        if recs:
            measured_round = trace.measured_round_seconds(kind)
            measured_bubble = trace.measured_bubble_fraction(kind)
    if measured_round is None and registry is not None:
        labels = {} if kind is None else {"kind": kind}
        stats = registry.histogram("round_seconds").stats(**labels)
        n_rounds = stats["count"]
        measured_round = stats["mean"]

    have_costs = t_fwd is not None
    pf = t_fwd if have_costs else 1.0
    if t_bwd is None:
        t_bwd = 0.0 if have_costs else 1.0
    predicted_round, predicted_bubble = weighted_round_time(sched, pf, t_bwd)

    predicted_round_s = float(predicted_round) if have_costs else None
    ratio = None
    if predicted_round_s and measured_round is not None:
        ratio = measured_round / predicted_round_s
    return ReconcileReport(
        kind=kind, rounds=int(n_rounds),
        measured_round_s=measured_round,
        predicted_round_s=predicted_round_s,
        round_ratio=ratio,
        measured_bubble=measured_bubble,
        predicted_bubble=float(predicted_bubble))


def stage_seconds(registry, n_stages: int, *,
                  name: str = "stage_round_seconds") -> List[float]:
    """Per-stage mean wall seconds of the ``name{stage=s}`` histograms,
    s < ``n_stages`` (the series ``TrainDriver`` fills).  Raises
    ``ValueError`` when a stage has no samples: a replan from partial
    telemetry would mis-balance without a word."""
    hist = registry.histogram(name)
    out = []
    for s in range(n_stages):
        mean = hist.stats(stage=s)["mean"]
        if mean is None:
            raise ValueError(
                f"registry has no {name}{{stage={s}}} samples; "
                f"cannot replan from partial telemetry")
        out.append(float(mean))
    return out
