"""Observability: metrics registry, pipeline trace and reconciliation
(port of ``repro/obs/__init__.py``, numpy only).

One :class:`Observability` rides through a run, handed to
``build_pipeline(obs=)`` / ``build_serving(obs=)`` / ``TrainDriver(
obs=)``, and every execution layer reports into it through two verbs:

  * :meth:`Observability.on_round`: once per executed schedule round
    (train / prefill / decode) with the host wall interval; it feeds
    the ``round_seconds`` / ``rounds_total`` / ``bucket_rounds_total``
    series and, when tracing, the per-tick spans synthesized from the
    round's table (:mod:`repro_torch.obs.trace`);
  * plain registry access (:meth:`counter` / :meth:`gauge` /
    :meth:`histogram` / :meth:`timer`) for the rest: allocator
    occupancy, per-stage seconds, launcher phases.

``obs=None`` everywhere means off, at no cost: call sites test ``if obs
is not None``.  :mod:`repro_torch.obs.reconcile` turns the series back
into planner inputs.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.obs.metrics import Counter, Gauge, Histogram, Registry
from repro_torch.obs.reconcile import (ReconcileReport, reconcile,
                                       stage_seconds)
from repro_torch.obs.trace import RoundRecord, TraceRecorder

__all__ = ["Counter", "Gauge", "Histogram", "Observability",
           "ReconcileReport", "Registry", "RoundRecord", "TraceRecorder",
           "reconcile", "stage_seconds"]


class Observability:
    """Registry, an optional trace recorder and the clock that stamps
    both (``time.perf_counter`` unless an analytic run passes its
    modeled clock)."""

    def __init__(self, registry: Optional[Registry] = None,
                 trace=None,
                 clock: Callable[[], float] = time.perf_counter):
        self.registry = registry if registry is not None else Registry()
        if trace is True:
            trace = TraceRecorder()
        self.trace: Optional[TraceRecorder] = trace or None
        self.clock = clock

    def counter(self, name: str) -> Counter:
        return self.registry.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.registry.gauge(name)

    def histogram(self, name: str) -> Histogram:
        return self.registry.histogram(name)

    def timer(self, name: str, **labels):
        """Phase timer on this object's clock (``Registry.timer``)."""
        return self.registry.timer(name, clock=self.clock, **labels)

    def on_round(self, kind: str, sched, t0: float, t1: float, *,
                 bucket: Optional[int] = None,
                 t_fwd=1.0, t_bwd=1.0) -> None:
        """One executed schedule round: ``[t0, t1)`` seconds over
        ``sched``'s table; ``bucket`` tags a bucketed round with the
        table size it ran."""
        dt = max(float(t1 - t0), 0.0)
        self.registry.histogram("round_seconds").observe(dt, kind=kind)
        self.registry.counter("rounds_total").inc(kind=kind)
        if bucket is not None:
            self.registry.counter("bucket_rounds_total").inc(
                kind=kind, bucket=bucket)
        if self.trace is not None:
            self.trace.record_round(kind, sched, t0, t1, bucket=bucket,
                                    t_fwd=t_fwd, t_bwd=t_bwd)

    def page_gauges(self, alloc, *,
                    queue_depth: Optional[int] = None) -> None:
        """A ``PageAllocator``'s occupancy (and, when given, the
        admission queue depth behind it)."""
        self.registry.gauge("pages_in_use").set(alloc.live_pages)
        self.registry.gauge("pages_free").set(alloc.free_pages)
        if queue_depth is not None:
            self.registry.gauge("admit_queue_depth").set(queue_depth)

    def save(self, *, trace_out: Optional[str] = None,
             metrics_out: Optional[str] = None) -> None:
        if trace_out and self.trace is not None:
            self.trace.save(trace_out)
        if metrics_out:
            self.registry.save(metrics_out)
