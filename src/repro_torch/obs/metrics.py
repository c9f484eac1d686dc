"""Metrics registry: labeled counters / gauges / histograms (port of
``repro/obs/metrics.py``, numpy only).

The measurement half of the paper's profile → plan → measure → replan
loop needs one place for numbers: the engine's rounds, the page
allocator's occupancy, ``TrainDriver``'s per-stage wall times.  This module
is that sink: named metric families, each fanning out into labeled
series (``rounds_total{kind=decode}``, ``stage_round_seconds{stage=1}``),
snapshot to JSON-safe dicts (``scripts/bench_check.py::
check_metrics_snapshot`` checks the schema).

  * :class:`Counter` — monotone accumulator (``inc``);
  * :class:`Gauge` — last write wins (``set``);
  * :class:`Histogram` — samples with percentile summaries
    (``observe``); an empty series summarizes to ``None``, never NaN
    (NaN survives ``json.dump`` and poisons every comparison after it).

``Registry.timer`` is the phase timer the launchers use: a context
manager observing its elapsed seconds into a histogram series, on a
pluggable clock so analytic runs time modeled seconds through the same
path.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "Registry"]

LabelKey = Tuple[Tuple[str, str], ...]


def _key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_dict(key: LabelKey) -> Dict[str, str]:
    return {k: v for k, v in key}


class _Metric:
    """One named family of labeled series."""

    kind = "metric"

    def __init__(self, name: str):
        self.name = name
        self._series: Dict[LabelKey, object] = {}

    def labelsets(self) -> List[Dict[str, str]]:
        return [_label_dict(k) for k in sorted(self._series)]


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> float:
        if amount < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc({amount}))")
        k = _key(labels)
        self._series[k] = self._series.get(k, 0.0) + float(amount)
        return self._series[k]

    def value(self, **labels) -> float:
        return float(self._series.get(_key(labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[_key(labels)] = float(value)

    def value(self, **labels) -> Optional[float]:
        v = self._series.get(_key(labels))
        return None if v is None else float(v)


class Histogram(_Metric):
    kind = "histogram"

    def observe(self, value: float, **labels) -> None:
        self._series.setdefault(_key(labels), []).append(float(value))

    def values(self, **labels) -> List[float]:
        return list(self._series.get(_key(labels), ()))

    def stats(self, **labels) -> Dict[str, Optional[float]]:
        """count / sum / mean / min / max / p50 / p99; ``None`` when
        the series is empty."""
        v = np.asarray(self._series.get(_key(labels), ()), float)
        if not v.size:
            return {"count": 0, "sum": 0.0, "mean": None, "min": None,
                    "max": None, "p50": None, "p99": None}
        return {"count": int(v.size), "sum": float(v.sum()),
                "mean": float(v.mean()), "min": float(v.min()),
                "max": float(v.max()),
                "p50": float(np.percentile(v, 50)),
                "p99": float(np.percentile(v, 99))}


class _Timer:
    """Context manager observing elapsed clock time into a histogram."""

    def __init__(self, hist: Histogram, clock: Callable[[], float],
                 labels: Dict[str, object]):
        self._hist, self._clock, self._labels = hist, clock, labels
        self.elapsed: Optional[float] = None

    def __enter__(self) -> "_Timer":
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = max(self._clock() - self._t0, 0.0)
        self._hist.observe(self.elapsed, **self._labels)


class Registry:
    """Named metric families; one instance per run or session."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {m.kind}, not a {cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(Counter, name)

    def gauge(self, name: str) -> Gauge:
        return self._get(Gauge, name)

    def histogram(self, name: str) -> Histogram:
        return self._get(Histogram, name)

    def timer(self, name: str, *,
              clock: Callable[[], float] = time.perf_counter,
              **labels) -> _Timer:
        """``with reg.timer("launch_phase_seconds", phase="run") as t:``
        observes the elapsed seconds into the histogram series and
        leaves them on ``t.elapsed``."""
        return _Timer(self.histogram(name), clock, labels)

    def snapshot(self) -> dict:
        """JSON-safe dump of every series: ``{"kind": "metrics",
        "counters": [...], "gauges": [...], "histograms": [...]}``;
        counter / gauge rows ``{name, labels, value}``, histogram rows
        ``{name, labels, count, sum, mean, min, max, p50, p99}``, empty
        statistics ``None`` and every number present finite."""
        counters, gauges, hists = [], [], []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            for labels in m.labelsets():
                if isinstance(m, Histogram):
                    hists.append({"name": name, "labels": labels,
                                  **m.stats(**labels)})
                elif isinstance(m, Counter):
                    counters.append({"name": name, "labels": labels,
                                     "value": m.value(**labels)})
                else:
                    gauges.append({"name": name, "labels": labels,
                                   "value": m.value(**labels)})
        return {"kind": "metrics", "counters": counters, "gauges": gauges,
                "histograms": hists}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
