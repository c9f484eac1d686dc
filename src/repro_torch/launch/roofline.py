"""Roofline terms of one step from its op counts (port of
``repro/launch/roofline.py``), on an H100:

    compute term    = FLOPs / peak (bf16 989 TFLOP/s; fp32 67 for f32 cells)
    memory term     = bytes / HBM rate (3.35 TB/s)
    collective term = collective bytes / link rate (NVLink, 450 GB/s a way)

The counts come from ``launch/op_analysis.py`` (:func:`from_counts`);
the rates from :data:`~repro_torch.core.profiler.H100_SXM`.  Given a
measured step time, :func:`from_counts` also fills
``step_seconds_measured`` and ``mfu`` = model FLOPs / (measured seconds
x peak), the measured counterpart of ``roofline_fraction``.

JAX's ``kernel_adjusted_bytes`` is not ported: it subtracts the score
and state tiles that only XLA's jnp twins of the Pallas kernels
materialize, and the port counts each kernel by its own bytes
(``kernels/cost.py``), so no such tiles enter the count.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

from repro_torch.core.profiler import H100_SXM


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    cards: str                    # cards the model FLOPs split over
    plan: str
    dtype: str                    # the compute term's peak
    # per-card totals for ONE step
    flops: float
    hbm_bytes: float
    coll_operand_bytes: float
    per_collective: Dict[str, float]
    kernel_calls: Dict[str, int]
    # terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    # usefulness
    model_flops: float            # 6·N_active·D (train) per card-step
    useful_ratio: float           # model_flops / flops
    peak_flops: float
    step_seconds_measured: Optional[float] = None
    mfu: Optional[float] = None   # model_flops / (measured s x peak)

    @property
    def step_seconds(self) -> float:
        """Bound = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful compute time over the bound."""
        if self.step_seconds <= 0:
            return 0.0
        return self.model_flops / self.peak_flops / self.step_seconds

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["step_seconds"] = self.step_seconds
        d["roofline_fraction"] = self.roofline_fraction
        return d


def from_counts(cost, *, arch: str, shape: str, cards: str, plan: str,
                model_flops_per_device: float, dtype: str = "bfloat16",
                hw=H100_SXM, step_seconds_measured: Optional[float] = None
                ) -> Roofline:
    """The roofline of one card's step from its
    :class:`~repro_torch.launch.op_analysis.OpCost` (already a card's
    share)."""
    peak = hw.peak(dtype)
    compute_s = cost.flops / peak
    memory_s = cost.hbm_bytes / hw.hbm_bw
    collective_s = cost.coll_operand_bytes / hw.link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    mfu = None
    if step_seconds_measured:
        mfu = model_flops_per_device / (step_seconds_measured * peak)
    return Roofline(
        arch=arch, shape=shape, cards=cards, plan=plan, dtype=dtype,
        flops=cost.flops, hbm_bytes=cost.hbm_bytes,
        coll_operand_bytes=cost.coll_operand_bytes,
        per_collective=dict(cost.per_collective),
        kernel_calls=dict(cost.kernel_calls), compute_s=compute_s,
        memory_s=memory_s, collective_s=collective_s,
        dominant=max(terms, key=terms.get),
        model_flops=model_flops_per_device,
        useful_ratio=(model_flops_per_device / cost.flops if cost.flops
                      else 0.0),
        peak_flops=peak, step_seconds_measured=step_seconds_measured,
        mfu=mfu)


def model_flops_per_device(spec, shape, n_chips: int) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (inference),
    per chip per step."""
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        factor = 6.0
    elif shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        factor = 2.0
    else:  # decode: one new token per sequence
        tokens = shape.global_batch
        factor = 2.0
    return factor * spec.active_param_count() * tokens / n_chips


def dump(r: Roofline, path: str):
    with open(path, "w") as f:
        json.dump(r.to_json(), f, indent=2)


def fmt_row(r: Roofline) -> str:
    mfu = "" if r.mfu is None else (
        f" measured={r.step_seconds_measured * 1e3:9.2f}ms mfu={r.mfu:5.3f}")
    return (f"{r.arch:18s} {r.shape:12s} {r.cards:9s} "
            f"C={r.compute_s * 1e3:9.2f}ms M={r.memory_s * 1e3:9.2f}ms "
            f"X={r.collective_s * 1e3:9.2f}ms dom={r.dominant:10s} "
            f"useful={r.useful_ratio:5.2f} frac={r.roofline_fraction:5.3f}"
            + mfu)
