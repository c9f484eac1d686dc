"""Layer profiler (paper §3.2, Figure 7; port of
``repro/core/profiler.py``).

The paper profiles 1000 minibatches on one GPU to estimate, per layer l:
  T_l  — fwd+bwd compute time,
  a_l  — activation bytes out of the layer (== bwd gradient bytes in),
  w_l  — parameter count.

Two modes:
  * analytic  — FLOP/byte counts from the layer spec divided by the
    device's peak × an efficiency factor;
  * measured  — wall-clock timing of layer callables on the device they
    run on (the card: the clock is read after ``torch.cuda.synchronize``).

The partitioner (core/partitioner.py) consumes the same LayerProfile
either way.  The default device is :data:`H100_SXM`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import spec as spec_lib


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    flops_peak: float          # bf16 FLOP/s per device
    hbm_bw: float              # bytes/s
    link_bw: float             # bytes/s per device-to-device link
    mfu: float = 0.5           # sustained fraction of peak for dense matmul
    net_bw: Optional[float] = None  # data-parallel sync bandwidth (defaults link)
    param_bytes: float = 4.0   # fp32 on the paper's GPU clusters
    ps_factor: float = 4.0     # paper §3.2: PS traffic = 4(m−1)|w|/m;
    #                            ring all-reduce = 2(m−1)|w|/m
    hbm_bytes: float = 16e9    # device memory budget; the planner rejects
    #                            plans whose MemoryModel exceeds it

    @property
    def sync_bw(self) -> float:
        return self.net_bw or self.link_bw


#: activation element size assumed by the analytic memory/comm models
ACT_BYTES = 2.0   # bf16

class H100(Hardware):
    """An H100's :class:`Hardware`, with the rates a kernel's bound needs
    beside the dense bf16 peak (``kernels/cost.py``, the roofline).  They
    are class attributes, not fields: the planner's fields stay JAX's."""

    #: dense fp32 on the CUDA cores (data sheet)
    flops_peak_f32 = 67e12
    #: SFU exps a second: 16 ex2 results per clock per SM (CUDA C++
    #: Programming Guide, arithmetic instruction throughput, compute
    #: capability 9.0) x 132 SMs x the 1.98 GHz boost clock
    exp_rate = 16 * 132 * 1.98e9

    def peak(self, dtype: str) -> float:
        """The dense peak for operands of ``dtype`` ("bfloat16" or
        "float32")."""
        return {"bfloat16": self.flops_peak,
                "float32": self.flops_peak_f32}[dtype]


#: NVIDIA H100 SXM data sheet: dense bf16 peak (989 TFLOP/s; fp32 67),
#: HBM3 rate, NVLink 4 (900 GB/s in all, 450 GB/s each way), 80 GB; bf16
#: weights synced by a ring all-reduce
H100_SXM = H100("h100-sxm", flops_peak=989e12, hbm_bw=3.35e12,
                link_bw=450e9, param_bytes=2.0, ps_factor=2.0,
                hbm_bytes=80e9)


def _host_chain(nic_bw: float, host_bw: float = 3e9) -> float:
    """Paper §3.2: all comm is GPU→CPU→NIC→CPU→GPU; the host copy
    (~3 GB/s pinned-memory memcpy) chains with the NIC."""
    return 1.0 / (1.0 / nic_bw + 1.0 / host_bw)


# Paper clusters (Table-1 reproduction).  Cluster-A: Titan X (Maxwell,
# 6.7 TFLOP/s fp32) with the 25 GbE NIC shared by the machine's workers
# (§2.1 footnote: a machine may run multiple GPU workers) ⇒ ~6.25 Gbps
# per worker; Cluster-B: AWS p3.2xlarge = ONE V100 per 10 Gbps NIC.
# ps_factor=2: each worker sends its gradient shards and receives fresh
# params (2(m−1)|w|/m on the wire).
CLUSTER_A = Hardware("titanx-6.25gbe", flops_peak=6.7e12, hbm_bw=336e9,
                     link_bw=25e9 / 8, mfu=0.35,
                     net_bw=_host_chain(25e9 / 8 / 4), ps_factor=2.0,
                     hbm_bytes=12e9)
CLUSTER_B = Hardware("v100-10gbe", flops_peak=15.7e12, hbm_bw=900e9,
                     link_bw=10e9 / 8, mfu=0.45,
                     net_bw=_host_chain(10e9 / 8), ps_factor=2.0,
                     hbm_bytes=16e9)


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    name: str
    t_fwd: float               # seconds
    t_bwd: float
    a_bytes: float             # activation bytes out (per minibatch)
    w_params: float            # parameter count

    @property
    def t_total(self) -> float:
        return self.t_fwd + self.t_bwd


# --------------------------------------------------------------------------
# Analytic per-layer FLOPs for the LM layer zoo
# --------------------------------------------------------------------------

def block_flops_fwd(spec: spec_lib.ModelSpec, blk: spec_lib.BlockSpec,
                    tokens: int, kv_len: Optional[int] = None) -> float:
    """Forward FLOPs for one block over ``tokens`` query tokens."""
    d = spec.d_model
    f = 0.0
    if blk.mixer == "attn":
        h, kv, dh = spec.n_heads, spec.n_kv, spec.d_head
        f += 2 * tokens * d * (h + 2 * kv) * dh      # qkv
        f += 2 * tokens * h * dh * d                 # out proj
        span = kv_len if kv_len is not None else tokens
        if blk.window > 0:
            span = min(span, blk.window)
        f += 2 * 2 * tokens * span * h * dh          # scores + weighted sum
        if blk.cross_attn:
            src = spec.encoder.source_len if spec.encoder else tokens
            f += 2 * tokens * d * (h + 2 * kv) * dh + 2 * tokens * h * dh * d
            f += 2 * 2 * tokens * src * h * dh
    elif blk.mixer == "mamba":
        ms = spec.mamba
        ci = ms.expand * d
        dt_rank = ms.dt_rank or -(-d // 16)
        f += 2 * tokens * d * 2 * ci                 # in projections
        f += 2 * tokens * ci * ms.d_conv             # conv
        f += 2 * tokens * ci * (dt_rank + 2 * ms.d_state)
        f += 2 * tokens * dt_rank * ci
        f += 6 * tokens * ci * ms.d_state            # scan update + readout
        f += 2 * tokens * ci * d                     # out proj
    elif blk.mixer == "rwkv":
        rs = spec.rwkv
        f += 2 * tokens * d * d * 5                  # r,k,v,g,o
        f += 2 * tokens * d * (rs.decay_lora * 2 + rs.tmix_lora * 10)
        f += 4 * tokens * d * rs.head_dim            # wkv state update+read
    if blk.ffn == "dense":
        mats = 3 if spec.act == "silu" else 2
        f += 2 * tokens * d * spec.d_ff * mats
    elif blk.ffn == "moe":
        m = spec.moe
        f += 2 * tokens * d * m.n_experts            # router
        f += 2 * tokens * m.top_k * d * m.d_expert * 3
        f += 2 * tokens * m.n_shared * d * m.d_shared * 3
    elif blk.ffn == "rwkv_cmix":
        f += 2 * tokens * d * spec.d_ff * 2 + 2 * tokens * d * d
    return f


def head_flops(spec: spec_lib.ModelSpec, tokens: int) -> float:
    return 2 * tokens * spec.d_model * spec.vocab


def model_flops_train(spec: spec_lib.ModelSpec, tokens: int) -> float:
    """MODEL_FLOPS: 6·N_active·D convention (fwd 2ND + bwd 4ND)."""
    return 6 * spec.active_param_count() * tokens


def profile_analytic(spec: spec_lib.ModelSpec, hw: Hardware = H100_SXM, *,
                     minibatch_tokens: int, bwd_factor: float = 2.0,
                     kv_len: Optional[int] = None) -> List[LayerProfile]:
    """Per-layer profiles for the partitioner (embed/head folded into ends).

    ``kv_len`` sets the attention span independently of the query token
    count (one query token per row against a ``kv_len``-deep cache);
    ``None`` keeps the self-attention span (= ``minibatch_tokens``).
    """
    out: List[LayerProfile] = []
    d = spec.d_model
    act_bytes = minibatch_tokens * d * ACT_BYTES
    out.append(LayerProfile("embed", 0.0, 0.0, act_bytes, spec.vocab * d))
    for i, blk in enumerate(spec.blocks):
        f = block_flops_fwd(spec, blk, minibatch_tokens, kv_len)
        t_f = f / (hw.flops_peak * hw.mfu)
        out.append(LayerProfile(
            f"block_{i}", t_f, bwd_factor * t_f, act_bytes,
            spec_lib._block_params(spec, blk)))
    hf = head_flops(spec, minibatch_tokens)
    t_h = hf / (hw.flops_peak * hw.mfu)
    out.append(LayerProfile("head", t_h, bwd_factor * t_h,
                            minibatch_tokens * spec.vocab * 4,
                            spec.vocab * d))
    return out


# --------------------------------------------------------------------------
# Measured mode — times a list of callables, paper-style repeated runs
# --------------------------------------------------------------------------

def _synchronize() -> None:
    """Wait for the card's queued work: without it the host clock times
    the launches, not the kernels."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profile_measured(layer_fns: Sequence[Callable[[], None]],
                     names: Sequence[str],
                     a_bytes: Sequence[float],
                     w_params: Sequence[float],
                     *, warmup: int = 2, iters: int = 10,
                     bwd_factor: float = 2.0) -> List[LayerProfile]:
    """Wall-clock profiling of forward callables (the 1000-minibatch run,
    scaled down).  bwd is estimated as bwd_factor × fwd, matching the
    paper's observation that backward ≈ 2× forward.  The clock is read
    only after the card has finished the work queued before it."""
    out = []
    for fn, name, ab, wp in zip(layer_fns, names, a_bytes, w_params):
        for _ in range(warmup):
            fn()
        _synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _synchronize()
        t = (time.perf_counter() - t0) / iters
        out.append(LayerProfile(name, t, bwd_factor * t, ab, wp))
    return out


# --------------------------------------------------------------------------
# Communication-time estimates (paper §3.2)
# --------------------------------------------------------------------------

def comm_time_activations(a_bytes: float, hw: Hardware) -> float:
    """C_l: activation transfer layer l -> l+1."""
    return a_bytes / hw.sync_bw


def comm_time_weight_sync(w_params: float, m: int, hw: Hardware) -> float:
    """W_l^m: per-worker sync bytes for |w_l| = w_params parameters.

    Paper §3.2 (parameter server, fp32): 4(m−1)·|w_l|_bytes/m; a bf16
    ring all-reduce: 2(m−1)·|w_l|_bytes/m.  Both via
    hw.ps_factor / param_bytes.
    """
    if m <= 1:
        return 0.0
    return (hw.ps_factor * (m - 1) * w_params * hw.param_bytes
            / m / hw.sync_bw)


def comm_time_tp_allreduce(a_bytes: float, tp: int, hw: Hardware) -> float:
    """Per-layer tensor-parallel all-reduce time (one direction).

    Megatron-style row/column sharding all-reduces the layer's activation
    once per block per pass: ring cost 2(tp−1)·a_bytes/tp over the
    device link.  0 at tp=1 — this is what makes tensor parallelism
    non-free in the planner.
    """
    if tp <= 1:
        return 0.0
    return 2.0 * (tp - 1) * a_bytes / tp / hw.link_bw


# --------------------------------------------------------------------------
# Measured-profile calibration (straggler rebalancing)
# --------------------------------------------------------------------------

def profile_stage_spans(n_profiles: int, n_stages: int) -> List[range]:
    """Profile-index span of each stage under the uniform stack.

    Profiles are [embed, block_0..block_{L-1}, head]; embed rides with
    stage 0 and head with the last stage.  With virtual stages, call with
    ``n_stages = S·v`` (chunk spans; chunk c belongs to stage c % S).
    """
    n_layers = n_profiles - 2
    assert n_layers % n_stages == 0, (n_layers, n_stages)
    lps = n_layers // n_stages
    spans = []
    for s in range(n_stages):
        lo = 1 + s * lps
        hi = 1 + (s + 1) * lps
        if s == 0:
            lo = 0                      # embed
        if s == n_stages - 1:
            hi = n_profiles             # head
        spans.append(range(lo, hi))
    return spans


def scale_profiles_to_measurements(profiles: Sequence[LayerProfile],
                                   measured_stage_seconds: Sequence[float],
                                   *, n_stages: int, virtual_stages: int = 1
                                   ) -> List[LayerProfile]:
    """Fold measured per-stage times back into the analytic profile.

    Each layer's t_fwd/t_bwd is scaled by the measured/predicted ratio of
    the stage that currently runs it (chunk c of the uniform S·v split
    belongs to physical stage c % S).  Ratios are normalized by their
    median so only the *relative* skew transfers — absolute wall-clock
    from a different machine class must not swamp the analytic comm
    terms.
    """
    times = np.asarray(measured_stage_seconds, float)
    assert len(times) == n_stages, (len(times), n_stages)
    n_chunks = n_stages * virtual_stages
    chunk_spans = profile_stage_spans(len(profiles), n_chunks)
    predicted = np.zeros(n_stages)
    layer_stage = np.zeros(len(profiles), np.int64)
    for c, span in enumerate(chunk_spans):
        s = c % n_stages
        predicted[s] += sum(profiles[i].t_total for i in span)
        for i in span:
            layer_stage[i] = s
    assert (predicted > 0).all(), "degenerate profile: zero-time stage"
    ratio = times / predicted
    med = float(np.median(ratio))
    assert med > 0, "measured stage times must be positive"
    ratio = ratio / med
    out = []
    for i, p in enumerate(profiles):
        r = float(ratio[layer_stage[i]])
        out.append(dataclasses.replace(p, t_fwd=p.t_fwd * r,
                                       t_bwd=p.t_bwd * r))
    return out
