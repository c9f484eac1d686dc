#!/usr/bin/env python3
"""Where a decode step of the PyTorch port goes, on one NVIDIA card.

  python3 scripts/torch_decode_profile.py

Serves qwen3-14b at full width and depth in bf16 (the chip_smoke.py
phase 3 configuration: serve_1f pp = 2, R = 4 slots × 2 rows, prefill
512, page 16, random seeded weights), warms up two decode steps, then
runs STEPS decode steps timed on the host clock, then as many under
``torch.profiler``, and prints: wall time per step (unprofiled), device
kernel time per step and the device's idle share, device time by kernel
name, and two byte bounds over 3.35 TB/s: the bound of the schedule as
run (every stage weight read once per microbatch, R times a step, plus
the head and the live KV pages) and the step's weight-once floor (every
weight byte read once for all rows, plus the head and the KV pages).
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.serving.engine import build_serving  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
STEPS = 3
R_SLOTS = 4


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cfg = configs.get("qwen3-14b")
    spec = cfg.full_spec()
    plan = cfg.PLAN.with_(tp=1, decode_microbatches=R_SLOTS)
    sess = build_serving(spec, plan, cache_len=1024, global_batch=8,
                         compute_dtype=torch.bfloat16, page_size=16).start(0)
    prompts = np.random.default_rng(0).integers(
        0, spec.vocab, (R_SLOTS, 2, 512)).astype(np.int32)
    nxt = sess.prefill({"tokens": prompts})
    for _ in range(2):
        nxt = sess.decode(nxt)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(STEPS):
        nxt = sess.decode(nxt)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            nxt = sess.decode(nxt)
        torch.cuda.synchronize()

    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in events) / STEPS
    weight_bytes = sum(t.numel() * t.element_size() for sp in
                       sess._stage_params for t in _leaves(sp))
    head_bytes = sess.params["head"].numel() * 2
    tokens = -(-(512 + 2 + 2 * STEPS) // 16) * 16  # live pages, per row
    kv_bytes = 2 * spec.n_layers * 8 * tokens * spec.n_kv * spec.d_head * 2
    as_run_ms = (1e3 * (R_SLOTS * weight_bytes + head_bytes + kv_bytes)
                 / HBM_BYTES_PER_S)
    floor_ms = 1e3 * (weight_bytes + head_bytes + kv_bytes) / HBM_BYTES_PER_S
    print(f"card: {torch.cuda.get_device_name(0)}; {spec.n_layers} layers")
    print(f"decode step: wall {1e3 * wall:.2f} ms, device kernels "
          f"{dev_us / 1e3:.2f} ms, device idle share "
          f"{1 - dev_us / 1e3 / (1e3 * wall):.3f}")
    print(f"byte bound of the schedule as run {as_run_ms:.2f} ms "
          f"({R_SLOTS} x {weight_bytes / 1e9:.2f} GB stage weights + head "
          f"{head_bytes / 1e9:.2f} GB + KV {kv_bytes / 1e9:.3f} GB); "
          f"weight-once floor of the step {floor_ms:.2f} ms")
    rows = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    print("device time per step by kernel (ms, calls):")
    for e in rows:
        print(f"  {e.self_device_time_total / 1e3 / STEPS:9.3f} "
              f"{e.count // STEPS:6d}  {e.key[:90]}")
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


if __name__ == "__main__":
    sys.exit(main())
