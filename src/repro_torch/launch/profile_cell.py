"""Device-time profile of one step, and of a cell (port of
``repro/launch/profile_cell.py``).

:func:`profile_step` runs ``fn(*args)`` once under ``torch.profiler``
(the card's activity only) and reports the device milliseconds, the
device's idle share against the step's unprofiled wall time, the kernel
launches, the device-to-device copies, the top kernels, and each named
kernel's milliseconds, share and launches.  The profiler's CUPTI hooks
are detached when each session ends (``TEARDOWN_CUPTI``): left attached
they slow every later host-bound step of the process (a 4-slot decode
step 176-201 ms before one profiling session, 243-283 ms after it;
``scripts/profiler_teardown_probe.py``, H100 80GB HBM3 at 700 W).

The CLI profiles a cell (``launch/cell.py``): one warm step, one timed
step, one profiled step, then the op count of one step
(``launch/op_analysis.py``) and its roofline row with ``mfu``
(``launch/roofline.py``).  JAX's profile attributes a compiled module's
bytes; on the card the profiler measures.

  python -m repro_torch.launch.profile_cell --arch qwen3-14b \\
      --shape train_4k --layers 4 --global-batch 4
  python -m repro_torch.launch.profile_cell --arch qwen3-14b \\
      --shape decode_32k --layers 4 --global-batch 8 --cache-len 1024 \\
      --dump /tmp/trace.json
  python -m repro_torch.launch.profile_cell --arch qwen3-14b \\
      --shape train_4k --smoke --seq-len 16 --global-batch 4 --device cpu

On the CPU (``--device cpu``) there is no device profile: the step's
wall time, the op count and the roofline row are printed.
"""
from __future__ import annotations

import os

os.environ.setdefault("TEARDOWN_CUPTI", "1")

import argparse  # noqa: E402
import time  # noqa: E402
from typing import Dict, Optional  # noqa: E402

import torch  # noqa: E402


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def profile_step(fn, args=(), *, wall_s: float,
                 kernels: Optional[Dict[str, str]] = None, top: int = 12,
                 dump: Optional[str] = None):
    """(``fn(*args)``, its profile): one call under ``torch.profiler``.
    ``wall_s`` is an unprofiled call's wall time (the idle share's
    denominator); ``kernels`` maps a label to a substring of kernel
    names, each reported as ``<label>_ms``, ``<label>_share`` and
    ``<label>_launches``; ``dump`` writes the Chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # the card's activity only: host operators add ~5 events a launch,
    # and reducing them took ~50 s of a 90k-launch training round
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn(*args)
        torch.cuda.synchronize()
    if dump:
        prof.export_chrome_trace(dump)
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if dev_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    copies = [e for e in events if "Memcpy DtoD" in e.key]
    rec = {"device_ms": dev_ms, "idle_share": 1 - dev_ms / (1e3 * wall_s),
           "kernel_launches": sum(e.count for e in events),
           "memcpy_dtod_ms": sum(e.self_device_time_total
                                 for e in copies) / 1e3,
           "memcpy_dtod_calls": sum(e.count for e in copies)}
    for label, key in (kernels or {}).items():
        mine = [e for e in events if key in e.key]
        rec[f"{label}_ms"] = sum(e.self_device_time_total
                                 for e in mine) / 1e3
        rec[f"{label}_share"] = rec[f"{label}_ms"] / dev_ms
        rec[f"{label}_launches"] = sum(e.count for e in mine)
    best = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    rec["by_kernel"] = [{"name": e.key[:80],
                         "ms": e.self_device_time_total / 1e3,
                         "calls": e.count} for e in best]
    return out, rec


#: the hand-written kernels' names, for a cell's profile
KERNELS = {"flash_fwd": "flash_attention_bf16_kernel",
           "flash_bwd": "flash_bwd_", "paged": "paged_attention",
           "wkv6": "wkv6", "mamba_scan": "mamba_scan"}


def main(argv=None):
    from repro_torch import configs
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.cell import build_cell
    from repro_torch.launch.op_analysis import count
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(configs.SHAPES))
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--page-size", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the config's smoke spec in fp32 (CPU tests)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="with --smoke: the sequence length")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=18)
    ap.add_argument("--dump", type=str, default=None,
                    help="write the profiled step's Chrome trace here")
    args = ap.parse_args(argv)

    def build():
        return build_cell(args.arch, args.shape, layers=args.layers,
                          global_batch=args.global_batch,
                          cache_len=args.cache_len, device=args.device,
                          page_size=args.page_size, smoke=args.smoke,
                          seq_len=args.seq_len)
    cell = build()
    cell.run()                                    # warm: builds kernels
    _sync(cell.device)
    t0 = time.perf_counter()
    cell.run()
    _sync(cell.device)
    wall_s = time.perf_counter() - t0
    print(f"step: {wall_s * 1e3:.2f} ms wall")
    if cell.device.type == "cuda":
        _, rec = profile_step(cell.run, wall_s=wall_s, kernels=KERNELS,
                              top=args.top, dump=args.dump)
        print(f"device {rec['device_ms']:.2f} ms, idle share "
              f"{rec['idle_share']:.3f}, {rec['kernel_launches']} launches, "
              f"D2D copies {rec['memcpy_dtod_ms']:.2f} ms")
        print(f"\n== top device kernels (of {rec['device_ms']:.2f} ms) ==")
        for k in rec["by_kernel"]:
            share = 100 * k["ms"] / rec["device_ms"]
            print(f"  {k['ms']:10.3f} ms {share:5.1f}%  x{k['calls']:<6d} "
                  f"{k['name']}")
        if args.dump:
            print(f"wrote {args.dump}")
    else:
        print("device profile: not measured (no card)")
    # the op count of one step of a fresh cell, so the count starts from
    # the state the timed step started from
    cost = count(build().run)
    print(f"\nop count: flops={cost.flops:.3e} hbm={cost.hbm_bytes:.3e}B "
          f"(kernels {cost.kernel_flops:.3e} / {cost.kernel_bytes:.3e}B, "
          f"calls {cost.kernel_calls})")
    for title, table, total in (("FLOP", cost.flops_by_sig, cost.flops),
                                ("byte", cost.bytes_by_sig,
                                 cost.hbm_bytes)):
        print(f"\n== top {title} signatures (of {total:.3e}) ==")
        for sig, v in cost.top(table, args.top):
            print(f"  {v:12.3e}  {100 * v / max(total, 1):5.1f}%  {sig}")
    shape = configs.SHAPES[args.shape]
    run_shape = configs.Shape(shape.name, shape.kind,
                              cell.seq_len if cell.kind in ("train",
                                                            "prefill")
                              else shape.seq_len, cell.global_batch)
    r = RL.from_counts(
        cost, arch=args.arch, shape=args.shape, cards="1",
        plan=f"pp{cell.plan.pp}xtp1", dtype=str(cell.dtype).split(".")[-1],
        model_flops_per_device=RL.model_flops_per_device(cell.spec,
                                                         run_shape, 1),
        step_seconds_measured=wall_s)
    print("\n" + RL.fmt_row(r))


if __name__ == "__main__":
    main()
