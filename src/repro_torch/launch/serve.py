"""One-shot pipelined serving (port of ``repro/launch/serve.py``): prefill
a batch of random prompts, then decode ``--tokens`` steps.

Runs on the card by default (``--device cpu`` runs the plain PyTorch
versions of the kernels).  ``--smoke`` serves the architecture's small
smoke spec in fp32; otherwise the full spec in bf16, every stage of the
plan on one device.

``--prefill`` is also the prompt length the session is sized for
(``prefill_len``: it sets the MoE expert capacity).

  python -m repro_torch.launch.serve --arch qwen3-14b --page-size 16
  python -m repro_torch.launch.serve --arch qwen3-14b --smoke --device cpu
  python -m repro_torch.launch.serve --arch jamba-v0.1-52b --smoke \
      --device cpu --page-size 16
  python -m repro_torch.launch.serve --arch qwen3-14b --smoke \
      --device cpu --page-size 16 --weight-dtype int8 --kv-dtype int8
  python -m repro_torch.launch.serve --arch qwen3-14b --smoke \
      --device cpu --page-size 16 --trace-out /tmp/t.json \
      --metrics-out /tmp/m.json

``--trace-out`` / ``--metrics-out`` write the session's Chrome trace (one
track per stage) and metrics snapshot (``repro_torch.obs``); the run
then prints the decode rounds' ``reconcile`` line.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.obs import Observability, reconcile
from repro_torch.serving.engine import build_serving


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", type=str, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prefill", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV page size in tokens (0 = dense; must "
                         "divide --cache-len)")
    ap.add_argument("--weight-dtype", type=str, default=None,
                    choices=[None, "fp32", "bf16", "int8", "fp8"],
                    help="weight storage dtype: int8/fp8 store matmul "
                         "weights quantized with per-output-channel "
                         "scales, dequantized on the fly")
    ap.add_argument("--kv-dtype", type=str, default=None,
                    choices=[None, "fp32", "bf16", "int8"],
                    help="KV-cache storage dtype; int8 needs --page-size "
                         "> 0 (per-page scales live in the page pools)")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the prompts")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="write a Chrome trace-event JSON of every "
                         "prefill and decode round")
    ap.add_argument("--metrics-out", type=str, default=None,
                    help="write the metrics-registry snapshot JSON")
    args = ap.parse_args(argv)
    obs = None
    if args.trace_out or args.metrics_out:
        obs = Observability(trace=bool(args.trace_out))

    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.smoke:
        spec, plan, dtype = cfg.smoke_spec(), cfg.SMOKE_PLAN, torch.float32
    else:
        spec, plan, dtype = cfg.full_spec(), cfg.PLAN, torch.bfloat16
    plan = plan.with_(tp=1)
    session = build_serving(spec, plan, cache_len=args.cache_len,
                            global_batch=args.batch, compute_dtype=dtype,
                            page_size=args.page_size,
                            prefill_len=args.prefill,
                            weight_dtype=args.weight_dtype,
                            kv_dtype=args.kv_dtype, device=device,
                            obs=obs)
    print(f"serve schedule: {session.sched.name} (S={session.sched.n_stages} "
          f"R={session.n_slots}, {session.sched.n_ticks} ticks/pass) on "
          f"{device}")
    if session.paged:
        print(f"paged KV: page_size={session.paged['page_size']} "
              f"max_pages/slot={session.paged['max_pages']} "
              f"pool_pages={session.paged['pool_pages']}")
    if args.weight_dtype or args.kv_dtype:
        print(f"storage dtypes: weights={args.weight_dtype or 'compute'} "
              f"kv={args.kv_dtype or 'compute'}")
    session.start(args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, spec.vocab, (session.n_slots, session.rows,
                                           args.prefill)).astype(np.int32)
    t0 = time.perf_counter()
    nxt = session.prefill({"tokens": prompts})
    _sync(device)
    print(f"prefill[{args.prefill}] batch={args.batch}: "
          f"{time.perf_counter() - t0:.3f}s first tokens "
          f"{nxt[:8].tolist()}")
    outs = []
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        nxt = session.decode(nxt)
        outs.append(nxt)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"decoded {args.tokens} steps x {args.batch} seqs in {dt:.3f}s "
          f"({args.tokens * args.batch / max(dt, 1e-9):.1f} tok/s)")
    print("sample:", torch.stack(outs)[:, 0].tolist())
    if obs is not None:
        print(" ", reconcile(session.sched, trace=obs.trace,
                             registry=obs.registry, kind="decode"))
        obs.save(trace_out=args.trace_out, metrics_out=args.metrics_out)
        for what, path in (("pipeline trace", args.trace_out),
                           ("metrics snapshot", args.metrics_out)):
            if path:
                print(f"wrote {what} to {path}")


if __name__ == "__main__":
    main()
