#!/usr/bin/env python3
"""Does NCCL take two ranks on one card?  Two processes, both on
``cuda:0``, join one NCCL process group and sum a tensor.

  python3 scripts/nccl_shared_card_probe.py

Prints one JSON line: ``outcome`` is ``refused`` (a rank raised; its
message follows), ``accepted`` (the sum came out right on both) or
``hung`` (no result within the deadline; the ranks are killed), with the
torch and NCCL versions and the card's name and power limit.  Exits
non-zero only without a card.  ``repro_torch.parallel.dist.init_grid``
refuses NCCL for ranks that share a card before NCCL is asked; this
script asks NCCL itself.
"""
import datetime
import json
import multiprocessing
import queue
import subprocess
import sys
import tempfile
import time

DEADLINE_S = 120


def rank(r, init_file, results):
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", init_method=f"file://{init_file}", rank=r, world_size=2,
            timeout=datetime.timedelta(seconds=DEADLINE_S // 2))
        x = torch.full((4,), float(r + 1), device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        results.put((r, "ok", x.tolist()))
    except Exception as e:                       # the probe's finding
        results.put((r, "error", f"{type(e).__name__}: {e}"[:600]))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("nccl_shared_card_probe: no CUDA device", file=sys.stderr)
        return 2
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="nccl_probe_")
    procs = [ctx.Process(target=rank, args=(r, f"{tmp}/rdv", results))
             for r in range(2)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    got = {}
    while len(got) < 2 and time.monotonic() - t0 < DEADLINE_S:
        try:
            r, status, detail = results.get(timeout=1.0)
            got[r] = (status, detail)
        except queue.Empty:
            if got and all(p.exitcode is not None for p in procs):
                break
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)
    if len(got) < 2 and not any(s == "error" for s, _ in got.values()):
        outcome = "hung"
    elif any(s == "error" for s, _ in got.values()):
        outcome = "refused"
    else:
        outcome = ("accepted" if all(d == [3.0] * 4 for _, d in got.values())
                   else "wrong sum")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({
        "nccl_two_ranks_one_card": outcome,
        "ranks": {str(r): {"status": s, "detail": d}
                  for r, (s, d) in sorted(got.items())},
        "seconds": time.monotonic() - t0, "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nccl": ".".join(map(str, torch.cuda.nccl.version())),
        "card": smi[0] if smi else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
