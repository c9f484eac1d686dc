#!/usr/bin/env python3
"""Does one ``torch.profiler`` session slow the host-bound work after it?

  python3 scripts/profiler_teardown_probe.py --teardown 0
  python3 scripts/profiler_teardown_probe.py --teardown 1

Serves phase 19a's request trace of ``chip_smoke.py`` (qwen3-14b at full
width, bf16, pp 2, through the continuous batcher) twice, profiles one
tiny kernel for a session as ``chip_smoke.kernel_events`` does, and
serves the trace twice more, each time in a fresh session.  ``--teardown``
sets ``TEARDOWN_CUPTI`` before torch loads: 1 detaches the profiler's
CUPTI hooks when its session ends, 0 leaves them attached.  Prints one
JSON line with each run's seconds and mean decode ms by live slots, the
torch and CUDA versions, and the card's name and power limit.  Exits
non-zero without a card.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--teardown", choices=("0", "1"), required=True)
    args = ap.parse_args()
    os.environ["TEARDOWN_CUPTI"] = args.teardown
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profiler_teardown_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import configs
    dev = torch.device("cuda")
    cs.phase_build()
    cfg = configs.get("qwen3-14b")
    plan = cfg.PLAN.with_(tp=1, decode_microbatches=cs.R_SLOTS)
    spec = cfg.full_spec()

    def trace():
        base = cs.batching_session(spec, plan, torch.bfloat16,
                                   dev).start(cs.SEED)
        _, _, watch, secs = cs.serve_trace(base, 1, cs.SEED)
        by_live = {n: float(np.mean([r["ms"] for r in watch.rounds
                                     if r["live"] == n]))
                   for n in sorted({r["live"] for r in watch.rounds})}
        del base
        torch.cuda.empty_cache()
        return {"seconds": secs, "decode_ms_by_live_slots": by_live}

    x = torch.zeros(1024, device=dev)
    runs = {"before 0": trace(), "before 1": trace()}
    cs.kernel_events(lambda: x.add_(1), 10)
    runs["after one profiler session 0"] = trace()
    runs["after one profiler session 1"] = trace()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"TEARDOWN_CUPTI": args.teardown, "runs": runs,
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
