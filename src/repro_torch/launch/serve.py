"""Pipelined serving (port of ``repro/launch/serve.py``): a one-shot
batch of random prompts (prefill, then ``--tokens`` decode steps or
draft–verify rounds), or a request trace through the continuous batcher
(``--arrivals``).

Runs on the card by default (``--device cpu`` runs the plain PyTorch
versions of the kernels).  ``--smoke`` serves the architecture's small
smoke spec in fp32; otherwise the full spec in bf16 (``--layers N``
keeps its first N layers), every stage of the plan on one device.

``--prefill`` is the prompt width the session is sized for
(``prefill_len``: the batcher's prompt width, and the MoE expert
capacity); a VLM's prompt holds its patch prefix and at least 8 text
tokens.  The frontends' inputs (patches, frames) are drawn beside the
tokens.

  python -m repro_torch.launch.serve --arch qwen3-14b --page-size 16
  python -m repro_torch.launch.serve --arch qwen3-14b --smoke --device cpu
  python -m repro_torch.launch.serve --arch qwen3-14b --smoke \\
      --device cpu --page-size 16 --buckets --arrivals 0,0,2,4
  python -m repro_torch.launch.serve --arch qwen3-14b --smoke \\
      --device cpu --page-size 16 --spec-k 2 --arrivals poisson:0.5:8
  python -m repro_torch.launch.serve --arch qwen3-14b --smoke \\
      --device cpu --schedule serve_interleaved --virtual-stages 2
  python -m repro_torch.launch.serve --arch jamba-v0.1-52b --smoke \\
      --device cpu --page-size 16
  python -m repro_torch.launch.serve --arch qwen3-14b --smoke \\
      --device cpu --page-size 16 --weight-dtype int8 --kv-dtype int8
  python -m repro_torch.launch.serve --arch qwen3-14b --smoke \\
      --device cpu --page-size 16 --trace-out /tmp/t.json \\
      --metrics-out /tmp/m.json
  python -m repro_torch.launch.serve --arch whisper-medium --smoke \\
      --device cpu --page-size 16
  python -m repro_torch.launch.serve --arch llava-next-34b --smoke \\
      --device cpu --page-size 16 --arrivals 0,0,2

``--ckpt DIR`` serves the weights of a converted checkpoint
(``python -m repro_torch.checkpoint.convert``, converted for this
session's ``--pp`` / ``--virtual-stages``) in place of the seeded ones;
``--weight-dtype int8`` / ``fp8`` quantizes them as they are installed:

  python -m repro_torch.checkpoint.convert --src hf_dir --dest ck \
      --config olmoe_1b_7b --smoke --pp 2
  python -m repro_torch.launch.serve --arch olmoe-1b-7b --smoke \
      --device cpu --page-size 16 --ckpt ck

``--trace-out`` / ``--metrics-out`` write the session's Chrome trace (one
track per stage) and metrics snapshot (``repro_torch.obs``); the run
then prints the decode (and verify) rounds' ``reconcile`` lines.

``--data D`` serves the one-shot batch on D data replicas, one process
each under torchrun (or ranks given ``--init-method``, with torchrun's
RANK / WORLD_SIZE): R is fitted to the batch over D replicas (as JAX's
engine fits it over its data axis), each replica serves its block of
every microbatch's rows, split as ``data/pipeline.py::Loader`` splits
them, and rank 0 gathers the tokens and prints them, the tokens of
``--data 1``.  ``--data`` > 1 without a process group is refused, and so
are ``--arrivals`` and ``--spec-k`` on several replicas (each replica's
rounds would run apart).  ``--backend gloo`` lets replicas share one
card:

  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch qwen3-14b --smoke --device cpu --data 2 --batch 4
"""
from __future__ import annotations

import argparse
import os
import time
from collections import Counter

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core.schedule import (SCHEDULES, fit_serving_microbatches,
                                       plan_kwargs_for_schedule)
from repro_torch.obs import Observability, reconcile
from repro_torch.serving.engine import build_serving

_ARRIVALS_HELP = ("accepted --arrivals formats: 't0,t1,...' "
                  "(comma-separated non-negative integer arrival steps, "
                  "one request each) or 'poisson:RATE:N' (N requests, "
                  "exponential inter-arrival at RATE requests/step, "
                  "e.g. 'poisson:0.5:32')")


def parse_arrivals(spec_str: str, seed: int = 0):
    """'t0,t1,...' explicit steps, or 'poisson:RATE:N' (RATE requests a
    step); a malformed spec raises ValueError naming the formats."""
    if spec_str.startswith("poisson:"):
        parts = spec_str.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"malformed arrivals spec {spec_str!r}: poisson traces "
                f"need both a rate and a count; {_ARRIVALS_HELP}")
        try:
            rate, n = float(parts[1]), int(parts[2])
        except ValueError:
            raise ValueError(
                f"malformed arrivals spec {spec_str!r}: RATE must be a "
                f"number and N an integer; {_ARRIVALS_HELP}") from None
        if rate <= 0 or n <= 0:
            raise ValueError(
                f"malformed arrivals spec {spec_str!r}: RATE and N must "
                f"be positive; {_ARRIVALS_HELP}")
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(scale=1.0 / rate, size=n)
        return np.floor(np.cumsum(gaps)).astype(int).tolist()
    try:
        steps = [int(t) for t in spec_str.split(",")]
    except ValueError:
        raise ValueError(
            f"malformed arrivals spec {spec_str!r}: non-numeric arrival "
            f"step; {_ARRIVALS_HELP}") from None
    if any(t < 0 for t in steps):
        raise ValueError(
            f"malformed arrivals spec {spec_str!r}: arrival steps must "
            f"be non-negative; {_ARRIVALS_HELP}")
    return steps


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_checkpoint(session, spec, args):
    """Install a converted checkpoint (``checkpoint/convert.py``) into
    the started session, after checking that it was converted for this
    schedule's chunks and storage order; ``ConvertError`` names the
    ``--pp`` / ``--virtual-stages`` to reconvert with otherwise.  Returns
    the loaded numpy tree and the manifest."""
    from repro_torch.checkpoint.convert import (ConvertError,
                                                load_converted,
                                                read_manifest)
    manifest = read_manifest(args.ckpt, spec)     # refused before reading
    sched = session.sched
    want = (list(int(c) for c in sched.storage_chunk_order())
            if sched.virtual_stages > 1 else list(range(sched.n_chunks)))
    if (manifest["n_chunks"] != sched.n_chunks
            or list(manifest["storage_order"]) != want):
        raise ConvertError(
            f"checkpoint at '{args.ckpt}' was converted for "
            f"pp={manifest['pp']} v={manifest['virtual_stages']} "
            f"(storage order {manifest['storage_order']}); this session "
            f"runs {sched.n_chunks} chunks in order {want} — reconvert "
            f"with --pp {sched.n_stages} --virtual-stages "
            f"{sched.virtual_stages}")
    params, manifest = load_converted(args.ckpt, spec)
    session.load_params(params)
    quantized = session.weight_dtype in ("int8", "fp8")
    print(f"loaded checkpoint {args.ckpt} (family={manifest['family']}, "
          f"{manifest['n_chunks']} chunks"
          f"{f', weights quantized to {session.weight_dtype}' if quantized else ''})")
    return params, manifest


def serve_arrivals(session, spec, args) -> None:
    """Continuous batching over a request trace (``--arrivals``)."""
    from repro_torch.serving.batcher import ContinuousBatchingSession, Request
    arrivals = parse_arrivals(args.arrivals, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    inputs = {k: v.shape[2:] for k, v in session.prefill_specs.items()
              if k != "tokens"}
    trace = [Request(rid=i,
                     prompt=rng.integers(1, spec.vocab, session.text_len)
                     .astype(np.int32),
                     max_new_tokens=args.tokens, arrival=int(t),
                     inputs={k: rng.standard_normal(shape).astype(np.float32)
                             * 0.02 for k, shape in inputs.items()} or None)
             for i, t in enumerate(sorted(arrivals))]
    session.start(args.seed)
    if args.ckpt:
        load_checkpoint(session, spec, args)
    server = ContinuousBatchingSession(session, policy=args.policy)
    t0 = time.perf_counter()
    report = server.run(trace)
    _sync(session.device)
    dt = time.perf_counter() - t0
    s = report.summary()
    print(f"{args.policy} batching: {s['requests']} requests over "
          f"{session.n_slots} slots, {s['steps']} steps "
          f"({s['decode_rounds']} decode + {s['admit_rounds']} admit "
          f"rounds) in {dt:.2f}s")

    def fmt_ms(v):
        return "n/a" if v is None else f"{v * 1e3:.1f} ms"

    print(f"  goodput {s['goodput_tokens_per_s']:.1f} tok/s; per-token "
          f"latency p50 {fmt_ms(s['p50_per_token_latency_s'])} / "
          f"p99 {fmt_ms(s['p99_per_token_latency_s'])}; mean TTFT "
          f"{fmt_ms(s['mean_ttft_s'])}")
    if s.get("spec_rounds"):
        print(f"  speculative: {s['spec_rounds']} verify rounds, "
              f"acceptance {s['acceptance_rate']:.2f}, "
              f"{s['accepted_per_round']:.2f} accepted tok/lane-round "
              "(goodput counts accepted tokens only)")
    if session.buckets and session._bucket_log:
        hist = Counter(session._bucket_log)
        print("  bucket rounds: " + ", ".join(
            f"R_b={b} x{hist[b]}" for b in sorted(hist)))
    for r in report.requests[:8]:
        print(f"  request {r.rid}: arrival step {r.arrival}, admitted "
              f"{r.step_admitted}, done {r.step_done}, "
              f"tokens {r.tokens[:6]}{'...' if len(r.tokens) > 6 else ''}")


def prefill_batch(session, seed: int, replica: int = 0, replicas: int = 1):
    """A prefill batch of every key of ``session.prefill_specs``, drawn
    in their order from one ``np.random.default_rng(seed)``: tokens in
    [0, vocab), a frontend's floats 0.02 x a standard normal (JAX
    ``launch/serve.py:295-300``).  On ``replicas`` data replicas the
    batch of all of them is drawn and replica ``replica`` keeps its
    block of each microbatch's rows."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in session.prefill_specs.items():
        shape = (v.shape[0], v.shape[1] * replicas) + tuple(v.shape[2:])
        a = (rng.integers(0, session.spec.vocab, shape).astype(np.int32)
             if v.dtype == torch.int32 else
             rng.standard_normal(shape).astype(np.float32) * 0.02)
        rows = v.shape[1]
        out[k] = np.ascontiguousarray(a[:, replica * rows:(replica + 1)
                                        * rows])
    return out


def serve_batch(session, spec, args, replica: int = 0, replicas: int = 1,
                gather=None):
    """One-shot batch: prefill, then decode steps or draft–verify
    rounds.  Returns the decode path's tokens, (1 + steps, batch) of
    every row (from ``gather`` over data replicas: rank 0's, None on the
    others)."""
    device = session.device
    session.start(args.seed)
    if args.ckpt:
        load_checkpoint(session, spec, args)
    t0 = time.perf_counter()
    nxt = session.prefill(prefill_batch(session, args.seed, replica,
                                        replicas))
    _sync(device)
    t_prefill = time.perf_counter() - t0
    if gather is None:
        print(f"prefill[{args.prefill}] batch={args.batch}: "
              f"{t_prefill:.3f}s first tokens {nxt[:8].tolist()}")
    if session.speculative:
        # draft–verify rounds: each commits 1..spec_k+1 tokens a slot
        last = nxt.cpu().numpy().astype(np.int32)
        emitted, rounds, acc_total, sample = 0, 0, 0, []
        t0 = time.perf_counter()
        while emitted < args.tokens * args.batch:
            drafts = session.draft(last)
            toks = np.concatenate([last[:, None], drafts], axis=1)
            scores, acc = session.verify(toks)
            rounds += 1
            acc_total += int(acc.sum())
            emitted += int((acc + 1).sum()) * session.rows
            sample.append(int(scores[0, 0]))
            last = scores[np.arange(scores.shape[0]),
                          acc.repeat(session.rows)].astype(np.int32)
        dt = time.perf_counter() - t0
        print(f"spec-decoded {emitted} tokens in {rounds} verify rounds "
              f"(k={session.sched.spec_k}, mean accepted/round "
              f"{acc_total / max(rounds * session.n_slots, 1):.2f}) in "
              f"{dt:.3f}s ({emitted / max(dt, 1e-9):.1f} tok/s)")
        print("sample (first emitted/round):", sample[:args.tokens])
        return
    outs = [nxt]
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        nxt = session.decode(nxt)
        outs.append(nxt)
    _sync(device)
    dt = time.perf_counter() - t0
    toks = torch.stack(outs).cpu().numpy()
    if gather is not None:
        toks = gather(toks)
        if toks is None:
            return None
        print(f"prefill[{args.prefill}] batch={args.batch} on {replicas} "
              f"data replicas: {t_prefill:.3f}s first tokens "
              f"{toks[0, :8].tolist()}")
    print(f"decoded {args.tokens} steps x {args.batch} seqs in {dt:.3f}s "
          f"({args.tokens * args.batch / max(dt, 1e-9):.1f} tok/s)")
    print("sample:", toks[1:, 0].tolist())
    return toks


def main(argv=None):
    serve_names = sorted(n for n, c in SCHEDULES.items() if c.is_serving)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", type=str, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the full spec's first N layers (0 = all)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prefill", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV page size in tokens (0 = dense; must "
                         "divide --cache-len)")
    ap.add_argument("--buckets", action="store_true",
                    help="liveness-aware bucketed execution: each round "
                         "walks the smallest compacted table variant "
                         "covering its slots")
    ap.add_argument("--ckpt", type=str, default=None,
                    help="converted checkpoint directory (see "
                         "repro_torch.checkpoint.convert: HF safetensors -> "
                         "per-chunk files in this plan's storage order)")
    ap.add_argument("--weight-dtype", type=str, default=None,
                    choices=[None, "fp32", "bf16", "int8", "fp8"],
                    help="weight storage dtype: int8/fp8 store matmul "
                         "weights quantized with per-output-channel "
                         "scales, dequantized on the fly")
    ap.add_argument("--kv-dtype", type=str, default=None,
                    choices=[None, "fp32", "bf16", "int8"],
                    help="KV-cache storage dtype; int8 needs --page-size "
                         "> 0 (per-page scales live in the page pools)")
    ap.add_argument("--schedule", type=str, default=None,
                    choices=[None, *serve_names])
    ap.add_argument("--virtual-stages", type=int, default=None)
    ap.add_argument("--spec-k", type=int, default=None,
                    help="speculative decode: draft depth (routes onto "
                         "the serve_spec_* schedules; each round drafts "
                         "k tokens and verifies k+1 positions in one "
                         "pipelined pass)")
    ap.add_argument("--arrivals", type=str, default=None,
                    help="continuous batching: 't0,t1,...' arrival steps "
                         "(one request each) or 'poisson:RATE:N'")
    ap.add_argument("--policy", type=str, default="continuous",
                    choices=["continuous", "synchronized"],
                    help="slot scheduler policy under --arrivals")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--data", type=int, default=1,
                    help="data replicas of the one-shot batch, one process "
                         "each (torchrun)")
    ap.add_argument("--backend", type=str, default=None,
                    choices=[None, "nccl", "gloo"],
                    help="torch.distributed backend on several replicas "
                         "(default: nccl on the card, gloo on the CPU); "
                         "gloo lets replicas share one card")
    ap.add_argument("--init-method", type=str, default=None,
                    help="the process group's rendezvous (default "
                         "torchrun's env://)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights, the prompts and a poisson "
                         "trace")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="write a Chrome trace-event JSON of every "
                         "executed round")
    ap.add_argument("--metrics-out", type=str, default=None,
                    help="write the metrics-registry snapshot JSON")
    args = ap.parse_args(argv)
    if args.virtual_stages and args.virtual_stages > 1 \
            and args.schedule not in (None, "serve_interleaved",
                                      "serve_spec_interleaved"):
        ap.error("--virtual-stages > 1 requires --schedule "
                 "serve_interleaved or serve_spec_interleaved")
    if args.spec_k is not None and args.schedule is not None \
            and not SCHEDULES[args.schedule].is_speculative:
        ap.error(f"--spec-k needs a speculative schedule "
                 f"(--schedule serve_spec_1f / serve_spec_interleaved), "
                 f"got {args.schedule}")
    if args.spec_k is None and args.schedule is not None \
            and SCHEDULES[args.schedule].is_speculative:
        args.spec_k = 4         # the schedules' default draft depth
    obs = None
    if args.trace_out or args.metrics_out:
        obs = Observability(trace=bool(args.trace_out))

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.data > 1 or world > 1:
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit(f"--data {args.data}: data replicas run one "
                             f"process each; launch with torchrun "
                             f"--nproc-per-node {args.data}")
        if world != args.data:
            raise SystemExit(f"--data {args.data} needs {args.data} ranks; "
                             f"the world has {world}")
        if args.arrivals or args.spec_k is not None:
            raise SystemExit("--arrivals and --spec-k run on one replica: "
                             "each replica's rounds would run apart")
    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.smoke:
        spec, plan, dtype = cfg.smoke_spec(), cfg.SMOKE_PLAN, torch.float32
    else:
        spec, plan, dtype = cfg.full_spec(), cfg.PLAN, torch.bfloat16
        if args.layers:
            from repro_torch.launch.train import cut_layers
            spec = cut_layers(spec, args.layers)
    plan = plan.with_(tp=1)
    if spec.frontend == "vision":
        # the prompt holds the patch prefix and some text
        args.prefill = max(args.prefill, spec.n_patches + 8)
    if args.schedule or args.virtual_stages or args.spec_k:
        v2 = (args.virtual_stages or 1) > 1
        name = args.schedule or (
            ("serve_spec_interleaved" if v2 else "serve_spec_1f")
            if args.spec_k else
            ("serve_interleaved" if v2 else "serve_1f"))
        plan = plan.with_(**plan_kwargs_for_schedule(
            name, virtual_stages=args.virtual_stages,
            stash_mode=plan.stash_mode))
    if world == 1:
        return serve(args, spec, plan, dtype, device, obs)
    from repro_torch.parallel.dist import ProcessGrid, close_grid, init_grid
    backend = args.backend or ("gloo" if device.type == "cpu" else "nccl")
    grid = init_grid(ProcessGrid(args.data, 1), backend,
                     init_method=args.init_method, device=args.device)
    try:
        print(f"grid: {grid.describe()}", flush=True)
        # R fitted to the batch over the replicas; each replica a block
        # of every microbatch's rows
        R = fit_serving_microbatches(plan.decode_microbatches, args.batch,
                                     args.data)
        return serve(args, spec, plan.with_(decode_microbatches=R), dtype,
                     grid.device, obs, grid=grid)
    finally:
        close_grid()


def serve(args, spec, plan, dtype, device, obs, grid=None):
    """Build the session of the parsed arguments and serve: the one-shot
    batch's tokens (rank 0's on several replicas), or None under
    ``--arrivals``."""
    replica, replicas = (0, 1) if grid is None else (grid.d, args.data)
    lead = grid is None or grid.rank == 0
    session = build_serving(spec, plan, cache_len=args.cache_len,
                            global_batch=args.batch // replicas,
                            compute_dtype=dtype, page_size=args.page_size,
                            prefill_len=args.prefill, buckets=args.buckets,
                            spec_k=args.spec_k,
                            weight_dtype=args.weight_dtype,
                            kv_dtype=args.kv_dtype, device=device,
                            obs=obs)
    sched = session.sched
    if lead:
        print(f"serve schedule: {sched.name} (S={sched.n_stages} "
              f"R={session.n_slots}"
              f"{f' v={sched.virtual_stages}' if sched.virtual_stages > 1 else ''}"
              f"{f' spec_k={sched.spec_k}' if session.speculative else ''}"
              f", {sched.n_ticks} ticks/pass) on {device}"
              + (f", {replicas} data replicas of {session.rows} rows a slot"
                 if replicas > 1 else ""))
        if session.paged:
            print(f"paged KV: page_size={session.paged['page_size']} "
                  f"max_pages/slot={session.paged['max_pages']} "
                  f"pool_pages={session.paged['pool_pages']}")
        if session.buckets:
            print(f"bucket lattice: {session.buckets}")
        if args.weight_dtype or args.kv_dtype:
            print(f"storage dtypes: weights={args.weight_dtype or 'compute'} "
                  f"kv={args.kv_dtype or 'compute'}")
    toks = None
    if args.arrivals:
        serve_arrivals(session, spec, args)
    elif grid is None:
        toks = serve_batch(session, spec, args)
    else:
        def gather(t):
            # every replica's (steps, R, rows) block, joined on the rows
            parts = grid.world_group.all_gather_object(
                t.reshape(t.shape[0], session.n_slots, session.rows))
            if not lead:
                return None
            return np.concatenate(parts, axis=2).reshape(t.shape[0], -1)
        toks = serve_batch(session, spec, args, replica, replicas, gather)
    if obs is not None:
        for kind in ("decode", "verify"):
            if obs.registry.counter("rounds_total").value(kind=kind):
                print(" ", reconcile(sched, trace=obs.trace,
                                     registry=obs.registry, kind=kind))
        obs.save(trace_out=args.trace_out, metrics_out=args.metrics_out)
        for what, path in (("pipeline trace", args.trace_out),
                           ("metrics snapshot", args.metrics_out)):
            if path:
                print(f"wrote {what} to {path}")
    return toks

if __name__ == "__main__":
    main()
