#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card.

  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build — compile every CUDA kernel of ``src/repro_torch/kernels/csrc``
   from the checkout's sources (one nvcc per source, in parallel);
2. kernels — each kernel against its plain PyTorch version on the card,
   at the main paths' shapes, in bf16 and f32, with stated tolerances
   (wkv6 and mamba_scan with and without a start state, plus
   strong-decay cases for wkv6, bf16 on its chunked design);
3. serve — qwen3-14b at full width (d 5120, 40 heads, 8 KV heads, Dh 128,
   d_ff 17408, vocab 151936), bf16, random seeded weights, ``serve_1f``
   with pp = 2 on the one card: R = 4 slots × 2 rows, prefill 512,
   cache_len 1024, page size 16, 16 decode steps through the paged
   kernel, and a ``torch.profiler`` breakdown of one more decode step;
   then ``full_transformer`` (the flash kernel) over the served
   sequence.  Launch counters are zeroed before and read after each;
4. consistency — fp32 at full width and 2 layers: the paged engine's
   hidden states and pools against the dense-cache engine's, and
   ``full_transformer`` logits against the engine's last-position logits;
5. serve rwkv6 — rwkv6-1.6b at full width (d 2048, 24 layers, 32 heads
   of 64, d_ff 7168, vocab 65536), bf16, random seeded weights,
   ``serve_1f`` with pp = 8 on the one card: R = 4 slots × 8 rows,
   prefill 1024, 32 decode steps, every layer's WKV through the wkv6
   kernel from the slot's recurrent state (the prefill on its chunked
   design, each decode step on its stepwise design); then
   ``torch.profiler`` breakdowns of one more decode step and of one more
   prefill, by kernel;
6. reference rwkv6 — ``full_transformer`` (wkv6 from a zero state) over
   the served sequence: the served tokens must be its greedy tokens at
   every generated position of every row;
7. consistency rwkv6 — fp32 at full width and 2 layers: the engine's
   last-position logits against ``full_transformer``'s;
8. serve jamba — jamba-v0.1-52b at full width (d 4096, 32 heads / 8 KV
   heads of 128, d_ff 14336, 16 experts top-2 of 14336, Mamba d_state
   16, d_conv 4, expand 2, vocab 65536), cut to its first 16 of 32
   layers (two periods of 7 Mamba + 1 attention mixers, 4 MoE + 4 dense
   FFNs), bf16, ``serve_1f`` with pp = 2: R = 4 slots × 2 rows, prefill
   1024 (MoE capacity 320), cache_len 2048, page 16, 16 decode steps;
   every Mamba layer call through the mamba_scan kernel from the slot's
   state, the attention layers' decode through the paged kernel; then
   ``torch.profiler`` breakdowns of one more decode step and of one more
   prefill;
9. reference jamba — per slot, ``full_transformer`` (flash + mamba_scan
   from zero) over that slot's prompts with the engine's statics: its
   greedy token at the last prompt position must be the served first
   token, up to bf16 near-ties;
10. consistency jamba — fp32 at full width and 2 layers (Mamba + MoE,
   attention + dense): the paged engine against the dense-cache engine
   (tokens, hidden states, pools, conv tails, SSM states) and the
   engine's prefill logits against ``full_transformer``'s;
11. serve quantized — phase 3's configuration with int8 weights
   (per-output-channel scales, dequantized at each matmul) and int8
   paged KV (per-(page, KV head) scales): memory against phase 3's,
   prefill and decode times, every decode's attention through the int8
   page walk, a profiled decode step, greedy agreement with phase 3;
12. consistency quantized — fp32 at full width and 2 layers, int8 / int8:
   the same session on the card and on the CPU (the int8 kernel against
   the plain path, every int8 page write included);
13. train — qwen3-14b at full width cut to its first 4 of 40 layers,
   bf16 parameters with f32 Adam moments, ``1f1b`` / ``stash`` with pp =
   2 (a V = 3 weight-version ring), remat, R = 4 microbatches of 1 row x
   4096 tokens, 3 rounds on the SyntheticLM stream, built as a train_4k
   cell (launch/cell.py::build_cell); every attention forward
   through the flash kernel (with its log-sum-exp) and every attention
   backward through the backward kernel; finite losses; the last round
   through ``launch/profile_cell.py::profile_step``, one more round's op
   count (launch/op_analysis.py) and its roofline terms beside the model
   FLOPs and the measured ``mfu`` (launch/roofline.py);
   then the same shape through the virtual-stage schedules,
   ``interleaved`` (flush) and ``interleaved_async`` (per-chunk
   weight-version rings), pp = 2 x v = 2 (4 chunks of one layer): round
   seconds, tokens/s, peak memory, losses, the predicted bubble, and for
   the async ring its bytes and the profiled round's device-to-device
   copy time;
14. consistency train — fp32 at full width and 2 layers, pp = 2, seq
   256, R = 4, 2 rounds of each schedule (1f1b stash and vertical, gpipe
   flush and 2bw), and at 4 layers of ``interleaved`` and
   ``interleaved_async`` (pp = 2, v = 2): the executor
   (core/pipeline.py) against the sequential oracle (core/reference.py),
   losses and every state tensor bit for bit, under deterministic
   algorithms (the executor's state is reduced to 64-bit digests on the
   card and freed before the oracle runs, and at 4 layers the oracle
   consumes its input as it goes);
15. plan — PipeDream's profiling step on the card: one qwen3-14b block's
   forward at full width (1 row x 4096 tokens, bf16, the flash kernel)
   and the head timed through ``core/profiler.py::profile_measured``,
   scaled to the train_4k microbatch (32 rows), and ``plan_search`` for
   all 40 layers at train_4k (seq 4096, global batch 256, R = 8) over a
   model axis of 8 H100s, on analytic and on measured profiles; both
   must return a plan that fits 80 GB;
16. driver — ``TrainDriver`` through the training entry point's flags at
   full width cut to 2 layers, bf16, SGD with momentum, 1f1b / stash, pp
   = 2: 5 rounds uninterrupted, without checkpoints, under deterministic
   algorithms, the reference of 18b (which runs the driver's faults and
   restart on two ranks; the one-process faulty run is left to the CPU
   tests, for the time limit);
17. dist — stages on several ranks and data replicas over
   ``torch.distributed`` (``parallel/dist.py``, the executor with a
   process grid).  17a: a (1, 1) grid under NCCL at world size 1, fp32,
   2 layers at full width, seq 256, equals the single-process executor
   bit for bit (NCCL's all-reduce runs; no p2p: one rank has no peer);
   17b: two processes on the one card under gloo (started with
   ``spawn``; every hand-off staged through host memory), pp 2 at dp 1,
   ``1f1b`` / stash at 2 layers and ``interleaved`` (flush) v 2 at 4
   layers, equal the single-process executor bit for bit (state digests
   compared across processes); 17c: dp 2 x pp 2 (four processes; dp 2
   x pp 1 is held on the CPU), R 2, one round, replicated and ZeRO-1, track the
   sequential oracle over the whole batch (losses atol 5e-5 / rtol 1e-4, weights 5e-5 / 2e-3),
   ZeRO-1 equals the replicated update bit for bit; 17d: phase 13's
   shape (qwen3-14b, 4 layers, bf16, Adam, 1f1b / stash, pp 2, R 4 x
   4096, one round) split over two ranks on the one card: its first
   round's loss within 2e-2 of phase 13's, finite losses, every
   attention through the flash kernels.  The children build nothing
   (the kernels are built by phase 1) and run deterministic algorithms;
18. ckpt dist — workers that checkpoint their own stages and report what
   they measure.  18a: qwen3-14b at all 40 layers and full width, bf16,
   1f1b / stash pp 2, parameters only (no optimizer state or ring, which
   do not fit two ranks at 40 layers), drawn row-wise on two gloo ranks
   sharing the card (``models/init.py::init_rank_params``): each rank's
   init peak, and its digests equal to the rows of one process's whole
   draw, made after the ranks exit.  18b: phase 16's TrainDriver run
   (2 layers, bf16, SGD with momentum, R 4 x 4096, 5 rounds, a
   checkpoint every 2) over two gloo ranks, with an Observability that
   traces; the last rank fails before round DRIVER_FAIL and crashes in
   round DRIVER_TORN's save.  Each rank's final state equals phase 16's
   rows bit for bit (digests), the last complete checkpoint restores in
   one process (spawned beside phases 19-20, joined after 20) to the digests
   of what the ranks saved, the torn round
   is skipped, ``rounds_total{kind=train}`` counts every executed round,
   rank 0's registry holds every stage's measured
   ``stage_round_seconds``, and the trace has a span per busy table cell;
19. batching — phase 3's model cut to BATCH_LAYERS of its 40 layers
   (for the script's time limit) at phase 3's shape (bf16,
   pp 2, R 4 x 2 rows, prompt width 512, cache 1024, page 16) through
   the continuous batcher (``serving/batcher.py``) with buckets and a
   pool of BATCH_POOL pages, over BATCH_TRACE (6 pairs of requests,
   prompts 64-512, 8-48 new tokens, staggered arrivals).  19a: every
   served token is ``full_transformer``'s greedy token up to near-ties
   (BATCH_TIE), the allocator holds after every step and every page
   comes back, each decode round launches the paged kernel layers x
   live slots times at Q = 1, an admission queues on the dry pool, one
   is admitted into an evicted slot, the live set shrinks to a smaller
   bucket and grows back.  19b: the same trace on ``serve_spec_1f``
   (spec_k SPEC_K) with the self-drafter, oracle drafts of 19a's streams
   and corrupted ones: every served token of each run is
   ``full_transformer``'s greedy token over that run's own prefix up to
   near-ties, streams equal 19a's up to a first difference at a
   near-tie, every verify round launches the paged kernel at Q =
   SPEC_K + 1 only (its plain version refused), oracle drafts are
   rejected only where a lane's stream leaves 19a's (all accepted for
   pairs that keep 19a's streams), corrupted ones never.  19c: fp32, TF32 off, at
   BATCH_CONS_LAYERS layers: the trace batched equals each request
   served alone in a fresh one-shot session (tokens; last hidden state
   1e-4), ``serve_interleaved`` pp 2 x v 2 equals ``serve_1f`` (tokens;
   hidden 1e-5), and the speculative streams (self, oracle, corrupted)
   equal the plain ones exactly;
20. planned serving — the serving planner and windowed ring caches.
   20a: ``plan_search(workload="decode")`` for qwen3-14b at all 40
   layers, pp 1 x tp 1 on an 80 GB H100, cache SPLAN_CACHE, SPLAN_BATCH
   rows (R SPLAN_R), bf16 KV: every dense plan over budget, paged at
   SPLAN_PAGE and occupancy SPLAN_OCC one that fits; the chosen plan's
   session, its pool the pages the occupancy implies, holds weights and
   cache (``torch.cuda.memory_allocated`` around ``init_weights`` and
   ``reset_state``) within MEM_RTOL of the memory model's; SPLAN_R
   requests of SPLAN_PROMPTS tokens, SPLAN_DECODE decodes at SPLAN_R live
   slots beside the predicted round (informative), slot 0's first tokens
   ``full_transformer``'s up to BATCH_TIE.  20b: h2o-danube3-4b at full
   width (24 layers, Dh 120, window 4096), bf16, ``serve_1f`` pp 2, R
   DANUBE_SLOTS x DANUBE_ROWS, DANUBE_PROMPT-token prompts, cache
   DANUBE_CACHE, page 16, DANUBE_DECODE decodes through the paged kernel
   at Dh 120; the served tokens ``full_transformer``'s (the flash kernel
   at Dh 120) greedy tokens up to near-ties (DANUBE_TIE).  20c: fp32,
   danube's widths cut to RING_LAYERS layers of window RING_WINDOW, cache
   RING_CACHE: a session without ``prefill_len`` (ring caches) equals one
   with it (full-length caches) over RING_PROMPT + RING_DECODE tokens
   (tokens; hidden 1e-5), and each one's cache bytes equal
   ``serving_cache_bytes`` with ``prefill`` False and True.  20b also
   serves danube3 at 2 layers in fp32 with int8 paged KV (120-byte rows
   through the walk's 8-byte chunks), DANUBE_INT8_DECODE decodes on the
   card and on the CPU: tokens and positions equal;
21. tensor parallelism — ranks as gloo processes sharing the card (NCCL
   refuses two a card, so round times are not tp's speed).  21a:
   qwen3-14b's widths at DIST_LAYERS layers, fp32, phase 17a's shape, pp
   1 x tp TP_DEGREE on two ranks against the one-process tp 1 executor
   from the same seed: losses and parameters within TP_LOSS_TOL /
   TP_PARAM_TOL, the replicated stage leaves bit-identical across the
   tensor ranks, each rank holding its own columns of the embedding and
   of the head (``models/lm_head.py``'s sharded tables), the tensor
   group's calls and bytes equal to the analytic count (``tp_sums``).
   21b: phase 13's model and shape at pp 2 x tp TP_DEGREE on four ranks
   through launch/train.py's build, one round: its loss within 2e-2 of
   phase 13's first round, the flash launches tp times phase 13's a
   round, a ``tp`` line a rank (round seconds, the tensor group's calls
   / bytes / seconds, hand-off wait, peak GB); the last stage's tensor
   ranks' peaks less than TP_PEAK_GAP_GB apart.
   21c: 21a's checkpoint, written by the ranks in JAX's full layout,
   restored by one tp 1 process in host memory while 21b runs: every
   rank's state equals its tensor shard of the restored one bit for
   bit (64-bit digests);
22. train recurrent — the recurrent block kinds trained through the
   launcher's builder at phase 13's shape (R 4 x 1 row x 4096 tokens, 3
   rounds, bf16, the config's Adam, remat), the last round under
   ``torch.profiler``, every plain version refused.  22a: rwkv6-1.6b
   at full width cut to 12 of 24 layers, ``1f1b`` / stash, pp 2: every WKV
   forward on the wkv6 kernel (chunked design) and every backward on
   the wkv6 backward kernel.  22b: jamba-v0.1-52b at full width cut to
   its first 2 of 32 layers (Mamba + dense FFN, Mamba + MoE of 16
   experts top 2, capacity 640), gpipe / flush, pp 1 (a stage holds
   whole layer patterns): every selective scan forward and backward on
   its kernels, the MoE aux loss finite and > 0.  Launches: three
   forwards (F, B's re-run, the checkpoint's recompute) and one
   backward a mixer layer and microbatch.  22c: rwkv6 at 2 layers and
   jamba at 1 (Mamba + dense FFN) in fp32 (phase 14's shape and SGD),
   the executor against the oracle bit for bit under deterministic
   algorithms, every scan on its kernels;
23. new configs — checkpoint ingest and three more configs, bf16 on the
   card.  23a: olmoe-1b-7b at full width cut to INGEST_LAYERS of 16
   layers, a BF16 fixture (values drawn on the card) written by the
   port's safetensors writer in INGEST_SHARDS shards and an index,
   converted by ``checkpoint/convert.py`` for pp 2 at v 1 and v 2, all
   of 23a in a spawned process beside 23b-e: the export of the v 1
   directory equals the fixture widened to f32, the v 1 ``load_converted``
   equals ``hf_to_params`` and the v 2 one the v 1 tree re-chunked into
   v 2 rows, bit for bit; each directory served through
   ``launch/serve.py::load_checkpoint`` (``serve_1f`` /
   ``serve_interleaved``) gives the tokens and logits of the same tree
   installed in memory bit for bit, and the v 1 directory loaded into
   the v 2 session raises ConvertError; bytes, seconds and GB/s of each
   step.  23b-d: olmoe-1b-7b (16 layers, 16 / 16 heads, 64
   experts top 8), deepseek-moe-16b (28 layers, 16 / 16 heads, 64
   experts top 6 and 2 shared) and chatglm3-6b (28 layers, 32 / 2 heads,
   2d RoPE) at full width and depth, ``serve_1f`` pp 2 at phase 3's
   shape (prefill_len PREFILL sizes the MoE capacity), every decode
   through the paged kernel, a profiled decode step; the served tokens
   ``full_transformer``'s greedy tokens up to near-ties of NEW_TIE (for
   chatglm3 at every generated position, for the MoE models the first
   token from per-slot passes: a longer pass routes more tokens a call);
   at NEW_CONS_LAYERS layers in fp32 the paged engine equals the dense
   one (1e-5), the same session on the CPU (tokens, positions; hidden
   1e-4) and ``full_transformer``'s prefill logits (1e-3).  23e:
   deepseek-moe-16b cut to 2 of 28 layers and chatglm3-6b cut to 4 of 28
   trained at phase 13's shape (1f1b / stash pp 2, the config's Adam,
   remat): finite losses, every attention forward and backward on the
   flash kernels; at NEW_CONS_LAYERS layers in fp32 the executor equals
   the oracle bit for bit;
24. frontends (while 23a's process finishes) — whisper-medium (an
   encoder of 24 layers before the
   pipeline over 1500 stub frames, cross-attention in each of 24 decoder
   layers, 16 / 16 heads of 64) and llava-next-34b (576 stub patch
   embeddings before the text, 56 / 8 heads of 128), bf16 on the card.
   24a: whisper at full size, ``serve_1f`` pp 2, R_SLOTS x ROWS rows, a
   prompt of 64 tokens and the frames, cache_len 448 (its published
   decoder context), page PAGE, N_DECODE decodes through the paged
   kernel (cross-attention K / V recomputed from each slot's
   ``enc_out``), a profiled decode step; ``full_transformer`` over the
   served sequences with the same encoder output: its greedy tokens the
   served ones up to near-ties of FRONT_TIE.  24b: llava at full width
   cut to 8 of 60 layers, the same with a prompt of 576 patches and 64
   tokens, cache_len 1024.  24c: whisper at full depth (1f1b / stash, 2
   rows a microbatch, 128 tokens and 1500 frames) and llava cut to 4
   layers (its plan's flush, 576 patches and 128 tokens) trained R
   FRONT_R x FRONT_ROUNDS rounds through the launcher's build and loader,
   the config's Adam: finite losses, whisper's encoder leaves moved,
   every decoder self-attention forward and backward on the flash
   kernels, the peak GB.  24d: whisper at 2 + 2 layers in fp32: the paged
   engine equals the dense one (tokens, positions, enc_out; hidden and
   pools 1e-5) and ``full_transformer``'s prefill logits (1e-3); the
   executor equals the oracle bit for bit.
25. gemma3 — gemma3-4b (34 layers, d 2560, 8 / 4 heads of 256, vocab
   262144, five layers of a 1024-token window to one global layer), bf16
   on the card.  25a: full_spec served at phase 3's shape (pp 2, R_SLOTS
   x ROWS rows, prefill PREFILL, N_DECODE decodes) with a cache of
   GEMMA_CACHE, dense and paged: the windowed stage positions keep rings
   of the window, the others full-length caches; ``full_transformer``'s
   greedy tokens the served ones up to near-ties of GEMMA_TIE.  25b: its
   first GEMMA_TRAIN_LAYERS layers trained GEMMA_TRAIN_ROUNDS rounds at
   phase 13's shape (1f1b / stash pp 2, the config's Adam, remat), the
   last profiled: finite losses, every attention forward and backward on
   the flash kernels at Dh 256.  25c: layers GEMMA_CONS_BLOCKS (one
   windowed, one global) in fp32: the paged engine equals the dense one
   and the CPU's, int8 paged KV on the card equals the CPU, the verify
   tile, and the executor equals the oracle bit for bit.
26. launch tools — 26a: one fp32 step of a qwen3-14b train_4k cell at
   TOOLS_LAYERS layers (1 x 4096, SGD) counted by launch/op_analysis.py
   on the card and on the CPU: equal FLOPs and kernel calls, bytes
   within TOOLS_BYTES_RTOL, the gap named by op.  26b: launch/dryrun.py
   on qwen3-14b's train_4k, prefill_32k and decode_32k cells at 256
   cards, on ``meta`` (26b and 26a's CPU count run in a process spawned
   beside phases 22-25, on the host's CPU only).  26c: two fp32 rounds of
   a TOOLS_LAYERS-layer cell fed by data/pipeline.py::Prefetcher equal
   the in-line Loader's bit for bit.  26d: ``serve --data 2`` on two gloo
   ranks sharing the card equals ``serve --data 1`` (qwen3-14b,
   TOOLS_LAYERS layers, bf16) token for token.

Phase 2 also holds the flash forward and backward (bf16 and f32, causal
and a 1024-token window) at 25b's training call and the paged walk
(float and int8 pools, and the verify tile) at 25a's decode call, all at
Dh 256 and gemma3's 8 / 4 heads, against their plain versions (a
``dh256`` entry on each record of the kernels line, with its launches
on phase 25's paths).

Phase 2 also holds the flash forward with its rows' log-sum-exp and its
backward (bf16 and f32) and the paged walk (bf16 and f32 pools) at the
head layouts of phase 23's and 24's configs (LAYOUTS: 16 / 16 heads, G
1; 32 / 2, G 16, with the verify tile at Q SPEC_K + 1, 80 query rows a
KV head; 16 / 16 at Dh 64; 56 / 8, G 7) against their plain versions;
the kernels line gives each record a ``layouts`` entry a layout (time,
bound, plain and library time, launches by path), and the script fails
if a kernel ran no time on phase 24's paths at its two layouts.
Phase 2 also holds the int8-pool paged kernel and the flash backward
kernel (bf16 and f32; with its log-sum-exp, and determinism) against
their plain versions, and at h2o-danube3-4b's heads (32 / 8, Dh 120)
the flash forward (bf16 and f32, windowed), its backward (bf16) and the
float and int8 paged walks (windowed; int8 rows of 120 bytes); and the
wkv6 and mamba_scan backward kernels against their plain backwards at
phase 22's training calls (wkv6 (1, 4096, 32, 64) in bf16 and f32, at
strong decay and with decays of exactly 0; mamba_scan (1, 4096, 8192,
16) in f32), deterministic.  Launch
counters are zeroed before and read after each main path (phases 3, 5,
6, 8, 9, 11, 13, 15, 16, 17d, 18b, whose two ranks count their own,
19a, each run of 19b, 20a-b, 21a-b, whose ranks count their own, and
22a-c, which also read the backward kernels' counters, 23a-e,
24a-d and 25a-c).
Prints a
``profile`` JSON line for qwen3 bf16, rwkv6 (decode, then prefill),
jamba (decode, then prefill), quantized qwen3 and the training rounds
(1f1b, interleaved, interleaved_async), three ``train`` JSON lines
(1f1b with its witnesses, then each interleaved schedule), the ``plan``
and ``driver`` JSON lines, a ``dist`` JSON line a rank of 17d and of
17c's dp 2 x pp 2 grid (backend, device, round seconds, hand-off
seconds and bytes, bytes staged through host memory, peak GB, optimizer
state GB with and without ZeRO-1), a ``ckpt_dist`` JSON line a rank of
18b (checkpoint GB written, save and restore seconds, rounds replayed,
stage seconds), one for 18b's one-process restore and one a rank of 18a
(init seconds, peak and kept GB), one ``obs`` JSON line (per-stage
measured seconds, ``reconcile`` against the planner's analytic H100
costs, ``replan_from_registry``'s plan), one ``batcher`` JSON line
(phase 19: requests, tokens, steps, rounds, goodput, TTFT and per-token
latency p50 / p99, decode ms by live slots, the bucket histogram, the
steps admissions waited on the dry pool, near-ties, each speculative
run's acceptance by round), one ``planned_serving`` JSON line (phase
20: the dense and chosen plans, predicted and measured bytes, the
decode step beside the predicted round, danube's times and gaps, the
ring check), ``tp`` JSON lines (phase 21: one a rank of 21b, one for
21a / 21c), ``train_recurrent`` JSON lines (phase 22: 22a and 22b's
round seconds, tokens/s, peak GB, losses, aux and launches; 22c),
profiles of 22a's and 22b's rounds, of 23b-d's decode steps and 23e's
rounds, an ``ingest`` JSON line (23a), three ``serve_new`` lines
(23b-d), two ``train_new`` lines and a ``train_new_exact`` line (23e),
two ``serve_front`` lines, two ``train_front`` lines and a
``front_consistency`` line (phase 24) with their decode and round
profiles, ``op_count``, ``dryrun``, ``prefetch`` and ``serve_data``
lines (phase 26),
one ``kernels`` JSON line
(launches, by path and for wkv6 by
design, errors, times, bounds, a ``layouts`` entry for the new head
layouts, each kernel's design and what ``ptxas -v`` reported; the
flash, backward, paged and int8 paged records carry a ``dh120`` entry at
Dh 120 and a ``dh256`` entry at Dh 256), the card's name and power
limit, and last ``{"ok": true, "device": ...}``.  Exits non-zero without
a CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# detach the profiler's CUPTI hooks when each profiling session ends: left
# attached, they slow every later host-bound phase of this process (phase
# 19a's 4-slot decode step 176-201 ms before one torch.profiler session,
# 243-283 ms after it; scripts/profiler_teardown_probe.py, H100 80GB HBM3
# at 700 W)
os.environ.setdefault("TEARDOWN_CUPTI", "1")

# a kernel's bound is the larger of the bytes it must move over the HBM
# rate and its operations over the peak of their type (and, for the
# scans, its exps over the SFU rate): the counts of kernels/cost.py on
# the H100 SXM's data-sheet rates of core/profiler.py::H100_SXM
L2_BYTES = 50 * 2**20          # H100 SXM L2 cache (data sheet)

SEED = 0
N_DECODE = 16
PREFILL = 512
CACHE_LEN = 1024
PAGE = 16
R_SLOTS, ROWS = 4, 2
TOL = {"float32": (2e-5, 1e-3), "bfloat16": (2e-2, 1e-2)}  # (atol, rtol)
# rwkv6 serving: R slots × rows, prompt and decode lengths
RWKV_SLOTS, RWKV_ROWS = 4, 8
RWKV_PREFILL, RWKV_DECODE = 1024, 32
RWKV_H, RWKV_DH = 32, 64
# bf16 greedy agreement: logits come out of a bf16 product, so near the
# maximum (~4 at these random weights) they are quantized in steps of
# 1/64..1/32, and the served path and full_transformer round their
# products differently.  A served token must be a greedy token of the
# reference up to this margin (~3-6 steps); a wrong state moves logits
# by their spread (~0.9).
RWKV_TIE = 0.1
# jamba serving: 16 of 32 layers at full width (all 32 are 103 GB in
# bf16), R slots × rows, prompt, cache and decode lengths
JAMBA_LAYERS = 16
JAMBA_SLOTS, JAMBA_ROWS = 4, 2
JAMBA_PREFILL, JAMBA_CACHE, JAMBA_DECODE = 1024, 2048, 16
MAMBA_CI, MAMBA_N = 8192, 16
# quantized consistency (card vs CPU): slots x ROWS rows, a prompt that
# leaves a page partly filled, cache_len; scale planes may differ by half
# an int8 step of their page's absmax
QUANT_SLOTS, QUANT_PREFILL, QUANT_CACHE = 1, 40, 128
# training (phase 13): qwen3-14b at full width cut to its first 4 of 40
# layers (all 40 with Adam and a V = 3 stash ring do not fit one card),
# bf16, Adam, 1f1b / stash, pp = 2, R microbatches of 1 row x the
# train_4k sequence length, 3 rounds
TRAIN_LAYERS, TRAIN_R, TRAIN_ROWS, TRAIN_SEQ, TRAIN_ROUNDS = 4, 4, 1, 4096, 3
# phase 13's witnesses at the same shape, each TRAIN_ROUNDS rounds from the
# same seed: (name, launcher flags, the stream's first batch repeated?).
# At the config's constant Adam lr the loss on the stream rises (PERF.md
# section 6); "flush" makes one Adam update a round instead of 1f1b's R,
# so it shows whether the per-microbatch updates alone cause the rise;
# "one_batch" is the main run on the first batch every round (the stream's
# tokens are fresh each round), and its loss must fall each round: a
# wrong bf16 gradient does not fit a batch
TRAIN_WITNESSES = (
    ("flush", ["--schedule", "gpipe", "--stash-mode", "flush"], False),
    ("one_batch", ["--schedule", "1f1b", "--stash-mode", "stash"], True))
# training consistency (phase 14): fp32, 2 layers, pp = 2, seq 256, R = 4,
# 2 rounds, each schedule; executor against oracle, bit for bit
CONS_LAYERS, CONS_SEQ, CONS_R, CONS_ROUNDS = 2, 256, 4, 2
# phase 13's virtual-stage runs at its shape: (schedule, stash mode), v = 2
TRAIN_VIRTUAL = (("interleaved", "flush"), ("interleaved_async", "stash"))
V_STAGES = 2
# phase 14's virtual-stage cases: 4 layers (pp = 2 x v = 2 chunks of one)
CONS_VIRTUAL_LAYERS = 4
# phase 15: PipeDream's profiling step, then plan_search at train_4k over
# one 8-card node: the block and the head timed at 1 row x PLAN_SEQ, the
# microbatch is PLAN_BATCH / PLAN_R rows
PLAN_SEQ, PLAN_BATCH, PLAN_R, PLAN_AXIS = 4096, 256, 8, 8
# phase 16: TrainDriver at full width cut to 2 layers, bf16, SGD with
# momentum (one f32 state: the smallest checkpoint), 1f1b / stash, pp = 2;
# a failure before round DRIVER_FAIL and a crash in round DRIVER_TORN's
# save
DRIVER_LAYERS, DRIVER_ROUNDS, DRIVER_EVERY = 2, 5, 2
DRIVER_FAIL, DRIVER_TORN = 3, 4
# phase 17: stages on several ranks; 17a-c in fp32 at full width, 2
# layers (17b's interleaved case 4: pp 2 x v 2 chunks of one), SGD with
# momentum, R microbatches of DIST_ROWS rows a replica x DIST_SEQ, 2
# rounds; 17d is phase 13's shape.  A rank waits DIST_GROUP_S on a peer
# before its process group raises; a spawn's results are due in
# DIST_JOIN_S
DIST_LAYERS, DIST_V_LAYERS, DIST_SEQ, DIST_R, DIST_ROWS, DIST_ROUNDS = \
    2, 4, 256, 4, 1, 2
# 17c's replicas sum every microbatch's full-width fp32 gradients through
# host memory (gloo on one card: ~30 s a round of R 4 at dp 2 x pp 2), so
# it runs R 2 microbatches for one round, at dp 2 x pp 2 only: dp 2 x pp
# 1 took 153 s on a slow host (the f32 embedding and head dominate, so a
# shallower model saves little); tests/test_torch_dist_replicas.py holds
# it on the CPU
DIST_REPLICA_R, DIST_REPLICA_ROUNDS = 2, 1
DIST_REPLICA_PP = (2,)
# 17d runs phase 13's shape for one round (its loss is held to phase 13's
# first round's), which gives phase 20 its seconds
DIST_TRAIN_ROUNDS = 1
DIST_GROUP_S, DIST_JOIN_S = 120, 600
# phase 21: tensor parallelism on gloo ranks sharing the card.  21a / 21c
# run 17a's shape (DIST_LAYERS layers fp32, DIST_R x DIST_ROWS x
# DIST_SEQ, SGD with momentum, DIST_ROUNDS rounds) at pp 1 x tp
# TP_DEGREE, held to the one-process tp 1 executor within the
# tolerances of tests/test_torch_dist_jax.py; 21b runs phase 13's model
# and shape at pp 2 x tp TP_DEGREE; 21c's restore at tp 1 runs in host
# memory while 21b's ranks hold the card
TP_DEGREE = 2
# 21b: the last stage's tensor ranks, each with its slice of the head,
# peak within half of the 20.6 GB gap measured when tensor rank 0 held
# the whole head (28.30 against 7.70 GB on an H100 80GB HBM3)
TP_PEAK_GAP_GB = 10.3
TP_LOSS_TOL = dict(atol=5e-5, rtol=1e-4)
TP_PARAM_TOL = (5e-5, 2e-3)
# elements a digest weighs at a time (its weights: 128 MB on the card)
DIGEST_CHUNK = 1 << 24
# the backward kernel's checks (phase 2): (B, S, window) at H 40 / KV 8,
# Dh 128, causal; Sq = Sk; the last is the training call, the shape the
# kernels line times
FLASH_BWD_CASES = ((1, 1024, -1), (1, 1000, 256), (1, TRAIN_SEQ, -1))
SCALE_RTOL = 0.5 / 127
# phase 19: continuous batching at phase 3's shape (R_SLOTS x ROWS, prefill
# width PREFILL, CACHE_LEN, PAGE).  Each entry is a pair of requests, the
# two lanes of one slot: (prompt length, max_new_tokens, arrival step).
# Pairs 1-3 fill three slots at step 0 (90 pages) and pair 4 (16 pages)
# queues on the dry pool of BATCH_POOL pages until pair 3 is evicted at
# step 8 and it is admitted into that slot; pair 4's eviction at step 24
# shrinks the live set to bucket 2, pairs 5-6 grow it back to 4.  No
# slot set can outgrow the pool, so no request is truncated.
BATCH_TRACE = ((512, 48, 0), (480, 40, 0), (448, 8, 0), (256, 16, 0),
               (320, 12, 28), (64, 20, 30))
BATCH_POOL = 100
SPEC_K = 4
# 19a-b's depth (bf16 at full width, cut from 40 for the script's time
# limit) and 19c's (fp32), pp 2 x v 2 chunks of one layer
BATCH_LAYERS = 20
BATCH_CONS_LAYERS = 4
# bf16 greedy agreement at qwen3-14b's 40 layers: the reference's largest
# logit is 5.7-7.9 at these random weights (bf16 steps of 1/32), and the
# served path's logits differ from full_transformer's by up to 0.22 at a
# position (the largest of the 151936, measured on the card); a served
# token must be a greedy token of the reference up to this margin, and a
# wrong state moves logits by their spread (std ~1.43)
BATCH_TIE = 0.25
# phase 20: the serving planner at qwen3-14b's full depth, pp 1 x tp 1 on
# one card: cache SPLAN_CACHE, SPLAN_BATCH rows in SPLAN_R slots, bf16 KV,
# paged at SPLAN_PAGE with SPLAN_OCC of the slots' capacity in the pool;
# SPLAN_R requests (a slot each) with prompts spread over SPLAN_PROMPTS,
# SPLAN_DECODE decodes; measured weights and cache within MEM_RTOL of the
# memory model's
SPLAN_CACHE, SPLAN_BATCH, SPLAN_R = 32768, 16, 8
SPLAN_PAGE, SPLAN_OCC = 16, 0.25
SPLAN_PROMPTS, SPLAN_DECODE = (1024, 2048), 16
MEM_RTOL = 0.01
# 20b: h2o-danube3-4b at full width (24 layers, bf16, serve_1f pp 2), R
# DANUBE_SLOTS x DANUBE_ROWS rows, prompts past its 4096 window; its
# heads (H, KV, Dh); served tokens held with phase 6's bf16 margin
DANUBE_SLOTS, DANUBE_ROWS = 2, 1
DANUBE_PROMPT, DANUBE_CACHE, DANUBE_DECODE = 6144, 8192, 16
DANUBE_WINDOW = 4096
DH120_HEADS = (32, 8, 120)
# 20b's int8 KV run: 2 layers fp32 at full width, card against the CPU
DANUBE_INT8_DECODE = 8
DANUBE_TIE = RWKV_TIE
# 20c: ring caches against full-length ones, fp32, h2o-danube3-4b's
# widths cut to RING_LAYERS layers of window RING_WINDOW
RING_LAYERS, RING_WINDOW, RING_CACHE = 2, 64, 512
RING_PROMPT, RING_DECODE = 32, 160
# phase 2's backward checks at the training calls of phase 22: wkv6 at
# (B, S, H, Dh) and mamba_scan at (B, S, Ci, N), f32 (the model casts the
# scan's inputs to f32).  Tolerance (rel, rtol): |err| <= rel · max|plain|
# + rtol · |plain|.  Each gradient is a sum over up to S x Dh (wkv6) or
# S x N (mamba) products taken in another order than the plain version's
# (f32: a few ulps of the largest term reach entries that cancel to
# near 0, hence a floor relative to the gradient's scale); bf16 outputs
# are rounded to bf16 (2^-8) from f32 values that already differ
TRAIN_WKV = (1, TRAIN_SEQ, RWKV_H, RWKV_DH)
TRAIN_MAMBA = (1, TRAIN_SEQ, MAMBA_CI, MAMBA_N)
WKV6_BWD_TOL = {"f32": (1e-5, 1e-3), "bf16": (1e-2, 1e-2)}
MAMBA_BWD_TOL = (1e-5, 1e-3)
# the paged records' ms: a call's device work is a few tens of us, below
# the host's pace of back-to-back wrapper calls, so events would time the
# host; the profiler times the kernels (the wkv6 and mamba_scan decode
# records do the same)
PAGED_MS_BY = ("torch.profiler device time of the split walk and the "
               "merge, a call; ms_events: CUDA events around back-to-back "
               "calls (the host's pace)")


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(name, got, want, atol, rtol):
    import torch
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: max |err| {err.max().item():.3e} "
                             f"exceeds atol {atol} + rtol {rtol}")
    return float(err.max().item())


def counters():
    """(wrapper, attribute) of every launch counter, by kernel name: each
    wrapper's ``launches``; the paged wrapper counts its int8-pool
    variant apart, in ``launches_int8``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import wkv6 as wk
    return {"paged_attention": (pa.paged_attention, "launches"),
            "paged_attention_int8": (pa.paged_attention, "launches_int8"),
            "flash_attention": (fa.flash_attention, "launches"),
            "flash_attention_bwd": (fa.flash_attention_bwd, "launches"),
            "wkv6": (wk.wkv6, "launches"),
            "mamba_scan": (ms.mamba_scan, "launches")}


def bwd_counters():
    """(wrapper, attribute) of the recurrent kernels' backward launch
    counters, by kernel name (read apart from :func:`counters`, whose
    dicts the earlier phases hold to exact values)."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import wkv6 as wk
    return {"wkv6_bwd": (wk.wkv6_bwd, "launches"),
            "mamba_scan_bwd": (ms.mamba_scan_bwd, "launches")}


def reset_counts() -> None:
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import wkv6 as wk
    for fn, attr in (*counters().values(), *bwd_counters().values()):
        setattr(fn, attr, 0)
    wk.wkv6.launches_chunked = wk.wkv6.launches_stepwise = 0
    pa.paged_attention.launches_by_q = {}


def wkv6_designs() -> dict:
    """Launches of each wkv6 design since the last reset (their sum is the
    ``wkv6`` counter)."""
    from repro_torch.kernels import wkv6 as wk
    return {"chunked": wk.wkv6.launches_chunked,
            "stepwise": wk.wkv6.launches_stepwise}


def read_counts() -> dict:
    return {name: getattr(fn, attr)
            for name, (fn, attr) in counters().items()}


def read_all_counts() -> dict:
    """:func:`read_counts` with the backward kernels' counters."""
    return {**read_counts(), **{name: getattr(fn, attr) for name, (fn, attr)
                                in bwd_counters().items()}}


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_events(fn, iters: int, names=("",)) -> list:
    """``torch.profiler``'s CUDA-kernel averages over ``iters`` calls of
    ``fn``, after one unprofiled call.  A session that recorded no kernel
    holding one of ``names`` is profiled again, twice at most: after the
    checkpoint phase's gigabytes of host I/O the card's profiler has been
    seen to return a session with the launches' API calls but without
    their kernel records."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")
                  and e.self_device_time_total > 0]
        missing = [n for n in names if not any(n in e.key for e in events)]
        if not missing:
            return events
        log(f"[profile] session {attempt + 1} recorded no kernel of "
            f"{missing}; it saw {sorted({e.key[:60] for e in prof.key_averages()})}")
    raise AssertionError(f"the profiler saw no launch of {missing}")


def device_ms(fn, iters: int, kernel: str = "") -> float:
    """Device time per call of ``fn`` from ``torch.profiler``: the summed
    time of the CUDA kernels whose name holds ``kernel`` (every kernel
    when empty), over ``iters`` calls.  Unlike CUDA events around a run
    of calls, it leaves out the host's launch pace, which sets the
    events' time when a call's device work is a few microseconds.  Late
    in the script the profiler has been seen to keep only some of a
    session's kernel records, which makes the sum too small: a session
    in which a named kernel recorded fewer than ``iters`` launches is
    profiled again, twice at most, and after that each named kernel is
    taken as launched once a call (its mean over the records kept)."""
    for attempt in range(3):
        events = [e for e in kernel_events(fn, iters, (kernel,))
                  if kernel in e.key]
        if not kernel or all(e.count >= iters for e in events):
            return sum(e.self_device_time_total for e in events) / 1e3 / iters
        log(f"[profile] device_ms session {attempt + 1} kept "
            f"{[(e.key[:40], e.count) for e in events]} launches of "
            f"{iters} calls")
    return sum(e.self_device_time_total / e.count for e in events) / 1e3


def per_launch_ms(fn, iters: int, kernels) -> dict:
    """Mean device time of one launch of each kernel whose name holds a
    string of ``kernels``, from ``torch.profiler`` over ``iters`` calls
    of ``fn``: the mean over the launches the profiler recorded."""
    events = kernel_events(fn, iters, kernels)
    out = {}
    for name in kernels:
        mine = [e for e in events if name in e.key]
        out[name.strip("<")] = (sum(e.self_device_time_total for e in mine)
                                / 1e3 / sum(e.count for e in mine))
    return out


# --------------------------------------------------------------------------
# phase 1: build
# --------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"[build] {len(paths)} kernels built in "
        f"{time.perf_counter() - t0:.2f}s: {sorted(paths)}")
    for name in sorted(paths):
        report = (_build.BUILD_DIR / f"{name}.log")
        for line in (report.read_text().splitlines() if report.exists() else []):
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def ptxas_report(source: str, kernel: str) -> dict:
    """Registers, spill bytes and static shared memory that ``ptxas -v``
    printed in the build of ``csrc/<source>.cu``, by instantiation of the
    entry functions whose mangled name holds ``kernel``."""
    import re
    from repro_torch.kernels import _build
    log_path = _build.BUILD_DIR / f"{source}.log"
    out, cur = {}, None
    for line in (log_path.read_text().splitlines() if log_path.exists()
                 else []):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            at = m.group(1).rfind(kernel)   # past the file-name prefix
            cur = m.group(1)[at:at + 56] if at >= 0 else None
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            out[cur].update(registers=int(m.group(1)),
                            static_smem=int(sm.group(1)) if sm else 0)
    return out


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def paged_inputs(dtype, device, q_len, lengths, seed, n_copies=1,
                 heads=(40, 8, 128), cache_len=CACHE_LEN, slots=R_SLOTS):
    """Main-path paged call: rows × KV-head tiles over the flattened pool
    (pool_pages · rows pages), tables of one slot's pages per lane, one
    lane a length; ``heads`` is (H, KV, Dh).  Unreferenced pages, and
    keys past each length, hold NaN."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    H, KV, DH = heads
    b = len(lengths)
    n_pages = cache_len // PAGE
    pool = slots * n_pages * b
    rng = np.random.default_rng(seed)
    perm = rng.permutation(pool)
    tables = np.full((b, n_pages), -1, np.int32)
    used = 0
    for r in range(b):
        need = -(-int(lengths[r]) // PAGE)
        tables[r, :need] = perm[used:used + need]
        used += need
    sets = []
    for _ in range(n_copies):
        q = torch.randn((b, q_len, H, DH), generator=g, device=device).to(dtype)
        kp = torch.full((pool, PAGE, KV, DH), float("nan"), device=device,
                        dtype=dtype)
        vp = kp.clone()
        for r in range(b):
            for i, pid in enumerate(tables[r][tables[r] >= 0]):
                n = min(PAGE, int(lengths[r]) - i * PAGE)
                kp[pid, :n] = torch.randn((n, KV, DH), generator=g,
                                          device=device).to(dtype)
                vp[pid, :n] = torch.randn((n, KV, DH), generator=g,
                                          device=device).to(dtype)
        sets.append((q, kp, vp))
    tab = torch.from_numpy(tables).to(device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return sets, tab, lens


def paged_cost(q, kp, tables, lengths, window, k_scale=None):
    """kernels/cost.py's count of one paged call on this run's
    ``lengths`` (a list): bytes the call must move (q, live K/V pages
    and, for int8 pools, their (page, KV head) f32 scales, tables,
    lengths, out) and the operations it does on the keys the data makes
    visible."""
    import torch
    from repro_torch.kernels import cost
    return cost.paged(q, kp, None, tables, torch.tensor(lengths),
                      window=window, k_scale=k_scale)


def bound_fields(kc) -> dict:
    """A record's bound from a kernels/cost.py count."""
    seconds, by, unit = kc.bound()
    return {"bound_ms": 1e3 * seconds, "bound_by": by, "bound_unit": unit,
            "bytes": kc.bytes, "flops": kc.flops}


def phase_kernels(device):
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    errs = {"paged_attention": 0.0, "flash_attention": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        for q_len, window, lengths in ((1, -1, [PREFILL + 5, PREFILL + 16]),
                                       (3, -1, [300, PREFILL + 16]),
                                       (1, 100, [PREFILL + 9, 77]),
                                       (3, 40, [PREFILL + 3, 129])):
            sets, tab, lens = paged_inputs(dtype, device, q_len, lengths,
                                           seed=q_len * 7 + len(lengths))
            q, kp, vp = sets[0]
            got = pa.paged_attention(q, kp, vp, tab, lens, window=window)
            want = pa.paged_attention_plain(q, kp, vp, tab, lens,
                                            window=window)
            torch.cuda.synchronize()
            e = check_close(f"paged {dtype} Q={q_len} w={window}", got, want,
                            atol, rtol)
            errs["paged_attention"] = max(errs["paged_attention"], e)
            log(f"[kernels] paged {str(dtype)[6:]} Q={q_len} window={window} "
                f"lengths={lengths}: max|err| {e:.3e} (atol {atol}, rtol {rtol})")
        g = torch.Generator(device=device).manual_seed(1)
        for b, sq, window in ((R_SLOTS * ROWS, PREFILL + N_DECODE, -1),
                              (R_SLOTS * ROWS, PREFILL + N_DECODE, 64),
                              (3, 500, -1), (2, 77, 20)):
            q = torch.randn((b, sq, 40, 128), generator=g, device=device).to(dtype)
            k = torch.randn((b, sq, 8, 128), generator=g, device=device).to(dtype)
            v = torch.randn((b, sq, 8, 128), generator=g, device=device).to(dtype)
            got = fa.flash_attention(q, k, v, causal=True, window=window)
            want = fa.flash_attention_plain(q, k, v, causal=True,
                                            window=window)
            torch.cuda.synchronize()
            e = check_close(f"flash {dtype} B={b} S={sq} w={window}", got,
                            want, atol, rtol)
            errs["flash_attention"] = max(errs["flash_attention"], e)
            log(f"[kernels] flash {str(dtype)[6:]} B={b} S={sq} H=40/KV=8 "
                f"window={window}: max|err| {e:.3e} (atol {atol}, rtol {rtol})")
    log("[kernels] " + json.dumps({"max_abs_err": errs, "tolerance": TOL}))
    return errs


def flash_inputs(dtype, device, b, s, seed, heads=(40, 8, 128)):
    """q, k, v, dO of an attention call at ``heads`` = (H, KV, Dh),
    qwen3's by default."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    h, kv, dh = heads
    shapes = ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh), (b, s, h, dh))
    return [torch.randn(sh, generator=g, device=device).to(dtype)
            for sh in shapes]


def phase_flash_bwd_kernel(device):
    """The backward kernel against ``flash_attention_bwd_plain`` on the
    same q, k, v, o, lse and dO (the forward kernel's o and lse), dK and
    dV summed over each KV head's 5 query heads; the forward kernel's lse
    against the plain forward's; two identical calls bit-equal."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        for b, sq, window in FLASH_BWD_CASES:
            q, k, v, do = flash_inputs(dtype, device, b, sq, seed=sq)
            out, lse = fa.flash_attention(q, k, v, causal=True,
                                          window=window, return_lse=True)
            _, lse_plain = fa.flash_attention_plain(
                q, k, v, causal=True, window=window, return_lse=True)
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                         window=window)
            again = fa.flash_attention_bwd(q, k, v, out, lse, do,
                                           causal=True, window=window)
            want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                causal=True, window=window)
            torch.cuda.synchronize()
            tag = f"flash bwd {str(dtype)[6:]} B={b} S={sq} w={window}"
            e_lse = check_close(f"{tag} lse", lse, lse_plain, atol, rtol)
            errs = [check_close(f"{tag} {n}", g_, w_, atol, rtol)
                    for n, g_, w_ in zip(("dq", "dk", "dv"), got, want)]
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                raise AssertionError(f"{tag}: two identical calls differ")
            err = max(err, *errs)
            log(f"[kernels] {tag} H=40/KV=8: max|err| dq {errs[0]:.3e} dk "
                f"{errs[1]:.3e} dv {errs[2]:.3e}, lse {e_lse:.3e} (atol "
                f"{atol}, rtol {rtol}); a second call bit-equal")
    return err


def paged_int8_inputs(q_dtype, device, q_len, lengths, seed, n_copies=1,
                      **shape):
    """The main-path paged call over int8 pools: :func:`paged_inputs`'s
    f32 pools quantized per (page, KV head), q in ``q_dtype``.  Pages no
    table references hold random int8 payloads and NaN scales (garbage
    the page walk must skip); keys past a length quantize from 0.
    Returns the sets ``(q, kq, vq, ks, vs)``, the tables, the lengths and
    the first set's f32 pools (NaN where unreferenced)."""
    import torch
    from repro_torch.quant import quantize_kv_page_batched
    sets, tab, lens = paged_inputs(torch.float32, device, q_len, lengths,
                                   seed, n_copies, **shape)
    live = torch.zeros(sets[0][1].shape[0], dtype=torch.bool, device=device)
    live[tab[tab >= 0].long()] = True
    g = torch.Generator(device=device).manual_seed(seed + 1)
    out = []
    for q, kp, vp in sets:
        pools = []
        for p in (kp, vp):
            qp, sc = quantize_kv_page_batched(torch.nan_to_num(p))
            qp[~live] = torch.randint(-127, 128, qp[~live].shape,
                                      generator=g, device=device,
                                      dtype=torch.int8)
            sc[~live] = float("nan")
            pools.append((qp, sc))
        (kq, ks), (vq, vs) = pools
        out.append((q.to(q_dtype), kq, vq, ks, vs))
    return out, tab, lens, sets[0][1:]


def phase_paged_int8_kernel(device):
    """The int8-pool paged kernel against its plain version at qwen3-14b
    shapes (40 heads / 8 KV heads, Dh 128, page 16), Q = 1 and 5, global
    and windowed, q in bf16 and f32, within TOL; and against the plain
    version over the unquantized pools within 0.05 (int8 rounding, the
    bound of tests/test_quant.py)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    err, err_full = 0.0, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        for q_len, window, lengths in ((1, -1, [PREFILL + 5, PREFILL + 16]),
                                       (5, -1, [300, PREFILL + 16]),
                                       (1, 100, [PREFILL + 9, 77]),
                                       (5, 40, [PREFILL + 3, 129])):
            sets, tab, lens, (kp, vp) = paged_int8_inputs(
                dtype, device, q_len, lengths, seed=q_len * 11 + window)
            q, kq, vq, ks, vs = sets[0]
            kw = dict(window=window, k_scale=ks, v_scale=vs)
            got = pa.paged_attention(q, kq, vq, tab, lens, **kw)
            want = pa.paged_attention_plain(q, kq, vq, tab, lens, **kw)
            full = pa.paged_attention_plain(q, kp, vp, tab, lens,
                                            window=window)
            torch.cuda.synchronize()
            name = f"paged int8 {str(dtype)[6:]} Q={q_len} w={window}"
            e = check_close(name, got, want, atol, rtol)
            ef = check_close(f"{name} vs unquantized", got, full, 0.05, 0.05)
            err, err_full = max(err, e), max(err_full, ef)
            log(f"[kernels] {name} lengths={lengths}: max|err| {e:.3e} "
                f"(atol {atol}, rtol {rtol}); vs the unquantized pools "
                f"{ef:.3e} (atol/rtol 0.05)")
    return err, err_full


def wkv6_inputs(dtype, device, b, s, seed, decay=None, with_state=True):
    """r, k, v, w (B, S, 32, 64) and u (32, 64) in ``dtype`` (decays in
    (0.49, 0.99), or constant ``decay``) and an f32 start state or None."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (b, s, RWKV_H, RWKV_DH)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=device)
    w = (torch.sigmoid(rnd(*shape)) * 0.5 + 0.49 if decay is None
         else torch.full(shape, decay, device=device))
    args = [rnd(*shape), 0.5 * rnd(*shape), rnd(*shape), w,
            0.1 * rnd(RWKV_H, RWKV_DH)]
    s0 = rnd(b, RWKV_H, RWKV_DH, RWKV_DH) if with_state else None
    return [a.to(dtype) for a in args], s0


def wkv6_check(name, args, s0, atol, rtol):
    """Kernel against plain on the same inputs (each advances its own
    copy of the state); returns the larger max |err| of y and s_last."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    y, s_last = wk.wkv6(*args, None if s0 is None else s0.clone())
    want_y, want_s = wk.wkv6_plain(*args, None if s0 is None else s0.clone())
    torch.cuda.synchronize()
    return max(check_close(f"{name} y", y, want_y, atol, rtol),
               check_close(f"{name} state", s_last, want_s, atol, rtol))


def phase_wkv6_kernel(device):
    """wkv6 against its plain version at the rwkv6 serve path's shapes:
    prefill (8, 1024, 32, 64) (bf16: the chunked design) and decode
    (8, 1, 32, 64) (the stepwise design), with and without a start state,
    bf16 and f32; then constant decay 0.5 over 256 steps from a state,
    where the TPU kernel's chunked form sits at the edge of f32 overflow,
    and in bf16 at the prefill shape constant decays 0.5 and 1e-8 (where
    that form overflows)."""
    import torch
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        for s in (RWKV_PREFILL, 1):
            for with_state in (False, True):
                args, s0 = wkv6_inputs(dtype, device, RWKV_ROWS, s,
                                       seed=s + with_state,
                                       with_state=with_state)
                e = wkv6_check(f"wkv6 {dtype} S={s} s0={with_state}", args,
                               s0, atol, rtol)
                err = max(err, e)
                log(f"[kernels] wkv6 {str(dtype)[6:]} B={RWKV_ROWS} S={s} "
                    f"H={RWKV_H} Dh={RWKV_DH} s0={with_state}: max|err| "
                    f"{e:.3e} (atol {atol}, rtol {rtol})")
        args, s0 = wkv6_inputs(dtype, device, RWKV_ROWS, 256, seed=7,
                               decay=0.5)
        e = wkv6_check(f"wkv6 {dtype} strong decay", args, s0, atol, rtol)
        err = max(err, e)
        log(f"[kernels] wkv6 {str(dtype)[6:]} strong decay w=0.5 S=256 "
            f"s0=True: finite, max|err| {e:.3e} (atol {atol}, rtol {rtol})")
    atol, rtol = TOL["bfloat16"]
    for decay in (0.5, 1e-8):
        args, s0 = wkv6_inputs(torch.bfloat16, device, RWKV_ROWS,
                               RWKV_PREFILL, seed=8, decay=decay)
        e = wkv6_check(f"wkv6 bf16 chunked decay {decay}", args, s0, atol,
                       rtol)
        err = max(err, e)
        log(f"[kernels] wkv6 bfloat16 chunked strong decay w={decay} "
            f"S={RWKV_PREFILL} s0=True: finite, max|err| {e:.3e} (atol "
            f"{atol}, rtol {rtol})")
    return err


def mamba_inputs(dtype, device, b, s, seed, with_state=True):
    """u, dt (B, S, 8192), B, C (B, S, 16) in ``dtype``; A = -exp(A_log)
    with the init's A_log = log(1..16) per channel, D ~ N(0, 1) (f32);
    dt the softplus of a normal; an f32 start state or None."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=device)
    a_log = torch.log(torch.arange(1, MAMBA_N + 1, dtype=torch.float32,
                                   device=device)).expand(MAMBA_CI, MAMBA_N)
    u = rnd(b, s, MAMBA_CI)
    dt = F.softplus(rnd(b, s, MAMBA_CI))
    bm, cm = rnd(b, s, MAMBA_N), rnd(b, s, MAMBA_N)
    args = [u.to(dtype), dt.to(dtype), -torch.exp(a_log).contiguous(),
            bm.to(dtype), cm.to(dtype), rnd(MAMBA_CI)]
    h0 = rnd(b, MAMBA_CI, MAMBA_N) if with_state else None
    return args, h0


def phase_mamba_kernel(device):
    """mamba_scan against its plain version at the jamba serve path's
    shapes: prefill (2, 1024, 8192, N 16) and decode (2, 1, 8192), with
    and without a start state, bf16 and f32.  Returns the largest max
    |err| and the max |err| of every case."""
    import torch
    from repro_torch.kernels import mamba_scan as ms
    cases = {}
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        for s in (JAMBA_PREFILL, 1):
            for with_state in (False, True):
                args, h0 = mamba_inputs(dtype, device, JAMBA_ROWS, s,
                                        seed=30 + s + with_state,
                                        with_state=with_state)
                name = f"{str(dtype)[6:]} S={s} h0={with_state}"
                got = ms.mamba_scan(*args, None if h0 is None else h0.clone())
                want = ms.mamba_scan_plain(*args, None if h0 is None
                                           else h0.clone())
                torch.cuda.synchronize()
                e = max(check_close(f"mamba_scan {name} y", got[0], want[0],
                                    atol, rtol),
                        check_close(f"mamba_scan {name} state", got[1],
                                    want[1], atol, rtol))
                cases[name] = e
                log(f"[kernels] mamba_scan {str(dtype)[6:]} B={JAMBA_ROWS} "
                    f"S={s} Ci={MAMBA_CI} N={MAMBA_N} h0={with_state}: "
                    f"max|err| {e:.3e} (atol {atol}, rtol {rtol})")
    return max(cases.values()), cases


def wkv6_bwd_inputs(dtype, device, seed, decay=None, zero_frac=0.0):
    """r, k, v, w, u, dy at the rwkv6 training call (TRAIN_WKV) in
    ``dtype``: decays in (0.49, 0.99), or uniform in (0, ``decay``); a
    ``zero_frac`` share of the decays exactly 0."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=device)
    shape = TRAIN_WKV
    if decay is None:
        w = torch.sigmoid(rnd(*shape)) * 0.5 + 0.49
    else:
        w = torch.rand(shape, generator=g, device=device) * decay
    if zero_frac:
        w = torch.where(torch.rand(shape, generator=g, device=device)
                        < zero_frac, 0.0, w)
    args = [rnd(*shape), 0.5 * rnd(*shape), rnd(*shape), w,
            0.1 * rnd(RWKV_H, RWKV_DH), rnd(*shape)]
    return [a.to(dtype) for a in args]


def bwd_check(name, got, want, names, tol):
    """Each gradient of a backward kernel against its plain version:
    |err| <= rel · max|want| + rtol · |want| elementwise (``tol`` =
    (rel, rtol)).  Returns {gradient: (max |err|, max |want|)}."""
    out = {}
    for n, a, b in zip(names, got, want):
        scale = float(b.float().abs().max().item())
        out[n] = (check_close(f"{name} {n}", a, b, tol[0] * scale, tol[1]),
                  scale)
    return out


def phase_wkv6_bwd_kernel(device):
    """wkv6's backward kernel against its plain backward at the rwkv6
    training call (TRAIN_WKV): bf16 at the model's range of decays with a
    quarter of them exactly 0 (where a d(log w) / w form is 0 / 0), f32
    at the model's range and at strong decay (w uniform in (0, 1e-3)),
    and twice on one input, bit for bit.  Returns ({case: {gradient:
    (max |err|, max |want|)}}, {case: the plain backward's ms}: host
    clock around one call between synchronizes, its Python loop over S
    launches ~20 small kernels a token)."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    names = ("dr", "dk", "dv", "dw", "du")
    plain_ms = {}
    cases = (("bf16 w=0", torch.bfloat16, None, 0.25),
             ("f32", torch.float32, None, 0.0),
             ("f32 strong decay", torch.float32, 1e-3, 0.0))
    out = {}
    for i, (label, dtype, decay, zero_frac) in enumerate(cases):
        args = wkv6_bwd_inputs(dtype, device, 60 + i, decay, zero_frac)
        got = wk.wkv6_bwd(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = wk.wkv6_bwd_plain(*args)
        torch.cuda.synchronize()
        plain_ms[label] = 1e3 * (time.perf_counter() - t0)
        tol = WKV6_BWD_TOL[label.split()[0]]
        out[label] = bwd_check(f"wkv6_bwd {label}", got, want, names, tol)
        log(f"[kernels] wkv6_bwd {label} {list(TRAIN_WKV)}: (max|err|, "
            f"max|plain|) {out[label]} (tolerance {tol})")
        if label == "bf16 w=0":
            again = wk.wkv6_bwd(*args)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError("wkv6_bwd: two calls on one input "
                                     "differ")
        del args, got, want
    return out, plain_ms


def mamba_bwd_inputs(device, seed):
    """u, dt, A, B, C, D, dy at the jamba training call (TRAIN_MAMBA), f32
    (the model casts the scan's inputs to f32): A from the init's A_log =
    log(1..16), dt the softplus of a normal, as mamba_inputs."""
    import torch
    args, _ = mamba_inputs(torch.float32, device, TRAIN_MAMBA[0],
                           TRAIN_MAMBA[1], seed, with_state=False)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    return args + [torch.randn(TRAIN_MAMBA[:3], generator=g, device=device)]


def phase_mamba_bwd_kernel(device):
    """mamba_scan's backward kernel against its plain backward at the
    jamba training call (TRAIN_MAMBA, f32), and twice on one input, bit
    for bit.  Returns ({gradient: (max |err|, max |want|)}, the plain
    backward's ms, timed as in :func:`phase_wkv6_bwd_kernel`)."""
    import torch
    from repro_torch.kernels import mamba_scan as ms
    args = mamba_bwd_inputs(device, 70)
    got = ms.mamba_scan_bwd(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ms.mamba_scan_bwd_plain(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    out = bwd_check("mamba_scan_bwd f32", got, want,
                    ("du", "ddt", "dA", "dB", "dC", "dD"), MAMBA_BWD_TOL)
    again = ms.mamba_scan_bwd(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("mamba_scan_bwd: two calls on one input differ")
    log(f"[kernels] mamba_scan_bwd f32 {list(TRAIN_MAMBA)}: (max|err|, "
        f"max|plain|) {out} (tolerance {MAMBA_BWD_TOL})")
    return out, plain_ms


# --------------------------------------------------------------------------
# phase 3: full-width serving
# --------------------------------------------------------------------------

def phase_serve(device, spec, plan):
    """Serve ``spec`` in bf16 through the paged engine; returns the
    session, the prompts and the generated tokens (N_DECODE + 1, B)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.engine import build_serving
    session = build_serving(spec, plan, cache_len=CACHE_LEN,
                            global_batch=R_SLOTS * ROWS,
                            compute_dtype=torch.bfloat16, page_size=PAGE,
                            device=device)
    t0 = time.perf_counter()
    session.start(SEED)
    torch.cuda.synchronize()
    log(f"[serve] {spec.name}: {spec.n_layers} layers, d {spec.d_model}, "
        f"heads {spec.n_heads}/{spec.n_kv}, Dh {spec.d_head}, d_ff "
        f"{spec.d_ff}, vocab {spec.vocab}; pp={plan.pp} R={session.n_slots} "
        f"rows={session.rows}; weights initialized in "
        f"{time.perf_counter() - t0:.2f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, spec.vocab, (R_SLOTS, ROWS, PREFILL)
                           ).astype(np.int32)
    reset_counts()
    t0 = time.perf_counter()
    nxt = session.prefill({"tokens": prompts})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    toks = [nxt]
    step_s = []
    per_step = spec.n_layers * session.n_slots
    for i in range(N_DECODE):
        before = pa.paged_attention.launches
        t0 = time.perf_counter()
        nxt = session.decode(nxt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        grew = pa.paged_attention.launches - before
        if grew != per_step:
            raise AssertionError(f"decode step {i}: paged kernel launched "
                                 f"{grew} times, expected {per_step}")
        toks.append(nxt)
    counts = read_counts()
    launches = counts["paged_attention"]
    if counts != {"paged_attention": per_step * N_DECODE,
                  "paged_attention_int8": 0, "flash_attention": 0,
                  "flash_attention_bwd": 0, "wkv6": 0, "mamba_scan": 0}:
        raise AssertionError(f"launches on the qwen3 serve path: {counts}")
    toks = torch.stack(toks).cpu().numpy()
    if not ((toks >= 0) & (toks < spec.vocab)).all():
        raise AssertionError("served token ids outside the vocabulary")
    session._alloc.check()
    ms = 1e3 * float(np.mean(step_s))
    log(f"[serve] prefill {PREFILL} tokens x {R_SLOTS * ROWS} rows: "
        f"{t_prefill:.3f}s; decode {N_DECODE} steps: {ms:.2f} ms/step, "
        f"{R_SLOTS * ROWS * 1e3 / ms:.1f} tokens/s; paged kernel launches "
        f"{launches} = {spec.n_layers} layers x R {session.n_slots} x "
        f"{N_DECODE} steps")
    prof = profile_decode_step(session, nxt, ms, kernels=("paged_attention",))
    log(f"[profile] {spec.name} bf16 decode step: {prof['device_ms']:.2f} ms "
        f"of device kernels in a {ms:.2f} ms step, idle share "
        f"{prof['idle_share']:.3f}, {prof['kernel_launches']} launches; "
        f"paged {prof['paged_attention_calls']} calls, "
        f"{prof['paged_attention_ms']:.3f} ms in all, "
        f"{1e3 * prof['paged_attention_ms_per_call']:.2f} us each (split walk "
        f"+ merge); byte bound of the schedule as run "
        f"{prof['bound_as_run_ms']:.3f} ms; top kernels (ms, calls): "
        f"{[(k['name'][:60], round(k['ms'], 3), k['calls']) for k in prof['by_kernel']]}")
    return session, prompts, toks, launches, prof, {
        "prefill_s": t_prefill, "decode_ms_per_step": ms,
        "decode_tokens_per_s": R_SLOTS * ROWS * 1e3 / ms,
        "weight_bytes": tensor_bytes(session.params),
        "pool_bytes": tensor_bytes(session.pages)}


def reference_logits(session, prompts, toks, n_last: int = 1):
    """``full_transformer`` over prompt + fed tokens; f32 logits at the
    last ``n_last`` positions, (rows, n_last, Vpad)."""
    seq = np.concatenate([prompts.reshape(-1, prompts.shape[-1]),
                          toks[:-1].T], axis=1)
    return sequence_logits(session, seq, n_last)


def sequence_logits(session, seq, n_last: int = 1):
    """``full_transformer`` over the token rows ``seq`` (rows, S) in one
    call, with the session's statics; f32 logits at the last ``n_last``
    positions, (rows, n_last, Vpad)."""
    import torch
    from repro_torch.models import lm_head
    from repro_torch.models.stage import full_transformer
    p, dev = session.params, session.device
    seq_t = torch.from_numpy(seq).to(dev)
    x = lm_head.embed_tokens(p["embed"], seq_t, session.compute_dtype)
    pos = torch.arange(seq.shape[1], device=dev).expand(seq.shape[0], -1)
    h = full_transformer(p, x, session.statics, positions=pos)
    fn = p["final_norm"]
    return torch.stack([
        lm_head.last_logits(p["head"], fn["scale"], h[:, t:t + 1],
                            norm_kind=session.spec.norm,
                            norm_bias=fn.get("bias"),
                            vocab=session.spec.vocab)
        for t in range(seq.shape[1] - n_last, seq.shape[1])], dim=1)


def phase_reference(session, prompts, toks):
    """The flash kernel's main path: full_transformer over the served
    sequence at full width."""
    import torch
    reset_counts()
    t0 = time.perf_counter()
    logits = reference_logits(session, prompts, toks)[:, -1]
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["flash_attention"]
    if counts["paged_attention"] or counts["paged_attention_int8"] \
            or counts["wkv6"] or counts["mamba_scan"] \
            or counts["flash_attention_bwd"] \
            or launches != session.spec.n_layers:
        raise AssertionError(f"flash kernel launched {launches} times, "
                             f"expected {session.spec.n_layers}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite reference logits")
    agree = float((logits.argmax(-1).cpu().numpy() == toks[-1]).mean())
    log(f"[reference] full_transformer bf16 over {prompts.shape[-1]} + "
        f"{toks.shape[0] - 1} tokens: {time.perf_counter() - t0:.3f}s, flash "
        f"kernel launches {launches}; last greedy token agrees with the "
        f"served one on {agree:.3f} of rows (bf16, "
        f"{session.spec.n_layers} layers: informative, not asserted)")
    return launches


# --------------------------------------------------------------------------
# phase 4: consistency at full width, reduced depth, fp32
# --------------------------------------------------------------------------

def phase_consistency(device, spec, plan, n_decode=6):
    import torch
    from repro_torch.serving.engine import build_serving
    sessions = {}
    rng = np.random.default_rng(SEED + 1)
    prompts = rng.integers(0, spec.vocab, (R_SLOTS, ROWS, PREFILL)
                           ).astype(np.int32)
    hidden = {}
    toks = {}
    for kind, page in (("paged", PAGE), ("dense", 0)):
        s = build_serving(spec, plan, cache_len=CACHE_LEN,
                          global_batch=R_SLOTS * ROWS,
                          compute_dtype=torch.float32, page_size=page,
                          device=device).start(SEED)
        nxt = s.prefill({"tokens": prompts})
        hs, ts = [s.last_hidden.clone()], [nxt]
        for _ in range(n_decode):
            nxt = s.decode(nxt)
            hs.append(s.last_hidden.clone())
            ts.append(nxt)
        sessions[kind], hidden[kind] = s, hs
        toks[kind] = torch.stack(ts).cpu().numpy()
    atol = rtol = 1e-4
    err_h = max(check_close(f"hidden step {i}", a, b, atol, rtol)
                for i, (a, b) in enumerate(zip(hidden["paged"],
                                               hidden["dense"])))
    paged, dense = sessions["paged"], sessions["dense"]
    n_keys = PREFILL + n_decode
    err_kv = 0.0
    for name, (kp, vp) in paged.pages.items():
        ck, cv = dense.cache[name]["kv"]
        for pool, cache in ((kp, ck), (vp, cv)):
            for m in range(R_SLOTS):
                ids = torch.from_numpy(paged._alloc.tables[m]).long()
                ids = ids[ids >= 0].to(device)
                got = pool[:, ids].transpose(1, 2).reshape(
                    pool.shape[0], ROWS, -1, *pool.shape[-2:])[:, :, :n_keys]
                err_kv = max(err_kv, check_close(
                    f"{name} slot {m} pool", got, cache[:, m, :, :n_keys],
                    atol, rtol))
    if not (paged._pos == dense._pos).all():
        raise AssertionError("paged and dense positions differ")
    logits_ref = reference_logits(paged, prompts, toks["paged"])[:, -1]
    fn = paged.params["final_norm"]
    from repro_torch.models import lm_head
    logits_eng = lm_head.last_logits(paged.params["head"], fn["scale"],
                                     paged.last_hidden, vocab=spec.vocab)
    err_l = check_close("full_transformer vs engine logits", logits_eng,
                        logits_ref, 1e-3, 1e-3)
    same = float((toks["paged"] == toks["dense"]).mean())
    log(f"[consistency] fp32 {spec.n_layers} layers at full width: hidden "
        f"max|err| {err_h:.3e}, pools vs dense caches {err_kv:.3e} "
        f"(atol/rtol {atol}); full_transformer vs engine logits "
        f"{err_l:.3e} (atol/rtol 1e-3); paged/dense tokens agree on "
        f"{same:.3f}")


# --------------------------------------------------------------------------
# phases 5-7: rwkv6-1.6b serving, reference and consistency
# --------------------------------------------------------------------------

def leaves(tree) -> list:
    """Every tensor in a tree of dicts, tuples and lists."""
    import torch
    if torch.is_tensor(tree):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for v in items if isinstance(v, (dict, tuple, list))
            or torch.is_tensor(v) for t in leaves(v)]


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a tree of dicts, tuples and lists."""
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def profile_decode_step(session, nxt, step_ms, kernels=("wkv6",)):
    """One decode step through ``launch/profile_cell.py::profile_step``:
    device time by kernel (calls and time per call of each of
    ``kernels``), the device's idle share against the unprofiled step
    time, and two byte bounds of the step over the HBM rate: the
    schedule as run (``serve_1f`` walks the R microbatches one after
    another, each reading every stage weight) and the weight-once floor;
    both add the head and the recurrent state read and written once."""
    from repro_torch.core.profiler import H100_SXM
    from repro_torch.launch.profile_cell import profile_step
    # calls of the kernel proper; time of every kernel of the wrapper
    # (the paged wrapper launches a split walk and a merge)
    labels = {}
    for name in kernels:
        labels[name], labels[f"{name}_kernel"] = name, f"{name}_kernel"
    _, rec = profile_step(session.decode, (nxt,), wall_s=step_ms / 1e3,
                          kernels=labels, top=10)
    weights = tensor_bytes(session._stage_params)
    rest = tensor_bytes(session.params["head"]) + 2 * tensor_bytes(
        session.cache)
    out = {"model": session.spec.name, "step_ms_unprofiled": step_ms,
           "device_ms": rec["device_ms"], "idle_share": rec["idle_share"],
           "stage_weight_gb": weights / 1e9, "head_and_state_gb": rest / 1e9,
           "bound_as_run_ms": 1e3 * (session.n_slots * weights + rest)
           / H100_SXM.hbm_bw,
           "bound_weight_once_ms": 1e3 * (weights + rest) / H100_SXM.hbm_bw,
           "kernel_launches": rec["kernel_launches"]}
    for name in kernels:
        calls = rec[f"{name}_kernel_launches"]
        out[f"{name}_calls"] = calls
        out[f"{name}_ms"] = rec[f"{name}_ms"]
        out[f"{name}_ms_per_call"] = rec[f"{name}_ms"] / max(1, calls)
    out["by_kernel"] = rec["by_kernel"]
    return out


def profile_prefill(session, prompts, kernel):
    """The prefill's breakdown: one more prefill of the same prompts timed
    unprofiled (warm: the first prefill also loads every kernel), then one
    through ``profile_step``: device time by kernel, the idle share
    against the warm wall time, ``kernel``'s calls, time, share and time
    per call, and the top kernels.  A prefill continues each slot's
    recurrent state and re-allocates its pages, so nothing after depends
    on these two."""
    import torch
    from repro_torch.launch.profile_cell import profile_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session.prefill({"tokens": prompts})
    torch.cuda.synchronize()
    warm_ms = 1e3 * (time.perf_counter() - t0)
    _, rec = profile_step(session.prefill, ({"tokens": prompts},),
                          wall_s=warm_ms / 1e3, kernels={kernel: kernel},
                          top=10)
    calls = rec[f"{kernel}_launches"]
    return {"model": session.spec.name, "phase": "prefill",
            "prefill_ms_warm_unprofiled": warm_ms,
            "device_ms": rec["device_ms"], "idle_share": rec["idle_share"],
            "kernel_launches": rec["kernel_launches"],
            f"{kernel}_calls": calls, f"{kernel}_ms": rec[f"{kernel}_ms"],
            f"{kernel}_share": rec[f"{kernel}_share"],
            f"{kernel}_us_per_call": 1e3 * rec[f"{kernel}_ms"] / max(1, calls),
            "by_kernel": rec["by_kernel"]}


def phase_serve_rwkv(device, spec, plan):
    """Serve rwkv6 in bf16 at full width: prefill then RWKV_DECODE steps,
    every layer's WKV through the kernel from the slot's state."""
    import torch
    from repro_torch.serving.engine import build_serving
    n_rows = RWKV_SLOTS * RWKV_ROWS
    session = build_serving(spec, plan,
                            cache_len=RWKV_PREFILL + RWKV_DECODE,
                            global_batch=n_rows,
                            compute_dtype=torch.bfloat16, device=device)
    t0 = time.perf_counter()
    session.start(SEED)
    torch.cuda.synchronize()
    state_mb = sum(t.numel() * t.element_size() for layer in
                   session.cache.values() for leaf in layer.values()
                   for t in (leaf if isinstance(leaf, tuple) else (leaf,))
                   ) / 1e6
    log(f"[serve-rwkv] {spec.name}: {spec.n_layers} layers, d "
        f"{spec.d_model}, {session.statics.rwkv.n_heads_local} heads of "
        f"{spec.rwkv.head_dim}, d_ff {spec.d_ff}, "
        f"vocab {spec.vocab}; pp={plan.pp} R={session.n_slots} rows="
        f"{session.rows}; weights initialized in "
        f"{time.perf_counter() - t0:.2f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"recurrent state {state_mb:.1f} MB")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, spec.vocab, (RWKV_SLOTS, RWKV_ROWS,
                                           RWKV_PREFILL)).astype(np.int32)
    per_pass = spec.n_layers * session.n_slots
    reset_counts()
    t0 = time.perf_counter()
    nxt = session.prefill({"tokens": prompts})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    toks, step_s = [nxt], []
    for i in range(RWKV_DECODE):
        before = read_counts()["wkv6"]
        t0 = time.perf_counter()
        nxt = session.decode(nxt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if read_counts()["wkv6"] - before != per_pass:
            raise AssertionError(f"decode step {i}: wkv6 launched "
                                 f"{read_counts()['wkv6'] - before} times, "
                                 f"expected {per_pass}")
        toks.append(nxt)
    counts = read_counts()
    designs = wkv6_designs()
    if counts != {"paged_attention": 0, "paged_attention_int8": 0,
                  "flash_attention": 0, "flash_attention_bwd": 0,
                  "wkv6": per_pass * (1 + RWKV_DECODE), "mamba_scan": 0}:
        raise AssertionError(f"launches on the rwkv6 serve path: {counts}")
    if designs != {"chunked": per_pass, "stepwise": per_pass * RWKV_DECODE}:
        raise AssertionError(f"wkv6 designs on the serve path: {designs} "
                             f"(the prefill chunked, each decode stepwise)")
    toks = torch.stack(toks).cpu().numpy()
    if not ((toks >= 0) & (toks < spec.vocab)).all():
        raise AssertionError("served token ids outside the vocabulary")
    ms = 1e3 * float(np.mean(step_s))
    log(f"[serve-rwkv] prefill {RWKV_PREFILL} tokens x {n_rows} rows: "
        f"{t_prefill:.3f}s ({n_rows * RWKV_PREFILL / t_prefill:.0f} "
        f"tokens/s); decode {RWKV_DECODE} steps: {ms:.2f} ms/step "
        f"(min {1e3 * min(step_s):.2f}, max {1e3 * max(step_s):.2f}), "
        f"{n_rows * 1e3 / ms:.1f} tokens/s; wkv6 launches "
        f"{counts['wkv6']} = {spec.n_layers} layers x R {session.n_slots} "
        f"x (1 prefill + {RWKV_DECODE} decode steps)")
    prof = profile_decode_step(session, nxt, ms)
    log(f"[profile] {spec.name} decode step: {prof['device_ms']:.2f} ms of "
        f"device kernels in a {ms:.2f} ms step, idle share "
        f"{prof['idle_share']:.3f}, {prof['kernel_launches']} launches; "
        f"wkv6 {prof['wkv6_calls']} calls, "
        f"{1e3 * prof['wkv6_ms_per_call']:.2f} us each; byte bound of the "
        f"schedule as run {prof['bound_as_run_ms']:.3f} ms, weight-once "
        f"floor {prof['bound_weight_once_ms']:.3f} ms")
    pre = profile_prefill(session, prompts, "wkv6")
    pre["prefill_s_first"] = t_prefill
    log(f"[profile] {spec.name} prefill {RWKV_PREFILL} x {n_rows}: first "
        f"{t_prefill:.3f}s, warm {pre['prefill_ms_warm_unprofiled']:.2f} "
        f"ms, {pre['device_ms']:.2f} ms of device kernels, idle share "
        f"{pre['idle_share']:.3f}, {pre['kernel_launches']} launches; wkv6 "
        f"{pre['wkv6_calls']} calls, {pre['wkv6_us_per_call']:.2f} us each, "
        f"{pre['wkv6_ms']:.3f} ms ({100 * pre['wkv6_share']:.1f}% of device "
        f"time)")
    return session, prompts, toks, counts["wkv6"], designs, prof, pre, {
        "prefill_s": t_prefill, "decode_ms_per_step": ms,
        "decode_tokens_per_s": n_rows * 1e3 / ms}


def phase_reference_rwkv(session, prompts, toks):
    """The wkv6 kernel from a zero state: full_transformer over the served
    sequence in bf16; at every generated position of every row the served
    token must be the reference's greedy token, up to bf16 near-ties
    (its reference logit within RWKV_TIE of the maximum)."""
    import torch
    reset_counts()
    t0 = time.perf_counter()
    logits = reference_logits(session, prompts, toks, n_last=toks.shape[0])
    torch.cuda.synchronize()
    counts = read_counts()
    designs = wkv6_designs()
    if counts != {"paged_attention": 0, "paged_attention_int8": 0,
                  "flash_attention": 0, "flash_attention_bwd": 0,
                  "wkv6": session.spec.n_layers, "mamba_scan": 0}:
        raise AssertionError(f"launches in rwkv6 full_transformer: {counts}")
    if designs != {"chunked": session.spec.n_layers, "stepwise": 0}:
        raise AssertionError(f"wkv6 designs in full_transformer: {designs}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite rwkv6 reference logits")
    served = torch.from_numpy(toks.T.astype(np.int64)).to(logits.device)
    greedy = logits.argmax(-1)
    agree = (greedy == served)
    gap = logits.amax(-1) - logits.gather(-1, served[..., None])[..., 0]
    top2 = logits.topk(2, dim=-1).values
    ties = (top2[..., 0] - top2[..., 1]) <= RWKV_TIE
    log(f"[reference-rwkv] full_transformer bf16 over {prompts.shape[-1]} + "
        f"{toks.shape[0] - 1} tokens x {served.shape[0]} rows: "
        f"{time.perf_counter() - t0:.3f}s, wkv6 launches {counts['wkv6']}; "
        f"greedy tokens equal the served ones at "
        f"{int(agree.sum())}/{agree.numel()} positions in "
        f"{int(agree.all(-1).sum())}/{agree.shape[0]} whole rows; the rest "
        f"are near-ties: largest logit gap of a served token below the "
        f"reference max {gap.max().item():.4f} (limit {RWKV_TIE}); "
        f"{int(ties.sum())} positions have a top-2 gap <= {RWKV_TIE}; "
        f"logits at the max up to {top2[..., 0].max().item():.3f}")
    if (gap > RWKV_TIE).any():
        raise AssertionError(
            f"served tokens are not full_transformer's greedy tokens at "
            f"{int((gap > RWKV_TIE).sum())} of {agree.numel()} positions "
            f"(logit gap up to {gap.max().item():.4f} > {RWKV_TIE})")
    return counts["wkv6"], designs


def phase_consistency_rwkv(device, spec, plan, n_decode=6):
    """fp32, full width, 2 layers: engine vs full_transformer logits."""
    import torch
    from repro_torch.models import lm_head
    from repro_torch.serving.engine import build_serving
    rng = np.random.default_rng(SEED + 1)
    prompts = rng.integers(0, spec.vocab, (RWKV_SLOTS, RWKV_ROWS,
                                           RWKV_PREFILL)).astype(np.int32)
    s = build_serving(spec, plan, cache_len=RWKV_PREFILL + n_decode,
                      global_batch=RWKV_SLOTS * RWKV_ROWS,
                      compute_dtype=torch.float32, device=device).start(SEED)
    nxt = s.prefill({"tokens": prompts})
    ts = [nxt]
    for _ in range(n_decode):
        nxt = s.decode(nxt)
        ts.append(nxt)
    toks = torch.stack(ts).cpu().numpy()
    ref = reference_logits(s, prompts, toks)[:, -1]
    fn = s.params["final_norm"]
    eng = lm_head.last_logits(s.params["head"], fn["scale"], s.last_hidden,
                              norm_kind=spec.norm, norm_bias=fn.get("bias"),
                              vocab=spec.vocab)
    err = check_close("rwkv6 full_transformer vs engine logits", eng, ref,
                      1e-3, 1e-3)
    log(f"[consistency-rwkv] fp32 {spec.n_layers} layers at full width, "
        f"pp={plan.pp}, {RWKV_SLOTS * RWKV_ROWS} rows, prefill "
        f"{RWKV_PREFILL} + {n_decode} decodes: full_transformer vs engine "
        f"logits {err:.3e} (atol/rtol 1e-3)")


# --------------------------------------------------------------------------
# phases 8-10: jamba-v0.1-52b serving, reference and consistency
# --------------------------------------------------------------------------

def jamba_cut(spec, blocks, name):
    """``spec`` at full width with only ``blocks`` (a cut of depth)."""
    return dataclasses.replace(spec, name=name, n_layers=len(blocks),
                               blocks=tuple(blocks))


def n_blocks(spec, mixer):
    return sum(b.mixer == mixer for b in spec.blocks)


def phase_serve_jamba(device, spec, plan):
    """Serve jamba in bf16 at full width and 16 of its 32 layers (all 32
    are 51.57 B parameters, 103 GB in bf16, more than the card's 80 GB;
    16 are 26.05 B with embedding and head, ~52 GB): prefill then
    JAMBA_DECODE steps.  Every Mamba layer call runs the mamba_scan
    kernel from the slot's state, every attention layer's decode the
    paged kernel; MoE capacity comes from the prefill (prefill_len)."""
    import torch
    from repro_torch.serving.engine import build_serving
    n_rows = JAMBA_SLOTS * JAMBA_ROWS
    session = build_serving(spec, plan, cache_len=JAMBA_CACHE,
                            global_batch=n_rows, compute_dtype=torch.bfloat16,
                            page_size=PAGE, prefill_len=JAMBA_PREFILL,
                            device=device)
    t0 = time.perf_counter()
    session.start(SEED)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(
        [session.params["embed"], session.params["head"],
         session._stage_params]))
    st = session.statics
    log(f"[serve-jamba] {spec.name}: {spec.n_layers} layers "
        f"({n_blocks(spec, 'mamba')} Mamba, {n_blocks(spec, 'attn')} "
        f"attention), d {spec.d_model}, heads {spec.n_heads}/{spec.n_kv} of "
        f"{spec.d_head}, d_ff {spec.d_ff}, {spec.moe.n_experts} experts "
        f"top-{spec.moe.top_k} of {spec.moe.d_expert} (capacity "
        f"{st.moe.capacity}), Mamba Ci {st.mamba.d_inner_local} N "
        f"{st.mamba.d_state} dt_rank {st.mamba.dt_rank}, vocab {spec.vocab}; "
        f"pp={plan.pp} R={session.n_slots} rows={session.rows}; "
        f"{n_params / 1e9:.2f} B parameters initialized in "
        f"{time.perf_counter() - t0:.2f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, spec.vocab, (JAMBA_SLOTS, JAMBA_ROWS,
                                           JAMBA_PREFILL)).astype(np.int32)
    per_pass = n_blocks(spec, "mamba") * session.n_slots
    per_step_paged = n_blocks(spec, "attn") * session.n_slots
    reset_counts()
    t0 = time.perf_counter()
    nxt = session.prefill({"tokens": prompts})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    toks, step_s = [nxt], []
    for i in range(JAMBA_DECODE):
        before = read_counts()
        t0 = time.perf_counter()
        nxt = session.decode(nxt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        after = read_counts()
        grew = {k: after[k] - before[k] for k in after}
        if grew != {"paged_attention": per_step_paged,
                    "paged_attention_int8": 0, "flash_attention": 0,
                    "flash_attention_bwd": 0, "wkv6": 0,
                    "mamba_scan": per_pass}:
            raise AssertionError(f"decode step {i}: launches {grew}")
        toks.append(nxt)
    counts = read_counts()
    if counts != {"paged_attention": per_step_paged * JAMBA_DECODE,
                  "paged_attention_int8": 0, "flash_attention": 0,
                  "flash_attention_bwd": 0, "wkv6": 0,
                  "mamba_scan": per_pass * (1 + JAMBA_DECODE)}:
        raise AssertionError(f"launches on the jamba serve path: {counts}")
    toks = torch.stack(toks).cpu().numpy()
    if not ((toks >= 0) & (toks < spec.vocab)).all():
        raise AssertionError("served token ids outside the vocabulary")
    session._alloc.check()
    ms = 1e3 * float(np.mean(step_s))
    log(f"[serve-jamba] prefill {JAMBA_PREFILL} tokens x {n_rows} rows: "
        f"{t_prefill:.3f}s ({n_rows * JAMBA_PREFILL / t_prefill:.0f} "
        f"tokens/s); decode {JAMBA_DECODE} steps: {ms:.2f} ms/step "
        f"(min {1e3 * min(step_s):.2f}, max {1e3 * max(step_s):.2f}), "
        f"{n_rows * 1e3 / ms:.1f} tokens/s; mamba_scan launches "
        f"{counts['mamba_scan']} = {n_blocks(spec, 'mamba')} Mamba layers x "
        f"R {session.n_slots} x (1 prefill + {JAMBA_DECODE} decode steps); "
        f"paged launches {counts['paged_attention']} = "
        f"{n_blocks(spec, 'attn')} attention layers x R {session.n_slots} x "
        f"{JAMBA_DECODE} decode steps")
    prof = profile_decode_step(session, nxt, ms,
                               kernels=("mamba_scan", "paged_attention"))
    log(f"[profile] {spec.name} decode step: {prof['device_ms']:.2f} ms of "
        f"device kernels in a {ms:.2f} ms step, idle share "
        f"{prof['idle_share']:.3f}, {prof['kernel_launches']} launches; "
        f"mamba_scan {prof['mamba_scan_calls']} calls, "
        f"{1e3 * prof['mamba_scan_ms_per_call']:.2f} us each; paged "
        f"{prof['paged_attention_calls']} calls, "
        f"{1e3 * prof['paged_attention_ms_per_call']:.2f} us each; byte "
        f"bound of the schedule as run {prof['bound_as_run_ms']:.3f} ms, "
        f"weight-once floor {prof['bound_weight_once_ms']:.3f} ms")
    pre = profile_prefill(session, prompts, "mamba_scan")
    pre["prefill_s_first"] = t_prefill
    log(f"[profile] {spec.name} prefill {JAMBA_PREFILL} x {n_rows}: first "
        f"{t_prefill:.3f}s, warm {pre['prefill_ms_warm_unprofiled']:.2f} "
        f"ms, {pre['device_ms']:.2f} ms of device kernels, idle share "
        f"{pre['idle_share']:.3f}, {pre['kernel_launches']} launches; "
        f"mamba_scan {pre['mamba_scan_calls']} calls, "
        f"{pre['mamba_scan_us_per_call']:.2f} us each, "
        f"{pre['mamba_scan_ms']:.3f} ms ({100 * pre['mamba_scan_share']:.1f}% "
        f"of device time)")
    return session, prompts, toks, counts, prof, pre, {
        "prefill_s": t_prefill, "decode_ms_per_step": ms,
        "decode_tokens_per_s": n_rows * 1e3 / ms,
        "params_b": n_params / 1e9}


def slot_prefill_logits(session, prompts):
    """Per slot, ``full_transformer`` over that slot's prompt rows (the
    same tokens per call, hence the same MoE capacity and drops as the
    engine's prefill microbatch); f32 logits at the last prompt position,
    (R · rows, Vpad) in the engine's row order."""
    import torch
    return torch.cat([sequence_logits(session, slot)[:, -1]
                      for slot in prompts])


def phase_reference_jamba(session, prompts, toks):
    """The flash and mamba_scan kernels from a zero state: per slot,
    ``full_transformer`` over the slot's prompts in bf16 with the
    engine's statics.  Its greedy token at the last prompt position must
    be the served first token, up to bf16 near-ties (its reference logit
    within RWKV_TIE of the maximum).  Decode positions are not compared:
    a longer ``full_transformer`` pass routes more tokens per call, so
    its MoE capacity and drops differ from the engine's."""
    import torch
    spec = session.spec
    reset_counts()
    t0 = time.perf_counter()
    logits = slot_prefill_logits(session, prompts)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {"paged_attention": 0, "paged_attention_int8": 0, "wkv6": 0,
            "flash_attention_bwd": 0,
            "flash_attention": n_blocks(spec, "attn") * prompts.shape[0],
            "mamba_scan": n_blocks(spec, "mamba") * prompts.shape[0]}
    if counts != want:
        raise AssertionError(f"launches in jamba full_transformer: {counts}, "
                             f"expected {want}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite jamba reference logits")
    served = torch.from_numpy(toks[0].astype(np.int64)).to(logits.device)
    agree = logits.argmax(-1) == served
    gap = logits.amax(-1) - logits.gather(-1, served[:, None])[:, 0]
    top2 = logits.topk(2, dim=-1).values
    log(f"[reference-jamba] full_transformer bf16 per slot over "
        f"{prompts.shape[1]} rows x {prompts.shape[2]} tokens: "
        f"{time.perf_counter() - t0:.3f}s, flash launches "
        f"{counts['flash_attention']}, mamba_scan launches "
        f"{counts['mamba_scan']}; greedy token at the last prompt position "
        f"equals the served first token on {int(agree.sum())}/"
        f"{agree.numel()} rows; largest logit gap of a served token below "
        f"the reference max {gap.max().item():.4f} (limit {RWKV_TIE}); top-2 "
        f"gaps {[round(v, 4) for v in (top2[:, 0] - top2[:, 1]).tolist()]}")
    if (gap > RWKV_TIE).any():
        raise AssertionError(
            f"served first tokens are not full_transformer's greedy tokens "
            f"on {int((gap > RWKV_TIE).sum())} of {agree.numel()} rows "
            f"(logit gap up to {gap.max().item():.4f} > {RWKV_TIE})")
    return counts


def phase_consistency_jamba(device, spec, plan, n_decode=6):
    """fp32, full width, 2 layers (Mamba + MoE, then attention + dense):
    the paged engine against the dense-cache engine after prefill +
    ``n_decode`` decodes (tokens, last hidden states, KV pages against
    dense caches, conv tails and SSM states, within 1e-5), and the
    paged engine's prefill logits against ``full_transformer``'s with
    the engine's statics (within 1e-3)."""
    import torch
    from repro_torch.models import lm_head
    from repro_torch.serving.engine import build_serving
    rng = np.random.default_rng(SEED + 1)
    prompts = rng.integers(0, spec.vocab, (JAMBA_SLOTS, JAMBA_ROWS,
                                           JAMBA_PREFILL)).astype(np.int32)
    sessions, hidden, toks = {}, {}, {}
    for kind, page in (("paged", PAGE), ("dense", 0)):
        s = build_serving(spec, plan, cache_len=JAMBA_CACHE,
                          global_batch=JAMBA_SLOTS * JAMBA_ROWS,
                          compute_dtype=torch.float32, page_size=page,
                          prefill_len=JAMBA_PREFILL, device=device
                          ).start(SEED)
        nxt = s.prefill({"tokens": prompts})
        if kind == "paged":
            fn = s.params["final_norm"]
            eng_logits = lm_head.last_logits(s.params["head"], fn["scale"],
                                             s.last_hidden, vocab=spec.vocab)
        hs, ts = [s.last_hidden.clone()], [nxt]
        for _ in range(n_decode):
            nxt = s.decode(nxt)
            hs.append(s.last_hidden.clone())
            ts.append(nxt)
        sessions[kind], hidden[kind] = s, hs
        toks[kind] = torch.stack(ts).cpu().numpy()
    if not (toks["paged"] == toks["dense"]).all():
        raise AssertionError("paged and dense jamba tokens differ")
    tol = 1e-5
    err_h = max(check_close(f"jamba hidden step {i}", a, b, tol, tol)
                for i, (a, b) in enumerate(zip(hidden["paged"],
                                               hidden["dense"])))
    paged, dense = sessions["paged"], sessions["dense"]
    n_keys = JAMBA_PREFILL + n_decode
    err_kv = 0.0
    for name, (kp, vp) in paged.pages.items():
        for pool, cache in zip((kp, vp), dense.cache[name]["kv"]):
            for m in range(JAMBA_SLOTS):
                ids = torch.from_numpy(paged._alloc.tables[m]).long()
                ids = ids[ids >= 0].to(device)
                got = pool[:, ids].transpose(1, 2).reshape(
                    pool.shape[0], JAMBA_ROWS, -1,
                    *pool.shape[-2:])[:, :, :n_keys]
                err_kv = max(err_kv, check_close(
                    f"jamba {name} slot {m} pool", got,
                    cache[:, m, :, :n_keys], tol, tol))
    err_ssm, h_max = 0.0, 0.0
    for name, layer in dense.cache.items():
        for i, (g, w) in enumerate(zip(paged.cache[name].get("ssm", ()),
                                       layer.get("ssm", ()))):
            err_ssm = max(err_ssm, check_close(
                f"jamba {name} ssm[{i}]", g, w, tol, tol))
            h_max = max(h_max, w.abs().max().item())
    if not (paged._pos == dense._pos).all():
        raise AssertionError("paged and dense positions differ")
    ref_logits = slot_prefill_logits(paged, prompts)
    err_l = check_close("jamba full_transformer vs engine prefill logits",
                        eng_logits, ref_logits, 1e-3, 1e-3)
    log(f"[consistency-jamba] fp32 {spec.n_layers} layers "
        f"({[(b.mixer, b.ffn) for b in spec.blocks]}) at full width, "
        f"pp={plan.pp}, {JAMBA_SLOTS * JAMBA_ROWS} rows, prefill "
        f"{JAMBA_PREFILL} + {n_decode} decodes: paged vs dense tokens equal, "
        f"hidden max|err| {err_h:.3e}, pools vs dense caches {err_kv:.3e}, "
        f"conv tails and SSM states {err_ssm:.3e} (largest state entry "
        f"{h_max:.3e}; atol/rtol {tol}); full_transformer vs engine prefill "
        f"logits {err_l:.3e} (atol/rtol 1e-3)")


# --------------------------------------------------------------------------
# phases 11-12: quantized qwen3-14b serving and consistency
# --------------------------------------------------------------------------

def phase_serve_quant(device, spec, plan, ref_toks, ref_serve):
    """Phase 3's configuration with int8 weights and int8 paged KV: the
    same seed draws the same bf16 weights, quantized leaf by leaf; every
    attention layer's decode runs the int8 page walk.  Prints memory
    against phase 3's, the step, a profiled decode step and the greedy
    agreement with phase 3's bf16 tokens (informative: random weights at
    full width are full of near-ties)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.engine import build_serving
    session = build_serving(spec, plan, cache_len=CACHE_LEN,
                            global_batch=R_SLOTS * ROWS,
                            compute_dtype=torch.bfloat16, page_size=PAGE,
                            weight_dtype="int8", kv_dtype="int8",
                            device=device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session.start(SEED)
    torch.cuda.synchronize()
    w_bytes, p_bytes = tensor_bytes(session.params), tensor_bytes(
        session.pages)
    log(f"[serve-quant] {spec.name}: {spec.n_layers} layers, int8 weights, "
        f"int8 paged KV; pp={plan.pp} R={session.n_slots} rows="
        f"{session.rows}; weights drawn in bf16 and quantized in "
        f"{time.perf_counter() - t0:.2f}s (peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB); weights "
        f"{w_bytes / 1e9:.2f} GB (bf16 {ref_serve['weight_bytes'] / 1e9:.2f} "
        f"GB, x{ref_serve['weight_bytes'] / w_bytes:.2f}), pools + scales "
        f"{p_bytes / 1e9:.3f} GB (bf16 {ref_serve['pool_bytes'] / 1e9:.3f} "
        f"GB, x{ref_serve['pool_bytes'] / p_bytes:.2f})")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, spec.vocab, (R_SLOTS, ROWS, PREFILL)
                           ).astype(np.int32)
    per_step = spec.n_layers * session.n_slots
    reset_counts()
    t0 = time.perf_counter()
    nxt = session.prefill({"tokens": prompts})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    toks, step_s = [nxt], []
    for i in range(N_DECODE):
        before = pa.paged_attention.launches_int8
        t0 = time.perf_counter()
        nxt = session.decode(nxt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        grew = pa.paged_attention.launches_int8 - before
        if grew != per_step:
            raise AssertionError(f"quantized decode step {i}: int8 paged "
                                 f"kernel launched {grew} times, expected "
                                 f"{per_step}")
        toks.append(nxt)
    counts = read_counts()
    if counts != {"paged_attention": 0,
                  "paged_attention_int8": per_step * N_DECODE,
                  "flash_attention": 0, "flash_attention_bwd": 0, "wkv6": 0,
                  "mamba_scan": 0}:
        raise AssertionError(f"launches on the quantized serve path: "
                             f"{counts}")
    toks = torch.stack(toks).cpu().numpy()
    if not ((toks >= 0) & (toks < spec.vocab)).all():
        raise AssertionError("served token ids outside the vocabulary")
    session._alloc.check()
    ms = 1e3 * float(np.mean(step_s))
    agree = float((toks == ref_toks).mean())
    log(f"[serve-quant] prefill {PREFILL} tokens x {R_SLOTS * ROWS} rows: "
        f"{t_prefill:.3f}s (bf16 {ref_serve['prefill_s']:.3f}s); decode "
        f"{N_DECODE} steps: {ms:.2f} ms/step (min {1e3 * min(step_s):.2f}, "
        f"max {1e3 * max(step_s):.2f}; bf16 "
        f"{ref_serve['decode_ms_per_step']:.2f}), "
        f"{R_SLOTS * ROWS * 1e3 / ms:.1f} tokens/s; int8 paged launches "
        f"{counts['paged_attention_int8']} = {spec.n_layers} layers x R "
        f"{session.n_slots} x {N_DECODE} steps; greedy tokens equal phase "
        f"3's bf16 tokens on {agree:.3f} of {toks.size} (not asserted)")
    prof = profile_decode_step(session, nxt, ms, kernels=("paged_attention",))
    log(f"[profile] {spec.name} int8/int8 decode step: "
        f"{prof['device_ms']:.2f} ms of device kernels in a {ms:.2f} ms "
        f"step, idle share {prof['idle_share']:.3f}, "
        f"{prof['kernel_launches']} launches; paged int8 "
        f"{prof['paged_attention_calls']} calls, "
        f"{1e3 * prof['paged_attention_ms_per_call']:.2f} us each; byte "
        f"bound of the schedule as run {prof['bound_as_run_ms']:.3f} ms; "
        f"top kernels (ms, calls): "
        f"{[(k['name'][:60], round(k['ms'], 3), k['calls']) for k in prof['by_kernel']]}")
    return counts["paged_attention_int8"], prof, {
        "prefill_s": t_prefill, "decode_ms_per_step": ms,
        "decode_tokens_per_s": R_SLOTS * ROWS * 1e3 / ms,
        "weight_bytes": w_bytes, "pool_bytes": p_bytes,
        "greedy_agreement_with_bf16": agree}


def to_device(tree, device):
    """A tree of dicts, tuples and lists with its tensors on ``device``."""
    import torch
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


def phase_consistency_quant(device, spec, plan, n_decode=4,
                            weight_dtype="int8", tag="consistency-quant"):
    """fp32, full width, 2 layers, ``weight_dtype`` weights (int8 for
    qwen3-14b's phase 12; h2o-danube3-4b's 20b runs fp32 weights, its
    120-byte int8 KV rows through the walk's 8-byte chunks) and int8
    paged KV: one
    session on the card (the int8 page walk) and the same session on the
    CPU (the plain version and the same int8 writes), started from the
    card's quantized weights, served the same prompts.  A 40-token prompt
    leaves page 2 partly filled, so every decode requantizes it.  One
    slot and four decodes keep the CPU half near 15 s: each round
    dequantizes the 2 layers and the 0.78 B-parameter head on the CPU.

    Tolerances, from one int8 step: tokens and positions equal.
    Payloads within one step: f32 sums that differ in order (cuBLAS
    against the CPU's GEMMs over d 5120) can put a value on the other
    side of a rounding edge.  Scale planes within half a step of their
    page's absmax (rtol 0.5 / 127): a scale is the page's f32 absmax /
    127, which the same f32 noise moves by far less.  Hidden states
    within half an int8 step of their own largest magnitude (max |h| /
    254): a payload one step off moves one key or value by one step of
    its page, far less than that."""
    import torch
    from repro_torch.serving.engine import build_serving
    rng = np.random.default_rng(SEED + 2)
    prompts = rng.integers(0, spec.vocab, (QUANT_SLOTS, ROWS, QUANT_PREFILL)
                           ).astype(np.int32)
    plan = plan.with_(decode_microbatches=QUANT_SLOTS)
    kw = dict(cache_len=QUANT_CACHE, global_batch=QUANT_SLOTS * ROWS,
              compute_dtype=torch.float32, page_size=PAGE,
              weight_dtype=weight_dtype, kv_dtype="int8")
    card = build_serving(spec, plan, device=device, **kw).start(SEED)
    host = build_serving(spec, plan, device="cpu", **kw).reset_state()
    host.set_params(to_device(card.params, "cpu"))
    runs, times = {}, {}
    for name, s in (("cuda", card), ("cpu", host)):
        reset_counts()
        t0 = time.perf_counter()
        nxt = s.prefill({"tokens": prompts})
        hs, ts = [s.last_hidden.cpu()], [nxt.cpu()]
        for _ in range(n_decode):
            nxt = s.decode(nxt)
            hs.append(s.last_hidden.cpu())
            ts.append(nxt.cpu())
        times[name] = time.perf_counter() - t0
        runs[name] = (torch.stack(ts).numpy(), hs)
        if name == "cuda":
            counts = read_counts()
    want = spec.n_layers * QUANT_SLOTS * n_decode
    if counts["paged_attention_int8"] != want or counts["paged_attention"]:
        raise AssertionError(f"{tag}: launches {counts}, {want} int8 walks "
                             "expected")
    if not (runs["cuda"][0] == runs["cpu"][0]).all():
        raise AssertionError("quantized tokens differ between the card and "
                             "the CPU")
    if not (card._pos == host._pos).all():
        raise AssertionError("quantized positions differ")
    if not (card._alloc.tables == host._alloc.tables).all():
        raise AssertionError("page tables differ")
    n_diff, n_all, err_s = 0, 0, 0.0
    for name, pools in host.pages.items():
        got = card.pages[name]
        for g, w in zip(got[:2], pools[:2]):
            d = (g.cpu().int() - w.int()).abs()
            if d.max() > 1:
                raise AssertionError(f"{name} payloads differ by "
                                     f"{int(d.max())} int8 steps")
            n_diff += int((d > 0).sum())
            n_all += d.numel()
        for i, (g, w) in enumerate(zip(got[2:], pools[2:])):
            check_close(f"{name} scale plane {i}", g.cpu(), w, 0.0,
                        SCALE_RTOL)
            err_s = max(err_s, ((g.cpu() - w).abs() / w.abs()).max().item())
    h_max = max(h.abs().max().item() for h in runs["cpu"][1])
    h_tol = h_max / 254
    err_h = max(check_close(f"quantized hidden step {i}", a, b, h_tol, 0.0)
                for i, (a, b) in enumerate(zip(runs["cuda"][1],
                                               runs["cpu"][1])))
    log(f"[{tag}] {spec.name} fp32 {spec.n_layers} layers at full width, "
        f"{weight_dtype} weights + int8 paged KV (Dh {spec.d_head}), "
        f"{QUANT_SLOTS} x {ROWS} rows, "
        f"prefill {QUANT_PREFILL} + {n_decode} decodes, card vs CPU: tokens "
        f"and positions equal; payloads one step apart at {n_diff} of "
        f"{n_all} entries ({n_diff / n_all:.2e}); scale planes max rel err "
        f"{err_s:.3e} (rtol {SCALE_RTOL:.3e}); hidden max|err| {err_h:.3e} (atol {h_tol:.3e} = max "
        f"|h| {h_max:.3f} / 254); card {times['cuda']:.2f}s, CPU "
        f"{times['cpu']:.2f}s")
    return {"payload_share_one_step": n_diff / n_all, "scale_err": err_s,
            "hidden_err": err_h, "hidden_tol": h_tol,
            "cpu_s": times["cpu"], "card_s": times["cuda"],
            "decodes": n_decode, "tokens_equal": True,
            "int8_launches": counts["paged_attention_int8"]}


# --------------------------------------------------------------------------
# phases 13-14: training qwen3-14b and its consistency
# --------------------------------------------------------------------------

def train_args(extra, arch="qwen3-14b"):
    from repro_torch.launch import train
    return train.parser().parse_args(["--arch", arch, "--device", "cuda",
                                      "--seed", str(SEED), *extra])


def build_train(args, grid=None, obs=None, tp=1):
    """launch/train.py's build for the parsed arguments at tensor degree
    ``tp``: the full spec's plan cuts qwen3-14b's stages over 8 tensor
    ranks (16 cards), and the phases run one process a stage (tp 1), or
    phase 21's tensor ranks (tp 2)."""
    from repro_torch.launch import train
    spec, plan, opt = train.make_plan(args)
    return train.build(args, grid, (spec, plan.with_(tp=tp), opt), obs)


FLASH_KERNELS = (("flash_fwd", "flash_attention_bf16_kernel"),
                 ("flash_bwd", "flash_bwd_"))


def profile_round(bundle, state, batch, round_s, kernels=FLASH_KERNELS):
    """One round through ``launch/profile_cell.py::profile_step``: device
    time by kernel, the idle share against an unprofiled warm round's
    time, and the calls and time of each of ``kernels`` ((label,
    substring of the kernel names)): by default the flash kernels."""
    from repro_torch.launch.profile_cell import profile_step
    (state, metrics), rec = profile_step(bundle.train_step, (state, batch),
                                         wall_s=round_s,
                                         kernels=dict(kernels))
    out = {"model": bundle.spec.name, "phase": "train_round",
           "schedule": f"{bundle.sched.name}/{bundle.plan.stash_mode}",
           "round_ms_warm_unprofiled": 1e3 * round_s, **rec}
    return state, metrics, out


def train_rounds(bundle, state, batches):
    """The rounds of ``batches`` through ``bundle.train_step`` with the
    plain attention versions refused, the last under torch.profiler;
    (state, losses, round seconds, profile, launches).  Every attention
    layer's forward through the flash kernel three times a microbatch
    (F, the B recompute and the checkpoint's recompute) and its backward
    through the backward kernel; the losses finite."""
    import torch
    reset_counts()
    losses, round_s, prof = [], [], None
    with plain_attention_refused():
        for r, batch in enumerate(batches):
            if r == len(batches) - 1:
                state, metrics, prof = profile_round(bundle, state, batch,
                                                     round_s[-1])
            else:
                t0 = time.perf_counter()
                state, metrics = bundle.train_step(state, batch)
                torch.cuda.synchronize()
                round_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
    counts = read_counts()
    per_round = bundle.spec.n_layers * bundle.plan.microbatches
    want = {"paged_attention": 0, "paged_attention_int8": 0, "wkv6": 0,
            "mamba_scan": 0,
            "flash_attention": 3 * per_round * len(batches),
            "flash_attention_bwd": per_round * len(batches)}
    name = bundle.sched.name
    if counts != want:
        raise AssertionError(f"launches on the {name} training path: "
                             f"{counts}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite training loss: {losses}")
    return state, losses, round_s, prof, counts


@contextlib.contextmanager
def plain_attention_refused():
    """The plain attention versions raise while the block runs: on the
    card nothing of the training path may take them."""
    from repro_torch.kernels import flash_attention as fa
    saved = fa.flash_attention_plain, fa.flash_attention_bwd_plain

    def refuse(*_, **__):
        raise AssertionError("a plain attention version ran on the card's "
                             "training path")
    fa.flash_attention_plain = fa.flash_attention_bwd_plain = refuse
    try:
        yield
    finally:
        fa.flash_attention_plain, fa.flash_attention_bwd_plain = saved


def phase_train(device):
    """qwen3-14b at full width, its first TRAIN_LAYERS layers, trained as
    a train_4k cell (``launch/cell.py::build_cell``): bf16, the config's
    Adam, 1f1b / stash, pp = 2, R = TRAIN_R microbatches of TRAIN_ROWS x
    TRAIN_SEQ, TRAIN_ROUNDS rounds on the SyntheticLM stream; the last
    round through ``profile_step``.  Every attention layer's forward
    through the flash kernel (three times a microbatch with remat: F,
    the B recompute and the checkpoint's recompute) and its backward
    through the backward kernel.  Then one more round's op count
    (``launch/op_analysis.py``) and its roofline terms beside the model
    FLOPs and the measured ``mfu`` (``launch/roofline.py``), and the
    TRAIN_WITNESSES runs."""
    import torch
    from repro_torch import configs
    from repro_torch.core.schedule import plan_kwargs_for_schedule
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.cell import build_cell
    from repro_torch.launch.op_analysis import count
    from repro_torch.launch.train import make_loader
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = configs.get("qwen3-14b")
    cell = build_cell("qwen3-14b", "train_4k", plan=cfg.PLAN.with_(
        **plan_kwargs_for_schedule("1f1b", stash_mode="stash")),
        layers=TRAIN_LAYERS, global_batch=TRAIN_R * TRAIN_ROWS,
        device=device, seed=SEED)
    spec, bundle, state = cell.spec, cell.bundle, cell.args[0]
    plan = bundle.plan
    torch.cuda.synchronize()
    log(f"[train] {spec.name}: d {spec.d_model}, heads {spec.n_heads}/"
        f"{spec.n_kv}, Dh {spec.d_head}, d_ff {spec.d_ff}, vocab "
        f"{spec.vocab}; {bundle.sched.name} {plan.stash_mode} pp={plan.pp} "
        f"V={bundle.sched.stash_slots} R={plan.microbatches} remat="
        f"{plan.remat}; state initialized "
        f"in {time.perf_counter() - t0:.2f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    loader = make_loader(spec, bundle, SEED)
    batches = [cell.args[1]] + [loader.get(r)
                                for r in range(1, TRAIN_ROUNDS)]
    # finite losses; the falling loss is asked of the one_batch witness
    # below (at the config's constant Adam lr the loss on fresh data rises)
    state, losses, round_s, prof, counts = train_rounds(bundle, state,
                                                        batches)
    # one more round counted: its work against the warm round's time
    t_count = time.perf_counter()
    op = count(bundle.train_step, state, batches[0])
    t_count = time.perf_counter() - t_count
    shape = configs.Shape("train_4k", "train", TRAIN_SEQ,
                          TRAIN_R * TRAIN_ROWS)
    roof = RL.from_counts(
        op, arch="qwen3-14b", shape="train_4k", cards="1",
        plan=f"pp{plan.pp}xtp1", model_flops_per_device=(
            RL.model_flops_per_device(spec, shape, 1)),
        step_seconds_measured=round_s[1])
    tokens = plan.microbatches * bundle.microbatch_size * TRAIN_SEQ
    out = {"model": spec.name, "layers": spec.n_layers,
           "schedule": f"{bundle.sched.name}/{plan.stash_mode}",
           "pp": plan.pp, "microbatches": plan.microbatches,
           "rows": bundle.microbatch_size, "seq_len": TRAIN_SEQ,
           "optimizer": "adam", "round_s_first": round_s[0],
           "round_s_warm": round_s[1],
           "tokens_per_s": tokens / round_s[1],
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss_per_round": losses,
           "flash_attention_launches": counts["flash_attention"],
           "flash_attention_bwd_launches": counts["flash_attention_bwd"],
           "model_flops": roof.model_flops, "mfu": roof.mfu,
           "op_count": {"flops": op.flops, "hbm_bytes": op.hbm_bytes,
                        "compute_ms": 1e3 * roof.compute_s,
                        "memory_ms": 1e3 * roof.memory_s,
                        "dominant": roof.dominant,
                        "useful_ratio": roof.useful_ratio,
                        "roofline_fraction": roof.roofline_fraction,
                        "kernel_calls": op.kernel_calls,
                        "kernel_flops": op.kernel_flops,
                        "kernel_bytes": op.kernel_bytes,
                        "aten_ops": op.aten_ops, "count_s": t_count}}
    log(f"[train] op count of a round ({t_count:.1f}s): "
        f"{op.flops:.4e} FLOPs, {op.hbm_bytes:.4e} B; compute "
        f"{1e3 * roof.compute_s:.1f} ms, memory {1e3 * roof.memory_s:.1f} "
        f"ms ({roof.dominant}); model FLOPs {roof.model_flops:.4e}, mfu "
        f"{roof.mfu:.4f} at the warm round's {round_s[1]:.3f}s; kernel "
        f"calls {op.kernel_calls}")
    log(f"[train] {TRAIN_ROUNDS} rounds of {tokens} tokens: first "
        f"{round_s[0]:.3f}s, warm {round_s[1]:.3f}s "
        f"({out['tokens_per_s']:.0f} tokens/s), peak "
        f"{out['peak_allocated_gb']:.1f} GB; loss per round "
        f"{[round(x, 4) for x in losses]}; flash launches "
        f"{counts['flash_attention']} forward = 3 x {spec.n_layers} layers x "
        f"R {plan.microbatches} x {TRAIN_ROUNDS} rounds (remat), "
        f"{counts['flash_attention_bwd']} backward")
    log(f"[profile] {spec.name} train round: {prof['device_ms']:.1f} ms of "
        f"device kernels in a {1e3 * round_s[1]:.1f} ms round, idle share "
        f"{prof['idle_share']:.3f}, {prof['kernel_launches']} launches; "
        f"flash fwd {prof['flash_fwd_ms']:.1f} ms, bwd "
        f"{prof['flash_bwd_ms']:.1f} ms; top kernels (ms, calls): "
        f"{[(k['name'][:50], round(k['ms'], 1), k['calls']) for k in prof['by_kernel']]}")
    del state, bundle, batches, cell
    torch.cuda.empty_cache()
    out["witnesses"] = {}
    for name, flags, one_batch in TRAIN_WITNESSES:
        with plain_attention_refused():
            w = train_witness(device, flags, one_batch)
        out["witnesses"][name] = w
        log(f"[train] witness {name} ({w['schedule']}, adam lr {w['lr']}, "
            f"{'one batch repeated' if one_batch else 'the stream'}): loss "
            f"per round {[round(x, 4) for x in w['loss_per_round']]}")
        falls = all(b < a for a, b in zip(w["loss_per_round"],
                                          w["loss_per_round"][1:]))
        if not all(np.isfinite(w["loss_per_round"])) or (one_batch
                                                         and not falls):
            raise AssertionError(f"witness {name}: loss per round "
                                 f"{w['loss_per_round']}" +
                                 (", expected to fall" if one_batch else ""))
    return out, prof, counts["flash_attention"], counts["flash_attention_bwd"]


def phase_train_flags(extra):
    """The launcher's flags of phase 13's shape, plus ``extra``."""
    return ["--layers", str(TRAIN_LAYERS), "--pp", "2", "--microbatches",
            str(TRAIN_R), "--global-batch", str(TRAIN_R * TRAIN_ROWS),
            "--seq-len", str(TRAIN_SEQ), *extra]


def train_witness(device, flags, one_batch):
    """TRAIN_ROUNDS rounds at phase 13's shape with the launcher's
    ``flags``, on the stream or on its first batch every round."""
    import torch
    from repro_torch.data.pipeline import Loader, SyntheticLM
    from repro_torch import configs
    from repro_torch.launch import train
    args = train_args(phase_train_flags(flags))
    spec, bundle = build_train(args)
    lr = args.lr or configs.get(args.arch).OPTIMIZER[1]
    state = bundle.init_state(torch.Generator(device).manual_seed(SEED))
    loader = Loader(SyntheticLM(spec.vocab, TRAIN_SEQ, seed=SEED),
                    bundle.plan.microbatches, bundle.microbatch_size, device)
    losses = []
    for r in range(TRAIN_ROUNDS):
        state, metrics = bundle.train_step(state, loader.get(0 if one_batch
                                                             else r))
        losses.append(float(metrics["loss"]))
    out = {"schedule": f"{bundle.sched.name}/{bundle.plan.stash_mode}",
           "lr": lr, "one_batch": one_batch,
           "loss_per_round": losses}
    del state, bundle
    torch.cuda.empty_cache()
    return out


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for _, t in tree_leaves(tree) if hasattr(t, "numel"))


def phase_train_virtual(device, name, mode):
    """Phase 13's shape through a virtual-stage schedule (pp = 2, v =
    V_STAGES: 4 chunks of one layer) from the launcher's builder:
    TRAIN_ROUNDS rounds on the stream, the last under torch.profiler;
    every attention forward through the flash kernel and every backward
    through the backward kernel."""
    import torch
    from repro_torch.core.schedule import weighted_round_time
    from repro_torch.data.pipeline import Loader, SyntheticLM
    from repro_torch.launch import train
    spec, bundle = build_train(train_args(phase_train_flags(
        ["--schedule", name, "--stash-mode", mode, "--virtual-stages",
         str(V_STAGES)])))
    plan, sched = bundle.plan, bundle.sched
    torch.cuda.reset_peak_memory_stats()
    state = bundle.init_state(torch.Generator(device).manual_seed(SEED))
    torch.cuda.synchronize()
    ring_gb = tree_bytes(state["stash"].get("ring", {})) / 1e9
    log(f"[train] {spec.name} {sched.name} {plan.stash_mode} pp={plan.pp} "
        f"v={plan.virtual_stages} R={plan.microbatches}: "
        f"{sched.n_ticks} ticks, ring V={sched.stash_slots} x "
        f"{sched.n_chunks} chunks ({ring_gb:.2f} GB), residual slots "
        f"{sched.resid_slots}; state "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    loader = Loader(SyntheticLM(spec.vocab, TRAIN_SEQ, seed=SEED),
                    plan.microbatches, bundle.microbatch_size, device)
    batches = [loader.get(r) for r in range(TRAIN_ROUNDS)]
    state, losses, round_s, prof, counts = train_rounds(bundle, state,
                                                        batches)
    tokens = plan.microbatches * bundle.microbatch_size * TRAIN_SEQ
    _, bubble = weighted_round_time(sched)
    out = {"model": spec.name, "layers": spec.n_layers,
           "schedule": f"{sched.name}/{plan.stash_mode}", "pp": plan.pp,
           "virtual_stages": plan.virtual_stages,
           "microbatches": plan.microbatches,
           "rows": bundle.microbatch_size, "seq_len": TRAIN_SEQ,
           "optimizer": "adam", "n_ticks": sched.n_ticks,
           "predicted_bubble": bubble, "stash_slots": sched.stash_slots,
           "resid_slots": sched.resid_slots, "ring_gb": ring_gb,
           "round_s_first": round_s[0], "round_s_warm": round_s[1],
           "tokens_per_s": tokens / round_s[1],
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss_per_round": losses,
           "memcpy_dtod_ms": prof["memcpy_dtod_ms"],
           "device_ms": prof["device_ms"], "idle_share": prof["idle_share"],
           "flash_attention_launches": counts["flash_attention"],
           "flash_attention_bwd_launches": counts["flash_attention_bwd"]}
    log(f"[train] {name}: first {round_s[0]:.3f}s, warm {round_s[1]:.3f}s "
        f"({out['tokens_per_s']:.0f} tokens/s), peak "
        f"{out['peak_allocated_gb']:.1f} GB, predicted bubble {bubble:.3f}; "
        f"loss per round {[round(x, 4) for x in losses]}; device "
        f"{prof['device_ms']:.1f} ms, idle {prof['idle_share']:.3f}, "
        f"device-to-device copies {prof['memcpy_dtod_ms']:.1f} ms in "
        f"{prof['memcpy_dtod_calls']} calls; flash launches "
        f"{counts['flash_attention']} forward, "
        f"{counts['flash_attention_bwd']} backward")
    del state, bundle, batches
    torch.cuda.empty_cache()
    return out, prof, counts


def tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def phase_train_consistency(device):
    """fp32 at full width: at CONS_LAYERS layers, pp = 2, each of the four
    single-chunk schedules, and at CONS_VIRTUAL_LAYERS layers the two
    virtual-stage schedules (pp = 2, v = V_STAGES): the executor
    (core/pipeline.py) against the sequential oracle (core/reference.py)
    over CONS_ROUNDS rounds from one seed, losses and every state tensor
    bit for bit.  SGD with momentum.  The executor's state is reduced to
    digests and freed before the oracle runs; at 4 layers the oracle
    also consumes its input round by round (``donate``): a full-width
    fp32 state with the async schedule's ring is 49 GB, and a round's
    input and output do not fit the card side by side.  Deterministic
    algorithms for the phase (the embedding's scatter-add)."""
    import os
    import torch
    from repro_torch.launch.train import cut_layers
    from repro_torch.optim import SGDM
    from repro_torch import configs
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    cfg = configs.get("qwen3-14b")
    opt = SGDM(lr=0.01)
    base = cfg.PLAN.with_(tp=1, pp=2, microbatches=CONS_R)
    cases = [(mode, CONS_LAYERS, base.with_(stash_mode=mode), False)
             for mode in ("stash", "vertical", "flush", "2bw")]
    cases += [(name, CONS_VIRTUAL_LAYERS,
               base.with_(stash_mode=mode, schedule=name,
                          virtual_stages=V_STAGES), True)
              for name, mode in TRAIN_VIRTUAL]
    out = {}
    try:
        for label, n_layers, plan, donate in cases:
            out[label] = executor_equals_oracle(
                device, label, cut_layers(cfg.full_spec(), n_layers), plan,
                opt, donate)
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def executor_equals_oracle(device, label, spec, plan, opt, donate=False):
    """CONS_ROUNDS fp32 rounds of R = CONS_R x 1 row x CONS_SEQ text tokens
    (and a frontend's patches or frames) through the executor
    (core/pipeline.py), its state reduced to :func:`digest`s on the card
    and freed, then through the sequential oracle (core/reference.py,
    consuming its input with ``donate``) from the same seed: losses and
    every state tensor bit for bit (their 64-bit digests, as 17b, 18 and
    21c compare states; a single element that differs changes its
    tensor's).  Returns the case's record."""
    import torch
    from repro_torch.core.pipeline import build_pipeline
    from repro_torch.core.reference import (reference_init_state,
                                            reference_train_step)
    from repro_torch.launch.train import make_loader
    t0 = time.perf_counter()
    n_patch = spec.n_patches if spec.frontend == "vision" else 0
    bundle = build_pipeline(spec, plan, seq_len=n_patch + CONS_SEQ,
                            global_batch=CONS_R, optimizer=opt,
                            compute_dtype=torch.float32, device=device)
    # the SyntheticLM stream from SEED (and a frontend's stub inputs)
    loader = make_loader(spec, bundle, SEED)
    batches = [loader.get(r) for r in range(CONS_ROUNDS)]
    state = bundle.init_state(torch.Generator(device).manual_seed(SEED))
    e_loss = []
    for batch in batches:
        state, m = bundle.train_step(state, batch)
        e_loss.append(m["loss"].item())
    executor = state_digests(state)
    del state, bundle
    torch.cuda.empty_cache()
    ref = reference_init_state(spec, plan, opt,
                               torch.Generator(device).manual_seed(SEED),
                               torch.float32)
    o_loss = []
    for batch in batches:
        ref, m = reference_train_step(spec, plan, ref, batch, opt,
                                      donate=donate)
        o_loss.append(m["loss"].item())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    oracle = state_digests(ref)
    n_bytes = sum(t.numel() * t.element_size()
                  for _, t in tree_leaves(ref) if torch.is_tensor(t))
    del ref
    torch.cuda.empty_cache()
    if e_loss != o_loss:
        raise AssertionError(f"{label}: executor losses {e_loss} != oracle "
                             f"{o_loss}")
    if list(executor) != list(oracle):
        raise AssertionError(f"{label}: state trees differ")
    bad = [name for name in oracle if executor[name] != oracle[name]]
    if bad:
        raise AssertionError(f"{label}: {bad[:6]} differ between executor "
                             "and oracle")
    rec = {"layers": spec.n_layers, "losses": e_loss,
           "state_gb": n_bytes / 1e9, "seconds": time.perf_counter() - t0}
    log(f"[consistency-train] fp32 {spec.n_layers} layers at full width "
        f"({spec.name}), {label}, pp={plan.pp}, v={plan.virtual_stages}, "
        f"R={CONS_R} x seq {CONS_SEQ}, {CONS_ROUNDS} rounds: executor == "
        f"oracle bit for bit (losses {e_loss}, {n_bytes / 1e9:.2f} GB of "
        f"state, peak {peak_gb:.1f} GB), {rec['seconds']:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    return rec


# --------------------------------------------------------------------------
# phase 15: PipeDream's profiling step and the planner on the card
# --------------------------------------------------------------------------

def phase_plan(device):
    """One qwen3-14b block's forward at full width (1 row x PLAN_SEQ,
    bf16, the flash kernel) and the head (final norm, logits, loss) timed
    through profile_measured, scaled to the train_4k microbatch; the 40
    layers' and the head's profiles from them (bytes and parameters from
    profile_analytic); plan_search on analytic and on measured profiles
    over PLAN_AXIS H100s.  Both must return a plan that fits."""
    import torch
    from repro_torch import configs
    from repro_torch.core import profiler as prof
    from repro_torch.core.partitioner import plan_search
    from repro_torch.core.versioning import tree_chunk
    from repro_torch.launch.train import cut_layers
    from repro_torch.models import lm_head
    from repro_torch.models.init import init_params
    from repro_torch.models.stage import make_statics, stage_fwd
    cfg = configs.get("qwen3-14b")
    full = cfg.full_spec()
    one = cut_layers(full, 1)
    plan1 = cfg.PLAN.with_(pp=1, tp=1)
    bf16 = torch.bfloat16
    gen = torch.Generator(device).manual_seed(SEED)
    params = init_params(one, plan1, gen, bf16)
    statics = make_statics(one, plan1, tokens_per_mb=PLAN_SEQ)
    w = tree_chunk(params["stages"], 0)
    x = torch.randn((1, PLAN_SEQ, full.d_model), generator=gen,
                    device=device).to(bf16)
    pos = torch.arange(PLAN_SEQ, device=device)[None]
    labels = torch.randint(0, full.vocab, (1, PLAN_SEQ), generator=gen,
                           device=device)

    def block():
        with torch.no_grad():
            stage_fwd(w, x, statics, positions=pos,
                      windows=params["layer_windows"][0],
                      thetas=params["layer_thetas"][0])

    def head():
        with torch.no_grad():
            lm_head.head_loss(params["head"], params["final_norm"]["scale"],
                              x, labels, norm_kind=full.norm,
                              vocab=full.vocab)

    rows = PLAN_BATCH // PLAN_R                   # microbatch rows
    mb_tokens = rows * PLAN_SEQ
    analytic = prof.profile_analytic(full, prof.H100_SXM,
                                     minibatch_tokens=mb_tokens)
    reset_counts()
    t0 = time.perf_counter()
    meas_block, meas_head = prof.profile_measured(
        [block, head], ["block", "head"],
        [analytic[1].a_bytes, analytic[-1].a_bytes],
        [analytic[1].w_params, analytic[-1].w_params])
    prof_s = time.perf_counter() - t0
    counts = read_counts()
    # warmup 2 + iters 10 block calls, one attention layer each
    want = {"paged_attention": 0, "paged_attention_int8": 0, "wkv6": 0,
            "mamba_scan": 0, "flash_attention": 12, "flash_attention_bwd": 0}
    if counts != want:
        raise AssertionError(f"launches while profiling: {counts}, "
                             f"expected {want}")
    scale = lambda p, name: dataclasses.replace(         # noqa: E731
        p, name=name, t_fwd=p.t_fwd * rows, t_bwd=p.t_bwd * rows)
    measured = ([analytic[0]]
                + [scale(meas_block, f"block_{i}")
                   for i in range(full.n_layers)]
                + [scale(meas_head, "head")])
    ratio = measured[1].t_fwd / analytic[1].t_fwd
    out = {"model": full.name, "layers": full.n_layers,
           "seq_len": PLAN_SEQ, "global_batch": PLAN_BATCH,
           "microbatches": PLAN_R, "model_axis": PLAN_AXIS,
           "hardware": dataclasses.asdict(prof.H100_SXM),
           "block_fwd_ms_1x4096": 1e3 * meas_block.t_fwd,
           "head_fwd_ms_1x4096": 1e3 * meas_head.t_fwd,
           "block_fwd_ms_microbatch_analytic": 1e3 * analytic[1].t_fwd,
           "block_fwd_measured_over_analytic": ratio,
           "head_fwd_measured_over_analytic":
               measured[-1].t_fwd / analytic[-1].t_fwd,
           "profile_seconds": prof_s}
    log(f"[plan] block forward {1e3 * meas_block.t_fwd:.3f} ms, head "
        f"{1e3 * meas_head.t_fwd:.3f} ms at 1 x {PLAN_SEQ} tokens "
        f"(profile_measured, {prof_s:.2f}s); x {rows} rows: block "
        f"{1e3 * measured[1].t_fwd:.2f} ms against the analytic "
        f"{1e3 * analytic[1].t_fwd:.2f} ms (measured / analytic {ratio:.3f})")
    for label, profiles in (("analytic", analytic), ("measured", measured)):
        choice = plan_search(full, cfg.PLAN.with_(microbatches=PLAN_R),
                             PLAN_AXIS, prof.H100_SXM,
                             minibatch_tokens=mb_tokens, profiles=profiles)
        if not choice.feasible or not choice.memory.fits(80e9):
            raise AssertionError(f"plan_search ({label}) chose a plan that "
                                 f"does not fit: {choice.describe()}")
        out[label] = {"describe": choice.describe(),
                      "memory": str(choice.memory),
                      "round_ms": 1e3 * choice.round_time,
                      "bubble": choice.bubble_fraction,
                      "plan": {k: getattr(choice.plan, k) for k in (
                          "pp", "tp", "schedule", "stash_mode",
                          "virtual_stages", "microbatches")}}
        log(f"[plan] plan_search ({label} profiles), {full.name} "
            f"{full.n_layers} layers at train_4k over {PLAN_AXIS} H100s: "
            f"{choice.describe()}")
        log(f"[plan]   {choice.memory}")
    del params, w, x
    torch.cuda.empty_cache()
    return out, counts


# --------------------------------------------------------------------------
# phase 16: the fault-tolerant driver and its checkpoints
# --------------------------------------------------------------------------

def phase_driver(device):
    """TrainDriver through the training entry point's flags, DRIVER_ROUNDS
    rounds uninterrupted and without checkpoints, under deterministic
    algorithms: the reference of phase 18b, which runs the same driver
    and faults (a failure before round DRIVER_FAIL, a crash in the
    middle of round DRIVER_TORN's save) over two ranks and holds every
    rank's final state and the last rounds' losses to this run's bit
    for bit.  One process runs the same checkpoint and restart code as
    a grid of one rank; its faulty run was this phase's until the time
    limit wanted its ~110 s of checkpoint I/O (tests/test_torch_checkpoint
    .py holds it on the CPU).  Returns (the driver record, launches, this
    run's losses and each stage's rows' digests)."""
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch.core.versioning import rank_state
    from repro_torch.launch import train
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        reset_counts()
        args = train_args(driver_flags(tmp))
        args.ckpt_every = DRIVER_ROUNDS + 1        # saves nothing
        spec, bundle = build_train(args)
        driver = train.make_driver(args, spec, bundle, args.ckpt)
        state = bundle.init_state(torch.Generator(device).manual_seed(SEED))
        state, step = driver.run(state, args.steps)
        if step != DRIVER_ROUNDS:
            raise AssertionError(f"driver stopped at round {step}")
        counts = read_counts()
        losses = [m["loss"] for m in driver.metrics_log]
        ref_rows = {"losses": losses,
                    "digests": [state_digests(rank_state(state, bundle.sched,
                                                         s))
                                for s in range(2)]}
        per_round = DRIVER_LAYERS * TRAIN_R
        want = {"paged_attention": 0, "paged_attention_int8": 0, "wkv6": 0,
                "mamba_scan": 0,
                "flash_attention": 3 * per_round * DRIVER_ROUNDS,
                "flash_attention_bwd": per_round * DRIVER_ROUNDS}
        if counts != want:
            raise AssertionError(f"launches on the driver path: {counts}, "
                                 f"expected {want}")
        out = {"model": spec.name, "layers": DRIVER_LAYERS,
               "schedule": "1f1b/stash", "pp": 2, "optimizer": "sgdm",
               "dtype": "bfloat16", "rounds": DRIVER_ROUNDS,
               "state_gb": tree_bytes(state) / 1e9,
               "round_s_warm": driver.round_seconds[1],
               "losses_uninterrupted": losses,
               "faults": "phase 18b (two ranks, the same driver)"}
        log(f"[driver] {spec.name} 1f1b/stash pp=2 bf16 sgdm: "
            f"{DRIVER_ROUNDS} rounds uninterrupted (no checkpoints), losses "
            f"{[round(x, 4) for x in losses]}, state {out['state_gb']:.2f} "
            f"GB; the reference of 18b's restarted ranks")
        del state, bundle, driver
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return out, counts, ref_rows


# --------------------------------------------------------------------------
# phase 17: stages on several ranks and data replicas (torch.distributed)
# --------------------------------------------------------------------------

def digest(t) -> int:
    """A 64-bit fingerprint of a tensor's bits on its device: the sum over
    elements of bits(x_i) · w_i mod 2^64 (chunk k's sum times 2k + 1),
    w_i odd pseudo-random words from a fixed seed; any single element that
    differs changes it, so two processes compare states without moving
    them."""
    import torch
    flat = t.detach().contiguous().view(-1)
    bits = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[flat.element_size()])
    w = _DIGEST_WEIGHTS.get(flat.device)
    if w is None:
        g = torch.Generator(device=flat.device).manual_seed(20)
        w = _DIGEST_WEIGHTS[flat.device] = torch.randint(
            0, 2 ** 62, (DIGEST_CHUNK,), generator=g, device=flat.device,
            dtype=torch.int64) * 2 + 1
    h = 0
    for k, i in enumerate(range(0, bits.numel(), DIGEST_CHUNK)):
        c = bits[i:i + DIGEST_CHUNK].long()
        h += int((c * w[:c.numel()]).sum()) * (2 * k + 1)
    return h % 2 ** 64


_DIGEST_WEIGHTS = {}


def state_digests(tree) -> dict:
    """Every leaf of a state tree: a tensor's :func:`digest`, else the
    value (step, windows, thetas)."""
    import torch
    return {name: digest(t) if torch.is_tensor(t) else t
            for name, t in tree_leaves(tree)}


def dist_plan(pp, schedule="1f1b", mode="stash", v=1, zero1=False,
              r=DIST_R):
    from repro_torch import configs
    return configs.get("qwen3-14b").PLAN.with_(
        tp=1, pp=pp, microbatches=r, stash_mode=mode, schedule=schedule,
        virtual_stages=v, zero1=zero1)


def dist_batches(spec, rows, r, rounds):
    """``rounds`` rounds of ``r`` microbatches of ``rows`` rows (all
    replicas), on the host: the SyntheticLM stream at seed SEED."""
    from repro_torch.data.pipeline import SyntheticLM
    src = SyntheticLM(spec.vocab, DIST_SEQ, seed=SEED)
    return [src.round_batch(i, r, rows) for i in range(rounds)]


def replica_rows(batch, d, dp, device):
    """Replica ``d``'s block of a host round, on ``device``."""
    import torch
    mb = batch["tokens"].shape[1] // dp
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[:, d * mb:(d + 1) * mb])).to(device) for k, v in batch.items()}


def dist_fp32_run(spec, plan, device, dp=1, grid=None, rounds=DIST_ROUNDS):
    """``rounds`` rounds in fp32 (SGD with momentum) through the
    executor, one process or this rank of ``grid``; (losses, state,
    bundle, round seconds)."""
    import torch
    from repro_torch.core.pipeline import build_pipeline
    from repro_torch.optim import SGDM
    bundle = build_pipeline(spec, plan, seq_len=DIST_SEQ,
                            global_batch=dp * plan.microbatches * DIST_ROWS,
                            optimizer=SGDM(lr=0.01),
                            compute_dtype=torch.float32, device=device,
                            grid=grid)
    state = bundle.init_state(torch.Generator(bundle.device).manual_seed(SEED))
    # the init's transient (the whole model on each rank) goes back to the
    # card for the processes that share it
    torch.cuda.empty_cache()
    d = grid.d if grid is not None else 0
    losses, seconds = [], []
    for batch in dist_batches(spec, dp * DIST_ROWS, plan.microbatches,
                              rounds):
        batch = replica_rows(batch, d, dp, bundle.device)
        t0 = time.perf_counter()
        state, m = bundle.train_step(state, batch)
        losses.append(m["loss"].item())          # waits for the round
        seconds.append(time.perf_counter() - t0)
    return losses, state, bundle, seconds


def rank_child(rank, world, data, pp, init_file, job, kw, results, tp=1):
    """A spawned rank: deterministic algorithms and no TF32 before CUDA
    starts, the grid under gloo on the one card, ``job``'s result on the
    queue.  An exception goes to the queue and fails the rank."""
    import os
    import traceback
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    # up to four processes share the card: hand back what a process frees
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    from repro_torch.parallel.dist import ProcessGrid, close_grid, init_grid
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        grid = init_grid(ProcessGrid(data, pp, tp), "gloo",
                         init_method=f"file://{init_file}", rank=rank,
                         world_size=world, device="cuda",
                         timeout=DIST_GROUP_S)
        results.put((rank, globals()[job](grid, **kw)))
    except BaseException:
        results.put((rank, {"error": traceback.format_exc()}))
        raise
    finally:
        close_grid()


def spawn_ranks(data, pp, job, tp=1, **kw):
    """``job`` on a ``data x pp x tp`` grid of processes started with ``spawn``
    (the parent holds a CUDA context) on the one card under gloo; the
    results by rank.  A rank that fails, or a deadline of DIST_JOIN_S,
    fails the phase; every child is ended before this returns."""
    return join_ranks(start_ranks(data, pp, job, tp, **kw))


def start_ranks(data, pp, job, tp=1, **kw):
    """:func:`spawn_ranks`' processes, started; the handle
    :func:`join_ranks` takes (the parent may work meanwhile, and must
    join them whatever happens)."""
    import multiprocessing
    import tempfile
    import torch
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    world = data * pp * tp
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rdv_")
    procs = [ctx.Process(target=rank_child,
                         args=(r, world, data, pp, f"{tmp}/rendezvous", job,
                               kw, results, tp)) for r in range(world)]
    for p in procs:
        p.start()
    return job, procs, results, tmp


def join_ranks(handle):
    """The results by rank of :func:`start_ranks`' processes, every child
    ended before this returns."""
    import queue
    job, procs, results, tmp = handle
    world = len(procs)
    out = {}
    deadline = time.monotonic() + DIST_JOIN_S
    try:
        while len(out) < world:
            try:
                rank, res = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise AssertionError(f"{job}: rank(s) {dead} exited with "
                                         f"{[procs[r].exitcode for r in dead]}")
                if time.monotonic() > deadline:
                    raise AssertionError(f"{job}: no result after "
                                         f"{DIST_JOIN_S} s")
                continue
            if "error" in res:
                raise AssertionError(f"{job}: rank {rank} failed:\n"
                                     f"{res['error']}")
            out[rank] = res
        for p in procs:
            p.join(60)
            if p.exitcode != 0:
                raise AssertionError(f"{job}: a rank exited with "
                                     f"{p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]


def rank_info(grid) -> dict:
    return {"rank": grid.rank, "replica": grid.d, "stage": grid.s,
            "backend": grid.backend, "device": str(grid.device),
            "device_policy": grid.device_policy}


def dist_job_split(grid, cases):
    """17b on a rank: each case's fp32 rounds; losses and state digests."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.train import cut_layers
    out = {"seconds": []}
    for label, layers, plan_kw in cases:
        t0 = time.perf_counter()
        spec = cut_layers(configs.get("qwen3-14b").full_spec(), layers)
        losses, state, _, _ = dist_fp32_run(spec, dist_plan(**plan_kw),
                                            grid.device, grid=grid)
        out[label] = {"losses": losses, "digests": state_digests(state),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state
        torch.cuda.empty_cache()
        out["seconds"].append(round(time.perf_counter() - t0, 1))
    return out


def dist_job_replicas(grid, out_dir):
    """17c on a rank of a (2, pp) grid: the replicated and the ZeRO-1 run
    in fp32; losses, digests of both states and of the replicated run's
    optimizer shard, the replicated run's parameters as raw files from
    replica 0 (the parent holds them to the oracle), optimizer-state
    bytes and the transport's counters."""
    import torch
    from repro_torch import configs
    from repro_torch.core.versioning import zero1_axes, zero1_shard
    from repro_torch.launch.train import cut_layers
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.parallel.dist import TransportStats
    spec = cut_layers(configs.get("qwen3-14b").full_spec(), DIST_LAYERS)
    dp = grid.topo.data
    out = {"grid": rank_info(grid)}
    for zero1 in (False, True):
        torch.cuda.reset_peak_memory_stats()
        grid.stats = TransportStats()
        losses, state, bundle, round_s = dist_fp32_run(
            spec, dist_plan(grid.topo.pp, zero1=zero1, r=DIST_REPLICA_R),
            grid.device, dp=dp, grid=grid, rounds=DIST_REPLICA_ROUNDS)
        run = {"losses": losses, "round_s": round_s,
               "digests": state_digests({k: v for k, v in state.items()
                                         if k != "opt_stages"}),
               "opt_state_gb": tree_bytes(state["opt_stages"]) / 1e9,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "transport": dataclasses.asdict(grid.stats)}
        axes = zero1_axes(state["params"]["stages"], dp)
        opt = state["opt_stages"]
        if not zero1:
            opt = {k: tree_map(lambda a, ax: zero1_shard(a, ax, grid.d, dp),
                               v, axes) for k, v in opt.items()}
            if grid.d == 0:
                for name, t in tree_leaves(state["params"]):
                    if hasattr(t, "numel"):
                        t.cpu().numpy().tofile(
                            f"{out_dir}/s{grid.s}{name.replace('/', '.')}.bin")
        run["opt_shard_digests"] = state_digests(opt)
        out["zero1" if zero1 else "replicated"] = run
        del state, bundle, opt
        torch.cuda.empty_cache()
    return out


def dist_job_train(grid):
    """17d on a rank: phase 13's shape (qwen3-14b, 4 layers, bf16, Adam,
    1f1b / stash, pp 2, R 4 x 4096) through launch/train.py's build with
    this rank's grid, DIST_TRAIN_ROUNDS rounds on the stream with the plain
    attention versions refused; per round the host seconds and the
    transport's counters; the launches of this rank."""
    import torch
    from repro_torch.core.versioning import zero1_axes, zero1_shard
    from repro_torch.data.pipeline import Loader, SyntheticLM
    from repro_torch.launch import train
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.parallel.dist import TransportStats
    args = train_args(phase_train_flags(["--schedule", "1f1b",
                                         "--stash-mode", "stash"]))
    spec, bundle = build_train(args, grid)
    torch.cuda.reset_peak_memory_stats()
    state = bundle.init_state(torch.Generator(grid.device).manual_seed(SEED))
    loader = Loader(SyntheticLM(spec.vocab, TRAIN_SEQ, seed=SEED),
                    TRAIN_R, TRAIN_ROWS, grid.device)
    batches = [loader.get(r) for r in range(DIST_TRAIN_ROUNDS)]
    torch.cuda.synchronize()
    reset_counts()
    rounds, losses = [], []
    with plain_attention_refused():
        for batch in batches:
            grid.stats = TransportStats()
            t0 = time.perf_counter()
            state, m = bundle.train_step(state, batch)
            torch.cuda.synchronize()
            rounds.append({"round_s": time.perf_counter() - t0,
                           **dataclasses.asdict(grid.stats)})
            losses.append(float(m["loss"]))
    counts = read_counts()
    opt = state["opt_stages"]
    axes = zero1_axes(state["params"]["stages"], 2)
    shard = {k: tree_map(lambda a, ax: zero1_shard(a, ax, 0, 2), v, axes)
             for k, v in opt.items()}
    return {"grid": rank_info(grid), "losses": losses, "rounds": rounds,
            "counts": counts,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "state_gb": tree_bytes(state) / 1e9,
            "opt_state_gb": tree_bytes(opt) / 1e9,
            "opt_state_gb_zero1_at_dp2": tree_bytes(shard) / 1e9,
            "holds": sorted(k for k in state["params"]
                            if k in ("embed", "head"))}


def phase_dist(device, first_round_loss):
    """17a-d (see the module docstring); the dist records."""
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.core.reference import (reference_init_state,
                                            reference_train_step)
    from repro_torch.core.schedule import make_schedule
    from repro_torch.core.versioning import rank_params, rank_state
    from repro_torch.launch.train import cut_layers
    from repro_torch.optim import SGDM
    from repro_torch.parallel.dist import ProcessGrid, close_grid, init_grid
    full = configs.get("qwen3-14b").full_spec()
    spec = cut_layers(full, DIST_LAYERS)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    seconds, out = {}, {}
    try:
        # 17a: the rank-local executor under NCCL at world size 1
        t0 = time.perf_counter()
        plan = dist_plan(1)
        want_losses, ref, _, _ = dist_fp32_run(spec, plan, device)
        want = state_digests(ref)
        del ref
        torch.cuda.empty_cache()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
        try:
            grid = init_grid(ProcessGrid(1, 1), "nccl",
                             init_method=f"file://{tmp}/rendezvous", rank=0,
                             world_size=1, device="cuda",
                             timeout=DIST_GROUP_S)
            log(f"[dist] 17a {grid.describe()}")
            losses, state, _, _ = dist_fp32_run(spec, plan, device,
                                                grid=grid)
            got = state_digests(state)
            del state
        finally:
            close_grid()
            shutil.rmtree(tmp, ignore_errors=True)
            torch.cuda.empty_cache()
        if losses != want_losses or got != want:
            raise AssertionError(
                f"17a: NCCL (1, 1) grid differs from the single-process "
                f"executor: losses {losses} / {want_losses}, leaves "
                f"{[k for k in want if got.get(k) != want[k]][:5]}")
        seconds["17a nccl world 1"] = time.perf_counter() - t0
        out["17a"] = {"backend": "nccl", "world": 1, "losses": losses,
                      "leaves_equal": len(want)}
        log(f"[dist] 17a ({seconds['17a nccl world 1']:.1f}s): fp32, "
            f"{DIST_LAYERS} layers at full width, pp 1, "
            f"R {DIST_R} x seq {DIST_SEQ}: the (1, 1) grid under NCCL "
            f"equals the single-process executor bit for bit (losses "
            f"{losses}, {len(want)} leaves); it calls NCCL's all-reduce "
            f"(the round's metrics) and no p2p")

        # 17b: two ranks on the one card under gloo, bit for bit
        t0 = time.perf_counter()
        cases = [("1f1b/stash", DIST_LAYERS, dict(pp=2)),
                 ("interleaved/flush v2", DIST_V_LAYERS,
                  dict(pp=2, schedule="interleaved", mode="flush", v=2))]
        expect = {}
        for label, layers, kw in cases:
            cut = cut_layers(full, layers)
            p = dist_plan(**kw)
            lo, st, bundle, _ = dist_fp32_run(cut, p, device)
            expect[label] = (lo, [state_digests(rank_state(st, bundle.sched,
                                                           s))
                                  for s in range(2)])
            del st, bundle
            torch.cuda.empty_cache()
        ranks = spawn_ranks(1, 2, "dist_job_split", cases=cases)
        for label, _, _ in cases:
            lo, per_rank = expect[label]
            for s, res in enumerate(ranks):
                got = res[label]
                if got["losses"] != lo or got["digests"] != per_rank[s]:
                    bad = [k for k in per_rank[s]
                           if got["digests"].get(k) != per_rank[s][k]]
                    raise AssertionError(
                        f"17b {label} rank {s}: losses {got['losses']} / "
                        f"{lo}; leaves that differ {bad[:6]}")
            log(f"[dist] 17b {label} ({time.perf_counter() - t0:.1f}s "
                f"since 17b began; ranks {[r['seconds'] for r in ranks]} s "
                f"a case): two ranks on one card (gloo) equal "
                f"the single-process executor bit for bit: losses {lo}, "
                f"{sum(len(d) for d in per_rank)} leaves; peak "
                f"{[round(r[label]['peak_gb'], 2) for r in ranks]} GB")
        seconds["17b two ranks"] = time.perf_counter() - t0
        out["17b"] = {label: {"losses": expect[label][0]}
                      for label, _, _ in cases}

        # 17c: data replicas against the oracle over the whole batch
        out["17c"] = {}
        for pp in DIST_REPLICA_PP:
            t0 = time.perf_counter()
            plan = dist_plan(pp, r=DIST_REPLICA_R)
            opt = SGDM(lr=0.01)
            ref = reference_init_state(spec, plan, opt, torch.Generator(
                device).manual_seed(SEED), torch.float32)
            o_losses = []
            for batch in dist_batches(spec, 2 * DIST_ROWS, DIST_REPLICA_R,
                                      DIST_REPLICA_ROUNDS):
                ref, m = reference_train_step(
                    spec, plan, ref, {k: torch.from_numpy(v).to(device)
                                      for k, v in batch.items()}, opt,
                    donate=True)
                o_losses.append(m["loss"].item())
            sched = make_schedule(plan)
            oracle = [dict(tree_leaves(rank_params(ref["params"], sched, s)))
                      for s in range(pp)]
            oracle = [{k: v.cpu() if torch.is_tensor(v) else v
                       for k, v in o.items()} for o in oracle]
            del ref
            torch.cuda.empty_cache()
            tmp = tempfile.mkdtemp(prefix="chip_smoke_params_")
            try:
                ranks = spawn_ranks(2, pp, "dist_job_replicas", out_dir=tmp)
                t_cmp = time.perf_counter()
                worst = 0.0
                for s in range(pp):
                    for name, want_t in oracle[s].items():
                        if not torch.is_tensor(want_t):
                            continue
                        path = f"{tmp}/s{s}{name.replace('/', '.')}.bin"
                        got_t = torch.from_numpy(np.fromfile(
                            path, dtype=np.float32).reshape(want_t.shape))
                        worst = max(worst, check_close(
                            f"17c dp2 pp{pp} {name}", got_t.to(device),
                            want_t.to(device), 5e-5, 2e-3))
                t_cmp = time.perf_counter() - t_cmp
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            for rank, res in enumerate(ranks):
                d, s = divmod(rank, pp)
                rep, z1 = res["replicated"], res["zero1"]
                for name in ("replicated", "zero1"):
                    np.testing.assert_allclose(
                        res[name]["losses"], o_losses, atol=5e-5, rtol=1e-4,
                        err_msg=f"17c dp2 pp{pp} {name} rank {rank}")
                if rep["losses"] != z1["losses"] or \
                        rep["digests"] != z1["digests"] or \
                        rep["opt_shard_digests"] != z1["opt_shard_digests"]:
                    raise AssertionError(
                        f"17c dp2 pp{pp} rank {rank}: ZeRO-1 differs from the "
                        "replicated update")
                twin = ranks[(1 - d) * pp + s]["replicated"]["digests"]
                if {k: v for k, v in rep["digests"].items()
                        if k.startswith("/params")} != \
                        {k: v for k, v in twin.items()
                         if k.startswith("/params")}:
                    raise AssertionError(f"17c dp2 pp{pp}: the replicas of "
                                         f"stage {s} hold other weights")
            seconds[f"17c dp2 pp{pp}"] = time.perf_counter() - t0
            out["17c"][f"dp2xpp{pp}"] = {
                "oracle_losses": o_losses,
                "losses": ranks[0]["replicated"]["losses"],
                "max_abs_param_err": worst, "ranks": ranks}
            log(f"[dist] 17c dp 2 x pp {pp} ({seconds[f'17c dp2 pp{pp}']:.1f}s"
                f", compare {t_cmp:.1f}s): replicated and ZeRO-1 track the "
                f"oracle over the whole batch (losses "
                f"{ranks[0]['replicated']['losses']} / {o_losses}, max |param"
                f" err| {worst:.2e}); ZeRO-1 equals the replicated update bit "
                f"for bit; optimizer state "
                f"{[round(r['replicated']['opt_state_gb'], 3) for r in ranks]}"
                f" GB replicated, "
                f"{[round(r['zero1']['opt_state_gb'], 3) for r in ranks]} GB "
                f"ZeRO-1 by rank")

        # 17d: phase 13's shape split over two ranks on the one card
    finally:
        torch.use_deterministic_algorithms(False)
    t0 = time.perf_counter()
    ranks = spawn_ranks(1, 2, "dist_job_train")
    losses = ranks[1]["losses"]
    if not all(np.isfinite(losses)) or \
            abs(losses[0] - first_round_loss) > 2e-2:
        raise AssertionError(f"17d: losses {losses}, phase 13's first round "
                             f"{first_round_loss}")
    counts = {k: sum(r["counts"][k] for r in ranks) for k in ranks[0]["counts"]}
    per_round = TRAIN_LAYERS * TRAIN_R
    want = {"paged_attention": 0, "paged_attention_int8": 0, "wkv6": 0,
            "mamba_scan": 0,
            "flash_attention": 3 * per_round * DIST_TRAIN_ROUNDS,
            "flash_attention_bwd": per_round * DIST_TRAIN_ROUNDS}
    if counts != want:
        raise AssertionError(f"17d launches {counts}, expected {want}")
    seconds["17d two ranks, full width"] = time.perf_counter() - t0
    out["17d"] = {"losses": losses, "phase13_first_round_loss":
                  first_round_loss, "ranks": ranks}
    log(f"[dist] 17d qwen3-14b {TRAIN_LAYERS} layers bf16 Adam 1f1b/stash "
        f"pp 2 on two ranks (gloo, one card): losses "
        f"{[round(x, 4) for x in losses]} (phase 13's first round "
        f"{first_round_loss:.4f}); round seconds by rank "
        f"{[[round(x['round_s'], 3) for x in r['rounds']] for r in ranks]}; "
        f"peak {[round(r['peak_gb'], 2) for r in ranks]} GB")
    log(f"[phases] 17 seconds: {json.dumps(seconds)}")
    return out, seconds, counts


def dist_records(dist_out, smi_line):
    """The ``dist`` JSON records: one a rank of 17d (the slice at full
    width) and of 17c's dp 2 x pp 2 grid."""
    recs = []
    for phase, ranks in (("17d", dist_out["17d"]["ranks"]),
                         ("17c dp2xpp2", dist_out["17c"]["dp2xpp2"]["ranks"])):
        for res in ranks:
            rec = {"phase": phase, **res["grid"], "card": smi_line}
            if phase == "17d":
                rec.update({
                    "round_s": [x["round_s"] for x in res["rounds"]],
                    "handoff_wait_s": [x["handoff_s"] for x in res["rounds"]],
                    "handoff_bytes": [x["handoff_bytes"]
                                      for x in res["rounds"]],
                    "staged_bytes": [x["staged_bytes"]
                                     for x in res["rounds"]],
                    "collective_bytes": [x["collective_bytes"]
                                         for x in res["rounds"]],
                    "peak_gb": res["peak_gb"], "state_gb": res["state_gb"],
                    "opt_state_gb": res["opt_state_gb"],
                    "opt_state_gb_zero1": None,
                    "opt_state_gb_zero1_at_dp2":
                        res["opt_state_gb_zero1_at_dp2"],
                    "holds": res["holds"], "launches": res["counts"]})
            else:
                rep, z1 = res["replicated"], res["zero1"]
                n = DIST_REPLICA_ROUNDS
                rec.update({
                    "round_s": rep["round_s"],
                    "handoff_wait_s": rep["transport"]["handoff_s"] / n,
                    "handoff_bytes": rep["transport"]["handoff_bytes"] // n,
                    "staged_bytes": rep["transport"]["staged_bytes"] // n,
                    "collective_bytes":
                        rep["transport"]["collective_bytes"] // n,
                    "peak_gb": rep["peak_gb"], "opt_state_gb":
                    rep["opt_state_gb"], "opt_state_gb_zero1":
                    z1["opt_state_gb"], "zero1_peak_gb": z1["peak_gb"],
                    "zero1_collective_bytes":
                        z1["transport"]["collective_bytes"] // n})
            recs.append(rec)
    return recs


# --------------------------------------------------------------------------
# phase 18: workers that checkpoint their own stages and report what they
# measure
# --------------------------------------------------------------------------

def dist_job_init(grid):
    """18a on a rank: this stage's parameters of qwen3-14b at all 40
    layers, bf16, drawn row-wise (``init_rank_params``); the seconds, the
    peak and kept memory, the digests."""
    import torch
    from repro_torch import configs
    from repro_torch.core.reference import model_plan
    from repro_torch.core.schedule import make_schedule
    from repro_torch.models.init import init_rank_params
    spec = configs.get("qwen3-14b").full_spec()
    sched = make_schedule(dist_plan(2))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_rank_params(spec, model_plan(dist_plan(2), sched),
                              torch.Generator(grid.device).manual_seed(SEED),
                              sched, grid.s, torch.bfloat16)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"grid": rank_info(grid), "init_s": seconds,
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "kept_gb": tree_bytes(params) / 1e9,
            "digests": state_digests(params)}


def driver_flags(ckpt):
    """The launcher's flags of phases 16 and 18b."""
    return ["--layers", str(DRIVER_LAYERS), "--pp", "2", "--microbatches",
            str(TRAIN_R), "--global-batch", str(TRAIN_R * TRAIN_ROWS),
            "--seq-len", str(TRAIN_SEQ), "--schedule", "1f1b",
            "--stash-mode", "stash", "--optimizer", "sgdm", "--lr", "0.01",
            "--steps", str(DRIVER_ROUNDS), "--ckpt-every",
            str(DRIVER_EVERY), "--ckpt", ckpt]


def dist_job_driver(grid, ckpt):
    """18b on a rank: phase 16's TrainDriver run through the launcher's
    build on this rank's grid, with an Observability; the last rank fails
    before round DRIVER_FAIL and crashes in round DRIVER_TORN's save.
    The final digests, the digests of the state each save wrote, the
    save / restore seconds, what the torn save left, the registry, the
    trace's span counts and this rank's launches."""
    import json as _json
    import os
    import torch
    from repro_torch.launch import train
    from repro_torch.obs import Observability
    last = grid.rank == grid.topo.world - 1
    armed = {"hook": last, "save": last}
    seen = {"save_s": [], "restore_s": [], "torn": None, "saved": None}
    args = train_args(driver_flags(ckpt))
    obs = Observability(trace=True)
    spec, bundle = build_train(args, grid, obs=obs)

    def hook(step):
        if step == DRIVER_FAIL and armed["hook"]:
            armed["hook"] = False
            raise RuntimeError("simulated failure of the last rank")

    driver = train.make_driver(args, spec, bundle, ckpt, failure_hook=hook)
    save, restore = driver.ckpt.save, driver.ckpt.restore

    def t_save(rnd, st, n, fail_after_stage=None):
        torn = rnd == DRIVER_TORN and armed["save"]
        t0 = time.perf_counter()
        save(rnd, st, n, fail_after_stage=0 if torn else fail_after_stage)
        seen["save_s"].append(time.perf_counter() - t0)
        if torn:
            armed["save"] = False
            with open(os.path.join(driver.ckpt._round_dir(rnd),
                                   "MANIFEST.json")) as f:
                seen["torn"] = {"manifest": _json.load(f), "latest":
                                driver.ckpt.latest_complete_round()}
            raise RuntimeError("crash in the middle of a save")
        if driver.ckpt.latest_complete_round() == rnd:
            seen["saved"] = (rnd, state_digests(st))

    def t_restore(rnd, st):
        t0 = time.perf_counter()
        out = restore(rnd, st)
        torch.cuda.synchronize()
        seen["restore_s"].append(time.perf_counter() - t0)
        return out

    driver.ckpt.save, driver.ckpt.restore = t_save, t_restore
    torch.cuda.reset_peak_memory_stats()
    state = bundle.init_state(torch.Generator(grid.device).manual_seed(SEED))
    torch.cuda.synchronize()
    reset_counts()
    state, step = driver.run(state, DRIVER_ROUNDS)
    counts = read_counts()
    rnd = driver.ckpt.latest_complete_round()
    rdir = driver.ckpt._round_dir(rnd)
    v = bundle.plan.virtual_stages
    mine = [f"stage_{grid.s * v + j}.npz" for j in range(v)]
    if grid.rank == 0:
        mine += ["shared.npz", "opt.npz"]
    out = {"grid": rank_info(grid), "step": step, "unfired": armed,
           "losses": [m["loss"] for m in driver.metrics_log],
           "digests": state_digests(state), "saved": seen["saved"],
           "torn": seen["torn"], "save_s": seen["save_s"],
           "restore_s": seen["restore_s"],
           "written_gb": sum(os.path.getsize(os.path.join(rdir, f))
                             for f in mine) / 1e9,
           "round_s": driver.round_seconds,
           "stage_seconds": driver.stage_seconds,
           "snapshot": obs.registry.snapshot(),
           "span_counts": obs.trace.span_counts("train"),
           "rounds_traced": len(obs.trace.rounds), "counts": counts,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if grid.rank == 0:
        out["obs"] = driver_obs(spec, bundle, obs)
    return out


def driver_obs(spec, bundle, obs):
    """Rank 0's view of 18b: measured stage seconds, ``reconcile`` against
    the planner's analytic stage costs on an H100, and
    ``replan_from_registry`` on the measured seconds."""
    from repro_torch.core import profiler as prof
    from repro_torch.core.schedule import make_schedule
    from repro_torch.obs import reconcile, stage_seconds
    from repro_torch.runtime.driver import replan_from_registry
    plan = bundle.plan
    tokens = bundle.microbatch_size * bundle.seq_len
    profiles = prof.profile_analytic(spec, prof.H100_SXM,
                                     minibatch_tokens=tokens)
    spans = prof.profile_stage_spans(len(profiles), plan.pp)
    t_fwd = [sum(profiles[i].t_fwd for i in sp) for sp in spans]
    t_bwd = [sum(profiles[i].t_bwd for i in sp) for sp in spans]
    rep = reconcile(bundle.sched, trace=obs.trace, registry=obs.registry,
                    kind="train", t_fwd=t_fwd, t_bwd=t_bwd)
    new, changed = replan_from_registry(spec, plan, obs.registry,
                                        prof.H100_SXM,
                                        minibatch_tokens=tokens,
                                        data_replicas=1)
    return {"stage_seconds_mean": stage_seconds(obs.registry, plan.pp),
            "predicted_stage_fwd_s": t_fwd, "predicted_stage_bwd_s": t_bwd,
            "reconcile": rep.to_dict(), "reconcile_line": str(rep),
            "replan": {"pp": new.pp, "tp": new.tp,
                       "schedule": make_schedule(new).name,
                       "virtual_stages": new.virtual_stages,
                       "rebalanced": changed}}


def phase_ckpt_dist(device, driver_rows):
    """18a and 18b (see the module docstring); the ``ckpt_dist`` records,
    the ``obs`` record, the seconds and the launches of 18b."""
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.core.reference import model_plan, to_storage_order
    from repro_torch.core.schedule import B_MB, F_MB, make_schedule
    from repro_torch.core.versioning import rank_params
    from repro_torch.models.init import init_params
    seconds = {}

    # 18a: the row-wise init at the planner's depth, two ranks on the card
    t0 = time.perf_counter()
    inits = spawn_ranks(1, 2, "dist_job_init")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    spec = configs.get("qwen3-14b").full_spec()
    sched = make_schedule(dist_plan(2))
    t1 = time.perf_counter()
    whole = to_storage_order(init_params(
        spec, model_plan(dist_plan(2), sched),
        torch.Generator(device).manual_seed(SEED), torch.bfloat16), sched)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t1
    whole_peak = torch.cuda.max_memory_allocated() / 1e9
    for s, res in enumerate(inits):
        want = state_digests(rank_params(whole, sched, s))
        if res["digests"] != want:
            bad = [k for k in want if res["digests"].get(k) != want[k]]
            raise AssertionError(f"18a: rank {s}'s row-wise draw differs from "
                                 f"the whole draw's rows: {bad[:6]}")
    whole_gb = tree_bytes(whole) / 1e9
    del whole
    torch.cuda.empty_cache()
    seconds["18a row-wise init"] = time.perf_counter() - t0
    log(f"[ckpt_dist] 18a qwen3-14b 40 layers bf16 pp 2, two ranks: init "
        f"{[round(r['init_s'], 2) for r in inits]} s, peak "
        f"{[round(r['peak_gb'], 2) for r in inits]} GB, kept "
        f"{[round(r['kept_gb'], 2) for r in inits]} GB a rank; equal to the "
        f"whole draw's rows ({whole_gb:.2f} GB, peak {whole_peak:.2f} GB, "
        f"{whole_s:.2f} s) bit for bit")

    # 18b: phase 16 on two ranks
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_dist_")
    try:
        ranks = spawn_ranks(1, 2, "dist_job_driver", ckpt=tmp)
        for s, res in enumerate(ranks):
            if any(res["unfired"].values()):
                raise AssertionError(f"18b rank {s}: a fault did not fire")
            if res["step"] != DRIVER_ROUNDS:
                raise AssertionError(f"18b rank {s}: stopped at {res['step']}")
            if res["digests"] != driver_rows["digests"][s]:
                bad = [k for k, v in driver_rows["digests"][s].items()
                       if res["digests"].get(k) != v]
                raise AssertionError(f"18b rank {s}: final state differs from "
                                     f"phase 16's rows: {bad[:6]}")
        losses = ranks[0]["losses"]
        ref = driver_rows["losses"]
        # rounds 0-1, 2, (failure), 2-3, (torn save), 2-4
        if len(losses) != 8 or losses[:2] != ref[:2] or \
                losses[-3:] != ref[-3:]:
            raise AssertionError(f"18b: losses {losses} against phase 16's "
                                 f"{ref}")
        torn = ranks[-1]["torn"]
        if torn["manifest"]["done"] or \
                torn["latest"] != DRIVER_TORN - DRIVER_EVERY:
            raise AssertionError(f"18b: the torn round was not skipped: "
                                 f"{torn}")
        snap = ranks[0]["snapshot"]
        hist = {(r["name"], tuple(sorted(r["labels"].items()))): r
                for r in snap["histograms"]}
        rounds_total = [r["value"] for r in snap["counters"]
                        if r["name"] == "rounds_total"]
        if rounds_total != [len(losses)]:
            raise AssertionError(f"18b: rounds_total {rounds_total}, "
                                 f"{len(losses)} rounds executed")
        for s in range(2):
            row = hist.get(("stage_round_seconds", (("stage", str(s)),)))
            if row is None or row["count"] != len(losses):
                raise AssertionError(f"18b: stage {s}'s stage_round_seconds "
                                     f"{row}")
        tabs = make_schedule(dist_plan(2)).tables()
        cells = ((tabs.fwd[:, :, F_MB] >= 0).sum(0)
                 + (tabs.bwd[:, :, B_MB] >= 0).sum(0))
        for res in ranks:
            want = {s: int(c) * res["rounds_traced"]
                    for s, c in enumerate(cells)}
            if res["rounds_traced"] != len(losses) or \
                    res["span_counts"] != want:
                raise AssertionError(f"18b: trace spans {res['span_counts']},"
                                     f" expected {want}")
        counts = {k: sum(r["counts"][k] for r in ranks)
                  for k in ranks[0]["counts"]}
        per_round = DRIVER_LAYERS * TRAIN_R
        want = {"paged_attention": 0, "paged_attention_int8": 0, "wkv6": 0,
                "mamba_scan": 0,
                "flash_attention": 3 * per_round * len(losses),
                "flash_attention_bwd": per_round * len(losses)}
        if counts != want:
            raise AssertionError(f"18b launches {counts}, expected {want}")
        # the last complete checkpoint restores in one process: a spawned
        # process beside phases 19-20 (finish_restore_one joins it)
        restore = start_restore_one(tmp, ranks)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    seconds["18b driver on two ranks"] = time.perf_counter() - t0
    recs = []
    for res in ranks:
        recs.append({"phase": "18b", **res["grid"],
                     "checkpoint_gb_written": res["written_gb"],
                     "save_s": res["save_s"], "restore_s": res["restore_s"],
                     "rounds_executed": len(res["losses"]),
                     "rounds_replayed": len(res["losses"]) - DRIVER_ROUNDS,
                     "round_s": res["round_s"],
                     "stage_seconds": res["stage_seconds"],
                     # the share of this rank's round spent waiting on
                     # hand-offs (its stage's seconds are the rest)
                     "wait_share": 1 - sum(x[res["grid"]["stage"]] for x in
                                           res["stage_seconds"])
                     / sum(res["round_s"]),
                     "peak_gb": res["peak_gb"], "launches": res["counts"]})
    for res in inits:
        recs.append({"phase": "18a", **res["grid"], "init_s": res["init_s"],
                     "peak_gb": res["peak_gb"], "kept_gb": res["kept_gb"],
                     "whole_draw_gb": whole_gb,
                     "whole_draw_peak_gb": whole_peak,
                     "whole_draw_s": whole_s})
    obs_rec = {"phase": "18b", **ranks[0]["obs"]}
    log(f"[ckpt_dist] 18b {DRIVER_LAYERS} layers bf16 sgdm 1f1b/stash pp 2 "
        f"on two ranks: {len(losses)} rounds executed, final states equal "
        f"phase 16's rows bit for bit; saves "
        f"{[[round(x, 2) for x in r['save_s']] for r in ranks]} s, restores "
        f"{[[round(x, 2) for x in r['restore_s']] for r in ranks]} s, "
        f"written {[round(r['written_gb'], 2) for r in ranks]} GB a save; "
        f"torn round {DRIVER_TORN} skipped; "
        f"{obs_rec['reconcile_line']}; replan {obs_rec['replan']}")
    log(f"[phases] 18 seconds: {json.dumps(seconds)}")
    return recs, obs_rec, seconds, counts, restore


def restore_one_child(ckpt, rnd, results):
    """18b's one-process restore in a spawned process: phase 16's state
    built through the launcher's builder on the card, round ``rnd`` of
    the ranks' checkpoint at ``ckpt`` restored into it, and each stage's
    rows' digests (:func:`rank_state`, :func:`state_digests`) on the
    queue with the seconds."""
    import traceback
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        import torch
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.core.versioning import rank_state
        device = torch.device("cuda")
        t1 = time.perf_counter()
        _, bundle = build_train(train_args(driver_flags(ckpt)))
        state = bundle.init_state(torch.Generator(device).manual_seed(SEED))
        t2 = time.perf_counter()
        CheckpointManager(ckpt).restore(rnd, state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t2
        digests = [state_digests(rank_state(state, bundle.sched, s))
                   for s in range(bundle.plan.pp)]
        results.put(("ok", {"restore_s": restore_s, "digests": digests,
                            "seconds_with_init": time.perf_counter() - t1}))
    except BaseException:
        results.put(("error", traceback.format_exc()))
        raise


def start_restore_one(ckpt, ranks):
    """:func:`restore_one_child` started on the ranks' last complete
    checkpoint; the handle :func:`finish_restore_one` takes."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    rnd = ranks[0]["saved"][0]
    child = ctx.Process(target=restore_one_child, args=(ckpt, rnd, results),
                        daemon=True)
    child.start()
    return child, results, ckpt, ranks, rnd, time.perf_counter()


def finish_restore_one(handle):
    """Join 18b's one-process restore: every stage's restored rows equal
    what its rank saved, bit for bit (64-bit digests); the checkpoint is
    then removed.  The ``ckpt_dist`` record of the restore."""
    import shutil
    child, results, ckpt, ranks, rnd, t_start = handle
    try:
        t0 = time.perf_counter()
        status, got = results.get(timeout=DIST_JOIN_S)
        child.join(60)
        wait_s = time.perf_counter() - t0
        if status != "ok":
            raise AssertionError(f"18b's one-process restore failed:\n{got}")
        for s, res in enumerate(ranks):
            if res["saved"][0] != rnd or got["digests"][s] != res["saved"][1]:
                raise AssertionError(f"18b: round {rnd} restored in one "
                                     f"process differs from rank {s}'s "
                                     "saved state")
    finally:
        if child.is_alive():
            child.kill()
            child.join(5)
        shutil.rmtree(ckpt, ignore_errors=True)
    log(f"[ckpt_dist] 18b: round {rnd} restored in one process in "
        f"{got['restore_s']:.2f} s (spawned beside phases 19-20, "
        f"{time.perf_counter() - t_start:.1f} s from its start, "
        f"{wait_s:.1f} s waited after phase 20), equal to every rank's "
        "saved state")
    return {"phase": "18b one process", "restore_s": got["restore_s"],
            "round": rnd, "seconds_with_init": got["seconds_with_init"],
            "beside": "phases 19-20", "wait_after_phase_20_s": wait_s}


# --------------------------------------------------------------------------
# the kernels line
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# phase 19: continuous batching and speculative decode at phase 3's width
# --------------------------------------------------------------------------

def batch_requests(vocab, seed):
    """The phase's request trace: each BATCH_TRACE entry is a pair of
    requests (the two lanes of one slot: equal prompt length,
    max_new_tokens and arrival step), prompts drawn from ``seed``."""
    from repro_torch.serving.batcher import Request
    rng = np.random.default_rng(seed)
    reqs = []
    for plen, new, arrival in BATCH_TRACE:
        for _ in range(ROWS):
            reqs.append(Request(
                rid=len(reqs), prompt=rng.integers(0, vocab, plen)
                .astype(np.int32), max_new_tokens=new, arrival=arrival))
    return reqs


class RoundWatch:
    """Wraps a session's rounds for one batcher run: every decode
    (``q`` 1) or verify (``q`` spec_k + 1) must launch the paged kernel
    exactly layers x live slots times, at query count ``q`` only, and an
    admission not at all; the allocator's invariants are checked after
    every round.  Records each round's live slots, bucket, seconds and
    (verify) acceptance by slot with each live lane's (request, tokens
    before the round), and with ``hidden`` each live lane's last hidden
    state."""

    def __init__(self, session, q, server, hidden=False):
        import torch
        self.s, self.q, self.server = session, q, server
        self.rounds, self.admits, self.hidden = [], [], {}
        self.layers = session.spec.n_layers
        name = "decode" if q == 1 else "verify"
        orig = getattr(session, name)
        admit = session.write_prefill_into_slots

        def launches():
            from repro_torch.kernels import paged_attention as pa
            return dict(pa.paged_attention.launches_by_q)

        def grew(before):
            now = launches()
            return {k: v - before.get(k, 0) for k, v in now.items()
                    if v != before.get(k, 0)}

        def round_fn(tokens, bucket=None):
            n_live = int(session._live.sum())
            lanes = {slot.index: [(r.rid, len(r.tokens))
                                  for _, r in slot.live_lanes()]
                     for slot in server.slots}
            before = launches()
            t0 = time.perf_counter()
            out = orig(tokens, bucket=bucket)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = grew(before)
            if got != {q: self.layers * n_live}:
                raise AssertionError(
                    f"{name} round {len(self.rounds)}: paged launches by Q "
                    f"{got}, expected {{{q}: {self.layers} layers x "
                    f"{n_live} live slots}}")
            session._alloc.check()
            acc = None
            if q > 1:
                acc = {m: int(out[1][m]) for m, ls in lanes.items() if ls}
            self.rounds.append({"live": n_live, "ms": 1e3 * dt,
                                "bucket": session._bucket_log[-1],
                                "accepted": acc, "lanes": lanes})
            if hidden:
                for slot in server.slots:
                    for lane, r in slot.live_lanes():
                        row = slot.index * session.rows + lane
                        self.hidden[r.rid] = session.last_hidden[row, -1]
            return out

        def admit_fn(batch, mask, bucket=None):
            before = launches()
            t0 = time.perf_counter()
            out = admit(batch, mask, bucket=bucket)
            torch.cuda.synchronize()
            if grew(before):
                raise AssertionError(f"an admission launched the paged "
                                     f"kernel: {grew(before)}")
            session._alloc.check()
            self.admits.append({"slots": int(np.sum(mask)),
                                "ms": 1e3 * (time.perf_counter() - t0)})
            return out

        setattr(session, name, round_fn)
        session.write_prefill_into_slots = admit_fn


def serve_trace(session, q, seed, draft_fn=None, hidden=False):
    """The trace through ContinuousBatchingSession on ``session`` under a
    RoundWatch; the allocator is checked after every scheduler step and
    must have every page back at the end.  Returns (report, requests,
    watch, seconds)."""
    import torch
    from repro_torch.serving.batcher import ContinuousBatchingSession
    reqs = batch_requests(session.spec.vocab, seed)
    server = ContinuousBatchingSession(session, draft_fn=(
        draft_fn(lambda: server) if draft_fn else None))
    watch = RoundWatch(session, q, server, hidden)
    step = server.step

    def checked_step():
        more = step()
        session._alloc.check()
        return more

    server.step = checked_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = server.run(reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    alloc = session._alloc
    if alloc.live_pages or alloc.free_pages != alloc.pool_pages:
        raise AssertionError(f"pages not all back: {alloc.live_pages} live, "
                             f"{alloc.free_pages} of {alloc.pool_pages} free")
    unfinished = [r.rid for r in reqs if not r.finished or r.truncated]
    if unfinished:
        raise AssertionError(f"requests {unfinished} unfinished or truncated")
    return report, reqs, watch, seconds


def trace_reference(session, reqs):
    """``full_transformer`` (the flash kernel) over each request's prompt
    + tokens, a pair of lanes a call: every served token must be a
    greedy token of the reference up to BATCH_TIE.  Returns the
    reference logits at each generated position by request, the count of
    near-tie positions (top-2 gap <= BATCH_TIE) and the largest gap of a
    served token below the maximum."""
    import torch
    logits, ties, worst, n = {}, 0, 0.0, 0
    for i in range(0, len(reqs), ROWS):
        pair = reqs[i:i + ROWS]
        seq = np.stack([np.concatenate([r.prompt, r.tokens[:-1]])
                        for r in pair]).astype(np.int32)
        lg = sequence_logits(session, seq, len(pair[0].tokens))
        served = torch.tensor([r.tokens for r in pair], device=lg.device)
        gap = lg.max(-1).values - lg.gather(-1, served[..., None])[..., 0]
        top2 = lg.topk(2, dim=-1).values
        ties += int(((top2[..., 0] - top2[..., 1]) <= BATCH_TIE).sum())
        worst = max(worst, float(gap.max()))
        n += served.numel()
        if (gap > BATCH_TIE).any():
            bad = [(pair[r].rid, int(t)) for r, t in
                   (gap > BATCH_TIE).nonzero().tolist()]
            raise AssertionError(
                f"served tokens are not full_transformer's greedy tokens at "
                f"(request, position) {bad[:8]}: logit gaps up to "
                f"{float(gap.max()):.4f} > {BATCH_TIE}")
        for r, row in zip(pair, lg):
            logits[r.rid] = row
    return logits, ties, worst, n


def same_streams(reqs, want, ref_logits, what):
    """Each request's tokens equal ``want``'s, or first differ at a
    near-tie of the reference (both tokens within BATCH_TIE of its
    maximum at that position); returns the count of such divergences."""
    diverged = 0
    for r in reqs:
        a, b = r.tokens, want[r.rid]
        if a == b:
            continue
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        if j >= min(len(a), len(b)):
            raise AssertionError(f"{what}: request {r.rid} has {len(a)} "
                                 f"tokens, the reference stream {len(b)}")
        lg = ref_logits[r.rid][j]
        gaps = [float(lg.max() - lg[t]) for t in (a[j], b[j])]
        if max(gaps) > BATCH_TIE:
            raise AssertionError(
                f"{what}: request {r.rid} differs at token {j} ({a[j]} vs "
                f"{b[j]}), not a near-tie: logit gaps {gaps}")
        diverged += 1
    return diverged


def oracle_rounds(watch, reqs, want, k):
    """Holds each verify round of an oracle run to its own streams: a
    slot whose lanes all still follow ``want`` when the round starts
    (and have k + 1 tokens to go) must accept exactly as many drafts as
    every lane's emitted tokens kept of ``want``'s, so a draft is
    rejected only where a lane's stream leaves ``want``'s there.
    Returns (slot-rounds checked, of them accepted in full)."""
    toks = {r.rid: r.tokens for r in reqs}
    checked = full = 0
    for i, rnd in enumerate(watch.rounds):
        for m, lanes in rnd["lanes"].items():
            if not lanes or any(
                    n + k + 1 > len(toks[rid])
                    or toks[rid][:n] != want[rid][:n] for rid, n in lanes):
                continue
            kept = min(next((j for j in range(k) if toks[rid][n + j]
                             != want[rid][n + j]), k) for rid, n in lanes)
            if rnd["accepted"][m] != kept:
                raise AssertionError(
                    f"oracle verify round {i}, slot {m} (requests "
                    f"{[rid for rid, _ in lanes]}): accepted "
                    f"{rnd['accepted'][m]} drafts, its streams kept {kept}")
            checked += 1
            full += kept == k
    return checked, full


def oracle_drafts(want, k, vocab, corrupt):
    """A ``draft_fn`` factory: each live lane's next k tokens of its
    request's stream in ``want`` (zeros past its end), each plus one with
    ``corrupt``.  It is handed a getter of the server it drafts for."""
    def make(server_of):
        def draft(last):
            out = np.zeros((last.shape[0], k), np.int32)
            server = server_of()
            for slot in server.slots:
                for lane, r in slot.live_lanes():
                    cont = want[r.rid][len(r.tokens):len(r.tokens) + k]
                    out[slot.index * server.rows + lane, :len(cont)] = cont
            return (out + 1) % vocab if corrupt else out
        return draft
    return make


def batching_session(spec, plan, dtype, device, **kw):
    from repro_torch.serving.engine import build_serving
    return build_serving(spec, plan, cache_len=CACHE_LEN,
                         global_batch=R_SLOTS * ROWS, compute_dtype=dtype,
                         page_size=PAGE, prefill_len=PREFILL,
                         pool_pages=BATCH_POOL, buckets=True, device=device,
                         **kw)


def verify_tile_check(device):
    """The paged kernel at the verify tile (Q = SPEC_K + 1) against its
    plain version at the main path's shapes, bf16 and f32."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    err = 0.0
    lengths = [PREFILL + 37, 300]
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        sets, tab, lens = paged_inputs(dtype, device, SPEC_K + 1, lengths,
                                       seed=19)
        q, kp, vp = sets[0]
        got = pa.paged_attention(q, kp, vp, tab, lens)
        want = pa.paged_attention_plain(q, kp, vp, tab, lens)
        torch.cuda.synchronize()
        err = max(err, check_close(f"paged verify tile {dtype}", got, want,
                                   atol, rtol))
    return err


def spec_run(device, spec, plan, params, kind, want, ref_logits, what):
    """The trace on a speculative session sharing ``params``, with the
    self-drafter or ``kind`` "oracle" / "corrupt" drafts of ``want``'s
    streams.  The streams must equal ``want``'s: exactly without
    ``ref_logits``, else up to a first difference at a near-tie of the
    reference, with every token held to ``full_transformer`` over the
    run's own prefix.  Oracle drafts must be accepted in full (a request
    of a pair that kept both streams takes the fewest rounds; a slot
    accepts the minimum over its lanes) and rejected only where a
    stream leaves ``want``'s (``oracle_rounds``), corrupted ones never.
    Returns the run's record and its launch counts."""
    import torch
    sess = batching_session(spec, plan, torch.bfloat16 if ref_logits
                            is not None else torch.float32,
                            device, spec_k=SPEC_K)
    sess.reset_state()
    sess.set_params(params)
    fn = None if kind == "self" else oracle_drafts(
        want, SPEC_K, spec.vocab, kind == "corrupt")
    reset_counts()
    rep, rq, w, secs = serve_trace(sess, SPEC_K + 1, SEED, draft_fn=fn)
    counts = read_counts()
    ties = worst = None
    if ref_logits is None:
        bad = [r.rid for r in rq if r.tokens != want[r.rid]]
        if bad:
            raise AssertionError(f"{what} {kind}: requests {bad} differ "
                                 "from the plain streams")
        div = 0
    else:
        # every token of this run against full_transformer over its own
        # prefix, past any divergence from want's stream too
        _, ties, worst, _ = trace_reference(sess, rq)
        div = same_streams(rq, want, ref_logits, f"{what} {kind}")
    kept = {r.rid // ROWS for r in rq} - {
        r.rid // ROWS for r in rq if r.tokens != want[r.rid]}
    checked = full = None
    if kind == "oracle":
        slow = [r.rid for r in rq if r.rid // ROWS in kept
                and r.step_done - r.step_admitted != max(
                    -(-(r.max_new_tokens - 1) // (SPEC_K + 1)) - 1, 0)]
        if slow:
            raise AssertionError(f"{what} oracle: requests {slow} did not "
                                 "accept every draft")
        checked, full = oracle_rounds(w, rq, want, SPEC_K)
    if kind == "corrupt" and rep.accepted_drafts:
        raise AssertionError(f"{what} corrupt: {rep.accepted_drafts} "
                             "corrupted drafts accepted")
    rec = {"seconds": secs, "steps": rep.steps,
           "verify_rounds": rep.spec_rounds,
           "acceptance_rate": rep.acceptance_rate,
           "accepted_per_round": rep.accepted_per_round,
           "goodput_tokens_per_s": rep.goodput_tokens_per_s,
           "verify_ms_mean": float(np.mean([r["ms"] for r in w.rounds])),
           "acceptance_by_round": [round(float(np.mean(list(
               r["accepted"].values()))), 3)
                                   for r in w.rounds],
           "diverged_at_near_ties": div,
           "near_tie_positions": ties, "largest_served_gap": worst,
           "pairs_kept": len(kept),
           "oracle_slot_rounds_checked": checked,
           "oracle_slot_rounds_full": full,
           "paged_launches_q5": counts["paged_attention"]}
    log(f"[batching] {what} {kind} drafts: {rep.steps} steps, "
        f"{rep.spec_rounds} verify rounds in {secs:.2f}s "
        f"({rec['verify_ms_mean']:.2f} ms a round), acceptance "
        f"{rep.acceptance_rate:.3f}, accepted a round "
        f"{rec['acceptance_by_round']}; streams equal the plain ones "
        f"({div} diverge at a near-tie; {len(kept)} of "
        f"{len(BATCH_TRACE)} pairs keep both)"
        + ("" if ties is None else
           f", every token full_transformer's greedy token over its own "
           f"prefix up to near-ties ({ties} positions with a top-2 gap "
           f"<= {BATCH_TIE}, largest served gap {worst:.4f})")
        + ("" if checked is None else
           f", oracle acceptance held to its streams in {checked} "
           f"slot-rounds ({full} in full)")
        + f"; paged launches "
        f"{counts['paged_attention']} at Q={SPEC_K + 1}")
    return rec, counts


def phase_batching(device, spec, plan):
    """19a-c (see the module docstring).  Returns the ``batcher`` record,
    the launches by sub-phase and the verify tile's error."""
    import dataclasses as dc
    import torch
    from collections import Counter
    from repro_torch.kernels import paged_attention as pa
    seconds = {}
    tile_err = verify_tile_check(device)

    # 19a: continuous batching through the Q = 1 decode tile
    t0 = time.perf_counter()
    base = batching_session(spec, plan, torch.bfloat16, device).start(SEED)
    reset_counts()
    report, reqs, watch, run_s = serve_trace(base, 1, SEED, hidden=True)
    counts_a = read_counts()
    if counts_a["paged_attention"] != sum(r["live"] for r in watch.rounds) \
            * spec.n_layers or counts_a["flash_attention"] \
            or counts_a["paged_attention_int8"]:
        raise AssertionError(f"19a launches {counts_a}")
    hist = Counter(base._bucket_log)
    if report.pool_stalls < 1:
        raise AssertionError("19a: no admission queued on a dry pool")
    shrink = [i for i in range(1, len(watch.rounds))
              if watch.rounds[i]["bucket"] < watch.rounds[i - 1]["bucket"]]
    grow = [i for i in shrink for j in range(i + 1, len(watch.rounds))
            if watch.rounds[j]["bucket"] > watch.rounds[i]["bucket"]]
    first_done = min(r.step_done for r in reqs)
    mid = [r.rid for r in reqs if r.step_admitted > first_done]
    if not shrink or not grow or not mid:
        raise AssertionError(f"19a: the trace did not shrink the bucket "
                             f"and grow it back ({shrink}, {grow}) or admit "
                             f"mid-stream ({mid})")
    reset_counts()
    t1 = time.perf_counter()
    ref_logits, ties, worst, n_tok = trace_reference(base, reqs)
    ref_s = time.perf_counter() - t1
    ref_counts = read_counts()
    # the served path's logits against the reference's at each request's
    # last position: the bf16 noise BATCH_TIE must cover
    from repro_torch.models import lm_head
    fn = base.params["final_norm"]
    noise = max(float((lm_head.last_logits(
        base.params["head"], fn["scale"], watch.hidden[r.rid][None, None],
        vocab=spec.vocab)[0] - ref_logits[r.rid][-1])[:spec.vocab]
        .abs().max()) for r in reqs)
    want = {r.rid: list(r.tokens) for r in reqs}
    decode_ms = [r["ms"] for r in watch.rounds]
    by_live = {n: float(np.mean([r["ms"] for r in watch.rounds
                                 if r["live"] == n]))
               for n in sorted({r["live"] for r in watch.rounds})}
    seconds["19a"] = time.perf_counter() - t0
    log(f"[batching] 19a {spec.name} bf16 pp {plan.pp}, R {R_SLOTS} x "
        f"{ROWS}, pool {BATCH_POOL} pages: {len(reqs)} requests, "
        f"{report.completed_tokens} tokens, {report.steps} steps "
        f"({report.decode_rounds} decode + {report.admit_rounds} admit "
        f"rounds) in {run_s:.2f}s; decode ms by live slots "
        f"{ {k: round(v, 2) for k, v in by_live.items()} }; buckets "
        f"{dict(sorted(hist.items()))}; admissions queued on a dry pool "
        f"{report.pool_stalls}; mid-stream admissions {mid}; paged "
        f"launches {counts_a['paged_attention']} (Q=1), each round layers "
        f"x live slots; tokens equal full_transformer's greedy tokens at "
        f"all {n_tok} positions up to near-ties ({ties} positions with a "
        f"top-2 gap <= {BATCH_TIE}, largest served gap {worst:.4f}; served "
        f"vs reference logits at the last positions max|diff| {noise:.4f}); "
        f"reference {ref_s:.2f}s, {ref_counts['flash_attention']} flash "
        f"launches")

    # 19b: speculative decode through the Q = spec_k + 1 verify tile
    t0 = time.perf_counter()
    spec_plan = plan.with_(schedule="serve_spec_1f")
    plain = pa.paged_attention_plain

    def refuse(*a, **kw):
        raise AssertionError("verify called the paged kernel's plain version")

    spec_runs, counts_b = {}, {}
    pa.paged_attention_plain = refuse
    try:
        for kind in ("self", "oracle", "corrupt"):
            spec_runs[kind], counts_b[kind] = spec_run(
                device, spec, spec_plan, base.params, kind, want,
                ref_logits, "19b")
    finally:
        pa.paged_attention_plain = plain
    del base
    torch.cuda.empty_cache()
    seconds["19b"] = time.perf_counter() - t0

    # 19c: fp32 at 4 layers: batched = solo, interleaved = 1f, spec = plain
    t0 = time.perf_counter()
    short = dc.replace(spec, name=f"{spec.name}-{BATCH_CONS_LAYERS}l",
                       n_layers=BATCH_CONS_LAYERS,
                       blocks=spec.blocks[:BATCH_CONS_LAYERS])
    f32 = torch.float32
    one = batching_session(short, plan, f32, device).start(SEED)
    _, reqs32, w32, _ = serve_trace(one, 1, SEED, hidden=True)
    toks32 = {r.rid: list(r.tokens) for r in reqs32}
    err_solo = 0.0
    from repro_torch.serving.engine import build_serving
    for r in reqs32:
        solo = build_serving(short, plan, cache_len=CACHE_LEN,
                             global_batch=1, compute_dtype=f32,
                             page_size=PAGE, device=device)
        solo.reset_state()
        solo.set_params(one.params)
        nxt = solo.prefill({"tokens": r.prompt[None, None]})
        out = [int(nxt[0])]
        for _ in range(r.max_new_tokens - 1):
            nxt = solo.decode(nxt)
            out.append(int(nxt[0]))
        if out != toks32[r.rid]:
            raise AssertionError(f"19c: request {r.rid} batched "
                                 f"{toks32[r.rid]} != alone {out}")
        # phase 4's tolerance for engine hidden states: alone, every
        # matmul has one row instead of two, and the card's fp32 GEMMs
        # tile (and so sum) differently by row count
        err_solo = max(err_solo, check_close(
            f"19c request {r.rid} last hidden, batched vs alone",
            w32.hidden[r.rid], solo.last_hidden[0, -1], 1e-4, 1e-4))
    inter_plan = plan.with_(schedule="serve_interleaved", virtual_stages=2)
    inter = batching_session(short, inter_plan, f32, device)
    inter.reset_state()
    inter.set_params(interleaved_params(one.params, plan.pp, 2, inter.sched))
    _, reqs_i, w_i, _ = serve_trace(inter, 1, SEED, hidden=True)
    if {r.rid: r.tokens for r in reqs_i} != toks32:
        raise AssertionError("19c: serve_interleaved tokens != serve_1f's")
    err_inter = max(check_close(f"19c request {rid} last hidden, "
                                "interleaved vs 1f", w_i.hidden[rid], h,
                                1e-5, 1e-5)
                    for rid, h in w32.hidden.items())
    del inter
    spec32 = {kind: spec_run(device, short, spec_plan, one.params, kind,
                             toks32, None, "19c")[0]["acceptance_rate"]
              for kind in ("self", "oracle", "corrupt")}
    del one
    torch.cuda.empty_cache()
    seconds["19c"] = time.perf_counter() - t0
    log(f"[batching] 19c fp32 {BATCH_CONS_LAYERS} layers: the trace batched "
        f"equals each request alone in tokens, last hidden max|err| "
        f"{err_solo:.3e} (atol/rtol 1e-4); serve_interleaved pp {plan.pp} "
        f"x v 2 equals "
        f"serve_1f in tokens, hidden {err_inter:.3e} (atol/rtol 1e-5); "
        f"speculative tokens equal the plain tokens with self, oracle and "
        f"corrupted drafts (acceptance {spec32})")

    lat = report.per_token_latency_s()
    ttft = np.asarray([r.t_first - r.t_arrival for r in report.completed])
    record = {
        "model": spec.name, "schedule": "serve_1f", "pp": plan.pp,
        "slots": R_SLOTS, "rows": ROWS, "page": PAGE,
        "pool_pages": BATCH_POOL, "prefill_len": PREFILL,
        "cache_len": CACHE_LEN, "requests": len(reqs),
        "tokens": report.completed_tokens, "steps": report.steps,
        "decode_rounds": report.decode_rounds,
        "admit_rounds": report.admit_rounds, "seconds": run_s,
        "goodput_tokens_per_s": report.goodput_tokens_per_s,
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p99_s": float(np.percentile(ttft, 99)),
        "per_token_latency_p50_s": float(np.percentile(lat, 50)),
        "per_token_latency_p99_s": float(np.percentile(lat, 99)),
        "decode_ms_by_live_slots": by_live,
        "decode_ms_mean": float(np.mean(decode_ms)),
        "admit_ms": [round(a["ms"], 2) for a in watch.admits],
        "bucket_histogram": dict(sorted(hist.items())),
        "pool_dry_stalls": report.pool_stalls,
        "near_tie_positions": ties, "largest_served_gap": worst,
        "logit_diff_vs_reference": noise,
        "spec_k": SPEC_K, "speculative": spec_runs,
        "acceptance_rate": spec_runs["self"]["acceptance_rate"],
        "fp32_hidden_err": {"batched_vs_alone": err_solo,
                            "interleaved_vs_1f": err_inter},
        "fp32_acceptance": spec32,
        "seconds_by_part": seconds}
    launches = {"decode_q1": counts_a["paged_attention"],
                "reference_flash": ref_counts["flash_attention"],
                "verify_q5": sum(c["paged_attention"]
                                 for c in counts_b.values())}
    return record, launches, tile_err


def interleaved_params(params, S, v, sched):
    """``serve_1f`` parameters (S stages of L/S layers) as
    ``serve_interleaved``'s: S·v chunks of L/(S·v) layers, stacked in the
    schedule's storage order (row s·v + j holds chunk j·S + s)."""
    import torch
    lps = len(params["stages"])
    lpc = S * lps // (S * v)
    order = sched.storage_chunk_order().tolist()

    def layer(g, node):
        if isinstance(node, dict):
            return {k: layer(g, x) for k, x in node.items()}
        return node[g // lps]

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack(nodes)

    glob = [layer(g, params["stages"][f"layer_{g % lps}"])
            for g in range(S * lps)]
    flat_w = [w for row in params["layer_windows"] for w in row]
    flat_t = [t for row in params["layer_thetas"] for t in row]
    out = dict(params)
    out["stages"] = {f"layer_{k}": stack([glob[c * lpc + k] for c in order])
                     for k in range(lpc)}
    out["layer_windows"] = [[flat_w[c * lpc + k] for k in range(lpc)]
                            for c in order]
    out["layer_thetas"] = [[flat_t[c * lpc + k] for k in range(lpc)]
                           for c in order]
    return out


def verify_record(device, err, launches):
    """The paged kernel at the verify tile of 19b: bf16 q (2, SPEC_K + 1,
    40, 128), PREFILL + 37 keys a row (a round from mid-page), enough
    input sets cycled to fill L2 four times."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    lengths = [PREFILL + 37, PREFILL + 37]
    live = 2 * sum(-(-n // PAGE) for n in lengths) * PAGE * 8 * 128 * 2
    n_sets = -(-4 * L2_BYTES // live)
    sets, tab, lens = paged_inputs(torch.bfloat16, device, SPEC_K + 1,
                                   lengths, seed=21, n_copies=n_sets)
    it = {"i": 0}

    def run(fn):
        def call():
            q, kp, vp = sets[it["i"] % n_sets]
            it["i"] += 1
            fn(q, kp, vp, tab, lens)
        return call

    # three profiles in one run: the tile's device time moved 1.7x
    # between two runs of the whole script, so its spread is recorded
    ms_repeats = [device_ms(run(pa.paged_attention), 2 * n_sets,
                            "paged_attention") for _ in range(3)]
    ms = float(np.median(ms_repeats))
    ms_events = time_ms(run(pa.paged_attention))
    plain = time_ms(run(pa.paged_attention_plain))
    kc = paged_cost(sets[0][0], sets[0][1], tab, lengths, -1)
    return {"name": "paged_attention_verify", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:51",
            "launches": launches, "launches_by_path": {
                "qwen3_speculative_serve": launches},
            "max_abs_err": err, "tolerance": TOL, "ms": ms,
            "ms_repeats": ms_repeats,
            "ms_events": ms_events, "ms_by": PAGED_MS_BY,
            "plain_ms": plain, **bound_fields(kc), "library_ms": None,
            "shape": {"q": list(sets[0][0].shape),
                      "pool": list(sets[0][1].shape), "lengths": lengths}}


def kernel_records(device, errs, launches):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    bf16 = torch.bfloat16
    # paged, one decode call of the main path.  A call reads only its live
    # pages (~4.3 MB of K and V), so enough input sets are cycled that
    # their live pages fill L2 four times over and come from HBM
    lengths = [PREFILL + N_DECODE, PREFILL + N_DECODE]
    live = 2 * sum(-(-n // PAGE) for n in lengths) * PAGE * 8 * 128 * 2
    n_sets = -(-4 * L2_BYTES // live)
    sets, tab, lens = paged_inputs(bf16, device, 1, lengths, seed=5,
                                   n_copies=n_sets)
    it = {"i": 0}

    def run(fn):
        def call():
            q, kp, vp = sets[it["i"] % n_sets]
            it["i"] += 1
            fn(q, kp, vp, tab, lens)
        return call

    # device time of the split walk and the merge a call; CUDA events
    # around back-to-back calls measure the host's launch pace here
    p_ms = device_ms(run(pa.paged_attention), 2 * n_sets, "paged_attention")
    p_events = time_ms(run(pa.paged_attention))
    p_plain = time_ms(run(pa.paged_attention_plain))
    splits, per = pa.plan_splits(tab.shape[1], tab.shape[0], 8,
                                 pa._sm_count(device.index or 0))
    paged_design = {
        "design": f"split-k n={splits} ({per} pages a split; {ROWS} rows x "
                  f"8 KV heads x {splits} = {ROWS * 8 * splits} blocks), "
                  f"4-page cp.async ring; scores: keys across 8 warps, 8 "
                  f"query rows a K chunk; softmax and PV: a warp a query "
                  f"row; merge kernel",
        "ptxas": ptxas_report("paged_attention", "paged_attention"),
        "smem_dynamic_bytes": pa._bind().paged_attention_smem_bytes(
            1, 5, 128, PAGE, 2)}
    p_cost = paged_cost(sets[0][0], sets[0][1], tab, lengths, -1)
    del sets
    p8 = paged_int8_record(device, errs["paged_attention_int8"],
                           launches["paged_attention_int8"], lengths)
    p8.update(paged_design, smem_dynamic_bytes=pa._bind(
        ).paged_attention_smem_bytes(1, 5, 128, PAGE, 1))
    # flash, the main path's full_transformer call
    g = torch.Generator(device=device).manual_seed(2)
    b, s = R_SLOTS * ROWS, PREFILL + N_DECODE
    q = torch.randn((b, s, 40, 128), generator=g, device=device).to(bf16)
    k = torch.randn((b, s, 8, 128), generator=g, device=device).to(bf16)
    v = torch.randn((b, s, 8, 128), generator=g, device=device).to(bf16)
    f_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    f_plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    f_lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    f_cost = cost.flash_fwd(q, k, v, causal=True)
    fb = flash_bwd_record(device, errs["flash_attention_bwd"],
                          launches["flash_attention_bwd"])
    w = wkv6_record(device, errs["wkv6"], launches["wkv6"],
                    launches["wkv6_by_design"])
    mb = mamba_record(device, errs["mamba_scan"], launches["mamba_scan"])
    return [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:51",
         "launches": sum(launches["paged_attention"].values()),
         "launches_by_path": launches["paged_attention"],
         "max_abs_err": errs["paged_attention"], "tolerance": TOL, "ms": p_ms,
         "ms_events": p_events, "ms_by": PAGED_MS_BY,
         "plain_ms": p_plain, **bound_fields(p_cost),
         "library_ms": None, **paged_design},
        p8,
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:39",
         "launches": sum(launches["flash_attention"].values()),
         "launches_by_path": launches["flash_attention"],
         "max_abs_err": errs["flash_attention"], "tolerance": TOL, "ms": f_ms,
         "plain_ms": f_plain, **bound_fields(f_cost),
         "library_ms": f_lib,
         "design": "wgmma+cp.async ring: 128 query rows a CTA (two "
                   "warpgroups, two CTAs an SM), 64-key K/V tiles in a "
                   "2-stage ring, m64n64k16 QK^T and register-A "
                   "m64n128k16 PV (bf16); f32 on CUDA cores",
         "ptxas": ptxas_report("flash_attention", "flash_attention"),
         "smem_dynamic_bytes": fa._bind().flash_attention_smem_bytes(1, 128)},
        fb,
        w,
        mb,
    ]


def flash_bwd_record(device, err, launches):
    """The backward kernel at the training path's call: (1, TRAIN_SEQ,
    40 / 8, 128) bf16, causal; beside the plain version and autograd of
    ``F.scaled_dot_product_attention`` (its backward alone, timed over
    one recorded graph) as the yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attention as fa
    bf16 = torch.bfloat16
    b, s = TRAIN_ROWS, TRAIN_SEQ
    q, k, v, do = flash_inputs(bf16, device, b, s, seed=3)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)

    def call():
        fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)

    ms = time_ms(call)
    by_kernel = per_launch_ms(call, 5, ("flash_bwd_delta_kernel<",
                                        "flash_bwd_dkdv_kernel<",
                                        "flash_bwd_dq_kernel<"))
    plain = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, causal=True), iters=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ref = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    lib = time_ms(lambda: torch.autograd.grad(ref, (qt, kt, vt), dot,
                                              retain_graph=True))
    # relative L2 error of the kernel's and the library's bf16 gradients
    # against the f32 recurrence on the same bf16 values (P and dS not
    # rounded): what the bf16 rounding of P and dS costs, beside the
    # library's own
    exact = fa.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), lse, do.float(),
        causal=True)
    mine = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    theirs = [g.transpose(1, 2) for g in torch.autograd.grad(
        ref, (qt, kt, vt), dot)]
    rel_err = {who: [((g.float() - e).norm() / e.norm()).item()
                     for g, e in zip(grads, exact)]
               for who, grads in (("kernel", mine), ("library", theirs))}
    del exact, mine, theirs
    h, kv, dh = 40, 8, 128
    kc = cost.flash_bwd(q, k, v, causal=True)
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:39 (its "
                        "gradient: no TPU kernel has a backward; JAX "
                        "differentiates the kernel's jnp twin)",
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": err, "tolerance": TOL, "ms": ms,
            "ms_by_kernel": by_kernel,
            "ms_by_kernel_by": "torch.profiler device time, mean of a "
                               "launch",
            "plain_ms": plain, **bound_fields(kc),
            "library_ms": lib,
            "library": "autograd of F.scaled_dot_product_attention "
                       "(is_causal, enable_gqa), backward alone",
            "rel_l2_err_vs_f32": rel_err,
            "rel_l2_err_order": ["dq", "dk", "dv"],
            "shape": [b, s, h, kv, dh],
            "design": "bf16 FA-2 recurrence on wgmma, no atomics: D = "
                      "rowsum(dO*O); dK/dV kernel: 128 keys a CTA (two "
                      "warpgroups of 64), K and V in smem, the group's "
                      "query heads x 64-query tiles (last first) through "
                      "a 2-stage cp.async Q/dO ring, S^T and dP^T SS "
                      "m64n64k16, P^T and dS^T in bf16 register-A "
                      "m64n128k16 into dV and dK; dQ kernel: 128 queries "
                      "a CTA, Q and dO as register A fragments, 3-stage "
                      "K/V ring, dQ products left running under the next "
                      "tile's; warpgroups take turns issuing S and dP; "
                      "f32 on CUDA cores (4x4 score blocks a thread)",
            "ptxas": ptxas_report("flash_attention_bwd", "flash_bwd"),
            "smem_dynamic_bytes": fa._bind_bwd(
                ).flash_attention_bwd_smem_bytes(1, dh)}


def paged_int8_record(device, err, launches, lengths):
    """The int8 page walk at the quantized serve path's decode call: bf16
    q (2, 40, 128), int8 pools with f32 scales, PREFILL + N_DECODE keys
    a row.  A call reads ~2.2 MB of live int8 pages, so enough input sets
    are cycled that they fill L2 four times over and come from HBM."""
    from repro_torch.kernels import paged_attention as pa
    import torch
    live = 2 * sum(-(-n // PAGE) for n in lengths) * PAGE * 8 * 128
    n_sets = -(-4 * L2_BYTES // live)
    sets, tab, lens, _ = paged_int8_inputs(torch.bfloat16, device, 1,
                                           lengths, seed=6, n_copies=n_sets)
    it = {"i": 0}

    def run(fn):
        def call():
            q, kq, vq, ks, vs = sets[it["i"] % n_sets]
            it["i"] += 1
            fn(q, kq, vq, tab, lens, k_scale=ks, v_scale=vs)
        return call

    ms = device_ms(run(pa.paged_attention), 2 * n_sets, "paged_attention")
    ms_events = time_ms(run(pa.paged_attention))
    plain = time_ms(run(pa.paged_attention_plain))
    kc = paged_cost(sets[0][0], sets[0][1], tab, lengths, -1,
                    k_scale=sets[0][3])
    return {"name": "paged_attention_int8", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:51",
            "launches": sum(launches.values()),
            "launches_by_path": launches, "max_abs_err": err[0],
            "max_abs_err_vs_unquantized": err[1], "tolerance": TOL,
            "ms": ms, "ms_events": ms_events, "ms_by": PAGED_MS_BY,
            "plain_ms": plain, **bound_fields(kc), "library_ms": None,
            "shape": {"q": list(sets[0][0].shape),
                      "pool": list(sets[0][1].shape), "lengths": lengths}}


def wkv6_record(device, err, launches, by_design):
    """wkv6 at the serve path's shapes, bf16, from a state: the prefill
    call (8, 1024, 32, 64) on the chunked design, whose 176 MB exceed L2,
    timed with CUDA events; and the decode call (8, 1, 32, 64) on the
    stepwise design, cycling enough states (4.2 MB each) to fill L2 four
    times, as the step finds each slot's state cold, timed as device time
    (:func:`device_ms`): its few microseconds are less than the wrapper's
    host time.  ``launches_by_design`` splits the main paths' launches."""
    import torch
    from repro_torch.kernels import cost
    from repro_torch.kernels import wkv6 as wk
    bf16 = torch.bfloat16
    args, s0 = wkv6_inputs(bf16, device, RWKV_ROWS, RWKV_PREFILL, seed=11)
    if wk.design(RWKV_PREFILL, RWKV_DH, bf16) != "chunked" or \
            wk.design(1, RWKV_DH, bf16) != "stepwise":
        raise AssertionError("wkv6 prefill / decode designs changed")
    ms = time_ms(lambda: wk.wkv6(*args, s0), iters=20)
    plain = time_ms(lambda: wk.wkv6_plain(*args, s0), iters=3, warmup=1)
    kc = cost.wkv6(*args, s0)
    dargs, _ = wkv6_inputs(bf16, device, RWKV_ROWS, 1, seed=12,
                           with_state=False)
    state_bytes = RWKV_ROWS * RWKV_H * RWKV_DH * RWKV_DH * 4
    n_sets = -(-4 * L2_BYTES // state_bytes)
    states = [torch.randn((RWKV_ROWS, RWKV_H, RWKV_DH, RWKV_DH),
                          device=device) for _ in range(n_sets)]
    it = {"i": 0}

    def run(fn):
        def call():
            fn(*dargs, states[it["i"] % n_sets])
            it["i"] += 1
        return call

    d_ms = device_ms(run(wk.wkv6), 4 * n_sets, "wkv6_kernel")
    d_plain = device_ms(run(wk.wkv6_plain), n_sets)
    d_bound = cost.wkv6(*dargs, states[0]).bound()
    ptxas = ptxas_report("wkv6", "wkv6")
    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6.py:32",
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "launches_by_design": by_design,
            "max_abs_err": err, "tolerance": TOL, "ms": ms,
            "plain_ms": plain, **bound_fields(kc), "library_ms": None,
            "shape": [RWKV_ROWS, RWKV_PREFILL, RWKV_H, RWKV_DH],
            "design": "prefill (bf16, S >= 16): chunked, 16-token chunks on "
                      "mma.sync m16n8k16 with hi/lo bf16 splits, the state "
                      "as accumulator fragments of 4 consumer warps, 4 "
                      "producer warps (cp.async ring, running products, "
                      "in-half pair weights by running products, cross-"
                      "half on the tensor cores); decode (S = 1) and f32: "
                      "stepwise, a thread per state column",
            "ptxas": ptxas,
            "smem_dynamic_bytes": wk._bind().wkv6_chunked_smem_bytes(RWKV_DH),
            "decode_design": "stepwise",
            "decode_ms": d_ms, "decode_plain_ms": d_plain,
            "decode_bound_ms": 1e3 * d_bound[0],
            "decode_bound_by": d_bound[1]}


def mamba_record(device, err, launches):
    """mamba_scan at the jamba serve path's shapes and dtype (the engine
    calls it in f32, from the slot's state): the prefill call (2, 1024,
    8192, N 16), whose 201 MB of u, dt and y exceed L2 four times, timed
    with CUDA events; and the decode call (2, 1, 8192), cycling enough
    states (1 MB each) to fill L2 four times, as the step finds each
    slot's state cold, timed as device time (:func:`device_ms`)."""
    import torch
    from repro_torch.core.profiler import H100_SXM
    from repro_torch.kernels import cost
    from repro_torch.kernels import mamba_scan as ms
    f32 = torch.float32
    args, h0 = mamba_inputs(f32, device, JAMBA_ROWS, JAMBA_PREFILL, seed=41)
    t_ms = time_ms(lambda: ms.mamba_scan(*args, h0), iters=20)
    plain = time_ms(lambda: ms.mamba_scan_plain(*args, h0), iters=3,
                    warmup=1)
    kc = cost.mamba_scan(*args, h0)
    dargs, _ = mamba_inputs(f32, device, JAMBA_ROWS, 1, seed=42,
                            with_state=False)
    state_bytes = JAMBA_ROWS * MAMBA_CI * MAMBA_N * 4
    n_sets = -(-4 * L2_BYTES // state_bytes)
    states = [torch.randn((JAMBA_ROWS, MAMBA_CI, MAMBA_N), device=device)
              for _ in range(n_sets)]
    it = {"i": 0}

    def run(fn):
        def call():
            fn(*dargs, states[it["i"] % n_sets])
            it["i"] += 1
        return call

    d_ms = device_ms(run(ms.mamba_scan), 4 * n_sets, "mamba_scan_kernel")
    d_plain = device_ms(run(ms.mamba_scan_plain), n_sets)
    # operations: f32 arithmetic at the CUDA-core rate and the exps at the
    # SFU rate; the bound is the largest of the three times
    d_cost = cost.mamba_scan(*dargs, states[0])
    d_bound = d_cost.bound()
    return {"name": "mamba_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan.py:31",
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": err[0], "max_abs_err_by_case": err[1],
            "tolerance": TOL, "ms": t_ms, "plain_ms": plain,
            **bound_fields(kc), "library_ms": None,
            "shape": [JAMBA_ROWS, JAMBA_PREFILL, MAMBA_CI, MAMBA_N],
            "dtype": "float32",
            "bytes_bound_ms": 1e3 * kc.bytes / H100_SXM.hbm_bw,
            "flops_bound_ms": 1e3 * kc.flops / H100_SXM.flops_peak_f32,
            "exps": kc.exps,
            "exp_ms_at_sfu_rate": 1e3 * kc.exps / H100_SXM.exp_rate,
            "design": f"state split over lanes: {MAMBA_N // 8} lanes a "
                      f"channel, 8 entries a lane (ex2.approx on A·log2 e, "
                      f"shuffle sum of y), 64 channels a block; u, dt, B, C "
                      f"by cp.async in 64-token stages (double-buffered); y "
                      f"through shared memory, 16-byte row stores; decode "
                      f"(S = 1) straight from global memory",
            "ptxas": ptxas_report("mamba_scan", "mamba_scan"),
            "smem_dynamic_bytes": ms._bind().mamba_scan_smem_bytes(
                0, MAMBA_N),
            "decode_ms": d_ms, "decode_plain_ms": d_plain,
            "decode_bound_ms": 1e3 * d_bound[0],
            "decode_bound_by": d_bound[1], "decode_bound_unit": d_bound[2],
            "decode_exps": d_cost.exps}


def scaling_probe(fn, shapes) -> dict:
    """The kernel's ms (CUDA events) at each of ``shapes`` ({label:
    args}): whether the time follows S (a serial walk over the sequence)
    or the work (H or Ci)."""
    return {label: time_ms(lambda a=args: fn(*a), iters=10)
            for label, args in shapes.items()}


def wkv6_bwd_record(device, errs, plain_ms, launches):
    """wkv6's backward at the rwkv6 training call (TRAIN_WKV, bf16, as
    22a runs it), timed with CUDA events (its 151 MB of inputs and
    outputs exceed L2); the scaling probe at half S and half H."""
    import torch
    from repro_torch.kernels import cost
    from repro_torch.kernels import wkv6 as wk
    args = wkv6_bwd_inputs(torch.bfloat16, device, 60)
    ms = time_ms(lambda: wk.wkv6_bwd(*args), iters=10)
    by_kernel = per_launch_ms(lambda: wk.wkv6_bwd(*args), 5,
                              ("wkv6_bwd_local<", "wkv6_bwd_combine<",
                               "wkv6_bwd_chunk<", "wkv6_bwd_du<"))
    kc = cost.wkv6_bwd(*args[:5])
    b, s, h, dh = TRAIN_WKV
    scratch = 4 * wk._bind_bwd().wkv6_bwd_scratch_floats(b, s, h, dh)
    probe = scaling_probe(wk.wkv6_bwd, {
        str([b, s, h, dh]): args,
        str([b, s // 2, h, dh]): [a if i == 4 else a[:, :s // 2].contiguous()
                                  for i, a in enumerate(args)],
        str([b, s, h // 2, dh]): [a[:h // 2].contiguous() if i == 4
                                  else a[:, :, :h // 2].contiguous()
                                  for i, a in enumerate(args)]})
    return {"name": "wkv6_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wkv6_bwd.cu",
            "replaces": "none: the backward of src/repro/kernels/wkv6.py:32 "
                        "(pallas_call :95), which has none; JAX "
                        "differentiates the jnp twin "
                        "src/repro/models/nn.py:754 (wkv6_chunked)",
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": max(e for case in errs.values()
                               for e, _ in case.values()),
            "errors_by_case": errs, "tolerance": WKV6_BWD_TOL, "ms": ms,
            "ms_by_kernel": by_kernel,
            "ms_by_kernel_by": "torch.profiler device time, mean of a "
                               "launch",
            "plain_ms": plain_ms["bf16 w=0"], "plain_ms_by_case": plain_ms,
            **bound_fields(kc), "library_ms": None,
            "library": "none", "shape": list(TRAIN_WKV), "dtype": "bfloat16",
            "scratch_bytes": scratch, "scaling_ms": probe,
            "design": "split the sequence, find the boundary states, "
                      "finish every piece at once: chunks of 64 tokens; "
                      "A: each chunk's decay, ΔS and ΔG as two products "
                      "on the CUDA cores (persistent CTAs, the next "
                      "item's loads in flight); B: S_in and G_out of "
                      "every chunk by an ordered walk over chunks; C: a "
                      "CTA a (chunk, head) holds the state, 2 x 4 a "
                      "thread, its inputs by cp.async a sub-chunk at a "
                      "time, two ahead (bf16 through a two-slot ring), "
                      "walks S forward keeping it every 8 tokens "
                      "in shared memory, then each "
                      "8-token sub-chunk in "
                      "reverse: states recomputed into registers (dr), G "
                      "walked back (dk, dv, dw); sums over e by a "
                      "transpose-reduction within the warp, over d across "
                      "warps in shared memory; du's chunk partials summed "
                      "by a last launch (no atomics)",
            "ptxas": ptxas_report("wkv6_bwd", "wkv6_bwd")}


def mamba_bwd_record(device, errs, plain_ms, launches):
    """mamba_scan's backward at the jamba training call (TRAIN_MAMBA, f32),
    timed with CUDA events (its 0.7 GB of inputs and outputs exceed L2);
    the scaling probe at half S and half Ci.  Operations: 24 f32 a
    (token, channel, entry) (the state's recompute 4, dh 2, du 2, ddt 4,
    dA 3, dB 2, dC 4, the two decays 2, the sums 1) and one exp at the
    SFU rate; the bound is the largest time."""
    from repro_torch.kernels import cost
    from repro_torch.kernels import mamba_scan as ms
    args = mamba_bwd_inputs(device, 70)
    t_ms = time_ms(lambda: ms.mamba_scan_bwd(*args), iters=10)
    by_kernel = per_launch_ms(lambda: ms.mamba_scan_bwd(*args), 5,
                              ("mamba_bwd_local<", "mamba_bwd_combine<",
                               "mamba_bwd_seg<", "mamba_bwd_finish<"))
    u, A = args[0], args[2]
    b, s, ci = u.shape
    n = A.shape[1]
    kc = cost.mamba_scan_bwd(*args[:6])
    scratch = 4 * ms._bind_bwd().mamba_scan_bwd_scratch_floats(b, s, ci, n)
    half_s = [a if i in (2, 5) else a[:, :s // 2].contiguous()
              for i, a in enumerate(args)]
    half_c = [a[:ci // 2].contiguous() if i in (2, 5)
              else a if i in (3, 4) else a[:, :, :ci // 2].contiguous()
              for i, a in enumerate(args)]
    probe = scaling_probe(ms.mamba_scan_bwd, {
        str([b, s, ci, n]): args, str([b, s // 2, ci, n]): half_s,
        str([b, s, ci // 2, n]): half_c})
    return {"name": "mamba_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
            "replaces": "none: the backward of "
                        "src/repro/kernels/mamba_scan.py:31 (pallas_call "
                        ":86), which has none; JAX differentiates the jnp "
                        "twin src/repro/models/nn.py:649 (selective_scan)",
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": max(e for e, _ in errs.values()),
            "errors": errs, "tolerance": MAMBA_BWD_TOL, "ms": t_ms,
            "ms_by_kernel": by_kernel,
            "ms_by_kernel_by": "torch.profiler device time, mean of a "
                               "launch",
            "plain_ms": plain_ms, **bound_fields(kc), "exps": kc.exps,
            "library_ms": None,
            "library": "none", "shape": list(TRAIN_MAMBA),
            "dtype": "float32", "scratch_bytes": scratch,
            "scaling_ms": probe,
            "design": "split the sequence, find the boundary states, "
                      "finish every piece at once: segments of 128 tokens, "
                      "a CTA a (64 channels, segment, row), two CTAs an "
                      "SM, a channel's 16 entries over 4 lanes; A: each "
                      "segment's decay, "
                      "local end state and local gradient carry in one "
                      "walk; B: h_in and the carry of every segment by an "
                      "ordered walk; C: h walked forward from h_in, kept "
                      "every 8 tokens in shared memory, then each 8-token "
                      "sub-chunk in reverse: a_t and h_{t-1} recomputed "
                      "into registers (one exp), dh walked back; du, ddt "
                      "by shuffles over a channel's lanes, dB, dC by a "
                      "transpose-reduction over a warp's channels, shared "
                      "memory over its warps and per-block partials; "
                      "inputs by cp.async through a 3-slot ring, two "
                      "sub-chunks ahead; a last pass sums the partials in "
                      "a fixed order (no atomics); du, ddt, dB, dC "
                      "staged and stored behind the next sub-chunk",
            "ptxas": ptxas_report("mamba_scan_bwd", "mamba_bwd")}


# --------------------------------------------------------------------------
# phase 20: the serving planner, windowed ring caches, h2o-danube3-4b
# --------------------------------------------------------------------------

def allocated(device) -> int:
    """Bytes the caching allocator holds in live tensors on ``device``
    (whole blocks: a cached block up to 1 MB larger than a request is
    handed out unsplit)."""
    import torch
    torch.cuda.synchronize(device)
    return torch.cuda.memory_allocated(device)


def requested(device) -> int:
    """Bytes the live tensors on ``device`` asked the allocator for."""
    import torch
    torch.cuda.synchronize(device)
    return torch.cuda.memory_stats(device)["requested_bytes.all.current"]


def phase_serving_plan(device, spec, base):
    """20a: ``plan_search(workload="decode")`` for ``spec`` at pp 1 x tp 1
    on an H100 (80 GB), cache SPLAN_CACHE, SPLAN_BATCH rows (R SPLAN_R), bf16
    KV: dense must be over budget and paged at SPLAN_PAGE / SPLAN_OCC must
    fit; the chosen plan's session (its pool the occupancy's pages) holds
    weights and cache within MEM_RTOL of the model's; PLAN_REQUESTS
    ragged prompts, SPLAN_DECODE decodes at SPLAN_R live slots."""
    import math
    import torch
    from repro_torch.core.partitioner import plan_search
    from repro_torch.core.profiler import H100_SXM
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.engine import build_serving
    kw = dict(minibatch_tokens=SPLAN_BATCH // SPLAN_R, workload="decode",
              cache_len=SPLAN_CACHE, global_batch=SPLAN_BATCH,
              kv_dtype="bf16")
    dense = plan_search(spec, base, 1, H100_SXM, return_all=True, **kw)
    if any(c.feasible for c in dense):
        raise AssertionError("20a: a dense decode plan fits 80 GB: "
                             f"{[c.describe() for c in dense]}")
    chosen = plan_search(spec, base, 1, H100_SXM, page_size=SPLAN_PAGE,
                         occupancy=SPLAN_OCC, **kw)
    mm = chosen.memory
    for c in dense:
        log(f"[plan-serve] dense {c.describe()}")
    log(f"[plan-serve] paged page {SPLAN_PAGE} at occupancy {SPLAN_OCC}: "
        f"{chosen.describe()}; predicted {mm}")
    R = chosen.plan.decode_microbatches
    # the pool the priced occupancy implies: whole slots' worth of pages
    pool_pages = math.ceil(SPLAN_OCC * R) * SPLAN_CACHE // SPLAN_PAGE
    session = build_serving(spec, chosen.plan, cache_len=SPLAN_CACHE,
                            global_batch=SPLAN_BATCH,
                            compute_dtype=torch.bfloat16,
                            page_size=SPLAN_PAGE,
                            prefill_len=SPLAN_PROMPTS[-1],
                            pool_pages=pool_pages, kv_dtype="bf16",
                            device=device)
    m0 = allocated(device)
    t0 = time.perf_counter()
    session.init_weights(SEED)
    m1 = allocated(device)
    init_s = time.perf_counter() - t0
    session.reset_state()
    m2 = allocated(device)
    measured = {"weight_bytes": m1 - m0, "cache_bytes": m2 - m1}
    predicted = {"weight_bytes": mm.weight_bytes,
                 "cache_bytes": mm.cache_bytes}
    rel = {k: measured[k] / predicted[k] - 1 for k in measured}
    log(f"[plan-serve] measured weights {measured['weight_bytes'] / 1e9:.4f} "
        f"GB (model {mm.weight_bytes / 1e9:.4f}), cache "
        f"{measured['cache_bytes'] / 1e9:.4f} GB (model "
        f"{mm.cache_bytes / 1e9:.4f}, a pool of {pool_pages} pages); "
        f"relative {rel} (limit {MEM_RTOL}); weights drawn in {init_s:.2f}s")
    if any(abs(r) > MEM_RTOL for r in rel.values()):
        raise AssertionError(f"20a: measured {measured} vs the model "
                             f"{predicted}")
    rng = np.random.default_rng(SEED + 20)
    rows = session.rows
    lens = np.linspace(*SPLAN_PROMPTS, R).astype(np.int64)
    prompts = rng.integers(0, spec.vocab, (R, rows, SPLAN_PROMPTS[-1])
                           ).astype(np.int32)
    reset_counts()
    t0 = time.perf_counter()
    nxt = session.prefill({"tokens": prompts, "lens": lens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    first = nxt.cpu().numpy()
    toks, step_s = [first], []
    per_step = spec.n_layers * R
    for i in range(SPLAN_DECODE):
        before = pa.paged_attention.launches
        t0 = time.perf_counter()
        nxt = session.decode(nxt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if pa.paged_attention.launches - before != per_step:
            raise AssertionError(f"20a decode step {i}: paged launches "
                                 f"{pa.paged_attention.launches - before}, "
                                 f"expected {per_step}")
        toks.append(nxt.cpu().numpy())
    counts = read_counts()
    if counts != {"paged_attention": per_step * SPLAN_DECODE,
                  "paged_attention_int8": 0, "flash_attention": 0,
                  "flash_attention_bwd": 0, "wkv6": 0, "mamba_scan": 0}:
        raise AssertionError(f"20a launches {counts}")
    toks = np.stack(toks)
    if not ((toks >= 0) & (toks < spec.vocab)).all() or \
            not torch.isfinite(session.last_hidden).all():
        raise AssertionError("20a: tokens outside the vocabulary or "
                             "non-finite hidden states")
    session._alloc.check()
    used = int(session._alloc.live_pages)
    # slot 0's first token against full_transformer over its prompt
    reset_counts()
    seq = prompts[0][:, :lens[0]]
    logits = sequence_logits(session, seq)[:, -1]
    ref_flash = read_counts()["flash_attention"]
    gap = (logits.amax(-1) - logits.gather(
        -1, torch.from_numpy(first.reshape(R, rows)[0].astype(np.int64)
                             ).to(logits.device)[:, None])[:, 0])
    if (gap > BATCH_TIE).any() or ref_flash != spec.n_layers:
        raise AssertionError(f"20a: slot 0's first tokens are not "
                             f"full_transformer's (gaps {gap.tolist()}, "
                             f"limit {BATCH_TIE}; flash launches "
                             f"{ref_flash})")
    step_ms = 1e3 * float(np.mean(step_s))
    full_r = next(c for c in dense if c.plan.schedule == chosen.plan.schedule
                  and c.plan.virtual_stages == chosen.plan.virtual_stages)
    log(f"[plan-serve] {R} requests (slots of {rows} rows), prompts "
        f"{lens.tolist()}: prefill {prefill_s:.3f}s; decode {SPLAN_DECODE} "
        f"steps at {R} live slots {step_ms:.2f} ms/step (predicted round: "
        f"{1e3 * full_r.round_time:.3f} ms at R {R}, "
        f"{1e3 * chosen.round_time:.3f} ms on the chosen bucket "
        f"{chosen.bucket}; informative); {used} of {pool_pages} pages "
        f"live; slot 0's first tokens within {gap.max().item():.4f} of "
        f"full_transformer's maximum logit")
    record = {
        "model": spec.name, "layers": spec.n_layers, "cache_len": SPLAN_CACHE,
        "global_batch": SPLAN_BATCH, "slots": R, "rows": rows,
        "dense": [{"plan": c.describe(), "total_gb": c.memory.total_bytes
                   / 1e9, "cache_gb": c.memory.cache_bytes / 1e9,
                   "feasible": c.feasible} for c in dense],
        "chosen": chosen.describe(), "page": SPLAN_PAGE,
        "occupancy": SPLAN_OCC, "bucket": chosen.bucket,
        "pool_pages": pool_pages, "predicted": predicted,
        "measured": measured, "relative": rel,
        "predicted_round_ms": {"full_r": 1e3 * full_r.round_time,
                               "bucket": 1e3 * chosen.round_time},
        "decode_ms_per_step": step_ms, "decode_ms": [1e3 * x for x in
                                                     step_s],
        "prefill_s": prefill_s, "prompt_lens": lens.tolist(),
        "live_pages": used, "first_token_gap": gap.max().item()}
    return record, counts["paged_attention"], ref_flash


def danube_session(device, spec, plan, dtype, cache_len, **kw):
    from repro_torch.serving.engine import build_serving
    return build_serving(spec, plan, cache_len=cache_len,
                         global_batch=DANUBE_SLOTS * DANUBE_ROWS,
                         compute_dtype=dtype, device=device, **kw)


def phase_serve_danube(device, spec, plan):
    """20b: ``spec`` (h2o-danube3-4b, all 24 layers) in bf16 through the
    paged engine past its window: DANUBE_PROMPT-token prompts, cache
    DANUBE_CACHE, DANUBE_DECODE decodes through the paged kernel at Dh
    120; the served tokens are ``full_transformer``'s (the flash kernel
    at Dh 120, window 4096) greedy tokens up to near-ties (DANUBE_TIE)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    session = danube_session(device, spec, plan, torch.bfloat16,
                             DANUBE_CACHE, page_size=PAGE,
                             prefill_len=DANUBE_PROMPT)
    t0 = time.perf_counter()
    session.start(SEED)
    init_s = time.perf_counter() - t0
    lps = spec.layers_per_stage(plan.pp)
    if session.cache_lens != [DANUBE_CACHE] * lps or \
            session.paged_layers != tuple(range(lps)):
        raise AssertionError(f"20b: a prefilling session keeps full-length "
                             f"paged caches, got {session.cache_lens}")
    rng = np.random.default_rng(SEED + 21)
    prompts = rng.integers(0, spec.vocab, (DANUBE_SLOTS, DANUBE_ROWS,
                                           DANUBE_PROMPT)).astype(np.int32)
    reset_counts()
    t0 = time.perf_counter()
    nxt = session.prefill({"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    toks, step_s = [nxt], []
    for _ in range(DANUBE_DECODE):
        t0 = time.perf_counter()
        nxt = session.decode(nxt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        toks.append(nxt)
    counts = read_counts()
    per_step = spec.n_layers * DANUBE_SLOTS
    if counts != {"paged_attention": per_step * DANUBE_DECODE,
                  "paged_attention_int8": 0, "flash_attention": 0,
                  "flash_attention_bwd": 0, "wkv6": 0, "mamba_scan": 0} \
            or pa.paged_attention.launches_by_q != {
                1: per_step * DANUBE_DECODE}:
        raise AssertionError(f"20b launches {counts}, by query count "
                             f"{pa.paged_attention.launches_by_q}")
    session._alloc.check()
    toks = torch.stack(toks).cpu().numpy()
    reset_counts()
    t0 = time.perf_counter()
    logits = reference_logits(session, prompts, toks, n_last=toks.shape[0])
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref_counts = read_counts()
    if ref_counts["flash_attention"] != spec.n_layers or \
            sum(ref_counts.values()) != spec.n_layers:
        raise AssertionError(f"20b reference launches {ref_counts}")
    if not torch.isfinite(logits).all():
        raise AssertionError("20b: non-finite reference logits")
    served = torch.from_numpy(toks.T.astype(np.int64)).to(logits.device)
    gap = logits.amax(-1) - logits.gather(-1, served[..., None])[..., 0]
    agree = logits.argmax(-1) == served
    step_ms = 1e3 * float(np.mean(step_s))
    log(f"[danube] {spec.name} {spec.n_layers} layers bf16 pp {plan.pp}, "
        f"R {DANUBE_SLOTS} x {DANUBE_ROWS}, Dh {spec.d_head}, window "
        f"{spec.blocks[0].window}: weights in {init_s:.2f}s; prefill "
        f"{DANUBE_PROMPT} tokens {prefill_s:.3f}s; decode {step_ms:.2f} "
        f"ms/step; paged launches {counts['paged_attention']}; "
        f"full_transformer over {DANUBE_PROMPT} + {DANUBE_DECODE} tokens "
        f"{ref_s:.3f}s, flash launches {ref_counts['flash_attention']}; "
        f"greedy equal at {int(agree.sum())}/{agree.numel()} positions, "
        f"largest gap {gap.max().item():.4f} (limit {DANUBE_TIE})")
    if (gap > DANUBE_TIE).any():
        raise AssertionError(
            f"20b: served tokens are not full_transformer's greedy tokens "
            f"at {int((gap > DANUBE_TIE).sum())} positions (gap up to "
            f"{gap.max().item():.4f} > {DANUBE_TIE})")
    return {"model": spec.name, "layers": spec.n_layers, "pp": plan.pp,
            "slots": DANUBE_SLOTS, "rows": DANUBE_ROWS,
            "prompt": DANUBE_PROMPT, "cache_len": DANUBE_CACHE,
            "decode_steps": DANUBE_DECODE, "init_s": init_s,
            "prefill_s": prefill_s, "decode_ms_per_step": step_ms,
            "reference_s": ref_s, "largest_served_gap": gap.max().item(),
            "greedy_equal": int(agree.sum()), "positions": agree.numel(),
            "weight_bytes": tensor_bytes(session.params),
            "pool_bytes": tensor_bytes(session.pages)}, \
        counts["paged_attention"], ref_counts["flash_attention"]


def phase_ring_caches(device, spec, plan):
    """20c: fp32, ``spec`` cut to RING_LAYERS layers of window
    RING_WINDOW: a session without ``prefill_len`` (ring caches) and one
    with it (full-length caches), the same weights, a RING_PROMPT-token
    prompt and RING_DECODE decodes: tokens equal, hidden states within
    1e-5, and each session's cache bytes (requested from the allocator
    around ``reset_state``) the serving memory model's (prefill False /
    True)."""
    import torch
    from repro_torch.core.schedule import (make_serving_schedule,
                                           serving_cache_bytes)
    sched = make_serving_schedule(plan)
    rng = np.random.default_rng(SEED + 22)
    prompts = rng.integers(0, spec.vocab, (DANUBE_SLOTS, DANUBE_ROWS,
                                           RING_PROMPT)).astype(np.int32)
    out, params = {}, None
    for kind, prefill_len in (("ring", 0), ("full", RING_PROMPT)):
        session = danube_session(device, spec, plan, torch.float32,
                                 RING_CACHE, prefill_len=prefill_len)
        if params is None:
            session.init_weights(SEED)
            params = session.params
        else:
            session.set_params(params)
        m0, r0 = allocated(device), requested(device)
        session.reset_state()
        cache = requested(device) - r0
        blocks = allocated(device) - m0
        priced = serving_cache_bytes(spec, plan, sched, cache_len=RING_CACHE,
                                     global_batch=DANUBE_SLOTS * DANUBE_ROWS,
                                     prefill=bool(prefill_len),
                                     kv_dtype="fp32")
        if cache != priced:
            raise AssertionError(f"20c {kind}: {cache} cache bytes, the "
                                 f"model prices {priced}")
        nxt = session.prefill({"tokens": prompts})
        toks, hidden = [nxt], [session.last_hidden.clone()]
        for _ in range(RING_DECODE):
            nxt = session.decode(nxt)
            toks.append(nxt)
            hidden.append(session.last_hidden.clone())
        out[kind] = {"lens": session.cache_lens, "cache": cache,
                     "blocks": blocks, "priced": priced,
                     "toks": torch.stack(toks).cpu().numpy(),
                     "hidden": hidden}
        del session
    lps = spec.layers_per_stage(plan.pp)
    if out["ring"]["lens"] != [RING_WINDOW] * lps or \
            out["full"]["lens"] != [RING_CACHE] * lps:
        raise AssertionError(f"20c cache lengths {out['ring']['lens']} / "
                             f"{out['full']['lens']}")
    if not (out["ring"]["toks"] == out["full"]["toks"]).all():
        raise AssertionError("20c: ring and full-length tokens differ")
    err = max(check_close(f"20c hidden step {i}", a, b, 1e-5, 1e-5)
              for i, (a, b) in enumerate(zip(out["ring"]["hidden"],
                                             out["full"]["hidden"])))
    log(f"[ring] {spec.name} fp32 {spec.n_layers} layers, window "
        f"{RING_WINDOW}, cache {RING_CACHE}: {RING_PROMPT} + {RING_DECODE} "
        f"tokens; rings of {out['ring']['lens']} = full-length "
        f"{out['full']['lens']} in tokens, hidden max|err| {err:.3e} "
        f"(atol/rtol 1e-5); cache bytes requested {out['ring']['cache']} / "
        f"{out['full']['cache']} = the model's {out['ring']['priced']:.0f} "
        f"/ {out['full']['priced']:.0f} (allocator blocks "
        f"{out['ring']['blocks']} / {out['full']['blocks']})")
    return {"window": RING_WINDOW, "cache_len": RING_CACHE,
            "layers": spec.n_layers, "decodes": RING_DECODE,
            "hidden_err": err,
            "cache_bytes": {k: out[k]["cache"] for k in out},
            "allocator_block_bytes": {k: out[k]["blocks"] for k in out},
            "priced_bytes": {k: out[k]["priced"] for k in out}}


def phase_planned_serving(device):
    """Phase 20 (20a-c, see the module docstring)."""
    import gc
    import torch
    from repro_torch import configs
    # phase 19's sessions sit in reference cycles (RoundWatch wraps their
    # methods in closures over them): collect them before 20a needs 51 GB
    held_gb = allocated(device) / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    before_gb = allocated(device) / 1e9
    log(f"[plan-serve] {before_gb:.3f} GB allocated before phase 20 "
        f"({held_gb:.3f} before collecting garbage)")
    seconds = {}
    t0 = time.perf_counter()
    cfg = configs.get("qwen3-14b")
    plan_rec, plan_paged, plan_flash = phase_serving_plan(
        device, cfg.full_spec(),
        cfg.PLAN.with_(pp=1, tp=1, decode_microbatches=SPLAN_R))
    torch.cuda.empty_cache()
    seconds["20a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = configs.get("h2o-danube-3-4b")
    full = cfg.full_spec()
    plan = cfg.PLAN.with_(pp=2, tp=1, decode_microbatches=DANUBE_SLOTS)
    danube_rec, danube_paged, danube_flash = phase_serve_danube(
        device, full, plan)
    torch.cuda.empty_cache()
    # int8 paged KV at Dh 120 (120-byte rows): the card's tokens = the CPU's
    short = dataclasses.replace(full, name=f"{full.name}-2l", n_layers=2,
                                blocks=full.blocks[:2])
    danube_rec["int8_kv"] = phase_consistency_quant(
        device, short, plan.with_(pp=1), n_decode=DANUBE_INT8_DECODE,
        weight_dtype="fp32", tag="danube-int8")
    torch.cuda.empty_cache()
    seconds["20b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cut = dataclasses.replace(
        full, name=f"{full.name}-{RING_LAYERS}l-w{RING_WINDOW}",
        n_layers=RING_LAYERS, blocks=tuple(
            dataclasses.replace(b, window=RING_WINDOW)
            for b in full.blocks[:RING_LAYERS]))
    ring_rec = phase_ring_caches(device, cut, plan.with_(pp=1))
    torch.cuda.empty_cache()
    seconds["20c"] = time.perf_counter() - t0
    log(f"[phases] 20 seconds: {json.dumps(seconds)}")
    record = {"plan": plan_rec, "danube": danube_rec, "ring": ring_rec,
              "allocated_before_gb": before_gb, "seconds": seconds}
    launches = {"qwen3_planned_serve": plan_paged,
                "qwen3_planned_serve_reference": plan_flash,
                "danube3_serve": danube_paged,
                "danube3_full_transformer": danube_flash,
                "danube3_int8_serve":
                    danube_rec["int8_kv"]["int8_launches"]}
    return record, launches


def dh120_flash_inputs(dtype, device, s, seed):
    """q, k, v, dO of h2o-danube3-4b's attention: (1, s, 32 / 8, 120)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    h, kv, dh = DH120_HEADS
    shapes = ((1, s, h, dh), (1, s, kv, dh), (1, s, kv, dh), (1, s, h, dh))
    return [torch.randn(sh, generator=g, device=device).to(dtype)
            for sh in shapes]


def dh120_paged_inputs(dtype, device, seed, n_copies=1):
    """A 20b decode call: one lane, DANUBE_PROMPT + DANUBE_DECODE keys of
    a DANUBE_CACHE slot, q (1, 1, 32, 120)."""
    return paged_inputs(dtype, device, 1, [DANUBE_PROMPT + DANUBE_DECODE],
                        seed, n_copies=n_copies, heads=DH120_HEADS,
                        cache_len=DANUBE_CACHE, slots=DANUBE_SLOTS)


def dh120_int8_inputs(q_dtype, device, seed, n_copies=1):
    """A 20b decode call over int8 pools (120-byte rows: the walk's
    8-byte chunks): one lane of DANUBE_PROMPT + DANUBE_DECODE keys, q (1,
    1, 32, 120); :func:`paged_int8_inputs`' sets, tables, lengths and f32
    pools."""
    return paged_int8_inputs(q_dtype, device, 1,
                             [DANUBE_PROMPT + DANUBE_DECODE], seed,
                             n_copies=n_copies, heads=DH120_HEADS,
                             cache_len=DANUBE_CACHE, slots=DANUBE_SLOTS)


def phase_dh120_kernels(device):
    """Phase 2 at Dh 120 (h2o-danube3-4b's heads): the flash forward in
    bf16 and f32 at (1, DANUBE_PROMPT, 32 / 8, 120) with the 4096 window,
    the flash backward in bf16 at (1, TRAIN_SEQ, 32 / 8, 120) causal, and
    the float and int8 paged walks at a 20b decode call with the window,
    each against its plain version (the int8 walk also against the
    unquantized pools within 0.05)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    errs = {"flash_attention": 0.0, "flash_attention_bwd": 0.0,
            "paged_attention": 0.0, "paged_attention_int8": (0.0, 0.0)}
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        q, k, v, _ = dh120_flash_inputs(dtype, device, DANUBE_PROMPT, 31)
        got = fa.flash_attention(q, k, v, causal=True, window=DANUBE_WINDOW)
        want = fa.flash_attention_plain(q, k, v, causal=True,
                                        window=DANUBE_WINDOW)
        e = check_close(f"flash Dh 120 {dtype}", got, want, atol, rtol)
        errs["flash_attention"] = max(errs["flash_attention"], e)
        del got, want
        sets, tab, lens = dh120_paged_inputs(dtype, device, 32)
        qp, kp, vp = sets[0]
        got = pa.paged_attention(qp, kp, vp, tab, lens, window=DANUBE_WINDOW)
        want = pa.paged_attention_plain(qp, kp, vp, tab, lens,
                                        window=DANUBE_WINDOW)
        ep = check_close(f"paged Dh 120 {dtype}", got, want, atol, rtol)
        errs["paged_attention"] = max(errs["paged_attention"], ep)
        del sets
        sets, tab, lens, (kp, vp) = dh120_int8_inputs(dtype, device, 37)
        qi, kq, vq, ks, vs = sets[0]
        kw = dict(window=DANUBE_WINDOW, k_scale=ks, v_scale=vs)
        got = pa.paged_attention(qi, kq, vq, tab, lens, **kw)
        want = pa.paged_attention_plain(qi, kq, vq, tab, lens, **kw)
        full = pa.paged_attention_plain(qi, kp, vp, tab, lens,
                                        window=DANUBE_WINDOW)
        ei = check_close(f"paged int8 Dh 120 {dtype}", got, want, atol, rtol)
        ef = check_close(f"paged int8 Dh 120 {dtype} vs unquantized", got,
                         full, 0.05, 0.05)
        errs["paged_attention_int8"] = tuple(
            max(a, b) for a, b in zip(errs["paged_attention_int8"], (ei, ef)))
        del sets, got, want, full
        log(f"[kernels] Dh 120 {str(dtype)[6:]}: flash (1, {DANUBE_PROMPT}, "
            f"32/8, 120) window {DANUBE_WINDOW} max|err| {e:.3e}; paged "
            f"{int(lens[0])} keys window {DANUBE_WINDOW} max|err| {ep:.3e}; "
            f"int8 paged (120-byte rows) max|err| {ei:.3e}, vs the "
            f"unquantized pools {ef:.3e} (atol {atol}, rtol {rtol})")
    atol, rtol = TOL["bfloat16"]
    q, k, v, do = dh120_flash_inputs(torch.bfloat16, device, TRAIN_SEQ, 33)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True)
    e = [check_close(f"flash bwd Dh 120 {n}", g_, w_, atol, rtol)
         for n, g_, w_ in zip(("dq", "dk", "dv"), got, want)]
    errs["flash_attention_bwd"] = max(e)
    log(f"[kernels] Dh 120 bf16 flash bwd (1, {TRAIN_SEQ}, 32/8, 120): "
        f"max|err| dq {e[0]:.3e} dk {e[1]:.3e} dv {e[2]:.3e} (atol {atol}, "
        f"rtol {rtol})")
    torch.cuda.empty_cache()
    return errs


def dh120_records(device, errs, launches):
    """Times at Dh 120 beside bounds, plain versions and the library, one
    entry for each of the three kernels' records: the flash forward at
    20b's reference call, the paged walk at a 20b decode call, the
    backward at (1, TRAIN_SEQ, 32 / 8, 120)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    bf16 = torch.bfloat16
    h, kv, dh = DH120_HEADS
    out = {}
    # flash forward, windowed: the library call is SDPA with the window's
    # boolean mask (SDPA has no window argument)
    s, w = DANUBE_PROMPT, DANUBE_WINDOW
    q, k, v, _ = dh120_flash_inputs(bf16, device, s, 34)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True, window=w))
    plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                                     window=w), 3, 1)
    idx = torch.arange(s, device=device)
    dq_ = idx[:, None] - idx[None, :]
    mask = (dq_ >= 0) & (dq_ < w)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), 5, 1)
    out["flash_attention"] = _dh120_entry(
        [1, s, h, kv, dh], w, errs["flash_attention"],
        launches["flash_attention"], ms, plain,
        cost.flash_fwd(q, k, v, causal=True, window=w), lib,
        "F.scaled_dot_product_attention with the window's boolean mask "
        "(enable_gqa)")
    del q, k, v, qt, kt, vt, mask
    # the backward, causal
    q, k, v, do = dh120_flash_inputs(bf16, device, TRAIN_SEQ, 35)
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                causal=True))
    plain = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=True), 3, 1)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ref = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    lib = time_ms(lambda: torch.autograd.grad(ref, (qt, kt, vt), dot,
                                              retain_graph=True))
    out["flash_attention_bwd"] = _dh120_entry(
        [1, TRAIN_SEQ, h, kv, dh], -1, errs["flash_attention_bwd"],
        launches["flash_attention_bwd"], ms, plain,
        cost.flash_bwd(q, k, v, causal=True), lib,
        "autograd of F.scaled_dot_product_attention (is_causal, "
        "enable_gqa), backward alone")
    del q, k, v, do, o, lse, qt, kt, vt, ref
    # the paged walk, a 20b decode call, input sets cycled past L2
    n_keys = DANUBE_PROMPT + DANUBE_DECODE
    live = 2 * -(-min(n_keys, DANUBE_WINDOW + 1) // PAGE) * PAGE * kv * dh * 2
    n_sets = -(-4 * L2_BYTES // live)
    sets, tab, lens = dh120_paged_inputs(bf16, device, 36, n_copies=n_sets)
    it = {"i": 0}

    def run(fn):
        def call():
            qp, kp, vp = sets[it["i"] % n_sets]
            it["i"] += 1
            fn(qp, kp, vp, tab, lens, window=DANUBE_WINDOW)
        return call

    ms = device_ms(run(pa.paged_attention), 2 * n_sets, "paged_attention")
    plain = time_ms(run(pa.paged_attention_plain))
    kc = paged_cost(sets[0][0], sets[0][1], tab, [n_keys], DANUBE_WINDOW)
    out["paged_attention"] = _dh120_entry(
        [1, 1, h, kv, dh], DANUBE_WINDOW, errs["paged_attention"],
        launches["paged_attention"], ms, plain, kc, None,
        "none (no single PyTorch call)")
    out["paged_attention"].update(keys=n_keys, ms_by=PAGED_MS_BY)
    del sets
    # the int8 walk at the same call: bf16 q, int8 pools of 120-byte rows
    # (8-byte chunks) and their f32 scale planes
    live = 2 * -(-min(n_keys, DANUBE_WINDOW + 1) // PAGE) * PAGE * kv * dh
    n_sets = -(-4 * L2_BYTES // live)
    sets, tab, lens, _ = dh120_int8_inputs(bf16, device, 38, n_copies=n_sets)
    it = {"i": 0}

    def run8(fn):
        def call():
            qp, kq, vq, ks, vs = sets[it["i"] % n_sets]
            it["i"] += 1
            fn(qp, kq, vq, tab, lens, window=DANUBE_WINDOW, k_scale=ks,
               v_scale=vs)
        return call

    ms = device_ms(run8(pa.paged_attention), 2 * n_sets, "paged_attention")
    plain = time_ms(run8(pa.paged_attention_plain))
    kc = paged_cost(sets[0][0], sets[0][1], tab, [n_keys], DANUBE_WINDOW,
                    k_scale=sets[0][3])
    entry = _dh120_entry(
        [1, 1, h, kv, dh], DANUBE_WINDOW, errs["paged_attention_int8"][0],
        launches["paged_attention_int8"], ms, plain, kc, None,
        "none (no single PyTorch call)")
    entry.update(keys=n_keys, ms_by=PAGED_MS_BY, pool_dtype="int8",
                 chunk_bytes=8,
                 max_abs_err_vs_unquantized=errs["paged_attention_int8"][1])
    out["paged_attention_int8"] = entry
    del sets
    torch.cuda.empty_cache()
    return out


def _dh120_entry(shape, window, err, launches, ms, plain, kc, lib,
                 lib_what):
    """A record's entry at one shape: ``kc`` its kernels/cost.py count."""
    return {"shape": shape, "window": window, "dtype": "bfloat16",
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            **bound_fields(kc), "library_ms": lib, "library": lib_what}


# --------------------------------------------------------------------------
# phase 21: tensor parallelism (tp > 1) on gloo ranks sharing the card
# --------------------------------------------------------------------------

def tp_replicated(state, spec, tp) -> list:
    """Leaf names of a rank's state that every tensor rank holds whole:
    the replicated stage leaves (norms, qk-norm scales) with their ring
    rows and optimizer slots, and the final norm with its optimizer
    slots (each tensor rank holds its own columns of the embedding and
    the head, which are not among them)."""
    from repro_torch.models.init import tp_axes
    whole = {n for n, ax in tree_leaves(tp_axes(
        state["params"]["stages"], spec, tp)) if ax < 0}
    out = []
    for name, t in tree_leaves(state):
        if not hasattr(t, "numel"):
            continue
        tail = name.split("/stages", 1)[-1] if "/stages" in name else None
        for pre in ("/current", "/ring"):
            if name.startswith("/stash" + pre):
                tail = name[len("/stash" + pre):]
        if name.startswith("/opt_stages/"):
            tail = "/" + name.split("/", 3)[3]
        if (tail is not None and tail in whole) or name.startswith(
                "/params/final_norm/") or (name.startswith("/opt_head/")
                                           and "/f/" in name):
            out.append(name)
    return out


def tp_job_exact(grid, ckpt):
    """21a on a rank: DIST_LAYERS layers of qwen3-14b at full width, fp32,
    pp 1 x tp 2 (dist_fp32_run's shape: DIST_R x DIST_ROWS x DIST_SEQ,
    SGD with momentum, DIST_ROUNDS rounds) from the seed's state, cut to
    this rank's tensor shard; then 21c's checkpoint of it into ``ckpt``.
    Losses, the digests of every leaf, the transport's counters, the
    launches, peak GB."""
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.train import cut_layers
    spec = cut_layers(configs.get("qwen3-14b").full_spec(), DIST_LAYERS)
    plan = dist_plan(1).with_(tp=grid.topo.tp)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    losses, state, bundle, seconds = dist_fp32_run(spec, plan, grid.device,
                                                   grid=grid)
    run_s = time.perf_counter() - t0
    counts = read_counts()
    stats = dataclasses.asdict(grid.stats)
    t0 = time.perf_counter()
    CheckpointManager(ckpt, grid=grid, spec=spec).save(
        DIST_ROUNDS, state, plan.pp * plan.virtual_stages)
    save_s = time.perf_counter() - t0
    return {"grid": {**rank_info(grid), "tensor": grid.t},
            "losses": losses, "round_s": seconds, "run_s": run_s,
            "save_s": save_s, "stats": stats, "counts": counts,
            "digests": state_digests(state),
            "replicated": tp_replicated(state, spec, grid.topo.tp),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def tp_job_train(grid):
    """21b on a rank: phase 13's model and shape (qwen3-14b, TRAIN_LAYERS
    layers at full width, bf16, Adam, remat, 1f1b / stash, pp 2, R
    TRAIN_R x TRAIN_ROWS x TRAIN_SEQ) at tp 2 through launch/train.py's
    build with this rank's grid, one round on the stream with the plain
    attention versions refused: its loss, host seconds, the transport's
    counters (the tensor group's sums apart), launches and peak GB."""
    import torch
    from repro_torch.data.pipeline import Loader, SyntheticLM
    from repro_torch.parallel.dist import TransportStats
    spec, bundle = build_train(train_args(phase_train_flags(
        ["--schedule", "1f1b", "--stash-mode", "stash"])), grid,
        tp=grid.topo.tp)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = bundle.init_state(torch.Generator(grid.device).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    loader = Loader(SyntheticLM(spec.vocab, TRAIN_SEQ, seed=SEED),
                    TRAIN_R, TRAIN_ROWS, grid.device)
    batch = loader.get(0)
    torch.cuda.synchronize()
    reset_counts()
    grid.stats = TransportStats()
    with plain_attention_refused():
        t0 = time.perf_counter()
        state, m = bundle.train_step(state, batch)
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t0
    return {"grid": {**rank_info(grid), "tensor": grid.t},
            "loss": float(m["loss"]), "round_s": round_s, "init_s": init_s,
            "stats": dataclasses.asdict(grid.stats), "counts": read_counts(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "state_gb": tree_bytes(state) / 1e9,
            "stage_shapes": {
                n: list(t.shape) for n, t in tree_leaves(
                    state["params"]["stages"]["layer_0"])}}


def tp_sums(spec, lps, r, rows, seq, esz, tp, first, last):
    """The tensor group's collectives of one rank in one round of ``r``
    microbatches through ``lps`` layers at remat: per layer and
    microbatch the attention and FFN outputs in F (2) and in B's re-run
    of the stage (2), the attention's in the checkpoint's recompute (1:
    non-reentrant recomputation stops at the last tensor the backward
    needs, before the FFN's sum), the two inputs' cotangents backward
    (2), each rows x seq x d_model; the qk-norm scales' cotangents (2 x
    Dh) and, with KV replicated over the ranks, the KV weights' (2 x d x
    n_kv x Dh); on the ``first`` stage the all-gather of the round's
    embeddings (each rank's d_model / tp columns of r microbatches); on
    the ``last`` per microbatch the sharded loss's row max and two sums
    (f32, rows x seq each) forward and the normalized hidden state's
    cotangent backward.  (calls, bytes)."""
    act = rows * seq * spec.d_model * esz
    calls, nbytes = 7, 7 * act
    if spec.qk_norm:
        calls, nbytes = calls + 2, nbytes + 2 * spec.d_head * esz
    if spec.n_kv % tp:
        calls += 2
        nbytes += 2 * spec.d_model * spec.n_kv * spec.d_head * esz
    calls, nbytes = lps * r * calls, lps * r * nbytes
    if first:
        calls, nbytes = calls + 1, nbytes + r * act // tp
    if last:
        calls, nbytes = calls + 4 * r, nbytes + r * (act + 3 * rows * seq * 4)
    return calls, nbytes


def host_zeros(state):
    """A host copy of ``state``'s structure with every tensor zeroed (a
    restore template), ``stash["current"]`` the params' stages."""
    import torch

    def z(t):
        if isinstance(t, dict):
            return {k: z(v) for k, v in t.items()}
        return torch.zeros(t.shape, dtype=t.dtype) if torch.is_tensor(t) \
            else t
    out = z(state)
    out["stash"]["current"] = out["params"]["stages"]
    return out


def phase_tp(device, first_round_loss):
    """Phase 21 (21a-c, see the module docstring): the records and the
    launches.  21c's restore and 21a's parameter check run on the host
    while 21b's four ranks hold the card."""
    import gc
    import shutil
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.versioning import rank_state
    from repro_torch.launch.train import cut_layers
    from repro_torch.models.init import tp_axes
    from repro_torch.optim.optimizers import tree_map
    gc.collect()
    torch.cuda.empty_cache()
    seconds, out = {}, {}
    full = configs.get("qwen3-14b").full_spec()
    spec = cut_layers(full, DIST_LAYERS)
    tp = TP_DEGREE
    # 21a: the one-process tp 1 executor, then pp 1 x tp 2 on two ranks
    t0 = time.perf_counter()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        want_losses, ref, bundle, _ = dist_fp32_run(spec, dist_plan(1),
                                                    device)
    finally:
        torch.use_deterministic_algorithms(False)
    sched = bundle.sched
    one_s = time.perf_counter() - t0
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_tp_ckpt_")
    try:
        t1 = time.perf_counter()
        ranks = spawn_ranks(1, 1, "tp_job_exact", tp=tp, ckpt=ckpt)
        ranks_s = time.perf_counter() - t1
        for res in ranks:
            np.testing.assert_allclose(res["losses"], want_losses,
                                       **TP_LOSS_TOL,
                                       err_msg=f"21a rank {res['grid']}")
        rep = ranks[0]["replicated"]
        for res in ranks[1:]:
            bad = [n for n in rep
                   if res["digests"][n] != ranks[0]["digests"][n]]
            if bad or res["replicated"] != rep:
                raise AssertionError(f"21a: replicated leaves differ across "
                                     f"the tensor ranks: {bad[:6]}")
            tables = [n for n in ("/params/embed", "/params/head")
                      if res["digests"][n] == ranks[0]["digests"][n]]
            if tables:
                raise AssertionError(f"21a: tensor rank {res['grid']['tensor']}"
                                     f" holds tensor rank 0's {tables}, not "
                                     "its own columns")
        # the card goes to 21b: tp 1's parameters and a restore template
        # wait in host memory
        state = host_zeros(ref)
        want_params = tree_map(lambda t: t.cpu() if torch.is_tensor(t)
                               else t, ref["params"])
        del ref, bundle
        gc.collect()
        torch.cuda.empty_cache()
        # 21b: phase 13's model and shape at pp 2 x tp 2, four ranks
        t_b = time.perf_counter()
        handle = start_ranks(1, 2, "tp_job_train", tp=tp)
        try:
            # 21c: the ranks' checkpoint restored by one tp 1 process
            t2 = time.perf_counter()
            CheckpointManager(ckpt).restore(DIST_ROUNDS, state)
            restore_s = time.perf_counter() - t2
            t2 = time.perf_counter()
            axes = tp_axes(state["params"]["stages"], spec, tp)
            for t, res in enumerate(ranks):
                got = {n: digest(v.to(device)) if torch.is_tensor(v) else v
                       for n, v in tree_leaves(rank_state(
                           state, sched, 0, tensor=(axes, t, tp)))}
                bad = [n for n in got if got[n] != res["digests"].get(n)]
                if bad or set(got) != set(res["digests"]):
                    raise AssertionError(
                        f"21c: the tp {tp} checkpoint restored at tp 1 "
                        f"differs from rank {t}'s state at {bad[:6]}")
            # 21a's parameters: the tp 2 state (as restored) against tp 1's
            worst = 0.0
            for (n, a), (_, b) in zip(tree_leaves(state["params"]),
                                      tree_leaves(want_params)):
                if torch.is_tensor(a):
                    worst = max(worst, check_close(
                        f"21a {n}", a.to(device), b.to(device),
                        *TP_PARAM_TOL))
            cmp_s = time.perf_counter() - t2
            del state, want_params
        finally:
            ranks_b = join_ranks(handle)
        seconds["21b"] = time.perf_counter() - t_b
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    n_calls, n_bytes = tp_sums(spec, DIST_LAYERS, DIST_R, DIST_ROWS,
                               DIST_SEQ, 4, tp, True, True)
    for res in ranks:
        st = res["stats"]
        if (st["tensor_calls"], st["tensor_bytes"]) != \
                (DIST_ROUNDS * n_calls, DIST_ROUNDS * n_bytes):
            raise AssertionError(f"21a tensor sums {st['tensor_calls']} / "
                                 f"{st['tensor_bytes']} B, analytic "
                                 f"{DIST_ROUNDS * n_calls} / "
                                 f"{DIST_ROUNDS * n_bytes}")
    seconds["21a+c"] = t_b - t0
    out["21a"] = {"losses": ranks[0]["losses"], "tp1_losses": want_losses,
                  "max_abs_param_err": worst, "tp1_s": one_s,
                  "ranks": [{k: r[k] for k in ("grid", "round_s", "run_s",
                                                "save_s", "stats", "peak_gb")}
                            for r in ranks],
                  "replicated_leaves_equal": len(rep)}
    out["21c"] = {"restore_s": restore_s, "compare_s": cmp_s,
                  "ranks_s": ranks_s,
                  "leaves_equal": len(ranks[0]["digests"])}
    counts_a = {k: sum(r["counts"][k] for r in ranks)
                for k in ranks[0]["counts"]}
    log(f"[tp] 21a qwen3-14b {DIST_LAYERS} layers fp32 pp 1 x tp {tp} "
        f"(gloo, one card) vs the one-process tp 1 executor: losses "
        f"{ranks[0]['losses']} / {want_losses}, max |param err| "
        f"{worst:.3e}; {len(rep)} replicated leaves equal across the tensor "
        f"ranks; tensor sums {ranks[0]['stats']['tensor_calls']} calls, "
        f"{ranks[0]['stats']['tensor_bytes'] / 1e6:.2f} MB a rank (analytic "
        f"{DIST_ROUNDS * n_calls} / {DIST_ROUNDS * n_bytes / 1e6:.2f}); "
        f"21c: saved in {[round(r['save_s'], 1) for r in ranks]} s, "
        f"restored at tp 1 in {restore_s:.1f} s (host, beside 21b), every "
        f"rank's {len(ranks[0]['digests'])} leaves equal bit for bit; "
        f"seconds: tp 1 run {one_s:.1f}, ranks {ranks_s:.1f} (rounds "
        f"{[[round(x, 3) for x in r['round_s']] for r in ranks]}), "
        f"checks {cmp_s:.1f}")
    ranks = ranks_b
    losses = [r["loss"] for r in ranks]
    if not all(np.isfinite(losses)) or len(set(losses)) != 1 or \
            abs(losses[0] - first_round_loss) > 2e-2:
        raise AssertionError(f"21b: losses {losses}, phase 13's first round "
                             f"{first_round_loss}")
    counts_b = {k: sum(r["counts"][k] for r in ranks)
                for k in ranks[0]["counts"]}
    per_round = tp * TRAIN_LAYERS * TRAIN_R
    want = {"paged_attention": 0, "paged_attention_int8": 0, "wkv6": 0,
            "mamba_scan": 0, "flash_attention": 3 * per_round,
            "flash_attention_bwd": per_round}
    if counts_b != want:
        raise AssertionError(f"21b launches {counts_b}, expected {want}")
    sums = [tp_sums(full, TRAIN_LAYERS // 2, TRAIN_R, TRAIN_ROWS, TRAIN_SEQ,
                    2, tp, s == 0, s == 1) for s in range(2)]
    for res in ranks:
        st, want_s = res["stats"], sums[res["grid"]["stage"]]
        res["analytic_tensor"] = want_s
        if (st["tensor_calls"], st["tensor_bytes"]) != want_s:
            raise AssertionError(f"21b tensor sums {st['tensor_calls']} / "
                                 f"{st['tensor_bytes']} B, analytic "
                                 f"{want_s[0]} / {want_s[1]}")
    peaks = {r["grid"]["rank"]: r["peak_gb"] for r in ranks}
    last = [r["peak_gb"] for r in ranks if r["grid"]["stage"] == 1]
    gap = max(last) - min(last)
    out["21b"] = {"loss": losses[0], "phase13_first_round_loss":
                  first_round_loss, "seq": TRAIN_SEQ, "ranks": ranks,
                  "peak_gb_by_rank": peaks, "last_stage_peak_gap_gb": gap}
    for res in ranks:
        st = res["stats"]
        log(f"[tp] 21b rank {res['grid']['rank']} (stage "
            f"{res['grid']['stage']}, tensor {res['grid']['tensor']}): "
            f"round {res['round_s']:.3f} s; tensor sums "
            f"{st['tensor_calls']} calls, {st['tensor_bytes'] / 1e9:.3f} GB "
            f"(analytic {res['analytic_tensor'][1] / 1e9:.3f}), "
            f"{st['tensor_s']:.3f} s; hand-off wait {st['handoff_s']:.3f} s; "
            f"peak {res['peak_gb']:.2f} GB")
    log(f"[tp] 21b qwen3-14b {TRAIN_LAYERS} layers bf16 Adam 1f1b/stash pp 2 "
        f"x tp {tp} (four ranks, gloo, one card), seq {TRAIN_SEQ}: loss "
        f"{losses[0]:.4f} (phase 13's first round {first_round_loss:.4f}); "
        f"peak GB by rank {json.dumps(peaks)}, the last stage's tensor "
        f"ranks {gap:.2f} GB apart (limit {TP_PEAK_GAP_GB})")
    if gap >= TP_PEAK_GAP_GB:
        raise AssertionError(f"21b: the last stage's tensor ranks peak "
                             f"{last} GB, {gap:.2f} GB apart: the head is "
                             "not evenly cut")
    log(f"[phases] 21 seconds: {json.dumps(seconds)}")
    return out, seconds, {"qwen3_tp_exact": counts_a, "qwen3_train_tp":
                          counts_b}


def tp_records(tp_out, card):
    """One ``tp`` JSON record a rank of 21b, and one for 21a / 21c."""
    recs = []
    for res in tp_out["21b"]["ranks"]:
        st = res["stats"]
        recs.append({"phase": "21b", **res["grid"], "card": card,
                     "seq": tp_out["21b"]["seq"], "round_s": res["round_s"],
                     "tensor_calls": st["tensor_calls"],
                     "tensor_bytes": st["tensor_bytes"],
                     "tensor_calls_bytes_analytic": res["analytic_tensor"],
                     "tensor_s": st["tensor_s"],
                     "handoff_s": st["handoff_s"],
                     "handoff_bytes": st["handoff_bytes"],
                     "staged_bytes": st["staged_bytes"],
                     "peak_gb": res["peak_gb"], "loss": res["loss"]})
    recs.append({"phase": "21a+c", "card": card,
                 **{k: v for k, v in tp_out["21a"].items() if k != "ranks"},
                 "ranks": tp_out["21a"]["ranks"], **tp_out["21c"]})
    return recs


# phase 22: the recurrent block kinds trained on the card at phase 13's
# shape (R TRAIN_R x TRAIN_ROWS x TRAIN_SEQ, TRAIN_ROUNDS rounds, bf16,
# the config's Adam, remat), each in its config's stash mode: (arch,
# layers, pp, schedule, stash mode).  rwkv6-1.6b cut to 12 of its 24
# layers (for the script's time limit: its host-bound round scales with
# the layers); jamba-v0.1-52b cut to its first 2 of 32 layers
# (Mamba + dense FFN, Mamba + MoE of 16 experts top 2: ~3.7 B parameters;
# with Adam even 4 layers are ~83 GB), at pp 1: a stage must hold whole
# layer patterns.  22c in fp32 (phase 14's shape and SGD), executor
# against oracle: rwkv6 at its first 2 layers, jamba at its first layer
# (Mamba + dense FFN, for the script's time limit: its MoE layer made
# the fp32 state 30 GB, and phase 23e holds an MoE to the oracle on the
# card); the oracle consumes its input as it goes
RECUR_TRAIN = (("rwkv6-1.6b", 12, 2, "1f1b", "stash"),
               ("jamba-v0.1-52b", 2, 1, "gpipe", "flush"))
RECUR_CONS_LAYERS = {"rwkv6-1.6b": 2, "jamba-v0.1-52b": 1}
# (label, substring of the kernel names) of each arch's scan kernels in a
# profiled round
RECUR_KERNELS = {"rwkv6-1.6b": (("wkv6_fwd", "wkv6_chunked_kernel"),
                                ("wkv6_bwd", "wkv6_bwd")),
                 "jamba-v0.1-52b": (("mamba_fwd", "mamba_scan_kernel"),
                                    ("mamba_bwd", "mamba_bwd"))}


@contextlib.contextmanager
def plain_versions_refused():
    """Every plain version of a training kernel raises while the block
    runs: the attention, WKV6 and selective-scan forwards and backwards
    on the card's training path must run the CUDA kernels."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import wkv6 as wk
    names = ((wk, "wkv6_plain"), (wk, "wkv6_bwd_plain"),
             (ms, "mamba_scan_plain"), (ms, "mamba_scan_bwd_plain"))
    saved = [getattr(m, n) for m, n in names]

    def refuse(*_, **__):
        raise AssertionError("a plain WKV6 / selective-scan version ran on "
                             "the card's training path")
    for m, n in names:
        setattr(m, n, refuse)
    try:
        with plain_attention_refused():
            yield
    finally:
        for (m, n), fn in zip(names, saved):
            setattr(m, n, fn)


def train_launches(spec, rounds, r):
    """The mixers' kernel launches a run of ``rounds`` rounds of ``r``
    microbatches makes: per mixer layer and microbatch three forwards (F,
    the B phase's re-run, the checkpoint's recompute: remat) and one
    backward, on the attention, WKV6 or selective-scan kernels."""
    n = {m: sum(b.mixer == m for b in spec.blocks)
         for m in ("attn", "rwkv", "mamba")}
    per = rounds * r
    return {"flash_attention": 3 * per * n["attn"],
            "flash_attention_bwd": per * n["attn"],
            "wkv6": 3 * per * n["rwkv"], "wkv6_bwd": per * n["rwkv"],
            "mamba_scan": 3 * per * n["mamba"],
            "mamba_scan_bwd": per * n["mamba"]}


def train_cut(device, arch, layers, pp, schedule, mode, kernels,
              rounds=TRAIN_ROUNDS):
    """22a / 22b / 23e / 25b: ``arch`` at full width, its first ``layers``
    layers, trained ``rounds`` rounds through the launcher's build
    (launch/train.py) at phase 13's shape, the last round under
    torch.profiler (``kernels``:
    profile_round's labels of the mixer's kernels), with every plain
    version refused.  Every attention, WKV or selective-scan forward and
    backward on its kernel; finite losses; for MoE models a finite aux
    > 0."""
    import torch
    from repro_torch.data.pipeline import Loader, SyntheticLM
    from repro_torch import configs
    args = train_args(["--layers", str(layers), "--pp", str(pp),
                       "--microbatches", str(TRAIN_R), "--global-batch",
                       str(TRAIN_R * TRAIN_ROWS), "--seq-len",
                       str(TRAIN_SEQ), "--schedule", schedule,
                       "--stash-mode", mode], arch=arch)
    spec, bundle = build_train(args)
    plan = bundle.plan
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = bundle.init_state(torch.Generator(device).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in tree_leaves(state["params"])
                   if torch.is_tensor(t))
    loader = Loader(SyntheticLM(spec.vocab, TRAIN_SEQ, seed=SEED),
                    plan.microbatches, bundle.microbatch_size, device)
    batches = [loader.get(r) for r in range(rounds)]
    reset_counts()
    losses, auxes, round_s, prof = [], [], [], None
    with plain_versions_refused():
        for r, batch in enumerate(batches):
            if r == len(batches) - 1:
                state, m, prof = profile_round(bundle, state, batch,
                                               round_s[-1], kernels)
            else:
                t1 = time.perf_counter()
                state, m = bundle.train_step(state, batch)
                torch.cuda.synchronize()
                round_s.append(time.perf_counter() - t1)
            losses.append(float(m["loss"]))
            auxes.append(float(m["aux"]))
    counts = read_all_counts()
    want = {"paged_attention": 0, "paged_attention_int8": 0,
            **train_launches(spec, rounds, plan.microbatches)}
    if counts != want:
        raise AssertionError(f"launches on {spec.name}'s training path: "
                             f"{counts}, expected {want}")
    if not all(np.isfinite(losses + auxes)):
        raise AssertionError(f"{spec.name}: non-finite loss or aux: {losses}, "
                             f"{auxes}")
    if spec.moe is not None and not all(a > 0 for a in auxes):
        raise AssertionError(f"{spec.name}: MoE aux {auxes}, expected > 0")
    tokens = plan.microbatches * bundle.microbatch_size * TRAIN_SEQ
    moe = bundle.statics.moe
    out = {"model": spec.name, "layers": spec.n_layers,
           "parameters": n_params,
           "schedule": f"{bundle.sched.name}/{plan.stash_mode}",
           "pp": plan.pp, "microbatches": plan.microbatches,
           "rows": bundle.microbatch_size, "seq_len": TRAIN_SEQ,
           "optimizer": configs.get(arch).OPTIMIZER, "init_s": init_s,
           "round_s": round_s, "round_s_warm": round_s[-1],
           "tokens_per_s": tokens / round_s[-1],
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss_per_round": losses, "aux_per_round": auxes,
           "moe_capacity": None if moe is None else moe.capacity,
           "launches": counts}
    log(f"[train-recurrent] {spec.name}: {spec.n_layers} layers, "
        f"{n_params / 1e9:.3f} B parameters, {out['schedule']} pp={plan.pp} "
        f"R={plan.microbatches} x {bundle.microbatch_size} x {TRAIN_SEQ}, "
        f"adam lr {out['optimizer'][1]}: init {init_s:.1f}s, rounds "
        f"{[round(x, 3) for x in round_s]} s ({out['tokens_per_s']:.0f} "
        f"tokens/s warm), peak {out['peak_allocated_gb']:.1f} GB; loss per "
        f"round {[round(x, 4) for x in losses]}, aux "
        f"{[round(x, 4) for x in auxes]}, MoE capacity "
        f"{out['moe_capacity']}; launches {counts}")
    fwd, bwd = kernels
    log(f"[profile] {spec.name} train round: {prof['device_ms']:.1f} ms of "
        f"device kernels in a {1e3 * round_s[-1]:.1f} ms round, idle share "
        f"{prof['idle_share']:.3f}; {fwd[0]} {prof[fwd[0] + '_ms']:.1f} ms "
        f"in {prof[fwd[0] + '_launches']}, {bwd[0]} "
        f"{prof[bwd[0] + '_ms']:.1f} ms in {prof[bwd[0] + '_launches']} "
        f"launches; "
        f"top kernels (ms, calls): "
        f"{[(k['name'][:50], round(k['ms'], 1), k['calls']) for k in prof['by_kernel']]}")
    del state, bundle, batches
    torch.cuda.empty_cache()
    return out, prof


def phase_train_recurrent(device):
    """Phase 22: 22a and 22b (RECUR_TRAIN), then 22c: each arch at
    RECUR_CONS_LAYERS[arch] layers in fp32 through the executor and the
    oracle (:func:`executor_equals_oracle`, deterministic algorithms), every
    scan on its kernels.  Returns (records, profiles, launches by path,
    seconds)."""
    import os
    import torch
    from repro_torch import configs
    from repro_torch.launch.train import cut_layers
    from repro_torch.optim import SGDM
    out, profs, launches, seconds = {}, [], {}, {}
    for arch, layers, pp, schedule, mode in RECUR_TRAIN:
        t0 = time.perf_counter()
        out[arch], prof = train_cut(device, arch, layers, pp, schedule,
                                    mode, RECUR_KERNELS[arch])
        profs.append(prof)
        launches[f"{arch.split('-')[0]}_train"] = out[arch]["launches"]
        seconds[arch] = time.perf_counter() - t0
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    out["22c"] = {}
    try:
        for arch, _, pp, schedule, mode in RECUR_TRAIN:
            t0 = time.perf_counter()
            cfg = configs.get(arch)
            spec = cut_layers(cfg.full_spec(), RECUR_CONS_LAYERS[arch])
            plan = cfg.PLAN.with_(tp=1, pp=pp, microbatches=CONS_R,
                                  schedule=schedule, stash_mode=mode)
            reset_counts()
            with plain_versions_refused():
                out["22c"][arch] = executor_equals_oracle(
                    device, f"{schedule}/{mode}", spec, plan, SGDM(lr=0.01),
                    donate=True)
            counts = read_all_counts()
            want = train_launches(spec, 2 * CONS_ROUNDS, CONS_R)
            if {k: counts[k] for k in want} != want:
                raise AssertionError(f"22c {spec.name} launches {counts}, "
                                     f"expected {want} (executor + oracle)")
            out["22c"][arch]["launches"] = counts
            launches[f"{arch.split('-')[0]}_train_exact"] = counts
            seconds[f"22c {arch}"] = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[phases] 22 seconds: {json.dumps(seconds)}")
    return out, profs, launches, seconds


# --------------------------------------------------------------------------
# phase 2 at the new head layouts; phase 23: checkpoint ingest, olmoe-1b-7b,
# deepseek-moe-16b and chatglm3-6b
# --------------------------------------------------------------------------

# (H, KV, Dh) of the attention layouts phase 23's and 24's configs run:
# MHA (G 1, olmoe and deepseek), a group of 16 (chatglm3), MHA at Dh 64
# (whisper: 64-column tiles, 128-byte bf16 page rows) and a group of 7, not
# a power of two (llava)
LAYOUTS = {"g1": (16, 16, 128), "g16": (32, 2, 128),
           "whisper": (16, 16, 64), "llava": (56, 8, 128)}
LAYOUT_ARCHS = {"g1": ("olmoe", "deepseek"), "g16": ("chatglm3",),
                "whisper": ("whisper",), "llava": ("llava",)}
# 23a: olmoe-1b-7b at full width cut to INGEST_LAYERS of 16 layers (full
# depth would write ~41 GB of files), a BF16 fixture in INGEST_SHARDS
# shards and an index, converted for pp 2 at v 1 and v 2, each served
# INGEST_DECODE decodes from the directory and from memory
INGEST_ARCH, INGEST_LAYERS, INGEST_SHARDS, INGEST_DECODE = \
    "olmoe-1b-7b", 4, 2, 4
# 23b-d: served at full depth at phase 3's shape (prefill_len PREFILL
# sizes the MoE capacity); 23e: trained at phase 13's shape, cut to a
# depth (with Adam, deeper cuts do not fit the card beside the ring)
NEW_SERVE = ("olmoe-1b-7b", "deepseek-moe-16b", "chatglm3-6b")
NEW_TRAIN = (("deepseek-moe-16b", 2), ("chatglm3-6b", 4))
NEW_CONS_LAYERS = 2
# 23b-d's fp32 consistency at NEW_CONS_LAYERS layers: one slot of ROWS
# rows, a 40-token prompt and 4 decodes (the CPU session's time)
NEW_CONS_SLOTS, NEW_CONS_PREFILL, NEW_CONS_CACHE, NEW_CONS_DECODE = \
    1, 40, 128, 4
NEW_TIE = RWKV_TIE
# 23a (a spawned process beside 23b-e) is due this long after it starts
INGEST_S = 900


def phase_layout_kernels(device):
    """Phase 2 at the head layouts of LAYOUTS: the flash forward and its
    rows' log-sum-exp at (8, PREFILL + N_DECODE) and its backward at (1,
    TRAIN_SEQ) (causal; bf16 and f32, dK / dV summed over each KV head's
    query heads, two identical backward calls bit-equal), and the paged
    walk at a decode call (Q 1) and, at G 16, a verify tile (Q SPEC_K +
    1: Q·G = 80 query rows a KV head), bf16 and f32 pools, each against
    its plain version within TOL."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    errs = {}
    for name, heads in LAYOUTS.items():
        e = {"flash_attention": 0.0, "flash_attention_lse": 0.0,
             "flash_attention_bwd": 0.0, "paged_attention": 0.0,
             "paged_attention_verify": 0.0}
        for dtype in (torch.bfloat16, torch.float32):
            atol, rtol = TOL[str(dtype).split(".")[-1]]
            q, k, v, _ = flash_inputs(dtype, device, R_SLOTS * ROWS,
                                      PREFILL + N_DECODE, 41, heads)
            got, lse = fa.flash_attention(q, k, v, causal=True,
                                          return_lse=True)
            want, lse_plain = fa.flash_attention_plain(q, k, v, causal=True,
                                                       return_lse=True)
            e["flash_attention"] = max(e["flash_attention"], check_close(
                f"flash {name} {dtype}", got, want, atol, rtol))
            e["flash_attention_lse"] = max(
                e["flash_attention_lse"], check_close(
                    f"flash {name} {dtype} lse", lse, lse_plain, atol, rtol))
            del q, k, v, got, want, lse, lse_plain
            q_lens = (1, SPEC_K + 1) if name == "g16" else (1,)
            for q_len in q_lens:
                key = "paged_attention" if q_len == 1 else \
                    "paged_attention_verify"
                sets, tab, lens = paged_inputs(
                    dtype, device, q_len, [PREFILL + N_DECODE, PREFILL + 37],
                    seed=43 + q_len, heads=heads)
                qp, kp, vp = sets[0]
                got = pa.paged_attention(qp, kp, vp, tab, lens)
                want = pa.paged_attention_plain(qp, kp, vp, tab, lens)
                e[key] = max(e[key], check_close(
                    f"paged {name} Q={q_len} {dtype}", got, want, atol, rtol))
                del sets
            q, k, v, do = flash_inputs(dtype, device, 1, TRAIN_SEQ, 42,
                                       heads)
            out, lse = fa.flash_attention(q, k, v, causal=True,
                                          return_lse=True)
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
            again = fa.flash_attention_bwd(q, k, v, out, lse, do,
                                           causal=True)
            want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                causal=True)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash bwd {name} {dtype}: two "
                                     "identical calls differ")
            e["flash_attention_bwd"] = max(e["flash_attention_bwd"], *(
                check_close(f"flash bwd {name} {dtype} {n}", g_, w_, atol,
                            rtol)
                for n, g_, w_ in zip(("dq", "dk", "dv"), got, want)))
            del q, k, v, do, out, lse, got, again, want
            torch.cuda.empty_cache()
        log(f"[kernels] layout {name} (H/KV/Dh {heads}): max|err| "
            f"{json.dumps(e)} (bf16 atol/rtol {TOL['bfloat16']}, f32 "
            f"{TOL['float32']}); the backward bit-equal twice")
        errs[name] = e
    torch.cuda.empty_cache()
    return errs


def layout_records(device, errs, launches):
    """Times at each layout of LAYOUTS beside bounds, the plain versions
    and the library, one entry a layout for the flash forward (8, PREFILL
    + N_DECODE), its backward (1, TRAIN_SEQ), the paged walk's decode
    call and (G 16) its verify tile; bf16.  ``launches`` maps a kernel to
    {layout: {path: count}}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    bf16 = torch.bfloat16
    n_sm = pa._sm_count(device.index or 0)
    out = {}
    for name, heads in LAYOUTS.items():
        h, kv, dh = heads
        rec = {}
        b, s = R_SLOTS * ROWS, PREFILL + N_DECODE
        q, k, v, _ = flash_inputs(bf16, device, b, s, 44, heads)
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
        plain = time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                         causal=True), 5, 1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        rec["flash_attention"] = _dh120_entry(
            [b, s, h, kv, dh], -1, errs[name]["flash_attention"],
            launches["flash_attention"][name], ms, plain,
            cost.flash_fwd(q, k, v, causal=True), lib,
            "F.scaled_dot_product_attention (is_causal, enable_gqa)")
        del q, k, v, qt, kt, vt
        s = TRAIN_SEQ
        q, k, v, do = flash_inputs(bf16, device, 1, s, 45, heads)
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                    causal=True))
        plain = time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=True), 3, 1)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        ref = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        dot = do.transpose(1, 2)
        lib = time_ms(lambda: torch.autograd.grad(ref, (qt, kt, vt), dot,
                                                  retain_graph=True))
        rec["flash_attention_bwd"] = _dh120_entry(
            [1, s, h, kv, dh], -1, errs[name]["flash_attention_bwd"],
            launches["flash_attention_bwd"][name], ms, plain,
            cost.flash_bwd(q, k, v, causal=True), lib,
            "autograd of F.scaled_dot_product_attention (is_causal, "
            "enable_gqa), backward alone")
        del q, k, v, do, o, lse, qt, kt, vt, ref
        q_lens = (1, SPEC_K + 1) if name == "g16" else (1,)
        for q_len in q_lens:
            key = "paged_attention" if q_len == 1 else "paged_attention_verify"
            lengths = [PREFILL + N_DECODE, PREFILL + N_DECODE]
            live = 2 * sum(-(-n // PAGE) for n in lengths) * PAGE * kv * dh * 2
            n_sets = -(-4 * L2_BYTES // live)
            sets, tab, lens = paged_inputs(bf16, device, q_len, lengths,
                                           seed=46 + q_len, n_copies=n_sets,
                                           heads=heads)
            it = {"i": 0}

            def run(fn):
                def call():
                    qp, kp, vp = sets[it["i"] % n_sets]
                    it["i"] += 1
                    fn(qp, kp, vp, tab, lens)
                return call

            ms = device_ms(run(pa.paged_attention), 2 * n_sets,
                           "paged_attention")
            plain = time_ms(run(pa.paged_attention_plain))
            kc = paged_cost(sets[0][0], sets[0][1], tab, lengths, -1)
            splits, per = pa.plan_splits(tab.shape[1], tab.shape[0], kv,
                                         n_sm)
            entry = _dh120_entry(
                [len(lengths), q_len, h, kv, dh], -1, errs[name][key],
                launches[key][name], ms, plain, kc, None,
                "none (no single PyTorch call)")
            entry.update(
                keys=lengths, ms_by=PAGED_MS_BY, query_rows=q_len * h // kv,
                splits=splits, pages_a_split=per,
                blocks=len(lengths) * kv * splits,
                smem_dynamic_bytes={
                    dt: pa._bind().paged_attention_smem_bytes(
                        q_len, h // kv, dh, PAGE, esz)
                    for dt, esz in (("bfloat16", 2), ("float32", 4))})
            rec[key] = entry
            del sets
        out[name] = rec
        log(f"[kernels] layout {name} records: " + json.dumps(
            {k: {f: r[f] for f in ("ms", "bound_ms", "plain_ms",
                                   "library_ms", "launches")}
             for k, r in rec.items()}))
    torch.cuda.empty_cache()
    return out


def card_draw(device, seed):
    """``convert.synthetic_tensors``'s ``draw`` on the card: 0.05·N(0, 1)
    from a CUDA generator, rounded to bfloat16 (so a BF16 file holds the
    values exactly), as f32 numpy arrays."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        x = torch.randn(shape, generator=g, device=device).mul_(0.05)
        return x.to(torch.bfloat16).float().cpu().numpy()
    return draw


def same_arrays(label, got, want) -> int:
    """Every leaf of two numpy trees equal bit for bit; their bytes."""
    a, b = dict(tree_leaves(got)), dict(tree_leaves(want))
    if sorted(a) != sorted(b):
        raise AssertionError(f"{label}: trees differ: {sorted(set(a) ^ set(b))}")
    import torch
    n = 0
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                torch.from_numpy(np.ascontiguousarray(x)),
                torch.from_numpy(np.ascontiguousarray(y))):
            raise AssertionError(f"{label}: {k} differs")
        n += x.nbytes
    return n


def dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def new_session(spec, plan, device, dtype, **kw):
    import torch
    from repro_torch.serving.engine import build_serving
    kw.setdefault("cache_len", CACHE_LEN)
    kw.setdefault("prefill_len", PREFILL)
    slots = plan.decode_microbatches
    return build_serving(spec, plan, global_batch=slots * ROWS,
                         compute_dtype=dtype or torch.bfloat16,
                         page_size=kw.pop("page_size", PAGE), device=device,
                         **kw)


def serve_logits(session, prompts, n_decode):
    """Prefill and ``n_decode`` decodes: the tokens (n_decode + 1, rows)
    and each step's f32 logits of the last position, on the card."""
    import torch
    from repro_torch.models import lm_head
    nxt = session.prefill({"tokens": prompts})
    toks, logits = [nxt], []
    fn = session.params["final_norm"]
    for i in range(n_decode + 1):
        logits.append(lm_head.last_logits(
            session.params["head"], fn["scale"], session.last_hidden,
            vocab=session.spec.vocab))
        if i < n_decode:
            nxt = session.decode(nxt)
            toks.append(nxt)
    return torch.stack(toks), torch.stack(logits)


class Steps(dict):
    """Bytes, seconds and GB/s of 23a's steps, logged as each ends."""

    def timed(self, name, nbytes_fn, fn):
        t0 = time.perf_counter()
        out = fn()
        s = time.perf_counter() - t0
        nbytes = nbytes_fn(out)
        self[name] = {"seconds": s, "gb": nbytes / 1e9,
                      "gb_per_s": nbytes / 1e9 / s}
        log(f"[ingest] {name}: {nbytes / 1e9:.2f} GB in {s:.2f}s "
            f"({nbytes / 1e9 / s:.2f} GB/s)")
        return out


def to_v2_rows(tree, spec, order):
    """A pp 2 x v 1 tree (2 chunks of 2 layers) re-chunked into pp 2 x v 2
    storage rows (4 chunks of one layer, row p holding model chunk
    ``order[p]``, i.e. global layer ``order[p]``): the layout a v 2
    conversion must write, built from the v 1 tree alone."""
    lpc = spec.n_layers // 2
    def row(node, g):
        if isinstance(node, dict):
            return {k: row(v, g) for k, v in node.items()}
        return node[g // lpc]
    layers = [row(tree["stages"][f"layer_{g % lpc}"], g)
              for g in range(spec.n_layers)]

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)
    out = dict(tree)
    out["stages"] = {"layer_0": stack([layers[c] for c in order])}
    flat_w = np.asarray(tree["layer_windows"]).reshape(-1)
    flat_t = np.asarray(tree["layer_thetas"]).reshape(-1)
    out["layer_windows"] = flat_w[order].reshape(-1, 1)
    out["layer_thetas"] = flat_t[order].reshape(-1, 1)
    return out


def ingest_child(device, results):
    """23a, in a spawned process beside 23b-e (the card and the host share
    out; this process's launch counters are its own).  INGEST_ARCH cut to
    INGEST_LAYERS layers at full width: a BF16 fixture (values drawn on
    the card, bf16-exact; the norms, 1 + 0.01·r, widened as the BF16 file
    holds them) written by the port's safetensors writer in
    INGEST_SHARDS shards and an index; ``checkpoint/convert.py``
    converts it for pp 2 at v 1 and v 2 and exports the v 1 directory,
    which must equal the fixture bit for bit.  v 1: ``load_converted``
    (through ``launch/serve.py::load_checkpoint``, ``serve_1f``) equals
    ``hf_to_params`` bit for bit, and the session's tokens and every
    step's logits equal a session with the ``hf_to_params`` tree
    installed in memory, bit for bit.  v 2: the v 1 directory is refused
    by the ``serve_interleaved`` session (ConvertError, before a chunk is
    read); the v 2 directory's tree equals the v 1 tree re-chunked into
    v 2 rows (:func:`to_v2_rows`) bit for bit, and serving it from the
    directory equals serving that re-chunked tree from memory.  Puts
    ("ok", record) or ("error", traceback) on ``results``."""
    import tempfile
    import traceback
    import types
    from concurrent.futures import ThreadPoolExecutor
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        import torch
        from repro_torch import configs
        from repro_torch.checkpoint import convert as cv
        from repro_torch.launch.serve import load_checkpoint
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = configs.get(INGEST_ARCH)
        spec = ingest_spec()
        steps = Steps()
        rec = {"model": spec.name, "layers": spec.n_layers,
               "parameters": spec.param_count(), "shards": INGEST_SHARDS,
               "fixture_dtype": "BF16"}
        rng = np.random.default_rng(SEED + 3)
        prompts = rng.integers(0, spec.vocab, (R_SLOTS, ROWS, PREFILL)
                               ).astype(np.int32)
        plans = {1: cfg.PLAN.with_(pp=2, tp=1, decode_microbatches=R_SLOTS)}
        plans[2] = plans[1].with_(schedule="serve_interleaved",
                                  virtual_stages=2)
        with tempfile.TemporaryDirectory(prefix="ingest-") as tmp:
            hf = os.path.join(tmp, "hf")
            dirs = {v: os.path.join(tmp, f"ck_v{v}") for v in (1, 2)}
            tensors = steps.timed(
                "draw (card) to host",
                lambda t: sum(a.nbytes for a in t.values()),
                lambda: cv.synthetic_tensors(
                    spec, draw=card_draw(device, SEED)))
            tensors = {k: a if a.size > spec.d_model else
                       torch.from_numpy(a).bfloat16().float().numpy()
                       for k, a in tensors.items()}
            steps.timed("write BF16 fixture", lambda _: dir_bytes(hf),
                        lambda: cv.write_checkpoint(
                            hf, tensors, shards=INGEST_SHARDS, dtype="BF16"))
            rec["fixture_gb"] = dir_bytes(hf) / 1e9
            back = os.path.join(tmp, "back.safetensors")

            def convert(v):
                return steps.timed(
                    f"convert pp 2 v {v}", lambda _: dir_bytes(dirs[v]),
                    lambda: cv.convert(hf, dirs[v], spec, pp=2,
                                       virtual_stages=v, config=INGEST_ARCH))

            def export():
                out = steps.timed("export v 1 (F32)",
                                  lambda _: os.path.getsize(back),
                                  lambda: cv.export_checkpoint(dirs[1], back,
                                                               spec))
                same_arrays("export vs the fixture", out, tensors)
                os.remove(back)

            # two at a time: the passes are I/O and GIL-free numpy / torch
            with ThreadPoolExecutor(max_workers=2) as pool:
                t0 = time.perf_counter()
                for f in [pool.submit(convert, v) for v in (1, 2)]:
                    f.result()
                rec["convert_both_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                exported = pool.submit(export)
                direct = steps.timed("hf_to_params v 1 (in memory)",
                                     tensor_bytes_np, lambda: cv.hf_to_params(
                                         tensors, spec, pp=2))
                exported.result()
                rec["export_and_hf_to_params_s"] = time.perf_counter() - t0
            del tensors

            def serve(v, tree=None, ckpt=None):
                sess = new_session(spec, plans[v], device, None).start(SEED)
                loaded = None
                if tree is not None:
                    sess.load_params(tree)
                else:
                    loaded, _ = steps.timed(
                        f"load_checkpoint v {v}", lambda _: dir_bytes(ckpt),
                        lambda: load_checkpoint(
                            sess, spec, types.SimpleNamespace(ckpt=ckpt)))
                reset_counts()
                run = serve_logits(sess, prompts, INGEST_DECODE)
                counts = read_counts()
                want = spec.n_layers * R_SLOTS * INGEST_DECODE
                if counts["paged_attention"] != want:
                    raise AssertionError(f"23a v {v}: paged launches "
                                         f"{counts}, expected {want}")
                if v > 1 and tree is None:
                    # the v 1 directory into this v 2 session
                    try:
                        load_checkpoint(sess, spec, types.SimpleNamespace(
                            ckpt=dirs[1]))
                    except cv.ConvertError as e:
                        rec["v1_into_v2"] = str(e)
                    else:
                        raise AssertionError("the v 1 directory loaded into "
                                             "the v 2 session")
                del sess
                torch.cuda.empty_cache()
                return run, loaded

            served = {}
            for v in (1, 2):
                (t_dir, l_dir), loaded = serve(v, ckpt=dirs[v])
                if v == 1:
                    same_arrays("load_converted v 1 vs hf_to_params", loaded,
                                direct)
                    twin = direct
                else:
                    twin = to_v2_rows(v1_loaded, spec,
                                      [int(c) for c in cv.storage_order(2, 2)])
                    same_arrays("v 2 directory vs the v 1 tree re-chunked",
                                loaded, twin)
                (t_mem, l_mem), _ = serve(v, tree=twin)
                if not (torch.equal(t_dir, t_mem)
                        and torch.equal(l_dir, l_mem)):
                    raise AssertionError(f"23a v {v}: served from the "
                                         "directory differs from the same "
                                         "tree in memory")
                if not torch.isfinite(l_dir).all():
                    raise AssertionError(f"23a v {v}: non-finite logits")
                served[v] = t_dir.cpu().numpy()
                if v == 1:
                    v1_loaded = loaded
                    del direct
                del loaded, twin
                log(f"[ingest] v {v}: tokens and {l_dir.shape[0]} steps' "
                    f"logits from the directory == from memory, bit for "
                    f"bit; first tokens {served[v][0, :4].tolist()}")
        rec["paged_launches"] = 2 * 2 * spec.n_layers * R_SLOTS * INGEST_DECODE
        rec["tokens_equal_v1_v2"] = bool((served[1] == served[2]).all())
        rec["steps"] = dict(steps)
        log(f"[ingest] {spec.name}: export == fixture, load_converted == "
            f"hf_to_params (v 1) and == the v 1 tree re-chunked (v 2), "
            f"served from the directories == from memory bit for bit, the "
            f"v 1 directory refused at v 2 ({rec['v1_into_v2'][:60]}...)")
        results.put(("ok", rec))
    except BaseException:
        results.put(("error", traceback.format_exc()))
        raise


def ingest_spec():
    from repro_torch import configs
    from repro_torch.launch.train import cut_layers
    return cut_layers(configs.get(INGEST_ARCH).full_spec(), INGEST_LAYERS)


def tensor_bytes_np(tree) -> int:
    return sum(np.asarray(a).nbytes for _, a in tree_leaves(tree)
               if isinstance(a, np.ndarray))


def serve_new(device, arch):
    """23b-d: ``arch`` at full width and depth, bf16, ``serve_1f`` pp 2,
    phase 3's shape (R_SLOTS x ROWS, prefill PREFILL, cache CACHE_LEN,
    page PAGE, N_DECODE decodes: every decode's attention through the
    paged kernel), a profiled decode step; then the reference in bf16:
    for a dense model ``full_transformer`` over the served sequence (its
    greedy tokens the served ones at every generated position, up to
    near-ties of NEW_TIE), for an MoE model per slot over the prompts (a
    longer pass routes more tokens a call: other capacity, other drops),
    its greedy token the served first token up to NEW_TIE."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import paged_attention as pa
    cfg = configs.get(arch)
    spec = cfg.full_spec()
    plan = cfg.PLAN.with_(pp=2, tp=1, decode_microbatches=R_SLOTS)
    t0 = time.perf_counter()
    session = new_session(spec, plan, device, None).start(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = tensor_bytes(session.params)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, spec.vocab, (R_SLOTS, ROWS, PREFILL)
                           ).astype(np.int32)
    reset_counts()
    t0 = time.perf_counter()
    nxt = session.prefill({"tokens": prompts})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    toks, step_s = [nxt], []
    per_step = spec.n_layers * R_SLOTS
    for i in range(N_DECODE):
        before = pa.paged_attention.launches
        t0 = time.perf_counter()
        nxt = session.decode(nxt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if pa.paged_attention.launches - before != per_step:
            raise AssertionError(f"{spec.name} decode step {i}: paged kernel "
                                 f"launches {pa.paged_attention.launches - before}"
                                 f", expected {per_step}")
        toks.append(nxt)
    counts = read_counts()
    if counts != {"paged_attention": per_step * N_DECODE,
                  "paged_attention_int8": 0, "flash_attention": 0,
                  "flash_attention_bwd": 0, "wkv6": 0, "mamba_scan": 0}:
        raise AssertionError(f"launches on {spec.name}'s serve path: {counts}")
    toks = torch.stack(toks).cpu().numpy()
    session._alloc.check()
    ms = 1e3 * float(np.median(step_s))
    prof = profile_decode_step(session, nxt, ms, kernels=("paged_attention",))
    reset_counts()
    t0 = time.perf_counter()
    if spec.moe is None:
        logits = reference_logits(session, prompts, toks,
                                  n_last=toks.shape[0])
        served = torch.from_numpy(toks.T.astype(np.int64))
        want_flash = spec.n_layers
    else:
        logits = slot_prefill_logits(session, prompts)[:, None]
        served = torch.from_numpy(toks[:1].T.astype(np.int64))
        want_flash = spec.n_layers * R_SLOTS
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref_counts = read_counts()
    if ref_counts["flash_attention"] != want_flash or \
            ref_counts["paged_attention"]:
        raise AssertionError(f"{spec.name} reference launches {ref_counts}, "
                             f"expected {want_flash} flash")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{spec.name}: non-finite reference logits")
    served = served.to(logits.device)
    gap = logits.amax(-1) - logits.gather(-1, served[..., None])[..., 0]
    agree = logits.argmax(-1) == served
    if (gap > NEW_TIE).any():
        raise AssertionError(
            f"{spec.name}: served tokens are not full_transformer's greedy "
            f"tokens at {int((gap > NEW_TIE).sum())} of {gap.numel()} "
            f"positions (logit gap up to {gap.max().item():.4f} > {NEW_TIE})")
    rec = {"model": spec.name, "layers": spec.n_layers,
           "parameters": spec.param_count(), "weight_gb": weights / 1e9,
           "heads": [spec.n_heads, spec.n_kv, spec.d_head], "pp": plan.pp,
           "slots": R_SLOTS, "rows": ROWS, "prefill": PREFILL,
           "cache_len": CACHE_LEN, "init_s": init_s,
           "prefill_s": t_prefill, "decode_ms_per_step": ms,
           "decode_ms_steps": [1e3 * x for x in step_s],
           "decode_tokens_per_s": R_SLOTS * ROWS * 1e3 / ms,
           "moe_capacity": (None if session.statics.moe is None
                            else session.statics.moe.capacity),
           "paged_launches": counts["paged_attention"],
           "reference_flash_launches": ref_counts["flash_attention"],
           "reference_s": ref_s, "reference_positions": gap.numel(),
           "reference_agree": int(agree.sum()),
           "reference_max_gap": gap.max().item(), "tie": NEW_TIE}
    log(f"[serve-new] {spec.name}: {spec.n_layers} layers, "
        f"{spec.param_count() / 1e9:.2f} B parameters ({weights / 1e9:.1f} "
        f"GB), heads {spec.n_heads}/{spec.n_kv}; init {init_s:.1f}s, "
        f"prefill {t_prefill:.3f}s, decode {ms:.2f} ms/step (median of "
        f"{N_DECODE}), {rec['decode_tokens_per_s']:.1f} tokens/s; paged "
        f"launches {counts['paged_attention']}; reference: greedy == served "
        f"at {rec['reference_agree']}/{gap.numel()} positions, max gap "
        f"{rec['reference_max_gap']:.4f} (limit {NEW_TIE}); profiled step: "
        f"device {prof['device_ms']:.2f} ms, idle {prof['idle_share']:.3f}, "
        f"{prof['kernel_launches']} launches; top (ms, calls) "
        f"{[(k['name'][:50], round(k['ms'], 3), k['calls']) for k in prof['by_kernel'][:6]]}")
    del session
    torch.cuda.empty_cache()
    return rec, prof


def consistency_new(device, arch, spec=None):
    """23b-d (25c: ``spec``, a cut of the arch) in fp32 at
    NEW_CONS_LAYERS layers and full width: the paged
    engine against the dense-cache engine on the card (tokens; last
    hidden states and pools against caches within 1e-5), its prefill
    logits against ``full_transformer``'s (per slot, 1e-3), and the same
    paged session on the CPU from the card's weights (tokens and
    positions equal, hidden states within 1e-4)."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.train import cut_layers
    from repro_torch.models import lm_head
    cfg = configs.get(arch)
    if spec is None:
        spec = cut_layers(cfg.full_spec(), NEW_CONS_LAYERS)
    plan = cfg.PLAN.with_(pp=2, tp=1, decode_microbatches=NEW_CONS_SLOTS)
    rng = np.random.default_rng(SEED + 4)
    prompts = rng.integers(0, spec.vocab, (NEW_CONS_SLOTS, ROWS,
                                           NEW_CONS_PREFILL)).astype(np.int32)
    kw = dict(cache_len=NEW_CONS_CACHE, prefill_len=NEW_CONS_PREFILL)
    f32 = torch.float32
    paged = new_session(spec, plan, device, f32, **kw).start(SEED)
    dense = new_session(spec, plan, device, f32, page_size=0,
                        **kw).reset_state().set_params(paged.params)
    host = new_session(spec, plan, "cpu", f32, **kw).reset_state()
    host.set_params(to_device(paged.params, "cpu"))
    runs, secs = {}, {}
    for name, s in (("paged", paged), ("dense", dense), ("cpu", host)):
        t0 = time.perf_counter()
        nxt = s.prefill({"tokens": prompts})
        if name == "paged":
            fn = s.params["final_norm"]
            eng_logits = lm_head.last_logits(s.params["head"], fn["scale"],
                                             s.last_hidden, vocab=spec.vocab)
        hs, ts = [s.last_hidden.cpu()], [nxt.cpu()]
        for _ in range(NEW_CONS_DECODE):
            nxt = s.decode(nxt)
            hs.append(s.last_hidden.cpu())
            ts.append(nxt.cpu())
        runs[name] = (torch.stack(ts).numpy(), hs)
        secs[name] = time.perf_counter() - t0
    for other in ("dense", "cpu"):
        if not (runs[other][0] == runs["paged"][0]).all():
            raise AssertionError(f"{spec.name}: {other} tokens differ from "
                                 "the paged card session's")
    if not ((paged._pos == dense._pos).all() and
            (paged._pos == host._pos).all()):
        raise AssertionError(f"{spec.name}: positions differ")
    tol = 1e-5
    err_d = max(check_close(f"{spec.name} paged vs dense hidden {i}", a, b,
                            tol, tol)
                for i, (a, b) in enumerate(zip(runs["paged"][1],
                                               runs["dense"][1])))
    n_keys = NEW_CONS_PREFILL + NEW_CONS_DECODE
    err_kv = 0.0
    for name, (kp, vp) in paged.pages.items():
        for pool, cache in zip((kp, vp), dense.cache[name]["kv"]):
            for m in range(NEW_CONS_SLOTS):
                ids = torch.from_numpy(paged._alloc.tables[m]).long()
                ids = ids[ids >= 0].to(device)
                got = pool[:, ids].transpose(1, 2).reshape(
                    pool.shape[0], ROWS, -1, *pool.shape[-2:])[:, :, :n_keys]
                err_kv = max(err_kv, check_close(
                    f"{spec.name} {name} pool", got, cache[:, m, :, :n_keys],
                    tol, tol))
    err_c = max(check_close(f"{spec.name} card vs CPU hidden {i}", a, b,
                            1e-4, 1e-4)
                for i, (a, b) in enumerate(zip(runs["paged"][1],
                                               runs["cpu"][1])))
    ref_logits = slot_prefill_logits(paged, prompts)
    err_l = check_close(f"{spec.name} full_transformer vs engine logits",
                        eng_logits, ref_logits, 1e-3, 1e-3)
    rec = {"layers": spec.n_layers, "paged_vs_dense_hidden": err_d,
           "pools_vs_caches": err_kv, "card_vs_cpu_hidden": err_c,
           "engine_vs_full_transformer_logits": err_l, "seconds": secs}
    log(f"[consistency-new] {spec.name} fp32 {spec.n_layers} layers at full "
        f"width, {NEW_CONS_SLOTS} x {ROWS} rows, prefill {NEW_CONS_PREFILL} "
        f"+ {NEW_CONS_DECODE} decodes: paged == dense tokens, hidden "
        f"{err_d:.3e}, pools {err_kv:.3e} (atol/rtol {tol}); card == CPU "
        f"tokens and positions, hidden {err_c:.3e} (1e-4); engine vs "
        f"full_transformer prefill logits {err_l:.3e} (1e-3); seconds "
        f"{json.dumps({k: round(v, 2) for k, v in secs.items()})}")
    del paged, dense, host
    torch.cuda.empty_cache()
    return rec


def new_serve_train(device, out, profs, launches, seconds):
    """23b-d (NEW_SERVE through :func:`serve_new` and
    :func:`consistency_new`) and 23e (NEW_TRAIN through :func:`train_cut`
    at phase 13's shape, 1f1b / stash pp 2, then each at NEW_CONS_LAYERS
    layers in fp32: executor == oracle bit for bit), into ``out``,
    ``profs``, ``launches`` and ``seconds``."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.train import cut_layers
    from repro_torch.optim import SGDM
    for arch in NEW_SERVE:
        t0 = time.perf_counter()
        rec, prof = serve_new(device, arch)
        rec["consistency"] = consistency_new(device, arch)
        key = arch.split("-")[0]
        launches[f"{key}_serve"] = {"paged_attention": rec["paged_launches"]}
        launches[f"{key}_reference"] = {
            "flash_attention": rec["reference_flash_launches"]}
        out["serve"][arch] = rec
        profs.append({**prof, "phase": "decode"})
        seconds[arch] = time.perf_counter() - t0
    for arch, layers in NEW_TRAIN:
        t0 = time.perf_counter()
        rec, prof = train_cut(device, arch, layers, 2, "1f1b", "stash",
                              FLASH_KERNELS)
        out["train"][arch] = rec
        profs.append(prof)
        launches[f"{arch.split('-')[0]}_train"] = rec["launches"]
        seconds[f"train {arch}"] = time.perf_counter() - t0
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    out["exact"] = {}
    try:
        for arch, _ in NEW_TRAIN:
            t0 = time.perf_counter()
            cfg = configs.get(arch)
            spec = cut_layers(cfg.full_spec(), NEW_CONS_LAYERS)
            plan = cfg.PLAN.with_(tp=1, pp=2, microbatches=CONS_R,
                                  schedule="1f1b", stash_mode="stash")
            reset_counts()
            with plain_versions_refused():
                out["exact"][arch] = executor_equals_oracle(
                    device, "1f1b/stash", spec, plan, SGDM(lr=0.01),
                    donate=True)
            counts = read_all_counts()
            want = train_launches(spec, 2 * CONS_ROUNDS, CONS_R)
            if {k: counts[k] for k in want} != want:
                raise AssertionError(f"23e {spec.name} launches {counts}, "
                                     f"expected {want} (executor + oracle)")
            out["exact"][arch]["launches"] = counts
            launches[f"{arch.split('-')[0]}_train_exact"] = counts
            seconds[f"exact {arch}"] = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)


def phase_new_configs(device, alongside=None):
    """Phase 23: 23a (:func:`ingest_child`) in a spawned process beside
    23b-e (:func:`new_serve_train`), which run here, then ``alongside()``
    (phase 24) while 23a finishes.  Returns (records, profiles, launches
    by path, seconds)."""
    import multiprocessing
    import torch
    out, profs, launches, seconds = {"serve": {}, "train": {}}, [], {}, {}
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    child = ctx.Process(target=ingest_child, args=(device, results))
    t_child = time.perf_counter()
    child.start()
    try:
        new_serve_train(device, out, profs, launches, seconds)
        if alongside is not None:
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            alongside()
            seconds["24 beside 23a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        status, got = results.get(timeout=INGEST_S)
        child.join(60)
        seconds["23a wait after 23b-e and 24"] = time.perf_counter() - t0
        seconds["23a (spawned with 23b)"] = time.perf_counter() - t_child
        if status != "ok":
            raise AssertionError(f"23a failed:\n{got}")
        out["ingest"] = got
    finally:
        if child.is_alive():
            child.kill()
            child.join(5)
    launches["olmoe_ingest_serve"] = {
        "paged_attention": out["ingest"]["paged_launches"]}
    log(f"[phases] 23 seconds: {json.dumps(seconds)}")
    return out, profs, launches, seconds


def new_config_launches(launches):
    """Phase 23's and 24's launches by kernel and layout for the kernels
    line:
    {kernel: {layout: {path: count}}}, and by kernel over every layout."""
    out = {k: {name: {} for name in LAYOUTS}
           for k in ("paged_attention", "paged_attention_verify",
                     "flash_attention", "flash_attention_bwd")}
    for path, counts in launches.items():
        layout = next(n for n, archs in LAYOUT_ARCHS.items()
                      if path.split("_")[0] in archs)
        for k in ("paged_attention", "flash_attention",
                  "flash_attention_bwd"):
            if counts.get(k):
                out[k][layout][path] = counts[k]
    return out


# --------------------------------------------------------------------------
# phase 24: whisper-medium (an encoder, cross-attention) and llava-next-34b
# (a patch prefix), served and trained
# --------------------------------------------------------------------------

# 24a-b: (arch, decoder layers kept (None: all), text tokens a prompt,
# cache_len): whisper's cache is its published decoder context
# (max_target_positions 448); llava is cut to 8 of 60 layers (~10.6 GB of
# bf16 weights) and its prompt is its 576 patches and the text
FRONT_SERVE = (("whisper-medium", None, 64, 448),
               ("llava-next-34b", 8, 64, 1024))
# 24c: (arch, decoder layers kept, schedule, stash mode, rows a
# microbatch, text tokens a row), R FRONT_R microbatches, FRONT_ROUNDS
# rounds, the config's Adam
FRONT_TRAIN = (("whisper-medium", None, "1f1b", "stash", 2, 128),
               ("llava-next-34b", 4, None, "flush", 1, 128))
FRONT_R, FRONT_ROUNDS = 4, 2
# 24d: whisper at 2 decoder + 2 encoder layers in fp32: one slot of ROWS
# rows, a prompt of FRONT_CONS_TEXT tokens and NEW_CONS_DECODE decodes
FRONT_CONS_LAYERS, FRONT_CONS_TEXT, FRONT_CONS_CACHE = 2, 40, 128
FRONT_TIE = RWKV_TIE


def front_spec(arch, layers=None, enc_layers=None):
    """``arch``'s full spec, its decoder cut to ``layers`` and its
    encoder (where it has one) to ``enc_layers``."""
    from repro_torch import configs
    from repro_torch.launch.train import cut_layers
    spec = configs.get(arch).full_spec()
    if layers:
        spec = cut_layers(spec, layers)
    if enc_layers and spec.encoder is not None:
        spec = dataclasses.replace(spec, encoder=dataclasses.replace(
            spec.encoder, n_layers=enc_layers))
    return spec


def front_session(spec, arch, device, dtype, text, cache_len, slots, **kw):
    """A ``serve_1f`` pp 2 session of ``slots`` x ROWS rows whose prompt
    is the patch prefix (VLMs) and ``text`` tokens."""
    from repro_torch import configs
    from repro_torch.serving.engine import build_serving
    plan = configs.get(arch).PLAN.with_(pp=2, tp=1,
                                         decode_microbatches=slots)
    n_patch = spec.n_patches if spec.frontend == "vision" else 0
    return build_serving(spec, plan, cache_len=cache_len,
                         global_batch=slots * ROWS, compute_dtype=dtype,
                         prefill_len=n_patch + text,
                         page_size=kw.pop("page_size", PAGE), device=device,
                         **kw)


def front_logits(session, batch, toks, n_last):
    """``full_transformer`` over the served sequences — a VLM's patches,
    the prompt's text and the fed tokens — cross-attending into the
    session's own ``enc_out`` (the same encoder output the engine used);
    f32 logits at the last ``n_last`` positions, (rows, n_last, Vpad)."""
    import torch
    from repro_torch.models import lm_head
    from repro_torch.models.stage import full_transformer
    p, dev, spec = session.params, session.device, session.spec
    text = batch["tokens"].reshape(-1, batch["tokens"].shape[-1])
    seq = np.concatenate([text, toks[:-1].T], axis=1) if len(toks) > 1 \
        else text
    x = lm_head.embed_tokens(p["embed"], torch.from_numpy(seq).to(dev),
                             session.compute_dtype)
    if session.prefix_len:
        patches = torch.from_numpy(batch["patches"]).to(dev)
        x = torch.cat([patches.flatten(0, 1).to(x.dtype), x], dim=1)
    cross = (None if session.enc_out is None
             else session.enc_out.flatten(0, 1))
    pos = torch.arange(x.shape[1], device=dev).expand(x.shape[0], -1)
    h = full_transformer(p, x, session.statics, positions=pos,
                         cross_x=cross)
    fn = p["final_norm"]
    return torch.stack([
        lm_head.last_logits(p["head"], fn["scale"], h[:, t:t + 1],
                            norm_kind=spec.norm, norm_bias=fn.get("bias"),
                            vocab=spec.vocab)
        for t in range(x.shape[1] - n_last, x.shape[1])], dim=1)


def serve_front(device, arch, layers, text, cache_len):
    """24a / 24b: ``arch`` at full width, bf16, seeded weights, ``serve_1f``
    pp 2, R_SLOTS x ROWS rows: the entry point's prefill batch
    (launch/serve.py::prefill_batch: tokens, and the patches or frames),
    N_DECODE decodes with every decoder self-attention through the paged
    kernel (cross-attention K / V recomputed from ``enc_out``), a
    profiled decode step; then ``full_transformer`` over the served
    sequences with the same encoder output: its greedy tokens the served
    ones at every generated position, up to near-ties of FRONT_TIE."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import prefill_batch
    spec = front_spec(arch, layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = front_session(spec, arch, device, torch.bfloat16, text,
                            cache_len, R_SLOTS).start(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = tensor_bytes(session.params)
    batch = prefill_batch(session, SEED)
    reset_counts()
    t0 = time.perf_counter()
    nxt = session.prefill(batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    toks, step_s = [nxt], []
    per_step = spec.n_layers * R_SLOTS
    for i in range(N_DECODE):
        before = pa.paged_attention.launches
        t0 = time.perf_counter()
        nxt = session.decode(nxt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if pa.paged_attention.launches - before != per_step:
            raise AssertionError(
                f"{spec.name} decode step {i}: paged kernel launches "
                f"{pa.paged_attention.launches - before}, expected {per_step}")
        toks.append(nxt)
    counts = read_counts()
    if counts != {"paged_attention": per_step * N_DECODE,
                  "paged_attention_int8": 0, "flash_attention": 0,
                  "flash_attention_bwd": 0, "wkv6": 0, "mamba_scan": 0}:
        raise AssertionError(f"launches on {spec.name}'s serve path: {counts}")
    toks = torch.stack(toks).cpu().numpy()
    session._alloc.check()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if session.enc_out is not None and not (
            torch.isfinite(session.enc_out).all()
            and session.enc_out.abs().amax() > 0):
        raise AssertionError(f"{spec.name}: enc_out not finite or all zero")
    ms = 1e3 * float(np.median(step_s))
    prof = profile_decode_step(session, nxt, ms, kernels=("paged_attention",))
    reset_counts()
    t0 = time.perf_counter()
    logits = front_logits(session, batch, toks, toks.shape[0])
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref_counts = read_counts()
    if ref_counts["flash_attention"] != spec.n_layers or \
            ref_counts["paged_attention"]:
        raise AssertionError(f"{spec.name} reference launches {ref_counts}, "
                             f"expected {spec.n_layers} flash")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{spec.name}: non-finite reference logits")
    served = torch.from_numpy(toks.T.astype(np.int64)).to(logits.device)
    gap = logits.amax(-1) - logits.gather(-1, served[..., None])[..., 0]
    agree = logits.argmax(-1) == served
    if (gap > FRONT_TIE).any():
        raise AssertionError(
            f"{spec.name}: served tokens are not full_transformer's greedy "
            f"tokens at {int((gap > FRONT_TIE).sum())} of {gap.numel()} "
            f"positions (logit gap up to {gap.max().item():.4f} > "
            f"{FRONT_TIE})")
    enc = spec.encoder
    rec = {"model": spec.name, "layers": spec.n_layers,
           "encoder_layers": None if enc is None else enc.n_layers,
           "source_len": None if enc is None else enc.source_len,
           "patches": session.prefix_len,
           "parameters": spec.param_count(), "weight_gb": weights / 1e9,
           "heads": [spec.n_heads, spec.n_kv, spec.d_head], "pp": 2,
           "slots": R_SLOTS, "rows": ROWS, "text": text,
           "prefill": session.prefill_len, "cache_len": cache_len,
           "init_s": init_s, "prefill_s": t_prefill,
           "decode_ms_per_step": ms,
           "decode_ms_steps": [1e3 * x for x in step_s],
           "decode_tokens_per_s": R_SLOTS * ROWS * 1e3 / ms,
           "peak_allocated_gb": peak,
           "paged_launches": counts["paged_attention"],
           "reference_flash_launches": ref_counts["flash_attention"],
           "reference_s": ref_s, "reference_positions": gap.numel(),
           "reference_agree": int(agree.sum()),
           "reference_max_gap": gap.max().item(), "tie": FRONT_TIE}
    log(f"[serve-front] {spec.name}: {spec.n_layers} decoder layers"
        f"{'' if enc is None else f' + {enc.n_layers} encoder layers over {enc.source_len} frames'}"
        f", {session.prefix_len} patches, {spec.param_count() / 1e9:.2f} B "
        f"parameters ({weights / 1e9:.1f} GB), heads {spec.n_heads}/"
        f"{spec.n_kv} of {spec.d_head}; init {init_s:.1f}s, prefill "
        f"{t_prefill:.3f}s, decode {ms:.2f} ms/step (median of {N_DECODE}), "
        f"{rec['decode_tokens_per_s']:.1f} tokens/s, peak {peak:.1f} GB; "
        f"paged launches {counts['paged_attention']}; reference: greedy == "
        f"served at {rec['reference_agree']}/{gap.numel()} positions, max "
        f"gap {rec['reference_max_gap']:.4f} (limit {FRONT_TIE}); profiled "
        f"step: device {prof['device_ms']:.2f} ms, idle "
        f"{prof['idle_share']:.3f}, {prof['kernel_launches']} launches; top "
        f"(ms, calls) {[(k['name'][:50], round(k['ms'], 3), k['calls']) for k in prof['by_kernel'][:6]]}")
    del session
    torch.cuda.empty_cache()
    return rec, prof


def train_front(device, arch, layers, schedule, mode, rows, text):
    """24c: ``arch`` at full width (its decoder cut to ``layers``) through
    the launcher's build and loader (launch/train.py: the stubs' frames
    or patches beside the text), FRONT_R microbatches of ``rows`` rows x
    (patches +) ``text`` tokens, pp 2, the config's Adam, FRONT_ROUNDS
    rounds, the last under torch.profiler, the plain attention versions
    refused: finite losses, the encoder's leaves moved, every decoder
    self-attention forward and backward on the flash kernels (the
    encoder's attention and cross-attention take the plain path, as in
    JAX); the peak GB."""
    import torch
    from repro_torch.launch.train import make_loader
    spec = front_spec(arch, layers)
    n_patch = spec.n_patches if spec.frontend == "vision" else 0
    extra = ["--pp", "2", "--microbatches", str(FRONT_R), "--global-batch",
             str(FRONT_R * rows), "--seq-len", str(n_patch + text),
             "--stash-mode", mode]
    if layers:
        extra += ["--layers", str(layers)]
    if schedule:
        extra += ["--schedule", schedule]
    spec, bundle = build_train(train_args(extra, arch=arch))
    plan = bundle.plan
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = bundle.init_state(torch.Generator(device).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in tree_leaves(state["params"])
                   if torch.is_tensor(t))
    enc0 = (None if spec.encoder is None else
            {k: v.clone() for k, v in state["params"]["encoder"].items()
             if k in ("wq", "w2", "pos")})
    loader = make_loader(spec, bundle, SEED)
    batches = [loader.get(r) for r in range(FRONT_ROUNDS)]
    reset_counts()
    losses, round_s, prof = [], [], None
    with plain_attention_refused():
        for r, batch in enumerate(batches):
            if r == len(batches) - 1:
                state, m, prof = profile_round(bundle, state, batch,
                                               round_s[-1])
            else:
                t1 = time.perf_counter()
                state, m = bundle.train_step(state, batch)
                torch.cuda.synchronize()
                round_s.append(time.perf_counter() - t1)
            losses.append(float(m["loss"]))
    counts = read_all_counts()
    want = {"paged_attention": 0, "paged_attention_int8": 0,
            **train_launches(spec, FRONT_ROUNDS, plan.microbatches)}
    if counts != want:
        raise AssertionError(f"launches on {spec.name}'s training path: "
                             f"{counts}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{spec.name}: non-finite loss: {losses}")
    moved = None
    if enc0 is not None:
        enc = state["params"]["encoder"]
        moved = {k: float((enc[k].float() - v.float()).abs().max())
                 for k, v in enc0.items()}
        if not all(x > 0 for x in moved.values()):
            raise AssertionError(f"{spec.name}: encoder leaves did not move "
                                 f"({moved})")
    tokens = plan.microbatches * bundle.microbatch_size * bundle.seq_len
    enc = spec.encoder
    out = {"model": spec.name, "layers": spec.n_layers,
           "encoder_layers": None if enc is None else enc.n_layers,
           "source_len": None if enc is None else enc.source_len,
           "patches": n_patch, "text": text, "parameters": n_params,
           "schedule": f"{bundle.sched.name}/{plan.stash_mode}",
           "pp": plan.pp, "microbatches": plan.microbatches,
           "rows": bundle.microbatch_size, "seq_len": bundle.seq_len,
           "init_s": init_s, "round_s": round_s,
           "round_s_warm": round_s[-1], "tokens_per_s": tokens / round_s[-1],
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss_per_round": losses, "encoder_moved_max_abs": moved,
           "launches": counts}
    log(f"[train-front] {spec.name}: {spec.n_layers} decoder layers"
        f"{'' if enc is None else f' + {enc.n_layers} encoder layers over {enc.source_len} frames'}"
        f", {n_patch} patches + {text} text tokens, {n_params / 1e9:.3f} B "
        f"parameters, {out['schedule']} pp={plan.pp} R={plan.microbatches} x "
        f"{bundle.microbatch_size}: init {init_s:.1f}s, rounds "
        f"{[round(x, 3) for x in round_s]} s, peak "
        f"{out['peak_allocated_gb']:.1f} GB; loss per round "
        f"{[round(x, 4) for x in losses]}; encoder moved {moved}; launches "
        f"{counts}")
    log(f"[profile] {spec.name} train round: {prof['device_ms']:.1f} ms of "
        f"device kernels in a {1e3 * round_s[-1]:.1f} ms round, idle share "
        f"{prof['idle_share']:.3f}, {prof['kernel_launches']} launches; "
        f"flash fwd {prof['flash_fwd_ms']:.1f} ms in "
        f"{prof['flash_fwd_launches']}, bwd {prof['flash_bwd_ms']:.1f} ms in "
        f"{prof['flash_bwd_launches']}; top kernels (ms, calls): "
        f"{[(k['name'][:50], round(k['ms'], 1), k['calls']) for k in prof['by_kernel']]}")
    del state, bundle, batches
    torch.cuda.empty_cache()
    return out, prof


def consistency_front(device):
    """24d: whisper at FRONT_CONS_LAYERS decoder and encoder layers in
    fp32 at full width: the paged engine against the dense-cache engine
    (tokens, positions, enc_out bit for bit; last hidden states and pools
    against caches within 1e-5) and its prefill logits against
    ``full_transformer``'s with the same encoder output (1e-3)."""
    import torch
    from repro_torch.launch.serve import prefill_batch
    from repro_torch.models import lm_head
    arch = "whisper-medium"
    spec = front_spec(arch, FRONT_CONS_LAYERS, FRONT_CONS_LAYERS)
    f32 = torch.float32
    kw = dict(text=FRONT_CONS_TEXT, cache_len=FRONT_CONS_CACHE,
              slots=NEW_CONS_SLOTS)
    paged = front_session(spec, arch, device, f32, **kw).start(SEED)
    dense = front_session(spec, arch, device, f32, page_size=0,
                          **kw).reset_state().set_params(paged.params)
    batch = prefill_batch(paged, SEED + 4)
    runs, secs = {}, {}
    for name, s in (("paged", paged), ("dense", dense)):
        t0 = time.perf_counter()
        nxt = s.prefill(batch)
        if name == "paged":
            fn = s.params["final_norm"]
            eng_logits = lm_head.last_logits(
                s.params["head"], fn["scale"], s.last_hidden,
                norm_kind=spec.norm, norm_bias=fn.get("bias"),
                vocab=spec.vocab)
        hs, ts = [s.last_hidden.cpu()], [nxt.cpu()]
        for _ in range(NEW_CONS_DECODE):
            nxt = s.decode(nxt)
            hs.append(s.last_hidden.cpu())
            ts.append(nxt.cpu())
        runs[name] = (torch.stack(ts).numpy(), hs)
        secs[name] = time.perf_counter() - t0
    if not (runs["dense"][0] == runs["paged"][0]).all():
        raise AssertionError(f"{spec.name}: dense tokens differ from the "
                             "paged session's")
    if not (paged._pos == dense._pos).all():
        raise AssertionError(f"{spec.name}: positions differ")
    if not torch.equal(paged.enc_out, dense.enc_out):
        raise AssertionError(f"{spec.name}: enc_out differs between the "
                             "paged and the dense session")
    tol = 1e-5
    err_d = max(check_close(f"{spec.name} paged vs dense hidden {i}", a, b,
                            tol, tol)
                for i, (a, b) in enumerate(zip(runs["paged"][1],
                                               runs["dense"][1])))
    n_keys = paged.prefill_len + NEW_CONS_DECODE
    err_kv = 0.0
    for name, (kp, vp) in paged.pages.items():
        for pool, cache in zip((kp, vp), dense.cache[name]["kv"]):
            for m in range(NEW_CONS_SLOTS):
                ids = torch.from_numpy(paged._alloc.tables[m]).long()
                ids = ids[ids >= 0].to(device)
                got = pool[:, ids].transpose(1, 2).reshape(
                    pool.shape[0], ROWS, -1, *pool.shape[-2:])[:, :, :n_keys]
                err_kv = max(err_kv, check_close(
                    f"{spec.name} {name} pool", got, cache[:, m, :, :n_keys],
                    tol, tol))
    ref = front_logits(paged, batch, np.zeros((1, 0)), 1)[:, 0]
    err_l = check_close(f"{spec.name} full_transformer vs engine logits",
                        eng_logits, ref, 1e-3, 1e-3)
    rec = {"layers": spec.n_layers, "encoder_layers": spec.encoder.n_layers,
           "paged_vs_dense_hidden": err_d, "pools_vs_caches": err_kv,
           "enc_out_equal": True, "engine_vs_full_transformer_logits": err_l,
           "seconds": secs}
    log(f"[consistency-front] {spec.name} fp32 {spec.n_layers} + "
        f"{spec.encoder.n_layers} layers at full width, {NEW_CONS_SLOTS} x "
        f"{ROWS} rows, {FRONT_CONS_TEXT} tokens + {spec.encoder.source_len} "
        f"frames + {NEW_CONS_DECODE} decodes: paged == dense tokens, "
        f"positions and enc_out, hidden {err_d:.3e}, pools {err_kv:.3e} "
        f"(atol/rtol {tol}); engine vs full_transformer prefill logits "
        f"{err_l:.3e} (1e-3); seconds "
        f"{json.dumps({k: round(v, 2) for k, v in secs.items()})}")
    del paged, dense
    torch.cuda.empty_cache()
    return rec


def phase_frontends(device):
    """Phase 24: 24a-b (:func:`serve_front`), 24c (:func:`train_front`),
    24d (:func:`consistency_front`, then whisper's executor against its
    oracle at FRONT_CONS_LAYERS + FRONT_CONS_LAYERS layers in fp32, bit for
    bit, under deterministic algorithms).  Returns (records, profiles,
    launches by path, seconds)."""
    import torch
    from repro_torch import configs
    from repro_torch.optim import SGDM
    out = {"serve": {}, "train": {}}
    profs, launches, seconds = [], {}, {}
    for arch, layers, text, cache_len in FRONT_SERVE:
        t0 = time.perf_counter()
        rec, prof = serve_front(device, arch, layers, text, cache_len)
        key = arch.split("-")[0]
        launches[f"{key}_serve"] = {"paged_attention": rec["paged_launches"]}
        launches[f"{key}_reference"] = {
            "flash_attention": rec["reference_flash_launches"]}
        out["serve"][arch] = rec
        profs.append({**prof, "phase": "decode"})
        seconds[f"serve {arch}"] = time.perf_counter() - t0
    for arch, layers, schedule, mode, rows, text in FRONT_TRAIN:
        t0 = time.perf_counter()
        rec, prof = train_front(device, arch, layers, schedule, mode, rows,
                                text)
        out["train"][arch] = rec
        profs.append(prof)
        launches[f"{arch.split('-')[0]}_train"] = rec["launches"]
        seconds[f"train {arch}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["consistency"] = consistency_front(device)
    seconds["24d consistency"] = time.perf_counter() - t0
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        arch = "whisper-medium"
        spec = front_spec(arch, FRONT_CONS_LAYERS, FRONT_CONS_LAYERS)
        plan = configs.get(arch).PLAN.with_(
            tp=1, pp=2, microbatches=CONS_R, schedule="1f1b",
            stash_mode="stash")
        reset_counts()
        with plain_attention_refused():
            out["exact"] = executor_equals_oracle(
                device, "1f1b/stash", spec, plan, SGDM(lr=0.01),
                donate=True)
        counts = read_all_counts()
        want = train_launches(spec, 2 * CONS_ROUNDS, CONS_R)
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"24d {spec.name} launches {counts}, "
                                 f"expected {want} (executor + oracle)")
        out["exact"]["launches"] = counts
        launches["whisper_train_exact"] = counts
        seconds["24d exact"] = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[phases] 24 seconds: {json.dumps(seconds)}")
    return out, profs, launches, seconds


# --------------------------------------------------------------------------
# phase 2 at Dh 256 and phase 25: gemma3-4b served and trained
# --------------------------------------------------------------------------

# gemma3-4b: 34 layers, 8 / 4 heads of 256, vocab 262144, five layers of
# a 1024-token window to one global layer.  25a serves its full_spec at
# phase 3's shape with a cache of GEMMA_CACHE, built without prefill_len:
# the stage positions that hold only windowed layers keep rings of the
# window, the others (a global layer on either stage) full-length caches,
# paged with a page size; 25b trains its first GEMMA_TRAIN_LAYERS layers
# (five windowed, one global) at phase 13's shape for GEMMA_TRAIN_ROUNDS
# rounds (the last profiled); 25c runs its layers
# GEMMA_CONS_BLOCKS (one windowed, one global: one a stage at pp 2) in
# fp32.  Phase 2's Dh 256 calls: the flash kernels at 25b's training call
# (1, TRAIN_SEQ, 8 / 4, 256), global and windowed; the paged walk at 25a's
# decode call (ROWS lanes of PREFILL + N_DECODE keys of a GEMMA_CACHE
# slot), float and int8 pools, and the verify tile (Q SPEC_K + 1).
GEMMA_ARCH = "gemma3-4b"
DH256_HEADS = (8, 4, 256)
GEMMA_WINDOW, GEMMA_CACHE = 1024, 2048
GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_ROUNDS = 6, 2
GEMMA_CONS_BLOCKS = (4, 6)
GEMMA_SPEC_DECODE = 12
GEMMA_TIE = RWKV_TIE


def dh256_flash_inputs(dtype, device, seed):
    """q, k, v, dO of gemma3-4b's attention at 25b's training call."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    h, kv, dh = DH256_HEADS
    shapes = ((1, TRAIN_SEQ, h, dh), (1, TRAIN_SEQ, kv, dh),
              (1, TRAIN_SEQ, kv, dh), (1, TRAIN_SEQ, h, dh))
    return [torch.randn(sh, generator=g, device=device).to(dtype)
            for sh in shapes]


def dh256_paged_lengths(q_len):
    """25a's decode call (Q 1) or a verify round from mid-page (Q 5)."""
    return [PREFILL + N_DECODE] * ROWS if q_len == 1 else [PREFILL + 37] * ROWS


def phase_dh256_kernels(device):
    """Phase 2 at Dh 256 (gemma3-4b's heads, G 2): the flash forward (with
    its rows' log-sum-exp) and backward in bf16 and f32 at (1, TRAIN_SEQ,
    8 / 4, 256), global and with the 1024 window (two identical backward
    calls bit-equal), and the paged walk at 25a's decode call and at the
    verify tile over float pools (bf16 and f32) and int8 pools (the int8
    walk also against the unquantized pools within 0.05), each against
    its plain version within TOL."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    errs = {"flash_attention": 0.0, "flash_attention_lse": 0.0,
            "flash_attention_bwd": 0.0, "paged_attention": 0.0,
            "paged_attention_verify": 0.0, "paged_attention_int8": (0.0, 0.0)}
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        tag = str(dtype)[6:]
        q, k, v, do = dh256_flash_inputs(dtype, device, 61)
        for w in (-1, GEMMA_WINDOW):
            out, lse = fa.flash_attention(q, k, v, window=w, return_lse=True)
            want, lse_plain = fa.flash_attention_plain(q, k, v, window=w,
                                                       return_lse=True)
            errs["flash_attention"] = max(errs["flash_attention"], check_close(
                f"flash Dh 256 {tag} window {w}", out, want, atol, rtol))
            errs["flash_attention_lse"] = max(
                errs["flash_attention_lse"], check_close(
                    f"flash Dh 256 {tag} window {w} lse", lse, lse_plain,
                    atol, rtol))
            del want, lse_plain
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, window=w)
            again = fa.flash_attention_bwd(q, k, v, out, lse, do, window=w)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash bwd Dh 256 {tag} window {w}: two "
                                     "identical calls differ")
            want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                window=w)
            errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], *(
                check_close(f"flash bwd Dh 256 {tag} window {w} {n}", g_, w_,
                            atol, rtol)
                for n, g_, w_ in zip(("dq", "dk", "dv"), got, want)))
            del out, lse, got, again, want
            torch.cuda.empty_cache()
        del q, k, v, do
        for q_len in (1, SPEC_K + 1):
            key = "paged_attention" if q_len == 1 else "paged_attention_verify"
            sets, tab, lens = paged_inputs(
                dtype, device, q_len, dh256_paged_lengths(q_len), seed=62,
                heads=DH256_HEADS, cache_len=GEMMA_CACHE)
            qp, kp, vp = sets[0]
            for w in (-1, GEMMA_WINDOW // 2):
                got = pa.paged_attention(qp, kp, vp, tab, lens, window=w)
                want = pa.paged_attention_plain(qp, kp, vp, tab, lens,
                                                window=w)
                errs[key] = max(errs[key], check_close(
                    f"paged Dh 256 Q={q_len} {tag} window {w}", got, want,
                    atol, rtol))
            del sets
        sets, tab, lens, (kp, vp) = paged_int8_inputs(
            dtype, device, 1, dh256_paged_lengths(1), 63, heads=DH256_HEADS,
            cache_len=GEMMA_CACHE)
        qi, kq, vq, ks, vs = sets[0]
        got = pa.paged_attention(qi, kq, vq, tab, lens, k_scale=ks,
                                 v_scale=vs)
        want = pa.paged_attention_plain(qi, kq, vq, tab, lens, k_scale=ks,
                                        v_scale=vs)
        full = pa.paged_attention_plain(qi, kp, vp, tab, lens)
        ei = check_close(f"paged int8 Dh 256 {tag}", got, want, atol, rtol)
        ef = check_close(f"paged int8 Dh 256 {tag} vs unquantized", got,
                         full, 0.05, 0.05)
        errs["paged_attention_int8"] = tuple(
            max(a, b) for a, b in zip(errs["paged_attention_int8"], (ei, ef)))
        del sets, got, want, full
        torch.cuda.empty_cache()
    log(f"[kernels] Dh 256 (8/4 heads, G 2): max|err| {json.dumps(errs)} "
        f"(bf16 atol/rtol {TOL['bfloat16']}, f32 {TOL['float32']}); the "
        "backward bit-equal twice")
    return errs


def dh256_records(device, errs, launches):
    """Times at Dh 256 beside bounds, plain versions and the library: the
    flash forward and backward at (1, TRAIN_SEQ, 8 / 4, 256) global and
    windowed, bf16 (on the tensor cores) and f32 (CUDA cores; SDPA with
    TF32 off), the paged walk at 25a's decode call and the verify tile,
    the int8 walk at the decode call.  {record name: {case: entry}};
    ``launches`` maps a record name to {path: count}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    bf16 = torch.bfloat16
    h, kv, dh = DH256_HEADS
    s = TRAIN_SEQ
    out = {"flash_attention": {}, "flash_attention_bwd": {}}
    idx = torch.arange(s, device=device)
    dist = idx[:, None] - idx[None, :]
    for dtype, w in ((bf16, -1), (bf16, GEMMA_WINDOW), (torch.float32, -1),
                     (torch.float32, GEMMA_WINDOW)):
        q, k, v, do = dh256_flash_inputs(dtype, device, 64)
        f32 = dtype == torch.float32
        peak, reps = ("float32", 5) if f32 else ("bfloat16", 30)
        case = ("causal" if w < 0 else f"window_{w}") + ("_f32" if f32
                                                         else "")
        # 25c's exact check runs in f32, 25a-b in bf16
        paths = {k: {p: n for p, n in launches[k].items()
                     if ("exact" in p) == f32}
                 for k in ("flash_attention", "flash_attention_bwd")}
        mask = None if w < 0 else (dist >= 0) & (dist < w)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa(*a):
            if mask is None:
                return F.scaled_dot_product_attention(*a, is_causal=True,
                                                      enable_gqa=True)
            return F.scaled_dot_product_attention(*a, attn_mask=mask,
                                                  enable_gqa=True)
        ms = time_ms(lambda: fa.flash_attention(q, k, v, window=w), reps)
        plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, window=w),
                        3, 1)
        lib = time_ms(lambda: sdpa(qt, kt, vt), 5, 1)
        out["flash_attention"][case] = _dh120_entry(
            [1, s, h, kv, dh], w, errs["flash_attention"],
            paths["flash_attention"], ms, plain,
            cost.flash_fwd(q, k, v, causal=True, window=w), lib,
            "F.scaled_dot_product_attention (is_causal or the window's "
            "boolean mask; enable_gqa)")
        out["flash_attention"][case]["dtype"] = peak
        o, lse = fa.flash_attention(q, k, v, window=w, return_lse=True)
        ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                    window=w), reps)
        plain = time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do, window=w), 3, 1)
        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
        ref = sdpa(qg, kg, vg)
        dot = do.transpose(1, 2)
        lib = time_ms(lambda: torch.autograd.grad(ref, (qg, kg, vg), dot,
                                                  retain_graph=True), 10, 2)
        out["flash_attention_bwd"][case] = _dh120_entry(
            [1, s, h, kv, dh], w, errs["flash_attention_bwd"],
            paths["flash_attention_bwd"], ms, plain,
            cost.flash_bwd(q, k, v, causal=True, window=w), lib,
            "autograd of F.scaled_dot_product_attention (is_causal or the "
            "window's mask; enable_gqa), backward alone")
        out["flash_attention_bwd"][case]["dtype"] = peak
        del o, lse, qg, kg, vg, ref, qt, kt, vt, q, k, v, do
        torch.cuda.empty_cache()
    n_sm = pa._sm_count(device.index or 0)
    for q_len in (1, SPEC_K + 1):
        key = "paged_attention" if q_len == 1 else "paged_attention_verify"
        lengths = dh256_paged_lengths(q_len)
        live = 2 * sum(-(-n // PAGE) for n in lengths) * PAGE * kv * dh * 2
        n_sets = -(-4 * L2_BYTES // live)
        sets, tab, lens = paged_inputs(bf16, device, q_len, lengths, seed=65,
                                       n_copies=n_sets, heads=DH256_HEADS,
                                       cache_len=GEMMA_CACHE)
        it = {"i": 0}

        def run(fn):
            def call():
                qp, kp, vp = sets[it["i"] % n_sets]
                it["i"] += 1
                fn(qp, kp, vp, tab, lens)
            return call

        ms = device_ms(run(pa.paged_attention), 2 * n_sets, "paged_attention")
        plain = time_ms(run(pa.paged_attention_plain))
        kc = paged_cost(sets[0][0], sets[0][1], tab, lengths, -1)
        splits, per = pa.plan_splits(tab.shape[1], tab.shape[0], kv, n_sm)
        entry = _dh120_entry(
            [len(lengths), q_len, h, kv, dh], -1, errs[key], launches[key],
            ms, plain, kc, None, "none (no single PyTorch call)")
        entry.update(keys=lengths, ms_by=PAGED_MS_BY,
                     query_rows=q_len * h // kv, splits=splits,
                     pages_a_split=per, smem_dynamic_bytes={
                         dt: pa._bind().paged_attention_smem_bytes(
                             q_len, h // kv, dh, PAGE, esz)
                         for dt, esz in (("bfloat16", 2), ("float32", 4))})
        out[key] = {"decode" if q_len == 1 else "verify": entry}
        del sets
    lengths = dh256_paged_lengths(1)
    live = 2 * sum(-(-n // PAGE) for n in lengths) * PAGE * kv * dh
    n_sets = -(-4 * L2_BYTES // live)
    sets, tab, lens, _ = paged_int8_inputs(bf16, device, 1, lengths, 66,
                                           n_copies=n_sets, heads=DH256_HEADS,
                                           cache_len=GEMMA_CACHE)
    it = {"i": 0}

    def run8(fn):
        def call():
            qp, kq, vq, ks, vs = sets[it["i"] % n_sets]
            it["i"] += 1
            fn(qp, kq, vq, tab, lens, k_scale=ks, v_scale=vs)
        return call

    ms = device_ms(run8(pa.paged_attention), 2 * n_sets, "paged_attention")
    plain = time_ms(run8(pa.paged_attention_plain))
    kc = paged_cost(sets[0][0], sets[0][1], tab, lengths, -1,
                    k_scale=sets[0][3])
    entry = _dh120_entry(
        [len(lengths), 1, h, kv, dh], -1, errs["paged_attention_int8"][0],
        launches["paged_attention_int8"], ms, plain, kc, None,
        "none (no single PyTorch call)")
    entry.update(keys=lengths, ms_by=PAGED_MS_BY, pool_dtype="int8",
                 max_abs_err_vs_unquantized=errs["paged_attention_int8"][1])
    out["paged_attention_int8"] = {"decode": entry}
    del sets
    torch.cuda.empty_cache()
    log("[kernels] Dh 256 records: " + json.dumps(
        {name: {case: {f: e[f] for f in ("ms", "bound_ms", "plain_ms",
                                         "library_ms", "launches")}
                for case, e in cases.items()}
         for name, cases in out.items()}))
    return out


def gemma_cut(blocks):
    """gemma3-4b at full width, its layers ``blocks`` = (first, end)."""
    import dataclasses as dc
    from repro_torch import configs
    full = configs.get(GEMMA_ARCH).full_spec()
    lo, hi = blocks
    return dc.replace(full, name=f"{full.name}-l{lo}-{hi - 1}",
                      n_layers=hi - lo, blocks=full.blocks[lo:hi])


def serve_gemma(device):
    """25a: gemma3-4b's full_spec in bf16, ``serve_1f`` pp 2, R_SLOTS x
    ROWS rows, PREFILL-token prompts, cache GEMMA_CACHE, N_DECODE decodes,
    sessions built without ``prefill_len``: rings of the window at the
    stage positions that hold only windowed layers, full-length caches at
    the others (``default_cache_lens``).  The paged session pages those
    (every decode's attention there through the paged kernel at Dh 256;
    the rings' through the plain path, as JAX's), the dense one keeps
    them dense; a profiled decode step of the paged one.  Each one's
    served tokens are ``full_transformer``'s (the flash kernel at Dh 256,
    windowed and global) greedy tokens up to near-ties of GEMMA_TIE.
    (record, profile, launches by path)."""
    import torch
    from repro_torch import configs
    from repro_torch.core.schedule import default_cache_lens
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.engine import build_serving
    cfg = configs.get(GEMMA_ARCH)
    spec = cfg.full_spec()
    plan = cfg.PLAN.with_(pp=2, tp=1, decode_microbatches=R_SLOTS)
    kw = dict(cache_len=GEMMA_CACHE, global_batch=R_SLOTS * ROWS,
              compute_dtype=torch.bfloat16, device=device)
    t0 = time.perf_counter()
    paged = build_serving(spec, plan, page_size=PAGE, **kw).start(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    dense = build_serving(spec, plan, page_size=0, **kw).reset_state()
    dense.set_params(paged.params)
    lens = default_cache_lens(spec, plan.pp, GEMMA_CACHE)
    full_pos = tuple(i for i, n in enumerate(lens) if n == GEMMA_CACHE)
    if not (paged.cache_lens == dense.cache_lens == lens
            and set(lens) == {GEMMA_WINDOW, GEMMA_CACHE}
            and tuple(paged.paged_layers) == full_pos
            and dense.pages is None):
        raise AssertionError(f"25a: cache lengths {paged.cache_lens} / "
                             f"{dense.cache_lens}, paged positions "
                             f"{paged.paged_layers}; expected rings of "
                             f"{GEMMA_WINDOW} beside full-length {full_pos}")
    rng = np.random.default_rng(SEED + 25)
    prompts = rng.integers(0, spec.vocab, (R_SLOTS, ROWS, PREFILL)
                           ).astype(np.int32)
    rec, prof, launches = {"model": spec.name, "layers": spec.n_layers,
                           "parameters": spec.param_count(),
                           "weight_gb": tensor_bytes(paged.params) / 1e9,
                           "heads": [spec.n_heads, spec.n_kv, spec.d_head],
                           "pp": plan.pp, "slots": R_SLOTS, "rows": ROWS,
                           "prefill": PREFILL, "cache_len": GEMMA_CACHE,
                           "cache_lens": lens, "paged_positions": full_pos,
                           "init_s": init_s}, None, {}
    for name, sess in (("paged", paged), ("dense", dense)):
        reset_counts()
        t0 = time.perf_counter()
        nxt = sess.prefill({"tokens": prompts})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        toks, step_s = [nxt], []
        for _ in range(N_DECODE):
            t0 = time.perf_counter()
            nxt = sess.decode(nxt)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            toks.append(nxt)
        counts = read_counts()
        per_step = len(full_pos) * plan.pp * R_SLOTS if sess.pages else 0
        want = {"paged_attention": per_step * N_DECODE,
                "paged_attention_int8": 0, "flash_attention": 0,
                "flash_attention_bwd": 0, "wkv6": 0, "mamba_scan": 0}
        if counts != want or (per_step and pa.paged_attention.launches_by_q
                              != {1: per_step * N_DECODE}):
            raise AssertionError(f"25a {name} launches {counts}, expected "
                                 f"{want}")
        toks = torch.stack(toks).cpu().numpy()
        ms = 1e3 * float(np.median(step_s))
        if sess.pages:
            sess._alloc.check()
            prof = profile_decode_step(sess, nxt, ms,
                                       kernels=("paged_attention",))
            launches["gemma3_serve"] = {"paged_attention":
                                        counts["paged_attention"]}
        reset_counts()
        t0 = time.perf_counter()
        logits = reference_logits(sess, prompts, toks, n_last=toks.shape[0])
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        ref_counts = read_counts()
        if ref_counts["flash_attention"] != spec.n_layers or \
                sum(ref_counts.values()) != spec.n_layers:
            raise AssertionError(f"25a {name} reference launches {ref_counts}")
        launches[f"gemma3_{name}_full_transformer"] = {
            "flash_attention": ref_counts["flash_attention"]}
        if not torch.isfinite(logits).all():
            raise AssertionError(f"25a {name}: non-finite reference logits")
        served = torch.from_numpy(toks.T.astype(np.int64)).to(logits.device)
        gap = logits.amax(-1) - logits.gather(-1, served[..., None])[..., 0]
        agree = logits.argmax(-1) == served
        rec[name] = {"prefill_s": prefill_s, "decode_ms_per_step": ms,
                     "decode_ms_steps": [1e3 * x for x in step_s],
                     "decode_tokens_per_s": R_SLOTS * ROWS * 1e3 / ms,
                     "paged_launches": counts["paged_attention"],
                     "reference_flash_launches": ref_counts["flash_attention"],
                     "reference_s": ref_s, "reference_positions": gap.numel(),
                     "reference_agree": int(agree.sum()),
                     "reference_max_gap": gap.max().item(),
                     "cache_gb": tensor_bytes(sess.cache) / 1e9,
                     "pool_gb": (tensor_bytes(sess.pages) / 1e9
                                 if sess.pages else 0.0)}
        log(f"[gemma3] 25a {name}: {spec.n_layers} layers, "
            f"{spec.param_count() / 1e9:.2f} B parameters, cache lengths "
            f"{lens} (paged positions {full_pos if sess.pages else ()}); "
            f"prefill {prefill_s:.3f}s, decode {ms:.2f} ms/step, paged "
            f"launches {counts['paged_attention']}; full_transformer "
            f"{ref_s:.2f}s, greedy == served at {int(agree.sum())}/"
            f"{gap.numel()}, max gap {gap.max().item():.4f} (limit "
            f"{GEMMA_TIE})")
        if (gap > GEMMA_TIE).any():
            raise AssertionError(
                f"25a {name}: served tokens are not full_transformer's "
                f"greedy tokens at {int((gap > GEMMA_TIE).sum())} positions "
                f"(gap up to {gap.max().item():.4f} > {GEMMA_TIE})")
    top = [(k["name"][:50], round(k["ms"], 3), k["calls"])
           for k in prof["by_kernel"][:6]]
    log(f"[profile] gemma3 paged decode step: device {prof['device_ms']:.2f} "
        f"ms, idle {prof['idle_share']:.3f}, {prof['kernel_launches']} "
        f"launches; top (ms, calls) {top}")
    del paged, dense
    torch.cuda.empty_cache()
    return rec, prof, launches


def gemma_verify(device, spec, plan):
    """25c's verify tile: ``spec`` in fp32 on ``serve_spec_1f`` (spec_k
    SPEC_K, page PAGE) from the weights of a plain ``serve_1f`` session:
    rounds of self-drafts, then one of the plain stream's own tokens as
    drafts; every emitted token equals the plain session's greedy stream
    at its position, and every verify round runs the paged kernel at Q =
    SPEC_K + 1 alone."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.engine import build_serving
    rows = NEW_CONS_SLOTS * ROWS
    kw = dict(cache_len=NEW_CONS_CACHE, global_batch=rows,
              compute_dtype=torch.float32, page_size=PAGE,
              prefill_len=NEW_CONS_PREFILL, device=device)
    plain = build_serving(spec, plan, **kw).start(SEED)
    rng = np.random.default_rng(SEED + 26)
    prompts = rng.integers(0, spec.vocab, (NEW_CONS_SLOTS, ROWS,
                                           NEW_CONS_PREFILL)).astype(np.int32)
    nxt = plain.prefill({"tokens": prompts})
    stream = [nxt.cpu().numpy()]
    for _ in range(GEMMA_SPEC_DECODE + SPEC_K + 1):
        nxt = plain.decode(nxt)
        stream.append(nxt.cpu().numpy())
    stream = np.stack(stream, axis=1)                   # (rows, steps)
    spec_s = build_serving(spec, plan.with_(schedule="serve_spec_1f"),
                           spec_k=SPEC_K, **kw).reset_state()
    spec_s.set_params(plain.params)
    reset_counts()
    last = spec_s.prefill({"tokens": prompts}).cpu().numpy()
    if not (last == stream[:, 0]).all():
        raise AssertionError("25c verify: the speculative prefill differs")
    emitted, rounds, accepted = 1, 0, []
    while emitted <= GEMMA_SPEC_DECODE:
        drafts = (spec_s.draft(last) if rounds % 2 == 0 else
                  stream[:, emitted:emitted + SPEC_K])
        scores, acc = spec_s.verify(np.concatenate([last[:, None], drafts],
                                                   1))
        n = int(acc.min()) + 1
        if not (acc == acc[0]).all() or not (
                scores[:, :n] == stream[:, emitted:emitted + n]).all():
            raise AssertionError(f"25c verify round {rounds}: emitted tokens "
                                 "differ from the plain stream")
        last = scores[:, n - 1]
        emitted += n
        rounds += 1
        accepted.append(int(acc[0]))
    counts = read_counts()
    by_q = dict(pa.paged_attention.launches_by_q)
    want = spec.n_layers * NEW_CONS_SLOTS * rounds
    if by_q != {SPEC_K + 1: want} or counts["paged_attention"] != want:
        raise AssertionError(f"25c verify: launches {counts}, by query count "
                             f"{by_q}, expected {want} at Q {SPEC_K + 1}")
    log(f"[gemma3] 25c verify tile (Q {SPEC_K + 1}, fp32, {spec.n_layers} "
        f"layers): {rounds} rounds, accepted {accepted}, every emitted token "
        f"the plain stream's; paged launches {want} at Q {SPEC_K + 1}")
    del plain, spec_s
    torch.cuda.empty_cache()
    return {"rounds": rounds, "accepted": accepted, "launches_q5": want}


def phase_gemma(device):
    """Phase 25: 25a (:func:`serve_gemma`), 25b (:func:`train_cut` of
    GEMMA_TRAIN_LAYERS layers at phase 13's shape for GEMMA_TRAIN_ROUNDS
    rounds, 1f1b / stash pp 2, the config's Adam), 25c at the layers
    GEMMA_CONS_BLOCKS in fp32: the
    paged engine against the dense one and the same session on the CPU
    (:func:`consistency_new`), int8 paged KV on the card against the CPU
    (:func:`phase_consistency_quant`), the verify tile
    (:func:`gemma_verify`), and the executor against the oracle bit for
    bit.  (records, profiles, launches by path, seconds)."""
    import torch
    from repro_torch import configs
    from repro_torch.optim import SGDM
    out, profs, launches, seconds = {}, [], {}, {}
    t0 = time.perf_counter()
    out["serve"], prof, served = serve_gemma(device)
    profs.append({**prof, "phase": "decode"})
    launches.update(served)
    seconds["25a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["train"], prof = train_cut(device, GEMMA_ARCH, GEMMA_TRAIN_LAYERS, 2,
                                   "1f1b", "stash", FLASH_KERNELS,
                                   rounds=GEMMA_TRAIN_ROUNDS)
    profs.append(prof)
    launches["gemma3_train"] = out["train"]["launches"]
    seconds["25b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = configs.get(GEMMA_ARCH)
    spec = gemma_cut(GEMMA_CONS_BLOCKS)
    if sorted(b.window for b in spec.blocks) != [-1, GEMMA_WINDOW]:
        raise AssertionError(f"25c: layers {GEMMA_CONS_BLOCKS} are not one "
                             "windowed and one global layer")
    cons = consistency_new(device, GEMMA_ARCH, spec=spec)
    plan = cfg.PLAN.with_(pp=2, tp=1, decode_microbatches=NEW_CONS_SLOTS)
    cons["int8_kv"] = phase_consistency_quant(
        device, spec, plan.with_(pp=1), n_decode=4, weight_dtype="fp32",
        tag="gemma3-int8")
    launches["gemma3_int8_serve"] = {
        "paged_attention_int8": cons["int8_kv"]["int8_launches"]}
    cons["verify"] = gemma_verify(device, spec, plan)
    launches["gemma3_speculative_serve"] = {
        "paged_attention_verify": cons["verify"]["launches_q5"]}
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        tplan = cfg.PLAN.with_(tp=1, pp=2, microbatches=CONS_R,
                               schedule="1f1b", stash_mode="stash")
        reset_counts()
        with plain_versions_refused():
            out["exact"] = executor_equals_oracle(
                device, "1f1b/stash", spec, tplan, SGDM(lr=0.01),
                donate=True)
        counts = read_all_counts()
        want = train_launches(spec, 2 * CONS_ROUNDS, CONS_R)
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"25c {spec.name} launches {counts}, "
                                 f"expected {want} (executor + oracle)")
        out["exact"]["launches"] = counts
        launches["gemma3_train_exact"] = counts
    finally:
        torch.use_deterministic_algorithms(False)
    out["consistency"] = cons
    seconds["25c"] = time.perf_counter() - t0
    log(f"[phases] 25 seconds: {json.dumps(seconds)}")
    torch.cuda.empty_cache()
    return out, profs, launches, seconds


def gemma_launches(launches):
    """Phase 25's launches by kernel record and path, for the kernels line
    and the Dh 256 entries."""
    by = {k: {} for k in ("flash_attention", "flash_attention_bwd",
                          "paged_attention", "paged_attention_verify",
                          "paged_attention_int8")}
    for path, counts in launches.items():
        for k in by:
            if counts.get(k):
                by[k][path] = counts[k]
    return by


# --------------------------------------------------------------------------
# phase 26: the launch tools (cells, op counts, roofline, the dry run, the
# Prefetcher, serve --data)
# --------------------------------------------------------------------------

TOOLS_LAYERS = 2
TOOLS_DRY_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# 26b and 26a's CPU count run in a spawned process on the host's CPU
# beside phases 22-25 (the host has 8 cores): its torch threads and its
# deadline
TOOLS_CPU_THREADS = 6
TOOLS_CHILD_S = 900
# 26a: card = CPU in FLOPs and kernel calls, bytes within this share
TOOLS_BYTES_RTOL = 0.01
# 26c: rows of the Prefetcher-fed round (R 2 x 1 row x 4096)
TOOLS_PREFETCH_ROWS, TOOLS_PREFETCH_ROUNDS = 2, 2
# 26d: serve --data 2 against --data 1, bf16, gloo ranks sharing the card
TOOLS_SERVE = ["--arch", "qwen3-14b", "--layers", str(TOOLS_LAYERS),
               "--batch", "8", "--prefill", "64", "--tokens", "8",
               "--cache-len", "128", "--seed", str(SEED), "--device", "cuda"]


def tools_count_cell(device):
    """26a's cell: qwen3-14b's train_4k at full width, its first
    TOOLS_LAYERS layers, one row (R 1 x 4096), fp32, SGD with momentum
    (half Adam's host memory on the CPU side)."""
    import torch
    from repro_torch.launch.cell import build_cell
    from repro_torch.optim import SGDM
    return build_cell("qwen3-14b", "train_4k", layers=TOOLS_LAYERS,
                      global_batch=1, dtype=torch.float32,
                      optimizer=SGDM(lr=0.01), device=device, seed=SEED)


def count_record(op) -> dict:
    return {"flops": op.flops, "hbm_bytes": op.hbm_bytes,
            "kernel_flops": op.kernel_flops,
            "kernel_bytes": op.kernel_bytes,
            "kernel_calls": op.kernel_calls, "aten_ops": op.aten_ops,
            "flops_by_op": op.flops_by_op, "bytes_by_op": op.bytes_by_op}


def tools_child(results):
    """26b and 26a's CPU side in a spawned process that never touches the
    card: the dry run of qwen3-14b's three cells on ``meta``
    (``launch/dryrun.py::run_cell`` at 256 cards), then the op count of
    26a's cell on the CPU."""
    import tempfile
    import traceback
    try:
        import torch
        from repro_torch.launch import dryrun
        from repro_torch.launch.op_analysis import count
        torch.set_num_threads(1)
        out = {"dryrun": {}, "seconds": {}}
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dry_") as tmp:
            for shape in TOOLS_DRY_SHAPES:
                t0 = time.perf_counter()
                rec = dryrun.run_cell("qwen3-14b", shape, out_dir=tmp)
                out["dryrun"][shape] = {
                    k: rec[k] for k in (
                        "plan", "fits", "state_bytes_per_rank",
                        "data_replicas", "replica_batch", "flops",
                        "hbm_bytes", "coll_operand_bytes", "compute_s",
                        "memory_s", "collective_s", "dominant",
                        "model_flops", "useful_ratio", "roofline_fraction",
                        "kernel_calls", "cuts")}
                out["dryrun"][shape]["memory_model_gb"] = \
                    rec["memory_model"]["total_bytes"] / 1e9
                out["dryrun"][shape]["seconds"] = time.perf_counter() - t0
        torch.set_num_threads(TOOLS_CPU_THREADS)
        t0 = time.perf_counter()
        cell = tools_count_cell("cpu")
        out["seconds"]["26a cpu build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["cpu_count"] = count_record(count(cell.run))
        out["seconds"]["26a cpu count"] = time.perf_counter() - t0
        results.put(("ok", out))
    except BaseException:
        results.put(("error", traceback.format_exc()))
        raise


def start_tools_child():
    """:func:`tools_child` started in a spawned process: (process, its
    queue, its start time)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    child = ctx.Process(target=tools_child, args=(results,), daemon=True)
    child.start()
    return child, results, time.perf_counter()


def serve_replica(rank, world, init_file, argv, results):
    """A spawned data replica of 26d: ``launch/serve.py`` under a world of
    ``world`` gloo ranks sharing the card; rank 0's gathered tokens on
    the queue."""
    import traceback
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        from repro_torch.launch import serve
        toks = serve.main(argv + ["--data", str(world), "--backend", "gloo",
                                  "--init-method", f"file://{init_file}"])
        results.put((rank, None if toks is None else toks.tolist()))
    except BaseException:
        results.put((rank, {"error": traceback.format_exc()}))
        raise


def tools_prefetch(device):
    """26c: TOOLS_PREFETCH_ROUNDS fp32 rounds of a TOOLS_LAYERS-layer
    train_4k cell fed in line by its Loader, then from a fresh state fed
    by the Prefetcher (pinned host rounds copied on a side stream); under
    deterministic algorithms the losses and the states' digests must be
    equal bit for bit."""
    import torch
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.launch.cell import build_cell
    from repro_torch.launch.train import make_loader
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    runs = {}
    try:
        for how in ("inline", "prefetch"):
            cell = build_cell("qwen3-14b", "train_4k", layers=TOOLS_LAYERS,
                              global_batch=TOOLS_PREFETCH_ROWS,
                              dtype=torch.float32, device=device, seed=SEED)
            loader = make_loader(cell.spec, cell.bundle, SEED)
            feed = Prefetcher(loader) if how == "prefetch" else None
            state, losses, round_s = cell.args[0], [], []
            try:
                for r in range(TOOLS_PREFETCH_ROUNDS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    batch = next(feed) if feed else loader.get(r)
                    state, m = cell.bundle.train_step(state, batch)
                    losses.append(float(m["loss"]))
                    round_s.append(time.perf_counter() - t0)
            finally:
                if feed is not None:
                    feed.stop()
            runs[how] = {"losses": losses, "round_s": round_s,
                         "digests": state_digests(state)}
            del cell, state, batch, loader, feed
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = runs["inline"], runs["prefetch"]
    if a["losses"] != b["losses"] or a["digests"] != b["digests"]:
        bad = [k for k in a["digests"] if b["digests"].get(k)
               != a["digests"][k]]
        raise AssertionError(f"26c: Prefetcher-fed rounds differ from the "
                             f"in-line Loader's: losses {b['losses']} / "
                             f"{a['losses']}, leaves {bad[:6]}")
    return {"rounds": TOOLS_PREFETCH_ROUNDS, "rows": TOOLS_PREFETCH_ROWS,
            "layers": TOOLS_LAYERS, "dtype": "float32",
            "losses": a["losses"], "leaves_equal": len(a["digests"]),
            "round_s_inline": a["round_s"],
            "round_s_prefetch": b["round_s"]}


def tools_serve_data(device):
    """26d: ``serve --data 2`` on two spawned gloo ranks sharing the card
    against ``serve --data 1`` here: rank 0's gathered tokens must equal
    the one-process tokens."""
    import multiprocessing
    import shutil
    import tempfile
    import torch
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    one = serve.main(list(TOOLS_SERVE))
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    procs = [ctx.Process(target=serve_replica,
                         args=(r, 2, f"{tmp}/rendezvous", TOOLS_SERVE,
                               results)) for r in range(2)]
    t0 = time.perf_counter()
    got = {}
    try:
        for p in procs:
            p.start()
        while len(got) < 2:
            rank, res = results.get(timeout=DIST_JOIN_S)
            if isinstance(res, dict):
                raise AssertionError(f"26d rank {rank}:\n{res['error']}")
            got[rank] = res
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
    two_s = time.perf_counter() - t0
    two = np.asarray(got[0])
    if got[1] is not None or two.shape != one.shape or \
            not np.array_equal(two, one):
        raise AssertionError(f"26d: --data 2's tokens {got[0]} differ from "
                             f"--data 1's {one.tolist()}")
    return {"argv": TOOLS_SERVE, "replicas": 2, "backend": "gloo",
            "tokens_equal": int(one.size), "tokens_first_row":
                one[:, 0].tolist(), "data1_s": one_s, "data2_s": two_s}


def count_gaps(card, cpu, k=5):
    """The ops whose counted bytes differ most between the two counts."""
    keys = set(card["bytes_by_op"]) | set(cpu["bytes_by_op"])
    gaps = {op: card["bytes_by_op"].get(op, 0.0) - cpu["bytes_by_op"].get(
        op, 0.0) for op in keys}
    return sorted(((op, g) for op, g in gaps.items() if g),
                  key=lambda kv: -abs(kv[1]))[:k]


def phase_tools(device, child):
    """26a (the card's count against the child's CPU count), 26c, 26d, then
    the child's 26b and CPU count (see the module docstring)."""
    import torch
    from repro_torch.launch.op_analysis import count
    proc, results, t_child = child
    seconds, out = {}, {}
    try:
        t0 = time.perf_counter()
        cell = tools_count_cell(device)
        card = count_record(count(cell.run))
        del cell
        torch.cuda.empty_cache()
        seconds["26a card count"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["prefetch"] = tools_prefetch(device)
        seconds["26c prefetch"] = time.perf_counter() - t0
        log(f"[tools] 26c ({seconds['26c prefetch']:.1f}s): "
            f"{TOOLS_PREFETCH_ROUNDS} Prefetcher-fed fp32 rounds equal the "
            f"in-line rounds bit for bit: losses {out['prefetch']['losses']}"
            f", {out['prefetch']['leaves_equal']} leaves; round seconds "
            f"in line {out['prefetch']['round_s_inline']}, prefetched "
            f"{out['prefetch']['round_s_prefetch']}")
        t0 = time.perf_counter()
        out["serve_data"] = tools_serve_data(device)
        seconds["26d serve --data 2"] = time.perf_counter() - t0
        log(f"[tools] 26d ({seconds['26d serve --data 2']:.1f}s): serve "
            f"--data 2 on two gloo ranks equals --data 1, "
            f"{out['serve_data']['tokens_equal']} tokens")
        t0 = time.perf_counter()
        status, got = results.get(timeout=TOOLS_CHILD_S)
        proc.join(60)
        seconds["26 child wait"] = time.perf_counter() - t0
        seconds["26 child (spawned with 22)"] = time.perf_counter() - t_child
        if status != "ok":
            raise AssertionError(f"26b / 26a's CPU count failed:\n{got}")
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join(5)
    cpu = got["cpu_count"]
    gap = abs(card["hbm_bytes"] - cpu["hbm_bytes"]) / cpu["hbm_bytes"]
    out["op_count"] = {
        "cell": f"qwen3-14b train_4k, {TOOLS_LAYERS} layers, 1 x 4096, "
                "fp32, SGDM",
        **{f"{side}_{k}": rec[k] for side, rec in (("card", card),
                                                   ("cpu", cpu))
           for k in ("flops", "hbm_bytes", "kernel_flops", "kernel_bytes",
                     "kernel_calls", "aten_ops")},
        "flops_equal": card["flops"] == cpu["flops"],
        "kernel_calls_equal": card["kernel_calls"] == cpu["kernel_calls"],
        "bytes_rel_gap": gap, "byte_gaps_by_op": count_gaps(card, cpu),
        "seconds": {**got["seconds"], "26a card": seconds["26a card count"]}}
    out["dryrun"] = got["dryrun"]
    oc = out["op_count"]
    log(f"[tools] 26a: card {card['flops']:.6e} FLOPs / "
        f"{card['hbm_bytes']:.6e} B, CPU {cpu['flops']:.6e} / "
        f"{cpu['hbm_bytes']:.6e} B (gap {gap:.2e}; by op "
        f"{oc['byte_gaps_by_op']}); kernel calls {card['kernel_calls']} / "
        f"{cpu['kernel_calls']}")
    if not (oc["flops_equal"] and oc["kernel_calls_equal"]
            and gap <= TOOLS_BYTES_RTOL):
        raise AssertionError(f"26a: the card's count differs from the "
                             f"CPU's: {json.dumps(oc)}")
    for shape, rec in out["dryrun"].items():
        log(f"[tools] 26b dry run qwen3-14b x {shape} ({rec['seconds']:.1f}"
            f"s): {rec['plan']}, state {rec['state_bytes_per_rank'] / 1e9:.2f}"
            f" GB a rank, model {rec['memory_model_gb']:.2f} GB -> "
            f"{'fits' if rec['fits'] else 'OVER'}; compute "
            f"{1e3 * rec['compute_s']:.1f} ms, memory "
            f"{1e3 * rec['memory_s']:.1f} ms, collective "
            f"{1e3 * rec['collective_s']:.1f} ms ({rec['dominant']})")
    log(f"[phases] 26 seconds: {json.dumps(seconds)}")
    return out, seconds


class PhaseSeconds(dict):
    """Each phase's seconds, logged as it is recorded: a run cut short
    still shows where its time went."""

    def __setitem__(self, name, seconds):
        super().__setitem__(name, seconds)
        log(f"[phases] {name}: {seconds:.1f}s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch import configs
    t_start = time.perf_counter()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_s = PhaseSeconds()

    phase_build()
    phase_s["1 build"] = time.perf_counter() - t_start
    t0 = time.perf_counter()
    errs = phase_kernels(device)
    errs["wkv6"] = phase_wkv6_kernel(device)
    errs["mamba_scan"] = phase_mamba_kernel(device)
    errs["paged_attention_int8"] = phase_paged_int8_kernel(device)
    errs["flash_attention_bwd"] = phase_flash_bwd_kernel(device)
    errs["dh120"] = phase_dh120_kernels(device)
    errs["dh256"] = phase_dh256_kernels(device)
    errs["layouts"] = phase_layout_kernels(device)
    errs["wkv6_bwd"] = phase_wkv6_bwd_kernel(device)
    errs["mamba_scan_bwd"] = phase_mamba_bwd_kernel(device)
    phase_s["2 kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    cfg = configs.get("qwen3-14b")
    full = cfg.full_spec()
    plan = cfg.PLAN.with_(tp=1, decode_microbatches=R_SLOTS)
    qwen_full, qwen_plan = full, plan
    session, prompts, toks, paged_launches, prof_qwen, serve = phase_serve(
        device, full, plan)
    flash_launches = phase_reference(session, prompts, toks)
    qwen_toks = toks
    del session
    torch.cuda.empty_cache()

    short = dataclasses.replace(full, name="qwen3-14b-2l", n_layers=2,
                                blocks=full.blocks[:2])
    phase_consistency(device, short, plan)
    torch.cuda.empty_cache()
    phase_s["3-4 qwen3 serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    cfg = configs.get("rwkv6-1.6b")
    full = cfg.full_spec()
    plan = cfg.PLAN.with_(tp=1, decode_microbatches=RWKV_SLOTS)
    (session, prompts, toks, wkv_serve, wkv_serve_designs, prof,
     prof_rwkv_prefill, serve_rwkv) = phase_serve_rwkv(device, full, plan)
    wkv_ref, wkv_ref_designs = phase_reference_rwkv(session, prompts, toks)
    del session
    torch.cuda.empty_cache()

    short = dataclasses.replace(full, name="rwkv6-1.6b-2l", n_layers=2,
                                blocks=full.blocks[:2])
    phase_consistency_rwkv(device, short, plan.with_(pp=2))
    torch.cuda.empty_cache()
    phase_s["5-7 rwkv6 serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    cfg = configs.get("jamba-v0.1-52b")
    full = cfg.full_spec()
    cut = jamba_cut(full, full.blocks[:JAMBA_LAYERS],
                    f"jamba-v0.1-52b-{JAMBA_LAYERS}l")
    plan = cfg.PLAN.with_(pp=2, tp=1, decode_microbatches=JAMBA_SLOTS)
    (session, prompts, toks, jamba_counts, prof_jamba, prof_jamba_prefill,
     serve_jamba) = phase_serve_jamba(device, cut, plan)
    jamba_ref = phase_reference_jamba(session, prompts, toks)
    del session
    torch.cuda.empty_cache()

    phase_consistency_jamba(device, jamba_cut(full, full.blocks[3:5],
                                              "jamba-v0.1-52b-2l"),
                            plan.with_(pp=1))
    torch.cuda.empty_cache()
    phase_s["8-10 jamba serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    cfg = configs.get("qwen3-14b")
    full = cfg.full_spec()
    plan = cfg.PLAN.with_(tp=1, decode_microbatches=R_SLOTS)
    int8_launches, prof_quant, serve_quant = phase_serve_quant(
        device, full, plan, qwen_toks, serve)
    torch.cuda.empty_cache()
    short = dataclasses.replace(full, name="qwen3-14b-2l", n_layers=2,
                                blocks=full.blocks[:2])
    consistency_quant = phase_consistency_quant(device, short, plan)
    torch.cuda.empty_cache()
    phase_s["11-12 quantized serve"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    train_out, prof_train, train_fwd, train_bwd = phase_train(device)
    torch.cuda.empty_cache()
    virtual, prof_virtual, virtual_counts = {}, [], {}
    for name, mode in TRAIN_VIRTUAL:
        virtual[name], prof_v, virtual_counts[name] = phase_train_virtual(
            device, name, mode)
        prof_virtual.append(prof_v)
    phase_s["13 train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    consistency_train = phase_train_consistency(device)
    torch.cuda.empty_cache()
    phase_s["14 consistency train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan_out, plan_counts = phase_plan(device)
    phase_s["15 plan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    driver_out, driver_counts, driver_rows = phase_driver(device)
    phase_s["16 driver"] = time.perf_counter() - t0
    torch.cuda.empty_cache()          # the children of phase 17 need it
    t0 = time.perf_counter()
    dist_out, dist_s, dist_counts = phase_dist(
        device, train_out["loss_per_round"][0])
    phase_s["17 dist"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ckpt_recs, obs_rec, ckpt_s, ckpt_counts, restore = phase_ckpt_dist(
        device, driver_rows)
    phase_s["18 ckpt dist"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    from repro_torch.launch.train import cut_layers
    batch_rec, batch_counts, tile_err = phase_batching(
        device, cut_layers(qwen_full, BATCH_LAYERS), qwen_plan)
    phase_s["19 batching"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    planned_rec, planned_counts = phase_planned_serving(device)
    phase_s["20 planned serving"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt_recs.append(finish_restore_one(restore))
    phase_s["18b restore after 20"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp_out, tp_s, tp_counts = phase_tp(device,
                                       train_out["loss_per_round"][0])
    phase_s["21 tensor parallel"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # 26b and 26a's CPU count run on the host's CPU beside phases 22-25
    tools_child_proc = start_tools_child()
    t0 = time.perf_counter()
    recur_out, prof_recur, recur_launches, recur_s = phase_train_recurrent(
        device)
    phase_s["22 train recurrent"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # phase 24 runs while 23a's spawned process finishes
    front = {}

    def frontends():
        front["all"] = phase_frontends(device)
    new_out, prof_new, new_launches, new_s = phase_new_configs(
        device, alongside=frontends)
    front_out, prof_front, front_launches, front_s = front["all"]
    phase_s["23-24 new configs and frontends"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gemma_out, prof_gemma, gemma_paths, gemma_s = phase_gemma(device)
    phase_s["25 gemma3"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tools_out, tools_s = phase_tools(device, tools_child_proc)
    phase_s["26 launch tools"] = time.perf_counter() - t0
    by_gemma = gemma_launches(gemma_paths)
    for kernel, paths in by_gemma.items():
        if not sum(paths.values()):
            raise AssertionError(f"phase 25: {kernel} ran no time on "
                                 f"gemma3-4b's paths: {gemma_paths}")
    by_layout = new_config_launches({**new_launches, **front_launches})
    for name in ("whisper", "llava"):
        ran = {k: sum(by_layout[k][name].values()) for k in (
            "flash_attention", "flash_attention_bwd", "paged_attention")}
        if not all(ran.values()):
            raise AssertionError(f"phase 24 at layout {name}: a kernel ran "
                                 f"no time on its paths: {ran}")

    def new_paths(kernel):
        return {path: n for layout in by_layout[kernel].values()
                for path, n in layout.items()}

    def recur_paths(arch, kernel):
        return {k: c[kernel] for k, c in recur_launches.items()
                if k.startswith(arch)}

    records = kernel_records(device, errs, {
        "paged_attention": {"qwen3_serve": paged_launches,
                            "jamba_serve": jamba_counts["paged_attention"],
                            "qwen3_batching": batch_counts["decode_q1"],
                            "qwen3_planned_serve":
                                planned_counts["qwen3_planned_serve"],
                            "danube3_serve": planned_counts["danube3_serve"],
                            **new_paths("paged_attention"),
                            **by_gemma["paged_attention"]},
        "paged_attention_int8": {"qwen3_quant_serve": int8_launches,
                                 "danube3_int8_serve":
                                     planned_counts["danube3_int8_serve"],
                                 **by_gemma["paged_attention_int8"]},
        "flash_attention": {
            "qwen3_full_transformer": flash_launches,
            "jamba_full_transformer": jamba_ref["flash_attention"],
            "qwen3_train": train_fwd,
            **{f"qwen3_train_{n}": c["flash_attention"]
               for n, c in virtual_counts.items()},
            "qwen3_plan_profile": plan_counts["flash_attention"],
            "qwen3_batching_reference": batch_counts["reference_flash"],
            "qwen3_driver": driver_counts["flash_attention"],
            "qwen3_train_two_ranks": dist_counts["flash_attention"],
            "qwen3_driver_two_ranks": ckpt_counts["flash_attention"],
            "qwen3_planned_serve_reference":
                planned_counts["qwen3_planned_serve_reference"],
            "danube3_full_transformer":
                planned_counts["danube3_full_transformer"],
            **{k: c["flash_attention"] for k, c in tp_counts.items()},
            **new_paths("flash_attention"),
            **by_gemma["flash_attention"]},
        "flash_attention_bwd": {
            "qwen3_train": train_bwd,
            **{f"qwen3_train_{n}": c["flash_attention_bwd"]
               for n, c in virtual_counts.items()},
            "qwen3_driver": driver_counts["flash_attention_bwd"],
            "qwen3_train_two_ranks": dist_counts["flash_attention_bwd"],
            "qwen3_driver_two_ranks": ckpt_counts["flash_attention_bwd"],
            **{k: c["flash_attention_bwd"]
               for k, c in tp_counts.items()},
            **new_paths("flash_attention_bwd"),
            **by_gemma["flash_attention_bwd"]},
        "wkv6": {"serve": wkv_serve, "full_transformer": wkv_ref,
                 **recur_paths("rwkv6", "wkv6")},
        "wkv6_by_design": {
            design: {"serve": wkv_serve_designs[design],
                     "full_transformer": wkv_ref_designs[design]}
            for design in ("chunked", "stepwise")},
        "mamba_scan": {"serve": jamba_counts["mamba_scan"],
                       "full_transformer": jamba_ref["mamba_scan"],
                       **recur_paths("jamba", "mamba_scan")}})
    records += [wkv6_bwd_record(device, *errs["wkv6_bwd"],
                                recur_paths("rwkv6", "wkv6_bwd")),
                mamba_bwd_record(device, *errs["mamba_scan_bwd"],
                                 recur_paths("jamba", "mamba_scan_bwd"))]
    records.insert(2, verify_record(device, tile_err,
                                    batch_counts["verify_q5"]))
    dh120 = dh120_records(device, errs["dh120"], {
        "flash_attention": {"danube3_full_transformer":
                            planned_counts["danube3_full_transformer"]},
        "flash_attention_bwd": {},
        "paged_attention": {"danube3_serve":
                            planned_counts["danube3_serve"]},
        "paged_attention_int8": {"danube3_int8_serve":
                                 planned_counts["danube3_int8_serve"]}})
    layouts = layout_records(device, errs["layouts"], by_layout)
    dh256 = dh256_records(device, errs["dh256"], by_gemma)
    for rec in records:
        if rec["name"] in dh120:
            rec["dh120"] = dh120[rec["name"]]
        if rec["name"] in dh256:
            rec["dh256"] = dh256[rec["name"]]
        at = {name: layouts[name][rec["name"]] for name in LAYOUTS
              if rec["name"] in layouts[name]}
        if at:
            rec["layouts"] = at
    log(f"[phases] seconds: {json.dumps(phase_s)}")
    log(f"[done] {time.perf_counter() - t_start:.1f}s; serve qwen3 {serve}; "
        f"serve rwkv6 {serve_rwkv}; serve jamba {serve_jamba}; serve qwen3 "
        f"int8/int8 {serve_quant}; consistency int8/int8 "
        f"{consistency_quant}; consistency train {consistency_train}; "
        f"dist {json.dumps(dist_s)}; ckpt dist {json.dumps(ckpt_s)}; "
        f"tp {json.dumps(tp_s)}; train recurrent {json.dumps(recur_s)}; "
        f"new configs {json.dumps(new_s)}; frontends {json.dumps(front_s)}; "
        f"gemma3 {json.dumps(gemma_s)}; launch tools {json.dumps(tools_s)}")
    print(json.dumps({"profile": prof_qwen}))
    print(json.dumps({"profile": prof}))
    print(json.dumps({"profile": prof_rwkv_prefill}))
    print(json.dumps({"profile": prof_jamba}))
    print(json.dumps({"profile": prof_jamba_prefill}))
    print(json.dumps({"profile": prof_quant}))
    print(json.dumps({"profile": prof_train}))
    for prof_v in prof_virtual:
        print(json.dumps({"profile": prof_v}))
    for prof_r in prof_recur + prof_new + prof_front + prof_gemma:
        print(json.dumps({"profile": prof_r}))
    print(json.dumps({"train": train_out}))
    for name in virtual:
        print(json.dumps({"train": virtual[name]}))
    print(json.dumps({"plan": plan_out}))
    print(json.dumps({"driver": driver_out}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    for rec in dist_records(dist_out, card):
        print(json.dumps({"dist": rec}))
    for rec in ckpt_recs:
        print(json.dumps({"ckpt_dist": {**rec, "card": card}}))
    print(json.dumps({"obs": {**obs_rec, "card": card}}))
    print(json.dumps({"batcher": {**batch_rec, "card": card}}))
    print(json.dumps({"planned_serving": {**planned_rec, "card": card}}))
    for rec in tp_records(tp_out, card):
        print(json.dumps({"tp": rec}))
    for arch, *_ in RECUR_TRAIN:
        print(json.dumps({"train_recurrent": {**recur_out[arch],
                                              "card": card}}))
    print(json.dumps({"train_recurrent_exact": {**recur_out["22c"],
                                                "card": card}}))
    print(json.dumps({"ingest": {**new_out["ingest"], "card": card}}))
    for arch, rec in new_out["serve"].items():
        print(json.dumps({"serve_new": {**rec, "card": card}}))
    for arch, rec in new_out["train"].items():
        print(json.dumps({"train_new": {**rec, "card": card}}))
    print(json.dumps({"train_new_exact": {**new_out["exact"],
                                          "card": card}}))
    for arch, rec in front_out["serve"].items():
        print(json.dumps({"serve_front": {**rec, "card": card}}))
    for arch, rec in front_out["train"].items():
        print(json.dumps({"train_front": {**rec, "card": card}}))
    print(json.dumps({"front_consistency": {
        **front_out["consistency"], "exact": front_out["exact"],
        "card": card}}))
    print(json.dumps({"serve_gemma": {**gemma_out["serve"], "card": card}}))
    print(json.dumps({"train_gemma": {**gemma_out["train"], "card": card}}))
    print(json.dumps({"gemma_consistency": {
        **gemma_out["consistency"], "exact": gemma_out["exact"],
        "card": card}}))
    for key in ("op_count", "dryrun", "prefetch", "serve_data"):
        print(json.dumps({key: {**tools_out[key], "card": card}}))
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
