"""Continuous batching: an Orca-style slot scheduler over the serve
tables (port of ``repro/serving/batcher.py``).

The scheduler runs a request stream through one
:class:`~repro_torch.serving.engine.EngineSession` by scheduling its R
microbatch *slots* instead of whole batches:

  * a **slot** is one of the serve schedule's R slots, carrying
    ``lanes`` (the session's rows) sequence rows that share one cache
    position and liveness;
  * **requests** move waiting -> prefilling -> decoding -> finished:
    admission writes a waiting request's prompt into a free slot
    mid-stream (``EngineSession.write_prefill_into_slots``: only the
    admitted slots' cells run, so live slots keep decoding from the same
    state), and a slot whose requests finished (EOS or
    ``max_new_tokens``) is freed on the next scheduler step
    (``EngineSession.reset_slots``).

Prompts up to the session's ``prefill_len`` admit directly: shorter
prompts are right-padded, and a per-slot ``lens`` vector says where
each slot's prompt ends (its first token is read at ``lens - 1``).
Models with recurrent state or a frontend need exact-length prompts; a
frontend's request carries its ``inputs`` (a VLM's ``patches``, an
encoder-decoder model's ``frames``), which admission passes on for the
admitted lanes.  On a paged
session admission reserves ``ceil(len / page_size)`` pages a slot and
queues the request when the pool cannot cover them, retrying after the
next eviction; a decode or verify round the pool or the capacity cannot
cover raises :class:`CacheExhausted`, and the named slots' requests
finish truncated.  On a bucketed session the occupied slots are
compacted to a prefix after each eviction.

Policies: ``"continuous"`` admits into any free slot as soon as one and
a request are there; ``"synchronized"`` waits until every slot is free
(drain, then refill).  Time is counted in scheduler steps (one step: at
most one admission round and one decode or draft–verify round), which
keeps arrival traces deterministic; seconds come from ``clock``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.allocator import CacheExhausted, PageAllocator
from repro_torch.serving.engine import host_array as _host

__all__ = ["PageAllocator", "Request", "RequestQueue", "Slot",
           "BatchingReport", "ContinuousBatchingSession"]


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle record.

    ``arrival`` is the scheduler step at which the request becomes
    visible.  The scheduler fills the rest: generated ``tokens`` (the
    prefill's first token included), the admission / first-token /
    completion steps, and the ``clock`` stamps.
    """

    rid: int
    prompt: np.ndarray             # (<= prefill_len,) int32
    max_new_tokens: int
    arrival: int = 0               # scheduler step of arrival
    eos_id: Optional[int] = None   # per-request override of the session's
    # the frontend's inputs of this request: "patches" (n_patches, d),
    # "frames" (T_src, d_enc)
    inputs: Optional[Dict[str, np.ndarray]] = None

    state: str = "waiting"         # waiting|prefilling|decoding|finished
    # finished early because its slot ran out of KV room (CacheExhausted)
    truncated: bool = False
    tokens: List[int] = dataclasses.field(default_factory=list)
    step_admitted: Optional[int] = None
    step_first: Optional[int] = None
    step_done: Optional[int] = None
    t_arrival: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def finished(self) -> bool:
        return self.state == "finished"

    def _record(self, token: int, step: int, now: float,
                eos_id: Optional[int]) -> None:
        """Append one generated token; finish on EOS or max_new_tokens."""
        self.tokens.append(int(token))
        if self.t_first is None:
            self.t_first, self.step_first = now, step
        self.state = "decoding"
        eos = self.eos_id if self.eos_id is not None else eos_id
        if (eos is not None and int(token) == eos) \
                or len(self.tokens) >= self.max_new_tokens:
            self.state = "finished"
            self.t_done, self.step_done = now, step


class RequestQueue:
    """Arrival-gated FIFO of waiting requests."""

    def __init__(self, requests: Sequence[Request] = ()):
        self._pending = deque(sorted(requests,
                                     key=lambda r: (r.arrival, r.rid)))
        self._ready: deque = deque()

    def push(self, request: Request) -> None:
        """Add a request (arrival must be >= every queued arrival)."""
        if self._pending and request.arrival < self._pending[-1].arrival:
            raise ValueError(
                f"request {request.rid} arrives at step {request.arrival}, "
                f"before the queue tail "
                f"({self._pending[-1].arrival}); push in arrival order")
        self._pending.append(request)

    def absorb_arrivals(self, step: int, now: float) -> None:
        """Move every request with ``arrival <= step`` into the ready FIFO."""
        while self._pending and self._pending[0].arrival <= step:
            r = self._pending.popleft()
            r.t_arrival = now
            self._ready.append(r)

    def pop_ready(self) -> Optional[Request]:
        return self._ready.popleft() if self._ready else None

    def peek_ready(self) -> Optional[Request]:
        return self._ready[0] if self._ready else None

    def push_front(self, request: Request) -> None:
        """Return a popped request to the head (admission stall)."""
        self._ready.appendleft(request)

    @property
    def n_ready(self) -> int:
        return len(self._ready)

    def __len__(self) -> int:
        return len(self._pending) + len(self._ready)


@dataclasses.dataclass
class Slot:
    """One schedule slot: ``lanes`` request lanes sharing the slot's
    state rows, position and liveness."""

    index: int
    lanes: int
    requests: List[Optional[Request]] = dataclasses.field(
        default_factory=list)

    def __post_init__(self):
        if not self.requests:
            self.requests = [None] * self.lanes

    @property
    def free(self) -> bool:
        return all(r is None for r in self.requests)

    @property
    def drained(self) -> bool:
        """Occupied, and every request in it finished (evict next step)."""
        return (not self.free
                and all(r is None or r.finished for r in self.requests))

    def live_lanes(self):
        """(lane, request) pairs still decoding."""
        return [(i, r) for i, r in enumerate(self.requests)
                if r is not None and not r.finished]

    def clear(self) -> None:
        self.requests = [None] * self.lanes


@dataclasses.dataclass
class BatchingReport:
    """Outcome of one :meth:`ContinuousBatchingSession.run`."""

    requests: List[Request]
    policy: str
    steps: int
    decode_rounds: int
    admit_rounds: int
    wall_seconds: float
    # speculative decode accounting (zero on a plain session)
    spec_rounds: int = 0        # verify rounds run
    spec_lane_rounds: int = 0   # live (lane, round) pairs
    drafted_tokens: int = 0     # spec_k drafts a live lane-round
    accepted_drafts: int = 0    # drafts the verifier accepted
    accepted_tokens: int = 0    # tokens committed to requests
    # scheduler steps on which an admission waited on a dry page pool
    pool_stalls: int = 0

    @property
    def completed(self) -> List[Request]:
        return [r for r in self.requests if r.finished]

    @property
    def completed_tokens(self) -> int:
        return sum(len(r.tokens) for r in self.completed)

    @property
    def goodput_tokens_per_s(self) -> float:
        """Completed requests' tokens a second (unfinished requests'
        tokens do not count; rejected drafts never reach a request)."""
        return self.completed_tokens / max(self.wall_seconds, 1e-12)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of proposed drafts the verifier accepted."""
        return self.accepted_drafts / max(self.drafted_tokens, 1)

    @property
    def accepted_per_round(self) -> float:
        """Mean tokens committed a lane a verify round."""
        return self.accepted_tokens / max(self.spec_lane_rounds, 1)

    def per_token_latency_s(self) -> np.ndarray:
        """Per-request (completion − arrival) / tokens, seconds."""
        return np.asarray([(r.t_done - r.t_arrival) / len(r.tokens)
                           for r in self.completed])

    def summary(self) -> dict:
        lat = self.per_token_latency_s()
        ttft = np.asarray([r.t_first - r.t_arrival for r in self.completed])
        return {
            "policy": self.policy,
            "requests": len(self.requests),
            "completed": len(self.completed),
            "completed_tokens": self.completed_tokens,
            "steps": self.steps,
            "decode_rounds": self.decode_rounds,
            "admit_rounds": self.admit_rounds,
            "wall_seconds": self.wall_seconds,
            "goodput_tokens_per_s": self.goodput_tokens_per_s,
            "p50_per_token_latency_s":
                float(np.percentile(lat, 50)) if lat.size else None,
            "p99_per_token_latency_s":
                float(np.percentile(lat, 99)) if lat.size else None,
            "mean_ttft_s":
                float(ttft.mean()) if ttft.size else None,
        } | ({
            "spec_rounds": self.spec_rounds,
            "drafted_tokens": self.drafted_tokens,
            "accepted_drafts": self.accepted_drafts,
            "accepted_tokens": self.accepted_tokens,
            "acceptance_rate": self.acceptance_rate,
            "accepted_per_round": self.accepted_per_round,
        } if self.spec_rounds else {})


class ContinuousBatchingSession:
    """Drive an :class:`~repro_torch.serving.engine.EngineSession` as a
    request-stream server.

    ``session`` needs per-slot admission (built with ``prefill_len >
    0``); the scheduler reads its slot count (``sched.n_microbatches``),
    lanes (``rows``) and prompt width (``prefill_len``).  One
    :meth:`step`: evict the slots drained on the previous step (and, on
    a bucketed session, compact), admit ready requests into free slots,
    then one decode round (or draft–verify round on a speculative
    session) for every live lane.
    """

    def __init__(self, session, *, eos_id: Optional[int] = None,
                 policy: str = "continuous",
                 clock: Callable[[], float] = time.perf_counter,
                 draft_fn: Optional[Callable] = None, obs=None):
        if policy not in ("continuous", "synchronized"):
            raise ValueError(f"unknown policy {policy!r}")
        if not getattr(session, "prefill_len", 0):
            raise ValueError(
                "continuous batching needs the per-slot admission step; "
                "build the session with prefill_len= (> 0)")
        self.session = session
        self.eos_id = eos_id
        self.policy = policy
        self.clock = clock
        self.obs = obs if obs is not None else getattr(session, "obs", None)
        sched = session.sched
        self.spec_k = (int(sched.spec_k)
                       if getattr(sched, "is_speculative", False) else 0)
        if draft_fn is not None and not self.spec_k:
            raise ValueError(
                "draft_fn= passed but the session's schedule is not "
                "speculative; build with spec_k= (serve_spec_* schedule) "
                "or drop draft_fn")
        # default draft source: the engine's head-only self-draft
        self.draft_fn = (draft_fn if draft_fn is not None
                         else getattr(session, "draft", None))
        self.R = int(sched.n_microbatches)
        self.rows = int(session.rows)
        self.text_len = int(session.text_len)
        # positions before the text (a VLM's patches), and the prompt
        # batch's frontend keys with their (R, rows, ...) shapes
        self.prefix = int(getattr(session, "prefix_len", 0))
        self.inputs = {k: tuple(v.shape) for k, v in
                       (getattr(session, "prefill_specs", None) or {}).items()
                       if k != "tokens"}
        self.slots = [Slot(i, self.rows) for i in range(self.R)]
        self.queue = RequestQueue()
        self.steps = 0
        self.decode_rounds = 0
        self.admit_rounds = 0
        self.pool_stalls = 0
        self._all: List[Request] = []
        self._reset_spec_counters()

    def _reset_spec_counters(self) -> None:
        self.spec_rounds = 0
        self.spec_lane_rounds = 0
        self.drafted_tokens = 0
        self.accepted_drafts = 0
        self.accepted_tokens = 0
        # tokens each slot committed (speculative accounting)
        self.accepted_per_slot = np.zeros(self.R, np.int64)

    # ---- admission -------------------------------------------------------

    def _admissible_slots(self) -> List[Slot]:
        free = [s for s in self.slots if s.free]
        if self.policy == "synchronized" and len(free) != len(self.slots):
            return []               # drain, then refill
        return free

    def _admit(self) -> None:
        alloc = getattr(self.session, "_alloc", None)
        ragged_ok = getattr(self.session, "ragged_ok", True)
        slots: List[Slot] = []
        slot_lens = {}
        reserved = 0        # pool pages claimed by this admission round
        stalled = False
        for slot in self._admissible_slots():
            if stalled or not self.queue.n_ready:
                break
            for lane in range(slot.lanes):
                req = self.queue.peek_ready()
                if req is None:
                    break
                plen = len(req.prompt)
                if plen > self.text_len:
                    raise ValueError(
                        f"request {req.rid}: prompt length {plen} exceeds "
                        f"the session's prefill_len {self.text_len}; "
                        "truncate on the client or build the session with "
                        "a larger prefill_len")
                if plen < self.text_len and not ragged_ok:
                    raise ValueError(
                        f"request {req.rid}: prompt length {plen} != "
                        f"prefill_len {self.text_len}, and this model "
                        "carries recurrent (mamba/rwkv) state — ragged "
                        "admission would absorb the padding; pad on the "
                        "client or build per-length sessions")
                missing = [k for k in self.inputs
                           if req.inputs is None or k not in req.inputs]
                if missing:
                    raise ValueError(
                        f"request {req.rid}: the model's prompts need "
                        f"inputs {missing} beside the tokens")
                if slot.index in slot_lens and slot_lens[slot.index] != plen:
                    # lanes of a slot share one cache position; leave the
                    # mismatched request for the next free slot
                    break
                if alloc is not None and slot.index not in slot_lens:
                    need = alloc.pages_needed(self.prefix + plen)
                    if need > alloc.free_pages - reserved:
                        # page pool dry: the request waits for the next
                        # eviction to return pages
                        stalled = True
                        self.pool_stalls += 1
                        break
                    reserved += need
                self.queue.pop_ready()
                req.state = "prefilling"
                req.step_admitted = self.steps
                slot.requests[lane] = req
                slot_lens.setdefault(slot.index, plen)
            if not slot.free:
                slots.append(slot)
        if not slots:
            return
        # the admitted prompts land in their slots' rows of the (R, rows,
        # prefill_len) batch, right-padded; ``lens`` carries each slot's
        # prompt length
        tokens = np.zeros((self.R, self.rows, self.text_len), np.int32)
        mask = np.zeros((self.R,), np.int32)
        lens = np.full((self.R,), self.text_len, np.int32)
        for slot in slots:
            mask[slot.index] = 1
            lens[slot.index] = slot_lens[slot.index]
            for lane, req in enumerate(slot.requests):
                if req is not None:
                    tokens[slot.index, lane, :len(req.prompt)] = req.prompt
        batch = {"tokens": tokens}
        for key, shape in self.inputs.items():
            batch[key] = np.zeros(shape, np.float32)
            for slot in slots:
                for lane, req in enumerate(slot.requests):
                    if req is not None:
                        batch[key][slot.index, lane] = req.inputs[key]
        if any(slot_lens[s.index] != self.text_len for s in slots):
            batch["lens"] = lens
        first = self.session.write_prefill_into_slots(batch, mask)
        first = _host(first).reshape(self.R, self.rows)
        self.admit_rounds += 1
        now = self.clock()
        for slot in slots:
            for lane, req in enumerate(slot.requests):
                if req is not None:
                    req._record(first[slot.index, lane], self.steps, now,
                                self.eos_id)

    # ---- slot compaction (bucketed sessions) ------------------------------

    def _compact(self) -> None:
        """Move occupied slots to the front (stable order) so the live
        set forms a bucket prefix; only on a bucketed session."""
        if getattr(self.session, "buckets", None) is None:
            return
        occ = [s.index for s in self.slots if not s.free]
        perm = occ + [s.index for s in self.slots if s.free]
        if perm == list(range(self.R)):
            return
        self.session.compact_slots(perm)
        old = {s.index: s.requests for s in self.slots}
        for new_i, old_i in enumerate(perm):
            self.slots[new_i].requests = old[old_i]
        self.accepted_per_slot = self.accepted_per_slot[list(perm)].copy()

    def _evict_exhausted(self, slot_idx, now: float) -> None:
        """Backpressure for a :class:`CacheExhausted` round: the named
        slots' requests finish truncated (keeping their tokens), the
        slots reset (returning their pages) and the batch compacts."""
        mask = np.zeros((self.R,), np.int32)
        n_truncated = 0
        for i in slot_idx:
            slot = self.slots[int(i)]
            for r in slot.requests:
                if r is not None and not r.finished:
                    r.state = "finished"
                    r.truncated = True
                    r.t_done, r.step_done = now, self.steps
                    n_truncated += 1
            slot.clear()
            mask[int(i)] = 1
        self.session.reset_slots(mask)
        self._compact()
        if self.obs is not None:
            self.obs.counter("exhausted_evictions_total").inc(len(slot_idx))
            self.obs.counter("requests_truncated_total").inc(n_truncated)

    def _live_lanes(self):
        return [(s, lane, r) for s in self.slots
                for lane, r in s.live_lanes()]

    def _decode_round(self, live) -> None:
        tokens = np.zeros((self.R, self.rows), np.int32)
        for s, lane, r in live:
            tokens[s.index, lane] = r.tokens[-1]
        nxt = self.session.decode(tokens.reshape(-1))
        nxt = _host(nxt).reshape(self.R, self.rows)
        now = self.clock()
        for s, lane, r in live:
            r._record(nxt[s.index, lane], self.steps, now, self.eos_id)

    def _spec_round(self, live) -> None:
        """One draft–verify round: every live lane commits its slot's
        accepted prefix and the bonus token, stopping early where its
        request finishes."""
        K = self.spec_k
        last = np.zeros((self.R, self.rows), np.int32)
        for s, lane, r in live:
            last[s.index, lane] = r.tokens[-1]
        flat = last.reshape(-1)
        drafts = np.asarray(self.draft_fn(flat), np.int32)
        if drafts.shape != (flat.shape[0], K):
            raise ValueError(
                f"draft_fn returned shape {drafts.shape}, expected "
                f"({flat.shape[0]}, {K}) = (global_batch, spec_k)")
        toks = np.concatenate([flat[:, None], drafts], axis=1)
        scores, acc = self.session.verify(toks)
        scores = _host(scores).reshape(self.R, self.rows, K + 1)
        acc = _host(acc).reshape(-1)
        now = self.clock()
        self.spec_rounds += 1
        for s, lane, r in live:
            a = int(acc[s.index])
            self.spec_lane_rounds += 1
            self.drafted_tokens += K
            self.accepted_drafts += a
            for j in range(a + 1):
                r._record(scores[s.index, lane, j], self.steps, now,
                          self.eos_id)
                self.accepted_tokens += 1
                self.accepted_per_slot[s.index] += 1
                if r.finished:
                    break

    # ---- one scheduler step ----------------------------------------------

    def step(self) -> bool:
        """Run one scheduler step; returns True while work remains."""
        now = self.clock()
        # 1) evict the slots drained last step; compact on a bucketed
        #    session so live slots stay a prefix
        drained = [s for s in self.slots if s.drained]
        if drained:
            mask = np.zeros((self.R,), np.int32)
            for s in drained:
                mask[s.index] = 1
                s.clear()
            self.session.reset_slots(mask)
            self._compact()
        # 2) admission
        self.queue.absorb_arrivals(self.steps, now)
        if self.queue.n_ready:
            self._admit()
        # 3) one decode (or draft–verify) round for every live lane; a
        #    CacheExhausted round evicts the blocked slots (truncating
        #    their requests) and retries once
        live = self._live_lanes()
        if live:
            round_fn = self._spec_round if self.spec_k \
                else self._decode_round
            try:
                round_fn(live)
            except CacheExhausted as e:
                self._evict_exhausted(e.slots, self.clock())
                live = self._live_lanes()
                if live:
                    round_fn(live)
            if live:
                self.decode_rounds += 1
        self.steps += 1
        if self.obs is not None:
            self.obs.gauge("queue_depth").set(self.queue.n_ready)
            self.obs.gauge("slots_live").set(
                sum(1 for s in self.slots if not s.free))
        return bool(len(self.queue) or live
                    or any(not s.free for s in self.slots))

    # ---- main loop ---------------------------------------------------------

    def run(self, requests: Sequence[Request], *,
            max_steps: int = 100_000) -> BatchingReport:
        """Serve a trace of requests to completion (or ``max_steps``)."""
        self._all = list(requests)
        self.queue = RequestQueue(self._all)
        # a fresh trace: arrival gating and accounting restart from zero
        self.steps = 0
        self.decode_rounds = 0
        self.admit_rounds = 0
        self.pool_stalls = 0
        self._reset_spec_counters()
        if not self.session.started:
            self.session.start()
        # begin empty: every slot free until its first admission
        self.session.reset_slots(np.ones((self.R,), np.int32))
        for s in self.slots:
            s.clear()
        t0 = self.clock()
        while self.steps < max_steps:
            if not self.step():
                break
        report = BatchingReport(
            requests=self._all, policy=self.policy, steps=self.steps,
            decode_rounds=self.decode_rounds,
            admit_rounds=self.admit_rounds,
            wall_seconds=self.clock() - t0,
            spec_rounds=self.spec_rounds,
            spec_lane_rounds=self.spec_lane_rounds,
            drafted_tokens=self.drafted_tokens,
            accepted_drafts=self.accepted_drafts,
            accepted_tokens=self.accepted_tokens,
            pool_stalls=self.pool_stalls)
        if self.obs is not None:
            self._publish(report)
        return report

    def _publish(self, report: BatchingReport) -> None:
        """Fold a finished run into the registry: request and token
        totals, goodput, TTFT and per-token latency histograms, and the
        speculative acceptance counters."""
        c, g, h = self.obs.counter, self.obs.gauge, self.obs.histogram
        pol = self.policy
        c("requests_total").inc(len(report.requests), policy=pol)
        c("requests_completed_total").inc(len(report.completed), policy=pol)
        c("tokens_completed_total").inc(report.completed_tokens, policy=pol)
        g("goodput_tokens_per_s").set(report.goodput_tokens_per_s,
                                      policy=pol)
        for r in report.completed:
            h("ttft_seconds").observe(r.t_first - r.t_arrival, policy=pol)
            h("per_token_latency_seconds").observe(
                (r.t_done - r.t_arrival) / len(r.tokens), policy=pol)
        if report.spec_rounds:
            c("spec_rounds_total").inc(report.spec_rounds)
            c("spec_lane_rounds_total").inc(report.spec_lane_rounds)
            c("drafted_tokens_total").inc(report.drafted_tokens)
            c("accepted_drafts_total").inc(report.accepted_drafts)
            c("accepted_tokens_total").inc(report.accepted_tokens)
