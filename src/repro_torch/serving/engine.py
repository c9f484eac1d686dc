"""Table-driven pipelined serving: prefill, admission, decode and
speculative verify as clients of the serving schedules (port of
``repro/serving/engine.py``).

The engine walks a schedule's forward and exit tables tick by tick
(``serve_1f``, ``serve_interleaved`` with v chunks per stage, or their
speculative ``serve_spec_*`` twins); no tick/stage index arithmetic
lives here.  Every stage runs on one device, stage after stage within a
tick.  The JAX engine hands hidden states downstream with a
``ppermute`` (wrapping from the last stage to stage 0 between a stage's
chunks at v > 1), so the stage after s at tick t reads what s sent at
tick t − 1; the sequential loop double-buffers that hand-off.  A cell
runs only when its slot is gated: bubbles (``F_MB < 0``), slots that are
not live in a decode or verify round and slots not admitted in an
admission round are skipped (JAX computes them and never writes the
result), so a decode step runs each live slot through each layer
exactly once.  Rows of skipped slots come back as unspecified tokens.

Continuous batching: every slot has its own cache position, liveness
and prompt length, mirrored on the host (``_pos``, ``_live``,
``_prompt_len``; no per-layer device sync).  ``reset_slots`` frees
slots (zeroed state rows, pages back to the pool),
``write_prefill_into_slots`` admits ragged prompts (right-padded to the
session's ``prefill_len``; ``lens`` says where each slot's prompt ends)
into free slots mid-stream, and ``compact_slots`` permutes slots so the
live ones fill a prefix: pages are renamed, no KV byte moves.  With
``buckets=True`` a round walks the smallest ``bucket_lattice`` variant
of the tables that covers its slots (``ServingSchedule.bucketed``).
The speculative sessions add ``draft`` (head-only self-drafts),
``verify`` (one round scores spec_k + 1 positions a slot through the
paged kernel at Q = spec_k + 1, keeps the accepted prefix and the bonus
token, and truncates the rejected suffix's pages) and
``rollback_slots``.

Per-slot state is stacked like the JAX engine's, ``(n_chunks, R, rows,
...)`` per leaf with storage row p = s·v + j holding model chunk
j·S + s (``storage_chunk_order``, the training layout; the parameters
are stored the same way): dense KV caches ``(..., L_i, KV, Dh)`` for
attention layers, where ``L_i`` is ``cache_len``, or on a session that
neither prefills a fixed width nor speculates, a windowed layer's ring
length ``min(window, cache_len)`` (``default_cache_lens``, the lengths
the serving memory model prices: a decode writes position t at slot
t mod L_i); RWKV6 recurrent state, time-mix ``(x_prev (...,
d), wkv (..., H, Dh, Dh) f32)`` and channel-mix ``x_prev (..., d)``; and
Mamba state ``(conv_tail (..., d_conv - 1, Ci), h (..., Ci, N) f32)``.
With paging, the full-length attention layers' KV moves into page
pools ``(n_chunks, pool_pages, rows, page, KV, Dh)`` per layer plus one
host-side :class:`PageAllocator` whose (R, max_pages) table indexes
every paged layer's pool; ring buffers and recurrent state stay dense,
as in JAX.  Quantized storage
(``build_serving(weight_dtype=, kv_dtype=)``, ``repro_torch.quant``):
int8 / fp8 matmul weights with per-output-channel scales, dequantized at
each matmul site; int8 page pools with per-(page, KV head) f32 scale
planes ``(n_chunks, pool_pages, rows, KV)``; or dense caches re-typed
to fp32 / bf16.  Each cell gets its slot's views (``[p, m]``), fixed at
``start``, and everything is written in place.  A prefill reads the
recurrent state the slot holds, as the JAX engine's does: ``start`` and
``reset_slots`` zero it.

The frontends (JAX ``engine.py:1326-1356``): a VLM's prompt is its
patch embeddings (``n_patches`` of them, ``batch["patches"]`` (R, rows,
n_patches, d)) followed by ``prefill_len − n_patches`` text tokens; an
encoder-decoder model's prefill runs the encoder on the admitted slots'
``batch["frames"]`` (R, rows, T_src, d_enc) and each slot keeps its
output in ``enc_out`` (R, rows, T_src, d), which every later round of
the slot cross-attends into (its K and V recomputed each round, as JAX
does), ``reset_slots`` zeroes and ``compact_slots`` permutes.
``prefill_specs`` names a prefill batch's keys and shapes.  Neither
admits ragged prompts, and neither speculates.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import quant, resolve_device
from repro_torch.core.reference import model_plan, to_storage_order
from repro_torch.core.schedule import (F_CHUNK, F_FROM_EMBEDS, F_MB,
                                       ServingSchedule, bucket_lattice,
                                       default_cache_lens,
                                       fit_serving_microbatches,
                                       make_serving_schedule, pick_bucket)
from repro_torch.models import lm_head
from repro_torch.models import spec as spec_lib
from repro_torch.models.init import generator, init_params, params_from_numpy
from repro_torch.models.nn import page_row
from repro_torch.models.stage import (StageStatics, encoder_fwd,
                                      init_stage_state, make_statics,
                                      stage_fwd, stage_params)
from repro_torch.parallel.plan import ParallelismPlan
from repro_torch.serving.allocator import CacheExhausted, PageAllocator

__all__ = ["CacheExhausted", "EngineSession", "build_serving", "host_array"]

#: one key of a prefill batch (JAX's ``jax.ShapeDtypeStruct``)
InputSpec = collections.namedtuple("InputSpec", "shape dtype")


@dataclasses.dataclass
class EngineSession:
    """One serving session over a registry serving schedule.

    ``start`` initializes parameters and zeroes the per-slot state
    (``reset_state``), ``load_params`` installs a numpy parameter tree in
    the JAX layout (``set_params`` one in the port's).  ``prefill`` runs
    the pipelined prompt pass over every slot and ``decode`` one
    pipelined decode step over the live slots; both return the next
    token of every row, (R · rows,) int32 on the device.  ``last_hidden``
    keeps the hidden state exiting the pipe at each row's scored
    positions, (R · rows, 1, d) (Q positions after ``verify``), for
    callers that check logits.  The slot operations, bucket selection
    and the draft–verify API are the JAX engine's, with its checks and
    messages.
    """

    spec: spec_lib.ModelSpec
    plan: ParallelismPlan
    sched: ServingSchedule
    statics: StageStatics
    device: torch.device
    compute_dtype: torch.dtype
    cache_len: int
    rows: int                      # rows per microbatch slot
    # the session's prompt width (0: a one-shot prefill takes any width
    # up to cache_len, or up to the shortest ring, and there is no
    # per-slot admission)
    prefill_len: int = 0
    # KV capacity of each stage-program position (build_serving's
    # default_cache_lens, or cache_len everywhere)
    cache_lens: Optional[List[int]] = None
    # stage-program positions whose KV lives in the page pools
    paged_layers: Tuple[int, ...] = ()
    paged: Optional[Dict[str, int]] = None
    # the bucket lattice (build_serving(buckets=True)), None = full R only
    buckets: Optional[Tuple[int, ...]] = None
    # ragged admission (per-slot prompt lengths): False for recurrent
    # models, whose prefill would absorb the padding tokens
    ragged_ok: bool = True
    weight_dtype: Optional[str] = None   # "int8" / "fp8": quantized weights
    kv_dtype: Optional[str] = None       # "int8": int8 pools; "fp32"/"bf16"
    params: Any = None
    # per-slot state, {'layer_i': {"kv" | "tmix" | "cmix" | "ssm": ...}}
    cache: Optional[Dict] = None
    # paged KV, {'layer_i': (k_pool, v_pool)}, int8: (k, v, k_scale, v_scale)
    pages: Optional[Dict] = None
    # each slot's encoder output (R, rows, T_src, d): encoder-decoder only
    enc_out: Optional[torch.Tensor] = None
    last_hidden: Optional[torch.Tensor] = None
    _stage_params: List[Dict] = dataclasses.field(default_factory=list)
    _views: List[List[Dict]] = dataclasses.field(default_factory=list)
    _pools: List[Dict] = dataclasses.field(default_factory=list)
    _alloc: Optional[PageAllocator] = None
    _pos: Any = None               # host cache position per slot
    _live: Any = None              # host liveness per slot (0 / 1)
    _prompt_len: Any = None        # prompt length per slot (rollback floor)
    _bucket_log: list = dataclasses.field(default_factory=list)
    _bucket_scheds: Dict[int, ServingSchedule] = dataclasses.field(
        default_factory=dict)
    # observability (repro_torch.obs.Observability or None = off): one
    # on_round per executed round, the allocator's page gauges after it,
    # and the slot ops' and CacheExhausted counters
    obs: Any = None

    @property
    def n_slots(self) -> int:
        return self.sched.n_microbatches

    @property
    def started(self) -> bool:
        return self._pos is not None

    @property
    def speculative(self) -> bool:
        return self.sched.is_speculative

    @property
    def prefix_len(self) -> int:
        """Positions a prompt's patch prefix takes (VLMs), else 0."""
        return self.spec.n_patches if self.spec.frontend == "vision" else 0

    @property
    def text_len(self) -> int:
        """Text tokens a prompt of the session's ``prefill_len`` holds."""
        return self.prefill_len - self.prefix_len

    @property
    def prefill_specs(self) -> Dict[str, InputSpec]:
        """A prefill batch's keys (JAX ``engine.py:1425-1434``): tokens
        (R, rows, text_len) int32; a VLM's ``patches`` (R, rows,
        n_patches, d) and an encoder-decoder model's ``frames`` (R,
        rows, T_src, d_enc) in the compute dtype.  None on a session
        built without ``prefill_len``."""
        if not self.prefill_len:
            return None
        out = {"tokens": InputSpec((self.n_slots, self.rows, self.text_len),
                                   torch.int32)}
        out.update({k: InputSpec(shape, self.compute_dtype)
                    for k, shape in self._frontend_shapes().items()})
        return out

    def _frontend_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """The frontends' keys of a prompt batch and their shapes."""
        lead = (self.n_slots, self.rows)
        out = {}
        if self.prefix_len:
            out["patches"] = lead + (self.prefix_len, self.spec.d_model)
        if self.spec.encoder is not None:
            e = self.spec.encoder
            out["frames"] = lead + (e.source_len, e.d_model)
        return out

    @property
    def cache_dtype(self) -> torch.dtype:
        """Dtype of the dense state: a "fp32" / "bf16" kv dtype re-types
        it wholesale; "int8" leaves the dense leftovers (recurrent state)
        in compute dtype, as JAX does."""
        return {"fp32": torch.float32, "bf16": torch.bfloat16}.get(
            self.kv_dtype, self.compute_dtype)

    def start(self, seed: int = 0) -> "EngineSession":
        """Initialize (or reset) parameters from ``seed``
        (``init_weights``) and zero the per-slot state
        (``reset_state``)."""
        return self.init_weights(seed).reset_state()

    def init_weights(self, seed: int = 0) -> "EngineSession":
        """Draw the parameters from ``seed`` at the compute dtype, put
        them in the schedule's storage chunk order, and quantize them
        leaf by leaf (``weight_dtype``), so the largest transient is one
        leaf's f32 copy."""
        gen = generator(self.device, seed)
        params = init_params(self.spec, model_plan(self.plan, self.sched),
                             gen, self.compute_dtype)
        return self.set_params(quant.quantize_params(
            to_storage_order(params, self.sched), self.weight_dtype))

    def reset_state(self) -> "EngineSession":
        """Zero the per-slot state (KV caches or pools, recurrent state),
        the positions and prompt lengths, and make every slot live (the
        one-shot flows); the parameters stay.  int8 pools start at zero
        with scale planes of 1, so an untouched page dequantizes to
        exact zeros."""
        R, n_chunks = self.n_slots, self.sched.n_chunks
        st = self.statics
        self.cache = init_stage_state(
            st, self.rows, self.cache_lens, self.cache_dtype, self.device,
            lead=(n_chunks, R), paged_layers=self.paged_layers)
        self._views = [[_slot_view(self.cache, p, m) for m in range(R)]
                       for p in range(n_chunks)]
        if self.paged is not None:
            kv8 = self.kv_dtype == "int8"
            shape = (n_chunks, self.paged["pool_pages"], self.rows,
                     self.paged["page_size"], st.attn.n_kv_local,
                     st.attn.d_head)

            def pools():
                dt = torch.int8 if kv8 else self.cache_dtype
                out = [torch.zeros(shape, dtype=dt, device=self.device)
                       for _ in range(2)]
                if kv8:
                    out += [torch.ones(shape[:3] + shape[4:5],
                                       dtype=torch.float32,
                                       device=self.device)
                            for _ in range(2)]
                return tuple(out)

            self.pages = {f"layer_{i}": pools() for i in self.paged_layers}
            self._pools = [{name: tuple(t[p] for t in pool)
                            for name, pool in self.pages.items()}
                           for p in range(n_chunks)]
            self._alloc = PageAllocator(self.paged["pool_pages"], R,
                                        self.paged["max_pages"],
                                        self.paged["page_size"])
        if self.spec.encoder is not None:
            e = self.spec.encoder
            self.enc_out = torch.zeros(
                (R, self.rows, e.source_len, e.d_model),
                dtype=self.compute_dtype, device=self.device)
        self._pos = np.zeros(R, np.int64)
        self._live = np.ones(R, np.int64)
        self._prompt_len = np.zeros(R, np.int64)
        self._bucket_log = []
        return self

    def load_params(self, params_host) -> "EngineSession":
        """Install a numpy parameter tree in the JAX package's layout
        (``jax.tree.map(np.asarray, params)``), already in this
        schedule's storage chunk order (as the JAX engine's
        ``load_params`` takes it): cast to the compute dtype (the f32
        leaves stay f32), then quantized when the session was built with
        ``weight_dtype``, as the JAX engine does."""
        if self._pos is None:
            raise RuntimeError("call start() before load_params()")
        return self.set_params(quant.quantize_params(
            params_from_numpy(params_host, self.device, self.compute_dtype),
            self.weight_dtype))

    def set_params(self, params) -> "EngineSession":
        """Install a tree already in the port's layout, storage order,
        dtypes and storage (quantized leaves as they are) and on this
        session's device, such as another session's ``params``."""
        self.params = params
        self._stage_params = [stage_params(params, p)
                              for p in range(self.sched.n_chunks)]
        return self

    # ---- prompts ---------------------------------------------------------

    def _prompt(self, batch):
        """(tokens (R, rows, W) on the device, lens (R,)) of a prompt
        batch: W text tokens, the session's ``text_len`` (any width up to
        ``cache_len`` on a session built without ``prefill_len``),
        ``batch["lens"]`` the per-slot prompt lengths (default the
        prompt's width: a VLM's patch prefix and its W tokens)."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        R, width = self.n_slots, tokens.shape[2] + self.prefix_len
        for key, want in self._frontend_shapes().items():
            got = tuple(batch[key].shape) if key in batch else None
            if got != want:
                raise ValueError(f"{self.spec.name}'s prompts need "
                                 f"batch[{key!r}] of shape {want}, got {got}")
        if self.prefill_len:
            if tuple(tokens.shape) != (R, self.rows, self.text_len):
                raise ValueError(
                    f"tokens {tuple(tokens.shape)} must be (R={R}, rows="
                    f"{self.rows}, prefill_len={self.prefill_len}"
                    + (f" - {self.prefix_len} patches" if self.prefix_len
                       else "") + ")")
        elif tokens.shape[:2] != (R, self.rows) or width > self.cache_len:
            raise ValueError(
                f"tokens {tuple(tokens.shape)} must be (R={R}, rows="
                f"{self.rows}, S <= cache_len={self.cache_len})")
        else:
            lens = self.cache_lens
            for i, blk in enumerate(self.statics.program):
                if blk.mixer == "attn" and width > lens[i]:
                    raise ValueError(
                        f"a prompt of width {width} does not fit layer_{i}'s "
                        f"ring cache of {lens[i]} positions (cache_len="
                        f"{self.cache_len}): build "
                        "the session with prefill_len= for full-length "
                        "caches, or send prompts of at most "
                        f"{lens[i]} tokens")
        lens = batch.get("lens") if isinstance(batch, dict) else None
        if lens is None:
            return tokens, np.full(R, width, np.int64)
        if not self.ragged_ok:
            raise ValueError(
                "ragged admission (per-slot prompt lengths) is not "
                "supported for models with recurrent (mamba/rwkv) "
                "state or a frontend (patches, an encoder): prefill would "
                "absorb the padding tokens; pad prompts to the session "
                "prefill_len instead")
        lens = np.asarray(lens).reshape(-1)
        if lens.shape[0] != R:
            raise ValueError(
                f"lens has {lens.shape[0]} entries for R={R} slots; "
                "pass exactly one prompt length per slot")
        if (lens < 1).any() or (lens > width).any():
            raise ValueError(
                f"lens entries must lie in [1, {width}] (the "
                f"session prompt width); got {lens.tolist()}")
        return tokens, lens.astype(np.int64)

    def prefill(self, batch) -> torch.Tensor:
        """Pipelined prefill of every slot; ``batch["tokens"]`` is (R,
        rows, W) ints, ``batch["lens"]`` optionally each slot's prompt
        length (right-padded prompts).  Every slot becomes live at
        ``pos = lens``; returns the first token of every row."""
        if self._pos is None:
            self.start()
        tokens, lens = self._prompt(batch)
        return self._admit(tokens, lens, np.ones(self.n_slots, bool),
                           self.n_slots, "prefill", batch)

    def write_prefill_into_slots(self, batch, slot_mask, bucket=None):
        """Masked prefill: admit new requests into the masked slots.

        Live slots' state is untouched (only the admitted slots' cells
        run), so admission needs no global flush.  Returns the first
        token of every row; only the admitted slots' rows are
        meaningful.  On a bucketed session the pass runs the smallest
        bucket covering both the live slots and the admitted ones (which
        must therefore sit in a bucket prefix: the batcher admits into
        the lowest free slots).
        """
        if not self.prefill_len:
            raise ValueError(
                "this session was built without a prefill step; pass "
                "prefill_len= (> 0) to build_serving to enable "
                "per-slot admission")
        if self._pos is None:
            self.start()
        mask = np.asarray(slot_mask).reshape(-1) > 0
        R = self.n_slots
        occupied = mask | (self._live > 0)
        n_min = (int(np.flatnonzero(occupied)[-1]) + 1 if occupied.any()
                 else 1)
        b = self._resolve_bucket(bucket, n_min=n_min)
        if b < R and occupied[b:].any():
            raise ValueError(
                f"admit bucket {b} excludes occupied slots "
                f"{(np.flatnonzero(occupied[b:]) + b).tolist()}; "
                "compact_slots or admit into lower slots first")
        tokens, lens = self._prompt(batch)
        return self._admit(tokens, lens, mask, b, "admit", batch)

    def _admit(self, tokens, lens, mask, b: int, kind: str, batch):
        """Prefill the masked slots from position 0 over bucket ``b``'s
        tables: pages for ``lens`` positions, a VLM's patches before the
        text, an encoder-decoder model's encoder run on the masked
        slots' frames into their ``enc_out``, the first token read at
        ``lens - 1``, and the slots live at ``pos = lens``."""
        if self._alloc is not None:
            for r in np.flatnonzero(mask):
                self._alloc.alloc_slot(int(r), int(lens[r]))
        embeds = lm_head.embed_tokens(self.params["embed"], tokens,
                                      self.compute_dtype)
        if self.prefix_len:
            embeds = torch.cat([torch.as_tensor(
                batch["patches"], device=self.device).to(embeds.dtype),
                embeds], dim=2)
        if self.enc_out is not None and mask.any():
            idx = torch.from_numpy(np.flatnonzero(mask)).to(self.device)
            frames = torch.as_tensor(batch["frames"], device=self.device)
            frames = frames.index_select(0, idx).to(self.compute_dtype)
            enc = encoder_fwd(self.params["encoder"], frames.flatten(0, 1),
                              self.spec)
            self.enc_out.index_copy_(0, idx, enc.view(frames.shape[:2]
                                                      + enc.shape[1:]))
        t0 = self._obs_t0()
        ex = self._round(embeds, np.zeros(self.n_slots, np.int64), mask, b)
        h = torch.stack([ex[m, :, int(lens[m]) - 1]
                         for m in range(self.n_slots)])
        nxt = self._sample(h.reshape(-1, 1, h.shape[-1]))
        self._obs_round(kind, b, t0, nxt)
        self._pos[mask] = lens[mask]
        self._live[mask] = 1
        self._prompt_len[mask] = lens[mask]
        if self.buckets is not None and kind == "admit":
            self._bucket_log.append(b)
        return nxt

    # ---- decode ----------------------------------------------------------

    def decode(self, tokens, bucket=None) -> torch.Tensor:
        """One pipelined decode step over the live slots; ``tokens`` is
        (R · rows,) ints.  On a bucketed session the step walks the
        smallest bucket covering the live slots (``bucket`` overrides);
        live slots must sit in its prefix (``compact_slots``).  Rows of
        slots that are not live come back unspecified."""
        if self._pos is None:
            raise ValueError(
                "decode() before start(): no session state — call "
                "start() (and prefill prompts) before decoding")
        R = self.n_slots
        b = self._resolve_bucket(bucket)
        if b < R and int(self._live[b:].sum()):
            raise ValueError(
                f"decode bucket {b} excludes live slots "
                f"{(np.flatnonzero(self._live[b:]) + b).tolist()}; "
                "compact_slots first")
        if self._alloc is not None:
            # allocate on page-boundary crossings: every blocker is found
            # before any allocator change, so a CacheExhausted leaves the
            # session retryable once the named slots are evicted
            cap = self.cache_len
            live_r = np.flatnonzero(self._live)
            over = [int(r) for r in live_r if self._pos[r] >= cap]
            if over:
                self._obs_exhausted("decode", "capacity")
                raise CacheExhausted(
                    f"slots {over} are at paged KV capacity "
                    f"(cache_len={cap} tokens); evict or raise cache_len",
                    slots=over)
            self._check_pool(live_r, 1, "decode",
                             "size pool_pages for the worst-case decode "
                             "length")
            for r in live_r:
                self._alloc.extend_slot(int(r), int(self._pos[r]) + 1)
        tokens = torch.as_tensor(tokens, device=self.device)
        embeds = lm_head.embed_tokens(
            self.params["embed"], tokens.reshape(R, self.rows, 1),
            self.compute_dtype)
        t0 = self._obs_t0()
        ex = self._round(embeds, self._pos, self._live > 0, b)
        nxt = self._sample(ex[:, :, -1:].reshape(R * self.rows, 1, -1))
        self._obs_round("decode", b, t0, nxt)
        self._pos += self._live
        if self.buckets is not None:
            self._bucket_log.append(b)
        return nxt

    def _check_pool(self, live_r, width: int, kind: str, hint: str) -> None:
        """Raise CacheExhausted(reason pool) when the free pages cannot
        cover every live slot's next ``width`` positions, before any
        allocator change."""
        free = self._alloc.free_pages
        dry = []
        for r in live_r:
            need = (self._alloc.pages_needed(int(self._pos[r]) + width)
                    - int(self._alloc.counts[r]))
            if need > free:
                dry.append(int(r))
            else:
                free -= need
        if dry:
            self._obs_exhausted(kind, "pool")
            what = ("" if kind == "decode" else
                    f" for a spec_k={self.sched.spec_k} verify round")
            raise CacheExhausted(
                f"page pool exhausted growing slots {dry}{what} "
                f"({self._alloc.free_pages} pages free); evict a slot "
                f"or {hint}", slots=dry)

    # ---- speculative draft–verify ----------------------------------------

    def _check_spec(self, op: str) -> None:
        if not self.speculative:
            raise ValueError(
                f"{op}() on a non-speculative session: build with "
                "plan.schedule='serve_spec_1f'/'serve_spec_interleaved'")
        if self._pos is None:
            raise ValueError(
                f"{op}() before start(): no session state — call "
                "start() (and prefill/admit prompts) first")

    def draft(self, tokens) -> np.ndarray:
        """spec_k greedy self-drafts a row, (R · rows,) -> (R · rows,
        spec_k) int32 numpy: head-only hops (embed, final norm, head; no
        pipeline pass).  Any draft source works: ``verify`` keeps the
        output exact whatever the drafts."""
        self._check_spec("draft")
        fn = self.params["final_norm"]
        t = torch.as_tensor(host_array(tokens), device=self.device)
        out = []
        for _ in range(self.sched.spec_k):
            h = lm_head.embed_tokens(self.params["embed"], t[:, None],
                                     self.compute_dtype)
            t = lm_head.sample_greedy(self.params["head"], fn["scale"], h,
                                      norm_kind=self.spec.norm,
                                      norm_bias=fn.get("bias"),
                                      vocab=self.spec.vocab)
            out.append(t)
        return torch.stack(out, dim=1).cpu().numpy()

    def verify(self, tokens, bucket=None):
        """One draft–verify round: score spec_k + 1 positions a slot.

        ``tokens``: (R · rows, spec_k + 1) ints, column 0 each row's
        current token (what ``decode`` would be fed), columns 1..k its
        drafts.  One round through the serve tables scores every
        position (the paged kernel at Q = spec_k + 1); each live slot
        advances by ``accepted + 1`` and the rejected suffix rolls back
        (its pages are released).  Returns ``(scores, accepted)`` as
        numpy: scores (R · rows, spec_k + 1), the tokens to emit a row
        being ``scores[row, :accepted[slot] + 1]``, and accepted (R,),
        the minimum over the slot's lanes.
        """
        self._check_spec("verify")
        K = int(self.sched.spec_k)
        Q = K + 1
        toks = host_array(tokens)
        if toks.ndim != 2 or toks.shape[1] != Q:
            raise ValueError(
                f"tokens must be (global_batch, spec_k+1) = "
                f"(..., {Q}); got {toks.shape}")
        R = self.n_slots
        cap = self.cache_len
        if Q > cap:
            raise ValueError(
                f"spec_k={K} exceeds the cache_len headroom: a verify "
                f"round writes spec_k+1={Q} positions but "
                f"cache_len={cap}")
        live_r = np.flatnonzero(self._live)
        over = [int(r) for r in live_r if self._pos[r] + Q > cap]
        if over:
            self._obs_exhausted("verify", "capacity")
            raise CacheExhausted(
                f"slots {over} lack verify headroom (pos + spec_k+1 "
                f"> cache_len={cap}); evict them or lower spec_k",
                slots=over)
        b = self._resolve_bucket(bucket)
        if b < R and int(self._live[b:].sum()):
            raise ValueError(
                f"verify bucket {b} excludes live slots "
                f"{(np.flatnonzero(self._live[b:]) + b).tolist()}; "
                "compact_slots first")
        if self._alloc is not None:
            self._check_pool(live_r, Q, "verify",
                             "size pool_pages for the worst case")
            for r in live_r:
                self._alloc.extend_slot(int(r), int(self._pos[r]) + Q)
        tok_d = torch.as_tensor(toks, device=self.device)
        embeds = lm_head.embed_tokens(
            self.params["embed"], tok_d.reshape(R, self.rows, Q),
            self.compute_dtype)
        t0 = self._obs_t0()
        ex = self._round(embeds, self._pos, self._live > 0, b)
        h = ex.reshape(R * self.rows, Q, -1)
        self.last_hidden = h
        fn = self.params["final_norm"]
        scores = lm_head.greedy_tokens(self.params["head"], fn["scale"], h,
                                       norm_kind=self.spec.norm,
                                       norm_bias=fn.get("bias"),
                                       vocab=self.spec.vocab)
        self._obs_round("verify", b, t0, scores)
        scores = scores.cpu().numpy()
        # draft i is accepted iff it equals the verifier's token after
        # the prefix ending before it and every earlier draft was
        match = (toks[:, 1:] == scores[:, :-1]).astype(np.int64)
        acc_rows = np.cumprod(match, axis=1).sum(axis=1)
        accepted = acc_rows.reshape(R, self.rows).min(axis=1)
        self._pos += (accepted + 1) * (self._live > 0)
        if self._alloc is not None:
            for r in live_r:
                self._alloc.truncate_slot(int(r), int(self._pos[r]))
        if self.buckets is not None:
            self._bucket_log.append(b)
        return scores, accepted

    def rollback_slots(self, slot_mask, new_pos) -> "EngineSession":
        """Roll the masked slots back to ``new_pos``: a position
        decrement (dense KV past it is hidden by the position mask and
        overwritten later) and, paged, the release of the truncated
        suffix's pages.  A rollback may not cross a slot's prompt
        length nor move forward."""
        if self._pos is None:
            raise ValueError(
                "rollback_slots() before start(): no session state")
        R = self.n_slots
        m = np.asarray(slot_mask).reshape(-1) > 0
        if m.shape[0] != R:
            raise ValueError(
                f"slot_mask has {m.shape[0]} entries for R={R} slots")
        npos = np.asarray(new_pos, np.int64).reshape(-1)
        if npos.shape[0] != R:
            raise ValueError(
                f"new_pos has {npos.shape[0]} entries for R={R} slots")
        below = [int(r) for r in np.flatnonzero(m)
                 if npos[r] < self._prompt_len[r]]
        if below:
            raise ValueError(
                f"new_pos rolls slots {below} below their prompt length "
                f"(new_pos={[int(npos[r]) for r in below]}, prompt_len="
                f"{[int(self._prompt_len[r]) for r in below]}): rollback "
                "may only drop generated positions, never the prompt")
        fwd = [int(r) for r in np.flatnonzero(m) if npos[r] > self._pos[r]]
        if fwd:
            raise ValueError(
                f"new_pos advances slots {fwd} (new_pos > pos); "
                "rollback_slots only moves positions backward")
        self._pos[m] = npos[m]
        if self._alloc is not None:
            for r in np.flatnonzero(m):
                self._alloc.truncate_slot(int(r), int(npos[r]))
        return self

    # ---- continuous-batching slot ops -------------------------------------

    def reset_slots(self, slot_mask) -> "EngineSession":
        """Free the masked slots: zero their state rows, pages back to
        the pool, position, liveness and prompt length to 0."""
        if self._pos is None:
            self.start()
        m = np.asarray(slot_mask).reshape(-1) > 0
        if self._alloc is not None:
            for r in np.flatnonzero(m):
                self._alloc.release_slot(int(r))
        self._pos[m] = 0
        self._live[m] = 0
        self._prompt_len[m] = 0
        if m.any():
            idx = torch.from_numpy(np.flatnonzero(m)).to(self.device)
            for leaf in _leaves(self.cache):
                leaf.index_fill_(1, idx, 0)
            if self.enc_out is not None:
                self.enc_out.index_fill_(0, idx, 0)
        if self.obs is not None:
            self.obs.counter("slot_resets_total").inc(int(m.sum()))
            if self._alloc is not None:
                self.obs.page_gauges(self._alloc)
        return self

    def compact_slots(self, perm) -> "EngineSession":
        """Permute the per-slot state: new slot i takes old slot perm[i]
        (dense state rows in place, so the cells' views stay valid; the
        host mirrors; the allocator's table rows).  Paged KV moves no
        byte: the pool is global, only the table rows reorder."""
        if self._pos is None:
            self.start()
        R = self.n_slots
        perm = np.asarray(perm, np.int64).reshape(-1)
        if sorted(perm.tolist()) != list(range(R)):
            raise ValueError(
                f"perm must be a permutation of range({R}), got "
                f"{perm.tolist()}")
        if (perm != np.arange(R)).any():
            idx = torch.from_numpy(perm).to(self.device)
            for leaf in _leaves(self.cache):
                leaf.copy_(leaf.index_select(1, idx))
            if self.enc_out is not None:
                self.enc_out.copy_(self.enc_out.index_select(0, idx))
        self._pos = self._pos[perm]
        self._live = self._live[perm]
        self._prompt_len = self._prompt_len[perm]
        if self.obs is not None:
            self.obs.counter("compactions_total").inc()
        if self._alloc is not None:
            self._alloc.permute_slots(perm)
        return self

    # ---- buckets and observability ----------------------------------------

    def _resolve_bucket(self, bucket, n_min=None) -> int:
        """The compacted variant to run: explicit, picked from the live
        count (or ``n_min``), or R on a session without buckets."""
        R = self.n_slots
        if self.buckets is None:
            if bucket not in (None, R):
                raise ValueError(
                    f"bucket={bucket} on a session built without "
                    "buckets=True — pass buckets=True to build_serving")
            return R
        if bucket is None:
            n = int(self._live.sum()) if n_min is None else int(n_min)
            return pick_bucket(n, self.buckets)
        if bucket not in self.buckets:
            raise ValueError(
                f"bucket {bucket} is not in the lattice {self.buckets}")
        return int(bucket)

    def _bucket_sched(self, b: int) -> ServingSchedule:
        """Bucket ``b``'s schedule, built (and proved) once."""
        if b == self.n_slots:
            return self.sched
        if b not in self._bucket_scheds:
            self._bucket_scheds[b] = self.sched.bucketed(b)
        return self._bucket_scheds[b]

    def _obs_t0(self):
        """A round's start stamp, taken only when obs is on."""
        return self.obs.clock() if self.obs is not None else None

    def _obs_round(self, kind: str, b: int, t0, out: torch.Tensor) -> None:
        """Report one executed round [t0, now) over bucket ``b``'s table
        once ``out`` is computed (the stamp covers the device's work,
        not the enqueue)."""
        if self.obs is None:
            return
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        self.obs.on_round(kind, self._bucket_sched(b), t0, self.obs.clock(),
                          bucket=b if self.buckets is not None else None)
        if self._alloc is not None:
            self.obs.page_gauges(self._alloc)

    def _obs_exhausted(self, kind: str, reason: str) -> None:
        """Count a CacheExhausted about to be raised from ``kind``."""
        if self.obs is not None:
            self.obs.counter("cache_exhausted_total").inc(kind=kind,
                                                          reason=reason)

    # ---- the table walk ---------------------------------------------------

    def _sample(self, h) -> torch.Tensor:
        self.last_hidden = h
        fn = self.params["final_norm"]
        return lm_head.sample_greedy(self.params["head"], fn["scale"], h,
                                     norm_kind=self.spec.norm,
                                     norm_bias=fn.get("bias"),
                                     vocab=self.spec.vocab)

    def _round(self, embeds, start, gate, b: int) -> torch.Tensor:
        """Walk bucket ``b``'s forward / exit tables over ``embeds`` (R,
        rows, qlen, d); slot m's queries sit at ``start[m]`` onwards, and
        only the cells of slots with ``gate[m]`` run.  Returns what
        exits the last chunk, (R, rows, qlen, d), zeros for the other
        slots."""
        R, S = self.n_slots, self.sched.n_stages
        v = self.sched.virtual_stages
        qlen = embeds.shape[2]
        sched = self._bucket_sched(b)
        tabs = sched.tables()
        rows_pr = {}
        if self._alloc is not None:
            rows_pr = {m: page_row(self._alloc.tables[m], self.rows,
                                   int(start[m]) + qlen, self.device)
                       for m in range(b) if gate[m]}
        exits: List[Optional[torch.Tensor]] = [None] * R
        recv: List[Optional[torch.Tensor]] = [None] * S
        for t in range(sched.n_ticks):
            sent: List[Optional[torch.Tensor]] = [None] * S
            for s in range(S):
                m = int(tabs.fwd[t, s, F_MB])
                if m < 0 or not gate[m]:
                    continue                       # bubble, or not gated
                p = s * v + int(tabs.fwd[t, s, F_CHUNK])
                x = (embeds[m] if tabs.fwd[t, s, F_FROM_EMBEDS]
                     else recv[(s - 1) % S])
                pos = int(start[m])
                positions = torch.arange(pos, pos + qlen, device=self.device
                                         ).expand(self.rows, qlen)
                paged = None
                if self.pages is not None:
                    paged = {"pools": self._pools[p], "row": rows_pr[m]}
                sent[s] = stage_fwd(
                    self._stage_params[p], x, self.statics,
                    positions=positions,
                    windows=self.params["layer_windows"][p],
                    thetas=self.params["layer_thetas"][p],
                    state=self._views[p][m], cache_pos=pos, paged=paged,
                    cross_x=None if self.enc_out is None
                    else self.enc_out[m])
            m_exit = int(tabs.exit_mb[t])
            if m_exit >= 0 and gate[m_exit]:
                exits[m_exit] = sent[S - 1]
            recv = sent
        zero = torch.zeros_like(embeds[0])
        return torch.stack([zero if e is None else e for e in exits])


def _slot_view(tree, p: int, m: int):
    """Storage row ``p``, slot ``m``'s views of the ``(n_chunks, R, ...)``
    state tree."""
    if isinstance(tree, dict):
        return {k: _slot_view(v, p, m) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_slot_view(v, p, m) for v in tree)
    return tree[p, m]


def host_array(x) -> np.ndarray:
    """``x`` as a host array (a tensor on any device, or array-like)."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def build_serving(spec: spec_lib.ModelSpec, plan: ParallelismPlan, *,
                  cache_len: int, global_batch: int,
                  compute_dtype=torch.bfloat16, page_size: int = 0,
                  prefill_len: int = 0, pool_pages: Optional[int] = None,
                  buckets: bool = False, spec_k: Optional[int] = None,
                  weight_dtype: Optional[str] = None,
                  kv_dtype: Optional[str] = None,
                  device=None, obs=None) -> EngineSession:
    """A serving session for the plan's serving schedule, all stages on
    ``device`` (default ``cuda``; raises without a card).

    ``global_batch`` rows split into R = fit(plan.decode_microbatches)
    microbatch slots.  The schedule comes from the registry
    (``make_serving_schedule``): ``serve_interleaved`` for a plan with
    ``virtual_stages > 1``, a speculative ``serve_spec_*`` schedule when
    the plan names one (draft depth ``spec_k``, default 4).
    ``prefill_len`` is the session's prompt width, as in the JAX engine:
    prompts right-pad to it (``lens`` gives each slot's length), the
    batcher reads it, and the statics see ``rows · max(prefill_len, 1)``
    tokens per microbatch call, which sets the MoE expert capacity.
    Without it a one-shot ``prefill`` takes any width up to
    ``cache_len`` and per-slot admission is off.

    Cache lengths, as the JAX engine allocates them and the serving
    memory model prices them: a session built without ``prefill_len``
    on a plain schedule keeps each windowed attention layer in a ring
    of ``default_cache_lens(spec, n_chunks, cache_len)`` positions (its
    one-shot prompts must fit the shortest ring, or ``prefill`` raises);
    a session with ``prefill_len``, or speculative, keeps every cache
    full-length.

    ``page_size > 0`` keeps the full-length attention layers' KV in a
    block-paged pool of ``pool_pages`` pages (default R · cache_len /
    page_size, the dense capacity; fewer trade worst-case capacity for
    memory, and the batcher queues admissions when the pool runs dry)
    and runs their decode and verify attention through the paged kernel.
    Ring buffers and recurrent state (RWKV6, Mamba) stay dense whatever
    ``page_size`` says; a session with no full-length attention layer
    has no pool.
    ``buckets=True`` runs each round over the smallest
    ``bucket_lattice(R)`` variant of the tables covering its slots.

    ``weight_dtype`` ("int8" / "fp8") stores the matmul weights
    quantized with per-output-channel scales; ``kv_dtype`` is the KV
    storage dtype: "fp32" / "bf16" re-type the dense state, "int8" keeps
    the page pools as int8 payloads with per-(page, KV head) f32 scale
    planes (it needs ``page_size > 0``).  The checks and messages are
    the JAX engine's.  ``obs`` (an :class:`~repro_torch.obs.
    Observability`) gets one ``on_round`` per executed round, the page
    gauges and the slot ops' counters.
    """
    dev = resolve_device(device)
    if weight_dtype is not None and weight_dtype not in quant.WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype={weight_dtype!r} not in "
                         f"{quant.WEIGHT_DTYPES}")
    if kv_dtype is not None and kv_dtype not in quant.KV_DTYPES:
        raise ValueError(f"kv_dtype={kv_dtype!r} not in {quant.KV_DTYPES}")
    if kv_dtype == "int8" and not page_size:
        raise ValueError(
            "kv_dtype='int8' requires the paged cache (page_size > 0): "
            "the per-page scale planes live alongside the page pools")
    if plan.tp != 1:
        raise ValueError(f"tp={plan.tp}: the port runs one device per "
                         "stage group (tp=1) in this slice")
    if spec.frontend == "vision" and prefill_len \
            and prefill_len <= spec.n_patches:
        raise ValueError(f"prefill_len={prefill_len} leaves no text after "
                         f"{spec.n_patches} patches")
    if page_size and cache_len % page_size:
        raise ValueError(f"cache_len={cache_len} must be a multiple of "
                         f"page_size={page_size}")
    if compute_dtype == torch.float32 and dev.type == "cuda":
        # fp32 parity with the JAX reference needs full-precision products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    R = fit_serving_microbatches(plan.decode_microbatches, global_batch, 1)
    sched = make_serving_schedule(plan, R, spec_k=spec_k)
    sched.validate()
    rows = global_batch // R
    statics = make_statics(spec, model_plan(plan, sched),
                           tokens_per_mb=rows * max(prefill_len, 1))
    recurrent = [i for i, blk in enumerate(statics.program)
                 if blk.mixer in ("mamba", "rwkv") or blk.ffn == "rwkv_cmix"]
    if sched.is_speculative:
        if recurrent or spec.encoder is not None \
                or spec.frontend == "vision":
            raise ValueError(
                "speculative decode needs a pure-attention decoder stack: "
                "rejected drafts roll back by a masked pos decrement, and "
                f"recurrent state cannot rewind (layers {recurrent}, "
                f"encoder={spec.encoder is not None}, "
                f"frontend={spec.frontend!r})")
        if sched.verify_qlen > cache_len:
            raise ValueError(
                f"spec_k={sched.spec_k} exceeds the cache_len headroom: a "
                f"verify round writes spec_k+1={sched.verify_qlen} "
                f"positions but cache_len={cache_len}")
    n_chunks = sched.n_chunks
    cache_lens = ([cache_len] * spec.layers_per_stage(n_chunks)
                  if prefill_len or sched.is_speculative
                  else default_cache_lens(spec, n_chunks, cache_len))
    paged_layers = tuple(
        i for i, (blk, ln) in enumerate(zip(statics.program, cache_lens))
        if page_size and blk.mixer == "attn" and ln >= cache_len)
    paged = None
    if paged_layers:
        max_pages = cache_len // page_size
        paged = {"page_size": page_size, "max_pages": max_pages,
                 "pool_pages": (R * max_pages if pool_pages is None
                                else int(pool_pages))}
    return EngineSession(
        spec=spec, plan=plan, sched=sched, statics=statics, device=dev,
        compute_dtype=compute_dtype, cache_len=cache_len, rows=rows,
        prefill_len=prefill_len, cache_lens=cache_lens,
        paged_layers=paged_layers, paged=paged,
        buckets=bucket_lattice(R) if buckets else None,
        ragged_ok=(not recurrent and spec.encoder is None
                   and spec.frontend != "vision"),
        weight_dtype=weight_dtype, kv_dtype=kv_dtype, obs=obs)
