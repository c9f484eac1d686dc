"""Table-driven pipelined serving: prefill and decode as clients of the
``serve_1f`` schedule (port of ``repro/serving/engine.py``).

The engine walks the schedule's forward and exit tables tick by tick;
no tick/stage index arithmetic lives here.  In this slice every stage
runs on one device, stage after stage within a tick.  The JAX engine
hands hidden states downstream with a ``ppermute``, so stage s + 1 at
tick t reads what stage s sent at tick t − 1; the sequential loop
double-buffers that hand-off.  Bubble cells (``F_MB < 0``) are skipped —
JAX computes garbage there and never writes it — so a decode step runs
each microbatch through each layer exactly once.

Per-slot state is stacked like the JAX engine's, ``(n_chunks, R, rows,
...)`` per leaf: dense KV caches ``(..., cache_len, KV, Dh)`` for
attention layers; RWKV6 recurrent state — time-mix ``(x_prev (..., d),
wkv (..., H, Dh, Dh) f32)`` and channel-mix ``x_prev (..., d)``; and
Mamba state ``(conv_tail (..., d_conv - 1, Ci), h (..., Ci, N) f32)``.
A hybrid model (jamba) holds both kinds, layer by layer.  With paging,
attention KV moves into page pools ``(n_chunks, pool_pages, rows, page,
KV, Dh)`` per layer plus one host-side :class:`PageAllocator` whose (R,
max_pages) table indexes every layer's pool; recurrent state stays
dense, as in JAX.  Quantized storage (``build_serving(weight_dtype=,
kv_dtype=)``, ``repro_torch.quant``): int8 / fp8 matmul weights with
per-output-channel scales, dequantized at each matmul site; int8 page
pools with per-(page, KV head) f32 scale planes ``(n_chunks,
pool_pages, rows, KV)``; or dense caches re-typed to fp32 / bf16.
Each cell gets its slot's views (``[s, m]``), fixed at ``start``, and
everything is written in place.  A prefill reads the
recurrent state the slot holds, as the JAX engine's does: only
``start`` zeroes it.  Cache positions live in the host mirror
``_pos``: no per-layer device sync.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import quant, resolve_device
from repro_torch.core.schedule import (F_FROM_EMBEDS, F_MB, ServingSchedule,
                                       fit_serving_microbatches,
                                       make_serving_schedule)
from repro_torch.models import lm_head
from repro_torch.models import spec as spec_lib
from repro_torch.models.init import init_params, params_from_numpy
from repro_torch.models.nn import page_row
from repro_torch.models.stage import (StageStatics, init_stage_state,
                                      make_statics, stage_fwd, stage_params)
from repro_torch.parallel.plan import ParallelismPlan
from repro_torch.serving.allocator import CacheExhausted, PageAllocator

__all__ = ["CacheExhausted", "EngineSession", "build_serving"]


@dataclasses.dataclass
class EngineSession:
    """One serving session over the ``serve_1f`` schedule.

    ``start`` initializes parameters and zeroes the per-slot state
    (``reset_state``), ``load_params`` installs a numpy parameter tree in
    the JAX layout (``set_params`` one in the port's), ``prefill`` runs
    the pipelined prompt pass and ``decode`` one pipelined decode step;
    both return the next token of every row, (R · rows,) int32 on the
    device.  ``last_hidden`` keeps the hidden state exiting the pipe at
    each row's last position, (R · rows, 1, d), for callers that check
    logits.
    """

    spec: spec_lib.ModelSpec
    plan: ParallelismPlan
    sched: ServingSchedule
    statics: StageStatics
    device: torch.device
    compute_dtype: torch.dtype
    cache_len: int
    rows: int                      # rows per microbatch slot
    paged: Optional[Dict[str, int]] = None
    weight_dtype: Optional[str] = None   # "int8" / "fp8": quantized weights
    kv_dtype: Optional[str] = None       # "int8": int8 pools; "fp32"/"bf16"
    params: Any = None
    # per-slot state, {'layer_i': {"kv" | "tmix" | "cmix" | "ssm": ...}}
    cache: Optional[Dict] = None
    # paged KV, {'layer_i': (k_pool, v_pool)}, int8: (k, v, k_scale, v_scale)
    pages: Optional[Dict] = None
    last_hidden: Optional[torch.Tensor] = None
    _stage_params: List[Dict] = dataclasses.field(default_factory=list)
    _views: List[List[Dict]] = dataclasses.field(default_factory=list)
    _pools: List[Dict] = dataclasses.field(default_factory=list)
    _alloc: Optional[PageAllocator] = None
    _pos: Any = None               # host cache position per slot
    # observability (repro_torch.obs.Observability or None = off): one
    # on_round per prefill / decode, the allocator's page gauges after it
    obs: Any = None

    @property
    def n_slots(self) -> int:
        return self.sched.n_microbatches

    @property
    def cache_dtype(self) -> torch.dtype:
        """Dtype of the dense state: a "fp32" / "bf16" kv dtype re-types
        it wholesale; "int8" leaves the dense leftovers (recurrent state)
        in compute dtype, as JAX does."""
        return {"fp32": torch.float32, "bf16": torch.bfloat16}.get(
            self.kv_dtype, self.compute_dtype)

    def start(self, seed: int = 0) -> "EngineSession":
        """Initialize (or reset) parameters from ``seed`` and zero the
        per-slot state (KV caches or pools, recurrent state).  Weights
        are drawn at the compute dtype and then quantized leaf by leaf
        (``weight_dtype``), so the largest transient is one leaf's f32
        copy; int8 pools start at zero with scale planes of 1, so an
        untouched page dequantizes to exact zeros."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.set_params(quant.quantize_params(
            init_params(self.spec, self.plan, gen, self.compute_dtype),
            self.weight_dtype))
        return self.reset_state()

    def reset_state(self) -> "EngineSession":
        """Zero the per-slot state (KV caches or pools, recurrent state)
        and the positions; the parameters stay."""
        R, S = self.n_slots, self.sched.n_stages
        st = self.statics
        paged_layers = [i for i, b in enumerate(st.program)
                        if b.mixer == "attn"] if self.paged else []
        self.cache = init_stage_state(
            st, self.rows, [self.cache_len] * len(st.program),
            self.cache_dtype, self.device, lead=(S, R),
            paged_layers=paged_layers)
        self._views = [[_slot_view(self.cache, s, m) for m in range(R)]
                       for s in range(S)]
        if self.paged is not None:
            kv8 = self.kv_dtype == "int8"
            shape = (S, self.paged["pool_pages"], self.rows,
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

            self.pages = {f"layer_{i}": pools() for i in paged_layers}
            self._pools = [{name: tuple(t[s] for t in pool)
                            for name, pool in self.pages.items()}
                           for s in range(S)]
            self._alloc = PageAllocator(self.paged["pool_pages"], R,
                                        self.paged["max_pages"],
                                        self.paged["page_size"])
        self._pos = np.zeros(R, np.int64)
        return self

    def load_params(self, params_host) -> "EngineSession":
        """Install a numpy parameter tree in the JAX package's layout
        (``jax.tree.map(np.asarray, params)``): cast to the compute dtype
        (the f32 leaves stay f32), then quantized when the session was
        built with ``weight_dtype``, as the JAX engine does."""
        if self._pos is None:
            raise RuntimeError("call start() before load_params()")
        return self.set_params(quant.quantize_params(
            params_from_numpy(params_host, self.device, self.compute_dtype),
            self.weight_dtype))

    def set_params(self, params) -> "EngineSession":
        """Install a tree already in the port's layout, dtypes and storage
        (quantized leaves as they are) and on this session's device, such
        as another session's ``params`` moved here."""
        self.params = params
        self._stage_params = [stage_params(params, s)
                              for s in range(self.sched.n_stages)]
        return self

    def prefill(self, batch) -> torch.Tensor:
        """Pipelined prefill; ``batch["tokens"]`` is (R, rows, S) ints."""
        if self._pos is None:
            self.start()
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        R, qlen = self.n_slots, tokens.shape[2]
        if tokens.shape[:2] != (R, self.rows) or qlen > self.cache_len:
            raise ValueError(
                f"tokens {tuple(tokens.shape)} must be (R={R}, rows="
                f"{self.rows}, S <= cache_len={self.cache_len})")
        if self._alloc is not None:
            for r in range(R):
                self._alloc.alloc_slot(r, qlen)
        self._pos[:] = 0
        embeds = lm_head.embed_tokens(self.params["embed"], tokens,
                                      self.compute_dtype)
        t0 = self._obs_t0()
        nxt = self._round(embeds)
        self._obs_round("prefill", t0, nxt)
        self._pos[:] = qlen
        return nxt

    def decode(self, tokens) -> torch.Tensor:
        """One pipelined decode step; ``tokens`` is (R · rows,) ints."""
        if self._pos is None:
            raise ValueError("decode() before start(): call start() and "
                             "prefill() first")
        if self._alloc is not None:
            # allocate on page-boundary crossing, after finding every slot
            # at capacity; the pool holds every slot's max_pages, so it
            # cannot run dry
            slots = range(self.n_slots)
            over = [r for r in slots if self._pos[r] >= self.cache_len]
            if over:
                raise CacheExhausted(
                    f"slots {over} are at paged KV capacity "
                    f"(cache_len={self.cache_len} tokens)", slots=over)
            for r in slots:
                self._alloc.extend_slot(r, int(self._pos[r]) + 1)
        tokens = torch.as_tensor(tokens, device=self.device)
        embeds = lm_head.embed_tokens(
            self.params["embed"], tokens.reshape(self.n_slots, self.rows, 1),
            self.compute_dtype)
        t0 = self._obs_t0()
        nxt = self._round(embeds)
        self._obs_round("decode", t0, nxt)
        self._pos += 1
        return nxt

    def _obs_t0(self):
        """A round's start stamp, taken only when obs is on."""
        return self.obs.clock() if self.obs is not None else None

    def _obs_round(self, kind: str, t0, out: torch.Tensor) -> None:
        """Report one executed round [t0, now) once ``out`` is computed
        (the stamp covers the device's work, not the enqueue)."""
        if self.obs is None:
            return
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        self.obs.on_round(kind, self.sched, t0, self.obs.clock())
        if self._alloc is not None:
            self.obs.page_gauges(self._alloc)

    def _round(self, embeds) -> torch.Tensor:
        """Walk the forward / exit tables over ``embeds`` (R, rows, qlen,
        d); return the greedy next token of every row."""
        R, S = self.n_slots, self.sched.n_stages
        qlen = embeds.shape[2]
        tabs = self.sched.tables()
        rows_pr = None
        if self._alloc is not None:
            rows_pr = [page_row(self._alloc.tables[m], self.rows,
                                int(self._pos[m]) + qlen, self.device)
                       for m in range(R)]
        exits: List[Optional[torch.Tensor]] = [None] * R
        recv: List[Optional[torch.Tensor]] = [None] * S
        for t in range(self.sched.n_ticks):
            sent: List[Optional[torch.Tensor]] = [None] * S
            for s in range(S):
                m = int(tabs.fwd[t, s, F_MB])
                if m < 0:
                    continue                       # bubble
                x = embeds[m] if tabs.fwd[t, s, F_FROM_EMBEDS] else recv[s - 1]
                pos = int(self._pos[m])
                positions = torch.arange(pos, pos + qlen, device=self.device
                                         ).expand(self.rows, qlen)
                paged = None
                if self.pages is not None:
                    paged = {"pools": self._pools[s], "row": rows_pr[m]}
                sent[s] = stage_fwd(
                    self._stage_params[s], x, self.statics,
                    positions=positions,
                    windows=self.params["layer_windows"][s],
                    thetas=self.params["layer_thetas"][s],
                    state=self._views[s][m], cache_pos=pos, paged=paged)
            m_exit = int(tabs.exit_mb[t])
            if m_exit >= 0:
                exits[m_exit] = sent[S - 1]
            recv = sent
        h = torch.stack(exits)[:, :, -1:].reshape(R * self.rows, 1, -1)
        self.last_hidden = h
        fn = self.params["final_norm"]
        return lm_head.sample_greedy(self.params["head"], fn["scale"], h,
                                     norm_kind=self.spec.norm,
                                     norm_bias=fn.get("bias"),
                                     vocab=self.spec.vocab)


def _slot_view(tree, s: int, m: int):
    """Stage ``s``, slot ``m``'s views of the ``(S, R, ...)`` state tree."""
    if isinstance(tree, dict):
        return {k: _slot_view(v, s, m) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_slot_view(v, s, m) for v in tree)
    return tree[s, m]


def build_serving(spec: spec_lib.ModelSpec, plan: ParallelismPlan, *,
                  cache_len: int, global_batch: int,
                  compute_dtype=torch.bfloat16, page_size: int = 0,
                  prefill_len: int = 0, weight_dtype: Optional[str] = None,
                  kv_dtype: Optional[str] = None,
                  device=None, obs=None) -> EngineSession:
    """A serving session for ``plan``'s ``serve_1f`` schedule, all stages
    on ``device`` (default ``cuda``; raises without a card).

    ``global_batch`` rows split into R = fit(plan.decode_microbatches)
    microbatch slots.  ``prefill_len`` is the prompt length the session
    is sized for, as in the JAX engine: the statics see
    ``rows · max(prefill_len, 1)`` tokens per microbatch call, which
    sets the MoE expert capacity (the same capacity, hence the same
    drops, as the JAX engine's).  ``page_size > 0`` keeps every
    attention layer's KV in a block-paged pool of R · cache_len /
    page_size pages (the dense capacity) and runs decode attention
    through the paged kernel.  Recurrent state (RWKV6, Mamba) stays
    dense whatever ``page_size`` says; a model without attention layers
    has nothing to page.

    ``weight_dtype`` ("int8" / "fp8") stores the attention, FFN, expert,
    embedding and head matmul weights quantized with per-output-channel
    scales, dequantized at each matmul site.  ``kv_dtype`` is the KV
    storage dtype: "fp32" / "bf16" re-type the dense state, "int8" keeps
    the page pools as int8 payloads with per-(page, KV head) f32 scale
    planes (it needs ``page_size > 0``), read by the paged kernel's int8
    page walk.  Both default to the unquantized behaviour; the checks
    and messages are the JAX engine's.  ``obs`` (an
    :class:`~repro_torch.obs.Observability`) gets one ``on_round`` per
    prefill and decode and the page gauges.
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
    if page_size and cache_len % page_size:
        raise ValueError(f"cache_len={cache_len} must be a multiple of "
                         f"page_size={page_size}")
    if compute_dtype == torch.float32 and dev.type == "cuda":
        # fp32 parity with the JAX reference needs full-precision products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    R = fit_serving_microbatches(plan.decode_microbatches, global_batch, 1)
    sched = make_serving_schedule(plan, R)
    sched.validate()
    rows = global_batch // R
    statics = make_statics(spec, plan,
                           tokens_per_mb=rows * max(prefill_len, 1))
    paged = None
    if page_size and statics.attn is not None:
        max_pages = cache_len // page_size
        paged = {"page_size": page_size, "max_pages": max_pages,
                 "pool_pages": R * max_pages}
    return EngineSession(spec=spec, plan=plan, sched=sched, statics=statics,
                         device=dev, compute_dtype=compute_dtype,
                         cache_len=cache_len, rows=rows, paged=paged,
                         weight_dtype=weight_dtype, kv_dtype=kv_dtype,
                         obs=obs)
