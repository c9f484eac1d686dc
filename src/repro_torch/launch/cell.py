"""(architecture x input-shape) cell builder (port of
``repro/launch/cell.py``).

One cell is one benchmark or dry-run unit: the step function of one
(arch, shape), its inputs, and the state they start from, built on one
device.  JAX's cell lowers a jitted step over a production mesh; the
port runs one process with every stage on one device, as its pipeline
and engine do, so a cell is built at a plan's pp with tp cut to 1:

  train    ``core/pipeline.py::build_pipeline``, a round from the
           ``data/pipeline.py::Loader`` (the SyntheticLM stream and the
           frontends' stubs);
  prefill  ``EngineSession.prefill`` of a full-width prompt batch;
  admit    ``EngineSession.write_prefill_into_slots`` under a slot mask
           (``serve_op="admit"``): the lower half of the slots;
  decode   ``EngineSession.decode`` (``bucket=``: the compacted
           variant, with the slots above the bucket reset), after every
           slot took a prompt of DECODE_PROMPT tokens;
  long_decode  ``EngineSession.decode`` of a sequence-parallel session
           (``build_serving(sp=True)``, JAX ``cell.py:144``) from
           position 0: it has no prefill; ``data_replicas=`` builds one
           data rank's shard of its full-length caches (on ``meta``,
           for the dry run's count of a rank);
  verify   ``EngineSession.verify`` of spec_k drafts a row
           (``spec_k=``), after the same prompts.

The spec's widths and the shape's sequence length are never cut; depth
(``layers``), the global batch, the cache length and tp (to 1) are cut
only as one card requires, each cut kept in ``cell.cuts`` and printed
with the cell.
``smoke=True`` builds the config's smoke spec and smoke plan in fp32 at
``seq_len`` (a cut) for CPU tests.  ``device="meta"`` builds the cell
without allocating anything (the dry run's counts); a step that reads
data on the host cannot run there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core.pipeline import build_pipeline
from repro_torch.models.init import generator
from repro_torch.optim.optimizers import by_name
from repro_torch.parallel.plan import ParallelismPlan
from repro_torch.serving.engine import build_serving

#: the prompt every slot of a decode or verify cell takes first
DECODE_PROMPT = 16


@dataclasses.dataclass
class Cell:
    arch: str
    shape: configs.Shape          # the registry's shape
    kind: str                     # train | prefill | admit | decode |
                                  # verify | long_decode
    plan: ParallelismPlan         # as run: tp 1, R fitted
    spec: Any
    fn: Callable
    args: Tuple[Any, ...]
    bundle: Any                   # PipelineBundle or EngineSession
    device: torch.device
    dtype: torch.dtype
    global_batch: int             # rows of one step (a replica's)
    seq_len: int                  # positions a row (train, prefill)
    cache_len: int                # KV positions a slot (serving)
    cuts: Dict[str, Any]

    def run(self):
        """One step; its outputs."""
        return self.fn(*self.args)

    @property
    def microbatches(self) -> int:
        """R: a round's microbatches, or a session's slots."""
        if self.kind == "train":
            return self.plan.microbatches
        return self.bundle.n_slots

    def describe(self) -> str:
        cuts = ", ".join(f"{k} {a} -> {b}" for k, (a, b) in
                         self.cuts.items()) or "none"
        return (f"[{self.arch} x {self.shape.name}] {self.kind}: "
                f"pp={self.plan.pp} tp={self.plan.tp} R={self.microbatches} "
                f"batch={self.global_batch} seq={self.seq_len} "
                f"cache={self.cache_len} {self.dtype} on {self.device}; "
                f"cuts: {cuts}")


def _fit_microbatches(plan: ParallelismPlan, global_batch: int,
                      dp: int) -> ParallelismPlan:
    """Clamp R so global_batch divides dp·R (multi-pod halves per-replica
    batch; the 1F1B schedule is valid for any R >= 1, the training
    interleaved family additionally needs R divisible by the stage
    count — registry-driven, so new schedules state their own rule)."""
    from repro_torch.core.schedule import SCHEDULES
    cls = SCHEDULES.get(plan.schedule)
    needs_groups = (cls is not None and cls.takes_virtual_stages
                    and cls.needs_group_microbatches)

    def ok(r):
        if global_batch % (dp * r):
            return False
        return not needs_groups or r % plan.pp == 0
    r = min(plan.microbatches, max(global_batch // dp, 1))
    while r > 1 and not ok(r):
        r -= 1
    assert ok(r), (plan, global_batch, dp)
    return plan.with_(microbatches=r) if r != plan.microbatches else plan


def build_cell(arch: str, shape_name: str, *,
               plan: Optional[ParallelismPlan] = None,
               layers: Optional[int] = None,
               global_batch: Optional[int] = None,
               cache_len: Optional[int] = None, device="cuda",
               dtype: Optional[torch.dtype] = None, optimizer=None,
               serve_op: str = "auto", page_size: int = 0,
               bucket: Optional[int] = None, spec_k: Optional[int] = None,
               seed: int = 0, smoke: bool = False,
               seq_len: Optional[int] = None,
               data_replicas: Optional[int] = None) -> Cell:
    """Build one (arch x shape) cell on ``device`` (see the module
    docstring): ``plan`` (default the config's) at tp 1, ``layers`` of the
    spec's first layers, ``global_batch`` rows (default the shape's),
    ``cache_len`` (decode shapes; default the shape's sequence length),
    ``dtype`` (default bf16; fp32 with ``smoke``), the config's optimizer
    unless ``optimizer`` is given.  ``serve_op``, ``page_size``,
    ``bucket`` and ``spec_k`` as JAX's ``build_cell`` takes them.
    ``data_replicas``: a long_decode cell's data ranks, of which the cell
    is one rank's shard (``build_serving(sp_shards=)``, ``meta`` only)."""
    from repro_torch.launch.train import cut_layers, make_loader
    if serve_op not in ("auto", "admit"):
        raise ValueError(f"serve_op={serve_op!r}: 'auto' or 'admit'")
    shape = configs.SHAPES[shape_name]
    if bucket is not None and shape.kind not in ("decode", "long_decode"):
        raise ValueError("bucket= builds a decode variant")
    if spec_k is not None and shape.kind != "decode":
        raise ValueError("spec_k builds the speculative verify step, a "
                         "decode variant")
    if page_size and shape.kind == "train":
        raise ValueError("page_size pages the serving KV cache; training "
                         "shapes have none")
    if serve_op == "admit" and shape.kind != "prefill":
        raise ValueError("serve_op='admit' builds a prefill variant")
    ok, why = configs.supports(arch, shape_name)
    if not ok:
        raise ValueError(f"{arch} x {shape_name} skipped: {why}")
    cfg = configs.get(arch)
    cuts: Dict[str, Tuple[Any, Any]] = {}
    if smoke:
        spec, base = cfg.smoke_spec(), plan or cfg.SMOKE_PLAN
        dtype = dtype or torch.float32
    else:
        spec, base = cfg.full_spec(), plan or cfg.PLAN
        dtype = dtype or torch.bfloat16
    if layers is not None and layers != spec.n_layers:
        cuts["layers"] = (spec.n_layers, layers)
        spec = cut_layers(spec, layers)
    if base.tp != 1:
        cuts["tp"] = (base.tp, 1)
    base = base.with_(tp=1)
    seq = shape.seq_len
    if seq_len is not None and seq_len != seq:
        if not smoke:
            raise ValueError("the shape's sequence length is never cut "
                             "(seq_len= is for smoke cells)")
        cuts["seq_len"] = (seq, seq_len)
        seq = seq_len
    gb = shape.global_batch
    if global_batch is not None and global_batch != gb:
        cuts["global_batch"] = (gb, global_batch)
        gb = global_batch
    dev = resolve_device(device)
    common = dict(arch=arch, shape=shape, spec=spec, device=dev,
                  dtype=dtype, global_batch=gb, cuts=cuts)

    if shape.kind == "train":
        plan = _fit_microbatches(base, gb, 1)
        opt = optimizer or by_name(*cfg.OPTIMIZER)
        bundle = build_pipeline(spec, plan, seq_len=seq, global_batch=gb,
                                optimizer=opt, compute_dtype=dtype,
                                device=dev)
        state = bundle.init_state(generator(dev, seed))
        batch = make_loader(spec, bundle, seed).get(0)
        return _done(Cell(kind="train", plan=plan, fn=bundle.train_step,
                          args=(state, batch), bundle=bundle, seq_len=seq,
                          cache_len=0, **common))

    cache = seq
    if cache_len is not None and cache_len != cache:
        cuts["cache_len"] = (cache, cache_len)
        cache = cache_len
    plan = base
    if spec_k is not None:
        plan = plan.with_(schedule=("serve_spec_interleaved"
                                    if plan.virtual_stages > 1
                                    else "serve_spec_1f"))
    prefill = shape.kind == "prefill"
    sp = shape.kind == "long_decode"
    if data_replicas is not None and not sp:
        raise ValueError("data_replicas= shards a long_decode cell's caches")
    session = build_serving(
        spec, plan, cache_len=cache, global_batch=gb, compute_dtype=dtype,
        page_size=page_size, prefill_len=seq if prefill else 0,
        buckets=bucket is not None, spec_k=spec_k, device=dev, sp=sp,
        sp_shards=data_replicas)
    session.start(seed)
    common.update(plan=plan, bundle=session, cache_len=cache)
    if sp:
        # decode-only: from position 0, a token a row
        tokens = np.random.default_rng(seed).integers(
            0, spec.vocab, (gb,)).astype(np.int32)
        step = session.decode
        if bucket is not None:
            def step(tokens):
                return session.decode(tokens, bucket=bucket)
        return _done(Cell(kind="long_decode", fn=step, args=(tokens,),
                          seq_len=0, **common))
    if prefill:
        batch = _prompts(session, seed, None)
        if serve_op == "admit":
            mask = np.zeros(session.n_slots, np.int32)
            mask[:max(1, session.n_slots // 2)] = 1
            cell = Cell(kind="admit", fn=session.write_prefill_into_slots,
                        args=(batch, mask), seq_len=seq, **common)
        else:
            cell = Cell(kind="prefill", fn=session.prefill, args=(batch,),
                        seq_len=seq, **common)
        return _done(cell)

    # decode / verify: every slot takes a prompt of DECODE_PROMPT tokens
    width = min(DECODE_PROMPT, cache - 1)
    nxt = session.prefill(_prompts(session, seed, width))
    if spec_k is not None:
        rng = np.random.default_rng(seed + 1)
        last = nxt.cpu().numpy().astype(np.int32)
        drafts = rng.integers(0, spec.vocab, (last.shape[0], spec_k))
        toks = np.concatenate([last[:, None], drafts], 1).astype(np.int32)
        return _done(Cell(kind="verify", fn=session.verify, args=(toks,),
                          seq_len=width, **common))
    if bucket is not None:
        if bucket not in session.buckets:
            raise ValueError(f"bucket {bucket} not in the lattice "
                             f"{session.buckets} for R={session.n_slots}")
        mask = np.zeros(session.n_slots, np.int32)
        mask[bucket:] = 1
        session.reset_slots(mask)

        def step(tokens):
            return session.decode(tokens, bucket=bucket)
    else:
        step = session.decode
    return _done(Cell(kind="decode", fn=step, args=(nxt,), seq_len=width,
                      **common))


def _prompts(session, seed: int, width: Optional[int]):
    """A prompt batch of every key of the session's prefill specs
    (``launch/serve.py::prefill_batch``), ``width`` text tokens wide on
    a session without a prompt width."""
    from repro_torch.launch.serve import prefill_batch
    if width is None:
        return prefill_batch(session, seed)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, session.spec.vocab, (
        session.n_slots, session.rows, width)).astype(np.int32)}
    for key, shape in session._frontend_shapes().items():
        batch[key] = rng.standard_normal(shape).astype(np.float32) * 0.02
    return batch


def _done(cell: Cell) -> Cell:
    print(cell.describe(), flush=True)
    return cell


def input_specs(arch: str, shape_name: str, **kw):
    """``meta`` stand-ins for every input of the cell (the counterpart of
    JAX's ``ShapeDtypeStruct`` inputs): the state's tensors as built on
    ``meta``, each host array as a ``meta`` tensor of its shape and
    dtype."""
    cell = build_cell(arch, shape_name, device="meta", **kw)

    def meta(x):
        if isinstance(x, dict):
            return {k: meta(v) for k, v in x.items()}
        if isinstance(x, np.ndarray):
            return torch.empty(x.shape, dtype=torch.from_numpy(x[:0]).dtype,
                               device="meta")
        return x
    return tuple(meta(a) for a in cell.args)
