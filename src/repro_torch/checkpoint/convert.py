"""HF safetensors -> storage-chunk checkpoint converter, and its inverse
(port of ``repro/checkpoint/convert.py``).

  * A **mapping table** per config family (qwen3, olmoe) maps each HF
    tensor name to a path in the parameter tree plus a transform
    ("transpose", head-dim reshapes to the ``(d, h, dh)`` layouts, vocab
    padding, per-expert accumulation into the stacked ``(E, d,
    d_expert)`` MoE arrays).
  * :func:`convert` streams the safetensors shard(s) **tensor by
    tensor** through the port's own reader (``checkpoint/safetensors.
    py``; BF16 is widened exactly to f32): each tensor goes to its
    (chunk, position, dest) slot, and a chunk file is written the moment
    its last tensor arrives.
  * Chunk files are in **storage order**: ``chunk_<p>.npz`` holds model
    chunk ``(p % v) * pp + p // v`` (``ServingSchedule.
    storage_chunk_order``), so :func:`load_converted` only stacks.
  * tp is validated at convert time (heads, kv heads, ffn, experts); the
    files hold full-width tensors.
  * :func:`export_checkpoint` writes the converted chunks back as one
    HF-named safetensors file.

The directory format is the JAX package's ``repro-chunks-v1``, file for
file (``chunk_<row>.npz``, ``shared.npz``, ``CONVERT_MANIFEST.json``):
each package reads the other's.  Every failure raises
:class:`ConvertError` (a ``ValueError``) with the JAX package's message.

Shared experts (``MoESpec.n_shared``, deepseek) have no rule in either
package's tables: the port raises :class:`ConvertError` for such a spec
where the JAX converter would hand the engine a tree without
``moe.shared``.

  python -m repro_torch.checkpoint.convert --src hf_dir --dest ck \\
      --config olmoe_1b_7b --pp 2 --virtual-stages 2
  python -m repro_torch.checkpoint.convert --src ck \\
      --dest back.safetensors --config olmoe_1b_7b --export
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import safetensors as st
from repro_torch.models import spec as spec_lib
from repro_torch.models.init import padded_vocab

MANIFEST_NAME = "CONVERT_MANIFEST.json"
INDEX_NAME = "model.safetensors.index.json"


class ConvertError(ValueError):
    """Typed conversion failure: unknown key, shape mismatch, tp that does
    not divide an axis, or a missing safetensors shard."""


# --------------------------------------------------------------------------
# Storage layout
# --------------------------------------------------------------------------

def storage_order(pp: int, v: int) -> List[int]:
    """Model chunk held by each storage row p = s·v + j (chunk j·pp + s):
    ``storage_chunk_order`` as plain arithmetic."""
    return [(p % v) * pp + p // v for p in range(pp * v)]


# --------------------------------------------------------------------------
# Mapping tables
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Rule:
    """One HF-name pattern -> tree destination.

    ``pattern`` may bind named groups ``layer`` and ``expert``;
    ``transform`` is one of the names :func:`_apply_transform` knows;
    ``tp_axis`` names the axis tensor parallelism splits; ``shared=True``
    leaves live outside the pipeline (embed / head / final norm)."""

    pattern: str
    dest: Tuple[str, ...]
    transform: str
    tp_axis: Optional[str] = None
    shared: bool = False

    def regex(self) -> "re.Pattern[str]":
        return re.compile(self.pattern + r"\Z")


_L = r"model\.layers\.(?P<layer>\d+)\."

_ATTN_RULES = (
    Rule(_L + r"input_layernorm\.weight", ("norm1", "scale"), "copy"),
    Rule(_L + r"self_attn\.q_proj\.weight", ("attn", "wq"), "qheads",
         "heads"),
    Rule(_L + r"self_attn\.k_proj\.weight", ("attn", "wk"), "kvheads",
         "kv_heads"),
    Rule(_L + r"self_attn\.v_proj\.weight", ("attn", "wv"), "kvheads",
         "kv_heads"),
    Rule(_L + r"self_attn\.o_proj\.weight", ("attn", "wo"), "transpose",
         "heads"),
    Rule(_L + r"self_attn\.q_norm\.weight", ("attn", "q_norm"), "copy"),
    Rule(_L + r"self_attn\.k_norm\.weight", ("attn", "k_norm"), "copy"),
    Rule(_L + r"post_attention_layernorm\.weight", ("norm2", "scale"),
         "copy"),
)

_SHARED_RULES = (
    Rule(r"model\.embed_tokens\.weight", ("embed",), "embed_pad",
         shared=True),
    Rule(r"model\.norm\.weight", ("final_norm", "scale"), "copy",
         shared=True),
    Rule(r"lm_head\.weight", ("head",), "head_pad", shared=True),
)

MAPPINGS: Dict[str, Tuple[Rule, ...]] = {
    "qwen3": _SHARED_RULES + _ATTN_RULES + (
        Rule(_L + r"mlp\.gate_proj\.weight", ("mlp", "w1"), "transpose",
             "ffn"),
        Rule(_L + r"mlp\.up_proj\.weight", ("mlp", "w3"), "transpose",
             "ffn"),
        Rule(_L + r"mlp\.down_proj\.weight", ("mlp", "w2"), "transpose",
             "ffn"),
    ),
    "olmoe": _SHARED_RULES + _ATTN_RULES + (
        Rule(_L + r"mlp\.gate\.weight", ("moe", "router"), "transpose"),
        Rule(_L + r"mlp\.experts\.(?P<expert>\d+)\.gate_proj\.weight",
             ("moe", "w1"), "transpose", "experts"),
        Rule(_L + r"mlp\.experts\.(?P<expert>\d+)\.up_proj\.weight",
             ("moe", "w3"), "transpose", "experts"),
        Rule(_L + r"mlp\.experts\.(?P<expert>\d+)\.down_proj\.weight",
             ("moe", "w2"), "transpose", "experts"),
    ),
}


def family_for(spec: spec_lib.ModelSpec) -> str:
    return "olmoe" if spec.moe is not None else "qwen3"


def _refuse_shared_experts(spec: spec_lib.ModelSpec, family: str) -> None:
    if spec.moe is not None and spec.moe.n_shared:
        raise ConvertError(
            f"{spec.name!r} has {spec.moe.n_shared} shared expert(s) "
            f"(moe.shared): mapping table {family!r} has no rule for them, "
            f"and no table of {sorted(MAPPINGS)} does")


# --------------------------------------------------------------------------
# Shapes and transforms
# --------------------------------------------------------------------------

def _dest_shape(spec: spec_lib.ModelSpec, dest: Tuple[str, ...]
                ) -> Tuple[int, ...]:
    """Per-layer (no stage dim) shape of a destination leaf."""
    d, h, kv, dh = spec.d_model, spec.n_heads, spec.n_kv, spec.d_head
    vpad = padded_vocab(spec.vocab)
    table = {
        ("embed",): (vpad, d),
        ("head",): (d, vpad),
        ("final_norm", "scale"): (d,),
        ("norm1", "scale"): (d,),
        ("norm2", "scale"): (d,),
        ("attn", "wq"): (d, h, dh),
        ("attn", "wk"): (d, kv, dh),
        ("attn", "wv"): (d, kv, dh),
        ("attn", "wo"): (h * dh, d),
        ("attn", "q_norm"): (dh,),
        ("attn", "k_norm"): (dh,),
        ("mlp", "w1"): (d, spec.d_ff),
        ("mlp", "w3"): (d, spec.d_ff),
        ("mlp", "w2"): (spec.d_ff, d),
    }
    if spec.moe is not None:
        m = spec.moe
        table.update({
            ("moe", "router"): (d, m.n_experts),
            ("moe", "w1"): (m.n_experts, d, m.d_expert),
            ("moe", "w3"): (m.n_experts, d, m.d_expert),
            ("moe", "w2"): (m.n_experts, m.d_expert, d),
        })
    return table[dest]


def _expected_hf_shape(spec, rule: Rule, per_expert: bool
                       ) -> Tuple[int, ...]:
    out = _dest_shape(spec, rule.dest)
    if per_expert:
        out = out[1:]                    # one expert's slice
    if rule.transform == "copy":
        return out
    if rule.transform == "transpose":
        return tuple(reversed(out))
    if rule.transform in ("qheads", "kvheads"):   # (d, h, dh) <- (h*dh, d)
        return (out[1] * out[2], out[0])
    if rule.transform in ("embed_pad", "head_pad"):
        return (spec.vocab, spec.d_model)
    raise ConvertError(f"unknown transform {rule.transform!r}")


def _apply_transform(arr: np.ndarray, spec, rule: Rule) -> np.ndarray:
    """HF layout -> the tree's layout (float32)."""
    arr = np.asarray(arr, np.float32)
    t = rule.transform
    if t == "copy":
        return arr
    if t == "transpose":
        return arr.T
    if t == "qheads":
        return arr.T.reshape(spec.d_model, spec.n_heads, spec.d_head)
    if t == "kvheads":
        return arr.T.reshape(spec.d_model, spec.n_kv, spec.d_head)
    if t == "embed_pad":
        vpad = padded_vocab(spec.vocab)
        return np.pad(arr, ((0, vpad - arr.shape[0]), (0, 0)))
    if t == "head_pad":
        vpad = padded_vocab(spec.vocab)
        return np.pad(arr.T, ((0, 0), (0, vpad - arr.shape[0])))
    raise ConvertError(f"unknown transform {t!r}")


def _invert_transform(arr: np.ndarray, spec, rule: Rule) -> np.ndarray:
    """The tree's layout -> HF layout (the export direction)."""
    arr = np.asarray(arr, np.float32)
    t = rule.transform
    if t == "copy":
        return arr
    if t == "transpose":
        return arr.T
    if t in ("qheads", "kvheads"):
        return arr.reshape(spec.d_model, -1).T
    if t == "embed_pad":
        return arr[: spec.vocab]
    if t == "head_pad":
        return arr[:, : spec.vocab].T
    raise ConvertError(f"unknown transform {t!r}")


def validate_tp(spec: spec_lib.ModelSpec, tp: int, family: str) -> None:
    """tp divisibility for every axis the family's table splits; raises
    :class:`ConvertError` naming the failing axis."""
    if tp <= 1:
        return
    checks = {"heads": spec.n_heads, "ffn": spec.d_ff}
    if spec.moe is not None:
        checks["experts"] = spec.moe.n_experts
        del checks["ffn"]
    for axis, size in checks.items():
        if size % tp:
            raise ConvertError(
                f"tp={tp} does not divide axis {axis!r} (size {size}) "
                f"for family {family!r} / spec {spec.name!r}")
    # kv heads follow the engine's rule: kv % tp == 0 or tp % kv == 0
    if spec.n_kv % tp and tp % spec.n_kv:
        raise ConvertError(
            f"tp={tp} does not divide axis 'kv_heads' (size {spec.n_kv}) "
            f"and is not a multiple of it, for family {family!r} / "
            f"spec {spec.name!r}")


# --------------------------------------------------------------------------
# Routing (shared by the streaming convert and the in-memory load)
# --------------------------------------------------------------------------

def _layer_dests(spec: spec_lib.ModelSpec, blk) -> Dict[Tuple[str, ...], int]:
    """Expected leaves of one layer -> number of HF tensors feeding each."""
    if spec.norm != "rmsnorm" or spec.act != "silu":
        raise ConvertError(
            f"mapping tables cover rmsnorm+silu families only, got "
            f"norm={spec.norm!r} act={spec.act!r} for {spec.name!r}")
    dests: Dict[Tuple[str, ...], int] = {
        ("norm1", "scale"): 1, ("norm2", "scale"): 1,
        ("attn", "wq"): 1, ("attn", "wk"): 1,
        ("attn", "wv"): 1, ("attn", "wo"): 1,
    }
    if spec.qk_norm:
        dests[("attn", "q_norm")] = 1
        dests[("attn", "k_norm")] = 1
    if blk.ffn == "dense":
        dests[("mlp", "w1")] = dests[("mlp", "w2")] = dests[("mlp", "w3")] = 1
    elif blk.ffn == "moe":
        e = spec.moe.n_experts
        dests[("moe", "router")] = 1
        dests[("moe", "w1")] = dests[("moe", "w2")] = dests[("moe", "w3")] = e
    else:
        raise ConvertError(
            f"mapping tables cover dense/moe ffn only, got {blk.ffn!r} "
            f"for {spec.name!r}")
    return dests


class _Assembler:
    """Routes HF tensors into per-chunk layer dicts and hands each chunk
    to ``sink(row, chunk)`` the moment it completes: the core shared by
    :func:`convert` (a disk sink) and :func:`hf_to_params` (in memory)."""

    def __init__(self, spec: spec_lib.ModelSpec, *, pp: int, tp: int,
                 v: int, family: Optional[str] = None, sink=None):
        self.spec = spec
        self.family = family or family_for(spec)
        if self.family not in MAPPINGS:
            raise ConvertError(
                f"unknown mapping table {self.family!r}; available: "
                f"{sorted(MAPPINGS)}")
        _refuse_shared_experts(spec, self.family)
        validate_tp(spec, tp, self.family)
        n_chunks = pp * v
        if spec.n_layers % n_chunks:
            raise ConvertError(
                f"n_layers={spec.n_layers} not divisible by "
                f"pp*v={n_chunks} for {spec.name!r}")
        self.pp, self.tp, self.v = pp, tp, v
        self.n_chunks = n_chunks
        self.lpc = spec.n_layers // n_chunks      # layers per chunk
        self.order = storage_order(pp, v)         # row -> model chunk
        self.row_of = {c: p for p, c in enumerate(self.order)}
        self.rules = [(r, r.regex()) for r in MAPPINGS[self.family]]
        program = spec.stage_program(n_chunks)
        self.expected = [_layer_dests(spec, blk) for blk in program]
        self.sink = sink or (lambda row, chunk: None)
        # chunk id -> {"layer_<pos>/<dest...>": array or (E, ...) buffer}
        self._buf: Dict[int, Dict[str, np.ndarray]] = {}
        self._remaining: Dict[int, Dict[str, int]] = {}
        self._shared: Dict[str, np.ndarray] = {}
        self._shared_remaining = {"embed": 1, "final_norm/scale": 1,
                                  "head": 1}
        self.flushed: List[int] = []

    def _match(self, key: str):
        for rule, rx in self.rules:
            m = rx.match(key)
            if m:
                return rule, m
        raise ConvertError(
            f"unknown checkpoint key {key!r}: no rule in mapping table "
            f"{self.family!r} matches it")

    def _chunk_init(self, c: int) -> None:
        self._buf[c] = {}
        self._remaining[c] = {}
        for pos in range(self.lpc):
            for dest, n in self.expected[pos].items():
                self._remaining[c]["/".join((f"layer_{pos}",) + dest)] = n

    def add(self, key: str, arr: np.ndarray) -> None:
        rule, m = self._match(key)
        gd = m.groupdict()
        per_expert = "expert" in gd
        want = _expected_hf_shape(self.spec, rule, per_expert)
        if tuple(arr.shape) != want:
            raise ConvertError(
                f"{key}: tensor shape {tuple(arr.shape)} does not match "
                f"expected shape {want} for {self.family}:"
                f"{'/'.join(rule.dest)}")
        out = _apply_transform(arr, self.spec, rule)

        if rule.shared:
            flat = "/".join(rule.dest)
            self._shared[flat] = out
            self._shared_remaining[flat] = 0
            return

        layer = int(gd["layer"])
        if layer >= self.spec.n_layers:
            raise ConvertError(
                f"{key}: layer index {layer} out of range for "
                f"{self.spec.name!r} (n_layers={self.spec.n_layers})")
        c, pos = divmod(layer, self.lpc)
        if c not in self._buf:
            if c in self.flushed:
                raise ConvertError(
                    f"{key}: duplicate tensor for already-flushed chunk {c}")
            self._chunk_init(c)
        flat = "/".join((f"layer_{pos}",) + rule.dest)
        if flat not in self._remaining[c]:
            raise ConvertError(
                f"unknown checkpoint key {key!r}: destination {flat!r} is "
                f"not expected by mapping table {self.family!r} for "
                f"{self.spec.name!r}")
        if per_expert:
            e = int(gd["expert"])
            full = _dest_shape(self.spec, rule.dest)
            if e >= full[0]:
                raise ConvertError(
                    f"{key}: expert index {e} out of range "
                    f"(n_experts={full[0]})")
            if flat not in self._buf[c]:
                self._buf[c][flat] = np.zeros(full, np.float32)
            # a transposed view into its slot: torch's strided copy runs
            # on every core, numpy's on one
            torch.from_numpy(self._buf[c][flat][e]).copy_(
                torch.from_numpy(out))
        else:
            self._buf[c][flat] = out
        self._remaining[c][flat] -= 1
        if all(n <= 0 for n in self._remaining[c].values()):
            row = self.row_of[c]
            self.sink(row, self._buf.pop(c))
            del self._remaining[c]
            self.flushed.append(c)

    def finish(self) -> Dict[str, np.ndarray]:
        missing = []
        for c, rem in sorted(self._remaining.items()):
            for flat, n in sorted(rem.items()):
                if n > 0:
                    missing.append(f"chunk {c}: {flat} ({n} tensor(s))")
        missing += [f"shared: {k}" for k, n in
                    sorted(self._shared_remaining.items()) if n > 0]
        unstarted = [c for c in range(self.n_chunks)
                     if c not in self.flushed and c not in self._buf]
        missing += [f"chunk {c}: no tensors seen" for c in unstarted]
        if missing:
            head = "; ".join(missing[:6])
            more = f" (+{len(missing) - 6} more)" if len(missing) > 6 else ""
            raise ConvertError(
                f"incomplete checkpoint for {self.spec.name!r}: missing "
                f"{head}{more}")
        return self._shared


# --------------------------------------------------------------------------
# Shard resolution and streaming iteration
# --------------------------------------------------------------------------

def resolve_shards(src: str) -> List[str]:
    """Shard file list for a checkpoint path (a file, or a directory with
    either ``model.safetensors`` or ``model.safetensors.index.json``)."""
    if os.path.isfile(src):
        return [src]
    if os.path.isdir(src):
        idx = os.path.join(src, INDEX_NAME)
        if os.path.exists(idx):
            with open(idx) as f:
                index = json.load(f)
            names = sorted(set(index.get("weight_map", {}).values()))
            shards = [os.path.join(src, n) for n in names]
            for s in shards:
                if not os.path.exists(s):
                    raise ConvertError(
                        f"missing safetensors shard {s!r} (referenced by "
                        f"{idx!r})")
            return shards
        single = os.path.join(src, "model.safetensors")
        if os.path.exists(single):
            return [single]
        raise ConvertError(
            f"missing safetensors shard {single!r}: directory {src!r} has "
            f"neither model.safetensors nor model.safetensors.index.json")
    raise ConvertError(f"missing safetensors shard {src!r}: no such "
                       f"file or directory")


def _iter_tensors(shards: List[str]):
    """Yield (key, np.ndarray) one tensor at a time across shards."""
    for path in shards:
        yield from st.iter_tensors(path)


# --------------------------------------------------------------------------
# convert / load / direct / export
# --------------------------------------------------------------------------

def convert(src: str, dest_dir: str, spec: spec_lib.ModelSpec, *,
            pp: int, tp: int = 1, virtual_stages: int = 1,
            family: Optional[str] = None,
            config: Optional[str] = None) -> Dict[str, Any]:
    """Stream an HF safetensors checkpoint into storage-chunk files:
    ``chunk_<row>.npz`` per storage row (written as soon as the chunk's
    tensors have all arrived), ``shared.npz`` and the manifest, written
    last.  Returns the manifest dict."""
    shards = resolve_shards(src)
    os.makedirs(dest_dir, exist_ok=True)
    writes = []

    # a finished chunk is written by a second thread while this one reads
    # and routes the next (file writes and zip CRCs release the GIL)
    with ThreadPoolExecutor(max_workers=1) as writer:
        def sink(row: int, chunk: Dict[str, np.ndarray]):
            writes.append(writer.submit(
                np.savez, os.path.join(dest_dir, f"chunk_{row:04d}.npz"),
                **chunk))

        asm = _Assembler(spec, pp=pp, tp=tp, v=virtual_stages,
                         family=family, sink=sink)
        for key, arr in _iter_tensors(shards):
            asm.add(key, arr)
        shared = asm.finish()
        np.savez(os.path.join(dest_dir, "shared.npz"), **shared)
        for w in writes:
            w.result()
    manifest = {
        "format": "repro-chunks-v1",
        "family": asm.family,
        "spec": spec.name,
        "config": config,
        "pp": pp, "tp": tp, "virtual_stages": virtual_stages,
        "n_chunks": asm.n_chunks,
        "layers_per_chunk": asm.lpc,
        "storage_order": asm.order,
        "vocab": spec.vocab,
        "dtype": "float32",
        "source": [os.path.basename(s) for s in shards],
    }
    tmp = os.path.join(dest_dir, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(dest_dir, MANIFEST_NAME))
    return manifest


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


def _stack(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack equally nested dicts of arrays leaf by leaf on a new dim 0."""
    return {k: (_stack([r[k] for r in rows]) if isinstance(v, dict)
                else np.stack([r[k] for r in rows], axis=0))
            for k, v in rows[0].items()}


def _finalize_params(rows: List[Dict[str, Any]], shared: Dict[str, Any],
                     spec: spec_lib.ModelSpec, order: List[int]
                     ) -> Dict[str, Any]:
    """Stack per-row chunk dicts (already in storage order) into the
    engine's stage-stacked tree, with the shared leaves and the per-chunk
    window / theta scalars in storage order, as the engine lays them."""
    stages = _stack(rows)
    windows, thetas = spec_lib.stage_varying_scalars(spec, len(order))
    perm = np.asarray(order)
    return {
        "embed": shared["embed"],
        "head": shared["head"],
        "final_norm": {"scale": shared["final_norm"]["scale"]},
        "stages": stages,
        "layer_windows": np.asarray(windows, np.int32)[perm],
        "layer_thetas": np.asarray(thetas, np.float32)[perm],
    }


def read_manifest(ckpt_dir: str, spec: spec_lib.ModelSpec
                  ) -> Dict[str, Any]:
    """A converted directory's manifest, after checking that it was
    converted for ``spec`` (nothing else of the directory is read)."""
    mf = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.exists(mf):
        raise ConvertError(f"missing manifest {mf!r}: not a converted "
                           f"checkpoint directory")
    with open(mf) as f:
        manifest = json.load(f)
    if manifest.get("spec") != spec.name:
        raise ConvertError(
            f"checkpoint {ckpt_dir!r} was converted for spec "
            f"{manifest.get('spec')!r}, not {spec.name!r}")
    return manifest


def load_converted(ckpt_dir: str, spec: spec_lib.ModelSpec
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A converted checkpoint directory as the engine's numpy parameter
    tree (storage chunk order, full width: ``EngineSession.load_params``
    takes it).  Returns (params, manifest)."""
    return load_converted_rows(ckpt_dir, spec)


def load_converted_rows(ckpt_dir: str, spec: spec_lib.ModelSpec,
                        rows=None, *, embed: bool = True, head: bool = True
                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The storage rows ``rows`` of a converted directory (every row for
    None), read without the rest: their ``chunk_<row>.npz`` files only,
    stacked in that order, with their window / theta scalars; from
    ``shared.npz``, which is opened only when one is asked for, the
    embedding with ``embed`` and the head and final norm with ``head``.
    One rank of a serving grid reads its own rows and tables, at full
    width: the rank cuts its tensor shard
    (``EngineSession.load_rank_params``).  Returns (params, manifest)."""
    manifest = read_manifest(ckpt_dir, spec)
    n_chunks = manifest["n_chunks"]
    rows = [int(r) for r in (range(n_chunks) if rows is None else rows)]
    paths = [os.path.join(ckpt_dir, f"chunk_{row:04d}.npz") for row in rows]
    for path in paths:
        if not os.path.exists(path):
            raise ConvertError(f"missing chunk file {path!r} (manifest "
                               f"lists {n_chunks} chunks)")
    keys = (("embed",) if embed else ()) + (("head", "final_norm/scale")
                                            if head else ())

    def read(path):
        with np.load(path) as z:
            return _unflatten(dict(z))

    def read_shared():
        with np.load(os.path.join(ckpt_dir, "shared.npz")) as z:
            return _unflatten({k: z[k] for k in keys})

    # the files are read side by side (file reads and zip CRCs release
    # the GIL)
    with ThreadPoolExecutor(max_workers=min(8, len(paths) + 1)) as pool:
        shared = pool.submit(read_shared) if keys else None
        trees = list(pool.map(read, paths))
        params: Dict[str, Any] = shared.result() if keys else {}
    windows, thetas = spec_lib.stage_varying_scalars(spec, n_chunks)
    order = manifest["storage_order"]
    params.update({
        "stages": _stack(trees),
        "layer_windows": np.asarray(windows, np.int32)[order][rows],
        "layer_thetas": np.asarray(thetas, np.float32)[order][rows]})
    return params, manifest


def hf_to_params(tensors: Dict[str, np.ndarray], spec: spec_lib.ModelSpec,
                 *, pp: int, tp: int = 1, virtual_stages: int = 1,
                 family: Optional[str] = None) -> Dict[str, Any]:
    """An in-memory HF dict -> the params tree, by the same routing as
    :func:`convert` without the disk (convert then load equals it bit
    for bit)."""
    rows: Dict[int, Dict[str, Any]] = {}

    def sink(row: int, chunk: Dict[str, np.ndarray]):
        rows[row] = _unflatten(chunk)

    asm = _Assembler(spec, pp=pp, tp=tp, v=virtual_stages, family=family,
                     sink=sink)
    for key in sorted(tensors):
        asm.add(key, tensors[key])
    shared = _unflatten(asm.finish())
    return _finalize_params([rows[r] for r in range(asm.n_chunks)],
                            shared, spec, asm.order)


def _hf_name(rule: Rule, layer: Optional[int] = None,
             expert: Optional[int] = None) -> str:
    """The concrete HF tensor name a rule's pattern matches."""
    pat = rule.pattern
    if layer is not None:
        pat = pat.replace(r"(?P<layer>\d+)", str(layer))
    if expert is not None:
        pat = pat.replace(r"(?P<expert>\d+)", str(expert))
    return pat.replace("\\.", ".")


def _get(tree, dest):
    for k in dest:
        tree = tree[k]
    return tree


def export_checkpoint(ckpt_dir: str, out_path: str,
                      spec: spec_lib.ModelSpec) -> Dict[str, np.ndarray]:
    """Converted chunks back to one HF-named F32 safetensors file.
    Returns the exported tensor dict."""
    params, manifest = load_converted(ckpt_dir, spec)
    family = manifest["family"]
    rule_of = {r.dest: r for r in MAPPINGS[family]}
    lpc = manifest["layers_per_chunk"]
    order = manifest["storage_order"]

    out: Dict[str, np.ndarray] = {}
    for dest in [("embed",), ("final_norm", "scale"), ("head",)]:
        rule = rule_of[dest]
        out[_hf_name(rule)] = _invert_transform(_get(params, dest), spec,
                                                rule)

    for row, chunk in enumerate(order):
        for pos in range(lpc):
            g = chunk * lpc + pos                 # global layer
            lp = params["stages"][f"layer_{pos}"]
            for dest in _layer_dests(spec, spec.blocks[g]):
                rule = rule_of[dest]
                ours = _get(lp, dest)[row]
                if "expert" in rule.pattern:
                    for e in range(ours.shape[0]):
                        out[_hf_name(rule, g, e)] = _invert_transform(
                            ours[e], spec, rule)
                else:
                    out[_hf_name(rule, g)] = _invert_transform(
                        ours, spec, rule)
    st.save_file(out, out_path)
    return out


# --------------------------------------------------------------------------
# Synthetic fixture (tests and chip_smoke.py)
# --------------------------------------------------------------------------

def synthetic_tensors(spec: spec_lib.ModelSpec, *, seed: int = 0,
                      family: Optional[str] = None,
                      draw: Optional[Callable[..., np.ndarray]] = None
                      ) -> Dict[str, np.ndarray]:
    """A random HF-named f32 tensor dict for ``spec``: the JAX package's
    ``make_synthetic_checkpoint`` draws, value for value.  ``draw(*shape)``
    replaces those draws of 0.05·N(0, 1) (a full-width fixture drawn on
    the card is seconds where numpy's generator takes minutes)."""
    _refuse_shared_experts(spec, family or family_for(spec))
    rng = np.random.default_rng(seed)
    d, h, kv, dh = spec.d_model, spec.n_heads, spec.n_kv, spec.d_head

    def r(*shape):
        if draw is not None:
            return draw(*shape)
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    out: Dict[str, np.ndarray] = {
        "model.embed_tokens.weight": r(spec.vocab, d),
        "model.norm.weight": 1.0 + 0.01 * r(d),
        "lm_head.weight": r(spec.vocab, d),
    }
    for i, blk in enumerate(spec.blocks):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = 1.0 + 0.01 * r(d)
        out[p + "post_attention_layernorm.weight"] = 1.0 + 0.01 * r(d)
        out[p + "self_attn.q_proj.weight"] = r(h * dh, d)
        out[p + "self_attn.k_proj.weight"] = r(kv * dh, d)
        out[p + "self_attn.v_proj.weight"] = r(kv * dh, d)
        out[p + "self_attn.o_proj.weight"] = r(d, h * dh)
        if spec.qk_norm:
            out[p + "self_attn.q_norm.weight"] = 1.0 + 0.01 * r(dh)
            out[p + "self_attn.k_norm.weight"] = 1.0 + 0.01 * r(dh)
        if blk.ffn == "dense":
            out[p + "mlp.gate_proj.weight"] = r(spec.d_ff, d)
            out[p + "mlp.up_proj.weight"] = r(spec.d_ff, d)
            out[p + "mlp.down_proj.weight"] = r(d, spec.d_ff)
        elif blk.ffn == "moe":
            m = spec.moe
            out[p + "mlp.gate.weight"] = r(m.n_experts, d)
            for e in range(m.n_experts):
                q = f"{p}mlp.experts.{e}."
                out[q + "gate_proj.weight"] = r(m.d_expert, d)
                out[q + "up_proj.weight"] = r(m.d_expert, d)
                out[q + "down_proj.weight"] = r(d, m.d_expert)
    return out


def write_checkpoint(path: str, tensors: Dict[str, np.ndarray], *,
                     shards: int = 1, dtype: Optional[str] = None) -> None:
    """Write an HF-format checkpoint: one file at ``path`` (or
    ``path/model.safetensors`` for a directory) for ``shards <= 1``,
    else ``shards`` files ``model-0000i-of-0000n.safetensors`` over the
    sorted keys plus ``model.safetensors.index.json`` in the directory
    ``path``.  ``dtype="BF16"`` stores the tensors as bfloat16."""
    if shards <= 1:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.isdir(path):
            path = os.path.join(path, "model.safetensors")
        st.save_file(tensors, path, dtype=dtype)
        return
    os.makedirs(path, exist_ok=True)
    keys = sorted(tensors)
    per = -(-len(keys) // shards)
    weight_map = {}
    for si in range(shards):
        name = f"model-{si + 1:05d}-of-{shards:05d}.safetensors"
        part = {k: tensors[k] for k in keys[si * per: (si + 1) * per]}
        st.save_file(part, os.path.join(path, name), dtype=dtype)
        weight_map.update({k: name for k in part})
    with open(os.path.join(path, INDEX_NAME), "w") as f:
        json.dump({"weight_map": weight_map}, f)


def make_synthetic_checkpoint(path: str, spec: spec_lib.ModelSpec, *,
                              seed: int = 0, shards: int = 1,
                              family: Optional[str] = None,
                              dtype: Optional[str] = None
                              ) -> Dict[str, np.ndarray]:
    """Write a random HF-format safetensors checkpoint for ``spec``
    (:func:`synthetic_tensors`, stored by :func:`write_checkpoint`;
    ``dtype="BF16"`` for a bfloat16 fixture).  Returns the f32 tensor
    dict that was drawn."""
    out = synthetic_tensors(spec, seed=seed, family=family)
    write_checkpoint(path, out, shards=shards, dtype=dtype)
    return out


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def _resolve_spec(config: str, smoke: bool) -> spec_lib.ModelSpec:
    from repro_torch import configs
    mod = configs.get(config)
    return mod.smoke_spec() if smoke else mod.full_spec()


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="HF safetensors <-> storage-chunk checkpoint converter")
    ap.add_argument("--src", required=True,
                    help="safetensors file/dir (convert) or converted "
                         "chunk dir (--export)")
    ap.add_argument("--dest", required=True,
                    help="output chunk dir (convert) or output "
                         ".safetensors path (--export)")
    ap.add_argument("--config", required=True,
                    help="config module or arch id, e.g. olmoe_1b_7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the config's smoke_spec()")
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--virtual-stages", type=int, default=1)
    ap.add_argument("--family", default=None,
                    help="mapping table override (default: from spec)")
    ap.add_argument("--export", action="store_true",
                    help="inverse direction: chunk dir -> safetensors")
    args = ap.parse_args(argv)

    spec = _resolve_spec(args.config, args.smoke)
    if args.export:
        tensors = export_checkpoint(args.src, args.dest, spec)
        print(f"exported {len(tensors)} tensors -> {args.dest}")
    else:
        manifest = convert(args.src, args.dest, spec, pp=args.pp,
                           tp=args.tp, virtual_stages=args.virtual_stages,
                           family=args.family, config=args.config)
        print(f"converted {manifest['spec']} -> {args.dest} "
              f"(pp={args.pp}, tp={args.tp}, v={args.virtual_stages}, "
              f"{manifest['n_chunks']} chunks)")


if __name__ == "__main__":
    main()
