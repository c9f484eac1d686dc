"""Op counts of one eager call: FLOPs, bytes and collective bytes (the
port's counterpart of ``repro/launch/hlo_analysis.py``).

:func:`count` runs ``fn(*args)`` once and counts

  * every ATen op under a ``TorchDispatchMode``: FLOPs by the formulas
    ``torch.utils.flop_counter`` registers (the products: mm, addmm,
    bmm, baddbmm, convolutions, SDPA), bytes as the op's operand bytes
    plus its output bytes.  A view (an op whose output aliases its
    input) and an allocation moves nothing and costs nothing.  These
    are the counterpart of JAX's bytes at fusion boundaries: each op's
    tensors cross HBM once, as an eager op's do;
  * every hand-written kernel through its entry point
    (``kernels/ops.py``, the autograd Functions' backwards): a *kernel
    region* adds ``kernels/cost.py``'s count of the call and stops the
    ATen counting inside itself, so the plain version on the CPU and
    the kernel on the card count the same work;
  * the collectives, as the change of a rank's
    ``parallel/dist.py::TransportStats`` over the call (``grid=``):
    hand-off bytes sent, the data / world groups' bytes and the tensor
    group's.

Eager execution runs every call of a loop, so JAX's recovery of while
trip counts has no counterpart here: the count is what ran.  Tensors on
``meta`` count by their shapes alone (the dry run's use), except the
data-dependent parts noted in ``kernels/cost.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kcost

# ops that allocate, alias or read a scalar: no HBM traffic of their own
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_local_scalar_dense", "resize_", "set_", "record_stream",
             "sym_size", "sym_stride", "sym_numel", "is_same_size",
             "_has_compatible_shallow_copy_type", "_unsafe_view"}
_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
          torch.int64: "s64", torch.int32: "s32", torch.int8: "s8",
          torch.uint8: "u8", torch.bool: "pred", torch.int16: "s16",
          torch.float64: "f64"}


def _tensors(tree):
    """The tensors in an op's arguments or outputs (tensors, lists and
    tuples of them, dicts of keyword arguments)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple, dict)):
            out.extend(_tensors(x))
    return out


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _sig(name: str, outs) -> str:
    if not outs:
        return name
    t = outs[0]
    return f"{name} {_DTYPE.get(t.dtype, str(t.dtype))}{list(t.shape)}"


@dataclasses.dataclass
class OpCost:
    """One call's counts.  ``flops`` and ``hbm_bytes`` are the ATen ops'
    plus the kernel regions' (``kernel_flops`` / ``kernel_bytes`` of
    them); ``*_by_sig`` attribute them to (op, first output's type)
    signatures and ``*_by_op`` to op names; ``kernel_calls`` counts the
    regions by kernel."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    flops_by_sig: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_sig: Dict[str, float] = dataclasses.field(default_factory=dict)
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_operand_bytes: float = 0.0
    per_collective: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    aten_ops: int = 0

    def _add(self, op: str, sig: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes
        for table, key, v in ((self.flops_by_sig, sig, flops),
                              (self.bytes_by_sig, sig, nbytes),
                              (self.flops_by_op, op, flops),
                              (self.bytes_by_op, op, nbytes)):
            if v:
                table[key] = table.get(key, 0.0) + v

    def add_kernel(self, name: str, c: kcost.KernelCost) -> None:
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        self.kernel_flops += c.flops
        self.kernel_bytes += c.bytes
        self._add(f"kernel {name}", f"kernel {name}", c.flops, c.bytes)

    def top(self, table: Dict[str, float], k: int = 15):
        return sorted(table.items(), key=lambda kv: -kv[1])[:k]

    def scaled(self, f: float) -> "OpCost":
        """Every count times ``f`` (a replica's counts split over its
        cards); the kernel calls stay the replica's."""
        out = dataclasses.replace(self)
        for name in ("flops", "hbm_bytes", "coll_operand_bytes",
                     "kernel_flops", "kernel_bytes"):
            setattr(out, name, getattr(self, name) * f)
        for name in ("flops_by_sig", "bytes_by_sig", "flops_by_op",
                     "bytes_by_op", "per_collective"):
            setattr(out, name, {k: v * f for k, v in
                                getattr(self, name).items()})
        return out

    def to_json(self, top: int = 12) -> Dict[str, Any]:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "kernel_flops": self.kernel_flops,
                "kernel_bytes": self.kernel_bytes,
                "coll_operand_bytes": self.coll_operand_bytes,
                "per_collective": self.per_collective,
                "kernel_calls": self.kernel_calls,
                "aten_ops": self.aten_ops,
                "top_flops": self.top(self.flops_by_sig, top),
                "top_bytes": self.top(self.bytes_by_sig, top)}


def _key(x):
    """A hashable stand-in of an op argument: a tensor by its metadata."""
    if isinstance(x, torch.Tensor):
        return (x.dtype, tuple(x.shape), x.stride(), x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_key(y) for y in x)
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in x.items())
    return x


class _Counter(TorchDispatchMode):
    """Counts every ATen op outside a kernel region into ``cost``.

    On ``meta`` the output of a functional op (no view, no mutation, only
    tensors out) depends on its inputs' metadata alone, so it is made
    from a cache of earlier calls: the same layer's ops repeat every
    microbatch, and PyTorch's meta functions cost ~0.1 ms an op."""

    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost
        self.ops = {}            # func -> (name, flop fn, counts bytes, pure)
        self.meta = {}           # (func, arguments) -> outputs' metadata

    def _op(self, func):
        got = self.ops.get(func)
        if got is None:
            packet = func._overloadpacket
            name = packet.__name__
            schema = func._schema
            pure = (not func.is_view and not schema.is_mutable
                    and all(str(r.type) == "Tensor" for r in schema.returns)
                    and len(schema.returns) > 0)
            got = self.ops[func] = (
                f"aten.{name}", flop_registry.get(packet),
                not func.is_view and name not in _NO_BYTES, pure,
                func.namespace in ("aten", "prims"))
        return got

    def _run(self, func, pure, args, kwargs):
        meta = pure and any(isinstance(t, torch.Tensor) and t.is_meta
                            for t in args)
        if not meta:
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        shapes = self.meta.get(key)
        if shapes is None:
            out = func(*args, **kwargs)
            outs = (out,) if isinstance(out, torch.Tensor) else out
            self.meta[key] = ((isinstance(out, torch.Tensor),)
                              + tuple((tuple(t.shape), t.stride(), t.dtype)
                                      for t in outs))
            return out
        outs = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                         device="meta")
                     for shape, stride, dtype in shapes[1:])
        return outs[0] if shapes[0] else outs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, flop_fn, counts_bytes, pure, aten = self._op(func)
        out = self._run(func, pure, args, kwargs)
        if not aten or kcost.in_region():
            return out
        flops = flop_fn(*args, **kwargs, out_val=out) if flop_fn else 0
        outs = _tensors(out)
        nbytes = 0
        if counts_bytes:
            nbytes = (_bytes(_tensors(args)) + _bytes(_tensors(kwargs))
                      + _bytes(outs))
        self.cost.aten_ops += 1
        self.cost._add(name, _sig(name, outs), flops, nbytes)
        return out


def _transport(grid) -> Dict[str, float]:
    s = grid.stats
    return {"handoff": s.handoff_bytes, "data": s.collective_bytes,
            "tensor": s.tensor_bytes}


def count_call(fn, *args, grid=None, **kwargs) -> Tuple[Any, OpCost]:
    """(``fn(*args, **kwargs)``, its :class:`OpCost`); with ``grid`` (a
    :class:`~repro_torch.parallel.dist.RankGrid`) the call's collectives
    too, from its transport's counters."""
    cost = OpCost()
    before = _transport(grid) if grid is not None else None
    kcost.COUNTERS.append(cost)
    try:
        with _Counter(cost):
            out = fn(*args, **kwargs)
    finally:
        kcost.COUNTERS.remove(cost)
    if grid is not None:
        after = _transport(grid)
        cost.per_collective = {k: float(after[k] - before[k])
                               for k in after}
        cost.coll_operand_bytes = float(sum(cost.per_collective.values()))
    return out, cost


def count(fn, *args, grid=None, **kwargs) -> OpCost:
    """The :class:`OpCost` of one call ``fn(*args, **kwargs)``."""
    return count_call(fn, *args, grid=grid, **kwargs)[1]
