"""Weight-version stash ring primitives (port of
``repro/core/versioning.py``).

The stash and residual rings are stacked trees indexed by
schedule-table slots: leaves ``[V, L, ...]`` (version slot, storage
row) for the weight ring, ``[Vr, S, ...]`` for the residual ring.  With
virtual stages the L = S·v rows are model chunks in storage order
(row s·v + j holds chunk j·S + s), and the ``tree_chunk*`` helpers index
one chunk row, or one (version slot, chunk) cell of the chunk-major
ring.  JAX writes them
functionally (``dynamic_update_index_in_dim`` + ``where``) and XLA
updates in place under donation; here a write is an in-place copy into
the slot, and a read is a view of it.  A bubble row is skipped on the
host, so ``valid`` is a Python bool, and JAX's masking helpers
(``tree_select``, ``tree_scale``) have nothing to mask.

ZeRO-1 (optimizer state sharded over data replicas) and the per-
microbatch gradient all-reduce over replicas wait for data replicas,
which the port does not run yet: one replica, so the all-reduce is the
identity.
"""
from __future__ import annotations

from repro_torch.optim.optimizers import tree_map


def tree_chunk(tree, idx: int):
    """Chunk row ``idx`` of every stage-stacked leaf (a view)."""
    return tree_map(lambda a: a[idx], tree)


def tree_chunk_write(tree, idx: int, val) -> None:
    """Copy ``val`` into chunk row ``idx`` of every leaf, in place."""
    tree_map(lambda a, v: a[idx].copy_(v), tree, val)


def tree_chunk_ring_read(ring, slot: int, chunk: int):
    """Cell (version ``slot``, chunk row ``chunk``) of the chunk-major
    ring ``[V, S·v, ...]`` (a view): the version F recorded for a
    (microbatch, chunk), read back by its B."""
    return tree_map(lambda a: a[slot, chunk], ring)


def tree_chunk_ring_write(ring, slot: int, chunk: int, val,
                          valid: bool = True) -> None:
    """Record a chunk's current weights into its ring cell, in place."""
    if valid:
        tree_map(lambda a, v: a[slot, chunk].copy_(v), ring, val)


def tree_chunk_add(acc, grad, idx: int) -> None:
    """``acc[idx] += grad`` leaf by leaf, in place: a chunk's gradient
    into the chunk-stacked accumulator."""
    tree_map(lambda a, g: a[idx].add_(g), acc, grad)


def tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def tree_add_(acc, b) -> None:
    """``acc += b`` leaf by leaf, in place (``acc`` keeps its dtype)."""
    tree_map(lambda x, y: x.add_(y), acc, b)


def replicated_microbatch_update(optimizer, dW, opt_state, weights, step,
                                 valid: bool, *, dp: int = 1) -> None:
    """Per-microbatch update of one stage (paper §3.2), in place.  Over
    data replicas the gradient is all-reduced first; the port runs one
    replica."""
    if dp != 1:
        raise NotImplementedError(
            "data replicas (all-reduce, ZeRO-1) are not ported yet")
    if valid:
        optimizer.update_(dW, opt_state, weights, step)


def make_train_state(params, sched, optimizer):
    """The training state JAX's ``init_state`` builds from ``params``
    (stage rows already in storage order): ``stash["current"]`` is
    ``params["stages"]`` itself (one set of tensors), ``stash["ring"]``
    a ``[V, L, ...]`` copy of it when the schedule keeps a ring (chunk-
    major for ``interleaved_async``: L = S·v storage rows), the
    optimizer states of the stages, of head + final norm and of the
    embedding, and the round counter."""
    stages = params["stages"]
    stash = {"current": stages}
    if sched.uses_stash_ring:
        V = sched.stash_slots
        stash["ring"] = tree_map(
            lambda a: a[None].expand((V,) + tuple(a.shape)).clone(), stages)
    return {
        "params": params,
        "stash": stash,
        "opt_stages": optimizer.init(stages),
        "opt_head": optimizer.init({"h": params["head"],
                                    "f": params["final_norm"]}),
        "opt_embed": optimizer.init(params["embed"]),
        "step": 0,
    }
