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

Over data replicas (a :class:`~repro_torch.parallel.dist.Group` of the
ranks that hold one stage) a stage's gradient is summed before its
update (paper §3.2), or with ZeRO-1 reduce-scattered: each replica
updates its 1/dp shard of the weights with an optimizer state that
holds only that shard, and the shards are all-gathered.  Without a
group (one replica) the sum is the identity.  :func:`rank_state` cuts a
whole-model state to what one rank of a process grid holds: its stage's
rows, with ``tensor`` its tensor shard of every sharded leaf
(``models/init.py::tp_axes`` says which dim), and with ``zero1`` its
replica's shard of the optimizer state, cut from the tensor shard.
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
                                 valid: bool, *, group=None) -> None:
    """Per-microbatch update of one stage (paper §3.2), in place: ``dW``
    summed over the stage's data ``group`` (None: one replica), then the
    update.  JAX ``versioning.py::replicated_microbatch_update``."""
    if group is not None:
        tree_map(group.all_reduce_, dW)
    if valid:
        optimizer.update_(dW, opt_state, weights, step)


def zero1_axes(stages, dp: int):
    """Tree of ints over stage-stacked leaves (``[L, ...]``, dim 0 the
    stacked row): the dim each leaf's optimizer state is sharded along
    over ``dp`` replicas, the first dim >= 1 whose size is a multiple of
    ``dp`` and at least ``dp``; -1 for a leaf with none, and for every
    leaf at ``dp <= 1``.  ``stages`` are a rank's own tensor shards, so
    the axis is picked from the local (post-tensor) shape, as JAX's
    ``versioning.py::zero1_axes`` picks it."""
    def pick(a):
        if dp <= 1:
            return -1
        for ax in range(1, len(a.shape)):
            if a.shape[ax] % dp == 0 and a.shape[ax] >= dp:
                return ax
        return -1
    return tree_map(pick, stages)


def row_axes(axes):
    """:func:`zero1_axes` of stacked leaves as dims of one row."""
    return tree_map(lambda ax: ax - 1 if ax > 0 else -1, axes)


def zero1_shard(a, ax: int, index: int, dp: int):
    """Replica ``index``'s 1/dp block of ``a`` (a tensor or a numpy
    array) along ``ax``, a view; all of ``a`` for ``ax < 0``."""
    if ax < 0:
        return a
    size = a.shape[ax] // dp
    return a[(slice(None),) * ax + (slice(index * size, (index + 1) * size),)]


def zero1_microbatch_update(optimizer, dW, opt_state, weights, step,
                            valid: bool, *, axes, group) -> None:
    """One ZeRO-1 update, in place (JAX ``versioning.py::
    zero1_microbatch_update``): ``dW`` reduce-scattered over ``group``
    along ``axes`` (dims of the trees given), this replica's shard of
    ``weights`` updated with ``opt_state`` (which holds that shard only),
    the shards all-gathered back into ``weights``.  A leaf with axis -1
    is summed and updated whole, its state replicated."""
    g = tree_map(lambda t, ax: (group.reduce_scatter(t, ax) if ax >= 0
                                else group.all_reduce_(t)), dW, axes)
    w = tree_map(lambda t, ax: (zero1_shard(t, ax, group.index,
                                            group.size).clone()
                                if ax >= 0 else t), weights, axes)
    if valid:
        optimizer.update_(g, opt_state, w, step)
    tree_map(lambda full, shard, ax: (group.all_gather_(shard, full, ax)
                                      if ax >= 0 else None),
             weights, w, axes)


def rank_rows(sched, s: int) -> slice:
    """The storage rows stage ``s`` holds: ``s·v … s·v + v − 1``."""
    v = sched.virtual_stages
    return slice(s * v, (s + 1) * v)


def tensor_cut(stages, tensor, lead: int = 0):
    """Tensor shard ``t`` of every stage-stacked leaf (views), ``tensor =
    (tp_axes, t, tp)``; ``lead`` extra leading dims (1 for the ``[V, L,
    ...]`` ring).  ``stages`` itself for None."""
    if tensor is None:
        return stages
    axes, t, tp = tensor
    return tree_map(lambda a, ax: zero1_shard(a, ax + lead if ax >= 0
                                              else -1, t, tp),
                    stages, axes)


# The dim of the embedding (Vpad, d) and of the head (d, Vpad) that the
# tensor axis cuts at tp > 1, as JAX's init cuts both: d_model and the
# vocabulary.
TABLE_TP_DIM = 1


def table_leaf(path: str) -> bool:
    """Whether the leaf at ``path`` of a rank's tree ("embed", "head",
    "opt_embed/<slot>", "opt_head/<slot>/h"; a checkpoint's flat key) is
    one of the two tables or an optimizer slot of one: what
    :func:`table_cut` cuts at tp > 1.  The final norm's slots
    ("opt_head/<slot>/f...") stay whole."""
    parts = path.split("/")
    if parts[0] == "opt_head":
        return parts[-1] == "h"
    return parts[0] in ("embed", "head", "opt_embed")


def table_columns(n: int, t: int, tp: int) -> slice:
    """Tensor rank ``t``'s block of a table's ``n`` columns
    (:data:`TABLE_TP_DIM`: d_model of the embedding, the padded
    vocabulary of the head) over ``tp`` ranks."""
    size = n // tp
    return slice(t * size, (t + 1) * size)


def table_cut(a, tensor):
    """Tensor shard ``t`` (a view) of the embedding, the head or an
    optimizer slot of either, ``tensor = (tp_axes, t, tp)``: its block
    of columns (:func:`table_columns`).  ``a`` itself for None."""
    if tensor is None:
        return a
    _, t, tp = tensor
    cols = table_columns(a.shape[TABLE_TP_DIM], t, tp)
    return a[(slice(None),) * TABLE_TP_DIM + (cols,)]


def _cut_tables(tree, tensor, path: str):
    """``tree`` (the leaf or subtree at ``path``) with its table leaves
    (:func:`table_leaf`) cut by :func:`table_cut`; ``tree`` itself for
    ``tensor`` None."""
    if tensor is None:
        return tree
    if isinstance(tree, dict):
        return {k: _cut_tables(v, tensor, f"{path}/{k}")
                for k, v in tree.items()}
    return table_cut(tree, tensor) if table_leaf(path) else tree


def rank_params(params, sched, s: int, *, tensor=None):
    """What stage ``s`` of ``sched`` holds of a whole-model parameter tree
    (torch or numpy leaves, stage rows in storage order): its rows of the
    stacked stages, windows and thetas — with ``tensor = (tp_axes, t,
    tp)`` tensor shard t of them (:func:`tensor_cut`) —; the embedding on
    stage 0; the head and final norm on the last stage (at tp > 1 each
    tensor rank's columns of the two tables, :func:`table_cut`, and the
    whole final norm); the whole encoder on every rank."""
    rows = rank_rows(sched, s)
    out = {"stages": tensor_cut(tree_map(lambda a: a[rows],
                                         params["stages"]), tensor),
           "layer_windows": list(params["layer_windows"][rows]),
           "layer_thetas": list(params["layer_thetas"][rows])}
    if s == 0:
        out["embed"] = _cut_tables(params["embed"], tensor, "embed")
    if s == sched.n_stages - 1:
        out["head"] = _cut_tables(params["head"], tensor, "head")
        out["final_norm"] = params["final_norm"]
    if "encoder" in params:
        out["encoder"] = params["encoder"]
    return out


def rank_state(state, sched, s: int, *, zero1=None, tensor=None):
    """What stage ``s``'s rank holds of a whole-model training state
    (torch or numpy leaves): :func:`rank_params`, its rows of the
    ``[V, L, ...]`` ring, its rows of the stage optimizer state — with
    ``tensor = (tp_axes, t, tp)`` tensor shard t of all three, and with
    ``zero1 = (axes, index, dp)`` only replica ``index``'s shard of the
    optimizer state, ``axes`` the dims of the tensor shard
    (:func:`zero1_axes`) — and the head's / embedding's optimizer states
    where it holds them (of its columns, with ``tensor``)."""
    rows = rank_rows(sched, s)
    params = rank_params(state["params"], sched, s, tensor=tensor)
    stash = {"current": params["stages"]}
    if "ring" in state["stash"]:
        stash["ring"] = tensor_cut(tree_map(lambda a: a[:, rows],
                                            state["stash"]["ring"]),
                                   tensor, lead=1)
    opt = {k: tensor_cut(tree_map(lambda a: a[rows], v), tensor)
           for k, v in state["opt_stages"].items()}
    if zero1 is not None:
        axes, index, dp = zero1
        opt = {k: tree_map(lambda a, ax: zero1_shard(a, ax, index, dp), v,
                           axes) for k, v in opt.items()}
    out = {"params": params, "stash": stash, "opt_stages": opt,
           "step": state["step"]}
    for key, table in (("opt_head", "head"), ("opt_embed", "embed")):
        if table in params:
            out[key] = _cut_tables(state[key], tensor, key)
    if "encoder" in params:
        out["opt_encoder"] = state["opt_encoder"]
    return out


def make_train_state(params, sched, optimizer, *, zero1=None):
    """The training state JAX's ``init_state`` builds from ``params``
    (stage rows already in storage order): ``stash["current"]`` is
    ``params["stages"]`` itself (one set of tensors), ``stash["ring"]``
    a ``[V, L, ...]`` copy of it when the schedule keeps a ring (chunk-
    major for ``interleaved_async``: L = S·v storage rows), the
    optimizer states of the stages, of head + final norm, of the
    embedding and of the encoder (where the model has one), and the
    round counter.  ``params`` may be one rank's
    (:func:`rank_params`): the head's and the embedding's states exist
    where those do, and with ``zero1 = (axes, index, dp)`` the stage
    optimizer state covers replica ``index``'s shard only."""
    stages = params["stages"]
    stash = {"current": stages}
    if sched.uses_stash_ring:
        V = sched.stash_slots
        stash["ring"] = tree_map(
            lambda a: a[None].expand((V,) + tuple(a.shape)).clone(), stages)
    shards = stages
    if zero1 is not None:
        axes, index, dp = zero1
        shards = tree_map(lambda a, ax: zero1_shard(a, ax, index, dp),
                          stages, axes)
    state = {"params": params, "stash": stash,
             "opt_stages": optimizer.init(shards), "step": 0}
    if "head" in params:
        state["opt_head"] = optimizer.init({"h": params["head"],
                                            "f": params["final_norm"]})
    if "embed" in params:
        state["opt_embed"] = optimizer.init(params["embed"])
    if "encoder" in params:
        state["opt_encoder"] = optimizer.init(params["encoder"])
    return state
