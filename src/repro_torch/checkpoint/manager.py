"""Per-stage local checkpointing (paper §4, "Checkpointing"; port of
``repro/checkpoint/manager.py``).

The paper: "Checkpoints don't require expensive global coordination; each
stage locally decides to dump its model parameters … Restarting entails
starting from the last epoch successfully checkpointed by all stages."

Layout on disk (the JAX package's, leaf keys included, so a checkpoint
written by either package restores in the other):
    <dir>/round_<n>/stage_<s>.npz     one file per stage-stacked row
    <dir>/round_<n>/shared.npz        embed / head / final_norm / windows
    <dir>/round_<n>/opt.npz           optimizer + stash ring + step
    <dir>/round_<n>/MANIFEST.json     {"round": n, "stages": [...], "done": bool}

npz has no bfloat16 or float8: those leaves are written as their
``uint16`` / ``uint8`` payload and viewed back through the restore
template, which knows the true dtype.  ``step`` is written as an int32
scalar and the per-layer windows / thetas as int32 / float32 arrays, as
JAX holds them.

``latest_complete_round`` scans manifests and returns the newest round for
which every stage file landed — a stage failure mid-dump leaves an
incomplete manifest that restart skips, exactly the paper's semantics.

With a process grid (``CheckpointManager(dir, grid=)``, a
:class:`~repro_torch.parallel.dist.RankGrid`) every rank holds its
stage's rows only, and the layout stays the same.  Without one the
manager is that of a grid of one rank that holds every row, so one
process and a grid share one save and one restore:

  * replica 0 of each stage writes its own ``stage_<row>.npz`` files, as
    the paper's stages dump locally;
  * the ranks agree (the rows each wrote, gathered over the world) that
    every row landed; a rank that failed or stopped short leaves the
    round not done, and every rank returns (the failing one raises);
  * ``shared.npz`` and ``opt.npz`` are written by rank 0 from every
    stage's rows, leaf by leaf: each piece (a stage's rows of one leaf,
    or of one version slot of the ring) is sent to rank 0 and streamed
    into the file's zip member, so rank 0 holds one piece of another
    rank at a time.  Under ZeRO-1 a stage's replicas first all-gather
    its optimizer rows over their data group.  A write of rank 0 that
    fails skips the rest and is agreed on like a stage's;
  * rank 0 marks the manifest done once every rank has said that its
    files landed, and every rank returns after a barrier, so each sees
    the round done.

The save's collectives run on ``RankGrid.ckpt_group``, whose timeout is
the checkpoint's (``parallel/dist.py::CKPT_TIMEOUT_S``), not
the grid's: the ranks that have nothing more to send wait there while
rank 0 writes.

``restore`` reads this rank's ``stage_<row>.npz`` files and
only its keys and rows of ``shared.npz`` / ``opt.npz`` (seeking to the
rows inside the uncompressed members); a ZeRO-1 replica keeps its shard.
A checkpoint written by ranks restores in one process, and the reverse.

On a grid with tensor ranks (``tp`` > 1; the manager then needs the
model's ``spec`` to know which dim each leaf is cut along,
``models/init.py::tp_axes``) the files keep the same full layout: before
a stage's row, or a piece of a stage-stacked leaf, leaves its stage, the
tensor ranks of replica 0 send their shards to tensor rank 0, which
joins them (after the data group's ZeRO-1 gather) and does what replica
0 does at tp 1.  The embedding and the head, and their optimizer
slots, cut over the tensor group of the first and last stage
(``models/lm_head.py``), are joined the same way on that group's rank 0
before it sends them to rank 0.  On restore each rank reads the full
rows (and the full tables) and keeps its tensor shard.  So a checkpoint
written at one tp restores at any other (tp 2 at tp 1 and back, bit for
bit).

``reshard_stages`` re-groups stage-stacked leaves when the pipeline depth
changes (elastic scaling): parameters are keyed by global layer index, so
moving stage boundaries is a pure reshape.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.versioning import TABLE_TP_DIM, table_leaf, zero1_shard
from repro_torch.models.init import tp_dim
from repro_torch.optim.optimizers import tree_map
from repro_torch.parallel.dist import ProcessGrid

# torch dtypes npz cannot hold -> (torch and numpy integer types of the
# same width, the unsigned type written to disk, as the JAX package does)
_PAYLOAD = {torch.bfloat16: (torch.int16, np.int16, np.uint16),
            torch.float8_e4m3fn: (torch.uint8, np.uint8, np.uint8),
            torch.float8_e5m2: (torch.uint8, np.uint8, np.uint8)}
# host-list leaves of the port's params (JAX holds them as arrays)
_LIST_DTYPES = {"layer_windows": np.int32, "layer_thetas": np.float32}


def _disk_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a tensor of ``dtype`` is written as."""
    if dtype in _PAYLOAD:
        return np.dtype(_PAYLOAD[dtype][2])
    return torch.empty(0, dtype=dtype).numpy().dtype


def _to_numpy(key: str, leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype in _PAYLOAD:
            as_int, _, on_disk = _PAYLOAD[t.dtype]
            return t.view(as_int).cpu().numpy().view(on_disk)
        return t.cpu().numpy()
    if key in _LIST_DTYPES:
        return np.asarray(leaf, _LIST_DTYPES[key])
    return np.asarray(leaf, np.int32)                  # step


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = _to_numpy(k, v)
    return out


def _restore_leaf(key: str, template, arr: np.ndarray):
    """The checkpoint's value for one leaf: copied into the template
    tensor in place (returned), or a host value for the per-layer lists
    and ``step``."""
    if torch.is_tensor(template):
        arr = np.ascontiguousarray(arr)
        dst = template
        if template.dtype in _PAYLOAD:
            # reinterpret the payload's bits: a cast would convert them
            as_int, np_int, _ = _PAYLOAD[template.dtype]
            arr, dst = arr.view(np_int), template.view(as_int)
        dst.copy_(torch.from_numpy(arr).reshape(template.shape))
        return template
    if key in _LIST_DTYPES:
        return np.asarray(arr).tolist()
    return int(arr)                                    # step


def _restore_into(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    for k, v in list(template.items()):
        if isinstance(v, dict):
            _restore_into(v, flat, f"{prefix}{k}/")
        else:
            template[k] = _restore_leaf(k, v, flat[f"{prefix}{k}"])


def _leaves(tree, prefix: str = ""):
    """(flat key, leaf) of a tree, in its order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _row_axis(key: str) -> Optional[int]:
    """The axis along which ``key``'s leaf holds the storage rows: 1 for
    the ``[V, L, ...]`` ring, 0 for the other stage-stacked leaves and
    the per-layer lists, None for a leaf one stage holds whole."""
    if key.startswith("stash/ring/"):
        return 1
    if key.startswith(("stash/current/", "opt_stages/", "layer_windows",
                       "layer_thetas")):
        return 0
    return None


def _files(state) -> Dict[str, Dict[str, Any]]:
    """The leaves of ``shared.npz`` and ``opt.npz``, by flat key."""
    return {"shared.npz": dict(_leaves({k: v for k, v in
                                        state["params"].items()
                                        if k != "stages"})),
            "opt.npz": dict(_leaves({k: v for k, v in state.items()
                                     if k != "params"}))}


def _full_rows(key: str, state):
    """The stage's rows of ``key``'s leaf as the rank would hold them
    without ZeRO-1: an optimizer slot's shape is its weight's."""
    if key.startswith("opt_stages/"):
        path = key.split("/", 2)[2]
        return dict(_leaves(state["params"]["stages"]))[path]
    return None


def _tp_key_dim(key: str, spec, tp: int) -> int:
    """The dim of ``key``'s leaf (as the files hold it) that the tensor
    axis cuts, -1 for none: a stage-stacked leaf's own dim, one more in
    the ``[V, L, ...]`` ring; the tables' columns."""
    if tp == 1:
        return -1
    if _row_axis(key) is None:
        return TABLE_TP_DIM if table_leaf(key) else -1
    parts = key.split("/")
    lead = 2 if key.startswith(("stash/", "opt_stages/")) else 0
    layer = parts[lead:]               # layer_i / block[/ block] / leaf
    if len(layer) < 3:
        return -1
    ax = tp_dim("/".join(layer[1:-1]), layer[-1], spec, tp)
    return ax + (1 if key.startswith("stash/ring/") else 0) if ax >= 0 else -1


def _shard_axis(local_shape, full_shape) -> int:
    """The axis a ZeRO-1 shard is cut along: where its shape differs
    from the full rows' (-1 for none)."""
    diff = [i for i, (a, b) in enumerate(zip(local_shape, full_shape))
            if a != b]
    return diff[0] if diff else -1


class _Files:
    """Rank 0's ``shared.npz`` and ``opt.npz`` of a save, written member
    by member, each member piece by piece: the header for the whole
    array, then each piece's bytes in C order.  The first write that
    fails (a full disk) is kept in ``err`` and every later one is
    skipped, so rank 0 goes on receiving its peers' pieces and the save
    ends on every rank, not done."""

    def __init__(self, d: str, names):
        self.err, self.zfs, self.f = None, {}, None
        for name in names:
            self._do(lambda: self.zfs.__setitem__(name, zipfile.ZipFile(
                os.path.join(d, name), "w", zipfile.ZIP_STORED,
                allowZip64=True)))

    def _do(self, fn) -> None:
        if self.err is None:
            try:
                fn()
            except Exception as e:      # agreed on by the save, re-raised
                self.err = e

    def begin(self, name: str, key: str, shape, dtype) -> None:
        def go():
            self.f = self.zfs[name].open(f"{key}.npy", "w", force_zip64=True)
            np.lib.format.write_array_header_1_0(self.f, {
                "descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
                "fortran_order": False, "shape": tuple(shape)})
        self._do(go)

    def write(self, arr: np.ndarray) -> None:
        self._do(lambda: self.f.write(np.ascontiguousarray(arr).data))

    def end(self) -> None:
        self._do(lambda: self.f.close())

    def close(self) -> None:
        for zf in self.zfs.values():
            try:
                zf.close()
            except Exception as e:
                self.err = self.err or e


def _read_rows(zf: zipfile.ZipFile, key: str, axis: int, start: int,
               count: int) -> np.ndarray:
    """Rows ``start … start + count − 1`` along ``axis`` of an npz
    member, read by seeking inside the (uncompressed) member."""
    with zf.open(f"{key}.npy") as f:
        version = np.lib.format.read_magic(f)
        read = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}[version]
        shape, fortran, dtype = read(f)
        if fortran:
            raise ValueError(f"{key}: Fortran-ordered member")
        base = f.tell()
        row = int(np.prod(shape[axis + 1:], dtype=np.int64)) * dtype.itemsize
        lead = int(np.prod(shape[:axis], dtype=np.int64))
        out = []
        for i in range(lead):
            f.seek(base + (i * shape[axis] + start) * row)
            out.append(np.frombuffer(f.read(count * row), dtype=dtype))
    return np.concatenate(out).reshape(tuple(shape[:axis]) + (count,)
                                       + tuple(shape[axis + 1:]))


class _OneProcess:
    """The grid of a manager without one: a single rank of a single stage
    that holds every row, its collectives returning at once."""
    rank = d = s = t = 0
    topo = ProcessGrid(1, 1)
    data_group = tensor_group = None

    @property
    def ckpt_group(self):
        return self

    def barrier(self) -> None:
        pass

    def any_flag(self, flag: bool) -> bool:
        return bool(flag)

    def all_gather_floats(self, values):
        return [list(values)]

    def all_gather_object(self, obj):
        return [obj]

    def gather_to_root(self, t, src, shape, dtype):
        return t


class CheckpointManager:
    def __init__(self, directory: str, grid=None, spec=None):
        self.dir = directory
        self.grid = grid if grid is not None else _OneProcess()
        self.tp = self.grid.topo.tp
        if self.tp > 1 and spec is None:
            raise ValueError(f"a grid of tp={self.tp}: the manager needs the "
                             "model's spec to join and cut tensor shards")
        self.spec = spec
        os.makedirs(directory, exist_ok=True)

    def _tp_join(self, key: str, t: torch.Tensor):
        """Tensor rank 0's whole ``key`` leaf from the shards of this
        rank's tensor group (each rank's ``t``; None on the other ranks,
        ``t`` itself for a leaf every rank holds whole)."""
        ax = _tp_key_dim(key, self.spec, self.tp)
        if ax < 0:
            return t
        g = self.grid
        grp = g.tensor_group
        pieces = [grp.gather_to_root(t if g.rank == src else None, src,
                                     t.shape, t.dtype)
                  for src in grp.ranks]
        if g.t:
            return None
        return torch.cat([p.cpu() for p in pieces], dim=ax)

    def _tp_cut(self, key: str, arr: np.ndarray) -> np.ndarray:
        """This rank's tensor shard of the whole ``key`` leaf ``arr``."""
        ax = _tp_key_dim(key, self.spec, self.tp)
        return arr if ax < 0 else zero1_shard(arr, ax, self.grid.t, self.tp)

    def _round_dir(self, rnd: int) -> str:
        return os.path.join(self.dir, f"round_{rnd:08d}")

    @staticmethod
    def _write_manifest(d: str, manifest: Dict[str, Any]):
        """Atomic manifest update: tmp file + os.replace, so a crash
        mid-write leaves either the previous manifest or none — never a
        truncated JSON that poisons every later restart scan."""
        tmp = os.path.join(d, "MANIFEST.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(d, "MANIFEST.json"))

    # ---------------- save ------------------------------------------------

    def save(self, rnd: int, state: Dict[str, Any], n_stages: int,
             fail_after_stage: Optional[int] = None):
        """Per-stage dump: ``stage_<row>.npz`` holds one storage row of
        every stage-stacked leaf, so ``n_stages`` is the number of rows
        (S·v chunks for a virtual-stage plan).  ``fail_after_stage``
        simulates a crash mid-save (used by the fault-tolerance tests):
        rows > that index are not written and the manifest stays
        incomplete.  With a grid every rank calls it with its own state
        (module docstring).  A rank whose write raised re-raises once
        every rank has returned; the others return, the round not
        done."""
        g = self.grid
        c = g.ckpt_group
        S = g.topo.pp
        v = n_stages // S
        d = self._round_dir(rnd)
        os.makedirs(d, exist_ok=True)
        if g.rank == 0:
            self._write_manifest(d, {"round": rnd, "stages": [],
                                     "n_stages": n_stages, "done": False})
        # 1. each stage's rows, by its replica 0 (its tensor rank 0, which
        # joins the tensor ranks' shards first)
        written, err = 0, None
        if g.d == 0:
            try:
                stages = state["params"]["stages"]
                for j in range(v):
                    row = g.s * v + j
                    if fail_after_stage is not None and row > fail_after_stage:
                        break
                    part = {f"stash/current/{k}": self._tp_join(
                        f"stash/current/{k}", a[j:j + 1])
                        for k, a in _leaves(stages)}
                    if g.t == 0:
                        np.savez(os.path.join(d, f"stage_{row}.npz"),
                                 **{k.split("/", 2)[2]: _to_numpy(k, a)
                                    for k, a in part.items()})
                        written += 1
            except Exception as e:      # agreed on below, then re-raised
                err = e
        counts = c.all_gather_floats([written])
        landed = [s * v + j for s in range(S)
                  for j in range(int(counts[g.topo.rank_of(0, s)][0]))]
        if g.rank == 0:
            self._write_manifest(d, {"round": rnd, "stages": landed,
                                     "n_stages": n_stages, "done": False})
        if len(landed) < n_stages:
            # every rank returns once the manifest says what landed
            c.barrier()
            if err is not None:
                raise err
            return
        # 2. shared.npz and opt.npz on rank 0, piece by piece
        files = _files(state)
        meta = {}          # (file, key) -> (rows shape, dtype, host value)
        for name, leaves in files.items():
            for key, leaf in leaves.items():
                if torch.is_tensor(leaf):
                    full = _full_rows(key, state)
                    shape = list((full if full is not None else leaf).shape)
                    ax = _tp_key_dim(key, self.spec, self.tp)
                    if ax >= 0 and _row_axis(key) is None and g.t:
                        # a table's slice: its tensor rank 0 joins them
                        continue
                    if ax >= 0:
                        shape[ax] *= self.tp
                    meta[name, key] = (tuple(shape), leaf.dtype, None)
                else:
                    host = _to_numpy(key.rsplit("/", 1)[-1], leaf)
                    meta[name, key] = (host.shape, host.dtype, host)
        every = c.all_gather_object(meta)
        out = _Files(d, files) if g.rank == 0 else None
        try:
            keys = []
            for m in every:
                keys += [k for k in m if k not in keys]
            for name, key in keys:
                self._gather_leaf(every, out, name, key,
                                  files[name].get(key), state)
        finally:
            if out is not None:
                out.close()
        # 3. done once every rank's files have landed and rank 0's wrote
        failed = c.any_flag(out is not None and out.err is not None)
        if g.rank == 0 and not failed:
            self._write_manifest(d, {"round": rnd, "stages": landed,
                                     "n_stages": n_stages, "done": True})
        c.barrier()
        if failed and out is not None:
            raise out.err

    def _gather_leaf(self, every, out, name, key, leaf, state):
        """One leaf of ``name`` into rank 0's files ``out``: a host value
        from the metadata; a leaf one stage holds whole from its lowest
        rank; a stage-stacked leaf stage by stage (version slot by slot
        for the ring), ZeRO-1 shards all-gathered over the data group
        first, then tensor shards joined on tensor rank 0 (a table's
        slices too, on the stage's replica 0)."""
        g = self.grid
        owners = [r for r, m in enumerate(every) if (name, key) in m]
        shape, dt, host = every[owners[0]][name, key]
        axis = _row_axis(key)
        if host is not None and axis is None:
            if out is not None:
                out.begin(name, key, host.shape, host.dtype)
                out.write(host)
                out.end()
            return
        if axis is None:
            full_shape, srcs, lead = shape, [owners[0]], [()]
            if (leaf is not None and g.d == 0
                    and _tp_key_dim(key, self.spec, self.tp) >= 0):
                # the tensor group's slices of a table (its owner is
                # the group's rank 0, which lists the joined shape)
                leaf = self._tp_join(key, leaf)
        else:
            S = g.topo.pp
            full_shape = (shape[:axis] + (shape[axis] * S,)
                          + shape[axis + 1:])
            # replica 0 (tensor rank 0) of each stage
            srcs = [g.topo.rank_of(0, s) for s in range(S)]
            lead = list(np.ndindex(*shape[:axis]))
        if out is not None:
            out.begin(name, key, full_shape, dt if host is not None
                      else _disk_dtype(dt))
        mine = leaf
        if leaf is not None and axis is not None and host is None:
            rows = _full_rows(key, state)
            ax = -1 if rows is None else _shard_axis(leaf.shape, rows.shape)
            if ax >= 0:
                # the stage's replicas hold 1/dp shards: gather the rows
                mine = torch.empty(rows.shape, dtype=leaf.dtype,
                                   device=leaf.device)
                g.data_group.all_gather_(leaf, mine, ax)
            if g.d == 0:
                mine = self._tp_join(key, mine)
        for idx in lead:
            for src in srcs:
                if host is not None:
                    piece = every[src][name, key][2][idx]
                else:
                    piece = g.ckpt_group.gather_to_root(
                        mine[idx] if g.rank == src else None, src,
                        shape[len(idx):], dt)
                if out is not None:
                    out.write(piece if host is not None
                              else _to_numpy(key, piece))
        if out is not None:
            out.end()

    # ---------------- restore --------------------------------------------

    def latest_complete_round(self) -> Optional[int]:
        best = None
        for name in os.listdir(self.dir):
            mf = os.path.join(self.dir, name, "MANIFEST.json")
            if not os.path.exists(mf):
                continue
            try:
                with open(mf) as f:
                    m = json.load(f)
            except (OSError, ValueError):
                # a truncated / corrupt manifest: the round is incomplete
                continue
            if isinstance(m, dict) and m.get("done"):
                best = max(best or -1, m["round"])
        return best

    def restore(self, rnd: int, state: Dict[str, Any]) -> Dict[str, Any]:
        """Overwrite ``state`` with round ``rnd``: every tensor is copied
        into in place (so a state left half-updated by a failed round is
        wholly replaced, and no second copy is allocated), ``step`` and
        the per-layer lists are replaced.  ``stash["current"]`` stays
        the very ``params["stages"]`` tensors.  Returns ``state``.  With
        a grid ``state`` is this rank's and only its rows are read."""
        g = self.grid
        d = self._round_dir(rnd)
        v = len(state["params"]["layer_windows"])
        start = g.s * v
        parts = [dict(np.load(os.path.join(d, f"stage_{start + j}.npz")))
                 for j in range(v)]
        _restore_into(state["params"]["stages"],
                      {k: self._tp_cut(f"stash/current/{k}", np.concatenate(
                          [p[k] for p in parts], axis=0))
                       for k in parts[0]})
        del parts
        for name, leaves in _files(state).items():
            with zipfile.ZipFile(os.path.join(d, name)) as zf:
                flat = {}
                for key, leaf in leaves.items():
                    if key.startswith("stash/current/"):
                        continue            # params["stages"], done above
                    axis = _row_axis(key)
                    if axis is None:
                        with zf.open(f"{key}.npy") as f:
                            flat[key] = self._tp_cut(
                                key, np.lib.format.read_array(f))
                        continue
                    arr = self._tp_cut(key, _read_rows(zf, key, axis, start,
                                                       v))
                    if torch.is_tensor(leaf):
                        ax = _shard_axis(leaf.shape, arr.shape)
                        if ax >= 0:         # this replica's ZeRO-1 shard
                            arr = zero1_shard(arr, ax, g.data_group.index,
                                              arr.shape[ax] // leaf.shape[ax])
                    flat[key] = arr
            if name == "shared.npz":
                params = {k: v for k, v in state["params"].items()
                          if k != "stages"}
                _restore_into(params, flat)
                state["params"].update(params)
            else:
                others = {k: v for k, v in state.items()
                          if k not in ("params", "stash")}
                if "ring" in state["stash"]:
                    others["stash"] = {"ring": state["stash"]["ring"]}
                _restore_into(others, flat)
                others.pop("stash", None)
                state.update(others)
        state["stash"]["current"] = state["params"]["stages"]
        return state

# --------------------------------------------------------------------------
# Elastic resharding: move stage boundaries (pp -> pp')
# --------------------------------------------------------------------------

def reshard_stages(stages_tree: Dict[str, Any], old_pp: int, new_pp: int
                   ) -> Dict[str, Any]:
    """Re-group per-(stage, position) leaves for a new pipeline depth.

    Old layout: stages['layer_i'][leaf] has shape [old_pp, ...], holding
    global layer (s*lps_old + i).  New layout must satisfy
    n_layers % new_pp == 0 and the stage-program pattern must still align
    (validated by the caller via spec.stage_program(new_pp)).
    """
    lps_old = len(stages_tree)
    n_layers = lps_old * old_pp
    assert n_layers % new_pp == 0, (n_layers, new_pp)
    lps_new = n_layers // new_pp
    out: Dict[str, Any] = {}
    for i_new in range(lps_new):
        per_stage = []
        for s_new in range(new_pp):
            s_old, i_old = divmod(s_new * lps_new + i_new, lps_old)
            per_stage.append(tree_map(lambda a: a[s_old],
                                      stages_tree[f"layer_{i_old}"]))
        out[f"layer_{i_new}"] = tree_map(lambda *xs: torch.stack(xs),
                                         *per_stage)
    return out
