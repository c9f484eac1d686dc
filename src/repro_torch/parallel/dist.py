"""The process grid of multi-rank training over ``torch.distributed``
(counterpart of ``repro/parallel/mesh.py``'s ``(data, stage, tensor)``
axes and ``repro/launch/mesh.py::make_host_mesh``).

One process per rank.  :class:`ProcessGrid` is the topology alone:
``data`` replicas of a ``pp``-stage pipeline whose stages are each cut
over ``tp`` tensor ranks, rank ``(d·pp + s)·tp + t`` (data-major, tensor
innermost, as JAX's ``split_model_axis`` reshapes the model axis into
``(stage, tensor)``), the data group of each (stage, tensor index), the
tensor group of each (replica, stage) and each rank's neighbours.
:func:`init_grid` joins the process group and returns this rank's
:class:`RankGrid`: its place in the grid, its device, its data and
tensor :class:`Group` and the transport that every hand-off and
collective goes through.

The tensor group's collectives inside a stage are autograd functions
(:func:`tp_exit`, :func:`tp_enter`, :func:`tp_all_gather`, the
counterparts of JAX's ``maybe_psum`` and of the all-gather of its MoE
combine), no-ops without a group.  Their backward is the sum's true
transpose for a stage whose output every tensor rank holds whole: an
exit's cotangent is the same on every rank and passes through; an
entry's is each rank's share and is summed.

The backend is the caller's choice.  NCCL takes tensors on the card and
needs a card per rank (it refuses two ranks on one device).  gloo takes
host tensors only, so under gloo every p2p and every collective on a
CUDA tensor is staged through host memory in one place,
:meth:`RankGrid._transport`, which counts the bytes it stages: p2p
moves copy bf16 / fp16 as their int16 bits, exact whatever gloo
supports; collectives (gloo's take no int16) take them to f32 on the
host: exact for a gather or a max, one rounding for a sum.  That
mode lets several ranks share one card.  Every process group has a
timeout, so a rank that dies makes the others raise instead of waiting
forever.

Launch: ``torchrun --nproc-per-node N`` sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` (and ``MASTER_ADDR`` / ``MASTER_PORT``), which
:func:`init_grid` reads when the caller passes none.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: seconds a rank waits on a peer before its process group raises
DEFAULT_TIMEOUT_S = 60.0
#: seconds a rank waits in a checkpoint's collectives (``RankGrid.
#: ckpt_group``): rank 0 writes ``shared.npz`` and ``opt.npz`` while its
#: peers wait, so the wait scales with the state's bytes: ~1.2 TB at the
#: 0.7 GB/s one process saved at on an H100 machine (PERF.md §6)
CKPT_TIMEOUT_S = 1800.0


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    """``data`` replicas × ``pp`` pipeline stages × ``tp`` tensor ranks a
    stage, rank = (d·pp + s)·tp + t."""

    data: int
    pp: int
    tp: int = 1

    def __post_init__(self):
        if self.data < 1 or self.pp < 1 or self.tp < 1:
            raise ValueError(f"grid ({self.data}, {self.pp}, {self.tp}): "
                             "every axis must be at least 1")

    @property
    def world(self) -> int:
        return self.data * self.pp * self.tp

    def rank_of(self, d: int, s: int, t: int = 0) -> int:
        return (d * self.pp + s) * self.tp + t

    def coords(self, rank: int) -> Tuple[int, int, int]:
        """(replica d, stage s, tensor index t) of ``rank``."""
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside a world of {self.world}")
        ds, t = divmod(rank, self.tp)
        return (*divmod(ds, self.pp), t)

    def data_group_ranks(self, s: int, t: int = 0) -> List[int]:
        """The ranks holding tensor shard ``t`` of stage ``s``, one per
        replica, in replica order: the group its gradients are summed
        over."""
        return [self.rank_of(d, s, t) for d in range(self.data)]

    def tensor_group_ranks(self, d: int, s: int) -> List[int]:
        """The ranks that cut stage ``s`` of replica ``d`` among
        themselves, in tensor order."""
        return [self.rank_of(d, s, t) for t in range(self.tp)]

    def pipe_group_ranks(self, d: int, t: int = 0) -> List[int]:
        """The ranks of replica ``d``'s stages at tensor index ``t``, in
        stage order: the group that meets the stages' shares of the
        encoder output's cotangent."""
        return [self.rank_of(d, s, t) for s in range(self.pp)]

    def downstream(self, rank: int, wrap: bool = False) -> Optional[int]:
        """The rank of the next stage of ``rank``'s replica at the same
        tensor index (each tensor rank hands its copy of the activation
        on, as JAX's stage ``ppermute`` does once for each tensor index);
        the last stage hands to stage 0 with ``wrap`` (virtual stages),
        else None."""
        d, s, t = self.coords(rank)
        if s + 1 < self.pp:
            return self.rank_of(d, s + 1, t)
        return self.rank_of(d, 0, t) if wrap else None

    def upstream(self, rank: int, wrap: bool = False) -> Optional[int]:
        """The rank of the previous stage of ``rank``'s replica at the
        same tensor index; stage 0 takes from the last stage with
        ``wrap``, else None."""
        d, s, t = self.coords(rank)
        if s > 0:
            return self.rank_of(d, s - 1, t)
        return self.rank_of(d, self.pp - 1, t) if wrap else None


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def _host_dtype(dtype: torch.dtype, collective: bool) -> torch.dtype:
    """What gloo gets for ``dtype``: half precision as f32 for a
    collective (gloo's take no int16; f32 holds every half value, so
    only a sum rounds, once, back on the card) and as its int16 bits for
    a point-to-point move."""
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32 if collective else torch.int16
    return dtype


def _host(t: torch.Tensor, collective: bool) -> torch.Tensor:
    dtype = _host_dtype(t.dtype, collective)
    if dtype == torch.int16 and t.dtype != torch.int16:
        return t.view(torch.int16).cpu()
    return t.to(device="cpu", dtype=dtype)


class Group:
    """Ranks of the grid that sum or shard a tensor among themselves (a
    stage's data replicas, a stage's tensor ranks, or the whole world),
    in rank order; every call goes through the grid's transport.  The
    tensor group's calls are counted apart (``TransportStats.tensor_*``):
    calls, bytes and host seconds, and so are the data group's
    (``data_*``: under sequence-parallel decode, its softmax sums)."""

    def __init__(self, grid: "RankGrid", ranks: Sequence[int], pg,
                 kind: str = "data"):
        self.grid, self.ranks, self.pg = grid, list(ranks), pg
        self.size = len(self.ranks)
        self.index = self.ranks.index(grid.rank)   # this rank's position
        self.kind = kind

    def _count(self, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        stats = self.grid.stats
        if self.kind == "tensor":
            stats.tensor_calls += 1
            stats.tensor_bytes += n
            return
        stats.collective_bytes += n
        if self.kind == "data":
            stats.data_calls += 1
            stats.data_bytes += n

    def _run(self, run, reads, writes, *, collective: bool) -> None:
        """``grid._transport``, timed into ``stats.tensor_s`` /
        ``stats.data_s`` for the tensor / data group (host seconds from
        the call to its return)."""
        t0 = time.perf_counter()
        self.grid._transport(run, reads, writes, collective=collective)
        if self.kind in ("tensor", "data"):
            dt = time.perf_counter() - t0
            if self.kind == "tensor":
                self.grid.stats.tensor_s += dt
            else:
                self.grid.stats.data_s += dt

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or with ``op="max"`` the elementwise max of) ``t`` over
        the group, in place; returns ``t``.  A group of one rank has no
        process group and returns at once; the world's always calls the
        backend."""
        if self.pg is not None:
            rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
            self._count(t)
            self._run(lambda x, y: dist.all_reduce(x[0], op=rop,
                                                   group=self.pg),
                      [t], [t], collective=True)
        return t

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's 1/size block along ``dim`` of the sum of ``t`` over
        the group (contiguous)."""
        if self.size == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        out = torch.empty((x.shape[0] // self.size,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        self._count(x)
        self._run(lambda a, b: dist.reduce_scatter_tensor(b[0], a[0],
                                                          group=self.pg),
                  [x], [out], collective=True)
        return out.movedim(0, dim).contiguous()

    def all_gather_(self, shard: torch.Tensor, out: torch.Tensor,
                    dim: int) -> None:
        """Write every rank's ``shard`` into its block of ``out`` along
        ``dim``, in rank order."""
        if self.size == 1:
            out.copy_(shard)
            return
        x = shard.movedim(dim, 0).contiguous()
        full = torch.empty((x.shape[0] * self.size,) + tuple(x.shape[1:]),
                           dtype=x.dtype, device=x.device)
        self._count(x)
        self._run(lambda a, b: dist.all_gather_into_tensor(b[0], a[0],
                                                           group=self.pg),
                  [x], [full], collective=True)
        out.copy_(full.movedim(0, dim))

    def broadcast_(self, t: torch.Tensor, root: int) -> torch.Tensor:
        """Overwrite ``t`` in place with the group member ``root``'s (an
        index into the group's ranks), on every rank; returns ``t``.  A
        group of one rank returns at once.  Serving broadcasts a round's
        sampled tokens from the last stage over the pipe group."""
        if self.pg is not None:
            src = self.ranks[root]
            self._count(t)
            self._run(lambda x, y: dist.broadcast(x[0], src, group=self.pg),
                      [t], [t], collective=True)
        return t

    # ---- the small collectives of checkpoints and telemetry, on a group
    # ---- that spans the world (its first rank is the root) -------------

    def barrier(self) -> None:
        """Return once every rank of the group has called it (a sum, so
        it has the group's timeout)."""
        self.all_reduce_(torch.zeros(1, device=self.grid.device))

    def any_flag(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank of the group."""
        t = torch.tensor([1.0 if flag else 0.0], device=self.grid.device)
        return bool(self.all_reduce_(t).item() > 0)

    def all_gather_floats(self, values: Sequence[float]) -> List[List[float]]:
        """Every rank's ``values`` (the same length on every rank), in
        rank order."""
        x = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=self.grid.device)
        full = torch.empty(self.size * x.numel(), dtype=x.dtype,
                           device=x.device)
        self._count(x)
        self.grid._transport(
            lambda a, b: dist.all_gather_into_tensor(b[0], a[0],
                                                     group=self.pg),
            [x], [full], collective=True)
        return full.view(self.size, -1).tolist()

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order (small
        metadata)."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.pg)
        return out

    def gather_to_root(self, t: Optional[torch.Tensor], src: int, shape,
                       dtype: torch.dtype) -> Optional[torch.Tensor]:
        """Rank ``src``'s tensor ``t`` (of ``shape`` and ``dtype``) on the
        root: the root gets it (on the host under gloo, else on its
        device), every other rank None.  A point-to-point send, so a rank
        that never sends makes the root raise after the group's timeout;
        under gloo half precision moves as its int16 bits."""
        g, root = self.grid, self.ranks[0]
        if g.rank == src == root:
            return t
        if g.rank not in (src, root):
            return None
        wire = _host_dtype(dtype, collective=False) if g.stage_host else dtype
        if g.rank == src:
            x = t.contiguous()
            x = x.view(wire) if wire != x.dtype else x
            g._transport(lambda a, b: dist.send(a[0], root, group=self.pg),
                         [x], [], collective=False)
            return None
        buf = torch.empty(tuple(shape), dtype=wire, device=(
            "cpu" if g.stage_host else g.device))
        g._transport(lambda a, b: dist.recv(b[0], src, group=self.pg),
                     [], [buf], collective=False)
        return buf.view(dtype) if wire != dtype else buf


@dataclasses.dataclass
class TransportStats:
    """What the transport moved since the counters were last zeroed."""

    handoff_bytes: int = 0      # p2p bytes this rank sent
    handoff_s: float = 0.0      # host seconds in hand-offs (post to done)
    collective_bytes: int = 0   # bytes this rank put into data / world
                                # collectives
    staged_bytes: int = 0       # bytes copied card <-> host for gloo
    tensor_calls: int = 0       # the tensor group's collectives
    tensor_bytes: int = 0       # bytes this rank put into them
    tensor_s: float = 0.0       # host seconds in them
    data_calls: int = 0         # the data group's collectives
    data_bytes: int = 0         # bytes this rank put into them
    data_s: float = 0.0         # host seconds in them


class RankGrid:
    """This rank's place in a :class:`ProcessGrid`: its coordinates, its
    device, its data group (the replicas of its stage's tensor shard),
    its tensor group (the ranks that cut its stage), its pipe group (its
    replica's stages at its tensor index) and the transport (p2p
    hand-offs and collectives).  Built by :func:`init_grid`.

    ``world_group`` and ``ckpt_group`` both span the world: the first
    has the grid's timeout, the second the checkpoint's, for the waits
    of a save (``checkpoint/manager.py``)."""

    def __init__(self, topo: ProcessGrid, rank: int, backend: str,
                 device: torch.device, device_policy: str,
                 data_groups: List, tensor_groups: List, world_pg, ckpt_pg,
                 pipe_groups: Optional[List] = None):
        self.topo, self.rank, self.backend = topo, rank, backend
        self.device, self.device_policy = device, device_policy
        self.d, self.s, self.t = topo.coords(rank)
        self.stats = TransportStats()
        # gloo takes host tensors only
        self.stage_host = backend == "gloo"
        self.data_group = Group(self, topo.data_group_ranks(self.s, self.t),
                                data_groups[self.s * topo.tp + self.t])
        self.tensor_group = Group(
            self, topo.tensor_group_ranks(self.d, self.s),
            tensor_groups[self.d * topo.pp + self.s], kind="tensor")
        self.pipe_group = Group(
            self, topo.pipe_group_ranks(self.d, self.t),
            (pipe_groups or [None] * (topo.data * topo.tp))[
                self.d * topo.tp + self.t], kind="pipe")
        self.world_group = Group(self, range(topo.world), world_pg,
                                 kind="world")
        self.ckpt_group = Group(self, range(topo.world), ckpt_pg,
                                kind="world")

    def describe(self) -> str:
        return (f"rank {self.rank} of {self.topo.world}: replica {self.d} "
                f"of {self.topo.data}, stage {self.s} of {self.topo.pp}, "
                f"tensor {self.t} of {self.topo.tp}; "
                f"backend {self.backend}, device {self.device} "
                f"({self.device_policy})")

    def _transport(self, run, reads, writes, *, collective: bool) -> None:
        """``run(reads, writes)``, a torch.distributed call, on the tensors
        themselves, or under gloo with tensors on the card on host copies:
        the one place where hand-offs and collectives are staged through
        host memory (``stats.staged_bytes`` counts both directions).  A
        tensor in both lists (an in-place sum) is copied out and back
        once."""
        if not (self.stage_host and any(t.is_cuda for t in (*reads,
                                                            *writes))):
            run(reads, writes)
            return
        host = {id(t): _host(t, collective) for t in reads}
        h_writes = [host[id(t)] if id(t) in host else
                    torch.empty(t.shape,
                                dtype=_host_dtype(t.dtype, collective))
                    for t in writes]
        run([host[id(t)] for t in reads], h_writes)
        for t, h in zip(writes, h_writes):
            t.copy_(h.view(t.dtype) if h.dtype == torch.int16 else h)
        self.stats.staged_bytes += sum(
            t.numel() * t.element_size() for t in (*reads, *writes))

    def exchange(self, sends: Sequence[Tuple[int, torch.Tensor]],
                 recvs: Sequence[Tuple[int, torch.Tensor]]) -> None:
        """Post ``sends`` ((peer, tensor)) and ``recvs`` ((peer, buffer))
        as one ``batch_isend_irecv`` and wait for all of them.  The time
        from posting to done goes to ``stats.handoff_s``: under gloo the
        host waits for the peer; under NCCL the wait is the stream's, and
        the host's time is the posting."""
        if not sends and not recvs:
            return
        t0 = time.perf_counter()

        def run(reads, writes):
            ops = [dist.P2POp(dist.isend, t, peer)
                   for (peer, _), t in zip(sends, reads)]
            ops += [dist.P2POp(dist.irecv, t, peer)
                    for (peer, _), t in zip(recvs, writes)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()

        self._transport(run, [t for _, t in sends], [b for _, b in recvs],
                        collective=False)
        self.stats.handoff_bytes += sum(t.numel() * t.element_size()
                                        for _, t in sends)
        self.stats.handoff_s += time.perf_counter() - t0


# --------------------------------------------------------------------------
# the tensor group's collectives inside a stage, as autograd functions
# --------------------------------------------------------------------------

class _Exit(torch.autograd.Function):
    """Sum over the tensor group forward; the cotangent passes through."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """Identity forward; the cotangent is summed over the tensor group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.contiguous().clone()), None


class _AllGather(torch.autograd.Function):
    """Every rank's block along ``dim`` in rank order forward; the
    backward keeps this rank's block of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= group.size
        out = x.new_empty(shape)
        group.all_gather_(x, out, dim)
        return out

    @staticmethod
    def backward(ctx, g):
        i = ctx.group.index
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None


def _split(group) -> bool:
    return group is not None and group.size > 1


def tp_exit(x: torch.Tensor, group) -> torch.Tensor:
    """Where a stage's tensor-sharded work leaves as partial sums (JAX's
    ``maybe_psum``): their sum over ``group``, the same on every rank.
    The identity without a group of several ranks."""
    return _Exit.apply(x, group) if _split(group) else x


def tp_enter(x: torch.Tensor, group) -> torch.Tensor:
    """Where a tensor every rank of ``group`` holds whole enters sharded
    work (an activation, or a replicated weight a rank uses in part):
    the identity forward, and the ranks' shares of its cotangent summed
    backward."""
    return _Enter.apply(x, group) if _split(group) else x


def tp_all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``x`` along ``dim``, concatenated in rank
    order (the MoE combine of JAX's ``all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, group, dim) if _split(group) else x


def tensor_index(group) -> int:
    """This rank's index in ``group`` (JAX's ``maybe_axis_index``): 0
    without a group."""
    return 0 if group is None else group.index


def _device_for(device, local_rank: int, local_world: int, backend: str,
                world: int) -> Tuple[torch.device, str]:
    """This rank's device and the rule that chose it: ``cuda:LOCAL_RANK``
    when the machine has a card per local rank, ``cuda:0`` for every rank
    when it has one card, else the CPU when asked."""
    if torch.device(device or "cuda").type == "cpu":
        return torch.device("cpu"), "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    n = torch.cuda.device_count()
    if n >= local_world:
        return torch.device("cuda", local_rank), "a card per rank"
    if n == 1:
        if backend == "nccl" and world > 1:
            raise ValueError(
                f"{local_world} ranks share one card: NCCL refuses two "
                "ranks on one device; run them with backend='gloo', which "
                "stages hand-offs and collectives through host memory")
        return torch.device("cuda", 0), f"one card shared by {local_world} ranks"
    raise ValueError(f"{local_world} ranks on a machine with {n} cards: "
                     "give each rank a card, or run on one card")


def init_grid(topo: ProcessGrid, backend: str, *,
              init_method: Optional[str] = None,
              timeout: float = DEFAULT_TIMEOUT_S,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              local_rank: Optional[int] = None, device=None) -> RankGrid:
    """Join the process group and build this rank's :class:`RankGrid`.

    ``rank`` / ``world_size`` / ``local_rank`` default to torchrun's
    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``; ``init_method`` to
    torchrun's ``env://`` rendezvous.  ``device`` is ``"cuda"`` (default)
    or ``"cpu"``; on the card the rank's device is set current.  Every
    process group gets ``timeout`` seconds, but the checkpoint's world
    group (``RankGrid.ckpt_group``) :data:`CKPT_TIMEOUT_S`.  Ends with a
    sum over the world, which every rank must reach."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: choose 'nccl' or 'gloo'")
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if rank is None or world_size is None:
        raise ValueError("no rank / world size: launch with torchrun or "
                         "pass rank= and world_size=")
    if world_size != topo.world:
        raise ValueError(f"grid ({topo.data} data x {topo.pp} stages x "
                         f"{topo.tp} tensor) needs {topo.world} ranks, the "
                         f"world has {world_size}")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
    dev, policy = _device_for(device, local_rank, local_world, backend,
                              world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    wait = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size, timeout=wait)
    # every rank creates every group, in the same order: the data groups
    # by (stage, tensor index), the tensor groups by (replica, stage),
    # the pipe groups by (replica, tensor index)
    data_groups = [dist.new_group(topo.data_group_ranks(s, t), timeout=wait)
                   if topo.data > 1 else None
                   for s in range(topo.pp) for t in range(topo.tp)]
    tensor_groups = [dist.new_group(topo.tensor_group_ranks(d, s),
                                    timeout=wait) if topo.tp > 1 else None
                     for d in range(topo.data) for s in range(topo.pp)]
    pipe_groups = [dist.new_group(topo.pipe_group_ranks(d, t), timeout=wait)
                   if topo.pp > 1 else None
                   for d in range(topo.data) for t in range(topo.tp)]
    ckpt_pg = dist.new_group(list(range(world_size)),
                             timeout=datetime.timedelta(seconds=CKPT_TIMEOUT_S))
    grid = RankGrid(topo, rank, backend, dev, policy, data_groups,
                    tensor_groups, dist.group.WORLD, ckpt_pg, pipe_groups)
    grid.world_group.all_reduce_(torch.ones(1, device=dev))
    grid.stats = TransportStats()
    return grid


def close_grid() -> None:
    """Leave the process group (a no-op when none is joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()
