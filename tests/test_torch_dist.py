"""Stages on several ranks (``repro_torch.parallel.dist``,
``core/pipeline.py`` with a process grid) on the CPU under gloo: the
grid's topology, the hand-off tables (every send has its receive), the
rank-local executor at dp 1 x pp 2 against the single-process executor
bit for bit in every training schedule, a rank that fails or goes
silent, and the small pieces the data replicas use (``zero1_axes``
against JAX, the loader's replica blocks, a rank's rows of a state)."""
import jax
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from _torch_train_jax import leaves, one_torch_thread  # noqa: F401
from repro import configs as jconfigs
from repro.core import versioning as jvers
from repro.models.init import init_params as j_init_params
from repro_torch.core.pipeline import build_pipeline, handoffs
from repro_torch.core.schedule import (B_CHUNK, B_MB, F_CHUNK, F_MB,
                                       make_schedule)
from repro_torch.core.versioning import (rank_state, zero1_axes,
                                         zero1_shard)
from repro_torch.data.pipeline import Loader, SyntheticLM
from repro_torch.parallel.dist import ProcessGrid
from repro_torch.parallel.plan import ParallelismPlan

# (schedule, stash mode, virtual stages) of every training schedule
SCHEDULES = [("1f1b", "stash", 1), ("1f1b", "vertical", 1),
             ("gpipe", "flush", 1), ("gpipe", "2bw", 1),
             ("interleaved", "flush", 2), ("interleaved_async", "stash", 2)]
SPLIT_ROUNDS = 2


def test_process_grid_topology():
    g = ProcessGrid(data=2, pp=3)
    assert g.world == 6
    assert [g.coords(r) for r in range(6)] == [
        (0, 0, 0), (0, 1, 0), (0, 2, 0), (1, 0, 0), (1, 1, 0), (1, 2, 0)]
    assert [g.rank_of(*g.coords(r)) for r in range(6)] == list(range(6))
    assert g.data_group_ranks(1) == [1, 4]
    assert [g.downstream(r) for r in range(6)] == [1, 2, None, 4, 5, None]
    assert [g.upstream(r) for r in range(6)] == [None, 0, 1, None, 3, 4]
    # the chunk hop of virtual stages wraps within the replica
    assert g.downstream(2, wrap=True) == 0 and g.upstream(3, wrap=True) == 5
    with pytest.raises(ValueError):
        g.coords(6)
    with pytest.raises(ValueError):
        ProcessGrid(0, 2)


@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("schedule,mode,v", SCHEDULES)
def test_every_send_has_its_receive(schedule, mode, v, S):
    """Each rank posts its sends and receives from ``handoffs`` alone; for
    every tick and phase the sends one stage posts to another are the
    receives that one posts from it, the sender made the tensor that tick
    (its row is not a bubble), and the receiver's next row continues the
    same microbatch one chunk on (forward) or back (backward)."""
    plan = ParallelismPlan(pp=S, tp=1, microbatches=2 * S, stash_mode=mode,
                           schedule=schedule, virtual_stages=v)
    sched = make_schedule(plan)
    tabs = sched.tables()
    n_moves = 0
    for tick in range(sched.n_ticks):
        for phase, pairs in zip("fb", handoffs(tabs, tick)):
            sends = {s: [(s, dst) for src, dst in pairs if src == s]
                     for s in range(S)}
            recvs = {s: [(src, s) for src, dst in pairs if dst == s]
                     for s in range(S)}
            assert sorted(p for s in sends for p in sends[s]) == \
                sorted(p for s in recvs for p in recvs[s])
            assert all(len(r) <= 1 for r in recvs.values())
            table, mb_col, chunk_col = ((tabs.fwd, F_MB, F_CHUNK)
                                        if phase == "f" else
                                        (tabs.bwd, B_MB, B_CHUNK))
            step = 1 if phase == "f" else -1
            for src, dst in pairs:
                made, used = table[tick, src], table[tick + 1, dst]
                assert made[mb_col] >= 0 and made[mb_col] == used[mb_col]
                assert (used[chunk_col] * S + dst
                        == made[chunk_col] * S + src + step)
                n_moves += 1
    # R microbatches cross S·v - 1 chunk boundaries each way
    assert n_moves == 2 * plan.microbatches * (S * v - 1)


@pytest.fixture(scope="module")
def split_runs(tmp_path_factory):
    """Each training schedule at dp 1 x pp 2 on two spawned ranks, and on
    one process, from one seed over the same rounds."""
    cases = {f"{s}/{m}/v{v}": (s, m, v, False, False, "sgdm")
             for s, m, v in SCHEDULES}
    torch.set_num_threads(1)
    ranks = W.run_ranks(tmp_path_factory.mktemp("split"), 1, 2,
                        {"pipeline": {"cases": cases,
                                      "rounds": SPLIT_ROUNDS}})
    single = {}
    for key, (s, m, v, *_rest) in cases.items():
        plan = W.smoke_plan(2, s, m, v)
        bundle = build_pipeline(W.smoke_spec(), plan, seq_len=W.SEQ,
                                global_batch=W.R * W.MB,
                                optimizer=W.optimizer(),
                                compute_dtype=torch.float32, device="cpu")
        state = bundle.init_state(torch.Generator("cpu").manual_seed(0))
        losses = []
        for r in range(SPLIT_ROUNDS):
            state, m_ = bundle.train_step(
                state, W.rows_of(W.full_batch(r, W.MB, False), 0))
            losses.append(float(m_["loss"]))
        single[key] = {"losses": losses, "state": state,
                       "sched": bundle.sched}
    return [r["pipeline"] for r in ranks], single


@pytest.mark.parametrize("schedule,mode,v", SCHEDULES)
def test_split_over_ranks_changes_no_bit(split_runs, schedule, mode, v):
    """dp 1 x pp 2 on two ranks equals the single-process executor: the
    losses, and each rank's every state tensor equal the matching rows of
    the single-process state, bit for bit (fp32)."""
    ranks, single = split_runs
    key = f"{schedule}/{mode}/v{v}"
    want = single[key]
    for s, rank in enumerate(ranks):
        got = rank[key]
        assert got["losses"] == want["losses"]
        assert got["aux"] == [0.0] * SPLIT_ROUNDS
        expect = rank_state(want["state"], want["sched"], s)
        g, e = leaves(got["state"]), leaves(expect)
        assert [n for n, _ in g] == [n for n, _ in e]
        for (name, a), (_, b) in zip(g, e):
            if torch.is_tensor(b):
                assert torch.equal(a, b), (key, s, name)
            else:
                assert a == b, (key, s, name)
    # stage 0 holds the embedding, the last stage the head
    assert "embed" in ranks[0][key]["state"]["params"]
    assert "head" not in ranks[0][key]["state"]["params"]
    assert "head" in ranks[1][key]["state"]["params"]
    assert "opt_embed" not in ranks[1][key]["state"]


def test_a_failing_rank_fails_the_run(tmp_path):
    """A rank that raises fails the spawn at once: the peer waiting in a
    collective is killed (or fails on the closed connection first), long
    before the group's 60 s timeout."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[(0, )?1\] failed"):
        W.run_ranks(tmp_path, 1, 2, {"fail": {}}, timeout=60)
    assert time.monotonic() - t0 < 40


def test_a_silent_peer_makes_the_wait_raise(tmp_path):
    """A receive from a rank that never sends raises after the group's
    timeout (1.5 s) instead of waiting forever: well before the silent
    rank leaves (8 s), which would close the connection."""
    out = W.run_ranks(tmp_path, 1, 2, {"exchange_timeout": {"idle_s": 8}},
                      timeout=60, group_timeout=1.5)
    res = out[0]["exchange_timeout"]
    assert res["raised"], res
    assert res["seconds"] < 6, res


def test_zero1_axes_equal_jax():
    """The dim each stage leaf's optimizer state is sharded along, on the
    qwen3 smoke spec's shapes at tp 1, for dp 2, 3 and 4."""
    spec = jconfigs.get("qwen3-14b").smoke_spec()
    plan = jconfigs.get("qwen3-14b").SMOKE_PLAN.with_(pp=2)
    shapes = jax.eval_shape(
        lambda: j_init_params(spec, plan, jax.random.key(0))[0])
    _, pspecs = j_init_params(spec, plan, jax.random.key(0))

    class Mesh:    # the fields zero1_axes reads, at (data, stage, tensor)
        axis_names = ("data", "stage", "tensor")

    for dp in (1, 2, 3, 4):
        Mesh.devices = np.zeros((dp, 2, 1))
        want = jvers.zero1_axes(shapes["stages"], pspecs["stages"], Mesh, dp)
        got = zero1_axes(shapes["stages"], dp)
        assert leaves(got) == leaves(want), dp
        # at dp 3 some leaf has no dim to shard: its state stays whole
        assert (-1 in {a for _, a in leaves(got)}) == (dp in (1, 3)), dp


def test_zero1_shards_tile_the_leaf():
    a = torch.arange(2 * 6 * 4).reshape(2, 6, 4)
    parts = [zero1_shard(a, 1, i, 3) for i in range(3)]
    assert torch.equal(torch.cat(parts, dim=1), a)
    assert zero1_shard(a, -1, 1, 3) is a
    assert np.array_equal(zero1_shard(a.numpy(), 2, 1, 2), a[:, :, 2:].numpy())


@pytest.mark.parametrize("replicas", [1, 2, 4])
def test_loader_gives_each_replica_its_block(replicas):
    src = SyntheticLM(256, 10, seed=3)
    whole = src.round_batch(5, 3, 8)
    for d in range(replicas):
        got = Loader(src, 3, 8, "cpu", replica=d, replicas=replicas).get(5)
        rows = slice(d * 8 // replicas, (d + 1) * 8 // replicas)
        for k in ("tokens", "labels"):
            assert np.array_equal(got[k].numpy(), whole[k][:, rows])
    with pytest.raises(ValueError):
        Loader(src, 3, 8, "cpu", replica=0, replicas=3)


def test_torchrun_ranks_print_the_single_process_loss():
    """``torchrun --standalone`` (a free port) with two ranks, dp 1 x pp 2
    under gloo on the CPU: each rank prints its grid line, rank 0 the
    loss line the one-process launcher prints."""
    import os
    import subprocess
    import sys
    from repro_torch.launch import train
    flags = ["--arch", "qwen3-14b", "--smoke", "--steps", "2", "--device",
             "cpu", "--microbatches", "4", "--pp", "2"]
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"),
        OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", "-m", "repro_torch.launch.train", *flags,
         "--backend", "gloo"], capture_output=True, text=True, env=env,
        timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    losses = train.main(flags)
    assert out.stdout.count("grid: rank ") == 2
    assert "backend gloo, device cpu" in out.stdout
    assert f"loss {losses[0]:.4f} -> {losses[-1]:.4f}" in out.stdout


def test_launcher_refuses_what_ranks_cannot_do(monkeypatch, capsys):
    from repro_torch.launch import train
    flags = ["--arch", "qwen3-14b", "--smoke", "--device", "cpu", "--pp",
             "2"]
    monkeypatch.setenv("WORLD_SIZE", "2")
    # --ckpt is taken on several ranks: the launcher goes on to join the
    # grid, which needs torchrun's rank
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="no rank / world size"):
        train.main(flags + ["--ckpt", "/nonexistent"])
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(SystemExit, match="needs 4 ranks; the world has 1"):
        train.main(flags + ["--data", "2"])


def test_host_staging_keeps_half_precision_bits():
    """What gloo is handed for a card tensor: a point-to-point move carries
    bf16 / fp16 as their int16 bits (back bit for bit), a collective (a
    sum, a gather, a broadcast: gloo's take no int16) takes them to f32,
    which holds every half value."""
    from repro_torch.parallel.dist import _host, _host_dtype
    x = torch.randn(64).to(torch.bfloat16)
    moved = _host(x, collective=False)
    assert moved.dtype == torch.int16
    assert torch.equal(moved.view(torch.bfloat16), x)
    assert _host(x, collective=True).dtype == torch.float32
    assert torch.equal(_host(x, collective=True).to(torch.bfloat16), x)
    for dt in (torch.float32, torch.int64):
        assert _host_dtype(dt, True) == _host_dtype(dt, False) == dt
