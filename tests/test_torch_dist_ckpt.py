"""The paper's workers checkpoint their own stages: the row-wise init
(``models/init.py::init_rank_params``), checkpoints written and read
rank by rank (``checkpoint/manager.py`` with a grid), the multi-rank
``TrainDriver`` and the launcher under torchrun, on gloo ranks on the
CPU in fp32.  A checkpoint of ranks is held to one process and to the
JAX package bit for bit, and a one-process checkpoint restores rank by
rank."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from _torch_train_jax import leaves, one_torch_thread  # noqa: F401
from repro import configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core.reference import reference_init_state as j_init
from repro.optim import optimizers as jopt
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.pipeline import build_pipeline
from repro_torch.core.reference import (model_plan, reference_init_state,
                                        to_storage_order)
from repro_torch.core.schedule import B_MB, F_MB, make_schedule
from repro_torch.core.versioning import rank_params, rank_state
from repro_torch.data.pipeline import Loader, SyntheticLM
from repro_torch.models.init import (init_params, init_rank_params,
                                     train_state_from_numpy)
from repro_torch.obs import TraceRecorder
from repro_torch.runtime.driver import DriverConfig, TrainDriver
from scripts.bench_check import check_metrics_snapshot
from scripts.obs_smoke import check_trace_schema

ROOT = Path(__file__).resolve().parents[1]
SAVE_ROUNDS = 2
# (schedule, stash mode, virtual stages, ZeRO-1, optimizer) by case
SPLIT_CASES = {"stash": ("1f1b", "stash", 1, False, "adam"),
               "interleaved_async": ("interleaved_async", "stash", 2, False,
                                     "sgdm")}
REPLICA_CASES = {"replicated": ("1f1b", "stash", 1, False, "adam"),
                 "zero1": ("1f1b", "stash", 1, True, "adam")}
# the driver: rounds, checkpoint period, a fault before round FAIL on
# the last rank, that rank's crash in round TORN's save; a run of FINAL
# rounds whose last save is torn
ROUNDS, EVERY, FAIL, TORN, FINAL = 5, 2, 3, 4, 4


def _same(got, want, what):
    """Every leaf equal bit for bit (dtypes included), or equal values."""
    g, w = leaves(got), leaves(want)
    assert [n for n, _ in g] == [n for n, _ in w], what
    for (name, a), (_, b) in zip(g, w):
        if torch.is_tensor(b):
            assert a.dtype == b.dtype and torch.equal(a, b), (what, name)
        else:
            assert a == b, (what, name)


def _plan(case, pp=2):
    schedule, mode, v, zero1, _ = case
    return W.smoke_plan(pp, schedule, mode, v, zero1)


def _template(case):
    """A zeroed one-process state of the case's plan."""
    plan = _plan(case)
    state = reference_init_state(W.smoke_spec(), plan,
                                 W.optimizer(case[4]),
                                 torch.Generator().manual_seed(9))
    return W.zeroed(state), make_schedule(plan)


# --------------------------------------------------------------------------
# the row-wise init
# --------------------------------------------------------------------------

INIT_CASES = [("qwen3-14b", 2, "1f1b", "stash", 1),
              ("qwen3-14b", 4, "1f1b", "stash", 1),
              ("qwen3-14b", 2, "interleaved", "flush", 2),
              ("qwen3-14b", 2, "interleaved_async", "stash", 2),
              ("rwkv6-1.6b", 2, "1f1b", "stash", 1),
              ("jamba-v0.1-52b", 2, "1f1b", "stash", 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,pp,schedule,mode,v", INIT_CASES)
def test_row_wise_init_equals_the_whole_draws_rows(arch, pp, schedule,
                                                   mode, v, dtype):
    """Each stage's leaf-by-leaf draw equals its rows of the whole model's
    draw in storage order, bit for bit: the same generator stream, the
    embedding on stage 0 only, the head and final norm on the last."""
    cfg = configs.get(arch)
    spec = cfg.smoke_spec()
    plan = cfg.SMOKE_PLAN.with_(pp=pp, microbatches=4, schedule=schedule,
                                stash_mode=mode, virtual_stages=v)
    sched = make_schedule(plan)
    mplan = model_plan(plan, sched)
    whole = to_storage_order(init_params(
        spec, mplan, torch.Generator().manual_seed(3), dtype), sched)
    for s in range(pp):
        got = init_rank_params(spec, mplan, torch.Generator().manual_seed(3),
                               sched, s, dtype)
        want = rank_params(whole, sched, s)
        assert sorted(got) == sorted(want)
        _same(got, want, (arch, schedule, s))
        assert ("embed" in got) == (s == 0)
        assert ("head" in got) == ("final_norm" in got) == (s == pp - 1)


# --------------------------------------------------------------------------
# dp 1 x pp 2: checkpoints, the driver
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """One spawn of a (1, 2) grid: checkpoints of two cases, a one-process
    checkpoint restored rank by rank, the driver with faults."""
    tmp = tmp_path_factory.mktemp("split")
    # a one-process checkpoint of a trained state (non-zero moments)
    case = SPLIT_CASES["stash"]
    plan = _plan(case)
    bundle = build_pipeline(W.smoke_spec(), plan, seq_len=W.SEQ,
                            global_batch=W.R * W.MB,
                            optimizer=W.optimizer("adam"),
                            compute_dtype=torch.float32, device="cpu")
    one = bundle.init_state(torch.Generator().manual_seed(1))
    one, _ = bundle.train_step(one, W.rows_of(W.full_batch(0, W.MB, True),
                                              0))
    CheckpointManager(str(tmp / "one")).save(1, one, plan.pp)
    ranks = W.run_ranks(tmp, 1, 2, {
        "ckpt_save": dict(out_dir=str(tmp / "save"), cases=SPLIT_CASES,
                          rounds=SAVE_ROUNDS),
        "ckpt_restore": dict(ckpt_dir=str(tmp / "one"), rnd=1,
                             schedule="1f1b", mode="stash", v=1),
        "driver": dict(out_dir=str(tmp / "driver"), rounds=ROUNDS,
                       every=EVERY, fail=FAIL, torn=TORN, final=FINAL)})
    return tmp, ranks, one, bundle.sched


@pytest.mark.parametrize("key", sorted(SPLIT_CASES))
def test_ranks_checkpoint_restores_in_one_process_and_rank_by_rank(split,
                                                                   key):
    """Two ranks each write their rows, rank 0 the shared files: the
    checkpoint restores in one process to the ranks' states (each rank's
    rows of it, bit for bit), and rank by rank in place, with
    ``stash["current"]`` the params' stages."""
    tmp, ranks, _, _ = split
    template, sched = _template(SPLIT_CASES[key])
    mgr = CheckpointManager(str(tmp / "save" / key))
    assert mgr.latest_complete_round() == SAVE_ROUNDS
    back = mgr.restore(SAVE_ROUNDS, template)
    assert back["step"] == SAVE_ROUNDS
    for s, rank in enumerate(ranks):
        got = rank["ckpt_save"][key]
        _same(rank_state(back, sched, s), got["state"], (key, s))
        _same(got["restored"], got["state"], (key, s, "rank restore"))
        assert got["aliased"]
    assert sorted(os.listdir(tmp / "save" / key / "round_00000002")) == [
        "MANIFEST.json", "opt.npz", "shared.npz",
        *[f"stage_{r}.npz" for r in range(sched.n_chunks)]]


@pytest.mark.parametrize("key", sorted(SPLIT_CASES))
def test_ranks_checkpoint_restores_in_jax(split, key):
    """The JAX package's manager reads the ranks' checkpoint into its own
    template: leaf for leaf the ranks' states."""
    tmp, ranks, _, _ = split
    schedule, mode, v, _, opt = SPLIT_CASES[key]
    jplan = jconfigs.get("qwen3-14b").SMOKE_PLAN.with_(
        pp=2, microbatches=W.R, stash_mode=mode, schedule=schedule,
        virtual_stages=v)
    js = j_init(jconfigs.get("qwen3-14b").smoke_spec(), jplan,
                {"adam": jopt.Adam, "sgdm": jopt.SGDM}[opt](),
                jax.random.key(0))
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), js)
    got = JManager(str(tmp / "save" / key)).restore(SAVE_ROUNDS, template)
    back = train_state_from_numpy(jax.tree.map(np.asarray, got), "cpu",
                                  torch.float32)
    sched = make_schedule(_plan(SPLIT_CASES[key]))
    for s, rank in enumerate(ranks):
        _same(rank_state(back, sched, s), rank["ckpt_save"][key]["state"],
              (key, s))


def test_one_process_checkpoint_restores_rank_by_rank(split):
    _, ranks, one, sched = split
    for s, rank in enumerate(ranks):
        _same(rank["ckpt_restore"], rank_state(one, sched, s), s)
        assert rank["ckpt_restore"]["step"] == 1


def _one_process_driver(tmp, rounds=ROUNDS):
    plan = W.smoke_plan(2)
    bundle = build_pipeline(W.smoke_spec(), plan, seq_len=W.SEQ,
                            global_batch=W.R * W.MB,
                            optimizer=W.optimizer(),
                            compute_dtype=torch.float32, device="cpu")
    loader = Loader(SyntheticLM(W.smoke_spec().vocab, W.SEQ, seed=1), W.R,
                    W.MB, "cpu")
    driver = TrainDriver(bundle, loader, str(tmp),
                         DriverConfig(checkpoint_every=EVERY))
    state, _ = driver.run(
        bundle.init_state(torch.Generator().manual_seed(0)), rounds)
    return state, [m["loss"] for m in driver.metrics_log], bundle.sched


def test_driver_fault_on_one_rank_replays_to_the_bit(split, tmp_path):
    """A failure raised on the last rank only, then that rank's crash in a
    save: every rank restores the last complete round and replays, and
    ends in the uninterrupted run's state, which is the one-process
    driver's, bit for bit."""
    _, ranks, _, _ = split
    one, one_losses, sched = _one_process_driver(tmp_path)
    for s, rank in enumerate(ranks):
        res = rank["driver"]
        assert not res["unfired"]
        a, b = res["a"], res["b"]
        assert a["step"] == b["step"] == ROUNDS
        assert a["losses"] == one_losses
        # rounds 0-1, 2, (fault), 2-3, (torn save), 2-4
        assert len(b["losses"]) == 2 + 1 + 2 + 3
        assert b["losses"][-3:] == a["losses"][-3:]
        _same(b["state"], a["state"], s)
        _same(a["state"], rank_state(one, sched, s), s)


def test_driver_replays_a_torn_save_of_the_last_round(split):
    """The last rank's crash in the save of the last round: every rank
    agrees, restores the round before and replays, so the run ends with
    the last round checkpointed, in the state the uninterrupted run
    checkpointed at that round, bit for bit."""
    _, ranks, _, _ = split
    for s, rank in enumerate(ranks):
        res = rank["driver"]
        c = res["c"]
        assert c["step"] == FINAL and c["latest"] == FINAL
        # rounds 0-3, (torn save), 2-3
        assert len(c["losses"]) == FINAL + EVERY
        assert c["losses"][-EVERY:] == res["a"]["losses"][FINAL - EVERY:FINAL]
        _same(c["state"], res["a_final"], s)


def _torn_driver(tmp, rounds, torn, fault=None):
    """A one-process driver whose save of round ``torn`` crashes once
    after its first row, and whose hook raises once before round
    ``fault``: (driver, final state, step, latest complete round when
    the hook fired)."""
    plan = W.smoke_plan(2)
    bundle = build_pipeline(W.smoke_spec(), plan, seq_len=W.SEQ,
                            global_batch=W.R * W.MB,
                            optimizer=W.optimizer(),
                            compute_dtype=torch.float32, device="cpu")
    loader = Loader(SyntheticLM(W.smoke_spec().vocab, W.SEQ, seed=1), W.R,
                    W.MB, "cpu")
    armed = {"hook": fault is not None, "save": True}
    fired = {}

    def hook(step):
        if step == fault and armed["hook"]:
            armed["hook"] = False
            fired["latest"] = driver.ckpt.latest_complete_round()
            raise RuntimeError("simulated node failure")

    driver = TrainDriver(bundle, loader, str(tmp),
                         DriverConfig(checkpoint_every=EVERY),
                         failure_hook=hook)
    save = driver.ckpt.save

    def torn_save(rnd, st, n, fail_after_stage=None):
        if rnd == torn and armed["save"]:
            armed["save"] = False
            save(rnd, st, n, fail_after_stage=0)
            raise RuntimeError("crash in the middle of a save")
        save(rnd, st, n, fail_after_stage)

    driver.ckpt.save = torn_save
    state, step = driver.run(
        bundle.init_state(torch.Generator().manual_seed(0)), rounds)
    assert not any(armed.values())
    return driver, state, step, fired.get("latest")


def test_one_process_driver_replays_a_torn_save_of_the_last_round(tmp_path):
    """A save of the last round that raises is not lost: the driver
    restores the round before and replays, as on ranks."""
    ref, ref_losses, _ = _one_process_driver(tmp_path / "a", FINAL)
    driver, got, step, _ = _torn_driver(tmp_path / "b", FINAL, FINAL)
    assert step == FINAL
    assert driver.ckpt.latest_complete_round() == FINAL
    # rounds 0-3, (torn save), 2-3
    losses = [m["loss"] for m in driver.metrics_log]
    assert len(losses) == FINAL + EVERY
    assert losses[-EVERY:] == ref_losses[FINAL - EVERY:]
    _same(got, ref, "final round's save torn")


def test_a_failed_save_restores_before_the_next_hook(tmp_path):
    """After a failed save the driver restores before it calls the hook
    again: a fault scheduled for the next round fires in the replay,
    once the round before it is checkpointed, not before the restore."""
    ref, _, _ = _one_process_driver(tmp_path / "a", FINAL)
    driver, got, step, latest = _torn_driver(tmp_path / "b", FINAL, EVERY,
                                             fault=EVERY)
    assert step == FINAL and latest == EVERY
    # rounds 0-1, (torn save: no checkpoint, a fresh start), 0-1,
    # (fault), 2-3
    assert len(driver.metrics_log) == EVERY + EVERY + EVERY
    _same(got, ref, "fault after a failed save")


def test_torn_save_of_one_rank_is_skipped(split):
    """The last rank's rows of round TORN never landed: its manifest is
    not done, lists stage 0's row only, and the latest complete round is
    the one before."""
    _, ranks, _, _ = split
    torn = ranks[-1]["driver"]["torn"]
    assert torn["latest"] == TORN - EVERY
    assert json.loads(torn["manifest"]) == {
        "round": TORN, "stages": [0], "n_stages": 2, "done": False}


def test_stage_seconds_reach_rank_0_registry(split):
    """Each rank's measured stage seconds, all-gathered each round: rank
    0's registry holds every stage's series, one sample an executed
    round, replays included, and the trace one span a busy cell."""
    _, ranks, _, sched = split
    res = ranks[0]["driver"]["b"]
    snap = res["snapshot"]
    assert check_metrics_snapshot(snap) == []
    executed = len(res["losses"])
    hist = {(r["name"], tuple(sorted(r["labels"].items()))): r
            for r in snap["histograms"]}
    for s in range(2):
        row = hist["stage_round_seconds", (("stage", str(s)),)]
        assert row["count"] == executed and row["min"] > 0
    assert hist["round_seconds", (("kind", "train"),)]["count"] == executed
    assert {(r["name"], r["labels"]["kind"]): r["value"]
            for r in snap["counters"]} == {("rounds_total", "train"):
                                           executed}
    assert len(res["stage_seconds"]) == executed
    # the ranks hold the same vector
    assert res["stage_seconds"] == ranks[1]["driver"]["b"]["stage_seconds"]
    tabs = sched.tables()
    cells = ((tabs.fwd[:, :, F_MB] >= 0).sum(0)
             + (tabs.bwd[:, :, B_MB] >= 0).sum(0))
    assert res["rounds_traced"] == executed
    assert res["span_counts"] == {s: int(c) * executed
                                  for s, c in enumerate(cells)}


# --------------------------------------------------------------------------
# dp 2 x pp 2 with ZeRO-1
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def replicas(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("replicas")
    ranks = W.run_ranks(tmp, 2, 2, {"ckpt_save": dict(
        out_dir=str(tmp / "save"), cases=REPLICA_CASES, rounds=SAVE_ROUNDS)})
    return tmp, ranks


def test_zero1_checkpoint_restores_equal_to_the_replicated_state(replicas):
    """dp 2 x pp 2: the ZeRO-1 ranks all-gather their optimizer rows
    before rank 0 writes them, so the checkpoint restores in one process
    equal to the replicated run's (every replica's rows of it, bit for
    bit); rank by rank each replica gets its own shard back."""
    tmp, ranks = replicas
    sched = make_schedule(_plan(REPLICA_CASES["zero1"]))
    back = {}
    for key, case in REPLICA_CASES.items():
        template, _ = _template(case)
        back[key] = CheckpointManager(str(tmp / "save" / key)).restore(
            SAVE_ROUNDS, template)
    _same(back["zero1"], back["replicated"], "zero1 vs replicated")
    for rank, res in enumerate(ranks):
        s = rank % 2
        _same(rank_state(back["zero1"], sched, s),
              res["ckpt_save"]["replicated"]["state"], (rank, s))
        z1 = res["ckpt_save"]["zero1"]
        _same(z1["restored"], z1["state"], (rank, "shard"))
    m = ranks[0]["ckpt_save"]["zero1"]["state"]["opt_stages"]["m"]
    full = ranks[0]["ckpt_save"]["replicated"]["state"]["opt_stages"]["m"]
    assert m["layer_0"]["mlp"]["w1"].shape != full["layer_0"]["mlp"][
        "w1"].shape


def test_zero1_checkpoint_restores_in_jax(replicas):
    tmp, ranks = replicas
    jplan = jconfigs.get("qwen3-14b").SMOKE_PLAN.with_(
        pp=2, microbatches=W.R, stash_mode="stash", schedule="1f1b",
        zero1=True)
    js = j_init(jconfigs.get("qwen3-14b").smoke_spec(), jplan, jopt.Adam(),
                jax.random.key(0))
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), js)
    got = JManager(str(tmp / "save" / "zero1")).restore(SAVE_ROUNDS,
                                                        template)
    back = train_state_from_numpy(jax.tree.map(np.asarray, got), "cpu",
                                  torch.float32)
    sched = make_schedule(_plan(REPLICA_CASES["zero1"]))
    for rank, res in enumerate(ranks[:2]):
        _same(rank_state(back, sched, rank),
              res["ckpt_save"]["replicated"]["state"], rank)


# --------------------------------------------------------------------------
# the launcher under torchrun
# --------------------------------------------------------------------------

def test_torchrun_checkpoints_and_reports_per_rank(tmp_path):
    """``torchrun`` with --data 1 --pp 2 --ckpt: the checkpoint of the two
    ranks equals the one-process launcher's file for file; each rank
    writes its own trace and metrics (``.rank<r>``), rank 0 prints the
    loss, the reconcile line and the replan."""
    from repro_torch.launch import train
    flags = ["--arch", "qwen3-14b", "--smoke", "--steps", "4", "--device",
             "cpu", "--microbatches", "4", "--pp", "2", "--ckpt-every", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", "-m", "repro_torch.launch.train", *flags,
         "--data", "1", "--backend", "gloo", "--ckpt", str(tmp_path / "ck"),
         "--trace-out", str(tmp_path / "trace.json"), "--metrics-out",
         str(tmp_path / "metrics.json"), "--replan"],
        capture_output=True, text=True, env=env, timeout=150)
    assert out.returncode == 0, out.stdout + out.stderr
    losses = train.main(flags + ["--ckpt", str(tmp_path / "one")])
    assert f"loss {losses[0]:.4f} -> {losses[-1]:.4f}" in out.stdout
    assert out.stdout.count("reconcile[train]") == 1
    assert "replan: stage seconds" in out.stdout
    for rnd in ("round_00000002", "round_00000004"):
        names = sorted(os.listdir(tmp_path / "ck" / rnd))
        assert names == sorted(os.listdir(tmp_path / "one" / rnd))
        assert json.loads((tmp_path / "ck" / rnd / "MANIFEST.json")
                          .read_text())["done"]
        for name in names:
            if not name.endswith(".npz"):
                continue
            a = np.load(tmp_path / "ck" / rnd / name)
            b = np.load(tmp_path / "one" / rnd / name)
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                assert a[k].dtype == b[k].dtype and \
                    np.array_equal(a[k], b[k]), (rnd, name, k)
    for r in range(2):
        snap = json.loads((tmp_path / f"metrics.rank{r}.json").read_text())
        assert check_metrics_snapshot(snap) == []
        stages = {row["labels"].get("stage") for row in snap["histograms"]
                  if row["name"] == "stage_round_seconds"}
        assert stages == {"0", "1"}
        trace = TraceRecorder()
        trace.events = json.loads((tmp_path / f"trace.rank{r}.json")
                                  .read_text())["traceEvents"]
        check_trace_schema(trace)
