"""The port's per-stage checkpoints (checkpoint/manager.py), the
fault-tolerant driver (runtime/driver.py) and the training CLI's new
flags, against the JAX package: checkpoints cross both ways bit for bit,
resharding equals JAX's, and a restart replays to the bit."""
import contextlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_jax import leaves, one_torch_thread  # noqa: F401
from repro import configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.checkpoint.manager import reshard_stages as j_reshard
from repro.core import profiler as jprof
from repro.core.reference import reference_init_state as j_init
from repro.optim import optimizers as jopt
from repro.runtime import driver as jdriver
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.manager import reshard_stages
from repro_torch.core import profiler as tprof
from repro_torch.core.pipeline import build_pipeline
from repro_torch.core.reference import reference_init_state as t_init
from repro_torch.data.pipeline import Loader, SyntheticLM
from repro_torch.launch import train
from repro_torch.models.init import train_state_from_numpy
from repro_torch.optim import optimizers as topt
from repro_torch.runtime import driver as tdriver
from repro_torch.runtime.driver import DriverConfig, TrainDriver

ROOT = Path(__file__).resolve().parents[1]
PLANS = {"stash": dict(stash_mode="stash"),
         "2bw": dict(stash_mode="2bw"),
         "interleaved": dict(stash_mode="flush", schedule="interleaved",
                             virtual_stages=2),
         "interleaved_async": dict(stash_mode="stash",
                                   schedule="interleaved_async",
                                   virtual_stages=2)}


def _plans(kind, R=4):
    kw = dict(pp=2, microbatches=R, **PLANS[kind])
    return (jconfigs.get("qwen3-14b").SMOKE_PLAN.with_(**kw),
            tconfigs.get("qwen3-14b").SMOKE_PLAN.with_(**kw))


def _same_state(got, want):
    """Every leaf equal bit for bit, dtypes included."""
    g, w = leaves(got), leaves(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (n, a), (_, b) in zip(g, w):
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a, b), n
        else:
            assert a == b, n


def _zero(state):
    """A template with the state's structure and every tensor zeroed."""
    def z(t):
        if isinstance(t, dict):
            return {k: z(v) for k, v in t.items()}
        return torch.zeros_like(t) if torch.is_tensor(t) else t
    out = z(state)
    out["stash"]["current"] = out["params"]["stages"]
    out["step"] = 0
    return out


def _rows(plan):
    return plan.pp * plan.virtual_stages


def _np(js):
    """A JAX state on the host; bf16 leaves as f32 numpy (exact), which
    train_state_from_numpy casts back to bf16."""
    return jax.tree.map(lambda a: np.asarray(
        a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), js)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", sorted(PLANS))
def test_save_restore_roundtrip_keeps_dtypes(tmp_path, kind, dtype):
    spec = tconfigs.get("qwen3-14b").smoke_spec()
    _, plan = _plans(kind)
    state = t_init(spec, plan, topt.Adam(), torch.Generator().manual_seed(0),
                   dtype)
    state["step"] = 7
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state, _rows(plan))
    assert mgr.latest_complete_round() == 3
    template = _zero(state)
    back = mgr.restore(3, template)
    assert back is template
    assert back["stash"]["current"] is back["params"]["stages"]
    _same_state(back, state)
    assert back["params"]["stages"]["layer_0"]["attn"]["wq"].dtype == dtype


def test_partial_save_truncated_manifest_and_atomic_write(tmp_path):
    spec = tconfigs.get("qwen3-14b").smoke_spec()
    _, plan = _plans("stash")
    state = t_init(spec, plan, topt.SGDM(), torch.Generator().manual_seed(0))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, 2)
    mgr.save(2, state, 2, fail_after_stage=0)      # stage 1 never lands
    assert mgr.latest_complete_round() == 1
    assert not (tmp_path / "round_00000002" / "stage_1.npz").exists()
    mgr.save(4, state, 2)
    assert mgr.latest_complete_round() == 4
    mf = tmp_path / "round_00000004" / "MANIFEST.json"
    assert not (tmp_path / "round_00000004" / "MANIFEST.json.tmp").exists()
    m = json.loads(mf.read_text())
    assert m == {"round": 4, "stages": [0, 1], "n_stages": 2, "done": True}
    mf.write_text(mf.read_text()[:10])              # a torn manifest
    assert mgr.latest_complete_round() == 1
    _same_state(mgr.restore(1, _zero(state)), state)


@pytest.mark.parametrize("kind", sorted(PLANS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, kind, dtype):
    """JAX's manager writes its oracle's state; the port restores it into
    a template and gets train_state_from_numpy of the same state."""
    jspec = jconfigs.get("qwen3-14b").smoke_spec()
    jplan, tplan_ = _plans(kind)
    js = j_init(jspec, jplan, jopt.Adam(), jax.random.key(0),
                getattr(jnp, dtype))
    JManager(str(tmp_path)).save(5, js, _rows(jplan))
    tdt = getattr(torch, dtype)
    want = train_state_from_numpy(_np(js), "cpu", tdt)
    got = CheckpointManager(str(tmp_path)).restore(5, _zero(want))
    _same_state(got, want)
    assert got["step"] == 0 and got["stash"]["current"] is \
        got["params"]["stages"]


@pytest.mark.parametrize("kind", sorted(PLANS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax(tmp_path, kind, dtype):
    spec = tconfigs.get("qwen3-14b").smoke_spec()
    _, plan = _plans(kind)
    state = t_init(spec, plan, topt.Adam(), torch.Generator().manual_seed(1),
                   getattr(torch, dtype))
    state["step"] = 3
    CheckpointManager(str(tmp_path)).save(6, state, _rows(plan))
    jspec = jconfigs.get("qwen3-14b").smoke_spec()
    jplan, _ = _plans(kind)
    js = j_init(jspec, jplan, jopt.Adam(), jax.random.key(0),
                getattr(jnp, dtype))
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), js)
    got = JManager(str(tmp_path)).restore(6, template)
    back = train_state_from_numpy(_np(got), "cpu", getattr(torch, dtype))
    _same_state(back, state)


def test_jax_driver_checkpoint_of_virtual_stages_cannot_restore(tmp_path):
    """A fault of the reference, not copied: JAX's TrainDriver saves
    ``plan.pp`` stage files, but an interleaved state has S·v rows and
    ``restore`` reads one file per row, so a round marked complete fails
    to restore.  The port's driver saves one file per row."""
    jspec = jconfigs.get("qwen3-14b").smoke_spec()
    jplan, _ = _plans("interleaved_async")
    js = j_init(jspec, jplan, jopt.SGDM(), jax.random.key(0))
    mgr = JManager(str(tmp_path))
    mgr.save(2, js, jplan.pp)                       # what its driver does
    assert mgr.latest_complete_round() == 2
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), js)
    with pytest.raises(FileNotFoundError, match="stage_2.npz"):
        mgr.restore(2, template)


def test_reshard_stages_equals_jax():
    jspec = jconfigs.get("qwen3-14b").smoke_spec()
    jplan, _ = _plans("stash")
    js = jax.tree.map(np.asarray,
                      j_init(jspec, jplan, jopt.SGDM(), jax.random.key(0)))
    ts = train_state_from_numpy(js, "cpu", torch.float32)
    for old, new in [(2, 4), (2, 1), (1, 2)]:
        jst = js["params"]["stages"] if old == 2 else jax.tree.map(
            np.asarray, j_reshard(js["params"]["stages"], 2, old))
        tst = ts["params"]["stages"] if old == 2 else reshard_stages(
            ts["params"]["stages"], 2, old)
        want = jax.tree.map(np.asarray, j_reshard(jst, old, new))
        got = reshard_stages(tst, old, new)
        for (n, a), (_, b) in zip(leaves(got), leaves(want)):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=n)


MOVES = [("stash", "interleaved"), ("interleaved", "stash"),
         ("stash", "interleaved_async"), ("interleaved_async", "2bw"),
         ("stash", "2bw"), ("interleaved", "interleaved_async")]


@pytest.mark.parametrize("old,new", MOVES)
def test_reshard_state_for_plan_equals_jax(old, new):
    jspec = jconfigs.get("qwen3-14b").smoke_spec()
    tspec = tconfigs.get("qwen3-14b").smoke_spec()
    jold, told = _plans(old)
    jnew, tnew = _plans(new)
    js = jax.tree.map(np.asarray,
                      j_init(jspec, jold, jopt.Adam(), jax.random.key(0)))
    ts = train_state_from_numpy(js, "cpu", torch.float32)
    want = train_state_from_numpy(
        jax.tree.map(np.asarray,
                     jdriver.reshard_state_for_plan(js, jspec, jold, jnew)),
        "cpu", torch.float32)
    got = tdriver.reshard_state_for_plan(ts, tspec, told, tnew)
    _same_state(got, want)
    back = tdriver.reshard_state_for_plan(got, tspec, tnew, told)
    for key in ("params", "opt_stages"):
        _same_state(back[key], ts[key])


# --------------------------------------------------------------------------
# TrainDriver
# --------------------------------------------------------------------------

SEQ = 12


def _driver(tmp_path, kind="stash", hook=None, every=2, seed=0):
    spec = tconfigs.get("qwen3-14b").smoke_spec()
    _, plan = _plans(kind)
    bundle = build_pipeline(spec, plan, seq_len=SEQ, global_batch=8,
                            optimizer=topt.SGDM(lr=0.05),
                            compute_dtype=torch.float32, device="cpu")
    loader = Loader(SyntheticLM(spec.vocab, SEQ, seed=seed), 4, 2, "cpu")
    driver = TrainDriver(bundle, loader, str(tmp_path),
                         DriverConfig(checkpoint_every=every),
                         failure_hook=hook, seed=seed)
    state = bundle.init_state(torch.Generator().manual_seed(seed))
    return driver, state


def _last_losses(driver, n):
    """Each round's loss from the driver's log, the replayed run's last
    pass over a round counting."""
    return [m["loss"] for m in driver.metrics_log][-n:]


@pytest.mark.parametrize("kind", ["stash", "interleaved_async"])
def test_driver_restart_replays_to_the_bit(tmp_path, kind):
    """A failure at round 3, and a crash in the middle of round 4's save
    that restart must skip: the final state and every round's loss equal
    the uninterrupted run's bit for bit."""
    driver, state = _driver(tmp_path / "a", kind)
    ref, step = driver.run(state, 5)
    assert step == 5
    ref_losses = [m["loss"] for m in driver.metrics_log]

    armed = {"hook": True, "save": True}

    def hook(step):
        if step == 3 and armed["hook"]:
            armed["hook"] = False
            raise RuntimeError("simulated node failure")

    driver, state = _driver(tmp_path / "b", kind, hook=hook)
    save = driver.ckpt.save

    def torn_save(rnd, st, n, fail_after_stage=None):
        if rnd == 4 and armed["save"]:
            armed["save"] = False
            save(rnd, st, n, fail_after_stage=0)
            raise RuntimeError("crash in the middle of a save")
        save(rnd, st, n, fail_after_stage)

    driver.ckpt.save = torn_save
    got, step = driver.run(state, 5)
    assert step == 5 and not any(armed.values())
    # rounds 0-1, 2, (fault), 2-3, (torn save), 2-4
    assert len(driver.metrics_log) == 2 + 1 + 2 + 3
    assert _last_losses(driver, 3) == ref_losses[2:]
    _same_state(got, ref)


def test_driver_gives_up_after_max_restarts(tmp_path):
    def hook(step):
        raise RuntimeError("always down")

    driver, state = _driver(tmp_path, hook=hook)
    driver.cfg.max_restarts = 2
    with pytest.raises(RuntimeError, match="always down"):
        driver.run(state, 4)


def test_restart_budget_resets_on_checkpoint(tmp_path):
    faults = {2, 5, 9}

    def hook(step):
        if step in faults:
            faults.discard(step)
            raise RuntimeError("sporadic failure")

    driver, state = _driver(tmp_path, hook=hook)
    driver.cfg.max_restarts = 1
    state, step = driver.run(state, 12)
    assert step == 12 and not faults


def test_failure_inside_a_round_is_wholly_overwritten(tmp_path):
    """train_step updates in place: a failure after some per-microbatch
    updates leaves a half-updated state, and the restore replaces every
    tensor, so the run still equals the uninterrupted one."""
    driver, state = _driver(tmp_path / "a")
    ref, _ = driver.run(state, 4)

    driver, state = _driver(tmp_path / "b")
    inner = driver.bundle.train_step
    calls = {"n": 0}

    def failing_step(st, batch):
        calls["n"] += 1
        if calls["n"] == 4:              # round 3, after round 2's save
            w = st["params"]["stages"]["layer_0"]["mlp"]["w1"]
            w.add_(1.0)                  # a half-done update
            st["opt_stages"]["m"]["layer_0"]["mlp"]["w1"].add_(1.0)
            st["stash"]["ring"]["layer_0"]["mlp"]["w1"].add_(1.0)
            st["params"]["head"].mul_(0.0)
            raise RuntimeError("fault in the middle of a round")
        return inner(st, batch)

    driver.bundle.train_step = failing_step
    got, step = driver.run(state, 4)
    assert step == 4 and calls["n"] == 6      # rounds 0-3, 2 and 3 twice
    _same_state(got, ref)


def test_no_checkpoint_reinitialises_from_the_seed(tmp_path):
    fired = {"n": 0}

    def hook(step):
        if step == 1 and not fired["n"]:
            fired["n"] = 1
            raise RuntimeError("fault before any checkpoint")

    driver, state = _driver(tmp_path / "a", every=10, seed=3)
    ref, _ = driver.run(state, 2)
    driver, state = _driver(tmp_path / "b", hook=hook, every=10, seed=3)
    got, step = driver.run(state, 2)
    assert step == 2 and fired["n"] == 1
    _same_state(got, ref)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-14b", "--smoke", "--device", "cpu", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
        check=True).stdout


def test_cli_trains_interleaved_async_with_checkpoints(tmp_path):
    log = tmp_path / "log.json"
    out = _cli("--steps", "4", "--schedule", "interleaved_async",
               "--virtual-stages", "2", "--ckpt", str(tmp_path / "ck"),
               "--ckpt-every", "2", "--log", str(log))
    assert re.search(r"schedule=interleaved_async v=2 stash_mode=stash R=2 "
                     r"predicted_bubble=0\.200", out), out
    a, b = map(float, re.search(r"loss ([\d.]+) -> ([\d.]+)", out).groups())
    assert np.isfinite([a, b]).all()
    assert sorted(os.listdir(tmp_path / "ck")) == ["round_00000002",
                                                   "round_00000004"]
    assert sorted(os.listdir(tmp_path / "ck" / "round_00000004")) == [
        "MANIFEST.json", "opt.npz", "shared.npz", "stage_0.npz",
        "stage_1.npz", "stage_2.npz", "stage_3.npz"]
    rec = json.loads(log.read_text())
    assert rec["arch"] == "qwen3-smoke" and len(rec["losses"]) == 4
    assert rec["losses"][0] == pytest.approx(a, abs=1e-4)


def test_cli_rejects_virtual_stages_without_an_interleaved_schedule():
    args = train.parser().parse_args(["--arch", "qwen3-14b", "--smoke",
                                      "--device", "cpu", "--schedule",
                                      "1f1b", "--virtual-stages", "2"])
    with pytest.raises(SystemExit, match="requires --schedule in"):
        train.build(args)


def test_cli_plan_search_prints_what_jax_prints():
    """--plan-search prints the two lines JAX's plan_search_report prints
    for the same plan, on the H100's fields, then trains that plan."""
    out = _cli("--steps", "1", "--plan-search", "--microbatches", "4")
    jspec = jconfigs.get("qwen3-14b").smoke_spec()
    jplan = jconfigs.get("qwen3-14b").SMOKE_PLAN.with_(microbatches=4)
    h100 = jprof.Hardware(**{k: getattr(tprof.H100_SXM, k) for k in (
        "name", "flops_peak", "hbm_bw", "link_bw", "mfu", "net_bw",
        "param_bytes", "ps_factor", "hbm_bytes")})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        choice = jdriver.plan_search_report(jspec, jplan, h100, seq_len=64,
                                            global_batch=8, data_replicas=1)
    assert out.splitlines()[:2] == buf.getvalue().splitlines()
    v = choice.plan.virtual_stages
    assert (f"plan: pp={choice.plan.pp} tp=1 schedule={choice.plan.schedule}"
            + (f" v={v}" if v > 1 else "")) in out
    assert re.search(r"loss [\d.]+ -> [\d.]+", out), out
