"""The port's virtual-stage training schedules (``interleaved``,
``interleaved_async``) against the JAX package: tables, the memory
model, the oracle over 2 rounds, and the executor against the port's
oracle bit for bit."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_jax import (LOSS_ATOL, PARAM_TOL, assert_trees_close,
                              leaves, one_torch_thread)  # noqa: F401
from repro import configs as jconfigs
from repro.core import profiler as jprof
from repro.core import schedule as jsched
from repro.core.reference import reference_init_state as j_init
from repro.core.reference import reference_train_step as j_step
from repro.models import spec as jspec_lib
from repro.optim import optimizers as jopt
from repro.parallel import mesh as jmesh
from repro_torch import configs as tconfigs
from repro_torch.core import profiler as tprof
from repro_torch.core import schedule as tsched
from repro_torch.core.pipeline import build_pipeline
from repro_torch.core.reference import reference_init_state as t_init
from repro_torch.core.reference import reference_train_step as t_step
from repro_torch.data.pipeline import Loader, SyntheticLM
from repro_torch.models import spec as tspec_lib
from repro_torch.models.init import train_state_from_numpy
from repro_torch.optim import optimizers as topt
from repro_torch.parallel import plan as tplan

CLASSES = ("ScheduleInterleaved1F1B", "ScheduleInterleavedAsync1F1B")
GRID = [(S, R) for S in (1, 2, 3, 4) for R in range(S, 9, S)]


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("v", [1, 2, 3])
@pytest.mark.parametrize("S,R", GRID)
def test_interleaved_tables_equal_jax(S, R, v, cls):
    t = getattr(tsched, cls)(S, R, virtual_stages=v)
    j = getattr(jsched, cls)(S, R, virtual_stages=v)
    t.validate()
    tt, jt = t.tables(), j.tables()
    for a in ("fwd", "bwd", "exit_mb", "demb_mb"):
        np.testing.assert_array_equal(getattr(tt, a), getattr(jt, a))
    np.testing.assert_array_equal(t.storage_chunk_order(),
                                  j.storage_chunk_order())
    for a in ("n_ticks", "stash_slots", "resid_slots", "n_chunks",
              "accumulate", "uses_stash_ring", "fwd_from_stash",
              "bubble_fraction", "name", "plan_stash_modes"):
        assert getattr(t, a) == getattr(j, a), a
    cost = [1.0, 3.0, 2.0, 1.5][:S]
    assert tsched.weighted_round_time(t, cost, 2.5) == \
        jsched.weighted_round_time(j, cost, 2.5)


def _mk_specs(n_layers, d_model=256, heads=4, d_ff=1024, vocab=1024):
    """The planner goldens' model (tests/test_plan_search.py::mk_spec) in
    both packages."""
    out = []
    for lib in (jspec_lib, tspec_lib):
        blocks = tuple(lib.BlockSpec(mixer="attn", ffn="dense")
                       for _ in range(n_layers))
        out.append(lib.ModelSpec(
            name="t", d_model=d_model, n_layers=n_layers, n_heads=heads,
            n_kv=heads, d_head=max(d_model // heads, 8), d_ff=d_ff,
            vocab=vocab, blocks=blocks, norm="rmsnorm", act="silu"))
    return out


def _hw_pair():
    """JAX's TPU_V5E and a port Hardware with the same fields."""
    j = dataclasses.replace(jprof.TPU_V5E, hbm_bytes=1e18)
    return j, tprof.Hardware(**dataclasses.asdict(j))


# the goldens' settings (tests/test_plan_search.py memory_model goldens)
MEMORY_CASES = [
    (8, dict(pp=4, tp=1, microbatches=8, stash_mode="stash")),
    (8, dict(pp=4, tp=1, microbatches=8, stash_mode="vertical")),
    (8, dict(pp=4, tp=1, microbatches=32, stash_mode="flush")),
    (8, dict(pp=4, tp=1, microbatches=32, stash_mode="2bw")),
    (12, dict(pp=3, tp=1, microbatches=6, stash_mode="flush",
              schedule="interleaved", virtual_stages=2)),
    (12, dict(pp=3, tp=1, microbatches=6, stash_mode="stash",
              schedule="interleaved_async", virtual_stages=2)),
    (8, dict(pp=2, tp=2, microbatches=4, stash_mode="flush", zero1=True)),
    (8, dict(pp=2, tp=2, microbatches=4, stash_mode="stash", zero1=True,
             remat=False)),
]


@pytest.mark.parametrize("data_replicas", [1, 4])
@pytest.mark.parametrize("n_layers,kw", MEMORY_CASES)
def test_memory_model_equals_jax(n_layers, kw, data_replicas):
    jspec, tspec = _mk_specs(n_layers)
    jhw, thw = _hw_pair()
    jp, tp = jmesh.ParallelismPlan(**kw), tplan.ParallelismPlan(**kw)
    jm = jsched.make_schedule(jp).memory_model(
        jspec, jp, jhw, microbatch_tokens=512, data_replicas=data_replicas)
    tm = tsched.make_schedule(tp).memory_model(
        tspec, tp, thw, microbatch_tokens=512, data_replicas=data_replicas)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert str(tm) == str(jm)
    assert tm.total_bytes == jm.total_bytes


def test_virtual_stage_registry_and_cli_rule_equal_jax():
    for name in ("interleaved", "interleaved_async"):
        for v in (None, 1, 3):
            for mode in ("stash", "flush"):
                assert tsched.plan_kwargs_for_schedule(
                    name, virtual_stages=v, stash_mode=mode) == \
                    jsched.plan_kwargs_for_schedule(
                        name, virtual_stages=v, stash_mode=mode)
    for name in (None, "1f1b", "gpipe", "interleaved", "interleaved_async"):
        for v in (None, 1, 2):
            # the same verdict and message: both registries hold the
            # same virtual-stage schedules, the serving ones included
            assert tsched.virtual_stages_error(name, v) == \
                jsched.virtual_stages_error(name, v)
    for m, k in [(8, 1), (8, 3), (7, 2), (1, 1)]:
        assert tsched.paper_noam(m, k) == jsched.paper_noam(m, k)
    plan = tconfigs.get("qwen3-14b").INTERLEAVED_PLAN
    jplan = jconfigs.get("qwen3-14b").INTERLEAVED_PLAN
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    assert tsched.make_schedule(plan).n_ticks == \
        jsched.make_schedule(jplan).n_ticks


# --------------------------------------------------------------------------
# the round: executor == port oracle, port oracle ~ JAX oracle
# --------------------------------------------------------------------------

SCHEDS = {"interleaved": "flush", "interleaved_async": "stash"}
R, BMB, SEQ, ROUNDS = 4, 2, 12, 2


def _plans(name, v=2):
    kw = dict(pp=2, microbatches=R, stash_mode=SCHEDS[name], schedule=name,
              virtual_stages=v)
    return (jconfigs.get("qwen3-14b").SMOKE_PLAN.with_(**kw),
            tconfigs.get("qwen3-14b").SMOKE_PLAN.with_(**kw))


@pytest.mark.parametrize("opt", ["sgdm", "adam"])
@pytest.mark.parametrize("name", sorted(SCHEDS))
def test_executor_equals_port_oracle_bit_for_bit(name, opt):
    spec = tconfigs.get("qwen3-14b").smoke_spec()
    _, plan = _plans(name)
    o = {"sgdm": topt.SGDM(lr=0.05), "adam": topt.Adam(lr=1e-3)}[opt]
    bundle = build_pipeline(spec, plan, seq_len=SEQ, global_batch=R * BMB,
                            optimizer=o, compute_dtype=torch.float32,
                            device="cpu")
    state = bundle.init_state(torch.Generator("cpu").manual_seed(0))
    ref = t_init(spec, plan, o, torch.Generator("cpu").manual_seed(0))
    loader = Loader(SyntheticLM(spec.vocab, SEQ, seed=1), R, BMB, "cpu")
    for r in range(ROUNDS):
        batch = loader.get(r)
        state, m = bundle.train_step(state, batch)
        # the oracle may consume its input: the executor must not care
        ref, mr = t_step(spec, plan, ref, batch, o, donate=(r == 1))
        assert m["loss"].item() == mr["loss"].item()
    got, want = leaves(state), leaves(ref)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), n
    assert ref["stash"]["current"] is ref["params"]["stages"]
    if name == "interleaved_async":
        assert state["stash"]["ring"]["layer_0"]["attn"]["wq"].shape[:2] \
            == (4, 4)                    # [min(2S, R), S·v] chunk-major


@functools.lru_cache(maxsize=None)
def _run_both(name):
    """(JAX losses, JAX state, port losses, port state) after ROUNDS
    rounds of the qwen3 smoke spec from one numpy state, fp32, SGDM."""
    jplan, tplan_ = _plans(name)
    jspec = jconfigs.get("qwen3-14b").smoke_spec()
    tspec = tconfigs.get("qwen3-14b").smoke_spec()
    jo, to = jopt.SGDM(lr=0.05), topt.SGDM(lr=0.05)
    js = j_init(jspec, jplan, jo, jax.random.key(0), jnp.float32)
    jround = jax.jit(functools.partial(j_step, jspec, jplan, optimizer=jo))
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu",
                                torch.float32)
    src = SyntheticLM(tspec.vocab, SEQ, seed=1)
    jl, tl = [], []
    for r in range(ROUNDS):
        b = src.round_batch(r, R, BMB)
        js, jm = jround(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = t_step(tspec, tplan_, ts,
                        {k: torch.from_numpy(v) for k, v in b.items()}, to)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    to_np = lambda t: t.numpy() if torch.is_tensor(t) else t   # noqa: E731
    return (jl, jax.tree.map(np.asarray, js), tl, jax.tree.map(to_np, ts))


@pytest.mark.parametrize("name", sorted(SCHEDS))
def test_port_oracle_tracks_jax_losses(name):
    jl, _, tl, _ = _run_both(name)
    np.testing.assert_allclose(tl, jl, atol=LOSS_ATOL, rtol=0)


@pytest.mark.parametrize("part", ["params", "opt_stages", "stash"])
@pytest.mark.parametrize("name", sorted(SCHEDS))
def test_port_oracle_tracks_jax_state(name, part):
    _, js, _, ts = _run_both(name)
    tree = {k: v for k, v in ts[part].items()
            if k not in ("layer_windows", "layer_thetas")}
    want = {k: v for k, v in js[part].items()
            if k not in ("layer_windows", "layer_thetas")}
    assert_trees_close(tree, want, *PARAM_TOL)
    if part == "params":
        np.testing.assert_array_equal(np.asarray(ts["params"]["layer_thetas"]),
                                      js["params"]["layer_thetas"])
        assert ts["step"] == int(js["step"]) == ROUNDS


def test_async_v1_is_exactly_1f1b_stash():
    """virtual_stages=1 is the paper's 1F1B weight stashing: the same
    tables, the same 2(S−1)+1 ring and the same per-microbatch update
    order, so the whole state matches bit for bit after real updates."""
    spec = tconfigs.get("qwen3-14b").smoke_spec()
    _, asyn = _plans("interleaved_async", v=1)
    plain = asyn.with_(schedule="auto")
    assert tsched.make_schedule(asyn).stash_slots == \
        tsched.make_schedule(plain).stash_slots == 3
    o = topt.SGDM(lr=0.05, momentum=0.9)
    a = t_init(spec, asyn, o, torch.Generator("cpu").manual_seed(0))
    p = t_init(spec, plain, o, torch.Generator("cpu").manual_seed(0))
    loader = Loader(SyntheticLM(spec.vocab, SEQ, seed=1), R, BMB, "cpu")
    for r in range(2):
        a, am = t_step(spec, asyn, a, loader.get(r), o)
        p, pm = t_step(spec, plain, p, loader.get(r), o)
        assert am["loss"].item() == pm["loss"].item()
    for (na, x), (nb, y) in zip(leaves(a), leaves(p)):
        assert na == nb
        assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), na
