"""Tensor parallelism in the port, piece by piece: the grid's rank order,
groups and neighbours against JAX's ``split_model_axis``; ``tp_axes`` /
``tp_shard`` against the JAX init's PartitionSpecs for every leaf of the
ported configs' smoke specs; ``zero1_axes`` on local shapes against
JAX's; the three collectives' gradients on 2 gloo ranks against one
process; checkpoints written at tp 2 restored at tp 1 and back; a Mamba
+ MoE + attention stage and an RWKV stage at tp 2 against JAX's at tp 1
(forward; gradients against the port's tp 1); the int8 paged plain
version at Dh 120 against the Pallas kernel in interpret mode."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
import _torch_tp as T
from _torch_train_jax import leaves, one_torch_thread  # noqa: F401
from repro import configs as jconfigs
from repro.core import versioning as jver
from repro.models import init as jinit
from repro.models import stage as jstage
from repro.parallel import mesh as jmesh
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.pipeline import build_pipeline
from repro_torch.core.versioning import (TABLE_TP_DIM, rank_state,
                                         zero1_axes)
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.init import tp_axes, tp_shard
from repro_torch.optim.optimizers import tree_map
from repro_torch.parallel.dist import ProcessGrid
from repro_torch.parallel.plan import ParallelismPlan

ARCHS = ["qwen3-14b", "rwkv6-1.6b", "jamba-v0.1-52b", "h2o-danube3-4b",
         "olmoe-1b-7b", "chatglm3-6b", "deepseek-moe-16b"]


# --------------------------------------------------------------------------
# the grid
# --------------------------------------------------------------------------

@pytest.mark.parametrize("data,pp,tp", [(2, 2, 2), (1, 2, 4), (2, 3, 4),
                                        (1, 1, 2)])
def test_grid_orders_ranks_as_jax_splits_the_model_axis(data, pp, tp,
                                                        monkeypatch):
    """rank (d·pp + s)·tp + t is the device JAX's ``split_model_axis``
    puts at (data d, stage s, tensor t); the data group of (s, t), the
    tensor group of (d, s) and the neighbours keep the other coords."""
    monkeypatch.setattr(jmesh, "Mesh", lambda devices, axes:
                        types.SimpleNamespace(devices=devices,
                                              axis_names=axes))
    base = types.SimpleNamespace(
        devices=np.arange(data * pp * tp).reshape(data, pp * tp),
        axis_names=("data", "model"))
    dev = jmesh.split_model_axis(base, pp, tp).devices
    g = ProcessGrid(data, pp, tp)
    assert g.world == dev.size
    for d in range(data):
        for s in range(pp):
            assert g.tensor_group_ranks(d, s) == list(dev[d, s])
            for t in range(tp):
                r = g.rank_of(d, s, t)
                assert r == dev[d, s, t] and g.coords(r) == (d, s, t)
                assert g.data_group_ranks(s, t) == list(dev[:, s, t])
                assert g.downstream(r) == (dev[d, s + 1, t] if s + 1 < pp
                                           else None)
                assert g.upstream(r) == (dev[d, s - 1, t] if s else None)
                assert g.downstream(r, wrap=True) == dev[d, (s + 1) % pp, t]
    with pytest.raises(ValueError):
        ProcessGrid(1, 1, 0)


# --------------------------------------------------------------------------
# the shard table
# --------------------------------------------------------------------------

def _jax_layout(spec, tp):
    """(shapes, pspecs) of the JAX init at pp 2 x ``tp``, traced only
    (the pspecs are static: taken out through a side channel, as JAX's
    pipeline does)."""
    box = {}
    jplan = jmesh.ParallelismPlan(pp=2, tp=tp, microbatches=2)

    def init():
        params, box["pspecs"] = jinit.init_params(
            spec, jplan, jax.random.key(0), jnp.float32)
        return params
    shapes = jax.eval_shape(init)
    return shapes, box["pspecs"]


def _tps(spec):
    """Every tp the smoke spec's static asserts take, past 1."""
    out = []
    for tp in (2, 4, 8):
        try:
            jinit.attn_static(spec, tp) if spec.n_heads else None
            if spec.moe:
                jinit.moe_static(spec, tp, 16)
            if spec.mamba:
                jinit.mamba_static(spec, tp)
            if spec.rwkv:
                jinit.rwkv_static(spec, tp)
        except AssertionError:
            continue
        out.append(tp)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_axes_are_the_jax_partition_specs(arch):
    """For every stage leaf of the smoke spec, at every tp its statics
    take: the dim the port cuts is the one JAX's PartitionSpec names
    "tensor", and ``tp_shard`` of a numpy tree is that block; so for the
    embedding and the head (JAX cuts their columns over ("stage",
    "tensor"), the port over the stage's tensor group), while every rank
    keeps the whole final norm."""
    jspec = jconfigs.get(arch).smoke_spec()
    tspec = tconfigs.get(arch).smoke_spec()
    tps = _tps(jspec)
    assert tps
    for tp in tps:
        shapes, pspecs = _jax_layout(jspec, tp)
        tree = jax.tree.map(lambda s: np.arange(int(np.prod(s.shape)),
                                                dtype=np.float32)
                            .reshape(s.shape), shapes)
        axes = tp_axes(tree["stages"], tspec, tp)
        spec_leaves = jax.tree_util.tree_flatten_with_path(
            pspecs["stages"], is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]
        got = dict(leaves(axes))
        assert len(got) == len(spec_leaves)
        for key in ("embed", "head"):
            assert [i for i, e in enumerate(pspecs[key])
                    if e is not None and "tensor" in e] == [TABLE_TP_DIM]
        for path, ps in spec_leaves:
            name = "".join(f"/{p.key}" for p in path)
            want = [i for i, e in enumerate(ps) if e == "tensor"]
            assert got[name] == (want[0] if want else -1), (arch, tp, name)
        for t in range(tp):
            cut = tp_shard(tree, tspec, ParallelismPlan(pp=2, tp=tp), t)
            for name, a in leaves(cut["stages"]):
                ax = got[name]
                whole = dict(leaves(tree["stages"]))[name]
                want = whole if ax < 0 else np.split(whole, tp, ax)[t]
                np.testing.assert_array_equal(a, want)
            for key in ("embed", "head"):
                np.testing.assert_array_equal(
                    cut[key], np.split(tree[key], tp, TABLE_TP_DIM)[t])
            assert cut["final_norm"] is tree["final_norm"]


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_axes_on_local_shapes_are_jax(arch, dp):
    """``zero1_axes`` of a rank's own tensor shards (every rank's: the
    shards have one shape) against JAX's ``zero1_axes`` on the whole
    leaves and their pspecs (its mesh's tensor axis divides the pspec'd
    dims)."""
    jspec = jconfigs.get(arch).smoke_spec()
    tspec = tconfigs.get(arch).smoke_spec()
    for tp in _tps(jspec):
        shapes, pspecs = _jax_layout(jspec, tp)
        mesh = types.SimpleNamespace(devices=np.empty((dp, 2, tp)),
                                     axis_names=("data", "stage", "tensor"))
        want = dict(leaves(jver.zero1_axes(shapes["stages"],
                                           pspecs["stages"], mesh, dp)))
        zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                             shapes["stages"])
        local = tp_shard({"stages": zeros}, tspec,
                         ParallelismPlan(pp=2, tp=tp), 1)["stages"]
        assert dict(leaves(zero1_axes(local, dp))) == want, (arch, tp)


# --------------------------------------------------------------------------
# the collectives
# --------------------------------------------------------------------------

def test_tp_collectives_gradients_equal_one_process(tmp_path):
    """On 2 gloo ranks: the outputs equal one process's, each rank's
    shard gradients are the matching blocks of one process's gradients,
    the replicated input's gradient is the whole one on both ranks, and
    the tensor group counts its sums and gathers."""
    torch.set_num_threads(1)
    ranks = [r["tp_autograd"] for r in W.run_ranks(
        tmp_path, 1, 1, {"tp_autograd": {"seed": 3}}, tp=2)]
    rng = np.random.default_rng(3)
    full = {k: torch.from_numpy(rng.normal(size=sh).astype(np.float32))
            .requires_grad_()
            for k, sh in (("x", (4, 6)), ("w1", (6, 8)), ("w2", (8, 6)),
                          ("a", (6, 4)), ("c", (4, 6)), ("e", (4, 4)))}
    y = torch.tanh(full["x"] @ full["w1"]) @ full["w2"]
    z = full["x"] @ full["a"]
    ((y * full["c"]).sum() + (z * full["e"]).sum()).backward()
    for t, res in enumerate(ranks):
        torch.testing.assert_close(res["y"], y.detach(), atol=1e-6,
                                   rtol=1e-6)
        torch.testing.assert_close(res["z"], z.detach(), atol=0, rtol=0)
        g = res["grads"]
        torch.testing.assert_close(g["x"], full["x"].grad, atol=1e-6,
                                   rtol=1e-6)
        torch.testing.assert_close(g["w1"], full["w1"].grad.chunk(2, 1)[t],
                                   atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(g["w2"], full["w2"].grad.chunk(2, 0)[t],
                                   atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(g["a"], full["a"].grad.chunk(2, 1)[t],
                                   atol=1e-6, rtol=1e-6)
        # forward: one sum and one gather; backward: one sum (the entry)
        assert res["stats"]["tensor_calls"] == 3
        assert res["stats"]["tensor_bytes"] == 4 * (4 * 6 + 4 * 2 + 4 * 6)
    assert torch.equal(ranks[0]["grads"]["x"], ranks[1]["grads"]["x"])


# --------------------------------------------------------------------------
# checkpoints across tp
# --------------------------------------------------------------------------

# (data, pp, tp, ZeRO-1) of the checkpoint grids: pipeline stages, and
# data replicas whose ZeRO-1 shards are cut from the tensor shards
CKPT_GRIDS = {"pp2_tp2": (1, 2, 2, False), "dp2_tp2_zero1": (2, 1, 2, True)}


@pytest.fixture(scope="module", params=list(CKPT_GRIDS))
def ckpt_runs(request, tmp_path_factory):
    """A grid of the tiny dense spec (Adam, 1f1b / stash): one round, a
    checkpoint; and a one-process tp 1 checkpoint of the same round on
    the whole batch, restored on the grid."""
    data, pp, tp, zero1 = CKPT_GRIDS[request.param]
    tmp = tmp_path_factory.mktemp("tp_ckpt")
    spec = T.tiny_spec("dense")
    plan = T.case_plan(pp, tp, "stash", "1f1b", 1, zero1)
    one = plan.with_(tp=1)
    torch.set_num_threads(1)
    bundle = build_pipeline(spec, one, seq_len=W.SEQ,
                            global_batch=data * W.R * W.MB,
                            optimizer=W.optimizer("adam"),
                            compute_dtype=torch.float32, device="cpu")
    state = bundle.init_state(torch.Generator("cpu").manual_seed(0))
    src = SyntheticLM(spec.vocab, W.SEQ, seed=1)
    state, _ = bundle.train_step(state, {
        k: torch.from_numpy(v)
        for k, v in src.round_batch(0, W.R, data * W.MB).items()})
    CheckpointManager(str(tmp / "tp1")).save(1, state, plan.pp)
    ranks = [r["tp_ckpt"] for r in W.run_ranks(tmp, data, pp, {"tp_ckpt": {
        "spec": spec, "plan": plan, "save_dir": str(tmp / "tp2"),
        "restore_dir": str(tmp / "tp1"), "rounds": 1}}, tp=tp)]
    fresh = bundle.init_state(torch.Generator("cpu").manual_seed(9))
    back = CheckpointManager(str(tmp / "tp2")).restore(1, W.zeroed(fresh))
    return spec, plan, data, bundle.sched, state, ranks, back


def _rank_want(state, spec, plan, data, sched, rank):
    """What ``rank`` of the grid holds of a one-process state: its stage
    rows, its tensor shard, its ZeRO-1 shard of that."""
    from repro_torch.core.versioning import tensor_cut
    d, s, t = ProcessGrid(data, plan.pp, plan.tp).coords(rank)
    axes = tp_axes(state["params"]["stages"], spec, plan.tp)
    z1 = None
    if plan.zero1 and data > 1:
        local = tensor_cut(state["params"]["stages"], (axes, 0, plan.tp))
        z1 = (zero1_axes(local, data), d, data)
    return rank_state(state, sched, s, zero1=z1, tensor=(axes, t, plan.tp))


def _assert_rank_equals(got, want, rank):
    for part in ("params", "stash", "opt_stages", "opt_head", "opt_embed"):
        if part not in want:
            assert part not in got
            continue
        gl, wl = leaves(got[part]), leaves(want[part])
        assert [n for n, _ in gl] == [n for n, _ in wl], (rank, part)
        for (n, a), (_, b) in zip(gl, wl):
            if torch.is_tensor(a):
                assert torch.equal(a, b), (rank, part, n)
    assert got["step"] == want["step"]


def test_tp2_checkpoint_restores_at_tp1_bit_for_bit(ckpt_runs):
    """The tp 2 grid's checkpoint restored by one tp 1 process: every
    rank's state is its rows, tensor shard and ZeRO-1 shard of the
    restored one, bit for bit (the files hold the shards joined), and
    the run matches the one-process run of the same round to fp32
    tolerance."""
    spec, plan, data, sched, one_state, ranks, back = ckpt_runs
    for rank, res in enumerate(ranks):
        _assert_rank_equals(res["state"], _rank_want(
            back, spec, plan, data, sched, rank), rank)
    for (n, a), (_, b) in zip(leaves(back["params"]), leaves(
            one_state["params"])):
        if torch.is_tensor(a):
            torch.testing.assert_close(a, b, atol=5e-6, rtol=1e-4)


def test_tp1_checkpoint_restores_at_tp2_bit_for_bit(ckpt_runs):
    """A one-process tp 1 checkpoint restored on the tp 2 grid: each rank
    holds its stage's rows, tensor shard and ZeRO-1 shard of it, bit for
    bit."""
    spec, plan, data, sched, one_state, ranks, _ = ckpt_runs
    for rank, res in enumerate(ranks):
        _assert_rank_equals(res["restored"], _rank_want(
            one_state, spec, plan, data, sched, rank), rank)


def test_driver_on_tensor_ranks_replays_to_the_bit(tmp_path):
    """TrainDriver on a (1, 2, 2) grid: a failure on the last rank alone
    makes every rank restore the last complete checkpoint (written with
    the tensor shards joined) and replay, ending in the uninterrupted
    run's state bit for bit; a stage's measured seconds count it once,
    and the replan reads them."""
    spec = T.tiny_spec("dense")
    plan = T.case_plan(2, 2, "stash", "1f1b", 1, False)
    torch.set_num_threads(1)
    ranks = [r["tp_driver"] for r in W.run_ranks(tmp_path, 1, 2, {
        "tp_driver": {"spec": spec, "plan": plan, "out_dir": str(tmp_path),
                      "rounds": 4, "every": 2, "fail": 3}}, tp=2)]
    for rank, res in enumerate(ranks):
        assert not res["unfired"]
        a, b = res["a"], res["b"]
        assert a["step"] == b["step"] == 4
        # rounds 0-1, 2, (fault), 2-3
        assert len(b["losses"]) == 2 + 1 + 2
        assert b["losses"][-2:] == a["losses"][-2:]
        _assert_rank_equals(b["state"], a["state"], rank)
        assert all(len(sec) == plan.pp for sec in a["stage_seconds"])
    assert ranks[0]["a"]["stage_seconds"] == ranks[3]["a"]["stage_seconds"]
    assert ranks[0]["replan"][0] * ranks[0]["replan"][1] == plan.pp * plan.tp


# --------------------------------------------------------------------------
# Mamba and RWKV stages at tp 2
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["hybrid", "rwkv"])
def test_stage_at_tp2_matches_jax_at_tp1(arch, tmp_path):
    """One stage of the tiny hybrid (attention, Mamba, MoE) and RWKV
    specs on 2 gloo ranks, each with its tensor shard of JAX's
    parameters: the output equals JAX's ``stage_fwd`` at tp 1, and the
    rank's gradients (stage_vjp) are its shards of the port's tp 1
    gradients, d(input) whole.  The MoE capacity is sized for 4x the
    call's tokens, so no pair is dropped: where one is, JAX's scatter
    drops a kept token's output too (tests/test_torch_moe.py, ROADMAP
    Queue 3), which is not what this test is about."""
    from spmd_pipeline_check import build_tiny_spec
    jspec = build_tiny_spec(arch)
    spec = T.port_spec(jspec)
    jplan = jmesh.ParallelismPlan(pp=1, tp=1, microbatches=1)
    params, _ = jinit.init_params(jspec, jplan, jax.random.key(5),
                                  jnp.float32)
    b, s = 2, 12
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, s, jspec.d_model)).astype(np.float32)
    g = rng.standard_normal((b, s, jspec.d_model)).astype(np.float32)
    cap_tokens = 4 * b * s
    jst = jstage.make_statics(jspec, jplan, tokens_per_mb=cap_tokens)
    jh = jax.jit(lambda w, x_: jstage.stage_fwd(
        w, x_, jst, positions=jnp.broadcast_to(
            jnp.arange(s, dtype=jnp.int32), (b, s)),
        windows=params["layer_windows"][0], thetas=params["layer_thetas"][0],
        tp_axis=None)[0])(jax.tree.map(lambda a: a[0:1], params["stages"]),
                          jnp.asarray(x))
    from _torch_dist_jax import flatten
    flat = flatten(jax.tree.map(np.asarray, params))
    np.savez(tmp_path / "stage.npz", x=x, g=g, **flat)
    torch.set_num_threads(1)
    ranks = [r["tp_stage"] for r in W.run_ranks(tmp_path, 1, 1, {
        "tp_stage": {"spec": spec, "npz": str(tmp_path / "stage.npz"),
                     "tokens_per_mb": cap_tokens}}, tp=2)]
    for t, res in enumerate(ranks):
        np.testing.assert_allclose(res[2]["h"].numpy(), np.asarray(jh),
                                   atol=2e-5, rtol=2e-4)
        torch.testing.assert_close(res[2]["h"], res[1]["h"], atol=2e-6,
                                   rtol=1e-5)
        torch.testing.assert_close(res[2]["dx"], res[1]["dx"], atol=2e-6,
                                   rtol=1e-4)
        # dW is one stage's (no stacked dim): cut it as the stage's row
        whole = tp_shard({"stages": tree_map(lambda a: a[None],
                                             res[1]["dW"])},
                         spec, ParallelismPlan(pp=1, tp=2), t)["stages"]
        whole = tree_map(lambda a: a[0], whole)
        for (n, a), (_, w) in zip(leaves(res[2]["dW"]), leaves(whole)):
            torch.testing.assert_close(a, w, atol=2e-6, rtol=1e-4,
                                       msg=f"rank {t} dW{n}")


# --------------------------------------------------------------------------
# int8 paged KV at Dh 120
# --------------------------------------------------------------------------

@pytest.mark.parametrize("window", [-1, 20])
def test_int8_paged_plain_at_dh120_matches_jax_kernel(window):
    """h2o-danube3-4b's heads (32 / 8, Dh 120: 120-byte int8 rows) through
    the plain paged version against the Pallas kernel in interpret
    mode."""
    from test_torch_quant import ATOL, RTOL, _jax_kernel, _paged_case, _port
    c = _paged_case(2, 32, 8, 120, 16, 6, seed=120)
    got = _port(c, window).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_kernel(c, window), atol=ATOL,
                               rtol=RTOL)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_launcher_keeps_the_plans_tensor_degree(capsys):
    """``--plan-search`` on qwen3-14b's full spec (4 layers, analytic) picks
    a plan with tp > 1 and the launcher keeps it (no ``--tp``; tp 1 is
    no longer forced); one process refuses it, naming the grid's world
    for torchrun."""
    from repro_torch.launch import train
    argv = ["--arch", "qwen3-14b", "--layers", "4", "--pp", "2",
            "--microbatches", "4", "--global-batch", "4", "--seq-len",
            "4096", "--device", "cpu", "--plan-search"]
    _, plan, _ = train.make_plan(train.parser().parse_args(argv))
    assert plan.tp > 1
    world = plan.pp * plan.tp
    with pytest.raises(SystemExit, match=f"needs {world} ranks.*"
                       f"torchrun --nproc-per-node {world}"):
        train.main(argv)
    assert "--tp" not in train.parser().format_help()
