"""The vocabulary-sharded embedding, head and loss at tp > 1
(``models/lm_head.py``): tensor rank t of the first stage holds the
embedding's columns t·d/tp …, rank t of the last stage the head's
vocabulary slice t·V/tp … and the optimizer state of its slice only.

On spawned gloo ranks (a file rendezvous in the test's temporary
directory, a timeout on every group and a deadline on every spawn,
tests/_torch_dist_worker.py): ``loss_and_grads`` over a tp 2 group
against JAX's ``head_loss_and_grad`` on the same numpy inputs; qwen3's
and gemma3's smoke specs trained two rounds at pp 1 x tp 2 and pp 2 x
tp 2 against one process at tp 1 (losses and every leaf, the tables
included, within 5e-5); each grid's checkpoint restored in one tp 1
process.  In one process, at tp 1, ``loss_and_grads`` against
JAX's ``head_loss_and_grad``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
import _torch_tp as T
from _torch_train_jax import leaves, one_torch_thread  # noqa: F401
from repro.models import lm_head as jlm
from repro_torch import configs
from repro_torch.checkpoint import manager as tmanager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.pipeline import build_pipeline
from repro_torch.core.schedule import make_schedule
from repro_torch.core.versioning import rank_state, table_leaf
from repro_torch.launch.train import make_loader
from repro_torch.models import lm_head as tlm
from repro_torch.models.init import padded_vocab, tp_axes
from repro_torch.optim.optimizers import SGDM
from repro_torch.parallel.dist import ProcessGrid

ARCHS = ("qwen3-14b", "gemma3-4b")
VOCAB = 300                       # padded to 384: rank 1 masks 84 ids
HEAD_TOL = dict(atol=2e-5, rtol=1e-3)   # tests/test_kernels.py's fp32


# ---- the head alone -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _head_inputs():
    """h (2, 5, 64), labels (some on rank 1's slice, some masked out),
    the valid mask, the head (64, 384) and the final norm's scale."""
    rng = np.random.default_rng(24)
    labels = rng.integers(0, VOCAB, (2, 5)).astype(np.int32)
    labels[0, :2] = (250, 191)          # rank 1's slice; rank 0's last id
    valid = np.ones((2, 5), np.float32)
    valid[1, 3:] = 0.0
    return {"h": rng.standard_normal((2, 5, 64)).astype(np.float32),
            "labels": labels, "valid": valid,
            "head": (0.3 * rng.standard_normal(
                (64, padded_vocab(VOCAB)))).astype(np.float32),
            "scale": (1.0 + 0.1 * rng.standard_normal(64)).astype(
                np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_head():
    a = _head_inputs()
    loss, dh, dhead, dscale = jlm.head_loss_and_grad(
        jnp.asarray(a["head"]), jnp.asarray(a["scale"]), jnp.asarray(a["h"]),
        jnp.asarray(a["labels"]), valid_mask=jnp.asarray(a["valid"]),
        vocab=VOCAB)
    return float(loss), np.asarray(dh), np.asarray(dhead), np.asarray(dscale)


def test_tp1_loss_and_grads_equal_jax():
    """At tp 1 (no group) ``loss_and_grads`` is the whole head's, as
    before: equal to JAX's ``head_loss_and_grad``."""
    a = _head_inputs()
    loss, dh, dhead, dfn = tlm.loss_and_grads(
        torch.from_numpy(a["head"]), {"scale": torch.from_numpy(a["scale"])},
        torch.from_numpy(a["h"]), torch.from_numpy(a["labels"]),
        norm_kind="rmsnorm", valid_mask=torch.from_numpy(a["valid"]),
        vocab=VOCAB)
    want = _jax_head()
    assert abs(float(loss) - want[0]) <= 5e-5
    for got, w in zip((dh, dhead, dfn["scale"]), want[1:]):
        np.testing.assert_allclose(got.numpy(), w, **HEAD_TOL)


# ---- training on grids ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def one_process(arch, pp):
    """Two rounds in one process at tp 1 from the same draw and batches:
    (losses, state, bundle)."""
    spec = configs.get(arch).smoke_spec()
    plan = configs.get(arch).SMOKE_PLAN.with_(pp=pp, tp=1, microbatches=W.R)
    bundle = build_pipeline(spec, plan, seq_len=W.SEQ,
                            global_batch=W.R * W.MB,
                            optimizer=SGDM(lr=0.05, momentum=0.9),
                            compute_dtype=torch.float32, device="cpu")
    state = bundle.init_state(torch.Generator().manual_seed(0))
    loader = make_loader(spec, bundle, 1)
    losses = []
    for r in range(T.ROUNDS):
        state, m = bundle.train_step(state, loader.get(r))
        losses.append(float(m["loss"]))
    return losses, state, bundle


@pytest.mark.parametrize("opt", ["sgdm", "adam"])
def test_checkpoint_cuts_the_tables_rank_state_cuts(opt):
    """The leaves outside the stages that the checkpoint cuts and joins
    at tp 2 (``versioning.table_leaf`` through ``_tp_key_dim``) are
    exactly those ``rank_state`` cuts, along the dim it cuts them: the
    two tables and their optimizer slots, not the final norm's."""
    spec = T.tiny_spec("dense")
    plan = T.case_plan(2, 1, "stash", "1f1b", 1, False)
    bundle = build_pipeline(spec, plan, seq_len=W.SEQ,
                            global_batch=W.R * W.MB,
                            optimizer=W.optimizer(opt),
                            compute_dtype=torch.float32, device="cpu")
    state = bundle.init_state(torch.Generator("cpu").manual_seed(0))
    axes = tp_axes(state["params"]["stages"], spec, 2)
    tables = set()
    for s in range(plan.pp):
        whole = tmanager._files(rank_state(state, bundle.sched, s))
        for t in range(2):
            cut = tmanager._files(rank_state(state, bundle.sched, s,
                                             tensor=(axes, t, 2)))
            for name, flat in cut.items():
                assert list(flat) == list(whole[name])
                for key, leaf in flat.items():
                    if tmanager._row_axis(key) is not None or \
                            not torch.is_tensor(leaf):
                        continue
                    dims = [i for i, (a, b) in enumerate(zip(
                        leaf.shape, whole[name][key].shape)) if a != b]
                    ax = tmanager._tp_key_dim(key, spec, 2)
                    assert dims == ([ax] if ax >= 0 else []), key
                    assert table_leaf(key) == bool(dims), key
                    if dims:
                        tables.add(key)
    assert {"embed", "head"} <= tables
    assert any(k.startswith("opt_head/") for k in tables)
    assert any(k.startswith("opt_embed/") for k in tables)


@pytest.fixture(scope="module", params=[1, 2], ids=["pp1-tp2", "pp2-tp2"])
def grid_run(request, tmp_path_factory):
    """On a pp x tp 2 grid: the head alone on each stage's tensor group,
    then both archs trained and checkpointed."""
    pp = request.param
    tmp = tmp_path_factory.mktemp(f"tp_head_pp{pp}")
    torch.set_num_threads(1)
    np.savez(tmp / "head.npz", **_head_inputs())
    ranks = W.run_ranks(tmp, 1, pp, {
        "tp_head": {"npz": str(tmp / "head.npz"), "vocab": VOCAB},
        "train_archs": {"archs": ARCHS, "pp": pp, "rounds": T.ROUNDS,
                        "ckpt_dir": str(tmp / "ckpt")}}, tp=2)
    return pp, tmp, ranks


def test_sharded_loss_and_grads_equal_jax(grid_run):
    """``loss_and_grads`` on a tp 2 group, each rank its half of the
    padded vocabulary (rank 1's half holds the 84 padded ids, masked):
    the loss, d(h) and d(scale) whole and equal on both ranks, and the
    two d(head) slices joined, equal to JAX's ``head_loss_and_grad`` of
    the whole head.  Forward: a max and two sums over the group;
    backward: one sum (d of the normalized hidden state)."""
    _, _, ranks = grid_run
    loss, dh, dhead, dscale = _jax_head()
    for res in (r["tp_head"] for r in ranks):
        assert abs(res["loss"] - loss) <= 5e-5
        np.testing.assert_allclose(res["dh"].numpy(), dh, **HEAD_TOL)
        np.testing.assert_allclose(res["dscale"].numpy(), dscale, **HEAD_TOL)
        assert res["stats"]["tensor_calls"] == 4
    for t0 in range(0, len(ranks), 2):      # each stage's tensor group
        got = [r["tp_head"] for r in ranks[t0:t0 + 2]]
        assert torch.equal(got[0]["dh"], got[1]["dh"])
        assert torch.equal(got[0]["dscale"], got[1]["dscale"])
        joined = torch.cat([r["dhead"] for r in got], dim=1)
        np.testing.assert_allclose(joined.numpy(), dhead, **HEAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_equal_tp1(grid_run, arch):
    pp, _, ranks = grid_run
    want, _, _ = one_process(arch, pp)
    for res in ranks:
        np.testing.assert_allclose(res["train_archs"][arch]["losses"], want,
                                   **T.LOSS_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_state_equals_tp1(grid_run, arch):
    """Every rank's state within 5e-5 of the one-process state's part it
    holds: its stage rows and tensor shard, its columns of the embedding
    (first stage) or the head (last stage) and of their optimizer slots,
    the whole final norm."""
    pp, _, ranks = grid_run
    _, ref, bundle = one_process(arch, pp)
    spec = configs.get(arch).smoke_spec()
    plan = bundle.plan.with_(tp=2)
    sched = make_schedule(plan)
    axes = tp_axes(ref["params"]["stages"], spec, 2)
    grid = ProcessGrid(1, pp, 2)
    tables = 0
    for rank, res in enumerate(ranks):
        _, s, t = grid.coords(rank)
        state = res["train_archs"][arch]["state"]
        want = rank_state(ref, sched, s, tensor=(axes, t, 2))
        got = {k: v for k, v in state.items() if k != "step"}
        g, w = leaves(got), leaves({k: want[k] for k in got})
        assert [n for n, _ in g] == [n for n, _ in w], rank
        for (name, a), (_, b) in zip(g, w):
            if torch.is_tensor(a):
                np.testing.assert_allclose(a.numpy(), b.numpy(),
                                           err_msg=f"rank {rank} {name}",
                                           **T.PARAM_TOL)
        if s == 0:
            assert state["params"]["embed"].shape == (
                padded_vocab(spec.vocab), spec.d_model // 2)
            tables += 1
        if s == pp - 1:
            assert state["params"]["head"].shape == (
                spec.d_model, padded_vocab(spec.vocab) // 2)
            for slot in state["opt_head"].values():
                assert slot["h"].shape == state["params"]["head"].shape
            tables += 1
    assert tables == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_checkpoint_restores_at_tp1(grid_run, arch):
    """The tp 2 grid's checkpoint (the tables' slices joined on each
    tensor group's rank 0) restored by one tp 1 process: each rank's
    state is its part of the restored one bit for bit, and the restored
    state is the one-process run's within 5e-5."""
    pp, tmp, ranks = grid_run
    _, ref, bundle = one_process(arch, pp)
    fresh = bundle.init_state(torch.Generator().manual_seed(9))
    back = CheckpointManager(str(tmp / "ckpt" / arch)).restore(
        T.ROUNDS, W.zeroed(fresh))
    spec = configs.get(arch).smoke_spec()
    sched = make_schedule(bundle.plan.with_(tp=2))
    axes = tp_axes(back["params"]["stages"], spec, 2)
    grid = ProcessGrid(1, pp, 2)
    for rank, res in enumerate(ranks):
        _, s, t = grid.coords(rank)
        state = res["train_archs"][arch]["state"]
        want = rank_state(back, sched, s, tensor=(axes, t, 2))
        for part in ("params", "opt_stages", "opt_head", "opt_embed"):
            assert (part in state) == (part in want), (rank, part)
            if part in want:
                for (n, a), (_, b) in zip(leaves(state[part]),
                                          leaves(want[part])):
                    if torch.is_tensor(a):
                        assert torch.equal(a, b), (rank, part, n)
    for key in ("params", "opt_head", "opt_embed"):
        for (n, a), (_, b) in zip(leaves(back[key]), leaves(ref[key])):
            if torch.is_tensor(a):
                np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=n,
                                           **T.PARAM_TOL)
