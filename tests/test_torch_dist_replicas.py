"""Data replicas of the rank-local executor on the CPU under gloo: dp 2 at
pp 1 and pp 2, replicated and ZeRO-1, per-microbatch and round-end
updates, SGD with momentum and Adam, and a batch whose replicas hold
different numbers of masked labels, against the port's sequential
oracle over the whole batch (JAX's tolerances of
tests/spmd_pipeline_check.py); ZeRO-1 against the replicated update bit
for bit (at dp 2 a sum of two terms has one order)."""
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from _torch_train_jax import leaves, one_torch_thread  # noqa: F401
from repro_torch.core.reference import (reference_init_state,
                                        reference_train_step)
from repro_torch.core.schedule import make_schedule
from repro_torch.core.versioning import (rank_params, rank_rows, zero1_axes,
                                         zero1_shard)
from repro_torch.optim.optimizers import tree_map

LOSS_TOL = dict(atol=5e-5, rtol=1e-4)
PARAM_TOL = dict(atol=5e-5, rtol=2e-3)
ROUNDS, DP = 2, 2
# key: (schedule, stash mode, v, zero1, masked labels, optimizer)
CASES = {
    "stash": ("1f1b", "stash", 1, False, False, "sgdm"),
    "stash_z1": ("1f1b", "stash", 1, True, False, "sgdm"),
    "masked": ("1f1b", "stash", 1, False, True, "sgdm"),
    "masked_z1": ("1f1b", "stash", 1, True, True, "sgdm"),
    "flush": ("gpipe", "flush", 1, False, False, "sgdm"),
    "flush_z1": ("gpipe", "flush", 1, True, False, "sgdm"),
    "adam": ("1f1b", "stash", 1, False, True, "adam"),
    "adam_z1": ("1f1b", "stash", 1, True, True, "adam"),
}
PAIRS = [(k, f"{k}_z1") for k in ("stash", "masked", "flush", "adam")]
GRIDS = [(DP, 1), (DP, 2)]


@pytest.fixture(scope="module", params=GRIDS, ids=lambda g: f"dp{g[0]}pp{g[1]}")
def runs(request, tmp_path_factory):
    """Every case on the grid's spawned ranks; the port's oracle over the
    whole batch (dp x MB rows a microbatch) from the same seed."""
    data, pp = request.param
    torch.set_num_threads(1)
    ranks = W.run_ranks(tmp_path_factory.mktemp(f"dp{data}pp{pp}"), data,
                        pp, {"pipeline": {"cases": CASES, "rounds": ROUNDS}})
    oracle = {}
    for key, (s, m, v, z1, masked, opt) in CASES.items():
        if z1:
            continue        # the oracle has no replicas to shard over
        plan = W.smoke_plan(pp, s, m, v)
        state = reference_init_state(W.smoke_spec(), plan, W.optimizer(opt),
                                     torch.Generator("cpu").manual_seed(0))
        losses = []
        for r in range(ROUNDS):
            batch = {k: torch.from_numpy(b) for k, b in
                     W.full_batch(r, data * W.MB, masked).items()}
            state, met = reference_train_step(W.smoke_spec(), plan, state,
                                              batch, W.optimizer(opt))
            losses.append(float(met["loss"]))
        oracle[key] = {"losses": losses, "state": state,
                       "sched": make_schedule(plan)}
    return (data, pp), [r["pipeline"] for r in ranks], oracle


def _rank(grid, rank):
    data, pp = grid
    return divmod(rank, pp)          # (replica, stage)


@pytest.mark.parametrize("key", list(CASES))
def test_replicas_track_the_oracle(runs, key):
    """Every rank's losses track the oracle's whole-batch losses, and its
    weights the oracle's rows of its stage, head and embedding."""
    grid, ranks, oracle = runs
    want = oracle[key.removesuffix("_z1")]
    for rank, res in enumerate(ranks):
        d, s = _rank(grid, rank)
        got = res[key]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   **LOSS_TOL)
        expect = rank_params(want["state"]["params"], want["sched"], s)
        g, e = leaves(got["state"]["params"]), leaves(expect)
        assert [n for n, _ in g] == [n for n, _ in e]
        for (name, a), (_, b) in zip(g, e):
            if torch.is_tensor(b):
                np.testing.assert_allclose(a.numpy(), b.numpy(),
                                           err_msg=f"{key} rank {rank} {name}",
                                           **PARAM_TOL)
            else:
                assert a == b


@pytest.mark.parametrize("rep,z1", PAIRS)
def test_zero1_changes_no_bit(runs, rep, z1):
    """ZeRO-1 equals the replicated update bit for bit: losses, weights,
    ring, and each replica's optimizer shard equals its block of the
    replicated optimizer state; the replicas' weights stay equal."""
    grid, ranks, _ = runs
    for rank, res in enumerate(ranks):
        d, s = _rank(grid, rank)
        a, b = res[rep], res[z1]
        assert a["losses"] == b["losses"]
        for part in ("params", "stash", "opt_head", "opt_embed"):
            la, lb = leaves(a["state"].get(part, {})), \
                leaves(b["state"].get(part, {}))
            assert [n for n, _ in la] == [n for n, _ in lb]
            for (name, x), (_, y) in zip(la, lb):
                same = torch.equal(x, y) if torch.is_tensor(x) else x == y
                assert same, (rep, rank, part, name)
        axes = zero1_axes(a["state"]["params"]["stages"], DP)
        for slot, tree in a["state"]["opt_stages"].items():
            want = tree_map(lambda t, ax: zero1_shard(t, ax, d, DP), tree,
                            axes)
            got = b["state"]["opt_stages"][slot]
            for (name, x), (_, y) in zip(leaves(got), leaves(want)):
                assert torch.equal(x, y), (z1, rank, slot, name)
            # the state holds the shard only: 1/dp of every sharded leaf
            assert sum(t.numel() for _, t in leaves(got)) < \
                sum(t.numel() for _, t in leaves(tree))
    # replicas of a stage end with the same weights
    data, pp = grid
    for s in range(pp):
        w0 = leaves(ranks[s][z1]["state"]["params"])
        w1 = leaves(ranks[pp + s][z1]["state"]["params"])
        for (name, x), (_, y) in zip(w0, w1):
            if torch.is_tensor(x):
                assert torch.equal(x, y), (z1, s, name)


def test_masked_replicas_hold_different_counts():
    """The masked batch gives the replicas different valid counts in each
    of its first three microbatches (the global-count normalisation is
    what test_replicas_track_the_oracle holds for it)."""
    b = W.full_batch(0, DP * W.MB, True)["labels"]
    counts = (b.reshape(W.R, DP, W.MB, W.SEQ) >= 0).sum(axis=(2, 3))
    assert all(counts[m, 0] != counts[m, 1] for m in range(3)), counts


def test_metrics_are_one_number_on_every_rank(runs):
    _, ranks, _ = runs
    for key in CASES:
        assert len({tuple(r[key]["losses"]) for r in ranks}) == 1, key
        assert len({tuple(r[key]["aux"]) for r in ranks}) == 1, key


def test_each_rank_holds_its_rows_only(runs):
    grid, ranks, oracle = runs
    data, pp = grid
    sched = oracle["stash"]["sched"]
    for rank, res in enumerate(ranks):
        d, s = _rank(grid, rank)
        st = res["stash"]["state"]
        rows = rank_rows(sched, s)
        assert len(st["params"]["layer_windows"]) == rows.stop - rows.start
        assert ("embed" in st["params"]) == (s == 0)
        assert ("head" in st["params"]) == (s == pp - 1)
        ring = st["stash"]["ring"]["layer_0"]["mlp"]["w1"]
        assert ring.shape[:2] == (sched.stash_slots, 1)
