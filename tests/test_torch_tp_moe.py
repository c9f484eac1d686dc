"""Tensor parallelism in the port's training round against JAX, MoE:
JAX's case (data 2, pp 2, tp 2, 1f1b / stash, ZeRO-1) on the tiny MoE
spec of tests/spmd_pipeline_check.py (4 experts, top 2: two experts a
tensor rank, the router and the dispatch buffer on every rank, the
expert outputs all-gathered in rank order).  The port runs on 8 spawned
gloo ranks from JAX's initial state.

The yardstick is JAX's SPMD pipeline on the (data 2, pp 2) mesh at tp 1,
from the same state: a replica routes its own rows (its own expert
capacity and load-balancing loss, summed over the replicas), which the
sequential oracle over the whole batch does not do, and JAX's tp
pipeline is faulty (tests/test_torch_tp_dense.py)."""
import numpy as np
import pytest

import _torch_tp as T
from _torch_train_jax import one_torch_thread  # noqa: F401

PARTS = ["params", "stash", "opt_stages", "opt_head", "opt_embed"]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_moe")
    spec = T.tiny_spec("moe")
    plan = T.case_plan(2, 2, "stash", "auto", 1, True)
    prefix = T.run_jax(tmp, "jax", 2, 2, 1, "moe", "stash", zero1=True,
                       oracle=False)
    ranks = T.run_port(tmp, spec, plan, 2, f"{prefix}_init.npz")
    return spec, plan, ranks, T.load(prefix, "final")


def test_losses_track_jax_at_tp1(case):
    spec, plan, ranks, want = case
    for res in ranks:
        np.testing.assert_allclose(res["losses"], want["losses"],
                                   **T.LOSS_TOL)


@pytest.mark.parametrize("part", PARTS)
def test_rank_state_tracks_jax_at_tp1(case, part):
    spec, plan, ranks, want = case
    T.assert_rank_part_tracks(spec, plan, 2, ranks, want, part)


def test_replicated_leaves_equal_across_tensor_ranks(case):
    spec, plan, ranks, _ = case
    T.assert_replicated_equal_across_t(spec, plan, 2, ranks)


def test_experts_are_cut_over_the_tensor_ranks(case):
    """Each rank holds its two experts' weights and the whole router, and
    the aux loss is every rank's."""
    spec, plan, ranks, _ = case
    for res in ranks:
        moe = res["state"]["params"]["stages"]["layer_0"]["moe"]
        assert moe["w1"].shape[1] == spec.moe.n_experts // plan.tp
        assert moe["router"].shape[2] == spec.moe.n_experts
        assert res["aux"] == ranks[0]["aux"] and res["aux"][0] > 0
