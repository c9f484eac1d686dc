"""Tensor parallelism in the port's training round against JAX, dense:
JAX's case (data 2, pp 2, tp 2, 1f1b / stash, ZeRO-1) on the tiny dense
spec of tests/spmd_pipeline_check.py (4 / 2 heads, qk-norm, windows),
and the same spec at pp 1 x tp 4 (2 KV heads over 4 ranks: each rank
slices the replicated KV weights).  The port runs on 8 and 4 spawned
gloo ranks from JAX's initial state and is held to JAX's sequential oracle
``reference_train_step`` (losses, and every rank's weights, ring,
optimizer state and ZeRO-1 shards); the leaves every tensor rank holds
whole are bit-identical across the tensor ranks.

JAX's own tp pipeline is not the yardstick: it updates every sharded
stage leaf by tp times the oracle's step and the replicated stage
leaves by another amount (its shard_map bodies run with
``check_vma=False``, where ``psum`` transposes to ``psum``), which
tests/spmd_pipeline_check.py's tp tolerance (5e-4, above one update)
does not see; ``test_jax_tp_pipeline_fault`` records it (ROADMAP
Queue 3)."""
import numpy as np
import pytest

import _torch_tp as T
from _torch_train_jax import leaves, one_torch_thread  # noqa: F401

PARTS = ["params", "stash", "opt_stages", "opt_head", "opt_embed"]


@pytest.fixture(scope="module")
def case_222(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_dense_222")
    spec = T.tiny_spec("dense")
    plan = T.case_plan(2, 2, "stash", "auto", 1, True)
    prefix = T.run_jax(tmp, "jax", 2, 2, 2, "dense", "stash", zero1=True)
    ranks = T.run_port(tmp, spec, plan, 2, f"{prefix}_init.npz")
    return (spec, plan, ranks, T.load(prefix, "ref"),
            T.load(prefix, "final"), T.load(prefix, "init"))


@pytest.fixture(scope="module")
def case_114(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_dense_114")
    spec = T.tiny_spec("dense")
    plan = T.case_plan(1, 4, "stash", "auto", 1, False)
    prefix = T.run_jax(tmp, "jax", 1, 1, 4, "dense", "stash",
                       pipeline=False)
    ranks = T.run_port(tmp, spec, plan, 1, f"{prefix}_init.npz")
    return spec, plan, ranks, T.load(prefix, "ref")


@pytest.mark.parametrize("case", ["case_222", "case_114"])
def test_losses_track_the_oracle(case, request):
    spec, plan, ranks, ref = request.getfixturevalue(case)[:4]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], ref["losses"], **T.LOSS_TOL)


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("case", ["case_222", "case_114"])
def test_rank_state_tracks_the_oracle(case, part, request):
    spec, plan, ranks, ref = request.getfixturevalue(case)[:4]
    data = 2 if case == "case_222" else 1
    T.assert_rank_part_tracks(spec, plan, data, ranks, ref, part)


@pytest.mark.parametrize("case", ["case_222", "case_114"])
def test_replicated_leaves_equal_across_tensor_ranks(case, request):
    spec, plan, ranks, _ = request.getfixturevalue(case)[:4]
    data = 2 if case == "case_222" else 1
    T.assert_replicated_equal_across_t(spec, plan, data, ranks)


def test_tp4_slices_the_replicated_kv_weights(case_114):
    """At tp 4 over 2 KV heads the KV weights stay whole on every rank
    (their gradient is the sum of the ranks' slices) and equal across
    the ranks of a stage."""
    spec, plan, ranks, ref = case_114
    assert spec.n_kv < plan.tp
    for res in ranks:
        wk = res["state"]["params"]["stages"]["layer_0"]["attn"]["wk"]
        assert wk.shape[2] == spec.n_kv
    assert (ranks[0]["state"]["params"]["stages"]["layer_0"]["attn"]["wq"]
            .shape[2] == spec.n_heads // plan.tp)


def test_jax_tp_pipeline_fault(case_222):
    """JAX's tp pipeline against its own oracle after the same rounds: its
    losses agree within its check's 5e-4, but the change of every
    sharded stage leaf (heads, FFN columns) over the run is about tp
    times the oracle's, and the port's is the oracle's."""
    spec, plan, ranks, ref, jax_tp, init = case_222
    np.testing.assert_allclose(jax_tp["losses"], ref["losses"], atol=5e-4)
    stages = lambda t: dict(leaves(t["params"]["stages"]))  # noqa: E731
    w0, wr, wj = stages(init), stages(ref), stages(jax_tp)
    for name in ("/layer_0/attn/wq", "/layer_0/attn/wo", "/layer_0/mlp/w1",
                 "/layer_1/mlp/w2"):
        dr = (np.asarray(wr[name]) - np.asarray(w0[name])).ravel()
        dj = (np.asarray(wj[name]) - np.asarray(w0[name])).ravel()
        ratio = float(dj @ dr / (dr @ dr))
        assert abs(ratio - plan.tp) < 0.05 * plan.tp, (name, ratio)
