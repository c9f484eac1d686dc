"""Tensor parallelism in the port's training round against JAX, virtual
stages: JAX's cases (data 1, pp 2, tp 2) at v 2 on the tiny dense spec
of tests/spmd_pipeline_check.py, ``interleaved`` / flush and
``interleaved_async`` / stash (per-chunk weight-version rings,
per-microbatch updates).  The port runs on 4 spawned gloo ranks from
JAX's initial state (storage order) and is held to JAX's SPMD pipeline
on the (1, 2) mesh at tp 1 from the same state, whose v-2 runs match
JAX's oracle walking the same tables (tests/spmd_pipeline_check.py);
JAX's tp pipeline is faulty (tests/test_torch_tp_dense.py)."""
import numpy as np
import pytest

import _torch_tp as T
from _torch_train_jax import one_torch_thread  # noqa: F401

PARTS = ["params", "stash", "opt_stages", "opt_head", "opt_embed"]
CASES = {"interleaved": "flush", "interleaved_async": "stash"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for schedule, mode in CASES.items():
        tmp = tmp_path_factory.mktemp(f"tp_{schedule}")
        spec = T.tiny_spec("dense")
        plan = T.case_plan(2, 2, mode, schedule, 2, False)
        prefix = T.run_jax(tmp, "jax", 1, 2, 1, "dense", mode, schedule, 2,
                           oracle=False)
        ranks = T.run_port(tmp, spec, plan, 1, f"{prefix}_init.npz")
        out[schedule] = (spec, plan, ranks, T.load(prefix, "final"))
    return out


@pytest.mark.parametrize("schedule", list(CASES))
def test_losses_track_jax_at_tp1(runs, schedule):
    spec, plan, ranks, want = runs[schedule]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], want["losses"],
                                   **T.LOSS_TOL)


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("schedule", list(CASES))
def test_rank_state_tracks_jax_at_tp1(runs, schedule, part):
    spec, plan, ranks, want = runs[schedule]
    T.assert_rank_part_tracks(spec, plan, 1, ranks, want, part)


@pytest.mark.parametrize("schedule", list(CASES))
def test_replicated_leaves_equal_across_tensor_ranks(runs, schedule):
    spec, plan, ranks, _ = runs[schedule]
    T.assert_replicated_equal_across_t(spec, plan, 1, ranks)
