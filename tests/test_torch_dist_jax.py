"""The port at data 2 x pp 2 against the JAX package's SPMD pipeline
(shard_map over a (data, stage) mesh of emulated host devices): JAX
trains 1f1b / stash with ZeRO-1 for 2 rounds in a subprocess
(tests/_torch_dist_jax.py) and writes its initial and final states; the
port loads the initial state rank by rank on four spawned gloo ranks,
trains the same batches and is held to JAX's losses and state within
the tolerances of tests/spmd_pipeline_check.py."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from _torch_train_jax import leaves, one_torch_thread  # noqa: F401
from repro_torch.core.schedule import make_schedule
from repro_torch.core.versioning import rank_state, zero1_axes

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
ROUNDS, DP, PP = 2, 2, 2
LOSS_TOL = dict(atol=5e-5, rtol=1e-4)
PARAM_TOL = dict(atol=5e-5, rtol=2e-3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_spmd")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_dist_jax.py"),
         str(tmp / "jax"), str(ROUNDS), str(W.SEQ), str(W.R), str(W.MB)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nERR:\n{out.stderr}"
    torch.set_num_threads(1)
    ranks = W.run_ranks(tmp, DP, PP, {"load_and_train": {
        "npz": str(tmp / "jax_init.npz"), "rounds": ROUNDS}})
    final = W.unflatten(dict(np.load(tmp / "jax_final.npz")))
    return [r["load_and_train"] for r in ranks], final


def test_losses_track_jax_spmd(runs):
    ranks, final = runs
    for res in ranks:
        np.testing.assert_allclose(res["losses"], final["losses"],
                                   **LOSS_TOL)


@pytest.mark.parametrize("part", ["params", "opt_stages", "opt_head",
                                  "opt_embed"])
def test_rank_state_tracks_jax_spmd(runs, part):
    """Every rank's weights (stage rows, head, embedding) and optimizer
    state (its ZeRO-1 shard of the stage momenta) against the matching
    part of JAX's final state."""
    ranks, final = runs
    final.pop("losses", None)
    sched = make_schedule(W.smoke_plan(PP, zero1=True))
    axes = zero1_axes(final["params"]["stages"], DP)
    n_checked = 0
    for rank, res in enumerate(ranks):
        d, s = divmod(rank, PP)
        want = rank_state(final, sched, s, zero1=(axes, d, DP))
        if part not in want:
            assert part not in res["state"]
            continue
        g, e = leaves(res["state"][part]), leaves(want[part])
        assert [n for n, _ in g] == [n for n, _ in e]
        for (name, a), (_, b) in zip(g, e):
            if torch.is_tensor(a):
                np.testing.assert_allclose(
                    a.numpy(), np.asarray(b, np.float32),
                    err_msg=f"rank {rank} {part}{name}", **PARAM_TOL)
                n_checked += 1
    assert n_checked
