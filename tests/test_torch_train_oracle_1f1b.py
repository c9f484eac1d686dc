"""The port's sequential oracle (core/reference.py) tracks the JAX
package's ``reference_train_step`` over 3 rounds of the qwen3 smoke spec
(fp32, R 4, seq 12) for 1f1b (stash and vertical) at pp 1 and 2,
under SGD with momentum: losses within 5e-5, parameters, momenta and
the weight-version ring within atol 2e-5 / rtol 1e-3.  The JAX runs are
cached per module (they dominate the time)."""
import functools

import pytest

from _torch_train_jax import (LOSS_ATOL, PARAM_TOL,  # noqa: F401
                              assert_trees_close, one_torch_thread,
                              run_both)

MODES = ["stash", "vertical"]
run = functools.lru_cache(maxsize=None)(run_both)


@pytest.mark.parametrize("pp", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_oracle_losses_track_jax(mode, pp):
    j, t = run(mode, pp)
    assert len(t["losses"]) == 3
    for a, b in zip(t["losses"], j["losses"]):
        assert abs(a - b) <= LOSS_ATOL, (t["losses"], j["losses"])


@pytest.mark.parametrize("pp", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_oracle_params_track_jax(mode, pp):
    j, t = run(mode, pp)
    assert_trees_close(t["state"]["params"], j["state"]["params"],
                       *PARAM_TOL)
    assert t["state"]["step"] == int(j["state"]["step"]) == 3


@pytest.mark.parametrize("pp", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_oracle_optimizer_state_and_ring_track_jax(mode, pp):
    j, t = run(mode, pp)
    for key in ("opt_stages", "opt_head", "opt_embed"):
        assert_trees_close(t["state"][key], j["state"][key], *PARAM_TOL)
    assert sorted(t["state"]["stash"]) == sorted(j["state"]["stash"])
    if "ring" in j["state"]["stash"]:
        assert_trees_close(t["state"]["stash"]["ring"],
                           j["state"]["stash"]["ring"], *PARAM_TOL)
