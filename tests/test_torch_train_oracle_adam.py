"""The port's oracle against the JAX package's under Adam (lr 1e-3), 3
rounds of the qwen3 smoke spec in fp32.  Adam's first steps move a
parameter by ~lr · sign(g), so a gradient element near zero whose sign
differs between the frameworks moves it by ~2·lr: parameters are held
under SGDM (tests/test_torch_train_oracle_1f1b.py / _gpipe.py); Adam is
held by its losses (within 5e-5) and its first and second moments
(atol 2e-5 / rtol 1e-3)."""
import functools

import pytest

from _torch_train_jax import (LOSS_ATOL, PARAM_TOL,  # noqa: F401
                              assert_trees_close, one_torch_thread,
                              run_both)

CASES = [("stash", 2), ("flush", 1)]
run = functools.lru_cache(maxsize=None)(
    lambda mode, pp: run_both(mode, pp, opt="adam", lr=1e-3))


@pytest.mark.parametrize("mode,pp", CASES)
def test_adam_oracle_losses_track_jax(mode, pp):
    j, t = run(mode, pp)
    for a, b in zip(t["losses"], j["losses"]):
        assert abs(a - b) <= LOSS_ATOL, (t["losses"], j["losses"])


@pytest.mark.parametrize("slot", ["m", "v"])
@pytest.mark.parametrize("mode,pp", CASES)
def test_adam_oracle_moments_track_jax(mode, pp, slot):
    j, t = run(mode, pp)
    for key in ("opt_stages", "opt_head", "opt_embed"):
        assert_trees_close(t["state"][key][slot], j["state"][key][slot],
                           *PARAM_TOL)
