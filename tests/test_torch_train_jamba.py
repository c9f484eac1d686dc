"""jamba's training round in the port against JAX's, where no (token,
expert) pair can overflow capacity.

The smoke spec is copied with ``top_k = n_experts = 4``: every token goes
to every expert once, so an expert gets T pairs a call against a capacity
of ceil(T · 4 / 4 · 1.25) >= T, and no pair is dropped; routing, gates,
the MoE auxiliary loss, the Mamba mixers (the plain scan and its plain
backward, ``MambaScan``) and attention still train.  Over 3 rounds in
the config's mode (gpipe / flush, pp 2, R 4, fp32, SGD with momentum)
the port's oracle tracks JAX's ``reference_train_step``: losses within
5e-5, parameters and momenta within atol 2e-5 / rtol 1e-3.  On the stock
spec, where pairs do overflow, JAX's scatter drops kept tokens (ROADMAP
Queue 3): tests/test_torch_train_jamba_overflow.py.
"""
import dataclasses
import functools

from _torch_train_jax import (LOSS_ATOL, PARAM_TOL,  # noqa: F401
                              assert_trees_close, one_torch_thread,
                              run_both)

ARCH, MODE = "jamba-v0.1-52b", "flush"


def no_drop(spec):
    """The spec with every token routed to every expert."""
    return dataclasses.replace(spec, moe=dataclasses.replace(
        spec.moe, top_k=spec.moe.n_experts))


run = functools.lru_cache(maxsize=None)(run_both)


def test_no_pair_overflows_the_capacity():
    from repro_torch import configs
    from repro_torch.models.init import moe_static
    spec = no_drop(configs.get(ARCH).smoke_spec())
    tokens = 2 * 12                     # a microbatch of run_both's rounds
    cap = moe_static(spec, 1, tokens).capacity
    assert spec.moe.top_k == spec.moe.n_experts and cap >= tokens


def test_losses_track_jax():
    j, t = run(MODE, 2, arch=ARCH, spec_fn=no_drop)
    assert len(t["losses"]) == 3
    for a, b in zip(t["losses"], j["losses"]):
        assert abs(a - b) <= LOSS_ATOL, (t["losses"], j["losses"])


def test_state_tracks_jax():
    j, t = run(MODE, 2, arch=ARCH, spec_fn=no_drop)
    for key in ("params", "opt_stages", "opt_head", "opt_embed"):
        assert_trees_close(t["state"][key], j["state"][key], *PARAM_TOL)
    assert "ring" not in t["state"]["stash"]      # flush keeps no ring
    assert t["state"]["step"] == int(j["state"]["step"]) == 3
