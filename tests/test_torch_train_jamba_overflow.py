"""jamba's training round on the stock smoke spec, where (token, expert)
pairs overflow the capacity (top 2 of 4 experts, 24 tokens a call,
capacity 15), in the port and in JAX.

JAX's MoE scatter writes a zero row for every dropped pair into the slot
of its expert's last kept pair (ROADMAP Queue 3,
``repro/models/nn.py:547-562``): a kept token loses its expert output,
and the expert weights of a layer whose calls drop pairs get other
gradients.  The port writes and reads kept pairs only.  Over 3 rounds in
the config's mode (gpipe / flush, pp 2, R 4, fp32, SGD with momentum),
with every dispatch's dropped pairs counted in both packages: the same
pairs overflow; the losses agree within 5e-5; every leaf but the expert
weights and their momenta agrees within atol 2e-5 / rtol 1e-3; and each
leaf beyond that is an expert leaf of a (stage row, layer) whose calls
dropped pairs.  Where nothing can overflow the two agree everywhere
(tests/test_torch_train_jamba.py).
"""
import re
import sys

import jax
import numpy as np
import pytest

from _torch_train_jax import (LOSS_ATOL, PARAM_TOL,  # noqa: F401
                              leaves, one_torch_thread, run_both)
from repro.models import nn as jnn
from repro_torch.models import nn as tnn

EXPERT = re.compile(r"/(layer_\d+)/moe/w[123]$")


def _where():
    """(storage row, layer) of the MoE call being dispatched: the
    ``stage_fwd`` and ``reference_train_step`` frames above it."""
    f, name, row = sys._getframe(2), None, None
    while f is not None and row is None:
        if f.f_code.co_name == "stage_fwd" and name is None:
            name = f.f_locals["name"]
        if f.f_code.co_name == "reference_train_step":
            row = f.f_locals["p"]
        f = f.f_back
    return row, name


@pytest.fixture(scope="module")
def runs():
    """Both packages' rounds with every dispatch's dropped pairs counted:
    JAX's per call (a callback from the compiled round), the port's per
    call and, for the forward calls of the F phase, per (storage row,
    layer)."""
    j_drops, t_drops, t_rows = [], [], {}
    j_dispatch, t_dispatch = jnn.moe_dispatch_indices, \
        tnn.moe_dispatch_indices

    def j_count(gate_idx, n_experts, capacity):
        slot, keep = j_dispatch(gate_idx, n_experts, capacity)
        jax.debug.callback(lambda d: j_drops.append(int(d)), (~keep).sum())
        return slot, keep

    def t_count(gate_idx, n_experts, capacity):
        slot, keep = t_dispatch(gate_idx, n_experts, capacity)
        n = int((~keep).sum())
        t_drops.append(n)
        row, name = _where()
        if row is not None and name is not None:   # the F phase's calls
            # (a recompute inside the backward has no stage_fwd frame)
            t_rows[row, name] = t_rows.get((row, name), 0) + n
        return slot, keep

    jnn.moe_dispatch_indices, tnn.moe_dispatch_indices = j_count, t_count
    try:
        j, t = run_both("flush", 2, arch="jamba-v0.1-52b")
    finally:
        jnn.moe_dispatch_indices, tnn.moe_dispatch_indices = \
            j_dispatch, t_dispatch
    return j, t, j_drops, t_drops, t_rows


def test_the_same_pairs_overflow_in_both(runs):
    _, _, j_drops, t_drops, t_rows = runs
    assert len(j_drops) == len(t_drops) > 0
    assert sorted(j_drops) == sorted(t_drops)
    assert sum(t_drops) > 0                 # the spec does overflow
    assert t_rows and None not in {k for key in t_rows for k in key}


def test_losses_track_jax(runs):
    j, t = runs[:2]
    for a, b in zip(t["losses"], j["losses"]):
        assert abs(a - b) <= LOSS_ATOL, (t["losses"], j["losses"])


def _row_errors(t, j):
    """(leaf path, storage row or None, within PARAM_TOL) for every
    tensor leaf of the state; stage-stacked leaves row by row."""
    out = []
    for (name, a), (_, b) in zip(leaves(t["state"]), leaves(j["state"])):
        if not isinstance(a, np.ndarray):
            continue
        stacked = name.startswith(("/params/stages/", "/opt_stages/",
                                   "/stash/current/"))
        pairs = enumerate(zip(a, b)) if stacked else [(None, (a, b))]
        for row, (x, y) in pairs:
            ok = np.allclose(x, y, atol=PARAM_TOL[0], rtol=PARAM_TOL[1])
            out.append((name, row, ok))
    return out


def test_divergent_leaves_are_expert_leaves_of_overflowing_layers(runs):
    j, t, _, _, t_rows = runs
    rows = _row_errors(t, j)
    assert [n for n, _ in leaves(t["state"])] == \
        [n for n, _ in leaves(j["state"])]
    bad = [(name, row) for name, row, ok in rows if not ok]
    for name, row in bad:
        m = EXPERT.search(name)
        assert m is not None and row is not None, (name, row)
        assert t_rows.get((row, m.group(1)), 0) > 0, (name, row, t_rows)


def test_every_other_leaf_tracks_jax(runs):
    j, t = runs[:2]
    checked = [(name, row) for name, row, ok in _row_errors(t, j)
               if not EXPERT.search(name)]
    assert len(checked) > 100
    for name, row, ok in _row_errors(t, j):
        if not EXPERT.search(name):
            assert ok, (name, row)
