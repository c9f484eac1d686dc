"""The port's MoE FFN against the JAX package and against a loop oracle,
on the CPU in fp32.

Routing and the drop rule are the JAX package's, so the dispatch indices
must equal JAX's exactly and, at capacities where no expert can
overflow, the outputs must equal JAX's ``nn.moe``.  The scatter is not
JAX's: at overflow the JAX buffer write lets dropped pairs zero the
slot of their expert's last kept pair (ROADMAP Queue 3).  There the port
is held against an independent per-pair loop written here, and one
test records the JAX fault.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import nn as jnn
from repro_torch.models import nn as tnn

ATOL, RTOL = 2e-5, 1e-4     # fp32: same products, sums of at most k terms


def _params(rng, d, e, f, scale=0.3):
    g = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return {"router": g(d, e), "w1": g(e, d, f), "w2": g(e, f, d),
            "w3": g(e, d, f)}


def _static(e, k, cap):
    return dict(n_experts=e, n_local=e, top_k=k, capacity=cap, n_shared=0)


def _run_both(p, x, e, k, cap, act):
    jout, jaux = jnn.moe({n: jnp.asarray(v) for n, v in p.items()},
                         jnp.asarray(x), jnn.MoEStatic(**_static(e, k, cap)),
                         act, None)
    tout, taux = tnn.moe({n: torch.from_numpy(v) for n, v in p.items()},
                         torch.from_numpy(x),
                         tnn.MoEStatic(**_static(e, k, cap)), act)
    return (tout.numpy(), float(taux)), (np.asarray(jout), float(jaux))


def _expert(p, j, v, act):
    """Expert j of the numpy tree on one token v (d,), in f64."""
    a = v @ p["w1"][j].astype(np.float64)
    if act == "silu":
        h = a / (1 + np.exp(-a)) * (v @ p["w3"][j].astype(np.float64))
    else:
        h = 0.5 * a * (1 + np.tanh(np.sqrt(2 / np.pi) * (a + 0.044715 * a ** 3)))
    return h @ p["w2"][j].astype(np.float64)


def _loop_oracle(p, x, k, cap, act):
    """Per-pair loop: route each token (f32 softmax, top-k renormalized),
    walk the (token, choice) pairs in flat order, keep a pair while its
    expert has taken fewer than ``cap`` pairs, and add the kept pair's
    gate-weighted expert output to its token.  Returns (out, n_dropped)."""
    b, s, d = x.shape
    xf = x.reshape(-1, d).astype(np.float64)
    logits = x.reshape(-1, d) @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    taken = np.zeros(p["router"].shape[1], int)
    out = np.zeros_like(xf)
    dropped = 0
    for t in range(xf.shape[0]):
        top = np.argsort(-probs[t], kind="stable")[:k]
        gates = probs[t, top] / probs[t, top].sum()
        for j, g in zip(top, gates):
            if taken[j] < cap:
                out[t] += g * _expert(p, j, xf[t], act)
            else:
                dropped += 1
            taken[j] += 1
    return out.reshape(b, s, d), dropped


def test_dispatch_indices_equal_jax_at_every_capacity():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 5, 40).astype(np.int32)
    idx[:12] = 2                                   # one expert overflows
    for cap in (1, 3, 8, 40):
        js, jk = jnn.moe_dispatch_indices(jnp.asarray(idx), 5, cap)
        ts, tk = tnn.moe_dispatch_indices(torch.from_numpy(idx).long(), 5,
                                          cap)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("b,s,e,k,cap", [(2, 5, 4, 2, 10), (1, 7, 8, 2, 7),
                                         (3, 1, 4, 2, 4), (2, 6, 6, 1, 20)])
def test_moe_matches_jax_without_overflow(act, b, s, e, k, cap):
    """Capacity at or above the token count: a token picks k distinct
    experts, so no expert gets more than B·S pairs and nothing drops;
    out and the auxiliary loss equal JAX's."""
    assert cap >= b * s
    rng = np.random.default_rng(b * 100 + s * 10 + e)
    d, f = 12, 16
    p = _params(rng, d, e, f)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    (tout, taux), (jout, jaux) = _run_both(p, x, e, k, cap, act)
    np.testing.assert_allclose(tout, jout, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(taux, jaux, atol=1e-6, rtol=1e-6)
    want, dropped = _loop_oracle(p, x, k, cap, act)
    assert dropped == 0
    np.testing.assert_allclose(tout, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("cap", [2, 4, 5])
def test_moe_keeps_every_kept_pair_at_overflow(act, cap):
    """A router biased toward expert 0 overflows its capacity: every kept
    pair, the one at position capacity - 1 included, contributes its
    gate-weighted output, a dropped pair nothing (the loop oracle)."""
    rng = np.random.default_rng(cap)
    b, s, d, e, f, k = 2, 6, 12, 4, 16, 2
    p = _params(rng, d, e, f)
    x = (np.abs(rng.standard_normal((b, s, d))) + 0.2).astype(np.float32)
    p["router"][:, 0] += 1.0
    (tout, _), _ = _run_both(p, x, e, k, cap, act)
    want, dropped = _loop_oracle(p, x, k, cap, act)
    assert dropped > 0
    np.testing.assert_allclose(tout, want, atol=ATOL, rtol=RTOL)


def test_jax_moe_scatter_fault_is_not_copied():
    """The JAX fault (ROADMAP Queue 3): 6 tokens all routed to expert 0,
    top-1, capacity 2.  Tokens 0 and 1 are kept, 2-5 dropped; the JAX
    scatter writes the dropped pairs' zero rows into slot capacity - 1,
    token 1's, and on this backend the later write wins: JAX gives token
    1 an output of exactly 0.0.  The port keeps token 1's expert output,
    as the loop oracle does."""
    rng = np.random.default_rng(6)
    d, e, f = 8, 4, 16
    p = _params(rng, d, e, f)
    p["router"][:] = 0.0
    p["router"][:, 0] = 1.0
    x = (np.abs(rng.standard_normal((1, 6, d))) + 0.1).astype(np.float32)
    (tout, _), (jout, _) = _run_both(p, x, e, 1, 2, "silu")
    want, dropped = _loop_oracle(p, x, 1, 2, "silu")
    assert dropped == 4
    assert np.all(jout[0, 1] == 0.0)              # the JAX fault
    assert np.abs(tout[0, 1]).max() > 0.1         # the port keeps token 1
    np.testing.assert_allclose(tout, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tout[0, 0], jout[0, 0], atol=ATOL, rtol=RTOL)
    assert np.all(tout[0, 2:] == 0.0) and np.all(jout[0, 2:] == 0.0)


def test_moe_rejects_shared_experts():
    """Shared experts were refused until the deepseek slice; now they are
    one MLP (``p["shared"]``) over every token added to the routed
    output, as JAX's ``nn.moe`` adds it."""
    rng = np.random.default_rng(1)
    p = _params(rng, 8, 4, 16)
    p["shared"] = {n: (0.3 * rng.standard_normal(s)).astype(np.float32)
                   for n, s in (("w1", (8, 32)), ("w2", (32, 8)),
                                ("w3", (8, 32)))}
    x = rng.standard_normal((1, 6, 8)).astype(np.float32)
    st = {**_static(4, 2, 12), "n_shared": 2}
    jout, _ = jnn.moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                      jnn.MoEStatic(**st), "silu", None)
    tout, _ = tnn.moe(jax.tree.map(torch.from_numpy, p),
                      torch.from_numpy(x), tnn.MoEStatic(**st), "silu")
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=RTOL)
