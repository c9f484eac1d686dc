"""The port's optimizers (SGDM, RMSProp, Adam) against the JAX package's
over 3 steps on one numpy-seeded tree, f32 and bf16 parameters; the
in-place ``update_`` against the functional ``update``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_jax import one_torch_thread  # noqa: F401
from repro.optim import optimizers as J
from repro_torch.optim import optimizers as T

NAMES = {"sgdm": "SGDM", "rmsprop": "RMSProp", "adam": "Adam"}
TOL = {"float32": (2e-5, 1e-3), "bfloat16": (2e-2, 1e-2)}


def _tree(rng, scale=1.0):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32) * scale,
            "n": {"s": rng.standard_normal(7).astype(np.float32) * scale}}


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [np.asarray(tree, np.float32) if not torch.is_tensor(tree)
            else tree.float().numpy()]


def _run(name, dt, lr, steps=3, seed=0):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(steps)]
    jo = getattr(J, NAMES[name])(lr=lr)
    to = T.by_name(name, lr)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    tp = T.tree_map(lambda a: torch.from_numpy(a).to(tdt), params)
    js, ts = jo.init(jp), to.init(tp)
    for step, g in enumerate(grads):
        jp, js = jo.update(jax.tree.map(lambda a: jnp.asarray(a, jdt), g), js,
                           jp, step)
        tp, ts = to.update(T.tree_map(lambda a: torch.from_numpy(a).to(tdt),
                                      g), ts, tp, step)
    return (jp, js), (tp, ts)


@pytest.mark.parametrize("dt", sorted(TOL))
@pytest.mark.parametrize("name", sorted(NAMES))
def test_update_matches_jax_over_three_steps(name, dt):
    (jp, js), (tp, ts) = _run(name, dt, lr=0.05)
    atol, rtol = TOL[dt]
    for a, b in zip(_flat(tp), _flat(jp)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)
    assert sorted(ts) == sorted(js)
    for slot in ts:      # state in f32, whatever the params' dtype
        for a, b in zip(_flat(ts[slot]), _flat(js[slot])):
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-3)
        assert all(t.dtype == torch.float32
                   for t in jax.tree.leaves(ts[slot]))


@pytest.mark.parametrize("chunk", [7, 1 << 24])
@pytest.mark.parametrize("dt", sorted(TOL))
@pytest.mark.parametrize("name", sorted(NAMES))
def test_in_place_update_equals_functional(name, dt, chunk, monkeypatch):
    """update_ works through a leaf a chunk at a time (7 elements: chunks
    and a ragged last one; the default: one chunk)."""
    monkeypatch.setattr(T, "CHUNK", chunk)
    rng = np.random.default_rng(1)
    tdt = torch.float32 if dt == "float32" else torch.bfloat16
    opt = T.by_name(name, 0.1)
    conv = lambda tree: T.tree_map(                          # noqa: E731
        lambda a: torch.from_numpy(a).to(tdt), tree)
    p0 = _tree(rng)
    fp, ip = conv(p0), conv(p0)
    fs, is_ = opt.init(fp), opt.init(ip)
    for step in range(3):
        g = conv(_tree(rng, 0.1))
        fp, fs = opt.update(g, fs, fp, step)
        opt.update_(g, is_, ip, step)
    for a, b in zip(jax.tree.leaves(fp), jax.tree.leaves(ip)):
        assert torch.equal(a, b)
    for slot in fs:
        for a, b in zip(jax.tree.leaves(fs[slot]),
                        jax.tree.leaves(is_[slot])):
            assert torch.equal(a, b)


def test_by_name_and_a_schedule_lr():
    assert isinstance(T.by_name("adam", 3e-4), T.Adam)
    assert T.by_name("sgdm", 0.1, momentum=0.5).momentum == 0.5
    opt = T.SGDM(lr=lambda step: 0.1 / (step + 1), momentum=0.0)
    p = {"w": torch.ones(3)}
    p1, _ = opt.update({"w": torch.ones(3)}, opt.init(p), p, step=1)
    assert torch.allclose(p1["w"], torch.full((3,), 0.95))
