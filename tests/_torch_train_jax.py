"""Shared by the port's training tests: the one-thread fixture, and (for
tests/test_torch_train_oracle*.py) the port's oracle and the JAX
package's oracle over the same rounds from one numpy state."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.reference import reference_init_state as j_init
from repro.core.reference import reference_train_step as j_step
from repro.optim import optimizers as jopt
from repro_torch import configs as tconfigs
from repro_torch.core.reference import reference_train_step as t_step
from repro_torch.data.pipeline import SyntheticLM, frontend_stub
from repro_torch.models.init import train_state_from_numpy
from repro_torch.optim import optimizers as topt

@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread (the test workers share the
    host's cores; a thread pool a worker oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROUNDS, R, BMB, SEQ = 3, 4, 2, 12
LOSS_ATOL = 5e-5
PARAM_TOL = (2e-5, 1e-3)


def frontend_batch(spec, step, r, bmb, seed=2):
    """A round's frontend keys (numpy f32, the port's stubs): a VLM's
    patches (r, bmb, n_patches, d), an encoder-decoder model's frames
    (r, bmb, T_src, d_enc); {} for other models."""
    shapes = {}
    if spec.frontend == "vision":
        shapes["patches"] = (r, bmb, spec.n_patches, spec.d_model)
    if spec.encoder is not None:
        shapes["frames"] = (r, bmb, spec.encoder.source_len,
                            spec.encoder.d_model)
    return frontend_stub(seed)(step, shapes) if shapes else {}


def run_both(mode, pp, opt="sgdm", lr=0.05, arch="qwen3-14b",
             spec_fn=None, rounds=ROUNDS):
    """({"losses", "state"} numpy for JAX, the same for the port) after
    ``rounds`` rounds of the arch's smoke spec (qwen3's by default), fp32;
    ``spec_fn`` maps each package's smoke spec to the spec trained.  A
    frontend's patches or frames (:func:`frontend_batch`) go to both."""
    kw = dict(pp=pp, microbatches=R, stash_mode=mode)
    spec_fn = spec_fn or (lambda spec: spec)
    jspec = spec_fn(jconfigs.get(arch).smoke_spec())
    jplan = jconfigs.get(arch).SMOKE_PLAN.with_(**kw)
    tspec = spec_fn(tconfigs.get(arch).smoke_spec())
    tplan = tconfigs.get(arch).SMOKE_PLAN.with_(**kw)
    name = {"sgdm": "SGDM", "adam": "Adam"}[opt]
    jo, to = getattr(jopt, name)(lr=lr), getattr(topt, name)(lr=lr)
    js = j_init(jspec, jplan, jo, jax.random.key(0), jnp.float32)
    # one compiled round (the tables are static numpy, so the oracle's
    # Python loops unroll at trace time): with its compile, a third less
    # CPU time over 3 rounds than dispatching the oracle op by op
    jround = jax.jit(functools.partial(j_step, jspec, jplan, optimizer=jo))
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu",
                                torch.float32)
    src = SyntheticLM(tspec.vocab, SEQ, seed=1)
    jl, tl = [], []
    for r in range(rounds):
        b = src.round_batch(r, R, BMB)
        b.update(frontend_batch(tspec, r, R, BMB))
        js, jm = jround(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = t_step(tspec, tplan, ts,
                        {k: torch.from_numpy(v) for k, v in b.items()}, to)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    to_np = lambda t: t.numpy() if torch.is_tensor(t) else t   # noqa: E731
    return ({"losses": jl, "state": jax.tree.map(np.asarray, js)},
            {"losses": tl, "state": jax.tree.map(to_np, ts)})


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k],
                                                        f"{prefix}/{k}")]
    return [(prefix, tree)]


def assert_trees_close(got, want, atol, rtol):
    g, w = leaves(got), leaves(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    assert g
    for (name, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), atol=atol,
                                   rtol=rtol, err_msg=name)
