"""The small modules that data replicas make possible, against the JAX
package: ``core/baselines.py`` (BSP, ASP as local SGD, model
parallelism without pipelining) and ``optim/compression.py`` (1-bit
all-reduce with error feedback), on one process and over two spawned
ranks under gloo on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from _torch_train_jax import (assert_trees_close, leaves,  # noqa: F401
                              one_torch_thread)
from repro import configs as jconfigs
from repro.core.baselines import build_bsp as j_build_bsp
from repro.optim import optimizers as jopt
from repro.optim.compression import init_errors as j_init_errors
from repro.optim.compression import onebit_compress_psum
from repro_torch.core.baselines import build_bsp, build_model_parallel
from repro_torch.core.reference import (reference_init_state,
                                        reference_train_step)
from repro_torch.models.init import params_from_numpy
from repro_torch.optim.compression import (init_errors,
                                           onebit_compress_all_reduce)

LOSS_TOL = dict(atol=5e-5, rtol=1e-4)
PARAM_TOL = (5e-5, 2e-3)
ROUNDS, DP = 2, 2


def _bsp_batch(r, rows):
    """Microbatch 0 of the masked round ``r``: ``rows`` rows."""
    return {k: v[0] for k, v in W.full_batch(r, rows, masked=True).items()}


def _torch(batch, rows=slice(None)):
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
            for k, v in batch.items()}


def _single_bsp(rows, rounds=ROUNDS):
    """The port's BSP on one process over ``rows`` of every round's batch
    (all replicas' rows when ``rows`` is everything)."""
    b = build_bsp(W.smoke_spec(), seq_len=W.SEQ, global_batch=DP * W.MB,
                  optimizer=W.optimizer(), compute_dtype=torch.float32,
                  device="cpu")
    state = b.init_state(torch.Generator("cpu").manual_seed(0))
    losses = []
    for r in range(rounds):
        state, m = b.train_step(state, _torch(_bsp_batch(r, DP * W.MB),
                                              rows))
        losses.append(float(m["loss"]))
    return losses, state


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    torch.set_num_threads(1)
    out = W.run_ranks(tmp_path_factory.mktemp("modules"), DP, 1,
                      {"modules": {"rounds": ROUNDS}})
    return [r["modules"] for r in out]


def test_bsp_matches_jax_bsp():
    """One process, the whole batch: the port's BSP step against JAX's
    ``build_bsp`` on one device from the same numpy weights."""
    spec = jconfigs.get("qwen3-14b").smoke_spec()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    step, init, _, _ = j_build_bsp(spec, mesh, seq_len=W.SEQ,
                                   global_batch=DP * W.MB,
                                   optimizer=jopt.SGDM(lr=0.05),
                                   compute_dtype=jnp.float32)
    jstate = init(jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]),
                                "cpu", torch.float32)
    b = build_bsp(W.smoke_spec(), seq_len=W.SEQ, global_batch=DP * W.MB,
                  optimizer=W.optimizer(), compute_dtype=torch.float32,
                  device="cpu")
    diffable = {k: v for k, v in tparams.items()
                if k not in ("layer_windows", "layer_thetas")}
    tstate = {"params": tparams, "opt": W.optimizer().init(diffable),
              "step": 0}
    jstep = jax.jit(step)
    for r in range(ROUNDS):
        batch = _bsp_batch(r, DP * W.MB)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = b.train_step(tstate, _torch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **LOSS_TOL)
    want = jax.tree.map(np.asarray, jstate["params"])
    got = jax.tree.map(lambda t: t.numpy() if torch.is_tensor(t) else t,
                       tstate["params"])
    for key in ("layer_windows", "layer_thetas"):
        want.pop(key), got.pop(key)
    assert_trees_close(got, want, *PARAM_TOL)


def test_bsp_over_replicas_equals_a_whole_batch_step(ranks):
    """BSP at dp 2 (a masked batch: the replicas hold different valid
    counts) tracks one process's step over the whole batch."""
    losses, state = _single_bsp(slice(None))
    for res in ranks:
        np.testing.assert_allclose(res["bsp"]["losses"], losses, **LOSS_TOL)
        got = {k: v for k, v in res["bsp"]["state"]["params"].items()
               if k not in ("layer_windows", "layer_thetas")}
        want = {k: v for k, v in state["params"].items()
                if k not in ("layer_windows", "layer_thetas")}
        for (name, a), (_, b) in zip(leaves(got), leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5,
                                       rtol=2e-3, err_msg=name)


def test_asp_is_local_sgd_with_a_periodic_average(ranks):
    """ASP with sync_every 2: each replica steps on its own rows as one
    process would, and after the second step the replicas hold the mean
    of their weights (bit for bit); the loss is the replicas' mean."""
    runs = [_single_bsp(slice(d * W.MB, (d + 1) * W.MB)) for d in range(DP)]
    mean = jax.tree.map(lambda a, b: (a + b) / DP,
                        *(s["params"] for _, s in runs))
    for res in ranks:
        np.testing.assert_allclose(
            res["asp"]["losses"],
            np.mean([lo for lo, _ in runs], axis=0), rtol=1e-6)
        got = res["asp"]["state"]["params"]
        for (name, a), (_, b) in zip(leaves(got), leaves(mean)):
            if torch.is_tensor(a):
                assert torch.equal(a, b), name
    # before the average the replicas had moved apart
    a, b = (leaves(s["params"]["stages"]) for _, s in runs)
    assert any(not torch.equal(x, y) for (_, x), (_, y) in zip(a, b))


def test_onebit_all_reduce_matches_jax_over_two_replicas(ranks):
    """Three steps with error feedback over 2 replicas: the synced
    gradient is the mean of the replicas' payloads as JAX's
    ``onebit_compress_psum`` makes them, each replica's error JAX's."""
    jerr = [j_init_errors({k: jnp.asarray(v.numpy()) for k, v in
                           r["onebit"]["grads"].items()}) for r in ranks]
    for step in range(3):
        payloads = []
        for d, r in enumerate(ranks):
            g = {k: jnp.asarray(v.numpy())
                 for k, v in r["onebit"]["grads"].items()}
            q, jerr[d] = onebit_compress_psum(g, jerr[d], axis=None,
                                              n_replicas=1)
            payloads.append(q)
        for d, r in enumerate(ranks):
            got = r["onebit"]["steps"][step]
            for k in ("a", "b"):
                want = (np.asarray(payloads[0][k])
                        + np.asarray(payloads[1][k])) / DP
                np.testing.assert_allclose(got["synced"][k].numpy(), want,
                                           atol=1e-6)
                np.testing.assert_allclose(got["errors"][k].numpy(),
                                           np.asarray(jerr[d][k]),
                                           atol=1e-6)


def test_onebit_error_feedback_matches_jax():
    """One replica (no group): JAX's error-feedback case of
    tests/test_data_optim.py, the two packages side by side."""
    rng = np.random.default_rng(0)
    g_seq = [rng.normal(size=64).astype(np.float32) for _ in range(50)]
    terr = init_errors({"g": torch.from_numpy(g_seq[0])})
    jerr = j_init_errors({"g": jnp.asarray(g_seq[0])})
    applied = torch.zeros(64)
    for g in g_seq:
        synced, terr = onebit_compress_all_reduce(
            {"g": torch.from_numpy(g)}, terr, None, 1)
        jsync, jerr = onebit_compress_psum({"g": jnp.asarray(g)}, jerr,
                                           axis=None, n_replicas=1)
        np.testing.assert_allclose(synced["g"].numpy(),
                                   np.asarray(jsync["g"]), atol=1e-6)
        applied += synced["g"]
    resid = np.abs(applied.numpy() - sum(g_seq))
    assert resid.max() < 3.0
    np.testing.assert_allclose(resid, np.abs(terr["g"].numpy()), atol=1e-5)
    np.testing.assert_allclose(terr["g"].numpy(), np.asarray(jerr["g"]),
                               atol=1e-5)


def test_onebit_payload_is_sign_and_scale():
    g = {"g": torch.tensor([1.0, -2.0, 3.0, -4.0])}
    synced, _ = onebit_compress_all_reduce(g, init_errors(g), None, 1)
    vals = np.unique(np.abs(synced["g"].numpy()))
    assert len(vals) == 1 and vals[0] == 2.5
    assert synced["g"].dtype == torch.float32


def test_model_parallel_is_the_r1_flush_pipeline():
    """Paper Figure 3: one minibatch in flight; a round equals the
    oracle's for that plan, bit for bit."""
    plan = W.smoke_plan(2, schedule="auto")
    bundle = build_model_parallel(
        W.smoke_spec(), plan, seq_len=W.SEQ, global_batch=W.MB,
        optimizer=W.optimizer(), compute_dtype=torch.float32, device="cpu")
    assert bundle.plan.microbatches == 1
    assert bundle.plan.stash_mode == "flush" and bundle.sched.accumulate
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[:1]))
             for k, v in W.full_batch(0, W.MB, False).items()}
    state = bundle.init_state(torch.Generator("cpu").manual_seed(0))
    ref = reference_init_state(W.smoke_spec(), bundle.plan, W.optimizer(),
                               torch.Generator("cpu").manual_seed(0))
    state, m = bundle.train_step(state, batch)
    ref, rm = reference_train_step(W.smoke_spec(), bundle.plan, ref, batch,
                                   W.optimizer())
    assert float(m["loss"]) == float(rm["loss"])
    for (name, a), (_, b) in zip(leaves(state["params"]),
                                 leaves(ref["params"])):
        if torch.is_tensor(a):
            assert torch.equal(a, b), name
