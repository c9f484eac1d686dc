"""JAX's SPMD pipeline for the port's multi-rank tests, run as a
subprocess: it sets the host device count before jax is imported.

  python tests/_torch_dist_jax.py OUT_PREFIX ROUNDS SEQ R MB \\
      [DATA PP TP ARCH MODE SCHEDULE V ZERO1]

With the five arguments (tests/test_torch_dist_jax.py): the qwen3 smoke
spec in fp32 (1f1b / stash, ZeRO-1 on, SGD with momentum 0.05) on a
(data 2, stage 2, tensor 1) mesh of emulated host devices, trained
ROUNDS rounds of the SyntheticLM stream (seed 1, R microbatches of
DATA·MB rows); writes ``OUT_PREFIX_init.npz`` (the initial state,
``path -> array``) and ``OUT_PREFIX_final.npz`` (the final state and
``losses``).

With the grid too (tests/test_torch_tp_*.py): the tiny spec of
``spmd_pipeline_check.build_tiny_spec(ARCH)`` (imported) on a (DATA, PP,
TP) mesh with the stash mode, schedule, virtual stages and ZeRO-1
given, the same stream; besides the two files, ``OUT_PREFIX_ref.npz``:
JAX's sequential oracle ``reference_train_step`` (one device, no
tensor axis, the plan's own schedule tables) over the same rounds from
the same initial state, with its ``losses``.  A negative PP skips the
SPMD pipeline (the oracle only, from ``reference_init_state``); a
trailing 0 skips the oracle.

  python tests/_torch_dist_jax.py OUT_PREFIX ROUNDS SEQ R MB \
      DATA PP TP ARCH MODE SCHEDULE V ZERO1 [ORACLE]
"""
import os
import sys

if __name__ == "__main__":
    _grid = [int(a) for a in sys.argv[6:9]] if len(sys.argv) > 6 else [2, 2, 1]
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                               f"{max(_grid[0] * _grid[1] * _grid[2], 1)}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

DATA, PP = 2, 2


def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def train(bundle, state, src, rounds, r, rows):
    step = jax.jit(bundle.train_step,
                   in_shardings=(bundle.state_shardings(),
                                 bundle.batch_shardings()),
                   out_shardings=(bundle.state_shardings(), None))
    losses = []
    for i in range(rounds):
        host = src.round_batch(i, r, rows)
        batch = {k: jax.device_put(jnp.asarray(host[k]), sh)
                 for k, sh in bundle.batch_shardings().items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return state, losses


def main(prefix, rounds, seq, r, mb):
    from repro import configs
    from repro.core.pipeline import build_pipeline
    from repro.data.pipeline import SyntheticLM
    from repro.launch.mesh import make_host_mesh
    from repro.optim import SGDM
    from repro.parallel.mesh import split_model_axis

    cfg = configs.get("qwen3-14b")
    spec = cfg.smoke_spec()
    plan = cfg.SMOKE_PLAN.with_(pp=PP, microbatches=r, stash_mode="stash",
                                schedule="1f1b", zero1=True)
    mesh = split_model_axis(make_host_mesh(data=DATA, model=PP), PP, 1)
    bundle = build_pipeline(spec, plan, mesh, seq_len=seq,
                            global_batch=DATA * r * mb,
                            optimizer=SGDM(lr=0.05),
                            compute_dtype=jnp.float32)
    state = jax.jit(bundle.init_state,
                    out_shardings=bundle.state_shardings())(jax.random.key(0))
    np.savez(f"{prefix}_init.npz", **flatten(jax.device_get(state)))
    state, losses = train(bundle, state, SyntheticLM(spec.vocab, seq, seed=1),
                          rounds, r, DATA * mb)
    final = flatten(jax.device_get(state))
    final["losses"] = np.asarray(losses)
    np.savez(f"{prefix}_final.npz", **final)


def main_grid(prefix, rounds, seq, r, mb, data, pp, tp, arch, mode,
              schedule, v, zero1, oracle=True):
    """The tiny spec's SPMD pipeline on a (data, pp, tp) mesh and JAX's
    sequential oracle from the same initial state (module docstring)."""
    import functools

    from repro.core.pipeline import build_pipeline
    from repro.core.reference import reference_init_state, reference_train_step
    from repro.data.pipeline import SyntheticLM
    from repro.launch.mesh import make_host_mesh
    from repro.optim import SGDM
    from repro.parallel.mesh import ParallelismPlan, split_model_axis
    from spmd_pipeline_check import build_tiny_spec

    spec = build_tiny_spec(arch)
    opt = SGDM(lr=0.05, momentum=0.9)
    src = SyntheticLM(spec.vocab, seq, seed=1)
    plan = ParallelismPlan(pp=abs(pp) or 1, tp=tp, microbatches=r,
                           stash_mode=mode, remat=True, zero1=zero1,
                           schedule=schedule, virtual_stages=v)
    if pp > 0:
        mesh = split_model_axis(make_host_mesh(data=data, model=pp * tp),
                                pp, tp)
        bundle = build_pipeline(spec, plan, mesh, seq_len=seq,
                                global_batch=data * r * mb, optimizer=opt,
                                compute_dtype=jnp.float32)
        state = jax.jit(bundle.init_state,
                        out_shardings=bundle.state_shardings())(
                            jax.random.key(0))
        init = jax.device_get(state)
        np.savez(f"{prefix}_init.npz", **flatten(init))
        state, losses = train(bundle, state, src, rounds, r, data * mb)
        final = flatten(jax.device_get(state))
        final["losses"] = np.asarray(losses)
        np.savez(f"{prefix}_final.npz", **final)
        ref = jax.tree.map(jnp.asarray, init)
    else:
        ref = reference_init_state(spec, plan, opt, jax.random.key(0),
                                   jnp.float32)
        np.savez(f"{prefix}_init.npz", **flatten(jax.device_get(ref)))
    if not oracle:
        return
    # the oracle over the whole batch, a compiled round (static tables)
    ref_round = jax.jit(functools.partial(reference_train_step, spec, plan,
                                          optimizer=opt,
                                          aux_weight=0.01))
    ref_losses = []
    for i in range(rounds):
        host = src.round_batch(i, r, data * mb)
        ref, m = ref_round(ref, {k: jnp.asarray(x) for k, x in host.items()})
        ref_losses.append(float(m["loss"]))
    out = flatten(jax.device_get(ref))
    out["losses"] = np.asarray(ref_losses)
    np.savez(f"{prefix}_ref.npz", **out)


if __name__ == "__main__":
    if len(sys.argv) > 6:
        a = sys.argv
        main_grid(a[1], *(int(x) for x in a[2:9]), a[9], a[10], a[11],
                  int(a[12]), bool(int(a[13])),
                  len(a) < 15 or bool(int(a[14])))
    else:
        main(sys.argv[1], *(int(a) for a in sys.argv[2:6]))
