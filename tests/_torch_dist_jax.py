"""JAX's SPMD pipeline at data 2 x pp 2 for tests/test_torch_dist_jax.py,
run as a subprocess: it sets the host device count before jax is
imported.

  python tests/_torch_dist_jax.py OUT_PREFIX ROUNDS SEQ R MB

Builds ``repro.core.pipeline.build_pipeline`` for the qwen3 smoke spec
in fp32 (1f1b / stash, ZeRO-1 on, SGD with momentum 0.05) on a (data 2,
stage 2, tensor 1) mesh of emulated host devices, trains ROUNDS rounds
of the SyntheticLM stream (seed 1, R microbatches of 2·MB rows) and
writes ``OUT_PREFIX_init.npz`` (the initial state, ``path -> array``)
and ``OUT_PREFIX_final.npz`` (the final state and ``losses``).
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

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
    step = jax.jit(bundle.train_step,
                   in_shardings=(bundle.state_shardings(),
                                 bundle.batch_shardings()),
                   out_shardings=(bundle.state_shardings(), None))
    src = SyntheticLM(spec.vocab, seq, seed=1)
    losses = []
    for i in range(rounds):
        host = src.round_batch(i, r, DATA * mb)
        batch = {k: jax.device_put(jnp.asarray(host[k]), sh)
                 for k, sh in bundle.batch_shardings().items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    final = flatten(jax.device_get(state))
    final["losses"] = np.asarray(losses)
    np.savez(f"{prefix}_final.npz", **final)


if __name__ == "__main__":
    main(sys.argv[1], *(int(a) for a in sys.argv[2:6]))
