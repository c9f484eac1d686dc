"""JAX's serving engine on a (data, stage, tensor) mesh of emulated host
devices, for tests/test_torch_serve_grid.py, run as a subprocess: it
sets the host device count before jax is imported.

  python tests/_torch_serve_grid_jax.py OUT_PREFIX DATA PP TP R ROWS \\
      PREFILL CACHE PAGE DECODES

The qwen3 smoke spec in fp32 on ``serve_1f`` (pp stages, tp tensor
ranks, R slots of ROWS rows, paged KV of PAGE-token pages): the
session's own initial weights with the embedding x0.05, ``wo`` x40 and
``w2`` x10 (so greedy tokens see attention, as tests/test_torch_engine.py
rescales them), installed with ``load_params``; a prefill of PREFILL
random tokens a row (seed 0, as
``_torch_dist_worker.serve_prompts`` draws them), then DECODES decode steps.  Writes
``OUT_PREFIX_params.npz`` (the weights, ``path -> array``, storage
order) and ``OUT_PREFIX_out.npz``: ``tokens`` (1 + DECODES, R·ROWS),
``prompts`` and ``hidden`` (DECODES, R·ROWS, 1, d), the hidden state
each decode step's head read (taken from ``lm_head.sample_greedy``'s
argument by a debug callback).
"""
import os
import sys

if __name__ == "__main__":
    _n = 1
    for a in sys.argv[2:5]:
        _n *= int(a)
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                               f"{_n}")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def main(argv):
    from repro import configs
    from repro.launch.mesh import make_host_mesh
    from repro.models import lm_head
    from repro.parallel.mesh import split_model_axis
    from repro.serving.engine import build_serving
    prefix = argv[0]
    data, pp, tp, R, rows, prefill, cache, page, decodes = map(int, argv[1:])
    hidden = []
    greedy = lm_head.sample_greedy

    def sample_greedy(head, scale, h, **kw):
        jax.debug.callback(lambda x: hidden.append(np.asarray(x)), h)
        return greedy(head, scale, h, **kw)

    lm_head.sample_greedy = sample_greedy
    cfg = configs.get("qwen3-14b")
    spec = cfg.smoke_spec()
    plan = cfg.SMOKE_PLAN.with_(pp=pp, tp=tp, decode_microbatches=R,
                                schedule="serve_1f")
    mesh = split_model_axis(make_host_mesh(data=data, model=pp * tp), pp, tp)
    session = build_serving(spec, plan, mesh, cache_len=cache,
                            global_batch=R * rows * data, prefill_len=prefill,
                            compute_dtype=jnp.float32, page_size=page)
    session.start(jax.random.key(0))
    params = jax.tree.map(lambda a: np.array(a), session.state["params"])
    params["embed"] *= 0.05
    for lp in params["stages"].values():
        lp["attn"]["wo"] *= 40.0
        lp["mlp"]["w2"] *= 10.0
    session.load_params(params)
    np.savez(f"{prefix}_params.npz", **flatten(params))
    prompts = np.random.default_rng(0).integers(
        0, spec.vocab, (R, rows * data, prefill)).astype(np.int32)
    nxt = session.prefill({"tokens": jnp.asarray(prompts)})
    toks = [np.asarray(nxt)]
    hidden.clear()
    for _ in range(decodes):
        nxt = session.decode(nxt)
        toks.append(np.asarray(nxt))
    jax.effects_barrier()
    np.savez(f"{prefix}_out.npz", tokens=np.stack(toks), prompts=prompts,
             hidden=np.stack(hidden))


if __name__ == "__main__":
    main(sys.argv[1:])
