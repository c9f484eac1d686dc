"""JAX's sequence-parallel decode (``build_serving(sp=True)``) on a
(data, stage) mesh of emulated host devices, for
tests/test_torch_serve_sp.py, run as a subprocess: it sets the host device
count before jax is imported.

  python tests/_torch_serve_sp_jax.py OUT_PREFIX CASE[,CASE...] DATA PP \\
      CACHE DECODES

Each CASE is ``ARCH:V`` (``gemma3:1``, ``jamba:1``, ``gemma3x8:2``;
:func:`spec_of` names the specs): the smoke spec in fp32 on ``serve_1f``
(V 1) or ``serve_interleaved`` (V 2), one row (global batch 1, R 1), the
session's own initial weights rescaled as
tests/_torch_serve_grid_jax.py rescales them (the embedding x0.05,
attention ``wo`` x40, FFN and expert ``w2`` x10, jamba's Mamba input
path as tests/test_torch_jamba_engine.py), installed with
``load_params``; then DECODES decode steps from position 0, the first
fed token 1.  Writes, per case, ``OUT_PREFIX_<case>_params.npz`` (the
weights, ``path -> array``, storage order) and ``_out.npz``: ``tokens``
(1 + DECODES, 1), ``hidden`` (DECODES, 1, 1, d) the hidden state each
step's head read (a debug callback on ``lm_head.sample_greedy``'s
argument, once per step), and ``cache/<path>`` every KV cache leaf as
the global array (n_chunks, R, rows, L, KV, Dh): a sequence-sharded one
is the data ranks' shards in rank order along L.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                               f"{int(sys.argv[3]) * int(sys.argv[4])}")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

#: the mamba input path's rescale (tests/test_torch_jamba_engine.py)
MAMBA_SCALE = (("in_x", 10.0), ("conv_w", 5.0), ("x_proj", 10.0),
               ("out_proj", 4.0))


def spec_of(configs, name):
    """``gemma3`` / ``jamba``: the registry's smoke specs; ``gemma3x8``:
    gemma3's smoke spec at 8 layers, windowed (8) and global by turns,
    so that pp 2 x v 2 chunks hold one of each."""
    import dataclasses
    if name == "jamba":
        return configs.get("jamba-v0.1-52b").smoke_spec()
    spec = configs.get("gemma3-4b").smoke_spec()
    if name == "gemma3x8":
        blocks = tuple(spec.blocks[0 if i % 2 == 0 else 2]
                       for i in range(8))
        spec = dataclasses.replace(spec, name="gemma3-smoke-8l", n_layers=8,
                                   blocks=blocks)
    return spec


def rescale(params):
    params["embed"] *= 0.05
    for lp in params["stages"].values():
        if "attn" in lp:
            lp["attn"]["wo"] *= 40.0
        if "mamba" in lp:
            for key, f in MAMBA_SCALE:
                lp["mamba"][key] *= f
        ffn = lp.get("mlp") or lp["moe"]
        ffn["w2"] *= 10.0
    return params


def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def run_case(prefix, name, v, data, pp, cache, decodes):
    from repro import configs
    from repro.launch.mesh import make_host_mesh
    from repro.models import lm_head
    from repro.parallel.mesh import split_model_axis
    from repro.serving.engine import build_serving
    hidden = []
    greedy = lm_head.sample_greedy

    def sample_greedy(head, scale, h, **kw):
        jax.debug.callback(lambda x: hidden.append(np.asarray(x)), h)
        return greedy(head, scale, h, **kw)

    lm_head.sample_greedy = sample_greedy
    arch = "jamba-v0.1-52b" if name == "jamba" else "gemma3-4b"
    spec = spec_of(configs, name)
    plan = configs.get(arch).SMOKE_PLAN.with_(
        pp=pp, tp=1, decode_microbatches=1, virtual_stages=v,
        schedule="serve_interleaved" if v > 1 else "serve_1f")
    mesh = split_model_axis(make_host_mesh(data=data, model=pp), pp, 1)
    session = build_serving(spec, plan, mesh, cache_len=cache,
                            global_batch=1, sp=True,
                            compute_dtype=jnp.float32)
    session.start(jax.random.key(0))
    params = rescale(jax.tree.map(lambda a: np.array(a),
                                  session.state["params"]))
    session.load_params(params)
    np.savez(f"{prefix}_{name}_params.npz", **flatten(params))
    nxt = jnp.ones((1,), jnp.int32)
    toks = [np.asarray(nxt)]
    steps = []
    for _ in range(decodes):
        hidden.clear()
        nxt = session.decode(nxt)
        toks.append(np.asarray(nxt))
        jax.effects_barrier()
        # one callback a device of the last stage: every copy the same
        assert hidden and all(np.array_equal(h, hidden[0]) for h in hidden)
        steps.append(hidden[0])
    cache_leaves = {f"cache/{k}": a
                    for k, a in flatten(session.state["cache"]).items()}
    np.savez(f"{prefix}_{name}_out.npz", tokens=np.stack(toks),
             hidden=np.stack(steps), **cache_leaves)
    lm_head.sample_greedy = greedy


def main(argv):
    prefix, cases = argv[0], argv[1].split(",")
    data, pp, cache, decodes = map(int, argv[2:6])
    for case in cases:
        name, v = case.split(":")
        run_case(prefix, name, int(v), data, pp, cache, decodes)


if __name__ == "__main__":
    main(sys.argv[1:])
