"""The port's ``serve_1f`` engine on the jamba smoke spec (Mamba + MoE +
attention) against the JAX engine, and its own invariants, on the CPU in
fp32.

Both engines serve the same numpy weights, rescaled so that greedy tokens
see the mixers (embedding x0.05; attention ``wo`` and expert ``w2`` x40;
dense ``w2`` x10; Mamba ``out_proj`` x4): at the JAX init scale the token
embedding dominates the residual stream (ROADMAP Queue 3), checked here
by flipping one Mamba weight.  The Mamba input path is enlarged too
(``in_x`` x10, ``conv_w`` x5, ``x_proj`` x10): at the init scale the SSM
states stay below 1e-4, where a 2e-4 tolerance would compare nothing;
rescaled they reach ~10-100.  The comparison covers positions, page
pools or dense KV caches, conv tails and SSM states, not only tokens.

The JAX-engine shape is R = 2 slots x 1 row with a 4-token prompt: 4
tokens per microbatch, so the capacity floor of 4 holds every (token,
choice) pair and no expert can overflow; decode routes 1 token.  The JAX
MoE scatter fault (tests/test_torch_moe.py) therefore cannot show.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.mesh import make_host_mesh
from repro.models.init import init_params as jax_init_params
from repro.parallel.mesh import ParallelismPlan as JPlan
from repro.parallel.mesh import split_model_axis
from repro.serving.engine import build_serving as jax_build_serving
from repro_torch.models import spec as tspec
from repro_torch.parallel.plan import ParallelismPlan as TPlan
from repro_torch.serving.engine import build_serving

R, ROWS, PREFILL, N_DEC, CACHE, PAGE = 2, 1, 4, 6, 32, 8
ATOL, RTOL = 2e-4, 1e-3


def _port_spec(jspec):
    d = {f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)}
    d["blocks"] = tuple(tspec.BlockSpec(**dataclasses.asdict(b))
                        for b in jspec.blocks)
    d["moe"] = tspec.MoESpec(**dataclasses.asdict(jspec.moe))
    d["mamba"] = tspec.MambaSpec(**dataclasses.asdict(jspec.mamba))
    return tspec.ModelSpec(**d)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _weights(jspec):
    """JAX-initialized numpy weights (pp 1), rescaled so tokens see the
    mixers and the experts."""
    params, _ = jax_init_params(jspec, JPlan(pp=1, tp=1), jax.random.key(7),
                                jnp.float32)
    params = jax.tree.map(lambda a: np.array(a), params)
    params["embed"] *= 0.05
    for lp in params["stages"].values():
        if "attn" in lp:
            lp["attn"]["wo"] *= 40.0
        if "mamba" in lp:
            for key, f in (("in_x", 10.0), ("conv_w", 5.0), ("x_proj", 10.0),
                           ("out_proj", 4.0)):
                lp["mamba"][key] *= f
        if "moe" in lp:
            lp["moe"]["w2"] *= 40.0
        if "mlp" in lp:
            lp["mlp"]["w2"] *= 10.0
    return params


def _restack(params, pp_to):
    """The same weights in a [pp_to] stage-stacked layout (from pp 1)."""
    n = len(params["stages"])
    lps = n // pp_to
    layers = [_map(lambda a: a[0], params["stages"][f"layer_{i}"])
              for i in range(n)]
    out = dict(params)
    out["stages"] = {f"layer_{i}": _stack([layers[s * lps + i]
                                            for s in range(pp_to)])
                     for i in range(lps)}
    out["layer_windows"] = np.asarray(params["layer_windows"]).reshape(
        pp_to, lps)
    out["layer_thetas"] = np.asarray(params["layer_thetas"]).reshape(
        pp_to, lps)
    return out


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _prompts(vocab, seed, rows=ROWS, prefill=PREFILL):
    return np.random.default_rng(seed).integers(
        1, vocab, (R, rows, prefill)).astype(np.int32)


def _serve_port(spec, params, pp, page_size, prompts, n_dec=N_DEC):
    rows, prefill = prompts.shape[1:]
    sess = build_serving(spec, TPlan(pp=pp, tp=1, decode_microbatches=R),
                         cache_len=CACHE, global_batch=R * rows,
                         compute_dtype=torch.float32, page_size=page_size,
                         prefill_len=prefill, device="cpu").start()
    sess.load_params(params)
    nxt = sess.prefill({"tokens": prompts})
    toks, hidden = [nxt.numpy()], [sess.last_hidden.clone()]
    for _ in range(n_dec):
        nxt = sess.decode(nxt)
        toks.append(nxt.numpy())
        hidden.append(sess.last_hidden.clone())
    if sess._alloc is not None:
        sess._alloc.check()
    return sess, np.stack(toks), hidden


@functools.lru_cache(maxsize=None)
def _jax_run(page_size):
    """The JAX engine on the rescaled jamba smoke spec, fp32, pp 1:
    tokens, positions, state and pools after prefill + N_DEC decodes;
    on the dense run also after a second prefill of other prompts on the
    same session."""
    jspec = jconfigs.get("jamba-v0.1-52b").smoke_spec()
    params = _weights(jspec)
    mesh = split_model_axis(make_host_mesh(data=1, model=1), 1, 1)
    jplan = JPlan(pp=1, tp=1, microbatches=R, decode_microbatches=R,
                  schedule="serve_1f")
    js = jax_build_serving(jspec, jplan, mesh, cache_len=CACHE,
                           global_batch=R * ROWS, prefill_len=PREFILL,
                           compute_dtype=jnp.float32, page_size=page_size)
    js.start(jax.random.key(0))
    js.load_params(params)
    prompts = _prompts(jspec.vocab, seed=0)
    nxt = js.prefill({"tokens": jnp.asarray(prompts)})
    toks = [np.asarray(nxt)]
    for _ in range(N_DEC):
        nxt = js.decode(nxt)
        toks.append(np.asarray(nxt))
    take = lambda tree: jax.tree.map(lambda a: np.array(a), tree)
    out = {"spec": jspec, "params": params, "prompts": prompts,
           "toks": np.stack(toks), "pos": np.array(js.state["pos"]),
           "cache": take(js.state["cache"])}
    if page_size:
        out["pages"] = take(js.state["pages"])
        out["tables"] = np.array(js._alloc.tables)
    else:
        out["prompts2"] = _prompts(jspec.vocab, seed=11)
        out["toks2"] = np.asarray(js.prefill(
            {"tokens": jnp.asarray(out["prompts2"])}))
        out["cache2"] = take(js.state["cache"])
    return out


def _assert_state(sess, cache, tol=ATOL):
    """Conv tails and SSM states of every Mamba layer, and the dense KV
    caches of attention layers that are not paged, against JAX's."""
    h = [layer["ssm"][1] for layer in cache.values() if "ssm" in layer]
    assert max(np.abs(a).max() for a in h) > 1.0     # not vacuous
    n_ssm = 0
    for name, layer in cache.items():
        got = sess.cache[name]
        assert set(got) == set(layer), (name, set(got), set(layer))
        for key in layer:
            for g, w in zip(got[key], layer[key]):
                assert tuple(g.shape) == w.shape, (name, key)
                np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=RTOL)
        n_ssm += "ssm" in layer
    assert n_ssm == 6          # 6 of the smoke spec's 8 layers are Mamba


@pytest.mark.parametrize("page_size", [0, PAGE])
def test_jamba_engine_matches_jax_engine(page_size):
    """Tokens, positions, page pools (and tables) or dense KV caches,
    conv tails and SSM states after prefill + 6 decodes."""
    ref = _jax_run(page_size)
    spec = _port_spec(ref["spec"])
    sess, toks, _ = _serve_port(spec, ref["params"], 1, page_size,
                                ref["prompts"])
    assert sess.statics.moe.capacity == 4
    np.testing.assert_array_equal(toks, ref["toks"])
    np.testing.assert_array_equal(sess._pos, ref["pos"])
    _assert_state(sess, ref["cache"])
    if page_size:
        np.testing.assert_array_equal(sess._alloc.tables, ref["tables"])
        assert set(sess.pages) == set(ref["pages"]) == {"layer_0",
                                                        "layer_4"}
        for name, pools in ref["pages"].items():
            for g, w in zip(sess.pages[name], pools):
                np.testing.assert_allclose(g.numpy(), w, atol=ATOL,
                                           rtol=RTOL)


def test_jamba_second_prefill_continues_state_as_jax_does():
    """A second ``prefill`` reads the conv tails and SSM states the slots
    hold, as the JAX engine's does; a fresh session's prefill differs."""
    ref = _jax_run(0)
    spec = _port_spec(ref["spec"])
    sess, _, _ = _serve_port(spec, ref["params"], 1, 0, ref["prompts"])
    toks2 = sess.prefill({"tokens": ref["prompts2"]}).numpy()
    np.testing.assert_array_equal(toks2, ref["toks2"])
    _assert_state(sess, ref["cache2"])
    fresh, _, _ = _serve_port(spec, ref["params"], 1, 0, ref["prompts2"],
                              n_dec=0)
    h, h_fresh = (s.cache["layer_1"]["ssm"][1] for s in (sess, fresh))
    assert not torch.allclose(h, h_fresh, atol=1e-3)


def test_jamba_tokens_depend_on_mamba():
    """At the rescaled weights the greedy tokens see a Mamba mixer: one
    flipped input projection changes them (at the JAX init scale they
    barely do, ROADMAP Queue 3)."""
    ref = _jax_run(0)
    spec = _port_spec(ref["spec"])
    bumped = _map(np.copy, ref["params"])
    bumped["stages"]["layer_1"]["mamba"]["in_x"] *= -1.0
    _, other, _ = _serve_port(spec, bumped, 1, 0, ref["prompts"])
    assert (other != ref["toks"]).any()


def test_jamba_pp2_equals_pp1_bit_for_bit():
    ref = _jax_run(0)
    spec = _port_spec(ref["spec"])
    p2 = _restack(ref["params"], 2)
    prompts = _prompts(spec.vocab, seed=3, rows=2, prefill=6)
    s1, t1, h1 = _serve_port(spec, ref["params"], 1, PAGE, prompts)
    s2, t2, h2 = _serve_port(spec, p2, 2, PAGE, prompts)
    assert s2.sched.n_stages == 2 and s2.sched.n_ticks == R + 1
    np.testing.assert_array_equal(t1, t2)
    for a, b in zip(h1, h2):
        assert torch.equal(a, b)
    lps = spec.n_layers // 2
    for i in range(spec.n_layers):
        st, j = divmod(i, lps)
        got, want = s2.cache[f"layer_{j}"], s1.cache[f"layer_{i}"]
        for g, w in zip(got.get("ssm", ()), want.get("ssm", ())):
            assert torch.equal(g[st], w[0])
    for i in (0, 4):
        for k2, k1 in zip(s2.pages[f"layer_{i % lps}"],
                          s1.pages[f"layer_{i}"]):
            assert torch.equal(k2[i // lps], k1[0])


def test_jamba_paged_decode_matches_dense_decode():
    """Paged and dense KV give the same tokens, hidden states and Mamba
    states, and the live pages hold the dense caches' keys (2 rows per
    slot, pp 2)."""
    spec = _port_spec(_jax_run(0)["spec"])
    params = _restack(_jax_run(0)["params"], 2)
    prompts = _prompts(spec.vocab, seed=5, rows=2, prefill=10)
    sp, tp, hp = _serve_port(spec, params, 2, PAGE, prompts)
    sd, td, hd = _serve_port(spec, params, 2, 0, prompts)
    np.testing.assert_array_equal(tp, td)
    for a, b in zip(hp, hd):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    n_keys = 10 + N_DEC
    for name, (kp, vp) in sp.pages.items():
        for pool, cache in zip((kp, vp), sd.cache[name]["kv"]):
            for m in range(R):
                ids = torch.from_numpy(sp._alloc.tables[m]).long()
                ids = ids[ids >= 0]
                got = pool[:, ids].transpose(1, 2).reshape(
                    pool.shape[0], 2, -1, *pool.shape[-2:])
                torch.testing.assert_close(got[:, :, :n_keys],
                                           cache[:, m, :, :n_keys],
                                           atol=1e-5, rtol=1e-5)
    for name, layer in sd.cache.items():
        for g, w in zip(sp.cache[name].get("ssm", ()), layer.get("ssm", ())):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_prefill_len_sets_moe_capacity_as_jax_does():
    spec = _port_spec(jconfigs.get("jamba-v0.1-52b").smoke_spec())
    for rows, prefill, cap in ((1, 4, 4), (2, 8, 10), (4, 0, 4)):
        sess = build_serving(spec, TPlan(pp=2, tp=1, decode_microbatches=R),
                             cache_len=CACHE, global_batch=R * rows,
                             compute_dtype=torch.float32,
                             prefill_len=prefill, device="cpu")
        assert sess.statics.moe.capacity == cap


def test_serve_cli_runs_jamba_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "jamba-v0.1-52b", "--smoke", "--device", "cpu",
                "--page-size", "16", "--batch", "4", "--prefill", "8",
                "--tokens", "3", "--cache-len", "32"])
    out = capsys.readouterr().out
    assert "serve_1f (S=2 R=4" in out and "decoded 3 steps x 4 seqs" in out
    assert "paged KV: page_size=16" in out
