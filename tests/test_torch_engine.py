"""The port's ``serve_1f`` engine against the JAX engine, and its own
invariants, on the CPU in fp32.

Both engines serve the same numpy weights.  The weights are rescaled
(embedding shrunk, attention and MLP output projections enlarged) so
that greedy tokens depend on attention: at the JAX init scale the token
embedding dominates the residual stream and tokens barely see attention
(checked here by perturbing one attention weight).  The comparison
covers page pools / dense caches and positions, not only tokens.  The
rwkv6 smoke spec (attention-free) is rescaled the same way on its
time-mix and channel-mix output projections, and compares its recurrent
states.
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
from repro.models import lm_head as jlm
from repro.models import stage as jstage
from repro.models.init import init_params as jax_init_params
from repro.parallel.mesh import ParallelismPlan as JPlan
from repro.parallel.mesh import split_model_axis
from repro.serving.engine import build_serving as jax_build_serving
from repro_torch.models import spec as tspec
from repro_torch.parallel.plan import ParallelismPlan as TPlan
from repro_torch.serving.allocator import CacheExhausted, PageAllocator
from repro_torch.serving.engine import build_serving
from test_paged import _attn_spec

R, ROWS, PREFILL, N_DEC, CACHE, PAGE = 2, 2, 12, 6, 32, 16
ATOL, RTOL = 2e-4, 1e-3


def _port_spec(jspec):
    d = {f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)}
    d["blocks"] = tuple(tspec.BlockSpec(**dataclasses.asdict(b))
                        for b in jspec.blocks)
    return tspec.ModelSpec(**d)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _weights(jspec, pp=1):
    """JAX-initialized numpy weights, rescaled so tokens see attention."""
    params, _ = jax_init_params(jspec, JPlan(pp=pp, tp=1), jax.random.key(7),
                                jnp.float32)
    params = jax.tree.map(lambda a: np.array(a), params)
    params["embed"] *= 0.05
    for lp in params["stages"].values():
        lp["attn"]["wo"] *= 40.0
        lp["mlp"]["w2"] *= 10.0
    return params


def _restack(params, pp_from, pp_to):
    """The same weights in a [pp_to] stage-stacked layout."""
    lps_from = len(params["stages"])
    layers = [_map(lambda a, s=s: a[s], params["stages"][f"layer_{i}"])
              for s in range(pp_from) for i in range(lps_from)]
    lps = len(layers) // pp_to
    out = dict(params)
    out["stages"] = {f"layer_{i}": _stack([layers[s * lps + i]
                                            for s in range(pp_to)])
                     for i in range(lps)}
    flat_w = np.asarray(params["layer_windows"]).reshape(-1)
    flat_t = np.asarray(params["layer_thetas"]).reshape(-1)
    out["layer_windows"] = flat_w.reshape(pp_to, lps)
    out["layer_thetas"] = flat_t.reshape(pp_to, lps)
    return out


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _prompts(vocab, seed=0):
    return np.random.default_rng(seed).integers(
        1, vocab, (R, ROWS, PREFILL)).astype(np.int32)


def _serve_port(spec, params, pp, page_size, prompts, check_alloc=False):
    sess = build_serving(spec, TPlan(pp=pp, tp=1, decode_microbatches=R),
                         cache_len=CACHE, global_batch=R * ROWS,
                         compute_dtype=torch.float32, page_size=page_size,
                         device="cpu").start()
    sess.load_params(params)
    nxt = sess.prefill({"tokens": prompts})
    toks, hidden = [nxt.numpy()], [sess.last_hidden.clone()]
    for _ in range(N_DEC):
        if check_alloc and sess._alloc is not None:
            sess._alloc.check()
        nxt = sess.decode(nxt)
        toks.append(nxt.numpy())
        hidden.append(sess.last_hidden.clone())
    if sess._alloc is not None:
        sess._alloc.check()
    return sess, np.stack(toks), hidden


@pytest.mark.parametrize("arch,page_size", [("paged-test", PAGE),
                                             ("paged-test", 0),
                                             ("qwen3-smoke", PAGE)])
def test_engine_matches_jax_engine(arch, page_size):
    jspec = (_attn_spec(n_layers=2) if arch == "paged-test"
             else jconfigs.get("qwen3-14b").smoke_spec())
    params = _weights(jspec)
    prompts = _prompts(jspec.vocab)

    mesh = split_model_axis(make_host_mesh(data=1, model=1), 1, 1)
    jplan = JPlan(pp=1, tp=1, microbatches=R, decode_microbatches=R,
                  schedule="serve_1f")
    js = jax_build_serving(jspec, jplan, mesh, cache_len=CACHE,
                           global_batch=R * ROWS, prefill_len=PREFILL,
                           compute_dtype=jnp.float32, page_size=page_size)
    js.start(jax.random.key(0))
    js.load_params(params)
    nxt = js.prefill({"tokens": jnp.asarray(prompts)})
    jtoks = [np.asarray(nxt)]
    for _ in range(N_DEC):
        nxt = js.decode(nxt)
        jtoks.append(np.asarray(nxt))

    ts, ttoks, _ = _serve_port(_port_spec(jspec), params, 1, page_size,
                               prompts)
    np.testing.assert_array_equal(ttoks, np.stack(jtoks))
    np.testing.assert_array_equal(ts._pos, np.asarray(js.state["pos"]))
    for name in (f"layer_{i}" for i in range(jspec.n_layers)):
        if page_size:
            np.testing.assert_array_equal(ts._alloc.tables,
                                          js._alloc.tables)
            got, want = ts.pages[name], js.state["pages"][name]
        else:
            got = ts.cache[name]["kv"]
            want = js.state["cache"][name]["kv"]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       rtol=RTOL)


def test_tokens_depend_on_attention():
    jspec = _attn_spec(n_layers=2)
    spec, params = _port_spec(jspec), _weights(jspec)
    prompts = _prompts(jspec.vocab)
    _, base, _ = _serve_port(spec, params, 1, PAGE, prompts)
    bumped = _map(np.copy, params)
    bumped["stages"]["layer_1"]["attn"]["wv"] *= -1.0
    _, other, _ = _serve_port(spec, bumped, 1, PAGE, prompts)
    assert (base != other).any()


def test_pp2_equals_pp1_bit_for_bit():
    jspec = _attn_spec(n_layers=2)
    spec = _port_spec(jspec)
    p1 = _weights(jspec)
    p2 = _restack(p1, 1, 2)
    prompts = _prompts(jspec.vocab, seed=3)
    s1, t1, h1 = _serve_port(spec, p1, 1, PAGE, prompts)
    s2, t2, h2 = _serve_port(spec, p2, 2, PAGE, prompts)
    assert s2.sched.n_stages == 2 and s2.sched.n_ticks == R + 1
    np.testing.assert_array_equal(t1, t2)
    for a, b in zip(h1, h2):
        assert torch.equal(a, b)
    for s in range(2):
        for k1, k2 in zip(s1.pages[f"layer_{s}"], s2.pages["layer_0"]):
            assert torch.equal(k1[0], k2[s])


def test_paged_decode_matches_dense_decode_and_allocator_holds():
    spec = _port_spec(_attn_spec(n_layers=2))
    params = _restack(_weights(_attn_spec(n_layers=2)), 1, 2)
    prompts = _prompts(spec.vocab, seed=5)
    sp, tp, hp = _serve_port(spec, params, 2, PAGE, prompts,
                             check_alloc=True)
    sd, td, hd = _serve_port(spec, params, 2, 0, prompts)
    np.testing.assert_array_equal(tp, td)
    for a, b in zip(hp, hd):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    n_keys = PREFILL + N_DEC
    for name, (kp, vp) in sp.pages.items():
        for pool, cache in zip((kp, vp), sd.cache[name]["kv"]):
            for m in range(R):
                ids = torch.from_numpy(sp._alloc.tables[m]).long()
                ids = ids[ids >= 0]
                got = pool[:, ids].transpose(1, 2).reshape(
                    pool.shape[0], ROWS, -1, *pool.shape[-2:])
                torch.testing.assert_close(got[:, :, :n_keys],
                                           cache[:, m, :, :n_keys],
                                           atol=1e-5, rtol=1e-5)
    assert sp._alloc.live_pages == R * -(-n_keys // PAGE)


def test_decode_raises_cache_exhausted_before_mutating():
    spec = _port_spec(_attn_spec(n_layers=2))
    sess = build_serving(spec, TPlan(pp=1, tp=1, decode_microbatches=R),
                         cache_len=PAGE, global_batch=R * ROWS,
                         compute_dtype=torch.float32, page_size=PAGE,
                         device="cpu").start()
    nxt = sess.prefill({"tokens": np.ones((R, ROWS, PAGE), np.int32)})
    before = sess._alloc.tables.copy()
    with pytest.raises(CacheExhausted) as e:
        sess.decode(nxt)
    assert e.value.slots == tuple(range(R))
    np.testing.assert_array_equal(sess._alloc.tables, before)
    sess._alloc.check()


def test_build_serving_validates():
    spec = _port_spec(_attn_spec(n_layers=2))
    with pytest.raises(ValueError, match="multiple"):
        build_serving(spec, TPlan(pp=1, tp=1), cache_len=100,
                      global_batch=2, page_size=16, device="cpu")
    with pytest.raises(ValueError, match="tp"):
        build_serving(spec, TPlan(pp=1, tp=2), cache_len=64,
                      global_batch=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_serving(spec, TPlan(pp=1, tp=1), cache_len=64,
                          global_batch=2)


def test_allocator_matches_jax_allocator_under_a_trace():
    from repro.serving.batcher import PageAllocator as JAlloc
    ops = [("alloc", 0, 17), ("alloc", 1, 8), ("extend", 0, 33),
           ("extend", 1, 9), ("release", 0, 0), ("alloc", 2, 40),
           ("extend", 1, 16), ("alloc", 0, 5)]
    mine, ref = PageAllocator(16, 3, 4, 16), JAlloc(16, 3, 4, 16)
    for op, slot, n in ops:
        for a in (mine, ref):
            {"alloc": a.alloc_slot, "extend": a.extend_slot,
             "release": lambda s, _n, a=a: a.release_slot(s)}[op](slot, n)
        np.testing.assert_array_equal(mine.tables, ref.tables)
        assert mine.free == ref.free
        mine.check()
    mine.tables[1, 0] = mine.tables[0, 0]
    with pytest.raises(AssertionError):
        mine.check()


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                "--page-size", "16", "--batch", "4", "--prefill", "8",
                "--tokens", "3", "--cache-len", "32"])
    out = capsys.readouterr().out
    assert "serve_1f (S=2 R=4" in out and "decoded 3 steps x 4 seqs" in out


# --------------------------------------------------------------------------
# rwkv6: recurrent per-slot state through the same engine
# --------------------------------------------------------------------------

RWKV_TOL = 1e-4


def _rwkv_weights(jspec, pp=1):
    """JAX-initialized numpy weights of an rwkv spec, rescaled so that
    tokens see the time-mix (same factors as :func:`_weights`)."""
    params, _ = jax_init_params(jspec, JPlan(pp=pp, tp=1), jax.random.key(7),
                                jnp.float32)
    params = jax.tree.map(lambda a: np.array(a), params)
    params["embed"] *= 0.05
    for lp in params["stages"].values():
        lp["tmix"]["wo"] *= 40.0
        lp["cmix"]["wv"] *= 10.0
    return params


def _state_np(tree):
    """{'layer_i': {"tmix": (x_prev, wkv), "cmix": x_prev}} as numpy."""
    return jax.tree.map(lambda a: np.array(a), tree)


@functools.lru_cache(maxsize=None)
def _jax_rwkv_run():
    """The JAX engine on the rwkv6 smoke spec, fp32, pp 1: tokens and
    states after prefill + N_DEC decodes, then after a second prefill of
    other prompts on the same session; plus the JAX ``full_transformer``
    last-position hidden state over the served sequence (the JAX engine
    keeps none)."""
    jspec = jconfigs.get("rwkv6-1.6b").smoke_spec()
    params = _rwkv_weights(jspec)
    mesh = split_model_axis(make_host_mesh(data=1, model=1), 1, 1)
    jplan = JPlan(pp=1, tp=1, microbatches=R, decode_microbatches=R,
                  schedule="serve_1f")
    js = jax_build_serving(jspec, jplan, mesh, cache_len=CACHE,
                           global_batch=R * ROWS, prefill_len=PREFILL,
                           compute_dtype=jnp.float32)
    js.start(jax.random.key(0))
    js.load_params(params)
    prompts = _prompts(jspec.vocab)
    nxt = js.prefill({"tokens": jnp.asarray(prompts)})
    toks = [np.asarray(nxt)]
    for _ in range(N_DEC):
        nxt = js.decode(nxt)
        toks.append(np.asarray(nxt))
    toks = np.stack(toks)
    state = _state_np(js.state["cache"])
    seq = np.concatenate([prompts.reshape(R * ROWS, PREFILL),
                          toks[:-1].T], axis=1)
    st = jstage.make_statics(jspec, jplan, tokens_per_mb=seq.size)
    jp = jax.tree.map(jnp.asarray, params)
    pos = np.broadcast_to(np.arange(seq.shape[1]), seq.shape)
    h, _ = jstage.full_transformer(
        jp, jlm.embed_tokens(jp["embed"], jnp.asarray(seq)), st,
        positions=jnp.asarray(pos))
    hidden = np.asarray(h[:, -1:])
    prompts2 = _prompts(jspec.vocab, seed=11)
    toks2 = np.asarray(js.prefill({"tokens": jnp.asarray(prompts2)}))
    state2 = _state_np(js.state["cache"])
    return {"spec": jspec, "params": params, "prompts": prompts,
            "toks": toks, "state": state, "hidden": hidden,
            "prompts2": prompts2, "toks2": toks2, "state2": state2}


def _assert_rwkv_state(sess, want, tol=RWKV_TOL):
    for name, layer in want.items():
        got = sess.cache[name]
        assert set(got) == set(layer) == {"tmix", "cmix"}
        pairs = list(zip(got["tmix"], layer["tmix"]))
        pairs.append((got["cmix"], layer["cmix"]))
        for g, w in pairs:
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=tol)


@pytest.mark.parametrize("page_size", [0, PAGE])
def test_rwkv_engine_matches_jax_engine(page_size):
    """Tokens, recurrent states and the last hidden state after prefill +
    6 decodes.  The model has no attention layer, so ``page_size`` has
    nothing to page: the state stays dense and the run is the same."""
    ref = _jax_rwkv_run()
    spec = _port_spec(ref["spec"])
    sess, toks, hidden = _serve_port(spec, ref["params"], 1, page_size,
                                     ref["prompts"])
    assert sess.paged is None and sess.pages is None and sess._alloc is None
    np.testing.assert_array_equal(toks, ref["toks"])
    _assert_rwkv_state(sess, ref["state"])
    np.testing.assert_allclose(hidden[-1].numpy(), ref["hidden"],
                               atol=RWKV_TOL, rtol=RWKV_TOL)
    np.testing.assert_array_equal(sess._pos, PREFILL + N_DEC)


def test_rwkv_second_prefill_continues_recurrent_state_as_jax_does():
    """A second ``prefill`` on a session reads the recurrent state the
    slots hold (token shift and WKV start from it), as the JAX engine's
    does; it is not a fresh session's prefill."""
    ref = _jax_rwkv_run()
    spec = _port_spec(ref["spec"])
    sess, _, _ = _serve_port(spec, ref["params"], 1, 0, ref["prompts"])
    toks2 = sess.prefill({"tokens": ref["prompts2"]}).numpy()
    np.testing.assert_array_equal(toks2, ref["toks2"])
    _assert_rwkv_state(sess, ref["state2"])
    fresh = build_serving(spec, TPlan(pp=1, tp=1, decode_microbatches=R),
                          cache_len=CACHE, global_batch=R * ROWS,
                          compute_dtype=torch.float32, device="cpu").start()
    fresh.load_params(ref["params"])
    fresh.prefill({"tokens": ref["prompts2"]})
    wkv, wkv_fresh = (s.cache["layer_0"]["tmix"][1] for s in (sess, fresh))
    assert not torch.allclose(wkv, wkv_fresh, atol=1e-3)


def test_rwkv_pp2_equals_pp1_bit_for_bit():
    ref = _jax_rwkv_run()
    spec = _port_spec(ref["spec"])
    p2 = _restack(ref["params"], 1, 2)
    s1, t1, h1 = _serve_port(spec, ref["params"], 1, 0, ref["prompts"])
    s2, t2, h2 = _serve_port(spec, p2, 2, 0, ref["prompts"])
    assert s2.sched.n_stages == 2 and s2.sched.n_ticks == R + 1
    np.testing.assert_array_equal(t1, t2)
    for a, b in zip(h1, h2):
        assert torch.equal(a, b)
    lps = spec.n_layers // 2
    for i in range(spec.n_layers):
        st, name = divmod(i, lps)
        got = s2.cache[f"layer_{name}"]
        want = s1.cache[f"layer_{i}"]
        for g, w in zip((*got["tmix"], got["cmix"]),
                        (*want["tmix"], want["cmix"])):
            assert torch.equal(g[st], w[0])


def test_rwkv_tokens_depend_on_time_mix():
    """At the rescaled weights the greedy tokens see the time-mix: one
    flipped time-mix value projection changes them (at the JAX init
    scale they do not, ROADMAP Queue 3)."""
    ref = _jax_rwkv_run()
    spec = _port_spec(ref["spec"])
    bumped = _map(np.copy, ref["params"])
    bumped["stages"]["layer_1"]["tmix"]["wv"] *= -1.0
    _, other, _ = _serve_port(spec, bumped, 1, 0, ref["prompts"])
    assert (other != ref["toks"]).any()


def test_serve_cli_runs_rwkv6_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                "--batch", "4", "--prefill", "8", "--tokens", "3",
                "--cache-len", "32"])
    out = capsys.readouterr().out
    assert "serve_1f (S=2 R=4" in out and "decoded 3 steps x 4 seqs" in out
