"""The port's quantized serving (``build_serving(weight_dtype=,
kv_dtype=)``) against the JAX engine, and its own invariants, on the CPU
in fp32.

Both engines get the same numpy weights through ``load_params``, so
both cast and then quantize them.  The weights are rescaled as in
tests/test_torch_engine.py (qwen3) and tests/test_torch_jamba_engine.py
(jamba) so that tokens depend on attention and the mixers.  Prompts are
not a page multiple, so decode requantizes a partly filled int8 page.
jamba runs at R = 2 slots x 1 row with a 4-token prompt: 4 tokens per
microbatch, within the capacity floor of 4, so no expert can drop a
pair (the JAX scatter fault of ROADMAP Queue 3 cannot show).

After prefill + 6 decodes: tokens and positions equal; int8 pool
payloads within 1 (a requantized page's scale may round differently in
the last f32 bit, moving a payload by one step); scale planes within
rtol 1e-5; dense caches, conv tails and SSM states within the engine
tests' 2e-4 / 1e-3, except that a bf16 dense cache is held at one bf16
step beyond the prompt (see :func:`_assert_bf16_cache`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.mesh import make_host_mesh
from repro.parallel.mesh import ParallelismPlan as JPlan
from repro.parallel.mesh import split_model_axis
from repro.serving.engine import build_serving as jax_build_serving
from repro_torch.parallel.plan import ParallelismPlan as TPlan
from repro_torch.serving.engine import build_serving
from test_paged import _attn_spec
from test_torch_engine import _port_spec, _restack
from test_torch_engine import _weights as _qwen_weights
from test_torch_jamba_engine import _port_spec as _jamba_port_spec
from test_torch_jamba_engine import _weights as _jamba_weights

N_DEC, CACHE, PAGE = 6, 32, 16
ATOL, RTOL = 2e-4, 1e-3
SCALE_RTOL = 1e-5

# name -> (arch, weight_dtype, kv_dtype, page_size, R, rows, prefill)
CASES = {
    "qwen3-int8-int8-paged": ("qwen3-14b", "int8", "int8", PAGE, 2, 2, 12),
    "qwen3-fp8-bf16-dense": ("qwen3-14b", "fp8", "bf16", 0, 2, 2, 12),
    "jamba-int8-int8-paged": ("jamba-v0.1-52b", "int8", "int8", PAGE, 2, 1,
                              4),
}


def _case(name):
    arch, w, kv, page, r, rows, prefill = CASES[name]
    jspec = jconfigs.get(arch).smoke_spec()
    jamba = arch.startswith("jamba")
    params = (_jamba_weights if jamba else _qwen_weights)(jspec)
    spec = (_jamba_port_spec if jamba else _port_spec)(jspec)
    prompts = np.random.default_rng(0).integers(
        1, jspec.vocab, (r, rows, prefill)).astype(np.int32)
    return jspec, spec, params, prompts, w, kv, page, r, rows, prefill


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    jspec, _, params, prompts, w, kv, page, r, rows, prefill = _case(name)
    mesh = split_model_axis(make_host_mesh(data=1, model=1), 1, 1)
    jplan = JPlan(pp=1, tp=1, microbatches=r, decode_microbatches=r,
                  schedule="serve_1f")
    js = jax_build_serving(jspec, jplan, mesh, cache_len=CACHE,
                           global_batch=r * rows, prefill_len=prefill,
                           compute_dtype=jnp.float32, page_size=page,
                           weight_dtype=w, kv_dtype=kv)
    js.start(jax.random.key(0))
    js.load_params(params)
    nxt = js.prefill({"tokens": jnp.asarray(prompts)})
    toks = [np.asarray(nxt)]
    for _ in range(N_DEC):
        nxt = js.decode(nxt)
        toks.append(np.asarray(nxt))
    take = lambda tree: jax.tree.map(lambda a: np.array(a), tree)
    out = {"toks": np.stack(toks), "pos": np.array(js.state["pos"]),
           "cache": take(js.state["cache"])}
    if page:
        out["pages"] = take(js.state["pages"])
        out["tables"] = np.array(js._alloc.tables)
    return out


def _port_session(spec, r, rows, prefill, pp=1, w=None, kv=None, page=0,
                  cache=CACHE):
    return build_serving(spec, TPlan(pp=pp, tp=1, decode_microbatches=r),
                         cache_len=cache, global_batch=r * rows,
                         compute_dtype=torch.float32, page_size=page,
                         prefill_len=prefill, weight_dtype=w, kv_dtype=kv,
                         device="cpu")


def _run(sess, prompts, n_dec=N_DEC):
    nxt = sess.prefill({"tokens": prompts})
    toks, hidden = [nxt.numpy()], [sess.last_hidden.clone()]
    for _ in range(n_dec):
        nxt = sess.decode(nxt)
        toks.append(nxt.numpy())
        hidden.append(sess.last_hidden.clone())
    if sess._alloc is not None:
        sess._alloc.check()
    return np.stack(toks), hidden


@pytest.mark.parametrize("name", list(CASES))
def test_quantized_engine_matches_jax_engine(name):
    ref = _jax_run(name)
    _, spec, params, prompts, w, kv, page, r, rows, prefill = _case(name)
    sess = _port_session(spec, r, rows, prefill, w=w, kv=kv, page=page
                         ).start()
    sess.load_params(params)
    toks, _ = _run(sess, prompts)
    np.testing.assert_array_equal(toks, ref["toks"])
    np.testing.assert_array_equal(sess._pos, ref["pos"])
    if page:
        np.testing.assert_array_equal(sess._alloc.tables, ref["tables"])
        assert set(sess.pages) == set(ref["pages"])
        for layer, (kq, vq, ks, vs) in ref["pages"].items():
            got = sess.pages[layer]
            assert [t.dtype for t in got] == [torch.int8] * 2 + \
                [torch.float32] * 2
            for g, want in ((got[0], kq), (got[1], vq)):
                diff = np.abs(g.numpy().astype(np.int32)
                              - want.astype(np.int32))
                assert diff.max() <= 1, (layer, diff.max())
            for g, want in ((got[2], ks), (got[3], vs)):
                np.testing.assert_allclose(g.numpy(), want, rtol=SCALE_RTOL,
                                           atol=0)
            assert (got[2] != 1).any()         # scales were written
    n_state = 0
    for layer, state in ref["cache"].items():
        for key, leaves in state.items():
            for g, want in zip(sess.cache[layer][key], leaves):
                want = want.astype(np.float32)
                if kv == "bf16":
                    assert g.dtype == torch.bfloat16
                    _assert_bf16_cache(g.float().numpy(), want, prefill)
                else:
                    np.testing.assert_allclose(g.numpy(), want, atol=ATOL,
                                               rtol=RTOL)
                n_state += 1
    assert n_state > 0 or page


def _assert_bf16_cache(got, want, prefill):
    """A bf16 dense cache (S, R, rows, L, KV, Dh): the prefill's keys within
    the engine tolerance, every key within one bf16 step at the cache's
    largest magnitude (2^-6 of max |want|).  Decode keys of later layers
    may differ by more than ATOL / RTOL: the PV product rounds p to the
    cache's bf16, so f32 summation-order noise can flip one rounding,
    and the rescaled ``wo`` (x40) carries that step into the next
    layers' keys."""
    np.testing.assert_allclose(got[..., :prefill, :, :],
                               want[..., :prefill, :, :], atol=ATOL,
                               rtol=RTOL)
    assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()


def _attn_session(w=None, kv=None, page=0, n_slots=4):
    """tests/test_quant.py's engine: 2 attention layers, pp 1, R = 4."""
    spec = _port_spec(_attn_spec(n_layers=2))
    return _port_session(spec, n_slots, 1, 8, w=w, kv=kv, page=page,
                         cache=64).start(0)


def _greedy_run(sess, steps=8):
    prompts = np.random.default_rng(3).integers(1, 256, (4, 1, 8)
                                                ).astype(np.int32)
    return _run(sess, prompts, n_dec=steps)[0]


@pytest.mark.parametrize("w,kv,page", [
    ("int8", None, 0),               # int8 weights, dense fp32 cache
    (None, "int8", PAGE),            # fp32 weights, paged int8 KV
    ("int8", "int8", PAGE),          # both
])
def test_quantized_engine_tracks_fp32_greedy(w, kv, page):
    """Same seed -> same underlying weights; the quantized session must
    emit (mostly) the same greedy continuation as the fp32 one (the
    port's copy of tests/test_quant.py's test)."""
    want = _greedy_run(_attn_session())
    got = _greedy_run(_attn_session(w=w, kv=kv, page=page))
    match = float(np.mean(got == want))
    assert match >= 0.75, f"greedy match {match} < 0.75 for w={w} kv={kv}"


def test_int8_pp2_equals_pp1_bit_for_bit():
    jspec = _attn_spec(n_layers=2)
    spec = _port_spec(jspec)
    p1 = _qwen_weights(jspec)
    p2 = _restack(p1, 1, 2)
    prompts = np.random.default_rng(5).integers(
        1, jspec.vocab, (2, 2, 12)).astype(np.int32)
    runs = []
    for pp, params in ((1, p1), (2, p2)):
        sess = _port_session(spec, 2, 2, 12, pp=pp, w="int8", kv="int8",
                             page=PAGE).start()
        sess.load_params(params)
        runs.append((sess, *_run(sess, prompts)))
    (s1, t1, h1), (s2, t2, h2) = runs
    np.testing.assert_array_equal(t1, t2)
    for a, b in zip(h1, h2):
        assert torch.equal(a, b)
    for s in range(2):
        for a, b in zip(s1.pages[f"layer_{s}"], s2.pages["layer_0"]):
            assert torch.equal(a[0], b[s])


def test_build_serving_validates_storage_dtypes():
    spec = _port_spec(_attn_spec(n_layers=2))
    plan = TPlan(pp=1, tp=1, decode_microbatches=2)
    kw = dict(cache_len=64, global_batch=2, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        build_serving(spec, plan, kv_dtype="int8", **kw)
    with pytest.raises(ValueError, match="weight_dtype"):
        build_serving(spec, plan, weight_dtype="int4", **kw)
    with pytest.raises(ValueError, match="kv_dtype"):
        build_serving(spec, plan, kv_dtype="fp8", **kw)
    sess = build_serving(spec, plan, weight_dtype="fp8", kv_dtype="int8",
                         page_size=16, **kw).start()
    head = sess.params["head"]
    assert head["q"].dtype == torch.float8_e4m3fn     # no cast touched it
    assert sess.pages["layer_0"][0].dtype == torch.int8
    assert (sess.pages["layer_0"][2] == 1).all()


def test_serve_cli_runs_quantized_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                "--page-size", "16", "--weight-dtype", "int8",
                "--kv-dtype", "int8", "--batch", "4", "--prefill", "12",
                "--tokens", "3", "--cache-len", "32"])
    out = capsys.readouterr().out
    assert "storage dtypes: weights=int8 kv=int8" in out
    assert "decoded 3 steps x 4 seqs" in out
