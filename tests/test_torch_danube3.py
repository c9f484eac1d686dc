"""h2o-danube3-4b in the port: its config against the JAX package's, the
served tokens against the JAX engine's past the window, ring caches
against full-length ones, the ring prompt check, training against JAX's
``reference_train_step``, and the JAX package's ring-pricing fault
(ROADMAP Queue 3), all on the CPU in fp32 at the smoke spec (4 layers,
a window of 8).

The engine weights are the JAX init rescaled as tests/test_torch_engine.py
does, so that tokens depend on attention (and so on the window)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_jax import (LOSS_ATOL, PARAM_TOL,  # noqa: F401
                              assert_trees_close, one_torch_thread,
                              run_both)
from repro import configs as jconfigs
from repro.core import schedule as jsched
from repro.launch.mesh import make_host_mesh
from repro.models import lm_head as jlm
from repro.models import stage as jstage
from repro.parallel.mesh import ParallelismPlan as JPlan
from repro.parallel.mesh import split_model_axis
from repro.serving.engine import build_serving as jax_build_serving
from repro_torch import configs as tconfigs
from repro_torch.core import schedule as tsched
from repro_torch.core.pipeline import build_pipeline
from repro_torch.core.reference import (reference_init_state,
                                        reference_train_step)
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim.optimizers import SGDM
from repro_torch.parallel.plan import ParallelismPlan as TPlan
from repro_torch.serving.engine import build_serving
from test_torch_engine import _weights

ARCH = "h2o-danube-3-4b"
R, ROWS, PREFILL, N_DEC, CACHE, PAGE = 2, 2, 12, 20, 64, 16
WINDOW = 8
HID_TOL = 1e-5


def _spec():
    return jconfigs.get(ARCH).smoke_spec(), tconfigs.get(ARCH).smoke_spec()


def test_config_matches_jax():
    j, t = jconfigs.get(ARCH), tconfigs.get(ARCH)
    for fn in ("full_spec", "smoke_spec"):
        assert dataclasses.asdict(getattr(t, fn)()) == \
            dataclasses.asdict(getattr(j, fn)())
    for plan in ("PLAN", "SMOKE_PLAN"):
        assert dataclasses.asdict(getattr(t, plan)) == \
            dataclasses.asdict(getattr(j, plan))
    assert t.OPTIMIZER == j.OPTIMIZER
    for alias in ("h2o-danube3-4b", "h2o-danube-3-4b", "h2o_danube3_4b"):
        assert tconfigs.get(alias) is t
    assert "h2o_danube3_4b" in tconfigs.ARCH_IDS
    full = t.full_spec()
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv,
            full.d_head, full.d_ff, full.vocab) == (24, 3840, 32, 8, 120,
                                                    10240, 32000)
    assert {(b.window, b.rope_theta) for b in full.blocks} == {(4096, 5e5)}
    assert {b.window for b in t.smoke_spec().blocks} == {WINDOW}


def _prompts(vocab, width, seed=0):
    return np.random.default_rng(seed).integers(
        1, vocab, (R, ROWS, width)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX engine on the smoke spec (pp 1, full-length caches after a
    12-token prefill): tokens over the prefill and N_DEC decodes, and JAX
    ``full_transformer``'s hidden state at each scored position of the
    served sequence (the engine keeps none)."""
    jspec, _ = _spec()
    params = _weights(jspec)
    mesh = split_model_axis(make_host_mesh(data=1, model=1), 1, 1)
    jplan = JPlan(pp=1, tp=1, microbatches=R, decode_microbatches=R,
                  schedule="serve_1f")
    js = jax_build_serving(jspec, jplan, mesh, cache_len=CACHE,
                           global_batch=R * ROWS, prefill_len=PREFILL,
                           compute_dtype=jnp.float32)
    js.start(jax.random.key(0))
    js.load_params(params)
    prompts = _prompts(jspec.vocab, PREFILL)
    nxt = js.prefill({"tokens": jnp.asarray(prompts)})
    toks = [np.asarray(nxt)]
    for _ in range(N_DEC):
        nxt = js.decode(nxt)
        toks.append(np.asarray(nxt))
    toks = np.stack(toks)
    seq = np.concatenate([prompts.reshape(R * ROWS, PREFILL),
                          toks[:-1].T], axis=1)
    st = jstage.make_statics(jspec, jplan, tokens_per_mb=seq.size)
    jp = jax.tree.map(jnp.asarray, params)
    pos = np.broadcast_to(np.arange(seq.shape[1]), seq.shape)
    h, _ = jstage.full_transformer(
        jp, jlm.embed_tokens(jp["embed"], jnp.asarray(seq)), st,
        positions=jnp.asarray(pos))
    cache_bytes = sum(np.asarray(a).nbytes
                      for a in jax.tree.leaves(js.state["cache"]))
    return {"params": params, "prompts": prompts, "toks": toks,
            "hidden": np.asarray(h[:, PREFILL - 1:]),
            "cache_bytes": cache_bytes}


def _serve(params, prompts, pp=1, page_size=0, prefill_len=0, n_dec=N_DEC):
    _, tspec = _spec()
    sess = build_serving(tspec, TPlan(pp=pp, tp=1, decode_microbatches=R),
                         cache_len=CACHE, global_batch=R * ROWS,
                         compute_dtype=torch.float32, page_size=page_size,
                         prefill_len=prefill_len, device="cpu").start()
    sess.load_params(params)
    nxt = sess.prefill({"tokens": prompts})
    toks, hidden = [nxt.numpy()], [sess.last_hidden.clone()]
    for _ in range(n_dec):
        nxt = sess.decode(nxt)
        toks.append(nxt.numpy())
        hidden.append(sess.last_hidden.clone())
    return sess, np.stack(toks), torch.cat(hidden, dim=1)


@pytest.mark.parametrize("page_size", [0, PAGE])
def test_served_tokens_equal_the_jax_engine_past_the_window(page_size):
    """A 12-token prefill and 20 decodes (32 positions, four windows):
    tokens equal the JAX engine's, and the hidden state at every scored
    position equals JAX ``full_transformer``'s within 1e-5."""
    ref = _jax_run()
    sess, toks, hidden = _serve(ref["params"], ref["prompts"],
                                page_size=page_size, prefill_len=PREFILL)
    assert sess.cache_lens == [CACHE] * 4
    np.testing.assert_array_equal(toks, ref["toks"])
    np.testing.assert_allclose(hidden.numpy(), ref["hidden"], atol=HID_TOL,
                               rtol=HID_TOL)


def test_tokens_depend_on_the_window():
    """Past the window the tokens differ from the same model's with a
    global window: the ring's reads are what the test compares."""
    ref = _jax_run()
    _, tspec = _spec()
    wide = dataclasses.replace(tspec, blocks=tuple(
        dataclasses.replace(b, window=-1) for b in tspec.blocks))
    params = dict(ref["params"])
    params["layer_windows"] = np.full_like(params["layer_windows"], -1)
    sess = build_serving(wide, TPlan(pp=1, tp=1, decode_microbatches=R),
                         cache_len=CACHE, global_batch=R * ROWS,
                         compute_dtype=torch.float32, prefill_len=PREFILL,
                         device="cpu").start()
    sess.load_params(params)
    nxt = sess.prefill({"tokens": ref["prompts"]})
    toks = [nxt.numpy()]
    for _ in range(N_DEC):
        nxt = sess.decode(nxt)
        toks.append(nxt.numpy())
    assert (np.stack(toks) != ref["toks"]).any()


@pytest.mark.parametrize("pp,page_size", [(1, 0), (2, 0), (2, PAGE)])
def test_ring_caches_equal_full_length_caches(pp, page_size):
    """A session without ``prefill_len`` keeps rings of the window's
    length (``default_cache_lens``) and pages nothing; after an 8-token
    prompt and 20 decodes its tokens equal a full-length session's and
    its hidden states agree within 1e-5."""
    jspec, tspec = _spec()
    params = _weights(jspec, pp=pp)
    prompts = _prompts(tspec.vocab, WINDOW, seed=3)
    ring, rt, rh = _serve(params, prompts, pp=pp, page_size=page_size)
    full, ft, fh = _serve(params, prompts, pp=pp, page_size=page_size,
                          prefill_len=WINDOW)
    lens = tsched.default_cache_lens(tspec, pp, CACHE)
    assert lens == jsched.default_cache_lens(jspec, pp, CACHE) == \
        [WINDOW] * (4 // pp)
    assert ring.cache_lens == lens
    assert ring.paged is None and ring.pages is None
    for name, layer in ring.cache.items():
        for t in layer["kv"]:
            assert tuple(t.shape) == (pp, R, ROWS, WINDOW, 2, 16), name
    assert full.cache_lens == [CACHE] * (4 // pp)
    assert (full.pages is not None) == bool(page_size)
    np.testing.assert_array_equal(rt, ft)
    torch.testing.assert_close(rh, fh, atol=HID_TOL, rtol=HID_TOL)


def test_speculative_session_keeps_full_length_caches():
    _, tspec = _spec()
    sess = build_serving(tspec, TPlan(pp=1, tp=1, decode_microbatches=R,
                                      schedule="serve_spec_1f"),
                         cache_len=CACHE, global_batch=R * ROWS,
                         compute_dtype=torch.float32, spec_k=2,
                         page_size=PAGE, device="cpu").start()
    assert sess.cache_lens == [CACHE] * 4
    assert sorted(sess.pages) == [f"layer_{i}" for i in range(4)]


def test_prompt_wider_than_the_ring_raises():
    """A one-shot prompt wider than a ring names the layer and its
    length before anything runs; one that fits runs."""
    jspec, tspec = _spec()
    sess = build_serving(tspec, TPlan(pp=1, tp=1, decode_microbatches=R),
                         cache_len=CACHE, global_batch=R * ROWS,
                         compute_dtype=torch.float32, device="cpu").start()
    with pytest.raises(ValueError, match=r"layer_0's ring cache of 8"):
        sess.prefill({"tokens": _prompts(tspec.vocab, WINDOW + 1)})
    assert not sess._pos.any()
    sess.prefill({"tokens": _prompts(tspec.vocab, WINDOW)})
    assert (sess._pos == WINDOW).all()


def test_jax_prices_ring_caches_its_prefilling_engine_does_not_allocate():
    """The JAX package's decode plan prices rings (``serving_cache_bytes``
    with ``prefill=False``), while its engine allocates full-length
    caches whenever it prefills (ROADMAP Queue 3).  The port allocates
    what each price says: the ring session the decode bytes, the
    prefilling session the prefill bytes."""
    ref = _jax_run()
    jspec, tspec = _spec()
    jplan = JPlan(pp=1, tp=1, decode_microbatches=R, schedule="serve_1f")
    tplan = TPlan(pp=1, tp=1, decode_microbatches=R, schedule="serve_1f")
    kw = dict(cache_len=CACHE, global_batch=R * ROWS, kv_dtype="fp32")
    jdec = jsched.serving_cache_bytes(jspec, jplan,
                                      jsched.make_serving_schedule(jplan),
                                      **kw)
    tsch = tsched.make_serving_schedule(tplan)
    tdec = tsched.serving_cache_bytes(tspec, tplan, tsch, **kw)
    tpre = tsched.serving_cache_bytes(tspec, tplan, tsch, prefill=True,
                                      **kw)
    assert tdec == jdec < ref["cache_bytes"] == tpre
    prompts = _prompts(tspec.vocab, WINDOW)
    for prefill_len, want in ((0, tdec), (WINDOW, tpre)):
        sess, _, _ = _serve(ref["params"], prompts, prefill_len=prefill_len,
                            n_dec=0)
        got = sum(t.nbytes for layer in sess.cache.values()
                  for t in layer["kv"])
        assert got == want


# ---- training ---------------------------------------------------------------

run = functools.lru_cache(maxsize=None)(run_both)


@pytest.mark.parametrize("pp", [1, 2])
def test_oracle_tracks_jax(pp):
    """The port's oracle over 3 rounds of the danube smoke spec (R 4,
    seq 12: past the window of 8) against JAX's ``reference_train_step``:
    losses within 5e-5, parameters, momenta and the ring within atol 2e-5
    / rtol 1e-3."""
    j, t = run("stash", pp, arch=ARCH)
    for a, b in zip(t["losses"], j["losses"]):
        assert abs(a - b) <= LOSS_ATOL, (t["losses"], j["losses"])
    assert_trees_close(t["state"]["params"], j["state"]["params"],
                       *PARAM_TOL)
    for key in ("opt_stages", "opt_head", "opt_embed"):
        assert_trees_close(t["state"][key], j["state"][key], *PARAM_TOL)
    if "ring" in j["state"]["stash"]:
        assert_trees_close(t["state"]["stash"]["ring"],
                           j["state"]["stash"]["ring"], *PARAM_TOL)


@pytest.mark.parametrize("pp", [1, 2])
def test_executor_equals_oracle_bit_for_bit(pp):
    _, spec = _spec()
    plan = tconfigs.get(ARCH).SMOKE_PLAN.with_(pp=pp, microbatches=4)
    opt = SGDM(lr=0.05)
    bundle = build_pipeline(spec, plan, seq_len=12, global_batch=8,
                            optimizer=opt, compute_dtype=torch.float32,
                            device="cpu")
    state = bundle.init_state(torch.Generator().manual_seed(0))
    ref = reference_init_state(spec, plan, opt,
                               torch.Generator().manual_seed(0))
    src = SyntheticLM(spec.vocab, 12, seed=5)
    for r in range(2):
        batch = {k: torch.from_numpy(v)
                 for k, v in src.round_batch(r, 4, 2).items()}
        state, em = bundle.train_step(state, batch)
        ref, om = reference_train_step(spec, plan, ref, batch, opt)
        assert torch.equal(em["loss"], om["loss"])
    got, want = _leaves(state), _leaves(ref)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), name


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{prefix}/{k}")]
    return [(prefix, tree)]
