"""gemma3-4b in the port (Dh 256; five windowed layers to one global, each
kind with its own rope theta; gelu MLP, qk-norm, untied head) against the
JAX package on the CPU in fp32: the config; the plain flash forward and
backward at Dh 256 against ``jax.vjp`` of JAX's jnp twin; the served
tokens and logits of the smoke spec (6 layers, a window of 8, every 3rd
layer global) against the JAX engine past the window, dense and paged,
at pp 2 (ring caches and a full-length one in each stage) and pp 3
(stage position 0 is global on stage 1 and windowed on stages 0 and 2,
so ``default_cache_lens`` sizes it to the largest need); two training
rounds against JAX's ``reference_train_step``; the executor against the
port's oracle bit for bit.  Helpers: tests/_torch_config_cases.py."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_config_cases as C
from _torch_train_jax import (LOSS_ATOL, PARAM_TOL,  # noqa: F401
                              assert_trees_close, one_torch_thread)
from repro.core import schedule as jsched
from repro.models import lm_head as jlm
from repro.models import nn as jnn
from repro.models import stage as jstage
from repro.parallel.mesh import ParallelismPlan as JPlan
from repro_torch.core import schedule as tsched
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import lm_head as tlm
from repro_torch.parallel.plan import ParallelismPlan as TPlan
from repro_torch.serving.engine import build_serving
from test_torch_engine import _restack

ARCH = "gemma3-4b"
WINDOW = 8                         # the smoke spec's local window
R, ROWS, N_DEC, CACHE, PAGE = 2, 2, 16, 32, 16
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def test_config_matches_jax():
    C.check_config(ARCH, ("gemma3-4b", "gemma3_4b"))
    j, t = C.jconfigs.get(ARCH), C.tconfigs.get(ARCH)
    assert (t.LOCAL_WINDOW, t.GLOBAL_EVERY) == (j.LOCAL_WINDOW,
                                                j.GLOBAL_EVERY)
    full = t.full_spec()
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv,
            full.d_head, full.d_ff, full.vocab, full.act, full.qk_norm,
            full.tie_embeddings) == (34, 2560, 8, 4, 256, 10240, 262144,
                                     "gelu", True, False)
    assert [(b.window, b.rope_theta) for b in full.blocks[:6]] == \
        [(1024, 1e4)] * 5 + [(-1, 1e6)]
    assert sum(b.window < 0 for b in full.blocks) == 5     # 5, 11, ..., 29
    assert [b.window for b in t.smoke_spec().blocks] == [WINDOW, WINDOW,
                                                         -1] * 2


# ---- the flash kernels' plain versions at Dh 256 ------------------------

@functools.lru_cache(maxsize=None)
def _jax_flash(window):
    """JAX's jnp twin of the flash kernel (``nn._sdpa_flash_jnp``, what
    the JAX package trains through) at (1, 300, 4 / 2, 256): its output
    and ``jax.vjp`` of it, GQA by repeating K and V over the group."""
    rng = np.random.default_rng(29)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((1, 300, 4, 256), (1, 300, 2, 256),
                             (1, 300, 2, 256), (1, 300, 4, 256)))
    pos = jnp.arange(300)

    def f(q_, k_, v_):
        return jnn._sdpa_flash_jnp(q_, jnp.repeat(k_, 2, axis=2),
                                   jnp.repeat(v_, 2, axis=2), pos, pos,
                                   window, True)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return (q, k, v, do), np.asarray(out), [np.asarray(g) for g in
                                            vjp(jnp.asarray(do))]


@pytest.mark.parametrize("window", [-1, 64])
def test_plain_flash_at_dh256_equals_jax_vjp(window):
    """The plain forward (and its lse) and the plain backward, the CPU
    path and the card kernels' yardstick, at gemma3's head width and
    group (G 2), causal, global and windowed: equal to JAX's jnp twin
    and its ``jax.vjp`` within fp32 atol 2e-5 / rtol 1e-3."""
    arrs, want_out, want_grads = _jax_flash(window)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    out, lse = tfa.flash_attention_plain(q, k, v, causal=True, window=window,
                                         return_lse=True)
    np.testing.assert_allclose(out.numpy(), want_out, atol=2e-5, rtol=1e-3)
    got = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                        window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want_grads):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5, rtol=1e-3,
                                   err_msg=name)


# ---- serving: mixed ring / full-length caches -----------------------------

def _prompts(vocab):
    return np.random.default_rng(3).integers(
        1, vocab, (R, ROWS, WINDOW)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_serve():
    """The JAX engine (pp 1, full-length dense caches) after an 8-token
    prefill and N_DEC decodes, and JAX ``full_transformer``'s logits at
    every scored position of the served sequence (the engine keeps
    none)."""
    from repro.launch.mesh import make_host_mesh
    from repro.parallel.mesh import split_model_axis
    from repro.serving.engine import build_serving as jax_build_serving
    jspec, _ = C.specs(ARCH)
    params = C.jax_params(ARCH)
    mesh = split_model_axis(make_host_mesh(data=1, model=1), 1, 1)
    jplan = JPlan(pp=1, tp=1, microbatches=R, decode_microbatches=R,
                  schedule="serve_1f")
    js = jax_build_serving(jspec, jplan, mesh, cache_len=CACHE,
                           global_batch=R * ROWS, prefill_len=WINDOW,
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
    seq = np.concatenate([prompts.reshape(R * ROWS, WINDOW), toks[:-1].T],
                         axis=1)
    st = jstage.make_statics(jspec, jplan, tokens_per_mb=seq.size)
    jp = jax.tree.map(jnp.asarray, params)
    pos = np.broadcast_to(np.arange(seq.shape[1]), seq.shape)
    h, _ = jstage.full_transformer(
        jp, jlm.embed_tokens(jp["embed"], jnp.asarray(seq)), st,
        positions=jnp.asarray(pos))
    h = jnn.rmsnorm(h[:, WINDOW - 1:], jp["final_norm"]["scale"])
    logits = np.asarray((h @ jp["head"]).astype(jnp.float32))
    return prompts, toks, logits[..., :jspec.vocab]


def _serve(pp, page_size):
    """The port's session at ``pp`` built without ``prefill_len`` (ring
    caches where ``default_cache_lens`` allows), on the JAX weights
    restacked for ``pp``: tokens and the logits at every scored
    position, and the session."""
    _, tspec = C.specs(ARCH)
    params = _restack(C.jax_params(ARCH), 1, pp)
    sess = build_serving(tspec, TPlan(pp=pp, tp=1, decode_microbatches=R),
                         cache_len=CACHE, global_batch=R * ROWS,
                         compute_dtype=torch.float32, page_size=page_size,
                         device="cpu").start()
    sess.load_params(params)
    head, scale = sess.params["head"], sess.params["final_norm"]["scale"]
    nxt = sess.prefill({"tokens": _prompts(tspec.vocab)})
    toks = [nxt.numpy()]
    logits = [tlm.last_logits(head, scale, sess.last_hidden)]
    for _ in range(N_DEC):
        nxt = sess.decode(nxt)
        toks.append(nxt.numpy())
        logits.append(tlm.last_logits(head, scale, sess.last_hidden))
    logits = torch.stack(logits, dim=1)[..., :tspec.vocab]
    return np.stack(toks), logits.numpy(), sess


@pytest.mark.parametrize("pp,page_size", [(2, 0), (2, PAGE), (3, 0),
                                          (3, PAGE)])
def test_served_tokens_and_logits_equal_the_jax_engine(pp, page_size):
    """An 8-token prompt and 16 decodes (24 positions: three windows):
    the port's tokens, dense and paged, equal the JAX engine's and its
    logits JAX ``full_transformer``'s within 1e-4.  At pp 2 each stage holds two
    windowed layers and a global one: rings of 8 at positions 0-1 and a
    full-length cache (paged, with a page size) at position 2; at pp 3
    every position holds a global layer on some stage, so every cache is
    full-length."""
    _, want_toks, want_logits = _jax_serve()
    toks, logits, sess = _serve(pp, page_size)
    _, tspec = C.specs(ARCH)
    lens = tsched.default_cache_lens(tspec, pp, CACHE)
    assert lens == jsched.default_cache_lens(C.specs(ARCH)[0], pp, CACHE)
    assert lens == ([WINDOW, WINDOW, CACHE] if pp == 2 else [CACHE] * 2)
    assert sess.cache_lens == lens
    if page_size:
        assert sorted(sess.pages) == [f"layer_{i}" for i, n in
                                      enumerate(lens) if n == CACHE]
    np.testing.assert_array_equal(toks, want_toks)
    np.testing.assert_allclose(logits, want_logits, **LOGIT_TOL)


def test_tokens_depend_on_the_window():
    """Past the window the served tokens differ from the same weights'
    with every layer global: the rings' reads are what is compared."""
    params = _restack(C.jax_params(ARCH), 1, 2)
    params["layer_windows"] = np.full_like(params["layer_windows"], -1)
    _, tspec = C.specs(ARCH)
    wide = dataclasses.replace(tspec, blocks=tuple(
        dataclasses.replace(b, window=-1) for b in tspec.blocks))
    sess = build_serving(wide, TPlan(pp=2, tp=1, decode_microbatches=R),
                         cache_len=CACHE, global_batch=R * ROWS,
                         compute_dtype=torch.float32, device="cpu").start()
    sess.load_params(params)
    nxt = sess.prefill({"tokens": _prompts(tspec.vocab)})
    toks = [nxt.numpy()]
    for _ in range(N_DEC):
        nxt = sess.decode(nxt)
        toks.append(nxt.numpy())
    assert (np.stack(toks) != _jax_serve()[1]).any()


# ---- training ---------------------------------------------------------------

def test_two_rounds_track_jax():
    """Two rounds at SMOKE_PLAN (pp 2 1f1b / stash, R 4, seq 12: past the
    window of 8) from JAX's initial state against JAX's
    ``reference_train_step``: losses within 5e-5, parameters, momenta
    and the ring within atol 2e-5 / rtol 1e-3."""
    j, t = C.run_both("stash", 2, arch=ARCH, rounds=2)
    assert len(t["losses"]) == 2
    for a, b in zip(t["losses"], j["losses"]):
        assert abs(a - b) <= LOSS_ATOL, (t["losses"], j["losses"])
    assert_trees_close(t["state"]["params"], j["state"]["params"],
                       *PARAM_TOL)
    for key in ("opt_stages", "opt_head", "opt_embed"):
        assert_trees_close(t["state"][key], j["state"][key], *PARAM_TOL)
    assert_trees_close(t["state"]["stash"]["ring"],
                       j["state"]["stash"]["ring"], *PARAM_TOL)


@pytest.mark.parametrize("pp", [2, 3])
def test_executor_equals_oracle_bit_for_bit(pp):
    C.check_executor_equals_oracle(ARCH, pp)
