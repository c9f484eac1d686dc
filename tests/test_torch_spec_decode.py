"""Speculative draft–verify in the port against the JAX engine, on the
CPU in fp32: ``draft`` / ``verify`` / ``rollback_slots`` on dense
caches, float page pools and int8 pools (whose verify writes run token
by token from mid-page positions), the speculative streams against the
plain ones, and the typed guards of tests/test_paged.py.

Both engines get the same weights (tests/test_torch_engine.py's
rescale), prompts and drafts.  spec_k 3: a round of 4 positions from a
12-token prompt fills page 0 exactly, and the next round starts
mid-page and crosses into page 1.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import schedule as tsched
from repro_torch.parallel.plan import ParallelismPlan as TPlan
from repro_torch.serving.batcher import ContinuousBatchingSession, Request
from repro_torch.serving.engine import CacheExhausted, build_serving
from test_paged import _attn_spec
from test_torch_engine import _port_spec, _weights
from test_torch_serving_slots import (CACHE, PAGE, PREFILL, ROWS,
                                      _assert_kv, _assert_mirrors,
                                      _jax_session, _port_session)

R, K = 2, 3
# name -> (page_size, kv_dtype)
CASES = {"dense": (0, None), "paged": (PAGE, None), "paged-int8": (PAGE,
                                                                   "int8")}


def _stream(spec, params, prompts, n, page_size=PAGE, kv_dtype=None):
    """Greedy tokens of a plain session: (1 + n, R · rows)."""
    s = _port_session(spec, params, R, page_size=page_size,
                      kv_dtype=kv_dtype)
    out = [s.prefill({"tokens": prompts}).numpy()]
    for _ in range(n):
        out.append(s.decode(out[-1]).numpy())
    return np.stack(out)


def _oracle(stream, sess, last):
    """Each row's next K greedy tokens after its current position."""
    pos = np.repeat(sess._pos, ROWS) - PREFILL + 1
    return np.stack([stream[p:p + K, i] for i, p in enumerate(pos)])


def _rounds(sess, stream, draft_of):
    """Four verify rounds (self drafts, oracle drafts, oracle drafts
    corrupted at their second position, self drafts after rolling slot 0
    back two positions); returns each round's (drafts, scores,
    accepted) and the positions after it."""
    last = stream[0].copy()
    out = []
    for kind in ("self", "oracle", "corrupt", "rollback"):
        if kind == "rollback":
            new_pos = sess._pos.copy()
            new_pos[0] -= 2
            sess.rollback_slots(np.array([1, 0]), new_pos)
            last[:ROWS] = stream[new_pos[0] - PREFILL, :ROWS]
        if kind in ("self", "rollback"):
            drafts = draft_of(sess, last)
        else:
            drafts = _oracle(stream, sess, last)
            if kind == "corrupt":
                drafts[:, 1] = (drafts[:, 1] + 1) % 256
        scores, acc = sess.verify(np.concatenate([last[:, None], drafts], 1))
        scores, acc = np.asarray(scores), np.asarray(acc)
        out.append((drafts, scores, acc, sess._pos.copy()))
        last = scores[np.arange(R * ROWS), np.repeat(acc, ROWS)]
    return out


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    page, kv = CASES[name]
    jspec = _attn_spec(n_layers=2)
    params = _weights(jspec)
    rng = np.random.default_rng(6)
    prompts = rng.integers(1, jspec.vocab, (R, ROWS, PREFILL)
                           ).astype(np.int32)
    stream = _stream(_port_spec(jspec), params, prompts, 16, page, kv)
    js = _jax_session(jspec, params, R, page_size=page,
                      schedule="serve_spec_1f", spec_k=K, kv_dtype=kv)
    first = np.asarray(js.prefill({"tokens": jnp.asarray(prompts)}))
    rounds = _rounds(js, stream, lambda s, last: np.asarray(s.draft(last)))
    return jspec, params, prompts, stream, first, rounds, js


@pytest.mark.parametrize("name", list(CASES))
def test_draft_verify_rollback_match_jax(name):
    jspec, params, prompts, stream, first, want, js = _jax_case(name)
    page, kv = CASES[name]
    ts = _port_session(_port_spec(jspec), params, R, page_size=page,
                       schedule="serve_spec_1f", spec_k=K, kv_dtype=kv)
    assert ts.speculative and ts.sched.verify_qlen == K + 1
    np.testing.assert_array_equal(ts.prefill({"tokens": prompts}).numpy(),
                                  first)
    got = _rounds(ts, stream, lambda s, last: s.draft(last))
    for i, (a, b) in enumerate(zip(got, want)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=f"round {i}")
    # the oracle round accepts everything, the corrupted one one draft
    assert (want[1][2] == K).all() and (want[2][2] == 1).all()
    _assert_mirrors(ts, js, "four verify rounds")
    if kv is None:
        _assert_kv(ts, js, range(R))
    else:
        for nm, pools in ts.pages.items():
            for m in range(R):
                ids = ts._alloc.tables[m][:ts._alloc.counts[m]]
                for t, j in zip(pools[:2], js.state["pages"][nm][:2]):
                    d = (t[:, ids].numpy().astype(np.int32)
                         - np.asarray(j)[:, ids].astype(np.int32))
                    assert np.abs(d).max() <= 1


@pytest.mark.parametrize("name", list(CASES))
def test_verify_scores_are_the_plain_greedy_stream(name):
    """Accepted tokens are the plain session's greedy tokens: every round
    emits scores[:, :accepted + 1] of the stream."""
    jspec, params, prompts, stream, first, want, _ = _jax_case(name)
    pos = np.full(R, PREFILL)
    for drafts, scores, acc, new_pos in want[:3]:
        for row in range(R * ROWS):
            m = row // ROWS
            n = acc[m] + 1
            np.testing.assert_array_equal(
                scores[row, :n], stream[pos[m] - PREFILL + 1:
                                        pos[m] - PREFILL + 1 + n, row])
        pos = new_pos


def test_verify_launch_and_tokenwise_writes_mid_page():
    """A verify round starting mid-page keeps the page's earlier keys (a
    slab write from offset 0 would clobber them) and holds each position
    where a decode would have written it."""
    jspec = _attn_spec(n_layers=2)
    spec, params = _port_spec(jspec), _weights(jspec)
    rng = np.random.default_rng(8)
    prompts = rng.integers(1, spec.vocab, (R, ROWS, PREFILL))
    plain = _port_session(spec, params, R, page_size=PAGE)
    spec_s = _port_session(spec, params, R, page_size=PAGE,
                           schedule="serve_spec_1f", spec_k=K)
    t = plain.prefill({"tokens": prompts})
    spec_s.prefill({"tokens": prompts})
    toks = [t.numpy()]
    for _ in range(K + 1):
        t = plain.decode(t)
        toks.append(t.numpy())
    toks = np.stack(toks)
    spec_s.verify(toks[:K + 1].T)
    np.testing.assert_array_equal(spec_s._pos, PREFILL + K + 1)
    n = PREFILL + K + 1
    for name in plain.pages:
        for a, b in zip(plain.pages[name], spec_s.pages[name]):
            for m in range(R):
                ia = plain._alloc.tables[m][:plain._alloc.counts[m]]
                ib = spec_s._alloc.tables[m][:spec_s._alloc.counts[m]]
                ga = a[:, ia].transpose(1, 2).reshape(1, ROWS, -1, 2, 16)
                gb = b[:, ib].transpose(1, 2).reshape(1, ROWS, -1, 2, 16)
                torch.testing.assert_close(ga[:, :, :n], gb[:, :, :n],
                                           atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# speculative streams through the batcher
# --------------------------------------------------------------------------

def _trace(vocab, seed=9):
    rng = np.random.default_rng(seed)
    # lanes pair up in a slot (equal prompt lengths, lengths and arrivals),
    # so a slot's acceptance (the minimum over its lanes) is the oracle's
    lens = [12, 12, 7, 7, 10, 10]
    news = [9, 9, 12, 12, 6, 6]
    arr = [0, 0, 1, 1, 4, 4]
    return [Request(rid=i, prompt=rng.integers(1, vocab, n).astype(np.int32),
                    max_new_tokens=m, arrival=a)
            for i, (n, m, a) in enumerate(zip(lens, news, arr))]


@functools.lru_cache(maxsize=None)
def _plain_streams(page_size):
    jspec = _attn_spec(n_layers=2)
    spec, params = _port_spec(jspec), _weights(jspec)
    sess = _port_session(spec, params, R, page_size=page_size, buckets=True)
    reqs = _trace(spec.vocab)
    ContinuousBatchingSession(sess).run(reqs)
    return spec, params, [r.tokens for r in reqs]


@pytest.mark.parametrize("drafts", ["self", "oracle", "corrupt"])
@pytest.mark.parametrize("page_size", [0, PAGE])
def test_spec_streams_equal_plain_streams(page_size, drafts):
    spec, params, want = _plain_streams(page_size)
    sess = _port_session(spec, params, R, page_size=page_size, buckets=True,
                         schedule="serve_spec_1f", spec_k=K)
    draft_fn = None
    if drafts != "self":
        def draft_fn(last):
            # oracle: each live lane's next K tokens of its request's
            # plain stream (zeros past its end), or their corruption
            out = np.zeros((last.shape[0], K), np.int32)
            for slot in server.slots:
                for lane, r in slot.live_lanes():
                    cont = want[r.rid][len(r.tokens):len(r.tokens) + K]
                    out[slot.index * ROWS + lane, :len(cont)] = cont
            return (out + 1) % spec.vocab if drafts == "corrupt" else out

    reqs = _trace(spec.vocab)
    server = ContinuousBatchingSession(sess, draft_fn=draft_fn)
    rep = server.run(reqs)
    assert [r.tokens for r in reqs] == want
    for r in reqs:
        # oracle drafts are all accepted where the stream knows the next
        # tokens: a request takes the fewest verify rounds; corrupted
        # ones never are: one token a round
        n = r.max_new_tokens - 1
        rounds = -(-n // (K + 1)) if drafts == "oracle" else n
        if drafts != "self":
            assert r.step_done - r.step_admitted == max(rounds - 1, 0)
    if drafts == "corrupt":
        assert rep.accepted_drafts == 0
    if sess._alloc is not None:
        sess._alloc.check()
        assert sess._alloc.live_pages == 0


# --------------------------------------------------------------------------
# typed guards (tests/test_paged.py's, on the port)
# --------------------------------------------------------------------------

def _spec_session(page_size=PAGE, start=True, **kw):
    spec = _port_spec(_attn_spec(n_layers=2))
    plan = TPlan(pp=1, tp=1, decode_microbatches=R, schedule="serve_spec_1f")
    s = build_serving(spec, plan, cache_len=kw.pop("cache", CACHE),
                      global_batch=R * ROWS, compute_dtype=torch.float32,
                      page_size=page_size, prefill_len=PREFILL, spec_k=K,
                      device="cpu", **kw)
    return s.start() if start else s


def test_ops_before_start_raise_typed_errors():
    sess = _spec_session(start=False)
    tok = np.zeros(R * ROWS, np.int32)
    with pytest.raises(ValueError, match=r"decode\(\) before start"):
        sess.decode(tok)
    with pytest.raises(ValueError, match=r"draft\(\) before start"):
        sess.draft(tok)
    with pytest.raises(ValueError, match=r"verify\(\) before start"):
        sess.verify(np.zeros((R * ROWS, K + 1), np.int32))
    with pytest.raises(ValueError,
                       match=r"rollback_slots\(\) before start"):
        sess.rollback_slots(np.ones(R, np.int32), np.zeros(R, np.int64))


def test_spec_ops_on_plain_session_raise_typed_errors():
    spec = _port_spec(_attn_spec(n_layers=2))
    sess = build_serving(spec, TPlan(pp=1, tp=1, decode_microbatches=R),
                         cache_len=CACHE, global_batch=R * ROWS,
                         compute_dtype=torch.float32, device="cpu").start()
    with pytest.raises(ValueError, match="non-speculative session"):
        sess.draft(np.zeros(R * ROWS, np.int32))
    with pytest.raises(ValueError, match="non-speculative session"):
        sess.verify(np.zeros((R * ROWS, 3), np.int32))
    with pytest.raises(ValueError, match="not speculative"):
        tsched.make_serving_schedule(TPlan(pp=1, tp=1), 2, spec_k=2)
    with pytest.raises(ValueError, match="draft_fn= passed"):
        ContinuousBatchingSession(
            build_serving(spec, TPlan(pp=1, tp=1, decode_microbatches=R),
                          cache_len=CACHE, global_batch=R * ROWS,
                          prefill_len=PREFILL, device="cpu"),
            draft_fn=lambda t: t)


def test_spec_k_headroom_and_recurrent_models_rejected_at_build():
    with pytest.raises(ValueError,
                       match=r"spec_k=3 exceeds the cache_len headroom"):
        _spec_session(page_size=0, cache=3)
    from repro_torch import configs
    cfg = configs.get("rwkv6-1.6b")
    with pytest.raises(ValueError, match="pure-attention decoder stack"):
        build_serving(cfg.smoke_spec(),
                      cfg.SMOKE_PLAN.with_(tp=1, schedule="serve_spec_1f"),
                      cache_len=CACHE, global_batch=4, prefill_len=8,
                      device="cpu")


def test_verify_without_headroom_raises_before_mutation():
    sess = _spec_session()
    rng = np.random.default_rng(3)
    toks = rng.integers(1, 256, (R, ROWS, PREFILL)).astype(np.int32)
    sess.write_prefill_into_slots({"tokens": toks}, np.ones(R, np.int32))
    while sess._pos[0] + K + 1 <= CACHE:
        sess.decode(rng.integers(1, 256, R * ROWS).astype(np.int32))
    pos, tables = sess._pos.copy(), sess._alloc.tables.copy()
    with pytest.raises(CacheExhausted, match="lack verify headroom") as e:
        sess.verify(rng.integers(1, 256, (R * ROWS, K + 1)))
    assert set(e.value.slots) == set(range(R))
    np.testing.assert_array_equal(sess._pos, pos)
    np.testing.assert_array_equal(sess._alloc.tables, tables)


def test_verify_pool_dry_raises_before_mutation():
    """Three pages for two slots at 12 tokens: a round to 16 fits page 0,
    the next needs page 1 in both and the pool covers one."""
    from repro_torch.obs import Observability
    sess = _spec_session(pool_pages=3, obs=Observability())
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 256, (R, ROWS, PREFILL)).astype(np.int32)
    sess.prefill({"tokens": toks})
    drafts = rng.integers(1, 256, (R * ROWS, K + 1))
    sess.verify(drafts)                    # accepts >= 0: pos 13..16
    snap = (sess._pos.copy(), sess._alloc.tables.copy(),
            list(sess._alloc.free))
    with pytest.raises(CacheExhausted, match="for a spec_k=3 verify round"
                       ) as e:
        sess.verify(drafts)
    assert e.value.slots == (1,)
    np.testing.assert_array_equal(sess._pos, snap[0])
    np.testing.assert_array_equal(sess._alloc.tables, snap[1])
    assert sess._alloc.free == snap[2]
    sess._alloc.check()
    assert sess.obs.counter("cache_exhausted_total").value(
        kind="verify", reason="pool") == 1


def test_verify_rejects_wrong_token_shape():
    sess = _spec_session()
    with pytest.raises(ValueError,
                       match=r"tokens must be \(global_batch, spec_k\+1\)"):
        sess.verify(np.zeros((R * ROWS, K), np.int32))
    with pytest.raises(ValueError,
                       match=r"tokens must be \(global_batch, spec_k\+1\)"):
        sess.verify(np.zeros(R * ROWS, np.int32))


def test_rollback_slots_validates_mask_bounds_and_direction():
    sess = _spec_session()
    rng = np.random.default_rng(7)
    toks = rng.integers(1, 256, (R, ROWS, PREFILL)).astype(np.int32)
    sess.write_prefill_into_slots({"tokens": toks}, np.ones(R, np.int32))
    for _ in range(4):
        sess.decode(rng.integers(1, 256, R * ROWS).astype(np.int32))
    before = sess._pos.copy()
    ones = np.ones(R, np.int32)
    with pytest.raises(ValueError,
                       match=rf"slot_mask has {R + 1} entries for R={R}"):
        sess.rollback_slots(np.ones(R + 1, np.int32), before)
    with pytest.raises(ValueError,
                       match=rf"new_pos has {R - 1} entries for R={R}"):
        sess.rollback_slots(ones, before[:-1])
    below = before.copy()
    below[1] = PREFILL - 1
    with pytest.raises(ValueError, match="below their prompt length"):
        sess.rollback_slots(ones, below)
    fwd = before.copy()
    fwd[0] += 1
    with pytest.raises(ValueError, match=r"new_pos advances slots \[0\]"):
        sess.rollback_slots(ones, fwd)
    np.testing.assert_array_equal(sess._pos, before)
    sess.rollback_slots(ones, before - 2)
    np.testing.assert_array_equal(sess._pos, before - 2)
    sess._alloc.check()
