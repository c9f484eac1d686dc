"""The port's continuous-batching engine surface against the JAX engine,
on the CPU in fp32: ragged prefill, the slot operations (reset, masked
admission, compaction) over bucketed tables, ``serve_interleaved``, the
bucketed and live-masked schedule tables, and the ``CacheExhausted``
guards.

Sizes are tests/test_torch_engine.py's (rows 2, prefill 12, cache 32,
page 16, its rescaled weights so tokens see attention); the scripted
slot sequence runs R 4 slots so that compaction and the (1, 2, 4) bucket
lattice have room.  Tokens are compared on the rows of live or admitted
slots only: the other rows are unspecified in both engines.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedule as jsched
from repro.launch.mesh import make_host_mesh
from repro.parallel.mesh import ParallelismPlan as JPlan
from repro.parallel.mesh import split_model_axis
from repro.serving.engine import build_serving as jax_build_serving
from repro_torch.core import schedule as tsched
from repro_torch.parallel.plan import ParallelismPlan as TPlan
from repro_torch.serving.engine import CacheExhausted, build_serving
from test_paged import _attn_spec
from test_torch_engine import _port_spec, _restack, _weights

ROWS, PREFILL, CACHE, PAGE = 2, 12, 32, 16
ATOL, RTOL = 2e-4, 1e-3


def _jax_session(jspec, params, R, *, page_size=0, buckets=False,
                 schedule="serve_1f", v=1, pool_pages=None, spec_k=None,
                 kv_dtype=None):
    mesh = split_model_axis(make_host_mesh(data=1, model=1), 1, 1)
    plan = JPlan(pp=1, tp=1, microbatches=R, decode_microbatches=R,
                 schedule=schedule, virtual_stages=v)
    js = jax_build_serving(jspec, plan, mesh, cache_len=CACHE,
                           global_batch=R * ROWS, prefill_len=PREFILL,
                           compute_dtype=jnp.float32, page_size=page_size,
                           buckets=buckets, pool_pages=pool_pages,
                           spec_k=spec_k, kv_dtype=kv_dtype)
    js.start(jax.random.key(0))
    js.load_params(params)
    return js


def _port_session(spec, params, R, *, pp=1, page_size=0, buckets=False,
                  schedule="serve_1f", v=1, pool_pages=None, spec_k=None,
                  prefill_len=PREFILL, kv_dtype=None):
    plan = TPlan(pp=pp, tp=1, decode_microbatches=R, schedule=schedule,
                 virtual_stages=v)
    sess = build_serving(spec, plan, cache_len=CACHE, global_batch=R * ROWS,
                         compute_dtype=torch.float32, page_size=page_size,
                         prefill_len=prefill_len, buckets=buckets,
                         pool_pages=pool_pages, spec_k=spec_k,
                         kv_dtype=kv_dtype, device="cpu").start()
    return sess.load_params(params)


def _rows(mask):
    """Row indices of the slots in ``mask`` (ROWS rows a slot)."""
    return np.flatnonzero(np.repeat(np.asarray(mask) > 0, ROWS))


def _assert_mirrors(ts, js, what):
    for name in ("_pos", "_live", "_prompt_len"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name),
                                      err_msg=f"{name} after {what}")
    np.testing.assert_array_equal(ts._pos, np.asarray(js.state["pos"]))
    if ts._alloc is not None:
        np.testing.assert_array_equal(ts._alloc.tables, js._alloc.tables,
                                      err_msg=f"page tables after {what}")
        np.testing.assert_array_equal(ts._alloc.counts, js._alloc.counts)
        assert ts._alloc.free == js._alloc.free
        ts._alloc.check()


def _assert_kv(ts, js, slots):
    """The keys and values the ``slots`` hold (positions < pos), paged or
    dense, equal JAX's."""
    for name in js.state["cache"]:
        for i in (0, 1):
            for m in slots:
                n = int(ts._pos[m])
                if ts.pages is not None:
                    ids = ts._alloc.tables[m][:ts._alloc.counts[m]]
                    got = ts.pages[name][i][:, ids].transpose(1, 2)
                    got = got.reshape(got.shape[0], ROWS, -1,
                                      *got.shape[-2:])[:, :, :n]
                    want = np.asarray(js.state["pages"][name][i])[:, ids]
                    want = want.transpose(0, 2, 1, 3, 4, 5).reshape(
                        got.shape[0], ROWS, -1, *want.shape[-2:])[:, :, :n]
                else:
                    got = ts.cache[name]["kv"][i][:, m, :, :n]
                    want = np.asarray(
                        js.state["cache"][name]["kv"][i])[:, m, :, :n]
                np.testing.assert_allclose(got.numpy(), want, atol=ATOL,
                                           rtol=RTOL)


# --------------------------------------------------------------------------
# ragged prefill
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ragged_case(page_size):
    R = 2
    jspec = _attn_spec(n_layers=2)
    params = _weights(jspec)
    rng = np.random.default_rng(1)
    prompts = rng.integers(1, jspec.vocab, (R, ROWS, PREFILL)
                           ).astype(np.int32)
    lens = np.array([PREFILL, 5])
    prompts[1, :, 5:] = 0
    batch = {"tokens": prompts, "lens": lens}
    js = _jax_session(jspec, params, R, page_size=page_size)
    jt = [np.asarray(js.prefill({"tokens": jnp.asarray(prompts),
                                 "lens": jnp.asarray(lens)}))]
    for _ in range(3):
        jt.append(np.asarray(js.decode(jnp.asarray(jt[-1]))))
    return jspec, params, batch, np.stack(jt), js


@pytest.mark.parametrize("page_size", [0, PAGE])
def test_ragged_prefill_matches_jax(page_size):
    jspec, params, batch, jtoks, js = _ragged_case(page_size)
    ts = _port_session(_port_spec(jspec), params, 2, page_size=page_size)
    toks = [ts.prefill(batch).numpy()]
    for _ in range(3):
        toks.append(ts.decode(toks[-1]).numpy())
    np.testing.assert_array_equal(np.stack(toks), jtoks)
    _assert_mirrors(ts, js, "ragged prefill + 3 decodes")
    np.testing.assert_array_equal(ts._pos, [PREFILL + 3, 5 + 3])
    _assert_kv(ts, js, range(2))


def test_ragged_prefill_first_token_is_the_short_prompt_alone():
    """A slot prefilled with a 5-token prompt right-padded to 12 gives the
    token (and KV) of that prompt prefilled at width 5 on its own."""
    jspec, params, batch, jtoks, _ = _ragged_case(PAGE)
    spec = _port_spec(jspec)
    solo = _port_session(spec, params, 2, page_size=PAGE, prefill_len=0)
    short = np.ascontiguousarray(batch["tokens"][:, :, :5])
    first = solo.prefill({"tokens": short}).numpy()
    np.testing.assert_array_equal(first[ROWS:], jtoks[0][ROWS:])


# --------------------------------------------------------------------------
# scripted slot operations over bucketed tables
# --------------------------------------------------------------------------

SLOT_R = 4
# (op, argument): admit (mask, lens), decode (n steps), reset (mask),
# compact (occupied-first, the batcher's rule)
SCRIPT = (("reset", [1, 1, 1, 1]),
          ("admit", ([1, 1, 0, 0], [PREFILL, 7])),
          ("decode", 2),
          ("admit", ([0, 0, 1, 0], [9])),
          ("decode", 2),
          ("reset", [1, 0, 0, 0]),
          ("compact", None),
          ("decode", 2),
          ("admit", ([0, 0, 1, 0], [PREFILL])),
          ("decode", 3),
          ("reset", [1, 1, 0, 0]),
          ("compact", None),
          ("decode", 2))


def _run_script(sess, prompts, feed, host):
    """Drive ``SCRIPT`` on ``sess``; ``feed`` holds the tokens to decode
    from (shared by both engines), ``host`` converts an engine's output.
    Returns, per op, (what ran, the tokens of the rows it defines)."""
    out = []
    for op, arg in SCRIPT:
        if op == "reset":
            sess.reset_slots(np.asarray(arg, np.int32))
            out.append((op, None))
        elif op == "compact":
            occ = [i for i in range(SLOT_R) if sess._live[i]]
            perm = occ + [i for i in range(SLOT_R) if not sess._live[i]]
            sess.compact_slots(perm)
            feed[:] = feed.reshape(SLOT_R, ROWS)[perm].reshape(-1)
            out.append((op, perm))
        elif op == "admit":
            mask, lens = arg
            mask = np.asarray(mask, np.int32)
            full = np.full(SLOT_R, PREFILL)
            full[np.flatnonzero(mask)] = lens
            batch = {"tokens": prompts[len(out)], "lens": full}
            toks = host(sess.write_prefill_into_slots(batch, mask))
            rows = _rows(mask)
            feed[rows] = toks[rows]
            out.append((op, toks[rows]))
        else:
            for _ in range(arg):
                rows = _rows(sess._live)
                toks = host(sess.decode(feed.copy()))
                feed[rows] = toks[rows]
                out.append((op, toks[rows]))
    return out


@functools.lru_cache(maxsize=None)
def _script_case():
    jspec = _attn_spec(n_layers=2)
    params = _weights(jspec)
    rng = np.random.default_rng(2)
    prompts = rng.integers(1, jspec.vocab, (len(SCRIPT) + 20, SLOT_R, ROWS,
                                            PREFILL)).astype(np.int32)
    js = _jax_session(jspec, params, SLOT_R, page_size=PAGE, buckets=True)
    feed = np.zeros(SLOT_R * ROWS, np.int32)
    out = _run_script(js, prompts, feed, np.asarray)
    mirrors = (js._pos.copy(), js._live.copy(), js._prompt_len.copy(),
               js._alloc.tables.copy(), list(js._bucket_log))
    return jspec, params, prompts, out, mirrors, js


def test_slot_script_matches_jax_engine():
    jspec, params, prompts, want, mirrors, js = _script_case()
    ts = _port_session(_port_spec(jspec), params, SLOT_R, page_size=PAGE,
                       buckets=True)
    feed = np.zeros(SLOT_R * ROWS, np.int32)
    got = _run_script(ts, prompts, feed, lambda x: x.numpy())
    assert [o for o, _ in got] == [o for o, _ in want]
    for i, ((op, a), (_, b)) in enumerate(zip(got, want)):
        if a is None:
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"op {i} ({op})")
    pos, live, plen, tables, blog = mirrors
    np.testing.assert_array_equal(ts._pos, pos)
    np.testing.assert_array_equal(ts._live, live)
    np.testing.assert_array_equal(ts._prompt_len, plen)
    np.testing.assert_array_equal(ts._alloc.tables, tables)
    assert ts._bucket_log == blog and set(blog) == {1, 2, 4}
    _assert_mirrors(ts, js, "the script")
    _assert_kv(ts, js, np.flatnonzero(ts._live))


def test_slot_script_dense_equals_paged():
    """The same script on a dense-cache session gives the paged
    session's tokens and positions, and its caches hold the pools'
    keys."""
    jspec, params, prompts, want, mirrors, _ = _script_case()
    spec = _port_spec(jspec)
    dense = _port_session(spec, params, SLOT_R, buckets=True)
    feed = np.zeros(SLOT_R * ROWS, np.int32)
    got = _run_script(dense, prompts, feed, lambda x: x.numpy())
    for (op, a), (_, b) in zip(got, want):
        if a is not None and op != "compact":
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dense._pos, mirrors[0])
    assert dense._alloc is None and dense.pages is None


def test_bucketed_step_skips_dead_slots_and_leaves_their_state():
    """A decode over live slots {0} runs bucket 1 and writes nothing in
    the other slots' state; a reset zeroes exactly its slot's rows."""
    jspec = _attn_spec(n_layers=2)
    spec, params = _port_spec(jspec), _weights(jspec)
    ts = _port_session(spec, params, SLOT_R, buckets=True)
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, spec.vocab, (SLOT_R, ROWS, PREFILL))
    nxt = ts.prefill({"tokens": prompts})
    ts.reset_slots(np.array([0, 1, 1, 1]))
    k = ts.cache["layer_0"]["kv"][0]
    assert (k[:, 1:] == 0).all() and (k[:, 0] != 0).any()
    before = k.clone()
    ts.decode(nxt)
    assert ts._bucket_log[-1] == 1
    assert torch.equal(k[:, 1:], before[:, 1:])
    np.testing.assert_array_equal(ts._pos, [PREFILL + 1, 0, 0, 0])


# --------------------------------------------------------------------------
# serve_interleaved
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _interleaved_case():
    R = 2
    jspec = _attn_spec(n_layers=2)
    params = _weights(jspec, pp=2)          # (S·v = 2) chunk rows
    rng = np.random.default_rng(4)
    prompts = rng.integers(1, jspec.vocab, (R, ROWS, PREFILL)
                           ).astype(np.int32)
    js = _jax_session(jspec, params, R, page_size=PAGE,
                      schedule="serve_interleaved", v=2)
    jt = [np.asarray(js.prefill({"tokens": jnp.asarray(prompts)}))]
    for _ in range(4):
        jt.append(np.asarray(js.decode(jnp.asarray(jt[-1]))))
    return jspec, params, prompts, np.stack(jt), js


def test_serve_interleaved_matches_jax():
    """S 1 x v 2 (the JAX tests' one device): two chunks on one stage,
    the tables walked with the chunk column."""
    jspec, params, prompts, jtoks, js = _interleaved_case()
    ts = _port_session(_port_spec(jspec), params, 2, page_size=PAGE,
                       schedule="serve_interleaved", v=2)
    assert ts.sched.name == "serve_interleaved" and ts.sched.n_chunks == 2
    toks = [ts.prefill({"tokens": prompts}).numpy()]
    for _ in range(4):
        toks.append(ts.decode(toks[-1]).numpy())
    np.testing.assert_array_equal(np.stack(toks), jtoks)
    _assert_mirrors(ts, js, "prefill + 4 decodes")
    _assert_kv(ts, js, range(2))


@pytest.mark.parametrize("page_size", [0, PAGE])
def test_serve_interleaved_equals_serve_1f_bit_for_bit(page_size):
    """pp 2 x v 2 (4 chunks of one layer, storage order [0, 2, 1, 3])
    gives serve_1f pp 2's tokens and hidden states bit for bit, through
    admission, decode and compaction."""
    R = 4
    jspec = _attn_spec(n_layers=4)
    spec = _port_spec(jspec)
    chunks = _weights(jspec, pp=4)                   # model chunk order
    order = tsched.ScheduleServeInterleaved(2, R).storage_chunk_order()
    stored = dict(chunks)
    stored["stages"] = jax.tree.map(lambda a: a[order], chunks["stages"])
    stored["layer_windows"] = chunks["layer_windows"][order]
    stored["layer_thetas"] = chunks["layer_thetas"][order]
    rng = np.random.default_rng(5)
    prompts = rng.integers(1, spec.vocab, (R, ROWS, PREFILL))
    runs = {}
    for name, v, p in (("serve_1f", 1, _restack(chunks, 4, 2)),
                       ("serve_interleaved", 2, stored)):
        s = _port_session(spec, p, R, pp=2, page_size=page_size,
                          schedule=name, v=v, buckets=True)
        out = [s.prefill({"tokens": prompts, "lens": [12, 6, 9, 12]})]
        hid = [s.last_hidden.clone()]
        for _ in range(3):
            out.append(s.decode(out[-1]))
            hid.append(s.last_hidden.clone())
        s.reset_slots(np.array([1, 0, 1, 0]))
        s.compact_slots([1, 3, 0, 2])
        for _ in range(2):
            out.append(s.decode(out[-1].reshape(R, ROWS)[[1, 3, 0, 2]]
                                .reshape(-1)))
            hid.append(s.last_hidden[:2 * ROWS].clone())
        runs[name] = (out, hid, s)
    (o1, h1, s1), (o2, h2, s2) = runs["serve_1f"], runs["serve_interleaved"]
    assert s2.sched.n_ticks == 9 and s1.sched.n_ticks == 5
    for a, b in zip(o1, o2):
        assert torch.equal(a[:2 * ROWS], b[:2 * ROWS])
    for a, b in zip(h1, h2):
        assert torch.equal(a[:2 * ROWS], b[:2 * ROWS])
    np.testing.assert_array_equal(s1._pos, s2._pos)


# --------------------------------------------------------------------------
# schedule tables: buckets, live masks, TTFT
# --------------------------------------------------------------------------

def _sched_pair(S, R, v):
    if v == 1:
        return tsched.ScheduleServe1F(S, R), jsched.ScheduleServe1F(S, R)
    return (tsched.ScheduleServeInterleaved(S, R, virtual_stages=v),
            jsched.ScheduleServeInterleaved(S, R, virtual_stages=v))


@pytest.mark.parametrize("R", range(1, 9))
@pytest.mark.parametrize("v", [1, 2])
@pytest.mark.parametrize("S", [2, 4])
def test_bucketed_tables_equal_jax(S, v, R):
    t, j = _sched_pair(S, R, v)
    assert tsched.bucket_lattice(R) == jsched.bucket_lattice(R)
    for b in range(1, R + 1):
        tb, jb = t.bucketed(b), j.bucketed(b)
        assert (tb.n_ticks, tb.n_microbatches) == (jb.n_ticks, b)
        for a in ("fwd", "exit_mb"):
            np.testing.assert_array_equal(getattr(tb.tables(), a),
                                          getattr(jb.tables(), a))
    for n in range(0, R + 1):
        assert tsched.pick_bucket(n, tsched.bucket_lattice(R)) == \
            jsched.pick_bucket(n, jsched.bucket_lattice(R))
    # every live subset's masked tables (R <= 5 keeps it small)
    if R <= 5:
        for bits in range(1, 2 ** R):
            live = [m for m in range(R) if bits >> m & 1]
            tm, jm = t.with_live_slots(live), j.with_live_slots(live)
            tm.validate()
            assert tm.live_count == jm.live_count
            np.testing.assert_array_equal(tm.live_mask(), jm.live_mask())
            np.testing.assert_array_equal(tm.tables().fwd, jm.tables().fwd)
            np.testing.assert_array_equal(tm.tables().exit_mb,
                                          jm.tables().exit_mb)
    assert tsched.serve_ttft(t, [1.0, 2.0] * (S // 2)) == \
        jsched.serve_ttft(j, [1.0, 2.0] * (S // 2))


def test_lattice_and_pick_bucket_errors():
    assert tsched.bucket_lattice(6) == (1, 2, 4, 6)
    with pytest.raises(ValueError, match="R=0"):
        tsched.bucket_lattice(0)
    with pytest.raises(ValueError, match="fits 5 live slots"):
        tsched.pick_bucket(5, (1, 2, 4))
    with pytest.raises(ValueError, match="outside"):
        tsched.ScheduleServe1F(2, 4).bucketed(5)


# --------------------------------------------------------------------------
# CacheExhausted and the slot operations' guards
# --------------------------------------------------------------------------

def _small(page_size=PAGE, R=2, **kw):
    spec = _port_spec(_attn_spec(n_layers=2))
    plan = TPlan(pp=1, tp=1, decode_microbatches=R)
    return build_serving(spec, plan, cache_len=CACHE, global_batch=R * ROWS,
                         compute_dtype=torch.float32, page_size=page_size,
                         prefill_len=PREFILL, device="cpu", **kw)


def _admit_all(sess, lens):
    R = sess.n_slots
    toks = np.ones((R, ROWS, PREFILL), np.int32)
    return sess.write_prefill_into_slots({"tokens": toks, "lens": lens},
                                         np.ones(R, np.int32))


def _snapshot(sess):
    a = sess._alloc
    return (sess._pos.copy(), a.tables.copy(), a.counts.copy(),
            list(a.free))


def _assert_unchanged(sess, snap):
    pos, tables, counts, free = snap
    np.testing.assert_array_equal(sess._pos, pos)
    np.testing.assert_array_equal(sess._alloc.tables, tables)
    np.testing.assert_array_equal(sess._alloc.counts, counts)
    assert sess._alloc.free == free
    sess._alloc.check()


def test_decode_capacity_exhausted_before_mutation_then_evict():
    from repro_torch.obs import Observability
    sess = _small(obs=Observability()).start()
    nxt = _admit_all(sess, [PREFILL, 4])
    for _ in range(CACHE - PREFILL):
        nxt = sess.decode(nxt)
    snap = _snapshot(sess)
    with pytest.raises(CacheExhausted, match="at paged KV capacity") as e:
        sess.decode(nxt)
    assert e.value.slots == (0,) and isinstance(e.value, RuntimeError)
    _assert_unchanged(sess, snap)
    assert sess.obs.counter("cache_exhausted_total").value(
        kind="decode", reason="capacity") == 1
    sess.reset_slots(np.array([1, 0]))
    sess.decode(nxt)
    np.testing.assert_array_equal(sess._pos, [0, 4 + CACHE - PREFILL + 1])
    assert sess.obs.counter("slot_resets_total").value() == 1


def test_decode_pool_dry_exhausted_before_mutation():
    """Two slots of 12-token prompts share 3 pages: the step that writes
    position 16 needs a second page in each, the pool covers slot 0's
    only, so the pool reason names slot 1 and slot 0 is not grown."""
    sess = _small(pool_pages=3).start()
    nxt = _admit_all(sess, [PREFILL, PREFILL])
    for _ in range(PAGE - PREFILL):
        nxt = sess.decode(nxt)
    snap = _snapshot(sess)
    assert sess._alloc.free_pages == 1
    with pytest.raises(CacheExhausted, match="page pool exhausted") as e:
        sess.decode(nxt)
    assert e.value.slots == (1,)
    _assert_unchanged(sess, snap)
    sess.reset_slots(np.array([0, 1]))
    sess.decode(nxt)
    assert sess._alloc.counts.tolist() == [2, 0]


def test_admit_and_bucket_guards():
    sess = _small(buckets=True, R=4).start()
    toks = np.ones((4, ROWS, PREFILL), np.int32)
    mask = np.ones(4, np.int32)
    with pytest.raises(ValueError, match=r"lens has 3 entries for R=4"):
        sess.write_prefill_into_slots({"tokens": toks,
                                       "lens": np.full(3, PREFILL)}, mask)
    with pytest.raises(ValueError, match=rf"lens entries must lie in "
                                         rf"\[1, {PREFILL}\]"):
        sess.write_prefill_into_slots({"tokens": toks,
                                       "lens": np.full(4, PREFILL + 1)},
                                      mask)
    with pytest.raises(ValueError, match=r"must be \(R=4, rows=2, "
                                         rf"prefill_len={PREFILL}\)"):
        sess.prefill({"tokens": toks[:, :, :5]})
    sess.reset_slots(np.ones(4))
    with pytest.raises(ValueError, match="admit bucket 1 excludes"):
        sess.write_prefill_into_slots({"tokens": toks},
                                      np.array([0, 1, 0, 0]), bucket=1)
    with pytest.raises(ValueError, match="not in the lattice"):
        sess.decode(np.zeros(8, np.int32), bucket=3)
    sess.write_prefill_into_slots({"tokens": toks}, np.array([0, 1, 0, 0]))
    assert sess._bucket_log == [2]
    with pytest.raises(ValueError, match=r"decode bucket 1 excludes live "
                                         r"slots \[1\]; compact_slots"):
        sess.decode(np.zeros(8, np.int32), bucket=1)
    with pytest.raises(ValueError, match="permutation of range"):
        sess.compact_slots([0, 0, 1, 2])
    plain = _small(R=4).start()
    with pytest.raises(ValueError, match="without buckets=True"):
        plain.decode(np.zeros(8, np.int32), bucket=2)


def test_sessions_without_prefill_len_or_with_recurrent_state_refuse():
    spec = _port_spec(_attn_spec(n_layers=2))
    one_shot = build_serving(spec, TPlan(pp=1, tp=1, decode_microbatches=2),
                             cache_len=CACHE, global_batch=4,
                             compute_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="without a prefill step"):
        one_shot.write_prefill_into_slots(
            {"tokens": np.ones((2, 2, 4), np.int32)}, np.ones(2))
    with pytest.raises(ValueError, match=r"decode\(\) before start"):
        one_shot.decode(np.zeros(4, np.int32))
    from repro_torch import configs
    cfg = configs.get("rwkv6-1.6b")
    rec = build_serving(cfg.smoke_spec(), cfg.SMOKE_PLAN.with_(tp=1),
                        cache_len=CACHE, global_batch=4, prefill_len=8,
                        compute_dtype=torch.float32, device="cpu").start()
    assert not rec.ragged_ok
    with pytest.raises(ValueError, match="ragged admission"):
        rec.write_prefill_into_slots(
            {"tokens": np.ones((rec.n_slots, rec.rows, 8), np.int32),
             "lens": np.full(rec.n_slots, 4)}, np.ones(rec.n_slots))


def test_allocator_truncate_and_permute_match_jax():
    from repro.serving.batcher import PageAllocator as JAlloc
    from repro_torch.serving.allocator import PageAllocator
    mine, ref = PageAllocator(12, 3, 4, 4), JAlloc(12, 3, 4, 4)
    ops = [("alloc", 0, 9), ("alloc", 1, 3), ("extend", 0, 14),
           ("truncate", 0, 6), ("alloc", 2, 16), ("permute", [2, 0, 1], None),
           ("truncate", 1, 0), ("extend", 2, 5), ("release", 0, 0)]
    for op, a, n in ops:
        outs = []
        for al in (mine, ref):
            if op == "permute":
                outs.append(al.permute_slots(a))
            elif op == "release":
                outs.append(al.release_slot(a))
            else:
                outs.append(getattr(al, f"{op}_slot")(a, n))
        assert outs[0] == outs[1]
        np.testing.assert_array_equal(mine.tables, ref.tables)
        np.testing.assert_array_equal(mine.tokens, ref.tokens)
        assert mine.free == ref.free
        mine.check()
    with pytest.raises(ValueError, match="truncate only shrinks"):
        mine.truncate_slot(2, 99)
    with pytest.raises(ValueError, match="permutation"):
        mine.permute_slots([0, 0, 1])
