"""The port's continuous batcher (``repro_torch.serving.batcher``)
against the JAX batcher: tests/test_batcher.py's scenarios on a
deterministic fake engine, request traces through both real engines
(ragged prompts, bucketed compaction, an admission queued on a dry page
pool, a decode the pool cannot cover), and the serve CLI's
``--arrivals`` / ``--spec-k`` on the CPU.
"""
import functools

import numpy as np
import pytest

from repro.serving import batcher as jb
from repro.serving.engine import CacheExhausted as JCacheExhausted
from repro_torch.serving import batcher as tb
from repro_torch.serving.engine import CacheExhausted
from test_batcher import FakeEngine, _chain, _mk_requests
from test_paged import _attn_spec
from test_torch_engine import _port_spec, _weights
from test_torch_serving_slots import (PREFILL, ROWS, _jax_session,
                                      _port_session)


class PortFake(FakeEngine):
    """tests/test_batcher.py's fake engine with the port engine's surface
    (``prefill_len``, ``started``); ``exhaust`` = (decode call, slots)
    makes that decode raise the engine's CacheExhausted first."""

    error = CacheExhausted

    def __init__(self, *a, exhaust=None, **kw):
        super().__init__(*a, **kw)
        self.prefill_len = self.text_len
        self.exhaust = exhaust
        self.n_decodes = 0

    @property
    def started(self):
        return self.state is not None

    def decode(self, tokens):
        self.n_decodes += 1
        if self.exhaust and self.n_decodes == self.exhaust[0]:
            raise self.error("blocked", slots=self.exhaust[1])
        return super().decode(tokens)


class JaxFake(PortFake):
    error = JCacheExhausted


def _run(module, fake_cls, scenario):
    kw, lens, arrivals, run_kw = scenario
    eng_kw = {k: kw[k] for k in ("slots", "rows", "text_len", "dt_admit",
                                 "exhaust") if k in kw}
    eng = fake_cls(**eng_kw)
    server = module.ContinuousBatchingSession(
        eng, clock=eng.clock, **run_kw)
    reqs = _mk_requests(lens, arrivals, text_len=kw.get("text_len", 4))
    for r, plen in zip(reqs, kw.get("prompt_lens", [])):
        r.prompt = r.prompt[:plen]
    rep = server.run(reqs)
    return rep, eng, reqs


SCENARIOS = {
    "lifecycle": ({"slots": 2}, [3, 6, 4], [0, 0, 1], {}),
    "evict_next_tick": ({"slots": 1}, [2, 2], [0, 0], {}),
    "synchronized": ({"slots": 2}, [2, 8, 4], [0, 0, 1],
                     {"policy": "synchronized"}),
    "continuous": ({"slots": 2}, [2, 8, 4], [0, 0, 1], {}),
    "eos": ({"slots": 1}, [50], [0], {"eos_id": 93}),
    "accounting": ({"slots": 2, "dt_admit": 2.0}, [4, 4], [0, 0], {}),
    "lanes_ragged": ({"slots": 2, "rows": 2, "prompt_lens": [4, 4, 2, 3, 2]},
                     [3, 5, 4, 2, 6], [0, 0, 0, 1, 2], {}),
    "exhausted": ({"slots": 2, "exhaust": (3, (1,))}, [6, 6, 3],
                  [0, 0, 1], {}),
}


def _req_state(r):
    return (r.rid, r.state, r.truncated, r.tokens, r.step_admitted,
            r.step_first, r.step_done)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fake_engine_scenarios_match_jax_batcher(name):
    scenario = SCENARIOS[name]
    jrep, jeng, jreqs = _run(jb, JaxFake, scenario)
    trep, teng, treqs = _run(tb, PortFake, scenario)
    assert [_req_state(r) for r in treqs] == [_req_state(r) for r in jreqs]
    assert trep.summary() == jrep.summary()
    for a, b in ((teng.admit_masks, jeng.admit_masks),
                 (teng.reset_masks, jeng.reset_masks)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    if name in ("lifecycle", "continuous", "evict_next_tick"):
        for r in treqs:
            assert r.tokens == _chain(r.prompt, r.max_new_tokens)
    if name == "exhausted":
        assert any(r.truncated for r in treqs)


def test_rerun_resets_arrival_gating_and_counters():
    eng = PortFake(slots=2)
    server = tb.ContinuousBatchingSession(eng, clock=eng.clock)
    r1 = server.run(_mk_requests([4, 4], [0, 0]))
    reqs = _mk_requests([4, 4], [0, 3], seed=1)
    r2 = server.run(reqs)
    assert reqs[1].step_admitted == 3
    assert r2.steps <= r1.steps + 4 and r2.decode_rounds <= 7
    for r in reqs:
        assert r.tokens == _chain(r.prompt, 4)


def test_error_paths_and_queue():
    eng = PortFake(slots=2)
    with pytest.raises(ValueError, match="unknown policy"):
        tb.ContinuousBatchingSession(eng, policy="fifo")
    bad = PortFake(slots=2)
    bad.prefill_len = 0
    with pytest.raises(ValueError, match="prefill_len"):
        tb.ContinuousBatchingSession(bad)
    server = tb.ContinuousBatchingSession(eng, clock=eng.clock)
    long = tb.Request(rid=0, prompt=np.arange(6, dtype=np.int32),
                      max_new_tokens=1)
    with pytest.raises(ValueError, match="exceeds"):
        server.run([long])
    rec = PortFake(slots=2)
    rec.ragged_ok = False
    short = tb.Request(rid=0, prompt=np.arange(2, dtype=np.int32),
                       max_new_tokens=1)
    with pytest.raises(ValueError, match="recurrent"):
        tb.ContinuousBatchingSession(rec, clock=rec.clock).run([short])
    q = tb.RequestQueue(_mk_requests([1, 1, 1], [5, 0, 2]))
    q.absorb_arrivals(4, 1.0)
    assert q.n_ready == 2 and q.pop_ready().rid == 1
    with pytest.raises(ValueError, match="arrival order"):
        qq = tb.RequestQueue(_mk_requests([1], [5]))
        qq.push(_mk_requests([1], [1])[0])
    s = tb.Slot(0, lanes=2)
    assert s.free and not s.drained


# --------------------------------------------------------------------------
# request traces through both real engines
# --------------------------------------------------------------------------

# (prompt length, max_new_tokens, arrival) per pair of requests (a slot's
# two lanes); pool_pages
TRACES = {
    # slot 0 grows to 2 pages, the pool is dry when the third pair
    # arrives: its admission queues until slot 0 is evicted
    "pool_dry_admission": (((12, 9, 0), (7, 2, 0), (12, 3, 5)), 2),
    # both slots cross into a second page on the same step and the pool
    # covers one: the other slot's requests finish truncated
    "pool_dry_decode": (((12, 9, 0), (12, 9, 0), (5, 4, 2)), 3),
    # the default pool: mid-stream admission into an evicted slot, the
    # live set shrinking to bucket 1 and growing back
    "staggered": (((12, 4, 0), (7, 9, 0), (10, 3, 2), (4, 6, 3)), None),
}


def _requests(trace, vocab, module):
    rng = np.random.default_rng(11)
    reqs = []
    for plen, new, arr in trace:
        for _ in range(ROWS):
            reqs.append(module.Request(
                rid=len(reqs), prompt=rng.integers(1, vocab, plen)
                .astype(np.int32), max_new_tokens=new, arrival=arr))
    return reqs


@functools.lru_cache(maxsize=None)
def _jax_trace(name):
    trace, pool = TRACES[name]
    jspec = _attn_spec(n_layers=2)
    params = _weights(jspec)
    js = _jax_session(jspec, params, 2, page_size=16, buckets=True,
                      pool_pages=pool)
    reqs = _requests(trace, jspec.vocab, jb)
    rep = jb.ContinuousBatchingSession(js).run(reqs)
    return jspec, params, [_req_state(r) for r in reqs], rep.summary(), \
        list(js._bucket_log)


@pytest.mark.parametrize("name", list(TRACES))
def test_trace_through_both_engines(name):
    jspec, params, want, jsum, jlog = _jax_trace(name)
    trace, pool = TRACES[name]
    ts = _port_session(_port_spec(jspec), params, 2, page_size=16,
                       buckets=True, pool_pages=pool)
    reqs = _requests(trace, jspec.vocab, tb)
    server = tb.ContinuousBatchingSession(ts)
    steps = []
    orig = server.step

    def step():
        more = orig()
        ts._alloc.check()
        steps.append(ts._alloc.free_pages)
        return more

    server.step = step
    rep = server.run(reqs)
    assert [_req_state(r) for r in reqs] == want
    s = rep.summary()
    for k in ("completed", "completed_tokens", "steps", "decode_rounds",
              "admit_rounds"):
        assert s[k] == jsum[k], k
    assert ts._bucket_log == jlog
    assert ts._alloc.live_pages == 0
    assert ts._alloc.free_pages == ts.paged["pool_pages"]
    if name == "pool_dry_admission":
        assert rep.pool_stalls >= 1
        assert reqs[4].step_admitted > reqs[0].step_done
    if name == "pool_dry_decode":
        assert any(r.truncated for r in reqs)
    if name == "staggered":
        assert {1, 2} <= set(jlog)


# --------------------------------------------------------------------------
# the serve CLI
# --------------------------------------------------------------------------

def test_parse_arrivals_equals_jax():
    from repro.launch.serve import parse_arrivals as jparse
    from repro_torch.launch.serve import parse_arrivals
    for spec in ("0,0,2,5", "poisson:0.5:8", "poisson:2:16"):
        assert parse_arrivals(spec, seed=3) == jparse(spec, seed=3)
    for bad in ("poisson:0.5", "poisson:fast:8", "1,two", "3,-1",
                "poisson:0.5:0"):
        with pytest.raises(ValueError, match="accepted --arrivals"):
            parse_arrivals(bad)


@pytest.mark.parametrize("extra,expect", [
    (["--buckets", "--arrivals", "0,0,2,4"],
     ["continuous batching: 4 requests over 4 slots", "bucket rounds:"]),
    (["--spec-k", "2", "--arrivals", "0,1,1"],
     ["serve_spec_1f (S=2 R=4 spec_k=2", "speculative:"]),
    (["--spec-k", "2"], ["spec-decoded", "verify rounds (k=2"]),
    (["--schedule", "serve_interleaved", "--virtual-stages", "2"],
     ["serve_interleaved (S=2 R=4 v=2", "decoded 3 steps x 4 seqs"]),
])
def test_serve_cli_on_cpu(capsys, extra, expect):
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                "--page-size", "16", "--batch", "4", "--prefill", "8",
                "--tokens", "3", "--cache-len", "32", *extra])
    out = capsys.readouterr().out
    for e in expect:
        assert e in out, out


def test_serve_cli_rejects_bad_flag_combinations():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                    "--schedule", "serve_1f", "--spec-k", "2"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                    "--schedule", "serve_1f", "--virtual-stages", "2"])
