"""The port's serving planner (``default_cache_lens``,
``serving_cache_bytes``, the serving ``memory_model``s, ``plan_search``
for decode and prefill, ``plan_search_report``) against the JAX
package's, on the ported configs' full and smoke specs under the same
``Hardware`` fields; the golden and assert cases of the JAX package's
tests/test_paged.py and tests/test_serve_schedule.py; and the JAX
package's speculative-planning fault (ROADMAP Queue 3), which the port
does not copy."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import partitioner as jpart
from repro.core import profiler as jprof
from repro.core import schedule as jsched
from repro.models import spec as jspec_lib
from repro.parallel.mesh import ParallelismPlan as JPlan
from repro.runtime import driver as jdriver
from repro_torch import configs as tconfigs
from repro_torch.core import partitioner as tpart
from repro_torch.core import profiler as tprof
from repro_torch.core import schedule as tsched
from repro_torch.models import spec as tspec_lib
from repro_torch.parallel.plan import ParallelismPlan as TPlan
from repro_torch.runtime import driver as tdriver

ARCHS = ("qwen3-14b", "rwkv6-1.6b", "jamba-v0.1-52b", "h2o-danube-3-4b")
REL = 1e-12


def _hw(name, **kw):
    """(JAX Hardware, port Hardware) with the same fields."""
    src = {"v5e": dataclasses.asdict(jprof.TPU_V5E),
           "h100": dataclasses.asdict(tprof.H100_SXM)}[name]
    src.update(kw)
    return jprof.Hardware(**src), tprof.Hardware(**src)


def _specs(arch, kind):
    j, t = jconfigs.get(arch), tconfigs.get(arch)
    return getattr(j, kind)(), getattr(t, kind)()


def _plans(**kw):
    return JPlan(**kw), TPlan(**kw)


def _splits(spec, L):
    """Whether the JAX package can cut ``spec`` into ``L`` chunks."""
    if spec.n_layers % L:
        return False
    try:
        spec.stage_program(L)
    except AssertionError:
        return False
    return True


def _sched_pairs(jspec):
    """(pp, schedule name, v) serving layouts the spec splits into."""
    out = []
    for pp, (name, v) in itertools.product(
            (1, 2, 4), (("serve_1f", 1), ("serve_interleaved", 2),
                        ("serve_interleaved", 4))):
        if _splits(jspec, pp * v):
            out.append((pp, name, v))
    return out


def _close(got, want, rel=REL):
    assert got == pytest.approx(want, rel=rel, abs=0.0), (got, want)


def _same_memory(t, j, rel=REL):
    assert t.schedule == j.schedule
    for f in dataclasses.fields(j):
        if f.name != "schedule":
            _close(getattr(t, f.name), getattr(j, f.name), rel)


@pytest.mark.parametrize("kind", ["full_spec", "smoke_spec"])
@pytest.mark.parametrize("arch", ARCHS)
def test_default_cache_lens_equal_jax(arch, kind):
    jspec, tspec = _specs(arch, kind)
    for L in (1, 2, 4, 8):
        if not _splits(jspec, L):
            continue
        for cache_len in (4, 8, 64, 4096, 8192, 32768):
            assert tsched.default_cache_lens(tspec, L, cache_len) == \
                jsched.default_cache_lens(jspec, L, cache_len)


@pytest.mark.parametrize("kind", ["full_spec", "smoke_spec"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_cache_bytes_equal_jax(arch, kind):
    """Every argument of ``serving_cache_bytes`` over the grid, and both
    serving memory models at the grid's corners."""
    jspec, tspec = _specs(arch, kind)
    cache_len, gb = (8192 if kind == "full_spec" else 64), 16
    n = 0
    for pp, name, v in _sched_pairs(jspec):
        jp, tp_ = _plans(pp=pp, tp=1, decode_microbatches=8, schedule=name,
                         virtual_stages=v)
        js, ts = (m.make_serving_schedule(p, 8)
                  for m, p in ((jsched, jp), (tsched, tp_)))
        for page, occ, n_slots, kv, prefill, sp, dp in itertools.product(
                (0, 16), (0.1, 0.25, 0.5, 1.0), (None, 8),
                (None, "bf16", "int8"), (False, True), (False, True),
                (1, 2)):
            if page and sp:
                continue
            kw = dict(cache_len=cache_len, global_batch=gb, sp=sp,
                      prefill=prefill, data_replicas=dp, page_size=page,
                      kv_occupancy=occ, n_slots=n_slots, kv_dtype=kv)
            _close(tsched.serving_cache_bytes(tspec, tp_, ts, **kw),
                   jsched.serving_cache_bytes(jspec, jp, js, **kw))
            n += 1
        jhw, thw = _hw("h100")
        for page, occ, prefill, wd, kv in itertools.product(
                (0, 16), (0.25, 1.0), (False, True), (None, "int8"),
                (None, "bf16")):
            kw = dict(microbatch_tokens=16, data_replicas=1,
                      cache_len=cache_len, global_batch=gb, prefill=prefill,
                      page_size=page, kv_occupancy=occ, weight_dtype=wd,
                      kv_dtype=kv)
            _same_memory(ts.memory_model(tspec, tp_, thw, **kw),
                         js.memory_model(jspec, jp, jhw, **kw))
    assert n > 0


@pytest.mark.parametrize("arch", ["qwen3-14b", "h2o-danube-3-4b"])
def test_speculative_memory_model_equals_jax_without_dtypes(arch):
    """JAX's speculative override takes no storage dtypes; without them
    the two models agree term for term."""
    jspec, tspec = _specs(arch, "full_spec")
    jhw, thw = _hw("h100")
    for pp, name, v in _sched_pairs(jspec):
        spec_name = name.replace("serve_", "serve_spec_")
        jp, tp_ = _plans(pp=pp, tp=1, decode_microbatches=8,
                         schedule=spec_name, virtual_stages=v)
        for k in (1, 3):
            js = jsched.make_serving_schedule(jp, 8, spec_k=k)
            ts = tsched.make_serving_schedule(tp_, 8, spec_k=k)
            for page, occ in ((0, 1.0), (16, 0.25)):
                kw = dict(microbatch_tokens=8, cache_len=8192,
                          global_batch=16, page_size=page, kv_occupancy=occ)
                _same_memory(ts.memory_model(tspec, tp_, thw, **kw),
                             js.memory_model(jspec, jp, jhw, **kw))


def _cand_key(c):
    p = c.plan
    return (p.pp, p.tp, p.schedule, p.stash_mode, p.virtual_stages,
            p.decode_microbatches, c.feasible, c.bucket, c.spec_k,
            c.workload, c.occupancy, c.weight_dtype, c.kv_dtype)


def _same_cands(tc, jc):
    assert [_cand_key(c) for c in tc] == [_cand_key(c) for c in jc]
    for t, j in zip(tc, jc):
        _close(t.round_time, j.round_time, 1e-9)
        _close(t.bubble_fraction, j.bubble_fraction, 1e-9)
        _same_memory(t.memory, j.memory, 1e-9)
        assert [(s.start, s.end) for s in t.partition.stages] == \
            [(s.start, s.end) for s in j.partition.stages]


SEARCH = [  # workload, cache_len, global_batch, page_size, occupancy, dtypes
    ("decode", 4096, 64, 0, 1.0, (None, None)),
    ("decode", 32768, 64, 16, 0.25, (None, None)),
    ("decode", 8192, 32, 16, 0.5, ("int8", "int8")),
    ("decode", 8192, 16, 0, 0.1, (None, "bf16")),
    ("prefill", 4096, 32, 0, 1.0, (None, None)),
    ("prefill", 8192, 8, 16, 1.0, ("int8", None)),
]


@pytest.mark.parametrize("hw", ["v5e", "h100"])
@pytest.mark.parametrize("case", range(len(SEARCH)))
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_search_candidates_equal_jax(arch, case, hw):
    workload, cache_len, gb, page, occ, (wd, kv) = SEARCH[case]
    jm, tm = jconfigs.get(arch), tconfigs.get(arch)
    jspec, tspec = jm.full_spec(), tm.full_spec()
    jhw, thw = _hw(hw)
    kw = dict(minibatch_tokens=gb // 8 * (cache_len if workload ==
                                          "prefill" else 1),
              workload=workload, cache_len=cache_len, global_batch=gb,
              page_size=page, occupancy=occ, weight_dtype=wd, kv_dtype=kv,
              return_all=True)
    axis = jm.PLAN.pp * jm.PLAN.tp
    jc = jpart.plan_search(jspec, jm.PLAN, axis, jhw, **kw)
    tc = tpart.plan_search(tspec, tm.PLAN, axis, thw, **kw)
    _same_cands(tc, jc)
    # the best fitting candidate, when one fits, and its description
    kw.pop("return_all")
    if any(c.feasible for c in jc):
        t = tpart.plan_search(tspec, tm.PLAN, axis, thw, **kw)
        j = jpart.plan_search(jspec, jm.PLAN, axis, jhw, **kw)
        assert _cand_key(t) == _cand_key(j)
        assert t.describe() == j.describe()


@pytest.mark.parametrize("workload", ["decode", "prefill"])
@pytest.mark.parametrize("arch", ["qwen3-14b", "h2o-danube-3-4b"])
def test_plan_search_report_equals_jax(arch, workload, capsys):
    jm, tm = jconfigs.get(arch), tconfigs.get(arch)
    jhw, thw = _hw("h100", hbm_bytes=1e15)
    kw = dict(seq_len=4096, global_batch=32, data_replicas=2,
              workload=workload)
    t = tdriver.plan_search_report(tm.full_spec(), tm.PLAN, thw, **kw)
    tout = capsys.readouterr().out
    j = jdriver.plan_search_report(jm.full_spec(), jm.PLAN, jhw, **kw)
    jout = capsys.readouterr().out
    assert _cand_key(t) == _cand_key(j)
    assert tout == jout and f"plan_search[{workload}]: " in tout


# ---- JAX tests/test_paged.py: the paged golden ------------------------------

def _attn_spec(lib, n_layers=8, window=0):
    blocks = tuple(lib.BlockSpec(mixer="attn", ffn="dense", window=window)
                   for _ in range(n_layers))
    return lib.ModelSpec(
        name="paged-test", d_model=64, n_layers=n_layers, n_heads=4,
        n_kv=2, d_head=16, d_ff=128, vocab=256, blocks=blocks,
        norm="rmsnorm", act="silu")


def _serve_plan(pp=2, r=8, schedule="serve_1f"):
    return TPlan(pp=pp, tp=1, microbatches=r, decode_microbatches=r,
                 schedule=schedule)


def test_plan_search_paged_unlocks_infeasible_decode_plan():
    """A decode plan over budget dense fits paged at 25% occupancy, and
    the paged feasible set holds the dense one (JAX
    tests/test_paged.py::test_plan_search_paged_unlocks_infeasible_decode_plan)."""
    spec = _attn_spec(tspec_lib, n_layers=8)
    plan = _serve_plan(pp=2, r=32)
    sched = tsched.make_schedule(plan)
    dense_cache = tsched.serving_cache_bytes(spec, plan, sched,
                                             cache_len=4096, global_batch=32)
    _close(dense_cache, jsched.serving_cache_bytes(
        _attn_spec(jspec_lib, n_layers=8),
        JPlan(pp=2, tp=1, microbatches=32, decode_microbatches=32,
              schedule="serve_1f"),
        jsched.ScheduleServe1F(2, 32), cache_len=4096, global_batch=32))
    hw = dataclasses.replace(_hw("v5e")[1], hbm_bytes=0.5 * dense_cache)
    kw = dict(minibatch_tokens=32, workload="decode", cache_len=4096,
              global_batch=32, occupancy=0.25, return_all=True)
    dense = tpart.plan_search(spec, plan, 2, hw, **kw)
    paged = tpart.plan_search(spec, plan, 2, hw, page_size=64, **kw)

    def feas(cands, pp):
        return [c.feasible for c in cands if c.plan.pp == pp
                and c.plan.schedule == "serve_1f"]
    assert feas(dense, 2) and not any(feas(dense, 2))
    assert feas(paged, 2) and all(feas(paged, 2))
    dense_ok = {(c.plan.pp, c.plan.schedule, c.plan.virtual_stages)
                for c in dense if c.feasible}
    paged_ok = {(c.plan.pp, c.plan.schedule, c.plan.virtual_stages)
                for c in paged if c.feasible}
    assert dense_ok <= paged_ok


def test_plan_search_rejects_paged_train_and_sp():
    spec, plan = _attn_spec(tspec_lib), _serve_plan()
    with pytest.raises(AssertionError, match="training"):
        tpart.plan_search(spec, plan, 2, minibatch_tokens=32,
                          workload="train", page_size=64)
    with pytest.raises(AssertionError, match="exclusive"):
        tpart.plan_search(spec, plan, 2, minibatch_tokens=32,
                          workload="decode", cache_len=4096,
                          global_batch=32, sp=True, page_size=64)


def test_cache_bytes_paged_rejects_sp_and_bad_page_size():
    spec, plan = _attn_spec(tspec_lib), _serve_plan()
    sched = tsched.make_schedule(plan)
    with pytest.raises(AssertionError):
        tsched.serving_cache_bytes(spec, plan, sched, cache_len=1024,
                                   global_batch=8, sp=True, page_size=64)
    with pytest.raises(AssertionError):
        tsched.serving_cache_bytes(spec, plan, sched, cache_len=1000,
                                   global_batch=8, page_size=64)


# ---- JAX tests/test_serve_schedule.py: the asserts --------------------------

HW_ROOMY = dataclasses.replace(_hw("v5e")[1], hbm_bytes=1e18)


def _mk_spec(n_layers=8, heads=4, d_model=256, d_ff=1024, vocab=1024):
    blocks = tuple(tspec_lib.BlockSpec(mixer="attn", ffn="dense")
                   for _ in range(n_layers))
    return tspec_lib.ModelSpec(name="t", d_model=d_model, n_layers=n_layers,
                               n_heads=heads, n_kv=heads,
                               d_head=max(d_model // heads, 8), d_ff=d_ff,
                               vocab=vocab, blocks=blocks, norm="rmsnorm",
                               act="silu")


def test_plan_search_prices_the_fitted_microbatch_count():
    """The R the engine runs: batch-fitted against the data replicas,
    1 under sequence-parallel decode; an indivisible batch raises."""
    spec = _mk_spec()
    base = TPlan(pp=4, tp=1, microbatches=8, decode_microbatches=8)
    best = tpart.plan_search(spec, base, 4, HW_ROOMY, minibatch_tokens=2,
                             data_replicas=4, workload="decode",
                             cache_len=1024, global_batch=8)
    assert tsched.make_schedule(best.plan).n_microbatches == 2
    sp_best = tpart.plan_search(spec, base, 4, HW_ROOMY, minibatch_tokens=1,
                                data_replicas=4, workload="decode",
                                cache_len=1024, global_batch=1, sp=True)
    assert tsched.make_schedule(sp_best.plan).n_microbatches == 1
    with pytest.raises(ValueError, match="not divisible"):
        tpart.plan_search(spec, base, 4, HW_ROOMY, minibatch_tokens=1,
                          data_replicas=3, workload="decode",
                          cache_len=1024, global_batch=8)


def test_plan_search_serving_rejects_training_schedules():
    spec = _mk_spec()
    base = TPlan(pp=4, tp=1, microbatches=8, decode_microbatches=8)
    with pytest.raises(AssertionError, match="does not run"):
        tpart.plan_search(spec, base, 4, HW_ROOMY, minibatch_tokens=32,
                          workload="decode", cache_len=1024, global_batch=8,
                          schedules=("1f1b",))
    with pytest.raises(AssertionError, match="cache_len"):
        tpart.plan_search(spec, base, 4, HW_ROOMY, minibatch_tokens=32,
                          workload="decode")
    with pytest.raises(AssertionError, match="partially live"):
        tpart.plan_search(spec, base, 4, HW_ROOMY, minibatch_tokens=32,
                          workload="prefill", cache_len=1024,
                          global_batch=8, occupancy=0.5)
    with pytest.raises(AssertionError, match="draft loop"):
        tpart.plan_search(spec, base, 4, HW_ROOMY, minibatch_tokens=32,
                          workload="prefill", cache_len=1024,
                          global_batch=8, spec_k=2)
    with pytest.raises(ValueError, match="need spec_k"):
        tpart.plan_search(spec, base, 4, HW_ROOMY, minibatch_tokens=32,
                          workload="decode", cache_len=1024, global_batch=8,
                          schedules=("serve_spec_1f",))


# ---- JAX fault: speculative decode cannot be planned ------------------------

def test_speculative_planning_prices_every_depth_where_jax_raises():
    """JAX's ``plan_search`` passes the storage dtypes to every serving
    ``memory_model`` and ``_SpeculativeServe.memory_model`` takes none,
    so any ``spec_k`` raises TypeError (ROADMAP Queue 3).  The port
    prices each depth 1..spec_k per accepted token, from the same plain
    rounds and memory JAX gives without speculation."""
    jm, tm = jconfigs.get("qwen3-14b"), tconfigs.get("qwen3-14b")
    jspec, tspec = jm.smoke_spec(), tm.smoke_spec()
    jhw, thw = _hw("v5e")
    kw = dict(minibatch_tokens=4, workload="decode", cache_len=64,
              global_batch=4, return_all=True)
    with pytest.raises(TypeError, match="weight_dtype"):
        jpart.plan_search(jspec, jm.SMOKE_PLAN, 2, jhw, spec_k=2, **kw)
    plain = jpart.plan_search(jspec, jm.SMOKE_PLAN, 2, jhw, **kw)
    alpha, c_v, c_d, K = 0.7, 0.15, 0.05, 3
    got = tpart.plan_search(tspec, tm.SMOKE_PLAN, 2, thw, spec_k=K,
                            spec_acceptance=alpha, **kw)
    assert {c.spec_k for c in got} == {None, 1, 2, 3}
    _same_cands([c for c in got if c.spec_k is None], plain)
    phases = {}
    for c in got:
        if c.spec_k is None:
            continue
        p = c.plan
        assert p.schedule in ("serve_spec_1f", "serve_spec_interleaved")
        base = next(j for j in plain
                    if (j.plan.pp, j.plan.virtual_stages) ==
                    (p.pp, p.virtual_stages) and j.plan.schedule ==
                    p.schedule.replace("spec_", ""))
        key = (p.pp, p.virtual_stages)
        if key not in phases:
            jp = jpart.partition_rectangular(
                jprof.profile_analytic(jspec, jhw, minibatch_tokens=4,
                                       kv_len=64), p.pp * p.virtual_stages,
                1, jhw)
            phases[key] = jpart.stage_phase_times(
                jprof.profile_analytic(jspec, jhw, minibatch_tokens=4,
                                       kv_len=64), jp, p.pp, p.tp, jhw)[0]
        k = c.spec_k
        adv = (1 - alpha ** (k + 1)) / (1 - alpha)
        want = (base.round_time * (1 + k * c_v)
                + k * c_d * float(np.mean(phases[key]))) / adv
        _close(c.round_time, want, 1e-9)
        js = dataclasses.replace(
            jsched.make_serving_schedule(
                JPlan(**{f.name: getattr(p, f.name)
                         for f in dataclasses.fields(p)}),
                p.decode_microbatches), spec_k=k)
        _same_memory(c.memory, js.memory_model(
            jspec, JPlan(**{f.name: getattr(p, f.name)
                            for f in dataclasses.fields(p)}), jhw,
            microbatch_tokens=4, cache_len=64, global_batch=4))
    # the storage dtypes reach the speculative model: int8 weights price
    # below the compute dtype's bytes, fp32 KV at twice them
    q = tpart.plan_search(tspec, tm.SMOKE_PLAN, 2, thw, spec_k=K,
                          spec_acceptance=alpha, weight_dtype="int8",
                          kv_dtype="fp32", **kw)

    def by_layout(cands):
        return {(c.plan.pp, c.plan.schedule, c.plan.virtual_stages,
                 c.spec_k): c for c in cands}
    plain_dt, quant_dt = by_layout(got), by_layout(q)
    assert set(plain_dt) == set(quant_dt)
    for key, a in plain_dt.items():
        b = quant_dt[key]
        assert b.memory.weight_bytes < a.memory.weight_bytes
        _close(b.memory.cache_bytes, 2 * a.memory.cache_bytes)
