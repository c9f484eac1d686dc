"""The port's planner (core/profiler.py, core/partitioner.py, the
re-planning half of runtime/driver.py) against the JAX package's, on
seeded profiles and the ported configs' full specs, under the same
``Hardware`` fields."""
import dataclasses

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import partitioner as jpart
from repro.core import profiler as jprof
from repro.runtime import driver as jdriver
from repro_torch import configs as tconfigs
from repro_torch.core import partitioner as tpart
from repro_torch.core import profiler as tprof
from repro_torch.runtime import driver as tdriver

ARCHS = ("qwen3-14b", "rwkv6-1.6b", "jamba-v0.1-52b")


def _hw(name):
    """(JAX Hardware, port Hardware) with the same fields."""
    src = {"v5e": dataclasses.asdict(jprof.TPU_V5E),
           "h100": dataclasses.asdict(tprof.H100_SXM),
           "cluster_a": dataclasses.asdict(jprof.CLUSTER_A)}[name]
    return jprof.Hardware(**src), tprof.Hardware(**src)


def test_h100_sxm_fields_are_pinned():
    assert dataclasses.asdict(tprof.H100_SXM) == dict(
        name="h100-sxm", flops_peak=989e12, hbm_bw=3.35e12, link_bw=450e9,
        mfu=0.5, net_bw=None, param_bytes=2.0, ps_factor=2.0,
        hbm_bytes=80e9)
    assert tprof.H100_SXM.sync_bw == 450e9
    assert tprof.ACT_BYTES == jprof.ACT_BYTES
    for name in ("CLUSTER_A", "CLUSTER_B"):
        assert dataclasses.asdict(getattr(tprof, name)) == \
            dataclasses.asdict(getattr(jprof, name))


def _profiles(seed, n, scale_w=1e6):
    """The same seeded LayerProfiles in both packages."""
    rng = np.random.default_rng(seed)
    rows = [(f"l{i}", float(rng.uniform(1e-3, 5e-2)),
             float(rng.uniform(2e-3, 1e-1)), float(rng.uniform(1e4, 1e7)),
             float(rng.uniform(0, scale_w))) for i in range(n)]
    return ([jprof.LayerProfile(*r) for r in rows],
            [tprof.LayerProfile(*r) for r in rows])


def _same_partition(t, j):
    assert [(s.start, s.end, s.replicas) for s in t.stages] == \
        [(s.start, s.end, s.replicas) for s in j.stages]
    assert t.bottleneck_time == j.bottleneck_time
    assert (t.noam, t.config_string) == (j.noam, j.config_string)


@pytest.mark.parametrize("hw", ["cluster_a", "h100"])
@pytest.mark.parametrize("machines", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("seed,n", [(0, 4), (1, 7), (2, 12), (3, 20)])
def test_partition_equals_jax(seed, n, machines, hw):
    jp, tp = _profiles(seed, n, scale_w=1e8 if hw == "cluster_a" else 1e6)
    jhw, thw = _hw(hw)
    _same_partition(tpart.partition(tp, machines, thw),
                    jpart.partition(jp, machines, jhw))
    _same_partition(tpart.partition_scalar(tp, machines, thw),
                    jpart.partition_scalar(jp, machines, jhw))
    if n <= 7 and machines <= 3:
        assert tpart.partition_brute_force(tp, machines, thw) == \
            jpart.partition_brute_force(jp, machines, jhw)
    for stages in {1, 2, min(n, 4)}:
        _same_partition(
            tpart.partition_rectangular(tp, stages, machines, thw),
            jpart.partition_rectangular(jp, stages, machines, jhw))


def test_uniform_split_and_stage_time_equal_jax():
    for n, s in [(8, 2), (40, 4), (40, 8), (12, 3)]:
        assert tpart.uniform_layer_split(n, s) == \
            jpart.uniform_layer_split(n, s)
    jp, tp = _profiles(7, 9)
    jhw, thw = _hw("cluster_a")
    for i, j, m in [(0, 8, 1), (2, 5, 3), (4, 4, 2)]:
        assert tpart.stage_time(tp, i, j, m, thw) == \
            jpart.stage_time(jp, i, j, m, jhw)


@pytest.mark.parametrize("kv_len", [None, 1024])
@pytest.mark.parametrize("hw", ["v5e", "h100"])
@pytest.mark.parametrize("arch", ARCHS)
def test_profile_analytic_equals_jax(arch, hw, kv_len):
    jspec = jconfigs.get(arch).full_spec()
    tspec = tconfigs.get(arch).full_spec()
    jhw, thw = _hw(hw)
    jpr = jprof.profile_analytic(jspec, jhw, minibatch_tokens=131072,
                                 kv_len=kv_len)
    tpr = tprof.profile_analytic(tspec, thw, minibatch_tokens=131072,
                                 kv_len=kv_len)
    assert len(tpr) == len(jpr) == tspec.n_layers + 2
    for t, j in zip(tpr, jpr):
        assert t.name == j.name
        np.testing.assert_allclose(
            [t.t_fwd, t.t_bwd, t.a_bytes, t.w_params],
            [j.t_fwd, j.t_bwd, j.a_bytes, j.w_params], rtol=1e-12, atol=0)
    assert tspec.param_count() == jspec.param_count()
    assert tspec.active_param_count() == jspec.active_param_count()
    assert tprof.model_flops_train(tspec, 4096) == \
        jprof.model_flops_train(jspec, 4096)
    assert tprof.head_flops(tspec, 4096) == jprof.head_flops(jspec, 4096)


def test_comm_times_equal_jax():
    for hw in ("v5e", "h100", "cluster_a"):
        jhw, thw = _hw(hw)
        for a, m in [(1e6, 1), (3e7, 2), (5e8, 8)]:
            assert tprof.comm_time_activations(a, thw) == \
                jprof.comm_time_activations(a, jhw)
            assert tprof.comm_time_weight_sync(a, m, thw) == \
                jprof.comm_time_weight_sync(a, m, jhw)
            assert tprof.comm_time_tp_allreduce(a, m, thw) == \
                jprof.comm_time_tp_allreduce(a, m, jhw)


def test_profile_measured_keeps_jax_semantics():
    calls = []
    out = tprof.profile_measured([lambda: calls.append(0)] * 2, ["a", "b"],
                                 [1.0, 2.0], [3.0, 4.0], warmup=1, iters=3,
                                 bwd_factor=2.5)
    assert len(calls) == 8
    assert [(p.name, p.a_bytes, p.w_params) for p in out] == \
        [("a", 1.0, 3.0), ("b", 2.0, 4.0)]
    assert all(p.t_bwd == 2.5 * p.t_fwd and p.t_fwd >= 0 for p in out)


@pytest.mark.parametrize("v", [1, 2])
@pytest.mark.parametrize("n_stages", [2, 4])
def test_scale_profiles_to_measurements_equals_jax(n_stages, v):
    jspec = jconfigs.get("qwen3-14b").full_spec()
    tspec = tconfigs.get("qwen3-14b").full_spec()
    jhw, thw = _hw("h100")
    jpr = jprof.profile_analytic(jspec, jhw, minibatch_tokens=8192)
    tpr = tprof.profile_analytic(tspec, thw, minibatch_tokens=8192)
    meas = np.random.default_rng(n_stages * v).uniform(0.5, 3.0, n_stages)
    for t, j in zip(tprof.scale_profiles_to_measurements(
                        tpr, meas, n_stages=n_stages, virtual_stages=v),
                    jprof.scale_profiles_to_measurements(
                        jpr, meas, n_stages=n_stages, virtual_stages=v)):
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
    assert [list(r) for r in tprof.profile_stage_spans(42, 4 * v)] == \
        [list(r) for r in jprof.profile_stage_spans(42, 4 * v)]


def _plan_fields(plan):
    return (plan.pp, plan.tp, plan.schedule, plan.stash_mode,
            plan.virtual_stages, plan.microbatches)


@pytest.mark.parametrize("hw", ["v5e", "h100"])
@pytest.mark.parametrize("axis", [8, 16])
def test_plan_search_ranks_as_jax(axis, hw):
    jspec = jconfigs.get("qwen3-14b").full_spec()
    tspec = tconfigs.get("qwen3-14b").full_spec()
    jplan, tplan_ = (jconfigs.get("qwen3-14b").PLAN,
                     tconfigs.get("qwen3-14b").PLAN)
    jhw, thw = _hw(hw)
    kw = dict(minibatch_tokens=4096 * 32, data_replicas=1, return_all=True)
    jc = jpart.plan_search(jspec, jplan, axis, jhw, **kw)
    tc = tpart.plan_search(tspec, tplan_, axis, thw, **kw)
    assert len(tc) == len(jc) > 10
    for t, j in zip(tc, jc):
        assert _plan_fields(t.plan) == _plan_fields(j.plan)
        assert t.feasible == j.feasible
        assert t.round_time == pytest.approx(j.round_time, rel=1e-12)
        assert t.bubble_fraction == pytest.approx(j.bubble_fraction,
                                                  rel=1e-12)
        assert t.memory.total_bytes == j.memory.total_bytes
        assert t.describe() == j.describe()
    if any(c.feasible for c in jc):
        best_t = tpart.plan_search(tspec, tplan_, axis, thw,
                                   minibatch_tokens=4096 * 32)
        best_j = jpart.plan_search(jspec, jplan, axis, jhw,
                                   minibatch_tokens=4096 * 32)
        assert best_t.describe() == best_j.describe()
    else:                    # both refuse: no plan fits the budget
        for fn, spec, plan, h in ((tpart.plan_search, tspec, tplan_, thw),
                                  (jpart.plan_search, jspec, jplan, jhw)):
            with pytest.raises(AssertionError, match="no plan fits"):
                fn(spec, plan, axis, h, minibatch_tokens=4096 * 32)


def test_stage_phase_times_equal_jax():
    jspec = jconfigs.get("qwen3-14b").full_spec()
    tspec = tconfigs.get("qwen3-14b").full_spec()
    jhw, thw = _hw("v5e")
    jpr = jprof.profile_analytic(jspec, jhw, minibatch_tokens=16384)
    tpr = tprof.profile_analytic(tspec, thw, minibatch_tokens=16384)
    for pp, v, tp, dp in [(2, 1, 8, 1), (4, 2, 4, 2), (8, 5, 1, 4)]:
        jp = jpart.partition_rectangular(jpr, pp * v, dp, jhw)
        tpt = tpart.partition_rectangular(tpr, pp * v, dp, thw)
        t = tpart.stage_phase_times(tpr, tpt, pp, tp, thw, data_replicas=dp)
        j = jpart.stage_phase_times(jpr, jp, pp, tp, jhw, data_replicas=dp)
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])


# a straggler at each stage, none, and a small skew under the slack
MEASURED = [[1.0, 1.0], [3.0, 1.0], [1.0, 3.0], [1.1, 1.0],
            [1.0, 1.0, 1.0, 4.0], [2.0, 1.0, 1.0, 1.0]]


@pytest.mark.parametrize("measured", MEASURED)
def test_rebalance_from_measurements_equals_jax(measured):
    jspec = jconfigs.get("qwen3-14b").full_spec()
    tspec = tconfigs.get("qwen3-14b").full_spec()
    pp = len(measured)
    jplan = jconfigs.get("qwen3-14b").PLAN.with_(pp=pp, tp=16 // pp)
    tplan_ = tconfigs.get("qwen3-14b").PLAN.with_(pp=pp, tp=16 // pp)
    for hw in ("v5e", "h100"):
        jhw, thw = _hw(hw)
        kw = dict(minibatch_tokens=16384, data_replicas=2)
        jnew, jflag = jdriver.rebalance_from_measurements(
            jspec, jplan, measured, jhw, **kw)
        tnew, tflag = tdriver.rebalance_from_measurements(
            tspec, tplan_, measured, thw, **kw)
        assert tflag == jflag
        assert _plan_fields(tnew) == _plan_fields(jnew)
        for axis in (8, 16):
            assert _plan_fields(tdriver.elastic_replan(
                tspec, tplan_, axis, thw, measured_stage_seconds=measured,
                **kw)) == _plan_fields(jdriver.elastic_replan(
                    jspec, jplan, axis, jhw,
                    measured_stage_seconds=measured, **kw))
        assert tdriver._plan_is_buildable(tspec, tplan_, thw, **kw) == \
            jdriver._plan_is_buildable(jspec, jplan, jhw, **kw)
