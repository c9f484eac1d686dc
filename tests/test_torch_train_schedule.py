"""The port's training schedule tables (1f1b stash / vertical, gpipe flush
/ 2bw) pinned to the JAX package's, and the registry's resolution."""
import numpy as np
import pytest

from repro.core import schedule as jsched
from repro.parallel import mesh as jmesh
from repro_torch.core import schedule as tsched
from repro_torch.parallel import plan as tplan

MODES = {"stash": ("Schedule1F1B", {}),
         "vertical": ("Schedule1F1B", {"policy": "vertical"}),
         "flush": ("ScheduleGPipe", {}),
         "2bw": ("ScheduleGPipe", {"weight_versions": 2})}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("R", range(1, 9))
@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_training_tables_equal_jax(S, R, mode):
    name, kw = MODES[mode]
    t, j = getattr(tsched, name)(S, R, **kw), getattr(jsched, name)(S, R, **kw)
    t.validate()
    tt, jt = t.tables(), j.tables()
    for a in ("fwd", "bwd", "exit_mb", "demb_mb"):
        np.testing.assert_array_equal(getattr(tt, a), getattr(jt, a))
    for a in ("stash_slots", "resid_slots", "n_ticks", "n_chunks",
              "accumulate", "uses_stash_ring", "fwd_from_stash",
              "bubble_fraction", "name"):
        assert getattr(t, a) == getattr(j, a), a
    assert tsched.weighted_round_time(t) == jsched.weighted_round_time(j)
    assert tsched.weighted_round_time(t, [1.0, 3.0, 2.0, 1.5][:S], 2.5) == \
        jsched.weighted_round_time(j, [1.0, 3.0, 2.0, 1.5][:S], 2.5)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("schedule", ["auto", "1f1b", "gpipe", "interleaved",
                                      "interleaved_async"])
def test_make_schedule_resolves_as_jax(schedule, mode):
    # the interleaved family needs microbatch groups (R % pp == 0)
    R = 6 if schedule.startswith("interleaved") else 5
    kw = dict(pp=3, tp=1, microbatches=R, stash_mode=mode)
    t_plan, j_plan = tplan.ParallelismPlan(**kw), jmesh.ParallelismPlan(**kw)
    if schedule != "auto":
        t_plan = t_plan.with_(**tsched.plan_kwargs_for_schedule(
            schedule, stash_mode=mode))
        j_plan = j_plan.with_(**jsched.plan_kwargs_for_schedule(
            schedule, stash_mode=mode))
        assert t_plan.stash_mode == j_plan.stash_mode
    t, j = tsched.make_schedule(t_plan), jsched.make_schedule(j_plan)
    assert type(t).__name__ == type(j).__name__
    assert (t.name, t.stash_slots, t.fwd_from_stash, t.accumulate) == \
        (j.name, j.stash_slots, j.fwd_from_stash, j.accumulate)
    np.testing.assert_array_equal(t.tables().fwd, j.tables().fwd)
    np.testing.assert_array_equal(t.tables().bwd, j.tables().bwd)


def test_unported_schedules_raise_and_serving_maps_training_plans():
    plan = tplan.ParallelismPlan(pp=2, tp=1, microbatches=4)
    assert tsched.NOT_PORTED == ()
    for name in ("serve_interleaved", "serve_spec_1f",
                 "serve_spec_interleaved"):
        kw = tsched.plan_kwargs_for_schedule(name)
        assert kw == jsched.plan_kwargs_for_schedule(name)
        s = tsched.make_schedule(plan.with_(**kw))
        assert s.name == name and s.is_serving
    with pytest.raises(KeyError, match="not a registered schedule"):
        tsched.make_schedule(plan.with_(schedule="serve_2f"))
    for name in ("1f1b", "gpipe"):
        s = tsched.make_serving_schedule(plan.with_(schedule=name), 3)
        assert (s.name, s.n_microbatches, s.is_serving) == ("serve_1f", 3,
                                                            True)
    assert tsched.make_schedule(plan.with_(schedule="serve_1f")).is_serving
