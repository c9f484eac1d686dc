"""``repro_torch.obs`` (registry, trace, reconcile, Observability) against
``repro.obs`` on the same inputs, ``scripts/obs_smoke.py``'s invariants
on the port, the registry-driven replan against JAX's, and the reports
of the driver, the engine and both launchers."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_train_jax import one_torch_thread  # noqa: F401
from repro import obs as jobs
from repro.core import profiler as jprof
from repro.core.schedule import make_schedule as j_make_schedule
from repro.models import spec as jspec_lib
from repro.parallel.mesh import ParallelismPlan as JPlan
from repro.runtime.driver import replan_from_registry as j_replan
from repro_torch import configs
from repro_torch import obs as tobs
from repro_torch.core import profiler as tprof
from repro_torch.core.pipeline import build_pipeline
from repro_torch.core.schedule import (B_MB, F_MB, make_schedule,
                                       make_serving_schedule,
                                       weighted_round_time)
from repro_torch.data.pipeline import Loader, SyntheticLM
from repro_torch.launch import serve, train
from repro_torch.models import spec as tspec_lib
from repro_torch.optim import SGDM
from repro_torch.parallel.plan import ParallelismPlan as TPlan
from repro_torch.runtime.driver import (DriverConfig, TrainDriver,
                                        replan_from_registry)
from repro_torch.serving.engine import build_serving
from scripts.bench_check import _bad_numbers, check_metrics_snapshot
from scripts.obs_smoke import check_trace_schema

# (schedule, stash mode, virtual stages) of every training schedule
TRAIN_SCHEDULES = [("1f1b", "stash", 1), ("1f1b", "vertical", 1),
                   ("gpipe", "flush", 1), ("gpipe", "2bw", 1),
                   ("interleaved", "flush", 2),
                   ("interleaved_async", "stash", 2)]


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def _drive_registry(reg, clock):
    """The same calls on either package's registry."""
    c = reg.counter("rounds_total")
    c.inc(kind="decode")
    c.inc(2.5, kind="decode")
    c.inc(kind="train")
    reg.gauge("pages_free").set(7)
    reg.gauge("pages_free").set(5, pool="a")
    h = reg.histogram("round_seconds")
    for x in (0.25, 1.5, 0.75, 3.0):
        h.observe(x, kind="decode")
    h.observe(2.0, kind="train", bucket=4)
    reg.histogram("empty")
    with reg.timer("launch_phase_seconds", clock=clock, phase="run"):
        clock.advance(1.25)
    return reg.snapshot()


def test_registry_snapshot_equals_jax():
    got = _drive_registry(tobs.Registry(), FakeClock())
    want = _drive_registry(jobs.Registry(), FakeClock())
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert check_metrics_snapshot(got) == []
    assert json.loads(json.dumps(got)) == got


def test_counter_gauge_histogram_rules():
    reg = tobs.Registry()
    c = reg.counter("rounds_total")
    c.inc(3, kind="decode")
    assert c.value(kind="decode") == 3 and c.value(kind="nope") == 0
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1, kind="decode")
    reg.gauge("pages_free").set(5)
    with pytest.raises(TypeError, match="gauge"):
        reg.counter("pages_free")
    st = reg.histogram("round_seconds").stats(kind="decode")
    assert st["count"] == 0 and st["mean"] is None and st["p99"] is None
    assert _bad_numbers(st) == []


def test_stage_seconds_refuses_partial_telemetry():
    reg = tobs.Registry()
    h = reg.histogram("stage_round_seconds")
    h.observe(1.0, stage=0)
    with pytest.raises(ValueError, match="stage=1"):
        tobs.stage_seconds(reg, 2)
    h.observe(2.0, stage=1)
    assert tobs.stage_seconds(reg, 2) == [1.0, 2.0]


# --------------------------------------------------------------------------
# trace + reconcile against JAX, on every training table
# --------------------------------------------------------------------------

def _scheds(schedule, mode, v, S=2, R=4):
    kw = dict(pp=S, tp=1, microbatches=R, stash_mode=mode,
              schedule=schedule, virtual_stages=v)
    return j_make_schedule(JPlan(**kw)), make_schedule(TPlan(**kw))


def _record(package, sched, trace_kw):
    clock = FakeClock()
    obs = package.Observability(trace=True, clock=clock)
    tf, tb = np.array([1.0e-3, 2.5e-3]), np.array([2.0e-3, 3.0e-3])
    for dt in (0.5, 0.25, 0.75):
        clock.advance(0.125)
        t0 = clock()
        clock.advance(dt)
        obs.on_round("train", sched, t0, clock(), t_fwd=tf, t_bwd=tb,
                     **trace_kw)
    rep = package.reconcile(sched, trace=obs.trace, registry=obs.registry,
                            kind="train", t_fwd=tf, t_bwd=tb)
    return obs, rep


@pytest.mark.parametrize("bucket", [None, 4])
@pytest.mark.parametrize("schedule,mode,v", TRAIN_SCHEDULES)
def test_trace_and_reconcile_equal_jax(schedule, mode, v, bucket):
    """The same rounds over the same table: every trace event, the round
    records, the reconcile report and the snapshot equal JAX's."""
    jsched, tsched = _scheds(schedule, mode, v)
    assert np.array_equal(jsched.tables().fwd, tsched.tables().fwd)
    jo, jrep = _record(jobs, jsched, {"bucket": bucket})
    to, trep = _record(tobs, tsched, {"bucket": bucket})
    assert to.trace.to_json() == jo.trace.to_json()
    assert [dataclasses.asdict(r) for r in to.trace.rounds] == \
        [dataclasses.asdict(r) for r in jo.trace.rounds]
    assert trep.to_dict() == jrep.to_dict() and str(trep) == str(jrep)
    assert to.registry.snapshot() == jo.registry.snapshot()
    check_trace_schema(to.trace)


@pytest.mark.parametrize("schedule,mode,v", TRAIN_SCHEDULES
                         + [("serve_1f", "stash", 1)])
def test_obs_smoke_invariants_on_the_port(schedule, mode, v, tmp_path):
    """scripts/obs_smoke.py's gate on the port: rounds charged exactly
    ``weighted_round_time`` on a modeled clock reconcile at ratio 1.0,
    the span-measured bubble is the weighted prediction, each stage's
    span count is its non-bubble cells, and the files are valid."""
    S, R = 2, 4
    if schedule == "serve_1f":
        sched = make_serving_schedule(TPlan(pp=S, tp=1), R)
        tf, tb = np.array([1.0e-3, 2.0e-3]), 0.0
    else:
        sched = _scheds(schedule, mode, v, S, R)[1]
        tf, tb = np.array([1.0e-3, 2.0e-3]), np.array([2.0e-3, 3.5e-3])
    cost, bubble = weighted_round_time(sched, tf, tb)
    clock = FakeClock()
    obs = tobs.Observability(trace=True, clock=clock)
    n = 5
    for _ in range(n):
        t0 = clock()
        clock.advance(cost)
        obs.on_round("round", sched, t0, clock(), t_fwd=tf, t_bwd=tb)
    check_trace_schema(obs.trace)
    tabs = sched.tables()
    cells = ((tabs.fwd[:, :, F_MB] >= 0).sum(0)
             + (tabs.bwd[:, :, B_MB] >= 0).sum(0))
    counts = obs.trace.span_counts("round")
    assert [counts.get(s, 0) for s in range(S)] == (cells * n).tolist()
    rep = tobs.reconcile(sched, trace=obs.trace, registry=obs.registry,
                         kind="round", t_fwd=tf,
                         t_bwd=None if schedule == "serve_1f" else tb)
    assert rep.rounds == n
    assert abs(rep.round_ratio - 1.0) < 1e-9
    assert abs(rep.measured_bubble - bubble) < 1e-9
    assert rep.predicted_bubble > 0
    tr, mt = tmp_path / "trace.json", tmp_path / "metrics.json"
    obs.save(trace_out=str(tr), metrics_out=str(mt))
    assert json.loads(tr.read_text())["traceEvents"]
    assert check_metrics_snapshot(json.loads(mt.read_text())) == []


def test_reconcile_falls_back_to_registry_without_trace():
    sched = make_schedule(TPlan(pp=2, tp=1, microbatches=4))
    reg = tobs.Registry()
    reg.histogram("round_seconds").observe(0.5, kind="train")
    rep = tobs.reconcile(sched, registry=reg, kind="train")
    assert rep.rounds == 1 and rep.measured_round_s == 0.5
    assert rep.predicted_round_s is None and rep.round_ratio is None
    assert "n/a" in str(rep)


# --------------------------------------------------------------------------
# replanning from the registry
# --------------------------------------------------------------------------

def _mk_spec(lib, n_layers=8, heads=4, d_model=256, d_ff=1024, vocab=1024):
    blocks = tuple(lib.BlockSpec(mixer="attn", ffn="dense")
                   for _ in range(n_layers))
    return lib.ModelSpec(name="t", d_model=d_model, n_layers=n_layers,
                         n_heads=heads, n_kv=heads,
                         d_head=max(d_model // heads, 8), d_ff=d_ff,
                         vocab=vocab, blocks=blocks, norm="rmsnorm",
                         act="silu")


def _time_stages(reg, stage_s, rounds=3):
    """Per-stage seconds collected through the registry's own timer."""
    clock = FakeClock()
    for _ in range(rounds):
        for s, sec in enumerate(stage_s):
            with reg.timer("stage_round_seconds", clock=clock, stage=s):
                clock.advance(sec)


@pytest.mark.parametrize("seconds,flips", [([0.1, 0.1, 0.1, 0.2], True),
                                           ([0.1, 0.1, 0.1, 0.1], False)])
def test_replan_from_registry_flips_on_measured_straggler(seconds, flips):
    """A 2x straggler measured into the registry flips the plan; balanced
    stages leave it alone; the result is JAX's replan_from_registry's for
    the same seconds on the same hardware numbers (an H100 with JAX's
    test's link and memory)."""
    hw = dataclasses.replace(tprof.H100_SXM, link_bw=1e11, hbm_bytes=1e18)
    jhw = jprof.Hardware(**{f.name: getattr(hw, f.name)
                            for f in dataclasses.fields(jprof.Hardware)})
    kw = dict(pp=4, tp=1, microbatches=8, stash_mode="stash")
    mb = dict(minibatch_tokens=4096, data_replicas=1)
    treg, jreg = tobs.Registry(), jobs.Registry()
    _time_stages(treg, seconds)
    _time_stages(jreg, seconds)
    p, changed = replan_from_registry(_mk_spec(tspec_lib), TPlan(**kw), treg,
                                      hw, **mb)
    jp, jchanged = j_replan(_mk_spec(jspec_lib), JPlan(**kw), jreg, jhw,
                            **mb)
    assert changed == jchanged == flips
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    # on the H100's numbers the straggler's layers move by a re-cut into
    # pp x v chunks (JAX's TPU numbers pick pp 2 x tp 2)
    assert ((p.pp, p.tp, p.virtual_stages) != (4, 1, 1)) == flips


# --------------------------------------------------------------------------
# the driver, the engine and the launchers
# --------------------------------------------------------------------------

def test_train_driver_reports_rounds_and_stage_seconds(tmp_path):
    """One process: the driver inherits the bundle's obs, reports each
    round, and ``stage_seconds_fn`` feeds the stage histograms."""
    cfg = configs.get("qwen3-14b")
    spec = cfg.smoke_spec()
    plan = cfg.SMOKE_PLAN.with_(pp=2, microbatches=2)
    obs = tobs.Observability(trace=True)
    bundle = build_pipeline(spec, plan, seq_len=8, global_batch=4,
                            optimizer=SGDM(lr=0.01),
                            compute_dtype=torch.float32, device="cpu",
                            obs=obs)
    loader = Loader(SyntheticLM(spec.vocab, 8), 2, 2, "cpu")
    driver = TrainDriver(bundle, loader, str(tmp_path), DriverConfig(),
                         stage_seconds_fn=lambda step: [0.01, 0.02])
    assert driver.obs is obs
    driver.run(bundle.init_state(torch.Generator().manual_seed(0)), 3)
    reg = obs.registry
    assert reg.counter("rounds_total").value(kind="train") == 3
    assert reg.histogram("round_seconds").stats(kind="train")["count"] == 3
    assert reg.histogram("stage_round_seconds").stats(stage=1)["count"] == 3
    assert tobs.stage_seconds(reg, 2) == [pytest.approx(0.01),
                                          pytest.approx(0.02)]
    recs = [r for r in obs.trace.rounds if r.kind == "train"]
    assert len(recs) == 3 and all(r.n_spans > 0 for r in recs)


def test_engine_reports_prefill_decode_and_pages():
    cfg = configs.get("qwen3-14b")
    plan = cfg.SMOKE_PLAN.with_(tp=1)
    obs = tobs.Observability(trace=True)
    session = build_serving(cfg.smoke_spec(), plan, cache_len=32,
                            global_batch=4, compute_dtype=torch.float32,
                            page_size=8, prefill_len=6, device="cpu",
                            obs=obs)
    session.start(0)
    tokens = np.arange(session.n_slots * session.rows * 6).reshape(
        session.n_slots, session.rows, 6) % 50
    nxt = session.prefill({"tokens": tokens})
    for _ in range(2):
        nxt = session.decode(nxt)
    c = obs.registry.counter("rounds_total")
    assert c.value(kind="prefill") == 1 and c.value(kind="decode") == 2
    assert obs.registry.gauge("pages_in_use").value() == \
        session._alloc.live_pages
    assert obs.registry.gauge("pages_free").value() == \
        session._alloc.free_pages
    counts = obs.trace.span_counts()
    cells = (session.sched.tables().fwd[:, :, F_MB] >= 0).sum(0)
    assert [counts[s] for s in range(session.sched.n_stages)] == \
        (3 * cells).tolist()


def _check_files(tmp_path, kinds):
    snap = json.loads((tmp_path / "metrics.json").read_text())
    assert check_metrics_snapshot(snap, "metrics.json") == []
    trace = tobs.TraceRecorder()
    trace.events = json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"]
    check_trace_schema(trace)
    got = {r["labels"]["kind"] for r in snap["histograms"]
           if r["name"] == "round_seconds"}
    assert got == set(kinds)
    return snap


def test_train_cli_writes_trace_and_metrics(tmp_path, capsys):
    train.main(["--arch", "qwen3-14b", "--smoke", "--steps", "2",
                "--device", "cpu", "--trace-out",
                str(tmp_path / "trace.json"), "--metrics-out",
                str(tmp_path / "metrics.json")])
    out = capsys.readouterr().out
    assert "reconcile[train]" in out and "(2 rounds)" in out
    snap = _check_files(tmp_path, {"train"})
    assert "launch_phase_seconds" in {r["name"] for r in snap["histograms"]}
    with pytest.raises(SystemExit, match="several ranks"):
        train.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                    "--replan"])


def test_serve_cli_writes_trace_and_metrics(tmp_path, capsys):
    serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                "--page-size", "8", "--batch", "4", "--prefill", "6",
                "--tokens", "3", "--cache-len", "32", "--trace-out",
                str(tmp_path / "trace.json"), "--metrics-out",
                str(tmp_path / "metrics.json")])
    out = capsys.readouterr().out
    assert "reconcile[decode]" in out and "(3 rounds)" in out
    snap = _check_files(tmp_path, {"prefill", "decode"})
    assert "pages_in_use" in {r["name"] for r in snap["gauges"]}
