"""The port's specs, plans, configs and schedule tables pinned to the JAX
package, and the port's import hygiene (no JAX, nothing of ``repro``)."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import schedule as jsched
from repro.models import spec as jspec
from repro.parallel import mesh as jmesh
from repro_torch import configs as tconfigs
from repro_torch.core import schedule as tsched
from repro_torch.models import spec as tspec
from repro_torch.parallel import plan as tplan

ROOT = Path(__file__).resolve().parents[1]


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ModelSpec", "BlockSpec", "MoESpec",
                                  "MambaSpec", "RWKVSpec", "EncoderSpec"])
def test_spec_dataclasses_pinned_field_for_field(name):
    assert _fields(getattr(tspec, name)) == _fields(getattr(jspec, name))


def test_parallelism_plan_pinned_field_for_field():
    assert _fields(tplan.ParallelismPlan) == _fields(jmesh.ParallelismPlan)
    p = tplan.ParallelismPlan(pp=2, tp=1)
    assert p.with_(pp=4) == tplan.ParallelismPlan(pp=4, tp=1)
    for bad in (dict(stash_mode="nope"), dict(grad_sync="nope"),
                dict(pp=0), dict(virtual_stages=0),
                dict(virtual_stages=2, schedule="serve_1f")):
        with pytest.raises(AssertionError):
            tplan.ParallelismPlan(**{"pp": 2, "tp": 1, **bad})


def test_qwen3_config_matches_jax():
    j, t = jconfigs.get("qwen3-14b"), tconfigs.get("qwen3-14b")
    for fn in ("full_spec", "smoke_spec"):
        assert dataclasses.asdict(getattr(t, fn)()) == \
            dataclasses.asdict(getattr(j, fn)())
    for plan in ("PLAN", "SMOKE_PLAN"):
        assert dataclasses.asdict(getattr(t, plan)) == \
            dataclasses.asdict(getattr(j, plan))
    assert tconfigs.get("qwen3_14b") is t
    with pytest.raises(KeyError):
        tconfigs.get("gemma3-27b")


def test_rwkv6_config_matches_jax():
    j, t = jconfigs.get("rwkv6-1.6b"), tconfigs.get("rwkv6-1.6b")
    for fn in ("full_spec", "smoke_spec"):
        assert dataclasses.asdict(getattr(t, fn)()) == \
            dataclasses.asdict(getattr(j, fn)())
    for plan in ("PLAN", "SMOKE_PLAN"):
        assert dataclasses.asdict(getattr(t, plan)) == \
            dataclasses.asdict(getattr(j, plan))
    for alias in ("rwkv6_1b6", "rwkv6-1b6"):
        assert tconfigs.get(alias) is t
    full = t.full_spec()
    assert full.d_model // full.rwkv.head_dim == full.n_heads == 32
    # the chip_smoke.py plan: serve_1f over all 24 layers in 8 stages
    sched = tsched.make_serving_schedule(
        t.PLAN.with_(tp=1, decode_microbatches=4), 4)
    sched.validate()
    assert (sched.n_stages, sched.n_microbatches, sched.n_ticks) == (8, 4, 11)
    assert full.layers_per_stage(8) == 3


def test_jamba_config_matches_jax():
    j, t = (m.get("jamba-v0.1-52b") for m in (jconfigs, tconfigs))
    for fn in ("full_spec", "smoke_spec"):
        assert dataclasses.asdict(getattr(t, fn)()) == \
            dataclasses.asdict(getattr(j, fn)())
    for plan in ("PLAN", "SMOKE_PLAN"):
        assert dataclasses.asdict(getattr(t, plan)) == \
            dataclasses.asdict(getattr(j, plan))
    for alias in ("jamba_v01_52b", "jamba-v01-52b"):
        assert tconfigs.get(alias) is t
    full = t.full_spec()
    # the chip_smoke.py cut: the first two periods of 8, one per stage
    cut = dataclasses.replace(full, n_layers=16, blocks=full.blocks[:16])
    prog = cut.stage_program(2)
    assert [(b.mixer, b.ffn) for b in prog] == [
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
        ("mamba", "moe"), ("attn", "dense"), ("mamba", "moe"),
        ("mamba", "dense"), ("mamba", "moe")]
    assert [(b.mixer, b.ffn) for b in full.blocks[3:5]] == [
        ("mamba", "moe"), ("attn", "dense")]


def test_stage_decomposition_matches_jax():
    jspec_, tspec_ = (m.get("qwen3-14b").full_spec() for m in (jconfigs,
                                                                tconfigs))
    for pp in (1, 2, 4, 5):
        assert tspec_.layers_per_stage(pp) == jspec_.layers_per_stage(pp)
        assert [dataclasses.asdict(b) for b in tspec_.stage_program(pp)] == \
            [dataclasses.asdict(b) for b in jspec_.stage_program(pp)]
        assert tspec.stage_varying_scalars(tspec_, pp) == \
            jspec.stage_varying_scalars(jspec_, pp)


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("R", [1, 2, 3, 5, 8])
def test_serve_1f_tables_equal_jax(S, R):
    t = tsched.ScheduleServe1F(S, R)
    j = jsched.ScheduleServe1F(S, R)
    t.validate()
    assert t.n_ticks == j.n_ticks and t.n_chunks == j.n_chunks
    tt, jt = t.tables(), j.tables()
    for a in ("fwd", "bwd", "exit_mb", "demb_mb"):
        np.testing.assert_array_equal(getattr(tt, a), getattr(jt, a))


def test_serving_schedule_resolution_and_fitting():
    plan = tplan.ParallelismPlan(pp=2, tp=1, decode_microbatches=4)
    s = tsched.make_serving_schedule(plan, 3)
    assert (s.name, s.n_stages, s.n_microbatches) == ("serve_1f", 2, 3)
    spec_plan = plan.with_(schedule="serve_spec_1f")
    s = tsched.make_serving_schedule(spec_plan, spec_k=3)
    j = jsched.make_serving_schedule(spec_plan, spec_k=3)
    assert (s.name, s.n_microbatches, s.spec_k) == (j.name, 4, 3)
    with pytest.raises(ValueError, match="not speculative"):
        tsched.make_serving_schedule(plan, spec_k=3)
    with pytest.raises(KeyError):
        tsched.make_serving_schedule(plan.with_(schedule="serve_2f"))
    for dm in (1, 3, 8):
        for gb in (1, 4, 6, 12):
            assert tsched.fit_serving_microbatches(dm, gb, 1) == \
                jsched.fit_serving_microbatches(dm, gb, 1)
    with pytest.raises(ValueError):
        tsched.fit_serving_microbatches(4, 5, 2)


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_nothing_of_repro():
    files = _port_files()
    assert len(files) > 15
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro", "flax"):
                    bad.append(f"{path.relative_to(ROOT)}: {n}")
    assert not bad, bad
