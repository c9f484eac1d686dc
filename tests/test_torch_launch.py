"""The port's launch tools (``repro_torch/launch/{cell,roofline,dryrun,
profile_cell,bsp_compare}.py``, ``serve --data``) and its shape registry,
against JAX's where JAX has the same function.

* ``configs.SHAPES``, ``cells()``, ``_fit_microbatches`` and
  ``model_flops_per_device`` equal JAX's.
* Each kind of smoke cell gives from ``Cell.run()`` what the direct call
  gives, bit for bit.
* The dry run counts a cell on ``meta`` and builds a rank's state there.
* ``serve --data 2`` on two gloo ranks gives the tokens of ``--data 1``.
* ``bsp_compare``'s bytes equal the analytic counts and the transport's
  counters as ``op_analysis`` reads them.
"""
import dataclasses
import multiprocessing
import os

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import cell as jcell
from repro.launch import roofline as jroof
from repro.core import schedule as jsched
from repro.parallel.mesh import ParallelismPlan as JPlan
from repro_torch import configs as tconfigs
from repro_torch.core import schedule as tsched
from repro_torch.core.pipeline import build_pipeline
from repro_torch.launch import roofline as troof
from repro_torch.launch.cell import _fit_microbatches, build_cell
from repro_torch.launch.op_analysis import count
from repro_torch.launch.train import make_loader
from repro_torch.models.init import generator
from repro_torch.optim.optimizers import by_name
from repro_torch.parallel.plan import ParallelismPlan as TPlan
from repro_torch.serving.engine import build_serving

SEQ = 12


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_shapes_and_cells_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert list(tconfigs.cells()) == list(jconfigs.cells())
    assert len(list(tconfigs.cells())) == 40
    assert not tconfigs.supports("qwen3-14b", "long_500k")[0]
    assert tconfigs.supports("rwkv6-1.6b", "long_500k") == (True, "")


def _fit(pkg_plan, fit, sched_mod, name, pp, r, batch, dp):
    kw = sched_mod.plan_kwargs_for_schedule(name, stash_mode="stash")
    plan = pkg_plan(pp=pp, tp=1, microbatches=r, **kw)
    try:
        return fit(plan, batch, dp).microbatches
    except AssertionError:
        return "refused"


def test_fit_microbatches_equals_jax():
    n = 0
    for name in ("1f1b", "gpipe", "interleaved", "interleaved_async"):
        for pp in (1, 2, 4):
            for r in (1, 3, 8):
                for batch in (1, 4, 6, 16, 256):
                    for dp in (1, 2, 16):
                        got = _fit(TPlan, _fit_microbatches, tsched, name,
                                   pp, r, batch, dp)
                        want = _fit(JPlan, jcell._fit_microbatches, jsched,
                                    name, pp, r, batch, dp)
                        assert got == want, (name, pp, r, batch, dp)
                        n += got != "refused"
    assert n > 300


def test_model_flops_per_device_equals_jax_on_every_cell():
    for arch, shape, _, _ in tconfigs.cells():
        for chips in (1, 256, 512):
            got = troof.model_flops_per_device(
                tconfigs.get(arch).full_spec(), tconfigs.SHAPES[shape], chips)
            want = jroof.model_flops_per_device(
                jconfigs.get(arch).full_spec(), jconfigs.SHAPES[shape], chips)
            assert got == want, (arch, shape, chips)


def test_roofline_terms_and_mfu():
    cost = count(lambda: torch.ones(64, 32) @ torch.ones(32, 16))
    r = troof.from_counts(cost, arch="a", shape="train_4k", cards="1",
                          plan="p", model_flops_per_device=2e12,
                          step_seconds_measured=0.5)
    peak = 989e12
    assert r.compute_s == cost.flops / peak
    assert r.memory_s == cost.hbm_bytes / 3.35e12
    assert r.dominant == "memory"
    assert r.mfu == 2e12 / (0.5 * peak)
    assert r.roofline_fraction == 2e12 / peak / r.step_seconds
    f32 = troof.from_counts(cost, arch="a", shape="s", cards="1", plan="p",
                            model_flops_per_device=1.0, dtype="float32")
    assert f32.compute_s == cost.flops / 67e12
    assert "mfu=" in troof.fmt_row(r) and "mfu=" not in troof.fmt_row(f32)


def _same(a, b):
    """Two outputs or states, bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _direct_train(seed=0):
    cfg = tconfigs.get("qwen3-14b")
    spec, plan = cfg.smoke_spec(), cfg.SMOKE_PLAN.with_(microbatches=4)
    bundle = build_pipeline(spec, plan, seq_len=SEQ, global_batch=4,
                            optimizer=by_name(*cfg.OPTIMIZER),
                            compute_dtype=torch.float32, device="cpu")
    state = bundle.init_state(torch.Generator().manual_seed(seed))
    batch = make_loader(spec, bundle, seed).get(0)
    return bundle.train_step(state, batch)


def _direct_serving(kind, seed=0, **kw):
    cfg = tconfigs.get("qwen3-14b")
    spec = cfg.smoke_spec()
    plan = cfg.SMOKE_PLAN
    if kw.get("spec_k"):
        plan = plan.with_(schedule="serve_spec_1f")
    cache = SEQ if kind in ("prefill", "admit") else 32
    s = build_serving(spec, plan, cache_len=cache, global_batch=kw.pop(
        "batch", 4), compute_dtype=torch.float32, device="cpu",
        prefill_len=SEQ if kind in ("prefill", "admit") else 0,
        buckets="bucket" in kw, **{k: v for k, v in kw.items()
                                   if k != "bucket"})
    s.start(seed)
    rng = np.random.default_rng(seed)
    if kind in ("prefill", "admit"):
        batch = {"tokens": rng.integers(0, spec.vocab, (
            s.n_slots, s.rows, SEQ)).astype(np.int32)}
        if kind == "prefill":
            return s.prefill(batch)
        mask = np.zeros(s.n_slots, np.int32)
        mask[:s.n_slots // 2] = 1
        return s.write_prefill_into_slots(batch, mask)
    toks = rng.integers(0, spec.vocab, (s.n_slots, s.rows, 16))
    nxt = s.prefill({"tokens": toks.astype(np.int32)})
    if kw.get("spec_k"):
        k = kw["spec_k"]
        drafts = np.random.default_rng(seed + 1).integers(
            0, spec.vocab, (nxt.shape[0], k))
        return s.verify(np.concatenate(
            [nxt.numpy().astype(np.int32)[:, None], drafts],
            1).astype(np.int32))
    if "bucket" in kw:
        mask = np.zeros(s.n_slots, np.int32)
        mask[kw["bucket"]:] = 1
        s.reset_slots(mask)
        return s.decode(nxt, bucket=kw["bucket"])
    return s.decode(nxt)


CELLS = {
    "train": (dict(shape="train_4k", seq_len=SEQ, global_batch=4,
                   plan=tconfigs.get("qwen3-14b").SMOKE_PLAN.with_(
                       microbatches=8)),
              _direct_train),
    "prefill": (dict(shape="prefill_32k", seq_len=SEQ, global_batch=4),
                lambda: _direct_serving("prefill")),
    "admit": (dict(shape="prefill_32k", seq_len=SEQ, global_batch=4,
                   serve_op="admit"),
              lambda: _direct_serving("admit")),
    "decode": (dict(shape="decode_32k", global_batch=4, cache_len=32,
                    page_size=8),
               lambda: _direct_serving("decode", page_size=8)),
    "bucket": (dict(shape="decode_32k", global_batch=8, cache_len=32,
                    bucket=2),
               lambda: _direct_serving("decode", batch=8, bucket=2)),
    "verify": (dict(shape="decode_32k", global_batch=4, cache_len=32,
                    page_size=8, spec_k=2),
               lambda: _direct_serving("verify", page_size=8, spec_k=2)),
}


@pytest.mark.parametrize("kind", list(CELLS))
def test_cell_runs_the_direct_call(kind, capsys):
    kw, direct = CELLS[kind]
    shape = kw.pop("shape") if "shape" in kw else None
    cell = build_cell("qwen3-14b", shape, device="cpu", smoke=True,
                      **dict(kw))
    kw["shape"] = shape
    assert cell.kind == {"bucket": "decode"}.get(kind, kind)
    _same(cell.run(), direct())
    printed = capsys.readouterr().out
    assert "cuts:" in printed and cell.cuts["global_batch"][1] == \
        cell.global_batch
    if kind == "train":
        # the smoke plan's R 8 fitted to 4 rows
        assert cell.plan.microbatches == 4 and cell.bundle.plan is cell.plan


def test_build_cell_cuts_only_what_it_may():
    with pytest.raises(ValueError, match="never cut"):
        build_cell("qwen3-14b", "train_4k", seq_len=64, device="cpu")
    with pytest.raises(ValueError, match="skipped"):
        build_cell("qwen3-14b", "long_500k", device="cpu")
    with pytest.raises(ValueError, match="training shapes"):
        build_cell("qwen3-14b", "train_4k", page_size=16, device="cpu")
    with pytest.raises(ValueError, match="decode variant"):
        build_cell("qwen3-14b", "prefill_32k", bucket=2, device="cpu")
    cell = build_cell("qwen3-14b", "decode_32k", layers=2, global_batch=8,
                      device="meta")
    assert cell.cuts == {"layers": (40, 2), "tp": (8, 1),
                         "global_batch": (128, 8)}
    assert cell.cache_len == 32768 and cell.spec.d_model == 5120
    assert cell.run().device.type == "meta"


def test_input_specs_are_meta_stand_ins():
    from repro_torch.launch.cell import input_specs
    state, batch = input_specs("qwen3-14b", "train_4k", layers=2,
                               global_batch=2)
    assert batch["tokens"].device.type == "meta"
    assert tuple(batch["tokens"].shape) == (2, 1, 4096)
    leaf = state["stash"]["current"]["layer_0"]["mlp"]["w1"]
    assert leaf.is_meta and leaf.shape[-2:] == (5120, 17408)


@pytest.fixture
def smoke_config(monkeypatch):
    """qwen3-14b's config with its smoke spec as the full spec and a
    tp 2 plan, so the dry run runs at smoke size."""
    cfg = tconfigs.get("qwen3-14b")
    monkeypatch.setattr(cfg, "full_spec", cfg.smoke_spec)
    monkeypatch.setattr(cfg, "PLAN", cfg.SMOKE_PLAN.with_(tp=2,
                                                          microbatches=4))
    return cfg


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_dry_run_counts_a_cell_on_meta(smoke_config, shape, tmp_path,
                                       capsys):
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("qwen3-14b", shape, cards=16, out_dir=tmp_path)
    out = capsys.readouterr().out
    assert "fits" in out and "C=" in out
    assert rec["data_replicas"] == 4 and rec["fits"]
    assert rec["cuts"]["tp"] == [2, 1]
    replica = rec["op_count_replica"]
    # a replica's work split over its pp x tp = 4 cards
    assert rec["flops"] == pytest.approx(replica["flops"] / 4)
    assert rec["model_flops"] == troof.model_flops_per_device(
        smoke_config.smoke_spec(), tconfigs.SHAPES[shape], 16)
    assert rec["state_bytes_per_rank"] > 0
    assert (tmp_path / f"qwen3-14b__{shape}__16.json").exists()
    if shape == "train_4k":
        assert replica["kernel_calls"]["flash_attention_bwd"] > 0
        assert rec["per_collective"]["tensor"] > 0
        assert rec["per_collective"]["data_sync"] > 0


def test_dry_run_rank_state_is_the_grid_rank_state():
    """The dry run's rank bytes on meta are a real rank's state's bytes:
    stage 0 and the last stage of a data 2 x pp 2 x tp 2 grid, built as
    ``core/pipeline.py`` builds a rank, then drawn on the CPU."""
    from types import SimpleNamespace
    from repro_torch.launch.dryrun import train_rank_bytes, tree_bytes
    from repro_torch.models.init import init_rank_params
    from repro_torch.parallel.dist import ProcessGrid
    cfg = tconfigs.get("qwen3-14b")
    spec = cfg.smoke_spec()
    plan = cfg.SMOKE_PLAN.with_(tp=2, microbatches=2, zero1=True)
    opt = by_name(*cfg.OPTIMIZER)
    got = train_rank_bytes(spec, plan, seq_len=SEQ, global_batch=8, dp=2,
                           optimizer=opt, dtype=torch.float32)
    topo = ProcessGrid(2, 2, 2)
    want = 0
    for s in (0, 1):
        rank = SimpleNamespace(topo=topo, rank=topo.rank_of(0, s, 0), d=0,
                               s=s, t=0, device=torch.device("cpu"),
                               data_group=None, tensor_group=None,
                               pipe_group=None, world_group=None)
        bundle = build_pipeline(spec, plan, seq_len=SEQ, global_batch=8,
                                optimizer=opt, compute_dtype=torch.float32,
                                grid=rank)
        want = max(want, tree_bytes(bundle.init_state(generator("cpu", 0))))
    assert got == want > 0
    assert tree_bytes(init_rank_params(
        spec, plan, generator("meta", 0), bundle.sched, 0,
        torch.float32)) > 0


def test_entry_points_ask_for_the_card():
    from repro_torch.launch import dryrun, profile_cell, serve
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "qwen3-14b", "--shape", "train_4k"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_cell.main(["--arch", "qwen3-14b", "--shape", "train_4k"])
    with pytest.raises(SystemExit, match="torchrun"):
        serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                    "--data", "2"])


def test_profile_cell_cli_on_the_cpu(capsys):
    from repro_torch.launch import profile_cell
    profile_cell.main(["--arch", "qwen3-14b", "--shape", "decode_32k",
                       "--smoke", "--global-batch", "4", "--cache-len",
                       "32", "--device", "cpu", "--top", "3"])
    out = capsys.readouterr().out
    assert "device profile: not measured" in out
    assert "top FLOP signatures" in out and "aten.mm" in out
    assert "mfu=" in out


def _serve_rank(rank, init_file, argv, out_path):
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2")
    torch.set_num_threads(1)
    from repro_torch.launch import serve
    toks = serve.main(argv + ["--data", "2", "--init-method",
                              f"file://{init_file}"])
    if rank == 0:
        np.save(out_path, toks)


SERVE = ["--arch", "qwen3-14b", "--smoke", "--device", "cpu", "--batch",
         "8", "--prefill", "8", "--tokens", "5", "--cache-len", "32"]


def test_serve_data_two_ranks_equals_one(tmp_path):
    from repro_torch.launch import serve
    one = serve.main(list(SERVE))
    ctx = multiprocessing.get_context("spawn")
    out = tmp_path / "toks.npy"
    procs = [ctx.Process(target=_serve_rank,
                         args=(r, str(tmp_path / "rdv"), SERVE, str(out)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(120)
        assert [p.exitcode for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    two = np.load(out)
    assert one.shape == two.shape == (6, 8)
    np.testing.assert_array_equal(two, one)


def test_bsp_compare_bytes_equal_the_analytic_counts(tmp_path, capsys):
    from repro_torch.launch import bsp_compare
    args = bsp_compare.parser().parse_args(
        ["--smoke", "--ranks", "2", "--out", str(tmp_path)])
    res = bsp_compare.report(args, bsp_compare.spawn(args))
    out = capsys.readouterr().out
    assert "measured comm reduction" in out
    for rank in res["by_rank"]:
        for way in ("bsp", "pipeline"):
            r = rank[way]
            moved = r["collective_bytes"] + r["handoff_bytes"]
            assert moved == r["analytic_bytes"] > 0
            assert r["op_count_bytes"]["data"] == r["collective_bytes"]
            assert r["op_count_bytes"]["handoff"] == r["handoff_bytes"]
        assert rank["pipeline"]["handoff_bytes"] > 0
        assert rank["bsp"]["handoff_bytes"] == 0
    assert 0 < res["reduction_pct"] < 100
    assert (tmp_path / "bsp_compare__qwen3-14b.json").exists()
