"""Pipelined serving on a rank grid in the port: each stage and tensor
shard of the serving engine on its own spawned gloo rank
(``build_serving(grid=)``), held to the one-process engine.

Three worlds, each spawned once for the module (tests/_torch_dist_worker.py
``job_serve``: one session a case, the same scenario code on every rank
and in one process):

* pp 2 on two ranks: qwen3 paged, dense at ``serve_interleaved`` v 2,
  speculative (``serve_spec_1f``) with int8 KV, the batcher under
  arrivals with buckets and speculative rounds, int8 weights; jamba
  (Mamba + MoE), rwkv6, whisper (an encoder) and llava (a patch
  prefix).  Tokens and hidden states equal one process bit for bit
  (fp32).
* pp 2 x tp 2 on four ranks: the same cases at tp 2 (tokens equal, hidden
  states within 2e-5; 1e-3 with int8 KV pages, where fp32 rounding can
  move a key across an int8 code), a converted BF16 checkpoint read rank
  by rank,
  the sharded greedy head's ties, and the qwen3 weights of JAX's engine
  run on a (1, 2, 2) mesh of emulated host devices
  (tests/_torch_serve_grid_jax.py): tokens equal to JAX's, hidden states
  within tests/test_kernels.py's fp32 2e-5.
* data 2 x pp 2 on four ranks: each replica equals one process serving
  its rows bit for bit; the batcher's tokens equal one process's over
  the whole batch.

On every rank the allocator's digest after each round equals one
process's, and a rank holds only its rows: its bytes against the whole
tree's over pp·tp, plus the embedding or the head, and against the
serving planner's price for a rank.  The launcher under torchrun's
environment on two ranks (a request trace with speculative rounds, a
converted checkpoint) equals one process; a quantized leaf cut over
tensor ranks is the cut of the whole leaf's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from _torch_train_jax import one_torch_thread  # noqa: F401
from repro_torch import configs

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
R, ROWS, PREFILL, CACHE, PAGE, DECODES = 4, 2, 8, 64, 16, 4
HIDDEN_TP_ATOL = 2e-5          # tp 2 against tp 1, and against JAX (fp32)
# tp 2 against tp 1 with int8 KV pages: the K / V the two write differ
# by fp32 rounding (1e-7), which can move a value across an int8 code
# boundary, a step of 1/127 of its page's absmax; the hidden states then
# differ by up to 4.3e-4 (the tokens still agree)
HIDDEN_TP_INT8_KV_ATOL = 1e-3
JAX_TIMEOUT_S = 240

BASE = dict(batch=R * ROWS, prefill_len=PREFILL, cache_len=CACHE,
            decodes=DECODES, scenario="oneshot")


def _case(arch, **kw):
    plan = dict(kw.pop("plan", {}), decode_microbatches=R)
    return dict(BASE, arch=arch, plan=plan, **kw)


def _cases(npz):
    """The cases of the pp 2 and pp 2 x tp 2 worlds (pp and tp set by the
    world); ``npz``: qwen3's rescaled weights (JAX's engine's)."""
    spec_plan = dict(schedule="serve_spec_1f")
    llava = configs.get("llava-next-34b").smoke_spec()
    return {
        "qwen3_paged": _case("qwen3-14b", page_size=PAGE),
        "qwen3_dense_v2": _case("qwen3-14b", plan=dict(
            schedule="serve_interleaved", virtual_stages=2)),
        "qwen3_spec_int8kv": _case("qwen3-14b", plan=spec_plan, spec_k=2,
                                   page_size=PAGE, kv_dtype="int8",
                                   scenario="spec", npz=npz),
        "qwen3_arrivals": _case("qwen3-14b", plan=spec_plan, spec_k=2,
                                page_size=PAGE, buckets=True, npz=npz,
                                scenario="arrivals", arrivals="0,0,1,3,4",
                                prompt_len=6),
        "qwen3_int8w": _case("qwen3-14b", page_size=PAGE, npz=npz,
                             weight_dtype="int8"),
        "jamba": _case("jamba-v0.1-52b", page_size=PAGE),
        "rwkv6": _case("rwkv6-1.6b"),
        "whisper": _case("whisper-medium", page_size=PAGE),
        "llava": _case("llava-next-34b", page_size=PAGE,
                       prefill_len=llava.n_patches + PREFILL),
    }


def _at(case, **plan):
    return dict(case, plan=dict(case["plan"], **plan))


def _jax_run(tmp):
    """JAX's engine on a (1, 2, 2) host mesh (a subprocess); its output
    files' prefix."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    prefix = str(tmp / "jax")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_serve_grid_jax.py"),
         prefix, "1", "2", "2", str(R), str(ROWS), str(PREFILL), str(CACHE),
         str(PAGE), str(DECODES)],
        capture_output=True, text=True, env=env, timeout=JAX_TIMEOUT_S)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nERR:\n{out.stderr}"
    return prefix


def _bf16_checkpoint(tmp):
    """tests/test_torch_convert.py's BF16 fixture (olmoe's smoke spec,
    two shards and an index) converted for pp 2."""
    from repro_torch.checkpoint import convert as tcv
    spec = configs.get("olmoe-1b-7b").smoke_spec()
    tensors = tcv.synthetic_tensors(spec, seed=4)
    tcv.write_checkpoint(str(tmp / "bf16"), tensors, shards=2, dtype="BF16")
    tcv.convert(str(tmp / "bf16"), str(tmp / "ck"), spec, pp=2)
    return str(tmp / "ck")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's ranks, and the one-process runs they are held to."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("serve_grid")
    jax_prefix = _jax_run(tmp)
    npz = f"{jax_prefix}_params.npz"
    ckpt = _bf16_checkpoint(tmp)
    cases = _cases(npz)
    pp2 = {k: _at(c, pp=2, tp=1) for k, c in cases.items()}
    tp2 = {k: _at(c, pp=2, tp=2) for k, c in cases.items()}
    tp2["jax"] = _at(_case("qwen3-14b", page_size=PAGE, npz=npz,
                           plan=dict(schedule="serve_1f")), pp=2, tp=2)
    tp2["ckpt"] = _at(_case("olmoe-1b-7b", page_size=PAGE, ckpt=ckpt,
                            decodes=3, batch=4), pp=2, tp=2)
    dp2 = {"qwen3_paged": pp2["qwen3_paged"],
           "qwen3_arrivals": pp2["qwen3_arrivals"]}
    out = {"cases": cases, "pp2": pp2, "tp2": tp2, "dp2": dp2,
           "jax": dict(np.load(f"{jax_prefix}_out.npz"))}
    vocab = configs.get("qwen3-14b").smoke_spec().vocab
    for name, (data, tp, world_cases, extra) in {
            "pp2": (1, 1, pp2, {}),
            "tp2": (1, 2, tp2, {"greedy_ties": {
                "n_vocab": 256, "vocab": vocab - 8, "seed": 3}}),
            "dp2": (2, 1, dp2, {})}.items():
        sub = tmp / name
        sub.mkdir()
        ranks = W.run_ranks(sub, data, 2, {"serve": {"cases": world_cases},
                                           **extra}, tp=tp)
        out[name + "_ranks"] = ranks
    # one process: every pp 2 case (the tp 2 cases' yardstick too), each
    # data replica's rows alone, and serve --ckpt
    out["one"] = {k: W.serve_case(W.serve_session(c), c)
                  for k, c in pp2.items()}
    out["one"]["jax"] = W.serve_case(
        W.serve_session(_at(tp2["jax"], tp=1)), _at(tp2["jax"], tp=1))
    out["replica"] = []
    for d in range(2):
        c = dict(pp2["qwen3_paged"], batch=R * ROWS // 2, replica=(d, 2))
        out["replica"].append(W.serve_case(W.serve_session(c), c))
    from repro_torch.launch import serve
    ck = tp2["ckpt"]
    out["ckpt_one"] = serve.main([
        "--arch", ck["arch"], "--smoke", "--device", "cpu", "--page-size",
        str(PAGE), "--batch", str(ck["batch"]), "--prefill", str(PREFILL),
        "--tokens", str(ck["decodes"]), "--cache-len", str(CACHE),
        "--ckpt", ckpt])
    return out


PP2_KEYS = list(_cases("").keys())


def _ranks(worlds, name, key):
    return [r["serve"][key] for r in worlds[name + "_ranks"]]


def _last_stage(world_ranks, pp, tp, data=1):
    """(rank, replica) of every last-stage rank of a (data, pp, tp) grid."""
    return [(r, r // (pp * tp)) for r in range(len(world_ranks))
            if (r // tp) % pp == pp - 1]


def _replica_rows(h, d, data):
    """Replica d's block of every slot's rows of a one-process hidden
    state (R · rows, ...)."""
    x = h.reshape((R, -1) + h.shape[1:])
    n = x.shape[1] // data
    return x[:, d * n:(d + 1) * n].reshape((-1,) + h.shape[1:])


# --------------------------------------------------------------------------
# pp 2: bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("key", PP2_KEYS)
def test_pp2_ranks_equal_one_process_bit_for_bit(worlds, key):
    one = worlds["one"][key]
    ranks = _ranks(worlds, "pp2", key)
    for got in ranks:
        if "requests" in one:
            assert got["requests"] == one["requests"]
            continue
        assert len(got["tokens"]) == len(one["tokens"]) == DECODES + 1
        for a, b in zip(got["tokens"], one["tokens"]):
            np.testing.assert_array_equal(a, b)
    for rank, _ in _last_stage(ranks, 2, 1):
        for a, b in zip(ranks[rank]["hidden"], one["hidden"]):
            if b is not None:
                assert np.array_equal(a, b), key


@pytest.mark.parametrize("world", ["pp2", "tp2", "dp2"])
def test_allocator_digests_are_equal_on_every_rank(worlds, world):
    for key in worlds[world]:
        ranks = _ranks(worlds, world, key)
        digests = [r["digests"] for r in ranks]
        assert digests[0] and all(d == digests[0] for d in digests), key
        if world == "pp2" or (world == "tp2" and key in worlds["one"]):
            assert digests[0] == worlds["one"][key]["digests"], key


def test_the_batcher_ran_speculative_rounds_on_the_grid(worlds):
    for world in ("pp2", "tp2", "dp2"):
        for got in _ranks(worlds, world, "qwen3_arrivals"):
            assert got["spec_rounds"] > 0 and len(got["requests"]) == 5
            assert all(len(t) == DECODES for t in got["requests"].values())


# --------------------------------------------------------------------------
# pp 2 x tp 2
# --------------------------------------------------------------------------

@pytest.mark.parametrize("key", PP2_KEYS)
def test_tp2_tokens_equal_and_hidden_states_agree(worlds, key):
    one = worlds["one"][key]
    ranks = _ranks(worlds, "tp2", key)
    for got in ranks:
        if "requests" in one:
            assert got["requests"] == one["requests"]
            continue
        for a, b in zip(got["tokens"], one["tokens"]):
            np.testing.assert_array_equal(a, b)
    last = _last_stage(ranks, 2, 2)
    assert len(last) == 2
    atol = (HIDDEN_TP_INT8_KV_ATOL
            if worlds["tp2"][key].get("kv_dtype") == "int8"
            else HIDDEN_TP_ATOL)
    for rank, _ in last:
        for a, b in zip(ranks[rank]["hidden"], one["hidden"]):
            if b is not None:
                np.testing.assert_allclose(a, b, atol=atol, rtol=0)
    # the two tensor ranks of the last stage read the same head output
    for a, b in zip(*(ranks[r]["hidden"] for r, _ in last)):
        if a is not None:
            assert np.array_equal(a, b)


def test_tp2_equals_jax_engine_on_a_host_mesh(worlds):
    """The port's pp 2 x tp 2 ranks and JAX's engine on a (1, 2, 2) mesh
    of emulated host devices, from JAX's weights: the same tokens, the
    last hidden states within fp32 2e-5 (tests/test_kernels.py)."""
    jax_out = worlds["jax"]
    ranks = _ranks(worlds, "tp2", "jax")
    for got in ranks:
        np.testing.assert_array_equal(np.stack(got["tokens"]),
                                      jax_out["tokens"])
    for rank, _ in _last_stage(ranks, 2, 2):
        got = np.stack(ranks[rank]["hidden"][1:])
        np.testing.assert_allclose(got, jax_out["hidden"], atol=2e-5,
                                   rtol=0)
    # and the one-process port engine on the same weights agrees too
    np.testing.assert_array_equal(np.stack(worlds["one"]["jax"]["tokens"]),
                                  jax_out["tokens"])


def test_sharded_greedy_equals_argmax_with_ties_across_the_boundary(worlds):
    for res in (r["greedy_ties"] for r in worlds["tp2_ranks"]):
        for kind, head in zip(("tie across", "rank 1 wins"), res):
            want = head["want"]
            np.testing.assert_array_equal(head["got"], want)
            np.testing.assert_array_equal(head["last"], want[:, -1])
            logits = head["logits"]
            top = logits.max(dim=-1, keepdim=True).values
            n_max = (logits == top).sum(dim=-1)
            assert (n_max > 1).all(), kind       # every row ties
            in_high = (want >= logits.shape[-1] // 2)
            if kind == "tie across":
                assert not in_high.any()
            else:
                assert in_high.all()


def test_each_rank_reads_only_its_chunk_files_and_serves_the_ckpt(worlds):
    """``serve --ckpt`` on a pp 2 x tp 2 grid (``load_checkpoint`` on
    ``build_serving(grid=)``): each rank opens only its stage's chunk file
    and, where it holds a table, ``shared.npz``; every rank's tokens equal
    the one-process ``serve --ckpt`` tokens."""
    ranks = _ranks(worlds, "tp2", "ckpt")
    for rank, got in enumerate(ranks):
        s = (rank // 2) % 2
        assert sorted(got["opened"]) == sorted(
            [f"chunk_{s:04d}.npz", "shared.npz"]), (rank, got["opened"])
        np.testing.assert_array_equal(np.stack(got["tokens"]),
                                      worlds["ckpt_one"])


# --------------------------------------------------------------------------
# data 2 x pp 2
# --------------------------------------------------------------------------

def test_dp2_replicas_equal_one_process_on_their_rows(worlds):
    ranks = _ranks(worlds, "dp2", "qwen3_paged")
    whole = worlds["one"]["qwen3_paged"]
    for got in ranks:
        for a, b in zip(got["tokens"], whole["tokens"]):
            np.testing.assert_array_equal(a, b)
    for rank, d in _last_stage(ranks, 2, 1, data=2):
        alone = worlds["replica"][d]
        for a, b, w in zip(ranks[rank]["hidden"], alone["hidden"],
                           whole["hidden"]):
            assert np.array_equal(a, b)
            np.testing.assert_allclose(a, _replica_rows(w, d, 2), atol=1e-6,
                                       rtol=0)


def test_dp2_batcher_tokens_equal_one_process(worlds):
    one = worlds["one"]["qwen3_arrivals"]["requests"]
    for got in _ranks(worlds, "dp2", "qwen3_arrivals"):
        assert got["requests"] == one


# --------------------------------------------------------------------------
# what a rank holds
# --------------------------------------------------------------------------

@pytest.mark.parametrize("world,data,tp", [("pp2", 1, 1), ("tp2", 1, 2),
                                           ("dp2", 2, 1)])
def test_a_rank_holds_only_its_rows(worlds, world, data, tp):
    """Stage leaves: at most the whole tree's over pp·tp plus what a
    rank keeps whole (norms, routers: the excess is bounded by the
    leaves tp does not cut), and the stage's tensor ranks together hold
    each cut leaf once; the embedding on stage 0 and the head on the
    last stage, each 1/tp of the whole; the KV pages 1/(pp·tp·data) of
    the one-process pool."""
    pp = 2
    one = worlds["one"]["qwen3_paged"]["bytes"]
    ranks = _ranks(worlds, world, "qwen3_paged")
    per_stage = {}
    for rank, got in enumerate(ranks):
        b = got["bytes"]
        s = (rank // tp) % pp
        assert b["stages"] * pp * tp >= one["stages"]
        assert b["stages"] <= one["stages"] / pp
        per_stage.setdefault((rank // (pp * tp), s), []).append(b["stages"])
        assert b["embed"] == (one["embed"] // tp if s == 0 else 0)
        assert b["head"] == (one["head"] // tp if s == pp - 1 else 0)
        assert b["pages"] * pp * tp * data == one["pages"]
    for held in per_stage.values():
        # a cut leaf once over the stage's tensor ranks, a whole one on
        # each: between the stage's share and tp times it
        assert one["stages"] / pp <= sum(held) <= one["stages"] / pp * tp
    if tp > 1:
        spec = configs.get("qwen3-14b").smoke_spec()
        # a layer's two norm scales and its q / k norm scales, f32
        norms = (2 * spec.d_model + 2 * spec.d_head) * 4
        lps = spec.n_layers // pp
        for held in per_stage.values():
            assert sum(held) == one["stages"] / pp + (tp - 1) * lps * norms


def test_a_rank_holds_what_the_serving_planner_prices(worlds):
    """Each rank's weights and pages against the serving memory model's
    price for a rank of its plan (``plan_search(workload="decode")``'s
    call, at fp32 storage), within 1%."""
    from repro_torch.core.profiler import H100_SXM
    from repro_torch.core.schedule import make_serving_schedule
    spec = configs.get("qwen3-14b").smoke_spec()
    for world, tp in (("pp2", 1), ("tp2", 2)):
        plan = W.serve_plan(worlds[world]["qwen3_paged"])
        sched = make_serving_schedule(plan, R)
        mm = sched.memory_model(
            spec, plan, H100_SXM, microbatch_tokens=ROWS, cache_len=CACHE,
            global_batch=R * ROWS, prefill=False, page_size=PAGE,
            kv_occupancy=1.0, weight_dtype="fp32", kv_dtype="fp32")
        for got in _ranks(worlds, world, "qwen3_paged"):
            b = got["bytes"]
            weights = b["stages"] + b["embed"] + b["head"]
            assert abs(weights / mm.weight_bytes - 1) < 0.01, (world, b)
            assert abs(b["pages"] / mm.cache_bytes - 1) < 0.01, (world, b)


# --------------------------------------------------------------------------
# the launcher on a grid
# --------------------------------------------------------------------------

def test_serve_launcher_on_two_ranks_equals_one_process(tmp_path):
    """``python -m repro_torch.launch.serve`` under torchrun's environment
    on two ranks (the smoke plan's pp 2, one stage a rank): the request
    trace with speculative rounds gives one process's tokens, request
    for request; a converted checkpoint, each rank reading its own chunk
    file, one process's one-shot tokens."""
    from repro_torch.launch import serve
    ckpt = _bf16_checkpoint(tmp_path)
    base = ["--smoke", "--device", "cpu", "--batch", "4", "--page-size",
            str(PAGE), "--cache-len", str(CACHE)]
    argvs = [["--arch", "qwen3-14b", *base, "--arrivals", "0,0,2,4",
              "--spec-k", "2", "--prefill", "8", "--tokens", "5"],
             ["--arch", "olmoe-1b-7b", *base, "--prefill", "8", "--tokens",
              "3", "--ckpt", ckpt]]
    got = W.run_launcher(tmp_path, 2, argvs)
    for argv, two in zip(argvs, got):
        one = serve.main(list(argv))
        if isinstance(one, dict):
            assert two == one and len(one) == 4
        else:
            np.testing.assert_array_equal(two, one)


# --------------------------------------------------------------------------
# quantized leaves cut over tensor ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("wd", ["int8", "fp8"])
def test_a_cut_quantized_leaf_is_the_cut_of_the_whole_leafs(wd):
    """JAX quantizes the whole tree and then shards it: a leaf cut along
    its input (``wo``: rows of the contraction axis) keeps the whole
    weight's per-output-channel scales, a leaf cut along its output
    (``wq``) the scales of its columns.  The port's cut of a quantized
    leaf dequantizes to the cut of the whole leaf's dequantization;
    quantizing the slice alone would not (its absmax is another)."""
    from repro_torch import quant
    from repro_torch.models.init import _copy_cut, tp_dim
    spec = configs.get("qwen3-14b").smoke_spec()
    g = torch.Generator().manual_seed(5)
    d, h, dh = spec.d_model, spec.n_heads, spec.d_head
    leaves = {"wo": torch.randn((2, h * dh, d), generator=g),
              "wq": torch.randn((2, d, h, dh), generator=g)}
    for name, w in leaves.items():
        # one row of the input far larger: a slice without it has
        # another absmax
        w[:, 0] *= 50.0
        ax = tp_dim("attn", name, spec, 2)
        whole = quant.quantize(w, wd, 1)
        full = quant.dequantize(whole)
        for t in range(2):
            cut = _copy_cut(whole, ax, t, 2)
            n = w.shape[ax] // 2
            want = full.narrow(ax, t * n, n)
            assert torch.equal(quant.dequantize(cut), want), (name, t)
            alone = quant.dequantize(quant.quantize(
                w.narrow(ax, t * n, n).contiguous(), wd, 1))
            # the slice of ``wo`` without the large row has its own scales
            if name == "wo" and t == 1:
                assert not torch.equal(alone, want)
