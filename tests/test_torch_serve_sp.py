"""Sequence-parallel decode in the port (``build_serving(sp=True)``,
long_500k's mode): every full-length KV cache sharded along the sequence
over the data ranks, R 1, the rows on every data rank, the softmax
combined over the data group (``models/nn.py::_sdpa_decode_seq_sharded``).

Three cases at data 2 x pp 2 on four gloo ranks (``_torch_dist_worker.
job_serve_sp``, one spawn for the module): gemma3's smoke spec (windowed
rings and a global layer a stage) and jamba's (attention, Mamba, MoE) on
``serve_1f``, and gemma3's smoke spec at 8 layers on ``serve_interleaved``
at v 2 (JAX's own SP case, tests/serve_check.py ``SP = 1``, interleaves;
neither smoke spec splits into 4 chunks of one block pattern).  fp32,
cache 16 (shards of 8, JAX's minimum), one row, 12 decodes from position
0 across the shard boundary at 8, on the weights of JAX's own SP session
on a (2, 2) mesh of emulated host devices (tests/_torch_serve_sp_jax.py,
one subprocess for the module):

* tokens equal JAX's, the hidden states the head read within
  tests/test_kernels.py's fp32 2e-5;
* each rank's shard of every full-length cache equals JAX's at the
  written positions (2e-5), rings and recurrent state whole;
* the ranks equal the port's one process (``sp=False``) within 1e-5,
  shard by shard;
* each rank holds ``max(ceil(L / dp), 8)`` positions a full-length cache
  and the serving planner's ``serving_cache_bytes(sp=True)``;
* the host digests agree on every rank, and each step makes two data-group
  sums a sharded layer.

The exclusions raise (paging and speculative decode with JAX's messages,
a prefill), and JAX's out-of-range write wrapping, which the port does
not copy, is pinned.
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
from repro_torch.core.schedule import serving_cache_bytes
from repro_torch.serving.engine import build_serving

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
CACHE, DECODES, DATA, PP = 16, 12, 2, 2
SHARD = max(-(-CACHE // DATA), 8)
CASES = {"gemma3": ("gemma3", 1), "jamba": ("jamba", 1),
         "gemma3x8_v2": ("gemma3x8", 2)}
JAX_ATOL = 2e-5               # against JAX, fp32 (tests/test_kernels.py)
ONE_ATOL = 1e-5               # against the port's one process, fp32
# recurrent state against JAX, as tests/test_torch_jamba_engine.py
STATE_ATOL, STATE_RTOL = 2e-4, 1e-3
JAX_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's SP sessions, the port's ranks and its one-process sessions."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("serve_sp")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    prefix = str(tmp / "jax")
    arg = ",".join(f"{n}:{v}" for n, v in CASES.values())
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_serve_sp_jax.py"),
         prefix, arg, str(DATA), str(PP), str(CACHE), str(DECODES)],
        capture_output=True, text=True, env=env, timeout=JAX_TIMEOUT_S)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nERR:\n{out.stderr}"
    cases = {key: dict(name=n, v=v, npz=f"{prefix}_{n}_params.npz",
                       cache_len=CACHE, decodes=DECODES)
             for key, (n, v) in CASES.items()}
    sub = tmp / "ranks"
    sub.mkdir()
    ranks = W.run_ranks(sub, DATA, PP, {"serve_sp": {"cases": cases}})
    return {
        "ranks": {k: [r["serve_sp"][k] for r in ranks] for k in cases},
        "one": {k: W.sp_run(W.sp_session(c, sp=False), DECODES)
                for k, c in cases.items()},
        "jax": {k: dict(np.load(f"{prefix}_{n}_out.npz"))
                for k, (n, _) in CASES.items()}}


def _coords(rank):
    """(replica, stage) of a rank of the data x pp grid."""
    return rank // PP, rank % PP


def _sharded(runs, key):
    """The cache leaves (paths) that SP shards: the full-length KV caches
    of the one-process session."""
    return {p for p, a in runs["one"][key]["cache"].items()
            if "/kv/" in f"/{p}/" and a.shape[3] == CACHE}


def _rank_view(full, d, s, v, sharded):
    """Rank (d, s)'s part of a one-process / JAX global cache leaf
    (n_chunks, R, rows, L, ...): its storage rows s·v + j, and along L
    its shard when the leaf is sharded."""
    part = full[s * v:(s + 1) * v]
    return part[:, :, :, d * SHARD:(d + 1) * SHARD] if sharded else part


KEYS = list(CASES)


@pytest.mark.parametrize("key", KEYS)
def test_sp_ranks_equal_jax_tokens_and_hidden_states(runs, key):
    want = runs["jax"][key]
    for rank, got in enumerate(runs["ranks"][key]):
        np.testing.assert_array_equal(np.stack(got["tokens"]),
                                      want["tokens"])
        if _coords(rank)[1] == PP - 1:
            np.testing.assert_allclose(np.stack(got["hidden"]),
                                       want["hidden"], atol=JAX_ATOL, rtol=0)
        else:
            assert all(h is None for h in got["hidden"])
    # the tokens move: the cases compare more than one repeated token
    assert len(set(want["tokens"].ravel().tolist())) >= 3


@pytest.mark.parametrize("key", KEYS)
def test_each_rank_holds_jaxs_shard_at_the_written_positions(runs, key):
    """Every rank's shard of a full-length cache equals JAX's shard at
    the positions written (0 .. DECODES − 1); a ring or a recurrent state
    equals JAX's whole."""
    jax_out, v = runs["jax"][key], CASES[key][1]
    shard_paths = _sharded(runs, key)
    n_sharded = 0
    for rank, got in enumerate(runs["ranks"][key]):
        d, s = _coords(rank)
        for path, leaf in got["cache"].items():
            want = jax_out[f"cache/{path}"]
            sharded = path in shard_paths
            want = _rank_view(want, d, s, v, sharded)
            assert leaf.shape == want.shape, (path, leaf.shape, want.shape)
            if sharded:
                n_sharded += 1
                written = d * SHARD + np.arange(SHARD) < DECODES
                np.testing.assert_allclose(leaf[:, :, :, written],
                                           want[:, :, :, written],
                                           atol=JAX_ATOL, rtol=0)
            elif "/kv/" in f"/{path}/":
                np.testing.assert_allclose(leaf, want, atol=JAX_ATOL, rtol=0)
            else:
                np.testing.assert_allclose(leaf, want, atol=STATE_ATOL,
                                           rtol=STATE_RTOL)
    assert n_sharded > 0


@pytest.mark.parametrize("key", KEYS)
def test_sp_ranks_equal_the_one_process_session(runs, key):
    """The ranks against the port's one process (``sp=False``, whole
    caches): tokens equal, hidden states and every KV cache within 1e-5
    (recurrent state 1e-5 absolute and relative) — each shard against
    its slice of the whole cache, the positions past the last one
    written zero on both."""
    one, v = runs["one"][key], CASES[key][1]
    shard_paths = _sharded(runs, key)
    for rank, got in enumerate(runs["ranks"][key]):
        d, s = _coords(rank)
        np.testing.assert_array_equal(np.stack(got["tokens"]),
                                      np.stack(one["tokens"]))
        if _coords(rank)[1] == PP - 1:
            np.testing.assert_allclose(np.stack(got["hidden"]),
                                       np.stack(one["hidden"]),
                                       atol=ONE_ATOL, rtol=0)
        for path, leaf in got["cache"].items():
            want = _rank_view(one["cache"][path], d, s, v,
                              path in shard_paths)
            # recurrent state (jamba's SSM, ~10 in magnitude) relative too
            rtol = 0 if "/kv/" in f"/{path}/" else ONE_ATOL
            np.testing.assert_allclose(leaf, want, atol=ONE_ATOL, rtol=rtol)


@pytest.mark.parametrize("key", KEYS)
def test_each_rank_holds_its_shard_and_the_planners_bytes(runs, key):
    """A full-length cache holds max(ceil(L / dp), 8) positions on a rank,
    a ring its window (the one process keeps ``default_cache_lens``); for
    the attention-only cases the rank's cache bytes equal
    ``serving_cache_bytes(sp=True, data_replicas=2)`` (fp32 KV)."""
    name, v = CASES[key]
    arch, spec = W.sp_spec(name)
    plan = configs.get(arch).SMOKE_PLAN.with_(
        pp=PP, tp=1, decode_microbatches=1, virtual_stages=v,
        schedule="serve_interleaved" if v > 1 else "serve_1f")
    from repro_torch.core.schedule import (default_cache_lens,
                                           make_serving_schedule)
    sched = make_serving_schedule(plan, 1)
    lens = default_cache_lens(spec, PP * v, CACHE)
    program = spec.stage_program(PP * v)
    want_lens = [SHARD if blk.mixer == "attn" and n >= CACHE else n
                 for blk, n in zip(program, lens)]
    price = serving_cache_bytes(spec, plan, sched, cache_len=CACHE,
                                global_batch=1, sp=True, data_replicas=DATA,
                                kv_dtype="fp32")
    for got in runs["ranks"][key]:
        assert got["cache_lens"] == want_lens
        if spec.mamba is None:
            assert got["cache_bytes"] == price
    assert runs["one"][key]["cache_lens"] == lens
    assert SHARD in want_lens


@pytest.mark.parametrize("key", KEYS)
def test_host_digests_and_data_group_sums(runs, key):
    """Every rank's host digest after each step is the one process's, and
    a rank makes two data-group sums (the max; the sums with the outputs)
    a sharded layer a step."""
    ranks = runs["ranks"][key]
    one = runs["one"][key]["digests"]
    v = CASES[key][1]
    n_layers = sum(p.endswith("kv/0") for p in _sharded(runs, key)) * v
    for got in ranks:
        assert got["digests"] == one
        assert got["data_calls"] == 2 * n_layers * DECODES > 0


def test_sp_without_a_grid_is_the_plain_session():
    """One shard: ``sp=True`` without a grid serves the plain session's
    tokens, hidden states and caches bit for bit (R 1)."""
    sessions = []
    for sp in (True, False):
        arch, spec = W.sp_spec("gemma3")
        plan = configs.get(arch).SMOKE_PLAN.with_(decode_microbatches=4)
        s = build_serving(spec, plan, cache_len=CACHE, global_batch=1,
                          compute_dtype=torch.float32, device="cpu", sp=sp)
        s.start(3)
        sessions.append(W.sp_run(s, 6))
        assert s.n_slots == 1 and s.sp == sp
    a, b = sessions
    np.testing.assert_array_equal(np.stack(a["tokens"]),
                                  np.stack(b["tokens"]))
    for x, y in zip(a["hidden"], b["hidden"]):
        assert np.array_equal(x, y)
    assert a["cache"].keys() == b["cache"].keys()
    for k in a["cache"]:
        assert np.array_equal(a["cache"][k], b["cache"][k])


def _jax_build(sp_kw):
    """JAX's ``build_serving`` of gemma3's smoke spec on a one-device
    mesh: the ValueError it raises."""
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.launch.mesh import make_host_mesh
    from repro.parallel.mesh import split_model_axis
    from repro.serving.engine import build_serving as jbuild
    cfg = jconfigs.get("gemma3-4b")
    plan = cfg.SMOKE_PLAN.with_(pp=1, **sp_kw.pop("plan", {}))
    mesh = split_model_axis(make_host_mesh(data=1, model=1), 1, 1)
    with pytest.raises(ValueError) as e:
        jbuild(cfg.smoke_spec(), plan, mesh, cache_len=CACHE,
               global_batch=1, sp=True, compute_dtype=jnp.float32, **sp_kw)
    return str(e.value)


@pytest.mark.parametrize("what", ["paged", "speculative", "prefill"])
def test_sp_exclusions_raise(what):
    """Paging and speculative decode raise JAX's errors; a prefill raises
    (JAX asserts one token a row)."""
    cfg = configs.get("gemma3-4b")
    spec = cfg.smoke_spec()
    plan = cfg.SMOKE_PLAN.with_(pp=1)
    kw = dict(cache_len=CACHE, global_batch=1, compute_dtype=torch.float32,
              device="cpu", sp=True)
    if what == "prefill":
        s = build_serving(spec, plan, **kw).start(0)
        with pytest.raises(ValueError, match="no prefill"):
            s.prefill({"tokens": np.ones((1, 1, 4), np.int32)})
        return
    if what == "paged":
        want = _jax_build({"page_size": 8})
        kw["page_size"] = 8
    else:
        want = _jax_build({"plan": {"schedule": "serve_spec_1f"}})
        plan = plan.with_(schedule="serve_spec_1f")
    with pytest.raises(ValueError) as e:
        build_serving(spec, plan, **kw)
    assert str(e.value) == want


def test_sp_needs_data_ranks_and_shards_on_meta_only():
    """On a grid, sp shards over its data ranks (a grid of one raises);
    ``sp_shards=`` builds one data rank's shard without a grid on
    ``meta``, and raises elsewhere."""
    from types import SimpleNamespace
    from repro_torch.parallel.dist import ProcessGrid
    cfg = configs.get("gemma3-4b")
    spec, plan = cfg.smoke_spec(), cfg.SMOKE_PLAN
    kw = dict(cache_len=CACHE, global_batch=1, compute_dtype=torch.float32,
              sp=True)
    grid = SimpleNamespace(topo=ProcessGrid(1, 2, 1), device="cpu")
    with pytest.raises(ValueError, match="data ranks"):
        build_serving(spec, plan, grid=grid, **kw)
    with pytest.raises(ValueError, match="meta only"):
        build_serving(spec, plan, device="cpu", sp_shards=2, **kw)
    s = build_serving(spec, plan, device="meta", sp_shards=2, **kw).start(0)
    assert s.cache_lens == [8, 8, SHARD]
    assert s.cache["layer_2"]["kv"][0].shape[3] == SHARD
    assert s.decode(np.ones(1, np.int32)).device.type == "meta"


def test_jax_sp_write_wraps_onto_a_non_owner_shard(runs):
    """JAX's owner-shard write, ``.at[:, cache_pos - off].set(...,
    mode="drop")``, wraps a negative index (``zeros((1, 4)).at[:,
    -1].set(1., mode="drop")`` writes slot 3): shard d writes the key of
    position p into its slot p − off + L whenever off − L <= p < off.
    The slot stays masked until its own position overwrites it, so the
    tokens agree; the caches differ there.  At 12 decodes JAX's shard 1
    holds the keys of positions 4-7 in the slots of positions 12-15; the
    port writes on the owner shard only, and those slots stay zero."""
    import jax.numpy as jnp
    got = np.asarray(jnp.zeros((1, 4)).at[:, -1].set(1.0, mode="drop"))
    np.testing.assert_array_equal(got, [[0.0, 0.0, 0.0, 1.0]])
    jax_out = runs["jax"]["gemma3"]
    for path in ("layer_2/kv/0", "layer_2/kv/1"):
        whole = jax_out[f"cache/{path}"]           # (2, 1, 1, 16, KV, Dh)
        stray = whole[:, :, :, SHARD + DECODES - SHARD:]      # slots 12-15
        np.testing.assert_array_equal(stray, whole[:, :, :, 4:SHARD])
        assert np.abs(stray).sum() > 0
        for rank, got in enumerate(runs["ranks"]["gemma3"]):
            d, _ = _coords(rank)
            if d == 1:
                assert not got["cache"][path][:, :, :, DECODES - SHARD:].any()
