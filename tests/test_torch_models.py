"""The port's model layer against the JAX package on the same numpy
weights: norms, RoPE, the parameter tree, ``full_transformer``, and the
paged attention dispatch (the lane-mapping regression)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import init as jinit
from repro.models import lm_head as jlm
from repro.models import nn as jnn
from repro.models import stage as jstage
from repro.parallel.mesh import ParallelismPlan as JPlan
from repro_torch import configs as tconfigs
from repro_torch.models import init as tinit
from repro_torch.models import lm_head as tlm
from repro_torch.models import nn as tnn
from repro_torch.models import stage as tstage
from repro_torch.models.spec import BlockSpec
from repro_torch.parallel.plan import ParallelismPlan as TPlan

ATOL, RTOL = 2e-4, 1e-3          # model-level fp32 (tests/test_kernels.py)


@functools.lru_cache(maxsize=None)
def _jax_params(pp, seed=3):
    """JAX-initialized numpy weights of the qwen3 smoke spec (shared)."""
    spec = jconfigs.get("qwen3-14b").smoke_spec()
    plan = JPlan(pp=pp, tp=1, microbatches=1, remat=False)
    params, _ = jinit.init_params(spec, plan, jax.random.key(seed),
                                  jnp.float32)
    return jax.tree.map(np.asarray, params), plan


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, 12), (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tnn.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jnn.rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-6, rtol=1e-6)
    for rope_2d in (False, True):
        tq, tk = tnn.apply_rope(torch.from_numpy(x), torch.from_numpy(k),
                                torch.from_numpy(pos), 1e6, rope_2d=rope_2d)
        jq, jk = jnn.apply_rope(jnp.asarray(x), jnp.asarray(k),
                                jnp.asarray(pos), jnp.float32(1e6),
                                rope_2d=rope_2d)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)


def test_init_tree_matches_jax_keys_and_shapes():
    spec = tconfigs.get("qwen3-14b").smoke_spec()
    plan = TPlan(pp=2, tp=1)
    mine = tinit.init_params(spec, plan, torch.Generator().manual_seed(0),
                             torch.float32)
    ref, _ = _jax_params(2)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(np.shape(tree))

    assert shapes(mine) == shapes(ref)
    conv = tinit.params_from_numpy(ref, "cpu", torch.float32)
    assert shapes(conv) == shapes(ref)
    assert conv["layer_windows"] == ref["layer_windows"].tolist()
    np.testing.assert_array_equal(
        conv["stages"]["layer_1"]["mlp"]["w2"].numpy(),
        ref["stages"]["layer_1"]["mlp"]["w2"])


@pytest.mark.parametrize("pp", [1, 2])
def test_full_transformer_matches_jax(pp):
    jspec = jconfigs.get("qwen3-14b").smoke_spec()
    tspec = tconfigs.get("qwen3-14b").smoke_spec()
    params, jplan = _jax_params(pp)
    rng = np.random.default_rng(pp)
    x = rng.standard_normal((2, 24, jspec.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    jst = jstage.make_statics(jspec, jplan, tokens_per_mb=48)
    want, _ = jstage.full_transformer(jax.tree.map(jnp.asarray, params),
                                      jnp.asarray(x), jst,
                                      positions=jnp.asarray(pos))
    tst = tstage.make_statics(tspec, TPlan(pp=pp, tp=1))
    tp = tinit.params_from_numpy(params, "cpu", torch.float32)
    got = tstage.full_transformer(tp, torch.from_numpy(x), tst,
                                  positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    # the head agrees too: greedy tokens from the same hidden state
    fn = tp["final_norm"]
    np.testing.assert_array_equal(
        tlm.sample_greedy(tp["head"], fn["scale"], got,
                          vocab=tspec.vocab).numpy(),
        np.asarray(jlm.sample_greedy(
            jnp.asarray(params["head"]),
            jnp.asarray(params["final_norm"]["scale"]), want,
            vocab=jspec.vocab)))


def test_make_statics_rejects_unported_block_kinds():
    """Mixer-less blocks are not ported yet; cross-attention blocks
    (ported with whisper) get non-causal statics of their own; MoE
    blocks (ported, with shared experts since the deepseek slice) need
    the tokens per microbatch that size capacity."""
    spec = tconfigs.get("qwen3-14b").smoke_spec()
    bare = dataclasses.replace(spec, blocks=tuple(
        BlockSpec(mixer="none", ffn="dense") for _ in spec.blocks))
    with pytest.raises(NotImplementedError):
        tstage.make_statics(bare, TPlan(pp=1, tp=1))
    xattn = dataclasses.replace(spec, blocks=tuple(
        BlockSpec(mixer="attn", ffn="dense", cross_attn=True)
        for _ in spec.blocks))
    st = tstage.make_statics(xattn, TPlan(pp=1, tp=1))
    assert st.attn.causal and not st.xattn.causal
    jamba = tconfigs.get("jamba-v0.1-52b").smoke_spec()
    with pytest.raises(ValueError, match="tokens_per_mb"):
        tstage.make_statics(jamba, TPlan(pp=1, tp=1))
    shared = dataclasses.replace(jamba, moe=dataclasses.replace(
        jamba.moe, n_shared=1, d_shared=32))
    st = tstage.make_statics(shared, TPlan(pp=1, tp=1), tokens_per_mb=8)
    assert st.moe.n_shared == 1


@pytest.mark.parametrize("rows", [1, 2, 3])
def test_paged_decode_dispatch_matches_jax_gather_path(rows):
    """Lane-mapping regression.  One paged decode call (pool of 8 pages,
    page 16, 4 heads over 2 KV heads, Dh 16, table [5, 2, -1, -1],
    cache_pos 20) with ``rows`` rows per slot: the port's paged dispatch
    (flattened pool, entries pid·rows + lane) against the JAX default
    jnp gather path, outputs and written pools.  The JAX Pallas dispatch
    (nn.py:405-410) flattens the pool lane-major and disagrees for
    rows > 1; the port must not copy that."""
    rng = np.random.default_rng(rows)
    n_pool, page, h, kv, dh, d = 8, 16, 4, 2, 16, 32
    st_kw = dict(n_heads_local=h, n_kv_local=kv, d_head=dh, kv_sharded=True,
                 kv_groups_per_device=0, qk_norm=True, rope_2d=False)
    p = {"wq": rng.standard_normal((d, h, dh)) * 0.3,
         "wk": rng.standard_normal((d, kv, dh)) * 0.3,
         "wv": rng.standard_normal((d, kv, dh)) * 0.3,
         "wo": rng.standard_normal((h * dh, d)) * 0.3,
         "q_norm": rng.standard_normal(dh), "k_norm": rng.standard_normal(dh)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((rows, 1, d)).astype(np.float32)
    kp = rng.standard_normal((n_pool, rows, page, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pool, rows, page, kv, dh)).astype(np.float32)
    table = np.array([5, 2, -1, -1], np.int32)
    cache_pos = 20
    pos = np.full((rows, 1), cache_pos, np.int32)

    assert not jops.use_pallas()
    jout, (jk, jv) = jnn.attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnn.AttnStatic(**st_kw), positions=jnp.asarray(pos),
        window=jnp.int32(-1), theta=jnp.float32(1e4), tp_axis=None,
        cache_pos=jnp.int32(cache_pos),
        paged_kv=((jnp.asarray(kp), jnp.asarray(vp)), jnp.asarray(table),
                  jnp.bool_(True)))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    row = tnn.page_row(table, rows, cache_pos + 1, "cpu")
    tout = tnn.attention({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), tnn.AttnStatic(**st_kw),
                         positions=torch.from_numpy(pos), window=-1,
                         theta=1e4, cache_pos=cache_pos,
                         paged_kv=(tk, tv, row))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=1e-3)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    assert not np.allclose(tk.numpy(), kp)      # the token was written


def test_blockwise_twin_matches_jax_twin_and_naive():
    """``_sdpa_flash`` (taken above 4M query·key pairs) against the JAX
    ``_sdpa_flash_jnp`` and the naive path, over a cache-style k_pos with
    unwritten slots."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 40, 4, 8)).astype(np.float32)
    v = rng.standard_normal((2, 40, 4, 8)).astype(np.float32)
    q_pos = np.arange(30, 36, dtype=np.int32)
    k_pos = np.where(np.arange(40) < 36, np.arange(40),
                     tnn._INVALID_POS).astype(np.int32)
    for window in (-1, 9):
        want = jnn._sdpa_flash_jnp(*(jnp.asarray(a) for a in
                                     (q, k, v, q_pos, k_pos)),
                                   jnp.int32(window), True, block=16)
        tq, tk, tv, tqp, tkp = (torch.from_numpy(a) for a in
                                (q, k, v, q_pos, k_pos))
        got = tnn._sdpa_flash(tq, tk, tv, tqp, tkp, window, True, block=16)
        naive = tnn._sdpa_naive(tq, tk, tv, tnn._attn_mask(
            tqp, tkp, window, True)[None, None])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=1e-3)
        np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=2e-5,
                                   rtol=1e-3)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_layernorm_and_mlp_match_jax(act):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    p = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
         for k, s in (("w1", (16, 24)), ("w2", (24, 16)), ("w3", (16, 24)))}
    scale, bias = (rng.standard_normal(16).astype(np.float32)
                   for _ in range(2))
    t = lambda a: torch.from_numpy(a)
    np.testing.assert_allclose(
        tnn.mlp({k: t(v) for k, v in p.items()}, t(x), act).numpy(),
        np.asarray(jnn.mlp({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), act, None)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tnn.layernorm(t(x), t(scale), t(bias)).numpy(),
        np.asarray(jnn.layernorm(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias))), atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# RWKV6 (rwkv6-1.6b): group norm, time-mix, channel-mix, init, full forward
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_rwkv_params(pp, seed=4):
    """JAX-initialized numpy weights of the rwkv6 smoke spec (shared)."""
    spec = jconfigs.get("rwkv6-1.6b").smoke_spec()
    plan = JPlan(pp=pp, tp=1, microbatches=1, remat=False)
    params, _ = jinit.init_params(spec, plan, jax.random.key(seed),
                                  jnp.float32)
    return jax.tree.map(np.asarray, params), plan


def _tmix_params(rng, d, h, lora=4, dlora=8):
    """Random time-mix weights (no stage dim) with decays spread over
    (0.07, 0.95): w0 ~ U(-3, 1) before exp(-exp(.))."""
    g = lambda *s, scale=0.3: (scale * rng.standard_normal(s)).astype(
        np.float32)
    p = {f"maa_{n}": rng.uniform(0, 1, d).astype(np.float32)
         for n in ("x", "w", "k", "v", "r", "g")}
    p.update(tmix_w1=g(d, 5 * lora), tmix_w2=g(5, lora, d),
             wr=g(d, d), wk=g(d, d), wv=g(d, d), wg=g(d, d), wo=g(d, d),
             w0=rng.uniform(-3, 1, d).astype(np.float32),
             decay_w1=g(d, dlora), decay_w2=g(dlora, d), u=g(d),
             gn_scale=1 + g(d), gn_bias=g(d))
    return p


def test_groupnorm_heads_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    scale, bias = (rng.standard_normal(32).astype(np.float32)
                   for _ in range(2))
    np.testing.assert_allclose(
        tnn.groupnorm_heads(*(torch.from_numpy(a) for a in (x, scale, bias))
                            ).numpy(),
        np.asarray(jnn.groupnorm_heads(*(jnp.asarray(a)
                                         for a in (x, scale, bias)))),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seq", [1, 9])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_time_and_channel_mix_match_jax(seq, with_state):
    """Time-mix and channel-mix against JAX on one numpy tree: without a
    state (the cache-less forward, zero token shift and WKV start) and
    from a state (the engine's prefill, seq 9, and decode, seq 1), whose
    in-place update must equal the JAX new state."""
    rng = np.random.default_rng(seq + 10 * with_state)
    b, d, h, dh, ff = 2, 32, 4, 8, 48
    tp = _tmix_params(rng, d, h)
    cp = {"maa_k": rng.uniform(0, 1, d).astype(np.float32),
          "maa_r": rng.uniform(0, 1, d).astype(np.float32),
          "wk": (0.3 * rng.standard_normal((d, ff))).astype(np.float32),
          "wv": (0.3 * rng.standard_normal((ff, d))).astype(np.float32),
          "wr_gate": (0.3 * rng.standard_normal((d, d))).astype(np.float32)}
    x = rng.standard_normal((b, seq, d)).astype(np.float32)
    tstate = cstate = None
    if with_state:
        tstate = (rng.standard_normal((b, d)).astype(np.float32),
                  (0.5 * rng.standard_normal((b, h, dh, dh))).astype(
                      np.float32))
        cstate = rng.standard_normal((b, d)).astype(np.float32)
    t = lambda a: torch.from_numpy(a.copy())
    jt = lambda tree: jax.tree.map(jnp.asarray, tree)

    jout, jnew = jnn.rwkv_time_mix(jt(tp), jnp.asarray(x),
                                   jnn.RWKVStatic(h, dh), None, jt(tstate))
    mine_state = None if tstate is None else tuple(t(a) for a in tstate)
    tout = tnn.rwkv_time_mix({k: t(v) for k, v in tp.items()}, t(x),
                             tnn.RWKVStatic(h, dh), state=mine_state)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=RTOL)
    if with_state:
        for got, want in zip(mine_state, jnew):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=RTOL)

    jout, jnew = jnn.rwkv_channel_mix(jt(cp), jnp.asarray(x), None,
                                      jt(cstate))
    mine = None if cstate is None else t(cstate)
    tout = tnn.rwkv_channel_mix({k: t(v) for k, v in cp.items()}, t(x),
                                state=mine)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=RTOL)
    if with_state:
        np.testing.assert_allclose(mine.numpy(), np.asarray(jnew), atol=0)


def test_rwkv_init_tree_matches_jax_keys_shapes_and_f32_decay():
    spec = tconfigs.get("rwkv6-1.6b").smoke_spec()
    mine = tinit.init_params(spec, TPlan(pp=2, tp=1),
                             torch.Generator().manual_seed(0),
                             torch.bfloat16)
    ref, _ = _jax_rwkv_params(2)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(np.shape(tree))

    assert shapes(mine) == shapes(ref)
    conv = tinit.params_from_numpy(ref, "cpu", torch.bfloat16)
    assert shapes(conv) == shapes(ref)
    for tree in (mine, conv):
        tm = tree["stages"]["layer_1"]["tmix"]
        assert tm["w0"].dtype == torch.float32        # as in the JAX init
        assert tm["wr"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        conv["stages"]["layer_1"]["tmix"]["w0"].numpy(),
        ref["stages"]["layer_1"]["tmix"]["w0"])
    w0 = mine["stages"]["layer_0"]["tmix"]["w0"]
    assert abs(w0.mean().item() + 3.9) < 0.1 and 0.1 < w0.std().item() < 0.3


@pytest.mark.parametrize("pp", [1, 2])
def test_rwkv_full_transformer_matches_jax(pp):
    jspec = jconfigs.get("rwkv6-1.6b").smoke_spec()
    tspec = tconfigs.get("rwkv6-1.6b").smoke_spec()
    params, jplan = _jax_rwkv_params(pp)
    rng = np.random.default_rng(20 + pp)
    x = rng.standard_normal((2, 21, jspec.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(21), (2, 21)).astype(np.int32)
    jst = jstage.make_statics(jspec, jplan, tokens_per_mb=42)
    want, _ = jstage.full_transformer(jax.tree.map(jnp.asarray, params),
                                      jnp.asarray(x), jst,
                                      positions=jnp.asarray(pos))
    tst = tstage.make_statics(tspec, TPlan(pp=pp, tp=1))
    assert tst.attn is None and tst.rwkv == tnn.RWKVStatic(8, 8)
    tp = tinit.params_from_numpy(params, "cpu", torch.float32)
    got = tstage.full_transformer(tp, torch.from_numpy(x), tst,
                                  positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


# --------------------------------------------------------------------------
# jamba (Mamba + MoE + attention): init, statics, full forward
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_jamba_params(pp, seed=5):
    """JAX-initialized numpy weights of the jamba smoke spec (shared)."""
    spec = jconfigs.get("jamba-v0.1-52b").smoke_spec()
    plan = JPlan(pp=pp, tp=1, microbatches=1, remat=False)
    params, _ = jinit.init_params(spec, plan, jax.random.key(seed),
                                  jnp.float32)
    return jax.tree.map(np.asarray, params), plan


def test_jamba_init_tree_matches_jax_keys_shapes_and_f32_leaves():
    spec = tconfigs.get("jamba-v0.1-52b").smoke_spec()
    mine = tinit.init_params(spec, TPlan(pp=2, tp=1),
                             torch.Generator().manual_seed(0),
                             torch.bfloat16)
    ref, _ = _jax_jamba_params(2)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(np.shape(tree))

    assert shapes(mine) == shapes(ref)
    conv = tinit.params_from_numpy(ref, "cpu", torch.bfloat16)
    assert shapes(conv) == shapes(ref)
    for tree in (mine, conv):
        mb = tree["stages"]["layer_1"]["mamba"]
        for key in ("dt_bias", "A_log", "D"):     # f32, as in the JAX init
            assert mb[key].dtype == torch.float32, key
        assert mb["in_x"].dtype == torch.bfloat16
        assert tree["stages"]["layer_1"]["moe"]["w1"].dtype == torch.bfloat16
    for key in ("dt_bias", "A_log", "D"):
        np.testing.assert_array_equal(
            conv["stages"]["layer_2"]["mamba"][key].numpy(),
            ref["stages"]["layer_2"]["mamba"][key])
    mb = mine["stages"]["layer_1"]["mamba"]
    dt = torch.nn.functional.softplus(mb["dt_bias"])
    assert 1e-3 <= dt.min().item() and dt.max().item() <= 0.1 + 1e-6
    np.testing.assert_allclose(mb["A_log"][0, 0].numpy(),
                               np.log(np.arange(1, 5)), rtol=1e-6)


def test_jamba_statics_match_jax():
    jspec = jconfigs.get("jamba-v0.1-52b").full_spec()
    tspec = tconfigs.get("jamba-v0.1-52b").full_spec()
    for pp, tokens in ((2, 2048), (4, 1), (1, 16)):
        jst = jstage.make_statics(jspec, JPlan(pp=pp, tp=1),
                                  tokens_per_mb=tokens)
        tst = tstage.make_statics(tspec, TPlan(pp=pp, tp=1),
                                  tokens_per_mb=tokens)
        assert dataclasses.asdict(tst.moe) == dataclasses.asdict(jst.moe)
        want = dataclasses.asdict(jst.mamba)
        want.pop("chunk")          # the jnp twin's chunk: no CUDA analogue
        assert dataclasses.asdict(tst.mamba) == want
    assert tst.attn is not None and tst.rwkv is None
    st = tstage.make_statics(tspec, TPlan(pp=2, tp=1), tokens_per_mb=2048)
    assert st.moe.capacity == 320 and st.mamba.d_inner_local == 8192
    assert st.mamba.dt_rank == 256


@pytest.mark.parametrize("pp", [1, 2])
def test_jamba_full_transformer_matches_jax(pp):
    """Mamba + MoE + attention blocks, no state, against JAX with the
    same statics.  tokens_per_mb is twice the call's B·S, so capacity
    (1.25 · B·S · 2 · k / E) is above B·S and no expert can overflow:
    the JAX MoE scatter fault cannot show (tests/test_torch_moe.py)."""
    jspec = jconfigs.get("jamba-v0.1-52b").smoke_spec()
    tspec = tconfigs.get("jamba-v0.1-52b").smoke_spec()
    params, jplan = _jax_jamba_params(pp)
    rng = np.random.default_rng(30 + pp)
    b, s = 2, 13
    x = rng.standard_normal((b, s, jspec.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    jst = jstage.make_statics(jspec, jplan, tokens_per_mb=2 * b * s)
    assert jst.moe.capacity >= b * s
    want, _ = jstage.full_transformer(jax.tree.map(jnp.asarray, params),
                                      jnp.asarray(x), jst,
                                      positions=jnp.asarray(pos))
    tst = tstage.make_statics(tspec, TPlan(pp=pp, tp=1),
                              tokens_per_mb=2 * b * s)
    assert tst.moe.capacity == jst.moe.capacity
    tp = tinit.params_from_numpy(params, "cpu", torch.float32)
    got = tstage.full_transformer(tp, torch.from_numpy(x), tst,
                                  positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
