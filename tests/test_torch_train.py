"""The port's training round (slice 7), CPU parts: the loss head, the
embedding's backward, the data stream, a stage's gradient (remat on and
off) against the JAX package, the executor against the port's oracle bit
for bit (fp32), the paper's staleness formula against the 1f1b oracle,
the entry point, and the kernels without a backward refusing autograd.
The oracle against JAX's oracle: tests/test_torch_train_oracle*.py."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_jax import one_torch_thread  # noqa: F401
from repro import configs as jconfigs
from repro.data import pipeline as jdata
from repro.models import init as jinit
from repro.models import lm_head as jlm
from repro.models import stage as jstage
from repro.parallel.mesh import ParallelismPlan as JPlan
from repro_torch import configs as tconfigs
from repro_torch.core.pipeline import build_pipeline
from repro_torch.core.reference import (reference_init_state,
                                        reference_train_step,
                                        staleness_formula_run)
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import wkv6 as twkv
from repro_torch.models import init as tinit
from repro_torch.models import lm_head as tlm
from repro_torch.models import nn as tnn
from repro_torch.models import stage as tstage
from repro_torch.optim import SGDM, Adam
from repro_torch.optim.optimizers import tree_map

ROOT = Path(__file__).resolve().parents[1]
F32 = (2e-5, 1e-3)
MODES = ["stash", "vertical", "flush", "2bw"]


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, atol=F32[0], rtol=F32[1]):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


# --------------------------------------------------------------------------
# loss head, embedding backward, data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("masked", [False, True])
def test_head_loss_and_its_gradient_match_jax(norm, masked):
    rng = np.random.default_rng(0)
    d, vocab, vpad = 32, 250, 256              # padded vocab ids masked
    head = rng.standard_normal((d, vpad)).astype(np.float32) * 0.2
    fn = {"scale": 1 + 0.1 * rng.standard_normal(d).astype(np.float32)}
    if norm == "layernorm":
        fn["bias"] = 0.1 * rng.standard_normal(d).astype(np.float32)
    h = rng.standard_normal((2, 9, d)).astype(np.float32)
    labels = rng.integers(0, vocab, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32) if masked else None

    def jf(hd, f, x):
        return jlm.head_loss(hd, f["scale"], x, jnp.asarray(labels),
                             norm_kind=norm, norm_bias=f.get("bias"),
                             valid_mask=None if mask is None
                             else jnp.asarray(mask), vocab=vocab)[0]

    jloss, (jdh, jdf, jdx) = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(head), jax.tree.map(jnp.asarray, fn), jnp.asarray(h))
    t = torch.from_numpy
    loss, dx, dh, df = tlm.loss_and_grads(
        t(head), tree_map(t, fn), t(h), t(labels), norm_kind=norm,
        valid_mask=None if mask is None else t(mask), vocab=vocab)
    _close(loss, jloss)
    _close(dx, jdx)
    _close(dh, jdh)
    for k in fn:
        _close(df[k], jdf[k])
    if norm == "rmsnorm":
        l2, dx2, dh2, ds2 = tlm.head_loss_and_grad(
            t(head), t(fn["scale"]), t(h), t(labels), norm_kind=norm,
            valid_mask=None if mask is None else t(mask), vocab=vocab)
        assert torch.equal(l2, loss) and torch.equal(dx2, dx)
        assert torch.equal(dh2, dh) and torch.equal(ds2, df["scale"])


def test_head_loss_in_bf16_matches_jax():
    """bf16 h and head: the product in bf16, the logits taken to f32.  The
    limit (1e-4) lies below the gap of either other rounding order on
    these inputs (an f32 product, or the log-sum-exp in bf16: >1e-3), so
    the test tells them apart."""
    rng = np.random.default_rng(1)
    head = rng.standard_normal((64, 256)).astype(np.float32)
    h = rng.standard_normal((2, 8, 64)).astype(np.float32)
    scale = np.ones(64, np.float32)
    labels = rng.integers(0, 256, (2, 8)).astype(np.int32)
    jloss, _ = jlm.head_loss(jnp.asarray(head, jnp.bfloat16),
                             jnp.asarray(scale, jnp.bfloat16),
                             jnp.asarray(h, jnp.bfloat16), jnp.asarray(labels))
    bf = lambda a: torch.from_numpy(a).bfloat16()          # noqa: E731
    lab = torch.from_numpy(labels)
    loss, _ = tlm.head_loss(bf(head), bf(scale), bf(h), lab)
    assert loss.dtype == torch.float32
    _close(loss, jloss, 1e-4, 0)

    def nll(logits):
        picked = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
        return (torch.logsumexp(logits, -1) - picked).float().mean()
    hn = tnn.rmsnorm(bf(h), bf(scale))
    for other in (nll(hn.float() @ bf(head).float()), nll(hn @ bf(head))):
        assert abs(float(other) - float(jloss)) > 1e-3


def test_embed_bwd_matches_jax():
    rng = np.random.default_rng(2)
    table = np.zeros((40, 8), np.float32)
    tokens = rng.integers(0, 40, (3, 2, 11)).astype(np.int32)
    d = rng.standard_normal((3, 2, 11, 8)).astype(np.float32)
    want = jlm.embed_bwd(jnp.asarray(table), jnp.asarray(tokens),
                         jnp.asarray(d))
    got = tlm.embed_bwd(torch.from_numpy(table), torch.from_numpy(tokens),
                        torch.from_numpy(d))
    assert got.shape == table.shape and got.dtype == torch.float32
    _close(got, want, 1e-6, 1e-6)


@pytest.mark.parametrize("seed,step,r,bmb,seq", [(0, 0, 4, 2, 16),
                                                 (3, 7, 2, 1, 33),
                                                 (1, 2, 8, 3, 4096)])
def test_synthetic_lm_round_batch_is_jax_bit_for_bit(seed, step, r, bmb, seq):
    j = jdata.SyntheticLM(151936, seq, seed=seed).round_batch(step, r, bmb)
    t = tdata.SyntheticLM(151936, seq, seed=seed).round_batch(step, r, bmb)
    for k in ("tokens", "labels"):
        assert t[k].dtype == j[k].dtype == np.int32
        np.testing.assert_array_equal(t[k], j[k])
    got = tdata.Loader(tdata.SyntheticLM(151936, seq, seed=seed), r, bmb,
                       "cpu").get(step)
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["labels"].numpy(), j["labels"])


# --------------------------------------------------------------------------
# a stage's gradient against jax.vjp of JAX's stage_fwd
# --------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("stage", [0, 1])
def test_stage_gradient_matches_jax_vjp(stage, remat):
    jspec = jconfigs.get("qwen3-14b").smoke_spec()
    tspec = tconfigs.get("qwen3-14b").smoke_spec()
    jplan = JPlan(pp=2, tp=1, microbatches=1, remat=remat)
    tplan = tconfigs.get("qwen3-14b").SMOKE_PLAN.with_(remat=remat)
    params, _ = jinit.init_params(jspec, jplan, jax.random.key(4),
                                  jnp.float32)
    tparams = tinit.params_from_numpy(jax.tree.map(np.asarray, params),
                                      "cpu", torch.float32)
    rng = np.random.default_rng(stage)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    g = rng.standard_normal((2, 12, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    jst = jstage.make_statics(jspec, jplan, tokens_per_mb=24)
    wp = jax.tree.map(lambda a: a[stage:stage + 1], params["stages"])

    def jf(w, x_):
        h, _, aux = jstage.stage_fwd(
            w, x_, jst, positions=jnp.asarray(pos),
            windows=params["layer_windows"][stage],
            thetas=params["layer_thetas"][stage], tp_axis=None)
        return h, aux

    @jax.jit
    def fwd_vjp(w, x_, g_):
        (h_, _), vjp = jax.vjp(jf, w, x_)
        return h_, vjp((g_, jnp.float32(0.01)))

    jh, (jdw, jdx) = fwd_vjp(wp, jnp.asarray(x), jnp.asarray(g))
    tst = tstage.make_statics(tspec, tplan, tokens_per_mb=24)
    sp = tstage.stage_params(tparams, stage)
    kw = dict(positions=torch.from_numpy(pos.copy()),
              windows=tparams["layer_windows"][stage],
              thetas=tparams["layer_thetas"][stage])
    with torch.no_grad():
        h = tstage.stage_fwd(sp, torch.from_numpy(x), tst, **kw)
    _close(h, jh)
    dw, dx = tstage.stage_vjp(sp, torch.from_numpy(x), tst,
                              torch.from_numpy(g), 0.01, **kw)
    _close(dx, jdx)
    flat_t = jax.tree.leaves(dw)
    flat_j = jax.tree.leaves(jax.tree.map(lambda a: a[0], jdw))
    assert len(flat_t) == len(flat_j) > 10
    for a, b in zip(flat_t, flat_j):
        _close(a, b)


def test_remat_changes_no_value_and_runs_checkpointed_blocks():
    """remat on and off give equal outputs and gradients; with remat a
    block's forward runs again in the backward (the flash forward counts
    it: F phase excluded, 2 calls a block, not 1)."""
    from repro_torch.kernels import flash_attention as tfa
    spec = tconfigs.get("qwen3-14b").smoke_spec()
    plan = tconfigs.get("qwen3-14b").SMOKE_PLAN
    params = tinit.init_params(spec, plan, torch.Generator().manual_seed(0),
                               torch.float32)
    x, g = torch.randn(2, 8, 64), torch.randn(2, 8, 64)
    pos = torch.arange(8).expand(2, 8)
    out, calls = [], []
    for remat in (False, True):
        st = tstage.make_statics(spec, plan.with_(remat=remat))
        seen = []
        orig = tfa.FlashAttention.forward

        def spy(ctx, *a, _orig=orig, _seen=seen):
            _seen.append(1)
            return _orig(ctx, *a)

        tfa.FlashAttention.forward = staticmethod(spy)
        try:
            out.append(tstage.stage_vjp(
                tstage.stage_params(params, 0), x, st, g, 0.0, positions=pos,
                windows=params["layer_windows"][0],
                thetas=params["layer_thetas"][0]))
        finally:
            tfa.FlashAttention.forward = staticmethod(orig)
        calls.append(len(seen))
    assert torch.equal(out[0][1], out[1][1])
    for a, b in zip(jax.tree.leaves(out[0][0]), jax.tree.leaves(out[1][0])):
        assert torch.equal(a, b)
    lps = spec.layers_per_stage(plan.pp)
    assert calls == [lps, 2 * lps]


def test_stage_vjp_feeds_the_moe_aux_cotangent():
    """jamba's smoke stage (Mamba, attention, MoE): return_aux sums the
    MoE auxiliary loss, and stage_vjp pulls back g on the output plus
    aux_ct on the aux term, as autograd of <h, g> + aux_ct · aux."""
    spec = tconfigs.get("jamba-v0.1-52b").smoke_spec()
    plan = tconfigs.get("jamba-v0.1-52b").SMOKE_PLAN.with_(pp=1, remat=False)
    params = tinit.init_params(spec, plan, torch.Generator().manual_seed(1),
                               torch.float32)
    st = tstage.make_statics(spec, plan, tokens_per_mb=16)
    sp = tstage.stage_params(params, 0)
    x, g = torch.randn(2, 8, spec.d_model), torch.randn(2, 8, spec.d_model)
    kw = dict(positions=torch.arange(8).expand(2, 8),
              windows=params["layer_windows"][0],
              thetas=params["layer_thetas"][0])
    with torch.no_grad():
        _, aux = tstage.stage_fwd(sp, x, st, return_aux=True, **kw)
    assert aux.dtype == torch.float32 and aux.item() > 0
    dw, dx = tstage.stage_vjp(sp, x, st, g, 0.25, **kw)
    leaves = tree_map(lambda a: a.detach().clone().requires_grad_(), sp)
    xl = x.clone().requires_grad_()
    h, a = tstage.stage_fwd(leaves, xl, st, return_aux=True, **kw)
    want = torch.autograd.grad((h * g).sum() + 0.25 * a,
                               [xl] + jax.tree.leaves(leaves),
                               allow_unused=True)
    _close(dx, want[0], 1e-6, 1e-5)
    for got, w in zip(jax.tree.leaves(dw), want[1:]):
        _close(got, torch.zeros_like(got) if w is None else w, 1e-6, 1e-5)


# --------------------------------------------------------------------------
# executor == oracle, staleness formula, entry point
# --------------------------------------------------------------------------

def _smoke(pp, mode, r=4):
    cfg = tconfigs.get("qwen3-14b")
    return cfg.smoke_spec(), cfg.SMOKE_PLAN.with_(pp=pp, microbatches=r,
                                                  stash_mode=mode)


def _batches(spec, rounds, r, bmb, seq):
    src = tdata.SyntheticLM(spec.vocab, seq, seed=5)
    return [{k: torch.from_numpy(v) for k, v in
             src.round_batch(i, r, bmb).items()} for i in range(rounds)]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{prefix}/{k}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("opt", ["sgdm", "adam"])
@pytest.mark.parametrize("pp", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_executor_equals_oracle_bit_for_bit(mode, pp, opt):
    spec, plan = _smoke(pp, mode)
    optimizer = SGDM(lr=0.05) if opt == "sgdm" else Adam(lr=1e-3)
    bundle = build_pipeline(spec, plan, seq_len=8, global_batch=8,
                            optimizer=optimizer, compute_dtype=torch.float32,
                            device="cpu")
    state = bundle.init_state(torch.Generator().manual_seed(0))
    ref = reference_init_state(spec, plan, optimizer,
                               torch.Generator().manual_seed(0))
    for batch in _batches(spec, 2, 4, 2, 8):
        state, em = bundle.train_step(state, batch)
        ref, om = reference_train_step(spec, plan, ref, batch, optimizer)
        assert torch.equal(em["loss"], om["loss"])
        assert torch.equal(em["aux"], om["aux"])
    assert state["stash"]["current"] is state["params"]["stages"]
    got, want = _leaves(state), _leaves(ref)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), name
    assert state["step"] == 2


@pytest.mark.parametrize("mode", ["stash", "vertical"])
@pytest.mark.parametrize("pp", [2, 4])
def test_staleness_formula_agrees_with_the_1f1b_oracle(pp, mode):
    """Paper §3.4: one round of 1F1B with weight stashing updates stage s
    with the gradient of the whole model evaluated at each stage's
    version after m − 2(S−1−s) updates (vertical: m − 2(S−1) for every
    stage).  The formula's loss_grad_fn runs the model at those versions
    and keeps the head current in exit order, as the oracle does."""
    R = 6
    spec, plan = _smoke(pp, mode, R)
    opt = SGDM(lr=0.05)
    state = reference_init_state(spec, plan, opt,
                                 torch.Generator().manual_seed(2))
    batch = _batches(spec, 1, R, 2, 8)[0]
    new_state, _ = reference_train_step(spec, plan, state, batch, opt)

    p = state["params"]
    st = tstage.make_statics(spec, plan, tokens_per_mb=16)
    embeds = tlm.embed_tokens(p["embed"], batch["tokens"])
    kw = [dict(positions=torch.arange(8).expand(2, 8),
               windows=p["layer_windows"][s], thetas=p["layer_thetas"][s])
          for s in range(pp)]
    head = {"h": p["head"], "f": p["final_norm"]}
    box = {"head": head, "opt": opt.init(head)}

    def loss_grad_fn(mixed, m):
        xs = [embeds[m]]
        with torch.no_grad():
            for s in range(pp):
                xs.append(tstage.stage_fwd(mixed[s], xs[-1], st, **kw[s]))
        _, g, dhead, dfn = tlm.loss_and_grads(
            box["head"]["h"], box["head"]["f"], xs[-1], batch["labels"][m],
            norm_kind=spec.norm, vocab=spec.vocab)
        box["head"], box["opt"] = opt.update({"h": dhead, "f": dfn},
                                             box["opt"], box["head"], 0)
        grads = [None] * pp
        for s in reversed(range(pp)):
            grads[s], g = tstage.stage_vjp(mixed[s], xs[s], st, g, 0.01,
                                           **kw[s])
        return grads

    init = [tstage.stage_params(p, s) for s in range(pp)]
    opt0 = [tree_map(lambda a, s=s: a[s], state["opt_stages"])
            for s in range(pp)]
    final, _ = staleness_formula_run(spec, plan, init, loss_grad_fn, opt,
                                     opt0, R, mode=mode)
    for s in range(pp):
        want = tstage.stage_params(new_state["params"], s)
        for a, b in zip(jax.tree.leaves(final[s]), jax.tree.leaves(want)):
            _close(a, b, 1e-6, 1e-5)
    for a, b in zip(jax.tree.leaves(box["head"]),
                    jax.tree.leaves({"h": new_state["params"]["head"],
                                     "f": new_state["params"]["final_norm"]})):
        _close(a, b, 1e-6, 1e-5)


def test_train_entry_point_prints_a_falling_loss():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-14b", "--smoke", "--steps", "3", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
        check=True).stdout
    assert re.search(r"schedule=1f1b .*predicted_bubble=0\.333", out), out
    a, b = map(float, re.search(r"loss ([\d.]+) -> ([\d.]+)", out).groups())
    assert b < a, out


def test_build_pipeline_raises_for_what_is_not_ported():
    spec, plan = _smoke(2, "stash")
    kw = dict(seq_len=8, global_batch=8, optimizer=SGDM(), device="cpu")
    # a stage cut over tensor ranks runs on a grid of ranks only
    with pytest.raises(ValueError, match="torchrun"):
        build_pipeline(spec, plan.with_(tp=2), **kw)
    with pytest.raises(ValueError, match="forward-only"):
        build_pipeline(spec, plan.with_(schedule="serve_interleaved"), **kw)
    with pytest.raises(ValueError, match="forward-only"):
        build_pipeline(spec, plan.with_(schedule="serve_1f"), **kw)
    with pytest.raises(ValueError):
        build_pipeline(spec, plan, **dict(kw, global_batch=6))


def test_train_state_from_numpy_carries_the_jax_state():
    from repro.core.reference import reference_init_state as jinit_state
    from repro.optim.optimizers import Adam as JAdam
    jspec = jconfigs.get("qwen3-14b").smoke_spec()
    jplan = JPlan(pp=2, tp=1, microbatches=2)
    js = jax.tree.map(np.asarray, jinit_state(jspec, jplan, JAdam(),
                                              jax.random.key(0)))
    ts = tinit.train_state_from_numpy(js, "cpu", torch.float32)
    assert ts["stash"]["current"] is ts["params"]["stages"]
    assert ts["step"] == 0 and sorted(ts["opt_stages"]) == ["m", "v"]
    np.testing.assert_array_equal(
        ts["stash"]["ring"]["layer_1"]["mlp"]["w2"].numpy(),
        js["stash"]["ring"]["layer_1"]["mlp"]["w2"])
    assert ts["stash"]["ring"]["layer_0"]["attn"]["wq"].shape[:2] == (3, 2)


@pytest.mark.parametrize("kernel", ["wkv6", "mamba_scan", "paged_attention"])
def test_kernels_without_a_backward_refuse_autograd(kernel):
    """The wrapper raises before it launches anything when an input
    requires grad (on the card the kernel's output would carry no
    gradient); the message names the autograd Function that trains
    through the kernel (wkv6, mamba_scan), or the later slice (paged)."""
    x = torch.zeros(1, 4, 2, 8, requires_grad=True)
    call = {"wkv6": lambda: twkv.wkv6(x, x, x, x, x[0, 0]),
            "mamba_scan": lambda: tms.mamba_scan(x[0], x[0], x[0, 0],
                                                 x[0], x[0], x[0, 0, 0]),
            "paged_attention": lambda: tpa.paged_attention(
                x[0], x, x, torch.zeros(1, 1, dtype=torch.int32),
                torch.ones(1, dtype=torch.int32))}[kernel]
    match = {"wkv6": "records no backward.*WKV6",
             "mamba_scan": "records no backward.*MambaScan",
             "paged_attention": "no backward.*later slice"}[kernel]
    with pytest.raises(RuntimeError, match=match):
        call()
