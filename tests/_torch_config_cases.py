"""Shared by tests/test_torch_{olmoe,deepseek,chatglm3,whisper,llava}.py:
one config of
the port held against the JAX package's on the CPU in fp32 at its smoke
spec — the config itself, ``full_transformer`` (every stage's forward),
the served tokens against the JAX engine's, one training round against
JAX's ``reference_train_step``, the executor against the port's oracle
bit for bit, and the row-wise draw against the whole one.

MoE specs route every token to every expert (``top_k = n_experts``):
the capacity rule (ceil(1.25·T·k / E)) then holds every pair, so JAX's
MoE scatter fault at overflow (ROADMAP Queue 3) cannot show.  The engine
weights are JAX's init rescaled as tests/test_torch_engine.py does
(embedding x0.05, attention and cross-attention outputs x40, FFN
outputs x10), so that tokens depend on attention.  A frontend's inputs
(patches, frames) come from numpy seeds and go to both packages."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_train_jax import (LOSS_ATOL, PARAM_TOL, assert_trees_close,
                              frontend_batch, leaves, run_both)
from repro import configs as jconfigs
from repro.launch.mesh import make_host_mesh
from repro.models import init as jinit
from repro.models import stage as jstage
from repro.parallel.mesh import ParallelismPlan as JPlan
from repro.parallel.mesh import split_model_axis
from repro.serving.engine import build_serving as jax_build_serving
from repro_torch import configs as tconfigs
from repro_torch.core.pipeline import build_pipeline
from repro_torch.core.reference import (model_plan, reference_init_state,
                                        reference_train_step,
                                        to_storage_order)
from repro_torch.core.schedule import make_schedule
from repro_torch.core.versioning import rank_params
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import init as tinit
from repro_torch.models import stage as tstage
from repro_torch.optim.optimizers import SGDM
from repro_torch.parallel.plan import ParallelismPlan as TPlan
from repro_torch.serving.batcher import ContinuousBatchingSession, Request
from repro_torch.serving.engine import build_serving

R, ROWS, PREFILL, N_DEC, CACHE, PAGE = 2, 2, 12, 6, 32, 16
FWD_TOL = dict(atol=2e-5, rtol=1e-4)       # fp32, tests/test_kernels.py


def route_all(spec):
    """``spec`` with every token routed to every expert (no overflow)."""
    if spec.moe is None:
        return spec
    return dataclasses.replace(spec, moe=dataclasses.replace(
        spec.moe, top_k=spec.moe.n_experts))


def specs(arch):
    return (route_all(jconfigs.get(arch).smoke_spec()),
            route_all(tconfigs.get(arch).smoke_spec()))


def check_config(arch, aliases):
    """Specs, plans and optimizer equal the JAX config's field for field;
    every alias resolves to the module."""
    j, t = jconfigs.get(arch), tconfigs.get(arch)
    for fn in ("full_spec", "smoke_spec"):
        assert dataclasses.asdict(getattr(t, fn)()) == \
            dataclasses.asdict(getattr(j, fn)())
    for plan in ("PLAN", "SMOKE_PLAN", "INTERLEAVED_PLAN"):
        assert hasattr(t, plan) == hasattr(j, plan), plan
        if hasattr(j, plan):
            assert dataclasses.asdict(getattr(t, plan)) == \
                dataclasses.asdict(getattr(j, plan))
    assert t.OPTIMIZER == j.OPTIMIZER
    for alias in aliases:
        assert tconfigs.get(alias) is t


@functools.lru_cache(maxsize=None)
def jax_params(arch, pp=1, seed=7):
    """JAX-initialized numpy weights of the smoke spec, rescaled."""
    jspec, _ = specs(arch)
    params, _ = jinit.init_params(jspec, JPlan(pp=pp, tp=1),
                                  jax.random.key(seed), jnp.float32)
    params = jax.tree.map(lambda a: np.array(a), params)
    params["embed"] *= 0.05
    for lp in params["stages"].values():
        lp["attn"]["wo"] *= 40.0
        if "xattn" in lp:
            lp["xattn"]["wo"] *= 40.0
        ffn = lp.get("mlp") or lp["moe"]
        ffn["w2"] *= 10.0
        if "shared" in ffn:
            ffn["shared"]["w2"] *= 10.0
    return params


def cross_input(spec, b, seed):
    """An encoder output (b, T_src, d) for an encoder-decoder spec, from
    a numpy seed; None for other specs."""
    if spec.encoder is None:
        return None
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, spec.encoder.source_len, spec.d_model)
                               ).astype(np.float32)


def full_transformer_pair(arch, pp):
    """(port, JAX) ``full_transformer`` hidden states of a (2, 24) input
    through every stage of the smoke spec at ``pp`` (cross-attending
    into one numpy encoder output where the spec has an encoder)."""
    jspec, tspec = specs(arch)
    params = jax_params(arch, pp)
    b, s = 2, 24
    rng = np.random.default_rng(pp)
    x = rng.standard_normal((b, s, jspec.d_model)).astype(np.float32)
    cx = cross_input(tspec, b, 10 + pp)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    jst = jstage.make_statics(jspec, JPlan(pp=pp, tp=1), tokens_per_mb=b * s)
    want = jax.jit(lambda w, x_, c_: jstage.full_transformer(
        w, x_, jst, positions=jnp.asarray(pos), cross_x=c_)[0])(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x),
            None if cx is None else jnp.asarray(cx))
    tst = tstage.make_statics(tspec, TPlan(pp=pp, tp=1), tokens_per_mb=b * s)
    tp = tinit.params_from_numpy(params, "cpu", torch.float32)
    got = tstage.full_transformer(
        tp, torch.from_numpy(x), tst, positions=torch.from_numpy(pos),
        cross_x=None if cx is None else torch.from_numpy(cx))
    return got.numpy(), np.asarray(want)


def prompts(vocab, seed=0, width=PREFILL):
    return np.random.default_rng(seed).integers(
        1, vocab, (R, ROWS, width)).astype(np.int32)


def prompt_batch(spec, seed=0):
    """A prefill batch of R slots: PREFILL positions a row (a VLM's patch
    prefix, then text), tokens and the frontend's inputs from numpy
    seeds."""
    text = PREFILL - (spec.n_patches if spec.frontend == "vision" else 0)
    out = {"tokens": prompts(spec.vocab, seed, text)}
    out.update(frontend_batch(spec, seed, R, ROWS, seed=seed + 3))
    return out


@functools.lru_cache(maxsize=None)
def jax_engine(arch, page_size):
    """The JAX engine (pp 1, ``serve_1f``) on the rescaled weights: the
    tokens of a 12-token prefill and N_DEC decodes, and the positions."""
    jspec, _ = specs(arch)
    mesh = split_model_axis(make_host_mesh(data=1, model=1), 1, 1)
    jplan = JPlan(pp=1, tp=1, microbatches=R, decode_microbatches=R,
                  schedule="serve_1f")
    js = jax_build_serving(jspec, jplan, mesh, cache_len=CACHE,
                           global_batch=R * ROWS, prefill_len=PREFILL,
                           compute_dtype=jnp.float32, page_size=page_size)
    js.start(jax.random.key(0))
    js.load_params(jax_params(arch))
    batch = {k: jnp.asarray(v) for k, v in prompt_batch(specs(arch)[1]).items()}
    nxt = js.prefill(batch)
    toks = [np.asarray(nxt)]
    for _ in range(N_DEC):
        nxt = js.decode(nxt)
        toks.append(np.asarray(nxt))
    return np.stack(toks), np.asarray(js.state["pos"]), js


def port_engine(arch, params, page_size, pp=1, v=1):
    """The port's engine on ``params`` (in the plan's storage order): the
    tokens of the same prefill and decodes, and the session."""
    _, tspec = specs(arch)
    plan = TPlan(pp=pp, tp=1, decode_microbatches=R)
    if v > 1:
        plan = plan.with_(schedule="serve_interleaved", virtual_stages=v)
    sess = build_serving(tspec, plan, cache_len=CACHE,
                         global_batch=R * ROWS, compute_dtype=torch.float32,
                         page_size=page_size, prefill_len=PREFILL,
                         device="cpu").start()
    sess.load_params(params)
    nxt = sess.prefill(prompt_batch(tspec))
    toks = [nxt.numpy()]
    for _ in range(N_DEC):
        nxt = sess.decode(nxt)
        toks.append(nxt.numpy())
    return np.stack(toks), sess


def check_engine(arch, page_size):
    want, pos, _ = jax_engine(arch, page_size)
    got, sess = port_engine(arch, jax_params(arch), page_size)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sess._pos, pos)
    return sess


def check_tokens_depend_on_attention(arch):
    """Flipping one attention weight changes the served tokens."""
    params = jax_params(arch)
    base, _ = port_engine(arch, params, PAGE)
    bumped = jax.tree.map(np.copy, params)
    bumped["stages"]["layer_1"]["attn"]["wv"] *= -1.0
    other, _ = port_engine(arch, bumped, PAGE)
    assert (base != other).any()


run = functools.lru_cache(maxsize=None)(run_both)


def check_round_tracks_jax(arch, pp):
    """One round of the smoke spec (1f1b / stash, R 4, seq 12, SGD with
    momentum) from JAX's initial state: the loss within 5e-5, parameters,
    momenta and the ring within atol 2e-5 / rtol 1e-3."""
    j, t = run("stash", pp, arch=arch, spec_fn=route_all, rounds=1)
    for a, b in zip(t["losses"], j["losses"]):
        assert abs(a - b) <= LOSS_ATOL, (t["losses"], j["losses"])
    assert_trees_close(t["state"]["params"], j["state"]["params"],
                       *PARAM_TOL)
    for key in ("opt_stages", "opt_head", "opt_embed", "opt_encoder"):
        assert (key in t["state"]) == (key in j["state"]), key
        if key in j["state"]:
            assert_trees_close(t["state"][key], j["state"][key], *PARAM_TOL)
    if "ring" in j["state"]["stash"]:
        assert_trees_close(t["state"]["stash"]["ring"],
                           j["state"]["stash"]["ring"], *PARAM_TOL)


def check_executor_equals_oracle(arch, pp, schedule="1f1b", mode="stash",
                                 v=1):
    """Two rounds of the executor against the port's oracle: losses and
    every state tensor bit for bit."""
    _, spec = specs(arch)
    plan = tconfigs.get(arch).SMOKE_PLAN.with_(
        pp=pp, microbatches=4, schedule=schedule, stash_mode=mode,
        virtual_stages=v)
    opt = SGDM(lr=0.05)
    n_patch = spec.n_patches if spec.frontend == "vision" else 0
    bundle = build_pipeline(spec, plan, seq_len=12 + n_patch, global_batch=8,
                            optimizer=opt, compute_dtype=torch.float32,
                            device="cpu")
    state = bundle.init_state(torch.Generator().manual_seed(0))
    ref = reference_init_state(spec, plan, opt,
                               torch.Generator().manual_seed(0))
    src = SyntheticLM(spec.vocab, 12, seed=5)
    for r in range(2):
        host = src.round_batch(r, 4, 2)
        host.update(frontend_batch(spec, r, 4, 2))
        batch = {k: torch.from_numpy(a) for k, a in host.items()}
        state, em = bundle.train_step(state, batch)
        ref, om = reference_train_step(spec, plan, ref, batch, opt)
        assert torch.equal(em["loss"], om["loss"])
    got, want = leaves(state), leaves(ref)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), name


def check_rank_draw(arch, pp, v):
    """``init_rank_params`` of every stage equals that stage's rows of
    the whole draw (``init_params`` in storage order), bit for bit."""
    _, spec = specs(arch)
    plan = tconfigs.get(arch).SMOKE_PLAN.with_(
        pp=pp, microbatches=4, virtual_stages=v,
        schedule="interleaved" if v > 1 else "1f1b",
        stash_mode="flush" if v > 1 else "stash")
    sched = make_schedule(plan)
    mplan = model_plan(plan, sched)
    whole = to_storage_order(
        tinit.init_params(spec, mplan, torch.Generator().manual_seed(3),
                          torch.float32), sched)
    for s in range(pp):
        got = tinit.init_rank_params(spec, mplan,
                                     torch.Generator().manual_seed(3),
                                     sched, s, torch.float32)
        want = rank_params(whole, sched, s)
        g, w = leaves(got), leaves(want)
        assert [n for n, _ in g] == [n for n, _ in w]
        for (name, a), (_, b) in zip(g, w):
            assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), \
                (s, name)
    return whole


def check_batcher_passes_inputs(arch):
    """The batcher over R x ROWS requests that carry the frontend's
    inputs (patches or frames) serves each request the tokens of the
    one-shot prefill and decodes of the same batch; a request without
    them is refused."""
    _, tspec = specs(arch)
    params = jax_params(arch)
    want, _ = port_engine(arch, params, PAGE)
    batch = prompt_batch(tspec)
    extra = [k for k in batch if k != "tokens"]
    reqs = [Request(rid=m * ROWS + lane, prompt=batch["tokens"][m, lane],
                    max_new_tokens=N_DEC + 1,
                    inputs={k: batch[k][m, lane] for k in extra})
            for m in range(R) for lane in range(ROWS)]
    sess = build_serving(tspec, TPlan(pp=1, tp=1, decode_microbatches=R),
                         cache_len=CACHE, global_batch=R * ROWS,
                         compute_dtype=torch.float32, page_size=PAGE,
                         prefill_len=PREFILL, device="cpu").start()
    sess.load_params(params)
    report = ContinuousBatchingSession(sess).run(reqs)
    for r in report.requests:
        assert r.tokens == want[:, r.rid].tolist(), r.rid
    bare = Request(rid=0, prompt=batch["tokens"][0, 0], max_new_tokens=2)
    try:
        ContinuousBatchingSession(sess.reset_state()).run([bare])
    except ValueError as e:
        assert "inputs" in str(e)
    else:
        raise AssertionError("a request without the frontend's inputs ran")
