"""whisper-medium in the port (an encoder before the pipeline,
cross-attention in every decoder layer, 16 / 16 heads of 64 at full
width) against the JAX package on the CPU in fp32 at its smoke spec:
tests/_torch_config_cases.py, and the encoder's pieces one by one."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_config_cases as C
from _torch_train_jax import leaves, one_torch_thread  # noqa: F401
from repro.data.pipeline import ShardedLoader
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import nn as jnn
from repro.models import stage as jstage
from repro.models.init import attn_static as j_attn_static
from repro_torch.core.pipeline import build_pipeline
from repro_torch.data.pipeline import Loader, SyntheticLM, frames_stub
from repro_torch.launch import train as tlaunch
from repro_torch.models import init as tinit
from repro_torch.models import nn as tnn
from repro_torch.models import stage as tstage
from repro_torch.optim.optimizers import SGDM
from repro_torch.runtime.driver import DriverConfig, TrainDriver

ARCH = "whisper-medium"
B, S = 2, 10


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_config_matches_jax():
    C.check_config(ARCH, ("whisper-medium", "whisper_medium"))
    j, t = C.jconfigs.get(ARCH), C.tconfigs.get(ARCH)
    assert t.SOURCE_LEN == j.SOURCE_LEN == 1500
    full = t.full_spec()
    assert (full.n_heads, full.n_kv, full.d_head, full.encoder.n_layers) \
        == (16, 16, 64, 24)


def test_encoder_fwd_matches_jax():
    """The encoder (learned positions, non-causal attention rotated at θ
    1e4, tanh-GELU MLP, zero-bias layernorms) on numpy frames."""
    jspec, tspec = C.specs(ARCH)
    enc = C.jax_params(ARCH)["encoder"]
    frames = C.cross_input(tspec, B, 3)
    want = jstage.encoder_fwd(_jnp(enc), jnp.asarray(frames), jspec)
    got = tstage.encoder_fwd({k: _torch(v) for k, v in enc.items()},
                             _torch(frames), tspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **C.FWD_TOL)


def _xattn_inputs():
    jspec, tspec = C.specs(ARCH)
    lp = C.jax_params(ARCH)["stages"]["layer_0"]
    p = {k: v[0] for k, v in lp["xattn"].items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, jspec.d_model)).astype(np.float32)
    cx = C.cross_input(tspec, B, 6)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    return jspec, tspec, p, x, cx, pos


def test_cross_attention_matches_jax():
    """``attention(cross_x=)``: K / V from the encoder output, no RoPE,
    every key seen."""
    jspec, tspec, p, x, cx, pos = _xattn_inputs()
    want, _ = jnn.attention(
        _jnp(p), jnp.asarray(x), j_attn_static(jspec, 1, causal=False),
        positions=jnp.asarray(pos), window=jnp.int32(-1),
        theta=jnp.float32(1e4), tp_axis=None, cross_x=jnp.asarray(cx))
    got = tnn.attention({k: _torch(v) for k, v in p.items()}, _torch(x),
                        tinit.attn_static(tspec, 1, causal=False),
                        positions=torch.from_numpy(pos), window=-1,
                        theta=1e4, cross_x=_torch(cx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **C.FWD_TOL)


def test_stage_vjp_cross_grad_matches_jax():
    """``stage_vjp``'s (dW, dx, d(cross_x)) against ``jax.vjp`` of JAX's
    ``stage_fwd`` over one stage of the pp-2 smoke model."""
    jspec, tspec = C.specs(ARCH)
    params = C.jax_params(ARCH, 2)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, S, jspec.d_model)).astype(np.float32)
    g = rng.standard_normal((B, S, jspec.d_model)).astype(np.float32)
    cx = C.cross_input(tspec, B, 9)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jst = jstage.make_statics(jspec, C.JPlan(pp=2, tp=1),
                              tokens_per_mb=B * S)
    w1 = jax.tree.map(lambda a: jnp.asarray(a[1:2]), params["stages"])

    def f(w, x_, c_):
        return jstage.stage_fwd(
            w, x_, jst, positions=jnp.asarray(pos),
            windows=jnp.asarray(params["layer_windows"][1]),
            thetas=jnp.asarray(params["layer_thetas"][1]), tp_axis=None,
            cross_x=c_)[0]

    jdw, jdx, jdc = jax.jit(lambda *a: jax.vjp(f, *a)[1](jnp.asarray(g)))(
        w1, jnp.asarray(x), jnp.asarray(cx))
    tst = tstage.make_statics(tspec, C.TPlan(pp=2, tp=1),
                              tokens_per_mb=B * S)
    tp = tinit.params_from_numpy(params, "cpu", torch.float32)
    dw, dx, dc = tstage.stage_vjp(
        tstage.stage_params(tp, 1), _torch(x), tst, _torch(g), 0.0,
        positions=torch.from_numpy(pos), windows=tp["layer_windows"][1],
        thetas=tp["layer_thetas"][1], cross_x=_torch(cx))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **C.FWD_TOL)
    np.testing.assert_allclose(dc.numpy(), np.asarray(jdc), **C.FWD_TOL)
    got = leaves(dw)
    want = leaves(jax.tree.map(lambda a: np.asarray(a)[0], jdw))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert any("xattn" in n for n, _ in got)
    for (name, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **C.FWD_TOL)


@pytest.mark.parametrize("pp", [1, 2])
def test_stage_forward_matches_jax(pp):
    got, want = C.full_transformer_pair(ARCH, pp)
    np.testing.assert_allclose(got, want, **C.FWD_TOL)


@pytest.mark.parametrize("page_size", [0, C.PAGE])
def test_engine_tokens_equal_the_jax_engine(page_size):
    """Tokens and each slot's encoder output; then (paged) slot 0 reset
    and the slots swapped (``reset_slots`` / ``compact_slots``), a new
    request admitted into the freed slot and two decodes, in both
    engines."""
    sess = C.check_engine(ARCH, page_size)
    served, _, js = C.jax_engine(ARCH, page_size)
    np.testing.assert_allclose(sess.enc_out.numpy(),
                               np.asarray(js.state["enc_out"]), **C.FWD_TOL)
    if not page_size:
        return
    _, tspec = C.specs(ARCH)
    free, admit = np.array([1, 0], np.int32), np.array([0, 1], np.int32)
    perm = np.array([1, 0], np.int32)
    batch = C.prompt_batch(tspec, seed=4)
    runs = []
    for eng, conv in ((sess, lambda a: a), (js, jnp.asarray)):
        eng.reset_slots(conv(free))
        eng.compact_slots(conv(perm))
        enc = sess.enc_out if eng is sess else js.state["enc_out"]
        np.testing.assert_array_equal(np.asarray(enc)[1], 0.0)
        first = np.asarray(eng.write_prefill_into_slots(
            {k: conv(v) for k, v in batch.items()}, conv(admit)))
        # slot 0 (the old slot 1) goes on from its last served token,
        # slot 1 from its admission's first token
        nxt = served[-1].reshape(C.R, C.ROWS)[perm]
        nxt[1] = first.reshape(C.R, C.ROWS)[1]
        toks = [nxt.reshape(-1)]
        for _ in range(2):
            toks.append(np.asarray(eng.decode(conv(toks[-1]))))
        runs.append(np.stack(toks))
    np.testing.assert_allclose(sess.enc_out.numpy(),
                               np.asarray(js.state["enc_out"]), **C.FWD_TOL)
    np.testing.assert_array_equal(runs[0], runs[1])


def test_batcher_passes_the_frontend_inputs():
    C.check_batcher_passes_inputs(ARCH)


def test_round_tracks_jax():
    C.check_round_tracks_jax(ARCH, 2)


@pytest.mark.parametrize("schedule,mode,v", [("1f1b", "stash", 1),
                                             ("interleaved", "flush", 2)])
def test_executor_equals_oracle_bit_for_bit(schedule, mode, v):
    C.check_executor_equals_oracle(ARCH, 2, schedule, mode, v)


def test_rank_draw_equals_the_whole_draws_rows():
    whole = C.check_rank_draw(ARCH, 2, 1)
    assert whole["encoder"]["pos"].shape == (16, 64)


def _driver(tmp_path, hook=None):
    _, spec = C.specs(ARCH)
    plan = C.tconfigs.get(ARCH).SMOKE_PLAN.with_(microbatches=4)
    bundle = build_pipeline(spec, plan, seq_len=12, global_batch=8,
                            optimizer=SGDM(lr=0.05),
                            compute_dtype=torch.float32, device="cpu")
    loader = tlaunch.make_loader(spec, bundle, 0)
    driver = TrainDriver(bundle, loader, str(tmp_path),
                         DriverConfig(checkpoint_every=2), failure_hook=hook)
    return driver, bundle.init_state(torch.Generator().manual_seed(0))


def test_train_driver_restart_replays_to_the_bit(tmp_path):
    """A failure at round 3 restores round 2's checkpoint (the encoder in
    shared.npz, its optimizer state in opt.npz) and replays: losses and
    the final state equal the uninterrupted run's bit for bit."""
    driver, state = _driver(tmp_path / "a")
    ref, _ = driver.run(state, 4)
    ref_losses = [m["loss"] for m in driver.metrics_log]
    armed = [True]

    def hook(step):
        if step == 3 and armed[0]:
            armed[0] = False
            raise RuntimeError("simulated node failure")

    driver, state = _driver(tmp_path / "b", hook)
    got, step = driver.run(state, 4)
    assert step == 4 and not armed[0]
    assert [m["loss"] for m in driver.metrics_log][-2:] == ref_losses[2:]
    rnd = tmp_path / "b" / "round_00000002"
    assert "encoder/pos" in np.load(rnd / "shared.npz").files
    assert any(k.startswith("opt_encoder/") and k.endswith("/pos")
               for k in np.load(rnd / "opt.npz").files)
    g, w = leaves(got), leaves(ref)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), name


@functools.lru_cache(maxsize=None)
def _jax_batch_specs():
    from repro.configs import whisper_medium
    spec = whisper_medium.smoke_spec()
    dev = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    e = spec.encoder
    return spec, {
        "tokens": jax.ShapeDtypeStruct((2, 2, 8), jnp.int32, sharding=dev),
        "labels": jax.ShapeDtypeStruct((2, 2, 8), jnp.int32, sharding=dev),
        "frames": jax.ShapeDtypeStruct((2, 2, e.source_len, e.d_model),
                                       jnp.float32, sharding=dev)}


def test_jax_sharded_loader_fault_and_the_port_trains_whisper():
    """JAX's launcher builds ``ShardedLoader`` without an ``extra_fn`` for
    an audio model (``launch/train.py:126``), and ``get`` asks the
    default ``{}`` for ``frames``: KeyError (ROADMAP Queue 3).  The
    port's loader fills ``frames`` from its stub, and its launcher
    trains whisper."""
    spec, shapes = _jax_batch_specs()
    loader = ShardedLoader(JSyntheticLM(spec.vocab, 8), shapes)
    with pytest.raises(KeyError, match="frames"):
        loader.get(0)
    tspec = C.tconfigs.get(ARCH).smoke_spec()
    e = tspec.encoder
    got = Loader(SyntheticLM(tspec.vocab, 8), 2, 2, "cpu",
                 extra_fn=frames_stub(e.d_model),
                 extra_shapes={"frames": (2, 2, e.source_len, e.d_model)}
                 ).get(0)
    assert got["frames"].shape == (2, 2, e.source_len, e.d_model)
    losses = tlaunch.main(["--arch", ARCH, "--smoke", "--steps", "2",
                           "--device", "cpu", "--microbatches", "2"])
    assert len(losses) == 2 and np.isfinite(losses).all()
