"""deepseek-moe-16b in the port (MHA at 16 / 16 heads; a MoE of 64 routed
experts top 6 plus two shared experts, one MLP of 2 x 1408 added to the
routed output) against the JAX package on the CPU in fp32 at its smoke
spec (tests/_torch_config_cases.py), the shared experts' leaves in the
tree, the statics and the tensor cut, and the smoke spec trained at tp 2
on two gloo ranks against tp 1."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_config_cases as C
import _torch_tp as T
from _torch_train_jax import one_torch_thread  # noqa: F401
from repro.core.reference import reference_init_state as j_init
from repro.models import init as jinit
from repro.models import nn as jnn
from repro.optim import optimizers as jopt
from repro.parallel.mesh import ParallelismPlan as JPlan
from repro_torch.core.reference import reference_train_step
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import init as tinit
from repro_torch.models import nn as tnn
from repro_torch.models import stage as tstage
from repro_torch.optim.optimizers import SGDM
from repro_torch.parallel.plan import ParallelismPlan as TPlan

ARCH = "deepseek-moe-16b"


def test_config_matches_jax():
    C.check_config(ARCH, ("deepseek-moe-16b", "deepseek_moe_16b"))
    full = C.tconfigs.get(ARCH).full_spec()
    m = full.moe
    assert (full.n_layers, full.n_heads, full.n_kv, full.d_head) == \
        (28, 16, 16, 128)
    assert (m.n_experts, m.top_k, m.d_expert, m.n_shared, m.d_shared) == \
        (64, 6, 1408, 2, 1408)
    assert {b.ffn for b in full.blocks} == {"moe"}


def test_shared_experts_are_an_mlp_of_the_jax_layout():
    """``moe.shared`` is drawn after the routed experts as an MLP of
    width n_shared x d_shared, with JAX's keys and shapes; the statics
    carry n_shared as JAX's do."""
    jspec, tspec = C.specs(ARCH)
    mine = tinit.init_params(tspec, TPlan(pp=2, tp=1),
                             torch.Generator().manual_seed(0), torch.float32)
    ref, _ = jinit.init_params(jspec, JPlan(pp=2, tp=1), jax.random.key(0),
                               jnp.float32)
    shapes = lambda t: jax.tree.map(lambda a: tuple(np.shape(a)),  # noqa
                                    t["stages"])
    assert shapes(mine) == shapes(jax.tree.map(np.asarray, ref))
    shared = mine["stages"]["layer_0"]["moe"]["shared"]
    ff = tspec.moe.n_shared * tspec.moe.d_shared
    assert tuple(shared["w1"].shape) == (2, tspec.d_model, ff)
    assert tuple(shared["w2"].shape) == (2, ff, tspec.d_model)
    for tokens in (24, 1):
        jst = jinit.moe_static(jspec, 1, tokens)
        tst = tstage.make_statics(tspec, TPlan(pp=2, tp=1),
                                  tokens_per_mb=tokens).moe
        assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
        assert tst.n_shared == 1


def test_moe_adds_the_shared_mlp_as_jax_does():
    """``nn.moe`` with shared experts on JAX's numpy weights: the output
    (routed + shared) and the aux loss equal JAX's; without the shared
    leaf's contribution they would not."""
    jspec, tspec = C.specs(ARCH)
    lp = C.jax_params(ARCH)["stages"]["layer_0"]["moe"]
    p1 = jax.tree.map(lambda a: a[0], lp)
    x = np.random.default_rng(4).standard_normal(
        (2, 6, jspec.d_model)).astype(np.float32)
    jst = jinit.moe_static(jspec, 1, 12)
    jout, jaux = jnn.moe(jax.tree.map(jnp.asarray, p1), jnp.asarray(x), jst,
                         "silu", None)
    tst = tnn.MoEStatic(**dataclasses.asdict(jst))
    tp = jax.tree.map(torch.from_numpy, p1)
    tout, taux = tnn.moe(tp, torch.from_numpy(x), tst, "silu")
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **C.FWD_TOL)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    routed, _ = tnn.moe({k: v for k, v in tp.items() if k != "shared"},
                        torch.from_numpy(x),
                        dataclasses.replace(tst, n_shared=0), "silu")
    assert not np.allclose(routed.numpy(), np.asarray(jout), atol=1e-3)


@pytest.mark.parametrize("pp", [1, 2])
def test_stage_forward_matches_jax(pp):
    got, want = C.full_transformer_pair(ARCH, pp)
    np.testing.assert_allclose(got, want, **C.FWD_TOL)


@pytest.mark.parametrize("page_size", [0, C.PAGE])
def test_engine_tokens_equal_the_jax_engine(page_size):
    C.check_engine(ARCH, page_size)


def test_tokens_depend_on_attention():
    C.check_tokens_depend_on_attention(ARCH)


def test_round_tracks_jax():
    C.check_round_tracks_jax(ARCH, 2)


@pytest.mark.parametrize("pp,schedule,mode,v", [
    (2, "1f1b", "stash", 1), (2, "interleaved", "flush", 2)])
def test_executor_equals_oracle_bit_for_bit(pp, schedule, mode, v):
    C.check_executor_equals_oracle(ARCH, pp, schedule, mode, v)


@pytest.mark.parametrize("pp,v", [(2, 1), (2, 2)])
def test_rank_draw_equals_the_whole_draws_rows(pp, v):
    whole = C.check_rank_draw(ARCH, pp, v)
    assert "shared" in whole["stages"]["layer_0"]["moe"]


def test_tp_axes_cut_the_shared_experts_as_an_mlp():
    """At tp 2 the shared MLP's w1 / w3 are cut by column and w2 by row
    (JAX's ``_mlp_init`` PartitionSpecs), the routed experts by expert;
    ``tp_shard`` gives each rank that block."""
    _, tspec = C.specs(ARCH)
    params = tinit.init_params(tspec, TPlan(pp=2, tp=1),
                               torch.Generator().manual_seed(1),
                               torch.float32)
    axes = tinit.tp_axes(params["stages"], tspec, 2)["layer_0"]["moe"]
    assert axes == {"router": -1, "w1": 1, "w2": 1, "w3": 1,
                    "shared": {"w1": 2, "w2": 1, "w3": 2}}
    for t in range(2):
        cut = tinit.tp_shard(params, tspec, TPlan(pp=2, tp=2), t)
        got = cut["stages"]["layer_0"]["moe"]["shared"]
        whole = params["stages"]["layer_0"]["moe"]["shared"]
        for leaf, ax in axes["shared"].items():
            assert torch.equal(got[leaf], whole[leaf].chunk(2, ax)[t])


def test_tp2_equals_tp1_on_two_gloo_ranks(tmp_path):
    """The smoke spec at pp 1 x tp 2 on two spawned gloo ranks (each with
    its cut of the shared MLP and its 4 of 8 experts), T.ROUNDS rounds
    of 1f1b / stash from one initial state: losses and each rank's state
    (weights, ring, momenta) within atol 5e-5 of its cut of the one-
    process tp 1 oracle's."""
    from _torch_dist_jax import flatten
    jspec, tspec = C.specs(ARCH)
    plan = T.case_plan(1, 2, "stash", "auto", 1, False)
    jplan = JPlan(pp=1, tp=1, microbatches=T.W.R, stash_mode="stash",
                  remat=True)
    init = jax.tree.map(np.asarray, j_init(
        jspec, jplan, jopt.SGDM(lr=0.05, momentum=0.9), jax.random.key(2),
        jnp.float32))
    np.savez(tmp_path / "init.npz", **flatten(init))
    ranks = T.run_port(tmp_path, tspec, plan, 1, str(tmp_path / "init.npz"))
    state = tinit.train_state_from_numpy(init, "cpu", torch.float32)
    src = SyntheticLM(tspec.vocab, T.W.SEQ, seed=1)
    losses = []
    for r in range(T.ROUNDS):
        b = src.round_batch(r, T.W.R, T.W.MB)
        state, m = reference_train_step(
            tspec, plan.with_(tp=1), state,
            {k: torch.from_numpy(v) for k, v in b.items()},
            SGDM(lr=0.05, momentum=0.9))
        losses.append(float(m["loss"]))
    ref = jax.tree.map(lambda t: t.numpy() if torch.is_tensor(t) else t,
                       state)
    for res in ranks:
        np.testing.assert_allclose(res["losses"], losses, **T.LOSS_TOL)
    for part in ("params", "stash", "opt_stages"):
        T.assert_rank_part_tracks(tspec, plan, 1, ranks, ref, part)
    cut = ranks[1]["state"]["params"]["stages"]["layer_0"]["moe"]
    assert cut["shared"]["w1"].shape[-1] == \
        tspec.moe.n_shared * tspec.moe.d_shared // 2
