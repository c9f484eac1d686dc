"""Tensor parallelism with the frontends: whisper-medium (an encoder
before the pipeline, cross-attention in every layer) and llava-next-34b
(a patch prefix) trained at their smoke specs on spawned gloo ranks of a
pp x tp grid, against one process at tp 1 from the same draw and the
same batches (the launcher's loader).  Every rank holds the whole
encoder and runs it; cross-attention's output sum leaves at
self-attention's site (JAX ``nn.py:280``), and its input's cotangent is
summed over the tensor group, so d(encoder output) is whole on every
tensor rank.  At pp 2 the stages' shares meet over the pipe group."""
import functools

import numpy as np
import pytest
import torch

import _torch_dist_worker as W
import _torch_tp as T
from _torch_train_jax import leaves, one_torch_thread  # noqa: F401
from repro_torch import configs
from repro_torch.core.pipeline import build_pipeline
from repro_torch.core.schedule import make_schedule
from repro_torch.core.versioning import rank_state
from repro_torch.launch.train import make_loader
from repro_torch.models.init import tp_axes
from repro_torch.optim.optimizers import SGDM
from repro_torch.parallel.dist import ProcessGrid

# tests/test_torch_tp_dense.py's tolerances
CASES = [("whisper-medium", 1, 2), ("whisper-medium", 2, 2),
         ("llava-next-34b", 1, 2)]


def _plan(arch, pp, tp):
    return configs.get(arch).SMOKE_PLAN.with_(pp=pp, tp=tp,
                                              microbatches=W.R)


@functools.lru_cache(maxsize=None)
def one_process(arch, pp):
    """The same rounds in one process at tp 1: (losses, state)."""
    spec = configs.get(arch).smoke_spec()
    n_patch = spec.n_patches if spec.frontend == "vision" else 0
    bundle = build_pipeline(spec, _plan(arch, pp, 1), seq_len=W.SEQ + n_patch,
                            global_batch=W.R * W.MB,
                            optimizer=SGDM(lr=0.05, momentum=0.9),
                            compute_dtype=torch.float32, device="cpu")
    state = bundle.init_state(torch.Generator().manual_seed(0))
    loader = make_loader(spec, bundle, 1)
    losses = []
    for r in range(T.ROUNDS):
        state, m = bundle.train_step(state, loader.get(r))
        losses.append(float(m["loss"]))
    return losses, state


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-pp{p}-tp{t}" for a, p, t in CASES])
def case(request, tmp_path_factory):
    arch, pp, tp = request.param
    tmp = tmp_path_factory.mktemp(f"tp_frontend_{arch}_{pp}{tp}")
    torch.set_num_threads(1)
    plan = _plan(arch, pp, tp)
    ranks = W.run_ranks(tmp, 1, pp, {"frontend_train": {
        "arch": arch, "plan": plan, "rounds": T.ROUNDS}}, tp=tp)
    return arch, plan, [r["frontend_train"] for r in ranks]


def test_losses_equal_tp1(case):
    arch, plan, ranks = case
    want, _ = one_process(arch, plan.pp)
    for res in ranks:
        np.testing.assert_allclose(res["losses"], want, **T.LOSS_TOL)


def test_rank_state_equals_tp1(case):
    """Every rank's state (its tensor shard of its stage's rows, ring and
    optimizer state; the whole encoder and its optimizer state) within
    5e-5 of the one-process state's part it holds."""
    arch, plan, ranks = case
    _, ref = one_process(arch, plan.pp)
    spec = configs.get(arch).smoke_spec()
    sched = make_schedule(plan)
    axes = tp_axes(ref["params"]["stages"], spec, plan.tp)
    grid = ProcessGrid(1, plan.pp, plan.tp)
    for rank, res in enumerate(ranks):
        _, s, t = grid.coords(rank)
        want = rank_state(ref, sched, s, tensor=(axes, t, plan.tp))
        got = {k: v for k, v in res["state"].items() if k != "step"}
        g, w = leaves(got), leaves({k: want[k] for k in got})
        assert [n for n, _ in g] == [n for n, _ in w], rank
        assert any(n.startswith("/params/encoder") for n, _ in g) == \
            (spec.encoder is not None)
        for (name, a), (_, b) in zip(g, w):
            if torch.is_tensor(a):
                np.testing.assert_allclose(a.numpy(), b.numpy(),
                                           err_msg=f"rank {rank} {name}",
                                           **T.PARAM_TOL)


def test_encoder_equal_across_ranks(case):
    """The encoder and its optimizer state are bit-identical on every
    rank of the grid."""
    arch, _, ranks = case
    if configs.get(arch).smoke_spec().encoder is None:
        assert all("encoder" not in r["state"]["params"] for r in ranks)
        return
    first = leaves({k: ranks[0]["state"][k] for k in ("opt_encoder",)})
    first += leaves(ranks[0]["state"]["params"]["encoder"])
    for res in ranks[1:]:
        other = leaves({k: res["state"][k] for k in ("opt_encoder",)})
        other += leaves(res["state"]["params"]["encoder"])
        for (name, a), (_, b) in zip(first, other):
            assert torch.equal(a, b), name
