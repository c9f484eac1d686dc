"""Training rounds of the recurrent block kinds (rwkv6's time-mix, jamba's
Mamba mixer and MoE) in the port, on the CPU, where every WKV and
selective scan runs the plain forward and the plain backward
(``WKV6`` / ``MambaScan``, what the CUDA kernels compute on a card).

- rwkv6's smoke spec in its config's mode (1f1b / stash, pp 2) tracks
  JAX's ``reference_train_step`` over 3 rounds: losses within 5e-5, the
  parameters, SGD momenta and the weight-version ring within atol 2e-5 /
  rtol 1e-3 (jamba against JAX: tests/test_torch_train_jamba*.py).
- For both archs, the executor (core/pipeline.py) equals the port's
  sequential oracle bit for bit in all six training schedules (pp 2;
  jamba's interleaved ones at pp 1 x v 2: a model chunk must hold whole
  attention periods of 4 layers, and its smoke spec has 8), and gpipe /
  flush at pp 2 equals pp 1 (the same update of the same model, its
  layers cut into two stages).
- The launcher trains both, and sizes jamba's expert capacity from a
  microbatch's tokens.
"""
import functools
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _torch_train_jax import (LOSS_ATOL, PARAM_TOL,  # noqa: F401
                              assert_trees_close, leaves, one_torch_thread,
                              run_both)
from repro_torch import configs as tconfigs
from repro_torch.core.pipeline import build_pipeline
from repro_torch.core.reference import (reference_init_state,
                                        reference_train_step)
from repro_torch.core.versioning import make_train_state
from repro_torch.models.init import init_params
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim import SGDM
from repro_torch.optim.optimizers import tree_map

ARCHS = ["rwkv6-1.6b", "jamba-v0.1-52b"]
# (schedule, stash mode, virtual stages): the six training schedules
SCHEDULES = [("1f1b", "stash", 1), ("1f1b", "vertical", 1),
             ("gpipe", "flush", 1), ("gpipe", "2bw", 1),
             ("interleaved", "flush", 2), ("interleaved_async", "stash", 2)]
R, BMB, SEQ = 4, 2, 12
ROOT = Path(__file__).resolve().parents[1]

run = functools.lru_cache(maxsize=None)(run_both)


def test_rwkv6_round_tracks_jax():
    j, t = run("stash", 2, arch="rwkv6-1.6b")
    assert len(t["losses"]) == 3
    for a, b in zip(t["losses"], j["losses"]):
        assert abs(a - b) <= LOSS_ATOL, (t["losses"], j["losses"])
    for key in ("params", "opt_stages", "opt_head", "opt_embed"):
        assert_trees_close(t["state"][key], j["state"][key], *PARAM_TOL)
    assert_trees_close(t["state"]["stash"]["ring"],
                       j["state"]["stash"]["ring"], *PARAM_TOL)
    assert t["state"]["step"] == int(j["state"]["step"]) == 3


def _batches(spec, rounds):
    src = SyntheticLM(spec.vocab, SEQ, seed=5)
    return [{k: torch.from_numpy(v) for k, v in
             src.round_batch(r, R, BMB).items()} for r in range(rounds)]


def _executor(spec, plan, opt, batches, state=None):
    bundle = build_pipeline(spec, plan, seq_len=SEQ, global_batch=R * BMB,
                            optimizer=opt, compute_dtype=torch.float32,
                            device="cpu")
    if state is None:
        state = bundle.init_state(torch.Generator().manual_seed(0))
    else:
        state = make_train_state(state, bundle.sched, opt)
    losses = []
    for batch in batches:
        state, m = bundle.train_step(state, batch)
        losses.append(m["loss"])
    return state, losses


@pytest.mark.parametrize("schedule,mode,v", SCHEDULES)
@pytest.mark.parametrize("arch", ARCHS)
def test_executor_equals_oracle_bit_for_bit(arch, schedule, mode, v):
    cfg = tconfigs.get(arch)
    spec = cfg.smoke_spec()
    pp = 1 if arch.startswith("jamba") and v > 1 else 2
    plan = cfg.SMOKE_PLAN.with_(pp=pp, microbatches=R, stash_mode=mode,
                                schedule=schedule, virtual_stages=v)
    opt = SGDM(lr=0.05)
    batches = _batches(spec, 2)
    state, e_losses = _executor(spec, plan, opt, batches)
    ref = reference_init_state(spec, plan, opt,
                               torch.Generator().manual_seed(0))
    for batch, e_loss in zip(batches, e_losses):
        ref, m = reference_train_step(spec, plan, ref, batch, opt)
        assert torch.equal(e_loss, m["loss"])
        assert torch.isfinite(m["loss"])
    got, want = leaves(state), leaves(ref)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), name


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.cat(trees)


def _restack(params, n_layers, pp):
    """pp 1's parameters with their layers cut into ``pp`` stage rows."""
    lps = n_layers // pp
    out = tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, params)
    out["stages"] = {f"layer_{i}": _stack([
        params["stages"][f"layer_{s * lps + i}"] for s in range(pp)])
        for i in range(lps)}
    for key in ("layer_windows", "layer_thetas"):
        flat = params[key][0]
        out[key] = [flat[s * lps:(s + 1) * lps] for s in range(pp)]
    return out


def _by_layer(stages, lps):
    """{global layer: {leaf path: tensor}} of a stage-stacked tree with
    ``lps`` layers a stage."""
    out = {}
    for name, t in leaves(stages):
        layer, rest = name.split("/", 2)[1:]
        i = int(layer.split("_")[1])
        for s in range(t.shape[0]):
            out.setdefault(s * lps + i, {})[rest] = t[s]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_pp2_equals_pp1(arch):
    """gpipe / flush makes one update a round from the summed gradients of
    the same model: from pp 1's weights cut into two stages, pp 2's
    losses and every layer's parameters and momenta equal pp 1's bit for
    bit."""
    cfg = tconfigs.get(arch)
    spec = cfg.smoke_spec()
    opt = SGDM(lr=0.05)
    batches = _batches(spec, 2)
    plans = [cfg.SMOKE_PLAN.with_(pp=pp, microbatches=R, stash_mode="flush",
                                  schedule="gpipe") for pp in (1, 2)]
    params = init_params(spec, plans[0], torch.Generator().manual_seed(0),
                         torch.float32)
    # the executor updates its state in place: each run gets its own copy
    runs = [_executor(spec, plans[0], opt, batches, tree_map(
                lambda t: t.clone() if torch.is_tensor(t) else t, params)),
            _executor(spec, plans[1], opt, batches,
                      _restack(params, spec.n_layers, 2))]
    (s1, l1), (s2, l2) = runs
    assert all(torch.equal(a, b) for a, b in zip(l1, l2)), (l1, l2)
    n = spec.n_layers
    pairs = [("params", s1["params"]["stages"], s2["params"]["stages"])]
    pairs += [(k, s1["opt_stages"][k], s2["opt_stages"][k])
              for k in s1["opt_stages"]]              # SGD's momenta
    for key, t1, t2 in pairs:
        a, b = _by_layer(t1, n), _by_layer(t2, n // 2)
        assert sorted(a) == sorted(b) == list(range(n))
        for i in range(n):
            assert sorted(a[i]) == sorted(b[i])
            for name in a[i]:
                assert torch.equal(a[i][name], b[i][name]), (key, i, name)
    for key in ("embed", "head", "final_norm"):
        for (name, a), (_, b) in zip(leaves(s1["params"][key]),
                                     leaves(s2["params"][key])):
            assert torch.equal(a, b), (key, name)


@pytest.mark.parametrize("arch,sched", [("rwkv6-1.6b", "1f1b"),
                                        ("jamba-v0.1-52b", "gpipe")])
def test_train_entry_point_trains_the_recurrent_archs(arch, sched):
    """launch/train.py on the CPU: the config's plan and a falling loss."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--steps", "3", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
        check=True).stdout
    assert re.search(rf"plan: pp=2 tp=1 schedule={sched} ", out), out
    a, b = map(float, re.search(r"loss ([\d.]+) -> ([\d.]+)", out).groups())
    assert b < a, out


def test_moe_capacity_comes_from_the_microbatch_tokens():
    """The launcher's build sizes jamba's expert capacity from a
    microbatch's rows x seq (JAX's rule, at least 4)."""
    from repro_torch.launch import train
    args = train.parser().parse_args(
        ["--arch", "jamba-v0.1-52b", "--smoke", "--device", "cpu",
         "--seq-len", "32", "--global-batch", "8", "--microbatches", "4"])
    spec, bundle = train.build(args)
    tokens = bundle.microbatch_size * 32
    assert tokens == 64
    assert bundle.statics.moe.capacity == math.ceil(
        tokens * spec.moe.top_k / spec.moe.n_experts * 1.25) == 40
