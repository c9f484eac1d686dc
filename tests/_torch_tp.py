"""Shared by tests/test_torch_tp_*.py: JAX's tensor-parallel cases run in
a subprocess (tests/_torch_dist_jax.py: JAX's SPMD pipeline on a (data,
pp, tp) mesh and JAX's sequential oracle from the same initial state),
the port on spawned gloo ranks of the same grid from that state, and
the checks that hold the port to the oracle."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

import _torch_dist_worker as W
from _torch_train_jax import leaves
from repro_torch.core.schedule import make_schedule
from repro_torch.core.versioning import rank_state, tensor_cut, zero1_axes
from repro_torch.models import spec as tspec
from repro_torch.models.init import padded_vocab, tp_axes
from repro_torch.parallel.plan import ParallelismPlan

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
ROUNDS = 2
# tests/test_torch_dist_jax.py's tolerances
LOSS_TOL = dict(atol=5e-5, rtol=1e-4)
PARAM_TOL = dict(atol=5e-5, rtol=2e-3)
JAX_TIMEOUT_S = 240


def port_spec(jspec):
    """The port's ModelSpec with the fields of a JAX package one."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(tspec, type(v).__name__)
            return cls(**{f.name: conv(getattr(v, f.name))
                          for f in dataclasses.fields(v)})
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return v
    return conv(jspec)


def tiny_spec(arch):
    from spmd_pipeline_check import build_tiny_spec
    return port_spec(build_tiny_spec(arch))


def case_plan(pp, tp, mode, schedule, v, zero1):
    return ParallelismPlan(pp=pp, tp=tp, microbatches=W.R, stash_mode=mode,
                           remat=True, zero1=zero1, schedule=schedule,
                           virtual_stages=v)


def run_jax(tmp, name, data, pp, tp, arch, mode, schedule="auto", v=1,
            zero1=False, pipeline=True, oracle=True):
    """tests/_torch_dist_jax.py for one case into ``tmp/name_*.npz``
    (the SPMD pipeline on a (data, pp, tp) mesh unless ``pipeline`` is
    False, the oracle unless ``oracle`` is False); the prefix."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    prefix = str(tmp / name)
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_dist_jax.py"), prefix,
         str(ROUNDS), str(W.SEQ), str(W.R), str(W.MB), str(data),
         str(pp if pipeline else -pp), str(tp), arch, mode, schedule,
         str(v), str(int(zero1)), str(int(oracle))],
        capture_output=True, text=True, env=env, timeout=JAX_TIMEOUT_S)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nERR:\n{out.stderr}"
    return prefix


def load(prefix, which):
    return W.unflatten(dict(np.load(f"{prefix}_{which}.npz")))


def run_port(tmp, spec, plan, data, init_npz):
    """The port on a (data, plan.pp, plan.tp) grid of spawned gloo ranks,
    ROUNDS rounds from JAX's initial state: each rank's results."""
    torch.set_num_threads(1)
    ranks = W.run_ranks(tmp, data, plan.pp, {"tp_train": {
        "spec": spec, "plan": plan, "npz": init_npz, "rounds": ROUNDS}},
        tp=plan.tp)
    return [r["tp_train"] for r in ranks]


def want_of(ref, spec, plan, data, rank):
    """The part of the oracle's final state that ``rank`` of a (data,
    plan.pp, plan.tp) grid holds: its stage rows, tensor shard and ZeRO-1
    shard."""
    from repro_torch.parallel.dist import ProcessGrid
    d, s, t = ProcessGrid(data, plan.pp, plan.tp).coords(rank)
    sched = make_schedule(plan)
    stages = ref["params"]["stages"]
    axes = tp_axes(stages, spec, plan.tp)
    z1 = None
    if plan.zero1 and data > 1:
        local = tensor_cut(stages, (axes, 0, plan.tp))
        z1 = (zero1_axes(local, data), d, data)
    return rank_state(ref, sched, s, zero1=z1, tensor=(axes, t, plan.tp))


def assert_rank_part_tracks(spec, plan, data, ranks, ref, part):
    """Every rank's ``part`` of its state (weights, ring, optimizer state
    with its ZeRO-1 shards) within PARAM_TOL of the yardstick's part
    that rank holds."""
    n_checked = 0
    for rank, res in enumerate(ranks):
        want = want_of(ref, spec, plan, data, rank)
        if part not in want:
            assert part not in res["state"]
            continue
        g, e = leaves(res["state"][part]), leaves(want[part])
        assert [n for n, _ in g] == [n for n, _ in e], (rank, part)
        for (name, a), (_, b) in zip(g, e):
            if torch.is_tensor(a):
                np.testing.assert_allclose(
                    a.numpy(), np.asarray(b, np.float32),
                    err_msg=f"rank {rank} {part}{name}", **PARAM_TOL)
                n_checked += 1
    if part in ("params", "opt_stages"):
        assert n_checked


def replicated_paths(spec, plan, stages):
    """Key paths of the stage leaves every tensor rank holds whole."""
    axes = tp_axes(stages, spec, plan.tp)
    return [n for n, ax in leaves(axes) if ax < 0]


def assert_replicated_equal_across_t(spec, plan, data, ranks):
    """The stage leaves every tensor rank holds whole (norms, qk-norm
    scales, KV weights replicated at n_kv < tp), their ring rows and
    optimizer slots are bit-identical across the tensor ranks of each
    (replica, stage), and so are the final norm and its optimizer
    slots; every tensor rank of the first and last stage holds its own
    columns of the embedding and the head and of their optimizer
    slots."""
    from repro_torch.parallel.dist import ProcessGrid
    grid = ProcessGrid(data, plan.pp, plan.tp)
    n = 0
    for d in range(data):
        for s in range(plan.pp):
            group = [ranks[r]["state"] for r in grid.tensor_group_ranks(d, s)]
            whole = set(replicated_paths(spec, plan,
                                         group[0]["params"]["stages"]))
            for part in ("params", "stash", "opt_stages"):
                base = dict(leaves(group[0][part]))
                for other in group[1:]:
                    for name, b in leaves(other[part]):
                        tail = name.split("/stages", 1)[-1]
                        for pre in ("/current", "/ring", "/v", "/m"):
                            if tail.startswith(pre + "/"):
                                tail = tail[len(pre):]
                        if torch.is_tensor(b) and tail in whole:
                            assert torch.equal(base[name], b), (d, s, part,
                                                                name)
                            n += 1
            first, last = s == 0, s == plan.pp - 1
            for t, other in enumerate(group):
                p = other["params"]
                assert ("embed" in p, "opt_embed" in other) == (first, first)
                assert ("head" in p, "opt_head" in other) == (last, last)
                if first:
                    assert p["embed"].shape[1] == spec.d_model // plan.tp
                if last:
                    assert p["head"].shape[1] * plan.tp == \
                        padded_vocab(spec.vocab)
                    for name, b in leaves({"p": p["final_norm"], "o": {
                            k: v["f"] for k, v in other["opt_head"].items()}}):
                        base = dict(leaves({"p": group[0]["params"][
                            "final_norm"], "o": {k: v["f"] for k, v in group[
                                0]["opt_head"].items()}}))
                        assert torch.equal(base[name], b), (d, s, t, name)
                        n += 1
    assert n
