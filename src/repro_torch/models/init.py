"""Parameter initialization (port of ``repro/models/init.py``).

The tree has the JAX package's keys and layout: every per-layer leaf is
stacked with a leading [pp] stage dim under ``params["stages"]
["layer_i"]``; ``embed`` (Vpad, d), ``head`` (d, Vpad), ``final_norm``
sit outside the pipeline.  ``layer_windows`` / ``layer_thetas`` are
[pp][lps] Python lists: static per layer, read on the host.  So a JAX
tree carries over leaf for leaf (:func:`params_from_numpy`).  Ported
block kinds: attention, RWKV6 time-mix or Mamba as the mixer; a dense
FFN, RWKV6 channel-mix or MoE (with shared experts, ``moe.shared``) as
the FFN; cross-attention (``xattn`` and its norm ``norm_x``) after
self-attention in an encoder-decoder block; and whisper's encoder
(``params["encoder"]``: stacked ``[n_layers, ...]`` leaves and a learned
``pos`` of (source_len, d)), which every rank holds whole.

A stage cut over tp tensor ranks holds rank t's shard of every sharded
leaf: :func:`tp_axes` is the port's copy of the JAX init's
``PartitionSpec`` table (which dim of each stage-stacked leaf the
``"tensor"`` axis cuts), :func:`tp_shard` cuts a whole tree to rank t's
shard, and :func:`init_rank_params` draws a rank's shard layer by
layer.  The embedding and the head are cut too, as the JAX init cuts
them (``P(None, "tensor")`` both: the embedding (Vpad, d) on d_model,
the head (d, Vpad) on the vocabulary, ``core/versioning.py::
table_cut``); the final norm is every rank's.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.versioning import rank_rows, rank_state, table_cut
from repro_torch.models import spec as spec_lib
from repro_torch.models.nn import (AttnStatic, MambaStatic, MoEStatic,
                                   RWKVStatic)
from repro_torch.optim.optimizers import tree_map

_STATIC_KEYS = ("layer_windows", "layer_thetas")
# leaves the JAX init keeps in f32 whatever the compute dtype
_F32_KEYS = ("w0", "dt_bias", "A_log", "D")


def padded_vocab(vocab: int, multiple: int = 128) -> int:
    return -(-vocab // multiple) * multiple


def attn_static(spec: spec_lib.ModelSpec, tp: int,
                causal: bool = True) -> AttnStatic:
    assert spec.n_heads % tp == 0, (spec.name, spec.n_heads, tp)
    if spec.n_kv % tp == 0:
        kv_local, kv_sharded, groups_per_dev = spec.n_kv // tp, True, 0
    else:
        assert tp % spec.n_kv == 0, (
            f"{spec.name}: kv={spec.n_kv} and tp={tp} must divide one another")
        kv_local, kv_sharded, groups_per_dev = 1, False, tp // spec.n_kv
    return AttnStatic(
        n_heads_local=spec.n_heads // tp, n_kv_local=kv_local,
        d_head=spec.d_head, kv_sharded=kv_sharded,
        kv_groups_per_device=groups_per_dev, qk_norm=spec.qk_norm,
        rope_2d=spec.rope_2d, causal=causal)


def moe_static(spec: spec_lib.ModelSpec, tp: int, tokens_per_mb: int,
               capacity_factor: float = 1.25) -> MoEStatic:
    """Per-expert capacity ceil(T·k / E · factor), at least 4, for
    ``tokens_per_mb`` tokens per microbatch call (the JAX rule)."""
    m = spec.moe
    assert m.n_experts % tp == 0, (spec.name, m.n_experts, tp)
    cap = max(int(np.ceil(tokens_per_mb * m.top_k / m.n_experts
                          * capacity_factor)), 4)
    return MoEStatic(n_experts=m.n_experts, n_local=m.n_experts // tp,
                     top_k=m.top_k, capacity=cap, n_shared=m.n_shared)


def mamba_static(spec: spec_lib.ModelSpec, tp: int) -> MambaStatic:
    ms = spec.mamba
    d_inner = ms.expand * spec.d_model
    assert d_inner % tp == 0, (spec.name, d_inner, tp)
    dt_rank = ms.dt_rank or -(-spec.d_model // 16)
    return MambaStatic(d_inner_local=d_inner // tp, d_state=ms.d_state,
                       d_conv=ms.d_conv, dt_rank=dt_rank)


def rwkv_static(spec: spec_lib.ModelSpec, tp: int) -> RWKVStatic:
    n_heads = spec.d_model // spec.rwkv.head_dim
    assert n_heads % tp == 0, (spec.name, n_heads, tp)
    return RWKVStatic(n_heads_local=n_heads // tp, d_head=spec.rwkv.head_dim)


# the dim of each stage-stacked leaf ([L, ...]) that the tensor axis cuts,
# by (block, leaf): JAX ``models/init.py``'s PartitionSpecs (``"kv"``:
# the KV heads when tp divides them, else whole; a block inside a block,
# the MoE's shared experts, by its path ``"moe/shared"``: cut as ``mlp``,
# since JAX draws it through ``_mlp_init``).  Every leaf not named
# (norms, qk-norm scales, the router, RWKV's lerps and LoRAs, the
# channel-mix gate) and the embedding, head and final norm stay whole.
_TP_DIMS = {
    "attn": {"wq": 2, "wk": "kv", "wv": "kv", "wo": 1},
    "xattn": {"wq": 2, "wk": "kv", "wv": "kv", "wo": 1},
    "mlp": {"w1": 2, "w3": 2, "w2": 1},
    "moe": {"w1": 1, "w2": 1, "w3": 1},
    "moe/shared": {"w1": 2, "w3": 2, "w2": 1},
    "mamba": {"in_x": 2, "in_z": 2, "conv_w": 1, "x_proj": 1, "dt_proj": 2,
              "dt_bias": 1, "A_log": 1, "D": 1, "out_proj": 1},
    "tmix": {"wr": 2, "wk": 2, "wv": 2, "wg": 2, "wo": 1, "w0": 1,
             "decay_w2": 2, "u": 1, "gn_scale": 1, "gn_bias": 1},
    "cmix": {"wk": 2, "wv": 1},
}


def check_table_cut(spec: spec_lib.ModelSpec, tp: int) -> None:
    """Raise unless d_model and the padded vocabulary divide by ``tp``."""
    vpad = padded_vocab(spec.vocab)
    if spec.d_model % tp or vpad % tp:
        raise ValueError(f"{spec.name}: d_model {spec.d_model} and the "
                         f"padded vocabulary {vpad} must divide by tp={tp}")


def tp_dim(block: str, leaf: str, spec: spec_lib.ModelSpec, tp: int) -> int:
    """The dim of a stage-stacked ``block`` / ``leaf`` weight that the
    tensor axis cuts at ``tp`` ranks; -1 for a leaf held whole.  A
    nested block is named by its path (``"moe/shared"``)."""
    ax = _TP_DIMS.get(block, {}).get(leaf, -1)
    if ax == "kv":
        ax = 2 if spec.n_kv % tp == 0 else -1
    return ax if tp > 1 else -1


def _block_tp_axes(block: str, sub, spec, tp: int) -> Dict:
    return {leaf: (_block_tp_axes(f"{block}/{leaf}", v, spec, tp)
                   if isinstance(v, dict) else tp_dim(block, leaf, spec, tp))
            for leaf, v in sub.items()}


def _layer_tp_axes(layer, spec: spec_lib.ModelSpec, tp: int) -> Dict:
    """:func:`tp_axes` of one ``stages["layer_i"]`` dict."""
    return {block: _block_tp_axes(block, sub, spec, tp)
            for block, sub in layer.items()}


def tp_axes(stages, spec: spec_lib.ModelSpec, tp: int) -> Dict:
    """Tree of ints over ``stages`` (stage-stacked leaves): the dim the
    tensor axis cuts at ``tp`` ranks, -1 for a leaf every rank holds
    whole (every leaf at tp 1)."""
    return {name: _layer_tp_axes(layer, spec, tp)
            for name, layer in stages.items()}


def _copy_cut(a, ax: int, t: int, tp: int):
    """Shard ``t`` of ``a`` along ``ax`` as a tensor (or array) of its
    own, so the whole leaf can be freed; ``a`` for ax < 0."""
    if ax < 0:
        return a
    n = a.shape[ax] // tp
    if torch.is_tensor(a):
        return a.narrow(ax, t * n, n).clone(
            memory_format=torch.contiguous_format)
    return np.ascontiguousarray(
        a[(slice(None),) * ax + (slice(t * n, (t + 1) * n),)])


def tp_shard(tree, spec: spec_lib.ModelSpec, plan, t: int) -> Dict:
    """Rank ``t``'s shard of a whole parameter tree (torch or numpy
    leaves; stage-stacked ``stages``, the embedding, head, final norm and
    per-layer lists as :func:`init_params` lays them out) at
    ``plan.tp`` tensor ranks: each sharded leaf cut to its own copy,
    every other leaf the same object.  ``tree`` itself at tp 1."""
    if plan.tp == 1:
        return tree
    if not 0 <= t < plan.tp:
        raise ValueError(f"tensor index {t} outside tp={plan.tp}")
    axes = tp_axes(tree["stages"], spec, plan.tp)
    out = dict(tree)
    out["stages"] = tree_map(lambda a, ax: _copy_cut(a, ax, t, plan.tp),
                             tree["stages"], axes)
    for key in ("embed", "head"):
        if key in tree:
            check_table_cut(spec, plan.tp)
            out[key] = _table_copy(tree[key], t, plan.tp)
    return out


def _table_copy(a, t: int, tp: int):
    """Tensor rank ``t``'s columns of a table (``core/versioning.py::
    table_cut``) as a tensor (or array) of its own, so the whole table
    can be freed; ``a`` at tp 1."""
    if tp == 1:
        return a
    part = table_cut(a, (None, t, tp))
    if torch.is_tensor(part):
        return part.clone(memory_format=torch.contiguous_format)
    return np.ascontiguousarray(part)


class MetaGenerator:
    """A generator on ``meta``: the draw makes every leaf's shape and
    dtype and draws nothing (``torch.Generator`` cannot run on ``meta``).
    The dry run counts a state's bytes and a step's work with it."""

    device = torch.device("meta")


def generator(device, seed: int):
    """A generator on ``device`` seeded with ``seed``, or on ``meta`` a
    :class:`MetaGenerator`."""
    if torch.device(device).type == "meta":
        return MetaGenerator()
    return torch.Generator(device=device).manual_seed(seed)


def _rand(gen, shape, **kw):
    if gen.device.type == "meta":
        return torch.empty(shape, device="meta", **kw)
    return torch.rand(shape, generator=gen, device=gen.device, **kw)


def _dense(gen: torch.Generator, shape, dtype, scale=0.02):
    if gen.device.type == "meta":
        return torch.empty(shape, device="meta", dtype=dtype)
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def _norm_init(shape, kind, dtype, device):
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def _rwkv_tmix_init(spec, pp, gen, dtype, out_scale, take):
    d, rs, dev = spec.d_model, spec.rwkv, gen.device
    p = {f"maa_{n}": take(torch.full((pp, d), 0.5, dtype=dtype, device=dev))
         for n in ("x", "w", "k", "v", "r", "g")}
    p.update({
        "tmix_w1": take(_dense(gen, (pp, d, 5 * rs.tmix_lora), dtype, 0.01)),
        "tmix_w2": take(_dense(gen, (pp, 5, rs.tmix_lora, d), dtype, 0.01)),
        "wr": take(_dense(gen, (pp, d, d), dtype)),
        "wk": take(_dense(gen, (pp, d, d), dtype)),
        "wv": take(_dense(gen, (pp, d, d), dtype)),
        "wg": take(_dense(gen, (pp, d, d), dtype)),
        "wo": take(_dense(gen, (pp, d, d), dtype, out_scale)),
        "w0": take(_dense(gen, (pp, d), torch.float32, 0.2).add_(-3.9)),
        "decay_w1": take(_dense(gen, (pp, d, rs.decay_lora), dtype, 0.01)),
        "decay_w2": take(_dense(gen, (pp, rs.decay_lora, d), dtype, 0.01)),
        "u": take(_dense(gen, (pp, d), dtype)),
        "gn_scale": take(torch.ones((pp, d), dtype=dtype, device=dev)),
        "gn_bias": take(torch.zeros((pp, d), dtype=dtype, device=dev)),
    })
    return p


def _rwkv_cmix_init(spec, pp, gen, dtype, out_scale, take):
    d, dev = spec.d_model, gen.device
    return {
        "maa_k": take(torch.full((pp, d), 0.5, dtype=dtype, device=dev)),
        "maa_r": take(torch.full((pp, d), 0.5, dtype=dtype, device=dev)),
        "wk": take(_dense(gen, (pp, d, spec.d_ff), dtype)),
        "wv": take(_dense(gen, (pp, spec.d_ff, d), dtype, out_scale)),
        "wr_gate": take(_dense(gen, (pp, d, d), dtype)),
    }


def _attn_init(spec, pp, gen, dtype, out_scale, take, cross=False):
    """Self-attention, or with ``cross`` cross-attention (no qk-norm, as
    JAX's ``_attn_init(cross=True)``)."""
    d, h, kv, dh, dev = (spec.d_model, spec.n_heads, spec.n_kv, spec.d_head,
                         gen.device)
    attn = {"wq": take(_dense(gen, (pp, d, h, dh), dtype)),
            "wk": take(_dense(gen, (pp, d, kv, dh), dtype)),
            "wv": take(_dense(gen, (pp, d, kv, dh), dtype)),
            "wo": take(_dense(gen, (pp, h * dh, d), dtype, out_scale))}
    if spec.qk_norm and not cross:
        attn["q_norm"] = take(torch.ones((pp, dh), dtype=dtype, device=dev))
        attn["k_norm"] = take(torch.ones((pp, dh), dtype=dtype, device=dev))
    return attn


def _encoder_init(spec, gen, dtype) -> Dict:
    """Whisper's encoder, JAX's ``_encoder_init``: per-layer leaves
    stacked ``[n_layers, ...]``, norms without a bias (the encoder's
    layernorms take zero bias), the final norm and the learned positions
    ``pos`` (source_len, d)."""
    e, dev = spec.encoder, gen.device
    n, d, dh = e.n_layers, e.d_model, e.d_model // e.n_heads
    p = {k: _dense(gen, (n, d, e.n_heads, dh), dtype)
         for k in ("wq", "wk", "wv")}
    p["wo"] = _dense(gen, (n, e.n_heads * dh, d), dtype)
    p["w1"] = _dense(gen, (n, d, e.d_ff), dtype)
    p["w2"] = _dense(gen, (n, e.d_ff, d), dtype)
    p["norm1"] = torch.ones((n, d), dtype=dtype, device=dev)
    p["norm2"] = torch.ones((n, d), dtype=dtype, device=dev)
    p["final_norm"] = torch.ones((d,), dtype=dtype, device=dev)
    p["pos"] = _dense(gen, (e.source_len, d), dtype)
    return p


def _mlp_init(spec, pp, gen, dtype, out_scale, take, ff):
    d = spec.d_model
    mlp = {"w1": take(_dense(gen, (pp, d, ff), dtype)),
           "w2": take(_dense(gen, (pp, ff, d), dtype, out_scale))}
    if spec.act == "silu":
        mlp["w3"] = take(_dense(gen, (pp, d, ff), dtype))
    return mlp


def _moe_init(spec, pp, gen, dtype, out_scale, take):
    d, m = spec.d_model, spec.moe
    p = {
        "router": take(_dense(gen, (pp, d, m.n_experts), dtype)),
        "w1": take(_dense(gen, (pp, m.n_experts, d, m.d_expert), dtype)),
        "w2": take(_dense(gen, (pp, m.n_experts, m.d_expert, d), dtype,
                          out_scale)),
        "w3": take(_dense(gen, (pp, m.n_experts, d, m.d_expert), dtype)),
    }
    if m.n_shared:              # one MLP of n_shared x d_shared, as JAX's
        p["shared"] = _mlp_init(spec, pp, gen, dtype, out_scale, take,
                                m.n_shared * m.d_shared)
    return p


def _mamba_init(spec, pp, gen, dtype, out_scale, take):
    d, ms, dev = spec.d_model, spec.mamba, gen.device
    ci = ms.expand * d
    dt_rank = ms.dt_rank or -(-d // 16)
    a = torch.arange(1, ms.d_state + 1, dtype=torch.float32, device=dev)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt0 = _rand(gen, (pp, ci)) * (hi - lo) + lo
    return {
        "in_x": take(_dense(gen, (pp, d, ci), dtype)),
        "in_z": take(_dense(gen, (pp, d, ci), dtype)),
        "conv_w": take(_dense(gen, (pp, ci, ms.d_conv), dtype, 0.1)),
        "x_proj": take(_dense(gen, (pp, ci, dt_rank + 2 * ms.d_state),
                              dtype)),
        "dt_proj": take(_dense(gen, (pp, dt_rank, ci), dtype,
                               dt_rank ** -0.5)),
        # softplus⁻¹ of dt ~ logU(1e-3, 1e-1); f32, as in the JAX init
        "dt_bias": take(torch.log(torch.expm1(torch.exp(dt0)))),
        "A_log": take(torch.log(a).expand(pp, ci, ms.d_state).contiguous()),
        "D": take(torch.ones((pp, ci), dtype=torch.float32, device=dev)),
        "out_proj": take(_dense(gen, (pp, ci, d), dtype, out_scale)),
    }


def init_params(spec: spec_lib.ModelSpec, plan, gen: torch.Generator,
                dtype=torch.bfloat16) -> Dict:
    """Random parameters on ``gen``'s device, drawn from ``gen``.

    Same scales as the JAX init (embed 1.0, projections 0.02, output
    projections 0.02/√(2L), RWKV decay bias w0 ~ -3.9 + 0.2·N in f32,
    Mamba conv 0.1, dt_proj dt_rank^-½ and f32 dt_bias / A_log / D);
    the random numbers differ from JAX's, so a
    test that compares the two packages hands both one numpy tree.  The
    encoder, where the spec has one, is drawn last, from the same
    stream.
    """
    return _draw(spec, plan, gen, dtype, None, True, True)


def init_rank_params(spec: spec_lib.ModelSpec, plan, gen: torch.Generator,
                     sched, stage: Optional[int],
                     dtype=torch.bfloat16, t: int = 0) -> Dict:
    """What stage ``stage`` of ``sched`` holds of :func:`init_params`,
    drawn without the rest (the paper's workers hold their stage only).

    ``plan`` is the plan the model is cut with (``core/reference.py::
    model_plan``: S·v chunks at virtual stages).  Every leaf is drawn
    whole, in :func:`init_params`' generator order, and cut to the
    stage's storage rows (row s·v + j holds chunk j·S + s) before the
    next leaf is drawn, so the transient is one leaf.  The embedding is
    kept on stage 0 and the head and final norm on the last stage; the
    other stages draw them and drop them.  Equal bit for bit to
    ``rank_params(to_storage_order(init_params(...), sched), sched,
    stage)`` (``core/versioning.py``).  ``stage`` None draws every row,
    one process's state: ``to_storage_order(init_params(...), sched)``.

    At ``plan.tp`` > 1 the rank keeps tensor shard ``t`` of every
    sharded leaf (:func:`tp_shard`): each layer is drawn at full width
    for the rank's rows and cut before the next layer is drawn; so are
    the embedding (every rank of stage 0 its columns) and the head
    (every rank of the last stage its vocabulary slice, beside the whole
    final norm).  Every rank keeps the whole encoder (it runs before the
    pipeline, on every rank)."""
    if stage is None:
        rows = list(range(sched.n_chunks))
    else:
        held = rank_rows(sched, stage)
        rows = list(range(held.start, held.stop))
    if sched.virtual_stages > 1:
        order = sched.storage_chunk_order().tolist()
        rows = [order[r] for r in rows]
    elif stage is None:
        rows = None                 # model order already: no copies
    return _draw(spec, plan, gen, dtype, rows, stage in (None, 0),
                 stage in (None, sched.n_stages - 1), t)


def _draw(spec, plan, gen, dtype, rows, embed: bool, head: bool,
          t: int = 0) -> Dict:
    """The parameter draw: ``rows`` (model chunks, in the order to keep
    them) of every stage-stacked leaf, or all of them for None; the
    embedding with ``embed``, head and final norm with ``head``; tensor
    shard ``t`` of each layer and of the two tables at ``plan.tp`` > 1;
    the whole encoder.  A leaf not kept is drawn all the same: the
    generator's stream stays the whole model's."""
    pp = plan.pp
    program = spec.stage_program(pp)
    dev = gen.device
    d, ff = spec.d_model, spec.d_ff
    out_scale = 0.02 / math.sqrt(2 * spec.n_layers)
    vpad = padded_vocab(spec.vocab)
    if rows is None:
        def take(a):
            return a
    else:
        idx = torch.tensor(rows, device=dev)

        def take(a):
            return a.index_select(0, idx)

    params: Dict = {}
    if plan.tp > 1:
        check_table_cut(spec, plan.tp)
    e = _dense(gen, (vpad, d), dtype, 1.0)
    if embed:
        params["embed"] = _table_copy(e, t, plan.tp)
    del e
    w = _dense(gen, (d, vpad), dtype)
    if head:
        params["head"] = _table_copy(w, t, plan.tp)
        params["final_norm"] = _norm_init((d,), spec.norm, dtype, dev)
    del w
    stages: Dict = {}
    for i, blk in enumerate(program):
        if (blk.mixer not in ("attn", "rwkv", "mamba")
                or blk.ffn not in ("dense", "rwkv_cmix", "moe")):
            raise NotImplementedError(
                f"block {blk} is not ported yet (mixer- or FFN-less "
                "blocks are still to port)")
        lp: Dict = {"norm1": tree_map(take, _norm_init((pp, d), spec.norm,
                                                       dtype, dev))}
        if blk.mixer == "mamba":
            lp["mamba"] = _mamba_init(spec, pp, gen, dtype, out_scale, take)
        elif blk.mixer == "attn":
            lp["attn"] = _attn_init(spec, pp, gen, dtype, out_scale, take)
            if blk.cross_attn:
                lp["xattn"] = _attn_init(spec, pp, gen, dtype, out_scale,
                                         take, cross=True)
                lp["norm_x"] = tree_map(take, _norm_init(
                    (pp, d), spec.norm, dtype, dev))
        else:
            lp["tmix"] = _rwkv_tmix_init(spec, pp, gen, dtype, out_scale,
                                         take)
        lp["norm2"] = tree_map(take, _norm_init((pp, d), spec.norm, dtype,
                                                dev))
        if blk.ffn == "dense":
            lp["mlp"] = _mlp_init(spec, pp, gen, dtype, out_scale, take, ff)
        elif blk.ffn == "moe":
            lp["moe"] = _moe_init(spec, pp, gen, dtype, out_scale, take)
        else:
            lp["cmix"] = _rwkv_cmix_init(spec, pp, gen, dtype, out_scale,
                                         take)
        if plan.tp > 1:
            lp = tree_map(lambda a, ax: _copy_cut(a, ax, t, plan.tp), lp,
                          _layer_tp_axes(lp, spec, plan.tp))
        stages[f"layer_{i}"] = lp
    params["stages"] = stages
    windows, thetas = spec_lib.stage_varying_scalars(spec, pp)
    if rows is not None:
        windows, thetas = [windows[r] for r in rows], [thetas[r] for r in rows]
    params["layer_windows"] = windows
    params["layer_thetas"] = thetas
    if spec.encoder is not None:
        params["encoder"] = _encoder_init(spec, gen, dtype)
    return params


def params_from_numpy(tree, device, dtype, *, tensor=None) -> Dict:
    """The port's tree from a JAX parameter tree taken to numpy
    (``jax.tree.map(np.asarray, params)``): a leaf-for-leaf copy, float
    leaves cast to ``dtype`` on ``device``; the per-layer window / theta
    arrays become host lists, and the leaves the JAX engine keeps in f32
    (the RWKV decay bias ``w0``; Mamba's ``dt_bias``, ``A_log`` and
    ``D``) stay f32.  ``tensor = (spec, plan, t)``: tensor rank t's
    shard of the whole tree (:func:`tp_shard`)."""
    if tensor is not None:
        tree = tp_shard(tree, *tensor)
    def conv(key, node):
        if isinstance(node, dict):
            return {k: conv(k, v) for k, v in node.items()}
        if key in _STATIC_KEYS:
            return np.asarray(node).tolist()
        t = torch.from_numpy(np.array(node))
        if t.is_floating_point():
            return t.to(device=device, dtype=(torch.float32 if key in _F32_KEYS
                                              else dtype))
        return t.to(device)
    return conv(None, tree)


def train_state_from_numpy(tree, device, dtype, *, sched=None, stage=None,
                           zero1=None, tensor=None) -> Dict:
    """The port's training state from a JAX one taken to numpy
    (``jax.tree.map(np.asarray, state)``, as ``reference_init_state``
    or ``build_pipeline``'s ``init_state`` build it): params as
    :func:`params_from_numpy` converts them, ``stash["current"]`` the
    very ``params["stages"]`` tensors (JAX holds one array for both),
    the ``[V, L, ...]`` stash ring in ``dtype``, optimizer states in
    their own dtype (f32) and ``step`` a Python int.  With ``stage``
    (and the plan's ``sched``) only what that stage's rank of a process
    grid holds (``core/versioning.py::rank_state``; ``zero1 = (axes,
    replica, dp)`` keeps the replica's optimizer shard), so a JAX state
    loads rank by rank; with ``stage``, ``tensor = (spec, plan, t)``
    keeps tensor rank t's shard of the stage's leaves (``zero1``'s axes
    are then those of the shard)."""
    if stage is not None:
        cut = None
        if tensor is not None:
            spec, plan, t = tensor
            cut = (tp_axes(tree["params"]["stages"], spec, plan.tp), t,
                   plan.tp)
        tree = rank_state(tree, sched, stage, zero1=zero1, tensor=cut)
    params = params_from_numpy(tree["params"], device, dtype)
    stash = {"current": params["stages"]}
    if "ring" in tree["stash"]:
        stash["ring"] = params_from_numpy(tree["stash"]["ring"], device,
                                          dtype)
    out = {"params": params, "stash": stash,
           "step": int(np.asarray(tree["step"]))}
    for key in ("opt_stages", "opt_head", "opt_embed", "opt_encoder"):
        if key in tree:
            out[key] = params_from_numpy(tree[key], device, torch.float32)
    return out
