"""Parameter initialization (port of ``repro/models/init.py``).

The tree has the JAX package's keys and layout: every per-layer leaf is
stacked with a leading [pp] stage dim under ``params["stages"]
["layer_i"]``; ``embed`` (Vpad, d), ``head`` (d, Vpad), ``final_norm``
sit outside the pipeline.  ``layer_windows`` / ``layer_thetas`` are
[pp][lps] Python lists: static per layer, read on the host.  So a JAX
tree carries over leaf for leaf (:func:`params_from_numpy`).  Ported
block kinds: attention + dense FFN, and RWKV6 time-mix + channel-mix;
MoE, Mamba and cross-attention blocks come later.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from repro_torch.models import spec as spec_lib
from repro_torch.models.nn import AttnStatic, RWKVStatic

_STATIC_KEYS = ("layer_windows", "layer_thetas")
# leaves the JAX init keeps in f32 whatever the compute dtype
_F32_KEYS = ("w0",)


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


def rwkv_static(spec: spec_lib.ModelSpec, tp: int) -> RWKVStatic:
    n_heads = spec.d_model // spec.rwkv.head_dim
    assert n_heads % tp == 0, (spec.name, n_heads, tp)
    return RWKVStatic(n_heads_local=n_heads // tp, d_head=spec.rwkv.head_dim)


def _dense(gen: torch.Generator, shape, dtype, scale=0.02):
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def _norm_init(shape, kind, dtype, device):
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def _rwkv_tmix_init(spec, pp, gen, dtype, out_scale):
    d, rs, dev = spec.d_model, spec.rwkv, gen.device
    p = {f"maa_{n}": torch.full((pp, d), 0.5, dtype=dtype, device=dev)
         for n in ("x", "w", "k", "v", "r", "g")}
    p.update({
        "tmix_w1": _dense(gen, (pp, d, 5 * rs.tmix_lora), dtype, 0.01),
        "tmix_w2": _dense(gen, (pp, 5, rs.tmix_lora, d), dtype, 0.01),
        "wr": _dense(gen, (pp, d, d), dtype),
        "wk": _dense(gen, (pp, d, d), dtype),
        "wv": _dense(gen, (pp, d, d), dtype),
        "wg": _dense(gen, (pp, d, d), dtype),
        "wo": _dense(gen, (pp, d, d), dtype, out_scale),
        "w0": _dense(gen, (pp, d), torch.float32, 0.2).add_(-3.9),
        "decay_w1": _dense(gen, (pp, d, rs.decay_lora), dtype, 0.01),
        "decay_w2": _dense(gen, (pp, rs.decay_lora, d), dtype, 0.01),
        "u": _dense(gen, (pp, d), dtype),
        "gn_scale": torch.ones((pp, d), dtype=dtype, device=dev),
        "gn_bias": torch.zeros((pp, d), dtype=dtype, device=dev),
    })
    return p


def _rwkv_cmix_init(spec, pp, gen, dtype, out_scale):
    d, dev = spec.d_model, gen.device
    return {
        "maa_k": torch.full((pp, d), 0.5, dtype=dtype, device=dev),
        "maa_r": torch.full((pp, d), 0.5, dtype=dtype, device=dev),
        "wk": _dense(gen, (pp, d, spec.d_ff), dtype),
        "wv": _dense(gen, (pp, spec.d_ff, d), dtype, out_scale),
        "wr_gate": _dense(gen, (pp, d, d), dtype),
    }


def init_params(spec: spec_lib.ModelSpec, plan, gen: torch.Generator,
                dtype=torch.bfloat16) -> Dict:
    """Random parameters on ``gen``'s device, drawn from ``gen``.

    Same scales as the JAX init (embed 1.0, projections 0.02, output
    projections 0.02/√(2L), RWKV decay bias w0 ~ -3.9 + 0.2·N in f32);
    the random numbers differ from JAX's, so a
    test that compares the two packages hands both one numpy tree.
    """
    pp = plan.pp
    program = spec.stage_program(pp)
    dev = gen.device
    d, h, kv, dh, ff = (spec.d_model, spec.n_heads, spec.n_kv, spec.d_head,
                        spec.d_ff)
    out_scale = 0.02 / math.sqrt(2 * spec.n_layers)
    vpad = padded_vocab(spec.vocab)

    params: Dict = {
        "embed": _dense(gen, (vpad, d), dtype, 1.0),
        "head": _dense(gen, (d, vpad), dtype),
        "final_norm": _norm_init((d,), spec.norm, dtype, dev),
    }
    stages: Dict = {}
    for i, blk in enumerate(program):
        if (blk.mixer not in ("attn", "rwkv") or blk.cross_attn
                or blk.ffn not in ("dense", "rwkv_cmix")):
            raise NotImplementedError(
                f"block {blk} is not ported yet (MoE, Mamba and "
                "cross-attention blocks are still to port)")
        lp: Dict = {"norm1": _norm_init((pp, d), spec.norm, dtype, dev)}
        if blk.mixer == "attn":
            attn = {"wq": _dense(gen, (pp, d, h, dh), dtype),
                    "wk": _dense(gen, (pp, d, kv, dh), dtype),
                    "wv": _dense(gen, (pp, d, kv, dh), dtype),
                    "wo": _dense(gen, (pp, h * dh, d), dtype, out_scale)}
            if spec.qk_norm:
                attn["q_norm"] = torch.ones((pp, dh), dtype=dtype, device=dev)
                attn["k_norm"] = torch.ones((pp, dh), dtype=dtype, device=dev)
            lp["attn"] = attn
        else:
            lp["tmix"] = _rwkv_tmix_init(spec, pp, gen, dtype, out_scale)
        lp["norm2"] = _norm_init((pp, d), spec.norm, dtype, dev)
        if blk.ffn == "dense":
            mlp = {"w1": _dense(gen, (pp, d, ff), dtype),
                   "w2": _dense(gen, (pp, ff, d), dtype, out_scale)}
            if spec.act == "silu":
                mlp["w3"] = _dense(gen, (pp, d, ff), dtype)
            lp["mlp"] = mlp
        else:
            lp["cmix"] = _rwkv_cmix_init(spec, pp, gen, dtype, out_scale)
        stages[f"layer_{i}"] = lp
    params["stages"] = stages
    windows, thetas = spec_lib.stage_varying_scalars(spec, pp)
    params["layer_windows"] = windows
    params["layer_thetas"] = thetas
    return params


def params_from_numpy(tree, device, dtype) -> Dict:
    """The port's tree from a JAX parameter tree taken to numpy
    (``jax.tree.map(np.asarray, params)``): a leaf-for-leaf copy, float
    leaves cast to ``dtype`` on ``device``; the per-layer window / theta
    arrays become host lists, and the RWKV decay bias ``w0`` stays f32
    as the JAX engine keeps it."""
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
