"""Stage assembly (port of ``repro/models/stage.py``).

A stage runs ``layers_per_stage`` blocks (the validated stage program).
:func:`stage_fwd` takes one stage's parameters — the stage-stacked tree
already indexed at that stage — and the ported block kinds with pre-norm
residuals: attention (with cross-attention into an encoder's output
after it in an encoder-decoder block), RWKV6 time-mix or Mamba as the
mixer; a dense FFN, RWKV6 channel-mix or MoE as the FFN.
:func:`encoder_fwd` is whisper's encoder, which runs before the
pipeline.  A stage cut over a tensor group
(``tp``) runs every block on this rank's shard with the group's
collectives (``models/nn.py``); its input and output are whole on every
rank of the group.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import nn
from repro_torch.models import spec as spec_lib
from repro_torch.models.init import (attn_static, mamba_static,
                                     moe_static, rwkv_static)
from repro_torch.parallel.plan import ParallelismPlan


@dataclasses.dataclass(frozen=True)
class StageStatics:
    """Static info shared by every stage."""

    spec: spec_lib.ModelSpec
    plan: ParallelismPlan
    program: Tuple[spec_lib.BlockSpec, ...]
    attn: Optional[nn.AttnStatic]
    xattn: Optional[nn.AttnStatic]
    rwkv: Optional[nn.RWKVStatic]
    moe: Optional[nn.MoEStatic]
    mamba: Optional[nn.MambaStatic]


def make_statics(spec: spec_lib.ModelSpec, plan: ParallelismPlan,
                 tokens_per_mb: Optional[int] = None) -> StageStatics:
    """The stage statics; ``tokens_per_mb`` (tokens per microbatch call)
    sizes the MoE capacity and is required when the program has MoE
    FFNs: the same value gives the same capacity, hence the same drops,
    as the JAX package."""
    program = spec.stage_program(plan.pp)
    bad = [b for b in program if b.mixer not in ("attn", "rwkv", "mamba")
           or b.ffn not in ("dense", "rwkv_cmix", "moe")]
    if bad:
        raise NotImplementedError(
            f"{spec.name}: block kinds "
            f"{sorted(set((b.mixer, b.ffn) for b in bad))} are not ported "
            "yet (mixer- or FFN-less blocks are still to port)")
    has = lambda kind: any(kind in (b.mixer, b.ffn) for b in program)
    if has("moe") and tokens_per_mb is None:
        raise ValueError(f"{spec.name} has MoE FFNs: make_statics needs "
                         "tokens_per_mb to size the expert capacity")
    return StageStatics(
        spec=spec, plan=plan, program=program,
        attn=attn_static(spec, plan.tp) if has("attn") else None,
        xattn=(attn_static(spec, plan.tp, causal=False)
               if any(b.cross_attn for b in program) else None),
        rwkv=rwkv_static(spec, plan.tp) if has("rwkv") else None,
        moe=(moe_static(spec, plan.tp, tokens_per_mb) if has("moe")
             else None),
        mamba=mamba_static(spec, plan.tp) if has("mamba") else None)


def stage_params(params, s: int):
    """Stage ``s``'s view of the stage-stacked ``params["stages"]`` tree
    (a quantized leaf gives stage ``s`` of its payload and its scale)."""
    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        return node[s]
    return take(params["stages"])


def _block(st: StageStatics, blk, lp, ls, x, cross_x=None, *, positions,
           window, theta, cache_pos, pg, tp, seq_group=None):
    """One block, mixer then FFN with pre-norm residuals; returns
    (x, aux) with the MoE auxiliary loss (None for other FFNs).  A
    cross-attention block attends into ``cross_x`` after its
    self-attention (JAX ``stage.py:95-105``)."""
    aux = None
    h = nn.apply_norm(lp["norm1"], x, st.spec.norm)
    if blk.mixer == "attn":
        x = x + nn.attention(lp["attn"], h, st.attn, positions=positions,
                             window=window, theta=theta,
                             kv_cache=ls.get("kv"), cache_pos=cache_pos,
                             paged_kv=pg, tp=tp, seq_group=seq_group)
        if blk.cross_attn:
            h = nn.apply_norm(lp["norm_x"], x, st.spec.norm)
            x = x + nn.attention(lp["xattn"], h, st.xattn,
                                 positions=positions, window=-1,
                                 theta=theta, cross_x=cross_x, tp=tp)
    elif blk.mixer == "mamba":
        x = x + nn.mamba_block(lp["mamba"], h, st.mamba, state=ls.get("ssm"),
                               tp=tp)
    else:
        x = x + nn.rwkv_time_mix(lp["tmix"], h, st.rwkv,
                                 state=ls.get("tmix"), tp=tp)
    h = nn.apply_norm(lp["norm2"], x, st.spec.norm)
    if blk.ffn == "dense":
        x = x + nn.mlp(lp["mlp"], h, st.spec.act, tp=tp)
    elif blk.ffn == "moe":
        out, aux = nn.moe(lp["moe"], h, st.moe, st.spec.act, tp=tp)
        x = x + out
    else:
        x = x + nn.rwkv_channel_mix(lp["cmix"], h, state=ls.get("cmix"),
                                    tp=tp)
    return x, aux


def stage_fwd(sp, x, st: StageStatics, *, positions, windows, thetas,
              state=None, cache_pos: int = 0, paged=None,
              return_aux: bool = False, cross_x=None, tp=None,
              seq_groups=None):
    """Run one stage over its blocks; returns the stage's output, or
    (output, aux) with ``return_aux``: the blocks' summed MoE auxiliary
    loss, an f32 scalar (0 without MoE FFNs), as JAX's ``stage_fwd``
    returns it.

    sp: ``stage_params(params, s)``; windows / thetas: this stage's
    [lps] host lists.  state: optional ``{'layer_i': {...}}`` views of
    one microbatch slot's state, as :func:`init_stage_state` lays it out
    (dense ``"kv"`` caches, ``"tmix"`` / ``"cmix"`` / ``"ssm"`` recurrent
    states);
    paged: optional ``{"pools": {'layer_i': (k_pool, v_pool)}, "row":
    PageRow}`` for the attention layers whose KV is paged; int8 pools
    are ``(k_pool, v_pool, k_scale, v_scale)``.  Caches and recurrent
    states are written in place.  Quantized ``{"q", "scale"}`` weights
    are dequantized at their matmul sites (``models/nn.py``).

    Remat as JAX's ``jax.checkpoint`` per block: with ``plan.remat``,
    no state and autograd recording, each block runs under
    ``torch.utils.checkpoint`` (non-reentrant), which keeps only the
    block's input and recomputes the block in the backward, the tensor
    group's sums included: every rank of the group re-runs the same
    blocks, so the ranks issue the same collectives in the same order.

    cross_x: the encoder's output (B, T_src, d) that the cross-attention
    blocks attend into (encoder-decoder models), else None.

    tp: the stage's tensor group (``RankGrid.tensor_group``) when ``sp``
    is this rank's shard (``models/init.py::tp_shard``), else None.

    seq_groups: sequence-parallel decode (JAX ``stage.py:141-174``, a
    ``seq_axis`` per stage-program position): one entry a position, the
    group over which that position's dense KV cache is sharded along the
    sequence (``nn.attention(seq_group=)``), or None where it is whole;
    None for every position.
    """
    remat = (st.plan.remat and state is None and paged is None
             and torch.is_grad_enabled())
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, blk in enumerate(st.program):
        name = f"layer_{i}"
        pg = None
        if paged is not None and name in paged["pools"]:
            pg = (*paged["pools"][name], paged["row"])
        fn = functools.partial(
            _block, st, blk, sp[name], state[name] if state is not None
            else {}, positions=positions, window=windows[i],
            theta=thetas[i], cache_pos=cache_pos, pg=pg, tp=tp,
            seq_group=None if seq_groups is None else seq_groups[i])
        if remat:
            x, aux = checkpoint(fn, x, cross_x, use_reentrant=False)
        else:
            x, aux = fn(x, cross_x)
        if aux is not None:
            aux_total = aux_total + aux
    return (x, aux_total) if return_aux else x


def _grad_leaves(node, prefix, names, leaves):
    """``node`` with every tensor replaced by a detached leaf that
    requires grad; the leaves and their key paths are appended to
    ``leaves`` / ``names``."""
    if isinstance(node, dict):
        return {k: _grad_leaves(v, prefix + (k,), names, leaves)
                for k, v in node.items()}
    t = node.detach().requires_grad_()
    names.append(prefix)
    leaves.append(t)
    return t


def stage_vjp(sp, x, st: StageStatics, g, aux_ct: float, *, positions,
              windows, thetas, cross_x=None, tp=None):
    """Re-run one stage's forward under autograd and pull back the
    cotangents (g on the output, ``aux_ct`` on the MoE auxiliary loss):
    returns (dW tree keyed like ``sp``, dx), as ``jax.vjp`` of JAX's
    ``stage_fwd`` gives them (zeros for weights the stage does not use);
    with ``cross_x`` (dW, dx, d(cross_x)), the stage's share of the
    encoder output's cotangent.

    ``sp`` and ``x`` may be views into rings that are written in place
    later: the backward completes inside this call, before any such
    write, so they are read through ``detach()`` without a copy.

    With ``tp`` the weights are this rank's shard and ``g`` the whole
    cotangent every rank of the group holds: dW is the rank's shard of
    the gradient (for a replicated leaf, the whole gradient: its
    ``tp_enter`` sums the ranks' shares), dx the whole of d(input).
    """
    names, leaves = [], []
    with torch.enable_grad():
        w = _grad_leaves(sp, (), names, leaves)
        xl = x.detach().requires_grad_()
        inputs = [xl]
        cl = None
        if cross_x is not None:
            cl = cross_x.detach().requires_grad_()
            inputs.append(cl)
        h, aux = stage_fwd(w, xl, st, positions=positions, windows=windows,
                           thetas=thetas, return_aux=True, cross_x=cl, tp=tp)
        outs, cts = [h], [g.to(h.dtype)]
        if aux.requires_grad:
            outs.append(aux)
            cts.append(torch.tensor(aux_ct, dtype=aux.dtype,
                                    device=aux.device))
        grads = torch.autograd.grad(outs, inputs + leaves, cts,
                                    allow_unused=True)
    dW: Dict = {}
    for path, leaf, gw in zip(names, leaves, grads[len(inputs):]):
        node = dW
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.zeros_like(leaf) if gw is None else gw
    return (dW, grads[0]) if cl is None else (dW, grads[0], grads[1])


def init_stage_state(st: StageStatics, batch_local: int, cache_lens,
                     dtype, device, lead=(), paged_layers=()) -> Dict:
    """Zero serving state ``{'layer_i': {...}}`` with leading dims
    ``lead``: ``"kv"`` = (k, v) dense caches ``lead + (batch_local,
    cache_lens[i], KV, Dh)`` for attention layers not in
    ``paged_layers``; ``"tmix"`` = (x_prev ``lead + (batch_local, d)``,
    wkv ``lead + (batch_local, H, Dh, Dh)`` f32) for RWKV time-mix;
    ``"cmix"`` = x_prev ``lead + (batch_local, d)`` for channel-mix;
    ``"ssm"`` = (conv_tail ``lead + (batch_local, d_conv - 1, Ci)``, h
    ``lead + (batch_local, Ci, N)`` f32) for Mamba."""
    lead = tuple(lead)

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + (batch_local,) + shape, dtype=dt,
                           device=device)

    out: Dict = {}
    for i, blk in enumerate(st.program):
        s: Dict = {}
        if blk.mixer == "attn" and i not in paged_layers:
            shape = (cache_lens[i], st.attn.n_kv_local, st.attn.d_head)
            s["kv"] = (zeros(*shape), zeros(*shape))
        elif blk.mixer == "mamba":
            ms = st.mamba
            s["ssm"] = (zeros(ms.d_conv - 1, ms.d_inner_local),
                        zeros(ms.d_inner_local, ms.d_state,
                              dt=torch.float32))
        elif blk.mixer == "rwkv":
            rs = st.rwkv
            s["tmix"] = (zeros(st.spec.d_model),
                         zeros(rs.n_heads_local, rs.d_head, rs.d_head,
                               dt=torch.float32))
        if blk.ffn == "rwkv_cmix":
            s["cmix"] = zeros(st.spec.d_model)
        out[f"layer_{i}"] = s
    return out


def full_transformer(params, x, st: StageStatics, *, positions,
                     cross_x=None):
    """Run all pp stages sequentially on one device, with no state: every
    (causal self-)attention layer runs the flash kernel, cross-attention
    into ``cross_x`` the plain path, every RWKV time-mix the WKV6
    kernel and every Mamba mixer the selective-scan kernel from a zero
    state.  MoE capacity is ``st.moe``'s: pass the statics whose
    ``tokens_per_mb`` is this call's B·S to see the same drops as one
    engine microbatch of the same tokens."""
    for s in range(st.plan.pp):
        x = stage_fwd(stage_params(params, s), x, st, positions=positions,
                      windows=params["layer_windows"][s],
                      thetas=params["layer_thetas"][s], cross_x=cross_x)
    return x


def _encoder_layer(lp, x, est: nn.AttnStatic, positions):
    """One encoder layer (JAX ``encoder_fwd``'s ``layer``): layernorms
    with zero bias, non-causal self-attention rotated at θ 1e4 (JAX's
    ``nn.attention`` rotates whenever it has no ``cross_x``), a tanh-GELU
    MLP."""
    zero = lambda a: torch.zeros_like(a)              # noqa: E731
    h = nn.layernorm(x, lp["norm1"], zero(lp["norm1"]))
    x = x + nn.attention({k: lp[k] for k in ("wq", "wk", "wv", "wo")}, h,
                         est, positions=positions, window=-1, theta=1e4)
    h = nn.layernorm(x, lp["norm2"], zero(lp["norm2"]))
    return x + F.gelu(h @ lp["w1"], approximate="tanh") @ lp["w2"]


def encoder_fwd(enc_params, frames, spec: spec_lib.ModelSpec):
    """Whisper's encoder over the stubbed frontend's frames (B, T_src,
    d_enc): the learned positions added, the stacked layers in turn,
    the final layernorm (JAX ``stage.py:235-275``).  Under autograd each
    layer runs under ``torch.utils.checkpoint``: only its input is kept,
    and the layer is re-run in the backward (the activations of 24
    layers of 1500-frame attention would not fit the card beside the
    pipeline)."""
    e = spec.encoder
    x = frames + enc_params["pos"][:frames.shape[1]]
    est = nn.AttnStatic(
        n_heads_local=e.n_heads, n_kv_local=e.n_heads,
        d_head=e.d_model // e.n_heads, kv_sharded=True,
        kv_groups_per_device=0, qk_norm=False, rope_2d=False, causal=False)
    positions = torch.arange(frames.shape[1], device=frames.device).expand(
        frames.shape[0], frames.shape[1])
    remat = torch.is_grad_enabled() and any(
        v.requires_grad for v in enc_params.values())
    for i in range(e.n_layers):
        lp = {k: v[i] for k, v in enc_params.items()
              if k not in ("pos", "final_norm")}
        if remat:
            x = checkpoint(_encoder_layer, lp, x, est, positions,
                           use_reentrant=False)
        else:
            x = _encoder_layer(lp, x, est, positions)
    fn = enc_params["final_norm"]
    return nn.layernorm(x, fn, torch.zeros_like(fn))


def encoder_vjp(enc_params, frames, spec: spec_lib.ModelSpec):
    """(enc_out, pull): the encoder's output on ``frames``, and the
    function that pulls a cotangent of it back to the encoder's
    parameters, a tree keyed like ``enc_params`` — the counterpart of
    JAX's ``jax.vjp`` of ``encoder_fwd`` in a training round.  The
    forward is recorded once, layer by layer under checkpoint, and
    ``pull`` is called once."""
    leaves = {k: v.detach().requires_grad_() for k, v in enc_params.items()}
    with torch.enable_grad():
        out = encoder_fwd(leaves, frames, spec)

    def pull(ct):
        names = list(leaves)
        grads = torch.autograd.grad([out], [leaves[k] for k in names],
                                    [ct.to(out.dtype)], allow_unused=True)
        return {k: torch.zeros_like(leaves[k]) if g is None else g
                for k, g in zip(names, grads)}

    return out.detach(), pull
