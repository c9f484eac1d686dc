"""Stage assembly (port of ``repro/models/stage.py``).

A stage runs ``layers_per_stage`` blocks (the validated stage program).
:func:`stage_fwd` takes one stage's parameters — the stage-stacked tree
already indexed at that stage — and this slice's block kinds, attention
+ dense FFN with pre-norm residuals.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import nn
from repro_torch.models import spec as spec_lib
from repro_torch.models.init import attn_static
from repro_torch.parallel.plan import ParallelismPlan


@dataclasses.dataclass(frozen=True)
class StageStatics:
    """Static info shared by every stage."""

    spec: spec_lib.ModelSpec
    plan: ParallelismPlan
    program: Tuple[spec_lib.BlockSpec, ...]
    attn: Optional[nn.AttnStatic]


def make_statics(spec: spec_lib.ModelSpec,
                 plan: ParallelismPlan) -> StageStatics:
    program = spec.stage_program(plan.pp)
    bad = [b for b in program
           if b.mixer != "attn" or b.ffn != "dense" or b.cross_attn]
    if bad:
        raise NotImplementedError(
            f"{spec.name}: block kinds {sorted(set((b.mixer, b.ffn) for b in bad))} "
            "are not ported yet (attention + dense FFN only)")
    return StageStatics(spec=spec, plan=plan, program=program,
                        attn=attn_static(spec, plan.tp))


def stage_params(params, s: int):
    """Stage ``s``'s view of the stage-stacked ``params["stages"]`` tree."""
    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        return node[s]
    return take(params["stages"])


def stage_fwd(sp, x, st: StageStatics, *, positions, windows, thetas,
              state=None, cache_pos: int = 0, paged=None):
    """Run one stage over its blocks; returns the stage's output.

    sp: ``stage_params(params, s)``; windows / thetas: this stage's
    [lps] host lists.  state: optional ``{'layer_i': {"kv": (k, v)}}``
    dense cache views of one microbatch slot; paged: optional
    ``{"pools": {'layer_i': (k_pool, v_pool)}, "row": PageRow}``.  Caches
    are written in place.
    """
    for i in range(len(st.program)):
        name = f"layer_{i}"
        lp = sp[name]
        kv = state[name]["kv"] if state is not None else None
        pg = None
        if paged is not None and name in paged["pools"]:
            pg = (*paged["pools"][name], paged["row"])
        h = nn.apply_norm(lp["norm1"], x, st.spec.norm)
        x = x + nn.attention(lp["attn"], h, st.attn, positions=positions,
                             window=windows[i], theta=thetas[i],
                             kv_cache=kv, cache_pos=cache_pos, paged_kv=pg)
        h = nn.apply_norm(lp["norm2"], x, st.spec.norm)
        x = x + nn.mlp(lp["mlp"], h, st.spec.act)
    return x


def init_stage_state(st: StageStatics, batch_local: int, cache_lens,
                     dtype, device, lead=()) -> Dict:
    """Zero dense KV caches ``{'layer_i': {"kv": (k, v)}}``, each
    ``lead + (batch_local, cache_lens[i], KV, Dh)``."""
    out: Dict = {}
    for i, blk in enumerate(st.program):
        s: Dict = {}
        if blk.mixer == "attn":
            shape = tuple(lead) + (batch_local, cache_lens[i],
                                   st.attn.n_kv_local, st.attn.d_head)
            s["kv"] = (torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))
        out[f"layer_{i}"] = s
    return out


def full_transformer(params, x, st: StageStatics, *, positions):
    """Run all pp stages sequentially on one device (the cache-less
    causal forward: every attention layer runs the flash kernel)."""
    for s in range(st.plan.pp):
        x = stage_fwd(stage_params(params, s), x, st, positions=positions,
                      windows=params["layer_windows"][s],
                      thetas=params["layer_thetas"][s])
    return x
