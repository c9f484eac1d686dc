"""Per-stage local checkpointing (paper §4, "Checkpointing"; port of
``repro/checkpoint/manager.py``).

The paper: "Checkpoints don't require expensive global coordination; each
stage locally decides to dump its model parameters … Restarting entails
starting from the last epoch successfully checkpointed by all stages."

Layout on disk (the JAX package's, leaf keys included, so a checkpoint
written by either package restores in the other):
    <dir>/round_<n>/stage_<s>.npz     one file per stage-stacked row
    <dir>/round_<n>/shared.npz        embed / head / final_norm / windows
    <dir>/round_<n>/opt.npz           optimizer + stash ring + step
    <dir>/round_<n>/MANIFEST.json     {"round": n, "stages": [...], "done": bool}

npz has no bfloat16 or float8: those leaves are written as their
``uint16`` / ``uint8`` payload and viewed back through the restore
template, which knows the true dtype.  ``step`` is written as an int32
scalar and the per-layer windows / thetas as int32 / float32 arrays, as
JAX holds them.

``latest_complete_round`` scans manifests and returns the newest round for
which every stage file landed — a stage failure mid-dump leaves an
incomplete manifest that restart skips, exactly the paper's semantics.

``reshard_stages`` re-groups stage-stacked leaves when the pipeline depth
changes (elastic scaling): parameters are keyed by global layer index, so
moving stage boundaries is a pure reshape.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.optim.optimizers import tree_map

# torch dtypes npz cannot hold -> (torch and numpy integer types of the
# same width, the unsigned type written to disk, as the JAX package does)
_PAYLOAD = {torch.bfloat16: (torch.int16, np.int16, np.uint16),
            torch.float8_e4m3fn: (torch.uint8, np.uint8, np.uint8),
            torch.float8_e5m2: (torch.uint8, np.uint8, np.uint8)}
# host-list leaves of the port's params (JAX holds them as arrays)
_LIST_DTYPES = {"layer_windows": np.int32, "layer_thetas": np.float32}


def _to_numpy(key: str, leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype in _PAYLOAD:
            as_int, _, on_disk = _PAYLOAD[t.dtype]
            return t.view(as_int).cpu().numpy().view(on_disk)
        return t.cpu().numpy()
    if key in _LIST_DTYPES:
        return np.asarray(leaf, _LIST_DTYPES[key])
    return np.asarray(leaf, np.int32)                  # step


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = _to_numpy(k, v)
    return out


def _restore_leaf(key: str, template, arr: np.ndarray):
    """The checkpoint's value for one leaf: copied into the template
    tensor in place (returned), or a host value for the per-layer lists
    and ``step``."""
    if torch.is_tensor(template):
        arr = np.ascontiguousarray(arr)
        dst = template
        if template.dtype in _PAYLOAD:
            # reinterpret the payload's bits: a cast would convert them
            as_int, np_int, _ = _PAYLOAD[template.dtype]
            arr, dst = arr.view(np_int), template.view(as_int)
        dst.copy_(torch.from_numpy(arr).reshape(template.shape))
        return template
    if key in _LIST_DTYPES:
        return np.asarray(arr).tolist()
    return int(arr)                                    # step


def _restore_into(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    for k, v in list(template.items()):
        if isinstance(v, dict):
            _restore_into(v, flat, f"{prefix}{k}/")
        else:
            template[k] = _restore_leaf(k, v, flat[f"{prefix}{k}"])


class CheckpointManager:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _round_dir(self, rnd: int) -> str:
        return os.path.join(self.dir, f"round_{rnd:08d}")

    @staticmethod
    def _write_manifest(d: str, manifest: Dict[str, Any]):
        """Atomic manifest update: tmp file + os.replace, so a crash
        mid-write leaves either the previous manifest or none — never a
        truncated JSON that poisons every later restart scan."""
        tmp = os.path.join(d, "MANIFEST.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(d, "MANIFEST.json"))

    # ---------------- save ------------------------------------------------

    def save(self, rnd: int, state: Dict[str, Any], n_stages: int,
             fail_after_stage: Optional[int] = None):
        """Per-stage dump: ``stage_<s>.npz`` holds row s of every
        stage-stacked leaf, so ``n_stages`` is the number of rows (S·v
        chunks for a virtual-stage plan).  ``fail_after_stage`` simulates
        a crash mid-save (used by the fault-tolerance tests): stages >
        that index are not written and the manifest stays incomplete."""
        d = self._round_dir(rnd)
        os.makedirs(d, exist_ok=True)
        stages = state["params"]["stages"]
        written: List[int] = []
        manifest = {"round": rnd, "stages": [], "n_stages": n_stages,
                    "done": False}

        for s in range(n_stages):
            if fail_after_stage is not None and s > fail_after_stage:
                break
            part = tree_map(lambda a: a[s:s + 1], stages)
            np.savez(os.path.join(d, f"stage_{s}.npz"), **_flatten(part))
            written.append(s)
            manifest["stages"] = written
            self._write_manifest(d, manifest)

        if len(written) == n_stages:
            shared = {k: v for k, v in state["params"].items()
                      if k != "stages"}
            np.savez(os.path.join(d, "shared.npz"), **_flatten(shared))
            rest = {k: v for k, v in state.items() if k != "params"}
            np.savez(os.path.join(d, "opt.npz"), **_flatten(rest))
            manifest["done"] = True
            self._write_manifest(d, manifest)

    # ---------------- restore --------------------------------------------

    def latest_complete_round(self) -> Optional[int]:
        best = None
        for name in os.listdir(self.dir):
            mf = os.path.join(self.dir, name, "MANIFEST.json")
            if not os.path.exists(mf):
                continue
            try:
                with open(mf) as f:
                    m = json.load(f)
            except (OSError, ValueError):
                # a truncated / corrupt manifest: the round is incomplete
                continue
            if isinstance(m, dict) and m.get("done"):
                best = max(best or -1, m["round"])
        return best

    def restore(self, rnd: int, state: Dict[str, Any]) -> Dict[str, Any]:
        """Overwrite ``state`` with round ``rnd``: every tensor is copied
        into in place (so a state left half-updated by a failed round is
        wholly replaced, and no second copy is allocated), ``step`` and
        the per-layer lists are replaced.  ``stash["current"]`` stays
        the very ``params["stages"]`` tensors.  Returns ``state``."""
        d = self._round_dir(rnd)
        n_rows = len(state["params"]["layer_windows"])
        parts = [dict(np.load(os.path.join(d, f"stage_{s}.npz")))
                 for s in range(n_rows)]
        stage_flat = {k: np.concatenate([p[k] for p in parts], axis=0)
                      for k in parts[0]}
        del parts
        _restore_into(state["params"]["stages"], stage_flat)
        del stage_flat
        shared = dict(np.load(os.path.join(d, "shared.npz")))
        params = {k: v for k, v in state["params"].items() if k != "stages"}
        _restore_into(params, shared)
        state["params"].update(params)
        rest = dict(np.load(os.path.join(d, "opt.npz")))
        # stash["current"] is params["stages"], restored above once
        others = {k: v for k, v in state.items() if k not in ("params",
                                                              "stash")}
        if "ring" in state["stash"]:
            others["stash"] = {"ring": state["stash"]["ring"]}
        _restore_into(others, rest)
        others.pop("stash", None)
        state.update(others)                 # step
        state["stash"]["current"] = state["params"]["stages"]
        return state


# --------------------------------------------------------------------------
# Elastic resharding: move stage boundaries (pp -> pp')
# --------------------------------------------------------------------------

def reshard_stages(stages_tree: Dict[str, Any], old_pp: int, new_pp: int
                   ) -> Dict[str, Any]:
    """Re-group per-(stage, position) leaves for a new pipeline depth.

    Old layout: stages['layer_i'][leaf] has shape [old_pp, ...], holding
    global layer (s*lps_old + i).  New layout must satisfy
    n_layers % new_pp == 0 and the stage-program pattern must still align
    (validated by the caller via spec.stage_program(new_pp)).
    """
    lps_old = len(stages_tree)
    n_layers = lps_old * old_pp
    assert n_layers % new_pp == 0, (n_layers, new_pp)
    lps_new = n_layers // new_pp
    out: Dict[str, Any] = {}
    for i_new in range(lps_new):
        per_stage = []
        for s_new in range(new_pp):
            s_old, i_old = divmod(s_new * lps_new + i_new, lps_old)
            per_stage.append(tree_map(lambda a: a[s_old],
                                      stages_tree[f"layer_{i_old}"]))
        out[f"layer_{i_new}"] = tree_map(lambda *xs: torch.stack(xs),
                                         *per_stage)
    return out
