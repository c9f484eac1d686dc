"""1-bit gradient compression with error feedback (CNTK-style, paper §2;
port of ``repro/optim/compression.py``).

An optional transform on the replicas' gradient sum.  Each replica sends
sign(g + e) scaled by the mean magnitude; the quantization error e feeds
back into its next step.  As in the JAX package the sum runs on the
dequantized payload (sign × scale in f32), so the wire carries what an
uncompressed sum would; the saving it models is the int8 signs and one
scale a tensor.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.optim.optimizers import tree_map


def onebit_compress_all_reduce(grads, errors, group, n_replicas: int
                               ) -> Tuple:
    """(synced grads, new errors) for matching trees ``grads`` and
    ``errors``: each leaf's payload sign(g + e)·mean|g + e| summed over
    ``group`` (a :class:`~repro_torch.parallel.dist.Group`; None: this
    replica alone) and divided by ``n_replicas``, in the gradient's
    dtype; the new error is what the payload left out, f32."""
    def one(g, e):
        x = g.float() + e
        scale = x.abs().mean()
        sign = torch.where(x >= 0, 1, -1).to(torch.int8)
        q = sign.float() * scale
        agg = q.clone()
        if group is not None:
            group.all_reduce_(agg)
        return (agg / n_replicas).to(g.dtype), x - q

    pairs = tree_map(one, grads, errors)
    pick = lambda i, node: (node[i] if isinstance(node, tuple)  # noqa: E731
                            else {k: pick(i, v) for k, v in node.items()})
    return pick(0, pairs), pick(1, pairs)


def init_errors(params, dtype=torch.float32):
    """Zero error-feedback buffers shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                          device=p.device), params)
