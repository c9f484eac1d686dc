"""Deterministic synthetic LM data (port of ``repro/data/pipeline.py``).

:class:`SyntheticLM` draws the JAX package's numpy stream, so both
packages train on the same tokens.  :class:`Loader` puts one round on
the training device; over data replicas each replica gets its
contiguous block of every microbatch's rows, as JAX's ``ShardedLoader``
shards the batch dim over the data axis
(``repro/core/pipeline.py``: ``P(None, data, None)``).  The batch keys
the stream does not give — the frontends' ``patches`` and ``frames`` —
come from an ``extra_fn`` such as :func:`frontend_stub`.
"""
from __future__ import annotations

import zlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


class SyntheticLM:
    """Zipf-ish token stream with EOS-delimited documents, deterministic
    in (seed, step)."""

    def __init__(self, vocab: int, seq_len: int, *, seed: int = 0,
                 eos_id: int = 0, mean_doc_len: int = 512):
        self.vocab = vocab
        self.seq_len = seq_len
        self.seed = seed
        self.eos_id = eos_id
        self.mean_doc_len = mean_doc_len

    def round_batch(self, step: int, r_microbatches: int, bmb: int
                    ) -> Dict[str, np.ndarray]:
        """(R, Bmb, S) tokens + next-token labels for one round."""
        rng = np.random.default_rng((self.seed, step))
        shape = (r_microbatches, bmb, self.seq_len + 1)
        u = rng.random(shape)
        toks = np.minimum((u ** 2.5 * self.vocab).astype(np.int64),
                          self.vocab - 1)
        doc = rng.random(shape) < (1.0 / self.mean_doc_len)
        toks = np.where(doc, self.eos_id, toks).astype(np.int32)
        return {"tokens": toks[..., :-1],
                "labels": toks[..., 1:].astype(np.int32)}


class Loader:
    """One round of ``source`` as tensors on ``device``: of the ``bmb``
    rows a microbatch has over all ``replicas``, replica ``replica``'s
    block of ``bmb / replicas``.  ``extra_shapes`` names the batch keys
    the stream does not give, each with its whole round's shape (R,
    bmb, ...); ``extra_fn(step, {key: shape})`` gives those arrays (f32),
    and every replica keeps its rows of them."""

    def __init__(self, source: SyntheticLM, r_microbatches: int, bmb: int,
                 device, *, replica: int = 0, replicas: int = 1,
                 extra_fn: Optional[Callable] = None,
                 extra_shapes: Optional[Dict[str, Tuple[int, ...]]] = None):
        if bmb % replicas:
            raise ValueError(f"{bmb} rows a microbatch do not split over "
                             f"{replicas} replicas")
        extra_shapes = dict(extra_shapes or {})
        if extra_shapes and extra_fn is None:
            raise ValueError(f"batch keys {sorted(extra_shapes)} need an "
                             "extra_fn to give them (the frontend stubs)")
        self.source = source
        self.r, self.bmb = r_microbatches, bmb
        self.device = torch.device(device)
        mb = bmb // replicas
        self.rows = slice(replica * mb, (replica + 1) * mb)
        self.extra_fn, self.extra_shapes = extra_fn, extra_shapes

    def get(self, step: int) -> Dict[str, torch.Tensor]:
        host = self.source.round_batch(step, self.r, self.bmb)
        for k, shape in self.extra_shapes.items():
            if k not in host:
                host[k] = self.extra_fn(step, {k: shape})[k]
        return {k: torch.from_numpy(np.ascontiguousarray(v[:, self.rows]))
                .to(self.device) for k, v in host.items()}


def frontend_stub(seed: int = 0):
    """The frontends' stub inputs: ``fn(step, {key: shape})`` gives, for
    each key, deterministic f32 values 0.02 x a standard normal in
    (seed, step, key); a shape may be a tuple or carry ``.shape`` (as
    JAX's ``ShapeDtypeStruct``).  JAX's ``vlm_patch_stub`` seeds with
    ``hash(key)``, which Python salts per process; the port takes the
    key's CRC-32, the same in every process."""
    def fn(step: int, shapes: Dict[str, Tuple[int, ...]]):
        out = {}
        for k, shape in shapes.items():
            rng = np.random.default_rng((seed, step, zlib.crc32(k.encode())))
            shape = tuple(getattr(shape, "shape", shape))
            out[k] = rng.standard_normal(shape).astype(np.float32) * 0.02
        return out
    return fn


def vlm_patch_stub(d_model: int, seed: int = 0):
    """The vision frontend's stub (JAX's ``vlm_patch_stub``): patch
    embeddings of width ``d_model``, which the shapes asked for carry."""
    del d_model
    return frontend_stub(seed)


def frames_stub(d_enc: int, seed: int = 0):
    """The audio frontend's stub, of :func:`vlm_patch_stub`'s form: the
    encoder's input frames (..., source_len, ``d_enc``)."""
    del d_enc
    return frontend_stub(seed)
