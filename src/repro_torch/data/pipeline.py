"""Deterministic synthetic LM data (port of ``repro/data/pipeline.py``).

:class:`SyntheticLM` draws the JAX package's numpy stream, so both
packages train on the same tokens.  :class:`Loader` puts one round on
the training device; over data replicas each replica gets its
contiguous block of every microbatch's rows, as JAX's ``ShardedLoader``
shards the batch dim over the data axis
(``repro/core/pipeline.py``: ``P(None, data, None)``).
"""
from __future__ import annotations

from typing import Dict

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
    """One round of ``source`` as int32 tensors on ``device``: of the
    ``bmb`` rows a microbatch has over all ``replicas``, replica
    ``replica``'s block of ``bmb / replicas``."""

    def __init__(self, source: SyntheticLM, r_microbatches: int, bmb: int,
                 device, *, replica: int = 0, replicas: int = 1):
        if bmb % replicas:
            raise ValueError(f"{bmb} rows a microbatch do not split over "
                             f"{replicas} replicas")
        self.source = source
        self.r, self.bmb = r_microbatches, bmb
        self.device = torch.device(device)
        mb = bmb // replicas
        self.rows = slice(replica * mb, (replica + 1) * mb)

    def get(self, step: int) -> Dict[str, torch.Tensor]:
        host = self.source.round_batch(step, self.r, self.bmb)
        return {k: torch.from_numpy(np.ascontiguousarray(v[:, self.rows]))
                .to(self.device) for k, v in host.items()}
