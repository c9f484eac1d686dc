"""The per-architecture parallelism plan (port of
``repro/parallel/mesh.py::ParallelismPlan``).

Same fields, defaults and asserts as the JAX plan (pinned by
tests/test_torch_spec.py).  The port runs the plan's stages on one
device (tp 1), or over ``torch.distributed`` (``parallel/dist.py``) on a
grid of data × pp × tp ranks: one rank a tensor shard of a stage of a
replica, with ``zero1`` over each shard's replicas.  Serving runs tp 1.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ParallelismPlan:
    """Per-architecture distribution plan (declared in configs/<arch>.py)."""

    pp: int                    # pipeline stages (PipeDream stages)
    tp: int                    # tensor parallel degree within a stage
    microbatches: int = 8      # R: microbatches in flight per round
    stash_mode: str = "stash"  # stash | flush | vertical | 2bw
    schedule: str = "auto"     # auto | registry name
    virtual_stages: int = 1    # model chunks per physical stage
    zero1: bool = True
    remat: bool = True
    grad_sync: str = "per_microbatch"  # per_microbatch | per_round
    decode_microbatches: int = 8

    def __post_init__(self):
        assert self.stash_mode in ("stash", "flush", "vertical", "2bw"), self.stash_mode
        assert self.grad_sync in ("per_microbatch", "per_round"), self.grad_sync
        assert self.pp >= 1 and self.tp >= 1 and self.microbatches >= 1
        assert self.virtual_stages >= 1, self.virtual_stages
        if self.virtual_stages > 1:
            from repro_torch.core.schedule import SCHEDULES
            cls = SCHEDULES.get(self.schedule)
            assert cls is not None and cls.takes_virtual_stages, (
                "virtual_stages > 1 requires an interleaved-family "
                f"schedule (got schedule={self.schedule!r}); registered: "
                f"{sorted(n for n, c in SCHEDULES.items() if c.takes_virtual_stages)}")

    def with_(self, **kw) -> "ParallelismPlan":
        return dataclasses.replace(self, **kw)
