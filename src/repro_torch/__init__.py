"""PyTorch + CUDA port of the PipeDream reproduction (``src/repro``).

The layout mirrors the JAX package module for module; the JAX package
stays the reference every part of this port is held against
(tests/test_torch_*.py).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, and raise when no card is present.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Never falls back to the CPU: asking for CUDA without a card raises.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
