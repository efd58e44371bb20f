"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names CUDA and
    no CUDA device exists.  There is no silent CPU fallback: a caller that
    wants the CPU passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the work queued on ``dev`` (a no-op on the CPU), so that a
    host clock around it measures the work and not its enqueueing."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
