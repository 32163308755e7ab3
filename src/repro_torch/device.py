"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    CUDA card.  Raises when no card is present and the caller did not ask
    for the CPU explicitly — a run never lands on the CPU by accident.  A
    CUDA device always carries its index, so devices compare equal."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        device = "cuda"
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d
