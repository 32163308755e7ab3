"""Device resolution for the port's entry points."""
from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of CUDA card ``device`` (the current card
    when it names no index), asked once per card: the kernel wrappers plan
    their grids from it."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())
