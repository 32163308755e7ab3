"""Device groups for prefill/decode disaggregation (port of
``repro/launch/mesh.py::disagg_groups``).

The reference's ``make_production_mesh`` and ``make_rules`` build a JAX
device mesh and its tensor/data-parallel sharding rules; they wait for the
port's sharding module (ROADMAP item 11), which needs more than one GPU.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve


def disagg_groups(devices=None):
    """Split the devices into (prefill, decode) groups for the
    disaggregated engine (``serve/disagg.py``).

    Decode takes the *leading* half -- it owns the resident KV pools and the
    engine's own device -- and gets the larger share on odd counts; prefill
    takes the trailing half.  With one device both groups alias it, so the
    engine runs degenerately on one card or on the CPU.  A list may repeat a
    device: its entries alias, as one device does (``[cuda:0] * 4`` gives
    two decode shards and two prefill devices on one card).

    ``devices`` is a sequence of ``torch.device``s or device strings; with
    None it is every CUDA card, and without a card this raises, as
    ``device.resolve`` does."""
    if devices is None:
        resolve(None)                      # raises when there is no card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve(d) for d in devices]
    if not devices:
        raise ValueError("disagg_groups needs at least one device")
    if len(devices) == 1:
        return devices, devices
    half = (len(devices) + 1) // 2
    return devices[half:], devices[:half]
