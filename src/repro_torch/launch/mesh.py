"""The production mesh, its sharding rules, and the device groups for
prefill/decode disaggregation (port of ``repro/launch/mesh.py``).

``make_production_mesh`` gives the reference's mesh as shapes only (no
device is touched), for the dry-run's per-device reckoning on any
machine; a ``sharding.Mesh`` with devices runs partitioned
(``train/loop.PartitionedStep``, ``serve/disagg.TensorParallelPrefill``).
"""
from __future__ import annotations

import torch

from repro_torch import sharding as shd
from repro_torch.device import resolve


def make_production_mesh(*, multi_pod: bool = False) -> shd.Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) with "pod" first."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shd.Mesh(shape, axes)


def make_rules(mesh, *, kind: str = "train", fsdp: bool = False,
               seq_shard: bool = False, seq_parallel: bool = False,
               dp_only: bool = False) -> shd.AxisRules:
    """kind: train | prefill | decode. long-context decode sets seq_shard;
    seq_parallel = Megatron-SP residual sharding; dp_only folds the model
    axis into data parallelism (small models)."""
    if kind == "train":
        return shd.tp_dp_rules(mesh, fsdp=fsdp, seq_parallel=seq_parallel,
                               dp_only=dp_only)
    return shd.serve_rules(mesh, seq_shard=seq_shard)


def disagg_groups(devices=None):
    """Split the devices into (prefill, decode) groups for the
    disaggregated engine (``serve/disagg.py``).

    Decode takes the *leading* half -- it owns the resident KV pools and the
    engine's own device -- and gets the larger share on odd counts; prefill
    takes the trailing half.  With one device both groups alias it, so the
    engine runs degenerately on one card or on the CPU.  A list may repeat a
    device: its entries alias, as one device does (``[cuda:0] * 4`` gives
    two decode shards and two prefill devices on one card).

    ``devices`` is a sequence of ``torch.device``s or device strings, or a
    ``sharding.Mesh`` with devices (its devices in mesh order); with None
    it is every CUDA card, and without a card this raises, as
    ``device.resolve`` does."""
    if isinstance(devices, shd.Mesh):
        if devices.devices is None:
            raise ValueError(f"{devices} holds shapes only, no devices")
        devices = devices.devices
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
