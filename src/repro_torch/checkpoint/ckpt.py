"""Checkpoints (port of ``repro/checkpoint/ckpt.py``), in the reference's
format: one ``ckpt_{step:08d}.npz`` per checkpoint step holding every leaf
under its tree path, the path's keys joined by ``//`` (a list index as
``[i]``; an ``nn.Module`` stands for the dict of its ``named_parameters()``),
so each package reads the other's files for trees of the same structure.
A bfloat16 leaf is stored as float32 (numpy has no bfloat16; the cast is
exact), and a bfloat16 leaf the reference wrote is read from its raw bits.

Writes are atomic (tmp + rename); ``latest_step`` scans the directory, so a
crashed write never corrupts recovery.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

_SEP = "//"


def _items(tree):
    """(key, child) pairs of a container, None for a leaf."""
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix=()) -> dict:
    items = _items(tree)
    if items is None:
        return {_SEP.join(prefix): _to_numpy(tree)}
    flat = {}
    for key, child in items:
        flat.update(_flatten(child, prefix + (key,)))
    return flat


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.itemsize == 2 and (arr.dtype.kind == "V" or
                                    arr.dtype.name == "bfloat16"):
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(tree: Any, directory: str, step: int, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)              # atomic publish
    _gc(directory, keep)
    return path


def _gc(directory: str, keep: int):
    steps = all_steps(directory)
    for s in steps[:-keep] if keep else []:
        try:
            os.remove(os.path.join(directory, f"ckpt_{s:08d}.npz"))
        except OSError:
            pass


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d+)\.npz", name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(template: Any, directory: str, step: Optional[int] = None) -> Any:
    """Restore into the structure of ``template`` (the latest step when
    ``step`` is None).  A tensor leaf of the template is overwritten in
    place, keeping its device, dtype and pinning, and returned; a module is
    returned with its parameters overwritten; any other leaf comes back as
    the stored array."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    with np.load(os.path.join(directory, f"ckpt_{step:08d}.npz")) as data:
        return _fill(template, data, ())


@torch.no_grad()
def _fill(tmpl, data, prefix):
    if isinstance(tmpl, nn.Module):
        for key, p in tmpl.named_parameters():
            _fill(p, data, prefix + (key,))
        return tmpl
    items = _items(tmpl)
    if items is not None:
        vals = [_fill(child, data, prefix + (key,)) for key, child in items]
        if isinstance(tmpl, dict):
            return dict(zip(tmpl.keys(), vals))
        return type(tmpl)(vals)
    arr = data[_SEP.join(prefix)]
    if isinstance(tmpl, torch.Tensor):
        value = _from_numpy(arr)
        if tuple(value.shape) != tuple(tmpl.shape):
            raise ValueError(f"{_SEP.join(prefix)}: stored shape "
                             f"{tuple(value.shape)} != {tuple(tmpl.shape)}")
        return tmpl.copy_(value)
    return arr
