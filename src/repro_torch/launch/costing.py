"""Analytic costing of a step function (port of ``repro/launch/costing.py``).

The reference walks the step's jaxpr, multiplying scan bodies by their
trip counts.  Here the step runs eagerly, on meta tensors as a rule, under
a ``TorchDispatchMode`` that counts every aten op it dispatches: the layer
loops run every trip, and the backward and each Sentinel block's
recompute are counted because they run.  The token-by-token loops of the
recurrent layers (``kernels/ref.step_loop``: the sequential mLSTM, the
sLSTM and the LSTM) run trip 0, then trip 1 counted for the other S - 1,
its backward too, as the reference counts a scan body once times its
length: their results under the counter are not the loop's.

  - FLOPs: 2 x output elements x K for the products (``mm``, ``bmm``,
    ``addmm``, ``baddbmm``, ``mv``, ``dot``: K the operands' shared dim),
    output elements for every other op; views count nothing.
  - bytes: inputs and outputs once each, for the ops the profiler does not
    take for fusible (``core/profiler._FUSIBLE``, aten names mapped by
    ``_PRIM``): a proxy of the device-memory traffic of a fused program.

Counts are for the GLOBAL (unpartitioned) program; per chip = / chips, the
roofline ideal of an evenly sharded step.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core.profiler import _FUSIBLE, _PRIM
from repro_torch.kernels import ref

_PRODUCTS = ("mm", "bmm", "addmm", "baddbmm", "mv", "dot")


def _product_flops(args, out) -> float:
    """2 x out elements x K, K the last dim of the left operand (the last
    operand pair of ``addmm``/``baddbmm``)."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    lhs = tensors[-2]
    return 2.0 * out.numel() * lhs.shape[-1]


def _bytes(ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = {"flops": 0.0, "bytes": 0.0, "matmul_flops": 0.0}
        # what an op counts for (``step_loop`` scales a trip)
        self.scale = 1.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        name = func.overloadpacket.__name__
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        k = self.scale
        if name in _PRODUCTS:
            f = _product_flops(args, outs[0])
            self.total["matmul_flops"] += k * f
        else:
            f = float(sum(t.numel() for t in outs))
        self.total["flops"] += k * f
        if _PRIM.get(name, name) not in _FUSIBLE:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.total["bytes"] += k * (_bytes(ins) + _bytes(outs))
        return out


def step_cost(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """{"flops", "bytes", "matmul_flops"} of one call of ``fn(*args)``,
    counted over the aten ops it runs (its backward included where it
    takes gradients)."""
    counter = _Counter()
    ref.counting(counter)
    try:
        with counter:
            fn(*args, **kwargs)
    finally:
        ref.counting(None)
    return counter.total
