"""AdamW's update, the global-norm clip included, as one multi-tensor pass on
the card: the wrapper of the hand-written kernels ``csrc/adamw.cu``.

``fused_update`` takes every leaf of one step at once (the parameters, the
gradients and the float32 moments as lists, one leaf's tensors at the same
index) and the int32 step count, all on one CUDA card.  It packs a table of
the leaves' addresses, copies it to the card from pinned host memory (one
copy, non-blocking) and launches two kernels on the current stream: one
sums the gradients' squares chunk by chunk and, in its last CTA, turns them
into the norm, the clip's scale, the schedule's lr and the bias
corrections; the other updates every chunk in place.  Nothing waits for the
card.  ``supports`` says which leaves the kernels take; CHUNK, THREADS
and VEC are how the source cuts the work.
``kernels/ref.py::adamw_fused_ref`` is the same algorithm in plain torch,
the sums in the same order; ``optim/adamw.update`` chooses between this
pass and the eager ops.  What bounds the kernels on this card (bytes) and
what their design does about that is noted in the CUDA source.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build

CHUNK = 65536        # elements a CTA takes
THREADS = 256        # its threads (kThreads in the source)
VEC = 4              # elements a vector
DTYPES = (torch.float32, torch.bfloat16)     # of parameters and gradients
_PARAM_BF16, _GRAD_BF16, _VECTOR = 1, 2, 4   # a row's flags
_ROW = 8                                     # int64 a row; the header too
_SCALARS = 5                                 # norm, scale, lr, b1c, b2c
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def _lib():
    lib = build.load("adamw")
    if lib.adamw_fused.argtypes is None:
        lib.adamw_fused.argtypes = [_P, _I, _I, _L] + [_P] * 4 + \
            [_F] * 12 + [_P]
        lib.adamw_fused.restype = _I
    return lib


def supports(p, g, m, v) -> bool:
    """Whether the kernels take a leaf: its parameter ``p`` and gradient
    ``g`` float32 or bfloat16, its moments ``m`` and ``v`` float32, all
    four of one shape, on one device and contiguous."""
    return (p.dtype in DTYPES and g.dtype in DTYPES
            and m.dtype == v.dtype == torch.float32
            and p.device == g.device == m.device == v.device
            and p.shape == g.shape == m.shape == v.shape
            and p.is_contiguous() and g.is_contiguous()
            and m.is_contiguous() and v.is_contiguous())


def vector_path(*leaf) -> bool:
    """Whether the kernels read a leaf (its parameter, gradient and
    moments) in vectors: all four start on 16 bytes (the flag
    ``pack_table`` sets)."""
    return all(t.data_ptr() % 16 == 0 for t in leaf)


def constants(cfg) -> tuple:
    """The float32 numbers of ``cfg`` (an ``optim.adamw.OptConfig``) in the
    order ``csrc/adamw.cu`` takes them: lr, 1 / max(1, warmup), warmup,
    1 / max(1, total - warmup), pi, b1, b2, 1 - b1, 1 - b2, eps, weight
    decay, clip.  Each as the eager update's CUDA ops round it: a Python
    number cast to float32 (1 - b1 taken in double first), a division by a
    Python number as a product with its float32 reciprocal."""
    f32 = np.float32

    def inv(d):
        return f32(1.0) / f32(d)

    return tuple(float(f32(x)) for x in (
        cfg.lr, inv(max(1.0, cfg.warmup_steps)), cfg.warmup_steps,
        inv(max(1.0, cfg.total_steps - cfg.warmup_steps)), math.pi, cfg.b1,
        cfg.b2, 1 - cfg.b1, 1 - cfg.b2, cfg.eps, cfg.weight_decay,
        cfg.clip_norm))


def pack_table(params, grads, ms, vs, chunk: int = CHUNK):
    """The kernels' table as int64: a header row whose first word is the
    zero the last-CTA counter starts from, then one row a leaf of at least
    one element (p, g, m, v addresses, numel, first chunk, flags, 0).
    Returns (table, leaves, chunks).  Raises on a leaf ``supports`` refuses
    or on another device than the first parameter's."""
    _check(len(params) == len(grads) == len(ms) == len(vs) > 0,
           "one gradient and two moments for each of at least one parameter")
    dev = params[0].device
    rows = [[0] * _ROW]
    first = 0
    for p, g, m, v in zip(params, grads, ms, vs):
        _check(supports(p, g, m, v) and p.device == dev,
               f"a leaf the kernels do not take: dtypes {p.dtype}, "
               f"{g.dtype}, {m.dtype}, {v.dtype}; devices {p.device}, "
               f"{g.device}, {m.device}, {v.device} (all {dev}); shapes "
               f"{tuple(p.shape)}, {tuple(g.shape)}, {tuple(m.shape)}, "
               f"{tuple(v.shape)} (see supports)")
        n = p.numel()
        if n == 0:
            continue
        flags = (_PARAM_BF16 if p.dtype == torch.bfloat16 else 0) | \
            (_GRAD_BF16 if g.dtype == torch.bfloat16 else 0) | \
            (_VECTOR if vector_path(p, g, m, v) else 0)
        rows.append([p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                     n, first, flags, 0])
        first += -(-n // chunk)
    return np.array(rows, dtype=np.int64), len(rows) - 1, first


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"adamw fused: {msg}")


def fused_update(params, grads, ms, vs, count, cfg):
    """One AdamW step of every leaf on the current stream: the parameters
    and moments written in place.  Returns (count + 1, the norm before the
    clip, lr), new 0-dim tensors on the card.  Raises on any input the
    kernels do not take (``pack_table``), and on a failed launch."""
    rows, leaves, chunks = pack_table(params, grads, ms, vs)
    dev = params[0].device
    _check(dev.type == "cuda", "the parameters must be on a CUDA card (the "
           "plain version is kernels/ref.py::adamw_fused_ref)")
    _check(count.device == dev and count.dtype == torch.int32
           and count.dim() == 0, f"count must be a 0-dim int32 on {dev}")
    _check(0 < chunks < 2 ** 31, f"{chunks} chunks")
    lib = _lib()
    with torch.cuda.device(dev):
        # the caching host allocator keeps the pinned block until the copy
        # has read it
        table = torch.from_numpy(rows).pin_memory().to(dev, non_blocking=True)
        partials = torch.empty(chunks, dtype=torch.float32, device=dev)
        scalars = torch.empty(_SCALARS, dtype=torch.float32, device=dev)
        count_out = torch.empty((), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adamw_fused(table.data_ptr(), leaves, chunks, CHUNK,
                              partials.data_ptr(), count.data_ptr(),
                              count_out.data_ptr(), scalars.data_ptr(),
                              *constants(cfg), stream)
    if err != 0:
        raise RuntimeError(f"adamw fused launch failed: CUDA error {err}")
    fused_update.launches += 2      # the one count of this pass's launches
    return count_out, scalars[0], scalars[2]


fused_update.launches = 0


def bytes_per_param(param_bytes: int, grad_bytes: int) -> int:
    """The bytes a parameter costs the pass, each read once and each
    written once: p read and written, g read, m and v read and written
    (22 in bf16)."""
    return 2 * param_bytes + grad_bytes + 16
