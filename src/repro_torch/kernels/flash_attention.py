"""Blocked online-softmax (flash) attention: the wrapper of the hand-written
Hopper kernel ``csrc/flash_attention.cu`` (the port of
``repro/kernels/flash_attention.py::flash_attention``, K2).

Layout, as the reference's signature and its oracle (not the reference's
docstring, R2 in ROADMAP.md):

  q      (B, Sq, H, D)     float32 or bfloat16
  k, v   (B, Skv, KVH, D)  q's dtype

It returns (B, Sq, H, D) in q's dtype.  Queries are right-aligned to the end
of the KV timeline (row i at position i + Skv - Sq); query head h reads KV
head h // (H // KVH).  H % KVH == 0; D is a multiple of 8 up to 256.  The
kernel reads q, k and v through their strides: the last dimension must be
contiguous and every row 16-byte aligned, or the wrapper raises (it never
copies KV).  What bounds the kernel on this card (operations) and what its
design does about that is noted in the CUDA source.  This wrapper takes CUDA
inputs only: the plain version for CPU tensors is
``kernels/ref.py::attention_ref``, chosen by ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import MAX_D, check_rows

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


def _lib():
    lib = build.load("flash_attention")
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = [_P] * 4 + [_I] * 8 + [_F] * 2 + \
            [_L] * 9 + [_I, _P]
        lib.flash_attention.restype = _I
    return lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap_val: float = 0.0):
    """Launch the kernel on the current stream; returns (B, Sq, H, D) in q's
    dtype.  Raises on any input the kernel does not take, and on a failed
    launch."""
    _check(q.dim() == 4 and k.dim() == 4,
           "q must be (B, Sq, H, D) and k, v (B, Skv, KVH, D)")
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v)):
        _check(tuple(t.shape) == (B, Skv, KVH, D),
               f"{name} shape {tuple(t.shape)} != {(B, Skv, KVH, D)}")
    _check(min(B, Sq, Skv, KVH) > 0 and H % KVH == 0,
           f"{H} query heads not a multiple of {KVH} KV heads, or an empty "
           f"dimension")
    _check(D % 8 == 0 and 8 <= D <= MAX_D,
           f"head_dim {D} is not a multiple of 8 in [8, {MAX_D}]")
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} is not float32/bfloat16")
    for name, t in (("k", k), ("v", v)):
        _check(t.dtype == q.dtype, f"{name} dtype {t.dtype} != {q.dtype}")
    _check(window >= 0, f"window {window} < 0")
    for name, t in (("k", k), ("v", v)):
        _check(t.device == q.device, f"{name} is not on {q.device}")
    _check(q.is_cuda, "q must be a CUDA tensor (CPU inputs take the plain "
           "version through kernels.ops)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_rows(_check, name, t)

    lib = _lib()
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, KVH, D, int(bool(causal)), int(window),
            float(softcap_val), float(D ** -0.5), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1       # the one count of every K2 launch
    return out


flash_attention.launches = 0
