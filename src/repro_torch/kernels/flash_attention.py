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
copies KV).  For bf16 the kernel loads tiles with TMA through tensor maps
that ``tma_map`` derives from each tensor's strides.  What bounds the kernel
on this card (operations) and what its design does about that is noted in
the CUDA source.  This wrapper takes CUDA inputs only: the plain version for
CPU tensors is ``kernels/ref.py::attention_ref``, chosen by
``kernels/ops.py``.
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


TMA_ROWS = 128         # rows of every tensor-map box: the kernel's tiles
_MAP = _L * 27         # three maps of nine numbers each


def _lib():
    lib = build.load("flash_attention")
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = [_P] * 4 + [_I] * 8 + [_F] * 2 + \
            [_L] * 9 + [_P, _I, _P]
        lib.flash_attention.restype = _I
        lib.flash_attention_mma.argtypes = [_P] * 4 + [_I] * 8 + \
            [_F] * 2 + [_L] * 9 + [_P]
        lib.flash_attention_mma.restype = _I
        lib.flash_attention_kernel.argtypes = [_I, _I]
        lib.flash_attention_kernel.restype = ctypes.c_char_p
    return lib


def kernel_name(q) -> str:
    """Which kernel ``flash_attention`` launches for ``q``'s head_dim and
    dtype: "wgmma", "mma.sync" or "simt" (as the C library routes it)."""
    return _lib().flash_attention_kernel(q.shape[-1],
                                         _DTYPES[q.dtype]).decode()


def tma_map(t: torch.Tensor):
    """The tensor map the kernel loads ``t`` (B, S, heads, D) through, as
    nine numbers: dims (D, S, heads, B) in elements, the byte strides of S,
    heads and B, and the box (128 bytes of columns, ``TMA_ROWS`` rows).  TMA
    needs the last dimension contiguous, a 16-byte aligned base and every
    byte stride a multiple of 16; raises ``ValueError`` otherwise (the
    wrapper never copies)."""
    es = t.element_size()
    B, S, heads, D = t.shape
    strides = tuple(x * es for x in (t.stride(1), t.stride(2), t.stride(0)))
    _check(t.stride(3) == 1 and t.data_ptr() % 16 == 0
           and all(x % 16 == 0 for x in strides),
           f"a tensor map needs a contiguous last dimension, a 16-byte "
           f"aligned base and byte strides that are multiples of 16 "
           f"(strides {t.stride()}, {es}-byte elements)")
    return (D, S, heads, B) + strides + (128 // es, TMA_ROWS)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def _check_inputs(q, k, v, window):
    """Raise on any input the kernels do not take."""
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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap_val: float = 0.0):
    """Launch the kernel on the current stream; returns (B, Sq, H, D) in q's
    dtype.  Raises on any input the kernel does not take, and on a failed
    launch."""
    _check_inputs(q, k, v, window)
    maps = _MAP(*(x for t in (q, k, v) for x in tma_map(t))) \
        if q.dtype == torch.bfloat16 else None
    out = _run("flash_attention", q, k, v, causal, window, softcap_val,
               maps, _DTYPES[q.dtype])
    flash_attention.launches += 1       # the one count of every K2 launch
    return out


def _run(entry, q, k, v, causal, window, softcap_val, *tail):
    """Launch C entry ``entry`` on checked inputs, with ``tail`` before the
    stream; raises on a failed launch."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    lib = _lib()
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, KVH, D, int(bool(causal)), int(window),
            float(softcap_val), float(D ** -0.5), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *tail, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return out


def mma_sync(q, k, v, *, causal: bool = True, window: int = 0,
             softcap_val: float = 0.0):
    """The earlier mma.sync kernel on bf16 inputs that ``flash_attention``
    takes (D 16, 32, 64, 112, 128 or 256), for timing beside the kernel
    ``flash_attention`` routes them to; not counted in its launches and on
    no path of the port."""
    _check_inputs(q, k, v, window)
    _check(q.dtype == torch.bfloat16, "the mma.sync kernel is bf16 only")
    return _run("flash_attention_mma", q, k, v, causal, window, softcap_val)


flash_attention.launches = 0
