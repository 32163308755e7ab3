"""Flash decode over a contiguous KV cache: the wrapper of the hand-written
Hopper kernel ``csrc/decode_attention.cu`` (the port of
``repro/kernels/decode_attention.py::decode_attention``, K3).

Layout, as the reference:

  q                 (B, H, D)         float32 or bfloat16
  k_cache, v_cache  (B, S, KVH, D)    q's dtype
  lengths           (B,) int32        valid cache entries per slot

It returns (B, H, D) in q's dtype.  H % KVH == 0; D is a multiple of 8 up to
256.  The kernel reads q and the caches through their strides: the last
dimension must be contiguous and every row 16-byte aligned, or the wrapper
raises (it never copies a cache).  What bounds the kernel on this card
(bytes) and what its design does about that is noted in the CUDA source.
This wrapper takes CUDA inputs only: the plain version for CPU tensors is
``kernels/ref.py::decode_attention_ref``, chosen by ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_D = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


def _lib():
    lib = build.load("decode_attention")
    if lib.decode_attention.argtypes is None:
        lib.decode_attention.argtypes = [_P] * 5 + [_I] * 6 + [_F] * 2 + \
            [_L] * 8 + [_I, _P]
        lib.decode_attention.restype = _I
    return lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"decode_attention: {msg}")


def check_rows(check, name: str, t: torch.Tensor):
    """The kernels read each row of ``t`` (its last dimension) with 16-byte
    loads: that dimension must be contiguous and every row 16-byte
    aligned.  ``check(cond, msg)`` raises when ``cond`` is false."""
    es = t.element_size()
    check(t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s * es % 16 == 0 for s in t.stride()[:-1]),
          f"{name} needs a contiguous last dimension and 16-byte aligned "
          f"rows (strides {t.stride()}); the wrapper does not copy")


def decode_attention(q, k_cache, v_cache, lengths, *, window: int = 0,
                     softcap_val: float = 0.0):
    """Launch the kernel on the current stream; returns (B, H, D) in q's
    dtype.  Raises on any input the kernel does not take, and on a failed
    launch."""
    _check(q.dim() == 3 and k_cache.dim() == 4,
           "q must be (B, H, D) and the caches (B, S, KVH, D)")
    B, H, D = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check(tuple(t.shape) == (B, S, KVH, D),
               f"{name} shape {tuple(t.shape)} != {(B, S, KVH, D)}")
    _check(tuple(lengths.shape) == (B,),
           f"lengths shape {tuple(lengths.shape)} != {(B,)}")
    _check(min(B, S, KVH) > 0 and H % KVH == 0,
           f"{H} query heads not a multiple of {KVH} KV heads, or an empty "
           f"dimension")
    _check(D % 8 == 0 and 8 <= D <= MAX_D,
           f"head_dim {D} is not a multiple of 8 in [8, {MAX_D}]")
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} is not float32/bfloat16")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check(t.dtype == q.dtype, f"{name} dtype {t.dtype} != {q.dtype}")
    _check(lengths.dtype == torch.int32, "lengths must be int32")
    _check(window >= 0, f"window {window} < 0")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        _check(t.device == q.device, f"{name} is not on {q.device}")
    _check(q.is_cuda, "q must be a CUDA tensor (CPU inputs take the plain "
           "version through kernels.ops)")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        check_rows(_check, name, t)
    _check(lengths.is_contiguous(), "lengths must be contiguous")

    lib = _lib()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, S, H, KVH, D, int(window),
            float(softcap_val), float(D ** -0.5), *q.stride()[:2],
            *k_cache.stride()[:3], *v_cache.stride()[:3], _DTYPES[q.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    decode_attention.launches += 1      # the one count of every K3 launch
    return out


decode_attention.launches = 0
