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
raises (it never copies a cache).  Each slot's keys are split over
``plan_splits(...)`` CTAs whose partial results a second kernel merges
(``kernels/ref.py::decode_attention_split_ref`` is that algorithm in plain
torch); one call counts as one launch.  What bounds the kernel on this card
(bytes) and what its design does about that is noted in the CUDA source.
This wrapper takes CUDA inputs only: the plain version for CPU tensors is
``kernels/ref.py::decode_attention_ref``, chosen by ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import sm_count
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
        lib.decode_attention.argtypes = [_P] * 7 + [_I] * 7 + [_F] * 2 + \
            [_L] * 8 + [_I, _P]
        lib.decode_attention.restype = _I
    return lib


KV_BYTES_PER_SPLIT = 128 << 10     # K and V a CTA reads at most, in bf16


def plan_splits(B: int, KVH: int, S: int, D: int, n_sm: int) -> int:
    """CTAs each slot's S keys are split over: enough that the B * KVH *
    splits CTAs give every SM two, and enough that no split holds more keys
    than ``KV_BYTES_PER_SPLIT`` of K and V in bf16 (4 D bytes a key), so a
    long slot is read by many SMs at once; at least 1 and at most S.
    Shapes and the SM count only: the lengths live on the card, and reading
    them would stall the host every call.  On a 132-SM card: 7 at the
    serving KV (B 8, KVH 5, S 1024, D 64), 15 at the long cache (B 8,
    KVH 32, S 4096, D 112)."""
    fill = -(-2 * n_sm // (B * KVH))
    by_bytes = -(-S // max(1, KV_BYTES_PER_SPLIT // (4 * D)))
    return max(1, min(S, max(fill, by_bytes)))


def plan(q: torch.Tensor, KVH: int, S: int) -> int:
    """The split count the wrapper launches with on q's card."""
    B, _, D = q.shape
    return plan_splits(B, KVH, S, D, sm_count(q.device))


def scratch_size(B: int, H: int, D: int, n_split: int) -> int:
    """f32 elements of the split partials: B n_split H (D + 2)."""
    return B * n_split * H * (D + 2)


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

    out = _launch(q, k_cache, v_cache, lengths, window, softcap_val,
                  plan(q, KVH, S))
    decode_attention.launches += 1      # the one count of every K3 launch
    return out


def _launch(q, k_cache, v_cache, lengths, window, softcap_val, n_split,
            scratch=None):
    """Both kernels on checked inputs with ``n_split`` CTAs per slot (1 to
    S), their partials in ``scratch`` (None: a new buffer of
    ``scratch_size`` f32, uninitialised; the kernels write all of it
    before the merge reads it).  ``chip_smoke.py`` also runs other counts,
    and scratch filled with NaN, through it.  Raises on a failed launch."""
    B, H, D = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    _check(1 <= n_split <= min(S, 65535),
           f"n_split {n_split} not in [1, {min(S, 65535)}]")
    # the partial o (B, n_split, H, D) and then m, l (B, n_split, H, 2), f32
    size = scratch_size(B, H, D, n_split)
    if scratch is None:
        scratch = torch.empty(size, dtype=torch.float32, device=q.device)
    _check(scratch.dtype == torch.float32 and scratch.device == q.device
           and scratch.is_contiguous() and scratch.numel() == size,
           f"scratch must be {size} contiguous f32 on {q.device}")
    lib = _lib()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    o_part = scratch[:B * n_split * H * D]
    ml_part = scratch[B * n_split * H * D:]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), o_part.data_ptr(),
            ml_part.data_ptr(), B, S, H, KVH, D, int(window), int(n_split),
            float(softcap_val), float(D ** -0.5), *q.stride()[:2],
            *k_cache.stride()[:3], *v_cache.stride()[:3], _DTYPES[q.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    return out


decode_attention.launches = 0
