"""Paged flash-decode over tiered KV pools: the wrapper of the hand-written
Hopper kernel ``csrc/paged_decode.cu`` (the port of
``repro/kernels/paged_decode.py::paged_decode_attention``).

Layout, as the reference:

  q                (B, H, D)            device
  k_hot / v_hot    (n_hot, page, KVH, D)  device memory
  k_cold / v_cold  (n_cold, page, KVH, D) pinned host memory
  page_table       (B, NP) int32        physical page in the pool named by
  page_tier        (B, NP) int32        0 = hot pool, anything else = cold
  lengths          (B,) int32           valid tokens per slot

The kernel reads cold pages straight from the pinned host pool through its
mapped device address, so the cold pools must be pinned CPU tensors.  This
wrapper takes CUDA inputs only: the plain version for CPU tensors is
``kernels/ref.py``, chosen by ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    lib = build.load("paged_decode")
    if lib.paged_decode_attention.argtypes is None:
        lib.paged_decode_attention.argtypes = [_P] * 9 + [_I] * 9 + [
            _F, _F, _I, _P]
        lib.paged_decode_attention.restype = _I
        lib.host_device_pointer.argtypes = [_P, ctypes.POINTER(_P)]
        lib.host_device_pointer.restype = _I
    return lib


_mapped: dict = {}          # pinned storage's host address -> device address


def _mapped_address(lib, t: torch.Tensor) -> int:
    """Device address of pinned host tensor ``t``: the mapped address of its
    storage plus the tensor's offset into it.  The mapped address comes from
    cudaHostGetDevicePointer (return code checked), asked once per storage
    address: the pools ask it every layer of every step, and a pinned host
    address maps to one device address for as long as the process runs
    (unified addressing, which every sm_90 card has)."""
    base = t.untyped_storage().data_ptr()
    dev = _mapped.get(base)
    if dev is None:
        out = _P()
        rc = lib.host_device_pointer(_P(base), ctypes.byref(out))
        if rc != 0 or not out.value:
            raise RuntimeError(
                f"cudaHostGetDevicePointer failed (error {rc}) on a cold pool")
        dev = _mapped[base] = out.value
    return dev + (t.data_ptr() - base)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_decode_attention: {msg}")


def paged_decode_attention(q, k_hot, v_hot, k_cold, v_cold, page_table,
                           page_tier, lengths, *, window: int = 0,
                           softcap_val: float = 0.0):
    """Launch the kernel on the current stream; returns (B, H, D) in q's
    dtype.  Raises on any input the kernel does not take."""
    _check(q.is_cuda, "q must be a CUDA tensor (CPU inputs take the plain "
           "version through kernels.ops)")
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} is not float32/bfloat16")
    B, H, D = q.shape
    _check(k_hot.dim() == 4, "pools must be (n, page, KVH, D)")
    n_hot, page, KVH, _ = k_hot.shape
    n_cold = k_cold.shape[0]
    NP = page_table.shape[1]
    _check(H % KVH == 0, f"{H} query heads not a multiple of {KVH} KV heads")
    for name, t, shape in (("k_hot", k_hot, (n_hot, page, KVH, D)),
                           ("v_hot", v_hot, (n_hot, page, KVH, D)),
                           ("k_cold", k_cold, (n_cold, page, KVH, D)),
                           ("v_cold", v_cold, (n_cold, page, KVH, D))):
        _check(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != "
               f"{shape}")
        _check(t.dtype == q.dtype, f"{name} dtype {t.dtype} != {q.dtype}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
    for name, t in (("k_hot", k_hot), ("v_hot", v_hot)):
        _check(t.device == q.device, f"{name} is not on {q.device}")
    for name, t in (("k_cold", k_cold), ("v_cold", v_cold)):
        _check(t.device.type == "cpu" and t.is_pinned(),
               f"{name} must be a pinned host tensor")
    for name, t, shape in (("page_table", page_table, (B, NP)),
                           ("page_tier", page_tier, (B, NP)),
                           ("lengths", lengths, (B,))):
        _check(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != "
               f"{shape}")
        _check(t.dtype == torch.int32, f"{name} must be int32")
        _check(t.device == q.device, f"{name} is not on {q.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(q.is_contiguous(), "q must be contiguous")
    _check(D * q.element_size() % 16 == 0,
           f"head_dim {D} is not a whole number of 16-byte chunks")
    _check(n_hot > 0 and n_cold > 0, "empty pool")

    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_attention(
            q.data_ptr(), k_hot.data_ptr(), v_hot.data_ptr(),
            _mapped_address(lib, k_cold), _mapped_address(lib, v_cold),
            page_table.data_ptr(), page_tier.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, H, KVH, D, page, NP, n_hot, n_cold,
            int(window), float(softcap_val), float(D ** -0.5),
            _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
