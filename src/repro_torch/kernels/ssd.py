"""Mamba2 SSD chunked scan: the wrapper of the hand-written Hopper kernel
``csrc/ssd.cu`` (the port of ``repro/kernels/mamba2.py::ssd``).

Layout, as the reference's ``ssd``:

  x        (B, S, H, P)   float32 or bfloat16, any strides
  dt       (B, S, H)      x's dtype, any strides
  A        (H,)           float32 (negative)
  Bm, Cm   (B, S, N)      x's dtype, any strides; one group for all heads
  h0       (B, H, P, N)   float32, optional start state

It returns y (B, S, H, P) in x's dtype and the final state h (B, H, P, N) in
float32.  The contract is the reference's: q = min(chunk, S) and S % q == 0.
The kernel itself runs an internal chunk of ``INTERNAL_CHUNK`` tokens
whatever ``chunk`` is (the result does not depend on it beyond rounding).
Unlike the reference, the ``h0`` case runs the kernel too.  This wrapper
takes CUDA inputs only: the plain version for CPU tensors is
``kernels/ref.py::ssd_chunked_ref``, chosen by ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

INTERNAL_CHUNK = 64          # kQ in csrc/ssd.cu
MAX_DIM = 64                 # P and N at most this, multiples of 4
MAX_HEADS = 2                # heads per CTA, 256 threads each
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = build.load("ssd")
    if lib.ssd_scan.argtypes is None:
        lib.ssd_scan.argtypes = [_P] * 8 + [_I] * 6 + [_L] * 13 + [_I, _P]
        lib.ssd_scan.restype = _I
    return lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"ssd: {msg}")


def check_chunk(S: int, chunk: int) -> int:
    """The reference's contract: q = min(chunk, S) must divide S."""
    q = min(chunk, S)
    _check(q > 0 and S % q == 0, f"seq {S} % chunk {q} != 0")
    return q


def _block_heads(B: int, H: int, n_sm: int) -> int:
    """Heads per CTA: C B^T of a chunk is computed once per CTA and shared by
    its heads, so take two when H is even and B * H / 2 CTAs still cover
    three quarters of the SMs, else one.  At the full-width zamba2 layer on
    an H100 (132 SMs) two heads win at B 2 and lose at B 1 (chip_smoke.py
    times both in turns)."""
    return 2 if H % 2 == 0 and B * H // 2 >= (3 * n_sm) // 4 else 1


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 256, h0=None):
    """Launch the kernel on the current stream; returns (y, h).  Raises on
    any input the kernel does not take, and on a failed launch."""
    return _launch(x, dt, A, Bm, Cm, chunk=chunk, h0=h0, block_heads=None)


def _launch(x, dt, A, Bm, Cm, *, chunk, h0, block_heads):
    """``ssd`` with ``block_heads`` heads per CTA (1 or 2, dividing H; None
    takes ``_block_heads``)."""
    _check(x.dim() == 4, "x must be (B, S, H, P)")
    B, S, H, P = x.shape
    _check(Bm.dim() == 3, "Bm must be (B, S, N)")
    N = Bm.shape[-1]
    check_chunk(S, chunk)
    for name, t, shape in (("dt", dt, (B, S, H)), ("A", A, (H,)),
                           ("Bm", Bm, (B, S, N)), ("Cm", Cm, (B, S, N))):
        _check(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != "
               f"{shape}")
    if h0 is not None:
        _check(tuple(h0.shape) == (B, H, P, N), f"h0 shape {tuple(h0.shape)} "
               f"!= {(B, H, P, N)}")
    _check(x.is_cuda, "x must be a CUDA tensor (CPU inputs take the plain "
           "version through kernels.ops)")
    _check(x.dtype in _DTYPES, f"dtype {x.dtype} is not float32/bfloat16")
    for name, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        _check(t.dtype == x.dtype, f"{name} dtype {t.dtype} != {x.dtype}")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                    ("h0", h0)):
        _check(t is None or t.device == x.device,
               f"{name} is not on {x.device}")
    _check(A.dtype == torch.float32, "A must be float32")
    _check(h0 is None or h0.dtype == torch.float32, "h0 must be float32")
    _check(P % 4 == 0 and N % 4 == 0 and 4 <= P <= MAX_DIM
           and 4 <= N <= MAX_DIM, f"P {P} and N {N} must be multiples of 4 "
           f"in [4, {MAX_DIM}]")
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    bh = block_heads or _block_heads(B, H, n_sm)
    _check(1 <= bh <= MAX_HEADS and H % bh == 0,
           f"block_heads {bh} must be 1..{MAX_HEADS} and divide {H} heads")

    lib = _lib()
    A = A.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h.data_ptr(), B, S, H, P, N, bh, *x.stride(),
            *dt.stride(), *Bm.stride(), *Cm.stride(), _DTYPES[x.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"ssd launch failed: CUDA error {err}")
    ssd.launches += 1       # the one count of every K4 launch
    return y, h


ssd.launches = 0
