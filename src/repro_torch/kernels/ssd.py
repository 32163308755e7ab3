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
The kernels themselves run an internal chunk of ``INTERNAL_CHUNK`` tokens
whatever ``chunk`` is (the result does not depend on it beyond rounding).
Unlike the reference, the ``h0`` case runs the kernel too.

Two kernels, by a rule of the inputs alone (``path``): bf16 x, Bm and Cm
with P and N multiples of 8, each with a contiguous last dimension and
16-byte aligned rows, run the tensor-core kernel, which splits the sequence
into ``plan_segments(...)`` segments with a state-passing step
(``kernels/ref.py::ssd_split_ref`` is that algorithm in plain torch);
everything else (f32, P or N of 4 mod 8, other strides) runs the SIMT
kernel.  Either way one call counts as one launch.  This wrapper takes
CUDA inputs only: the plain version for CPU tensors is
``kernels/ref.py::ssd_chunked_ref``, chosen by ``kernels/ops.py``.

Under autograd (``ssd`` is a ``torch.autograd.Function``) the forward is
the kernel and the backward is the plain version's: it runs
``ssd_chunked_ref`` again on the saved inputs with grad enabled and
returns its gradients for x, dt, A, Bm, Cm and h0.  The reference has no
backward kernel either: it differentiates its jnp oracle.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build, ref

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
        lib.ssd_scan_mma.argtypes = [_P] * 9 + [_I] * 6 + [_L] * 10 + [_P]
        lib.ssd_scan_mma.restype = _I
        lib.ssd_mma_ctas_per_sm.argtypes = [ctypes.POINTER(_I)]
        lib.ssd_mma_ctas_per_sm.restype = _I
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


def segment_chunks(S: int, segments: int) -> tuple:
    """(segments, chunks a segment) when the ceil(S / INTERNAL_CHUNK)
    chunks are cut into ``segments`` runs of equal length, the last one
    shorter: ceil(chunks / segments) chunks each, which may leave fewer
    segments than asked."""
    nc = -(-S // INTERNAL_CHUNK)
    cps = -(-nc // max(1, min(segments, nc)))
    return -(-nc // cps), cps


def plan_segments(B: int, S: int, H: int, n_sm: int,
                  ctas_per_sm: int) -> int:
    """Segments the tensor-core kernel cuts the sequence into: as many as
    keep its B * H * segments CTAs of the last pass within one wave of
    ``ctas_per_sm`` an SM (what the card's occupancy API gives for that
    kernel, ``ctas_per_sm(device)``), at least 1 and at most the chunk
    count.  A segment beyond the first adds a first pass over it (the state
    update alone), so a count that spills into a second wave costs more
    than it gains.  Shapes and the card only.  On a 132-SM H100 (two CTAs
    an SM) at zamba2-7b's layer (S 4096, H 112): 1 segment at B 2, 2 of 32
    chunks at B 1."""
    return segment_chunks(S, max(1, ctas_per_sm * n_sm // (B * H)))[0]


@functools.lru_cache(maxsize=None)
def _ctas_per_sm(index: int) -> int:
    n = _I()
    with torch.cuda.device(index):
        rc = _lib().ssd_mma_ctas_per_sm(ctypes.byref(n))
    if rc != 0 or n.value < 1:
        raise RuntimeError(f"ssd: occupancy query failed (CUDA error {rc}, "
                           f"{n.value} CTAs an SM)")
    return n.value


def ctas_per_sm(device: torch.device) -> int:
    """CTAs of the tensor-core kernel's last pass one SM of CUDA card
    ``device`` holds at once, asked once per card."""
    return _ctas_per_sm(device.index if device.index is not None
                        else torch.cuda.current_device())


def plan(x: torch.Tensor) -> int:
    """The segment count the tensor-core kernel launches with on x's
    card."""
    B, S, H, _ = x.shape
    return plan_segments(B, S, H, sm_count(x.device), ctas_per_sm(x.device))


def path(x, Bm, Cm) -> str:
    """"mma", the tensor-core kernel, for bf16 inputs whose P and N are
    multiples of 8 and whose x, Bm and Cm each have a contiguous last
    dimension and 16-byte aligned rows (its loads are 16-byte cp.async);
    else "simt"."""
    P, N = x.shape[-1], Bm.shape[-1]

    def rows16(t):
        return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and \
            all(st * t.element_size() % 16 == 0 for st in t.stride()[:-1])

    ok = x.dtype == torch.bfloat16 and P % 8 == 0 and N % 8 == 0 and \
        all(rows16(t) for t in (x, Bm, Cm))
    return "mma" if ok else "simt"


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 256, h0=None):
    """Launch the kernel ``path`` picks on the current stream; returns (y,
    h).  Raises on any input the kernels do not take, and on a failed
    launch.  Differentiable: see ``_Scan``."""
    return _Scan.apply(x, dt, A, Bm, Cm, h0, chunk)


class _Scan(torch.autograd.Function):
    """The SSD scan under autograd: the kernel forward, the plain
    version's backward (``ssd_chunked_ref`` recomputed with grad, at the
    call's chunk).  Either output may go unused (a train step reads y
    only)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0, chunk):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, h0)
        return _launch(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)

    @staticmethod
    def backward(ctx, gy, gh):
        need = ctx.needs_input_grad[:6]
        ins = [None if t is None else t.detach().requires_grad_(n)
               for t, n in zip(ctx.saved_tensors, need)]
        wrt = [t for t, n in zip(ins, need) if n]
        with torch.enable_grad():
            y, h = ref.ssd_chunked_ref(*ins[:5], chunk=ctx.chunk, h0=ins[5])
        outs = [(o, g) for o, g in ((y, gy), (h, gh)) if g is not None]
        got = iter(torch.autograd.grad(
            [o for o, _ in outs], wrt, [g for _, g in outs],
            allow_unused=True) if outs else [None] * len(wrt))
        return tuple(next(got) if n else None for n in need) + (None,)


def _launch(x, dt, A, Bm, Cm, *, chunk, h0, kernel=None, block_heads=None,
            segments=None):
    """``ssd`` on ``kernel`` ("mma" or "simt"; None takes ``path``, and
    "mma" raises where ``path`` would not take it), the SIMT kernel with
    ``block_heads`` heads per CTA (1 or 2, dividing H; None takes
    ``_block_heads``), the tensor-core kernel with ``segments`` segments
    (None takes ``plan``).  Each of ``block_heads`` and ``segments`` raises
    when the kernel that runs is not the one it sets.  ``chip_smoke.py``
    checks and times the kernels and plans against each other through
    it."""
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
    picked = path(x, Bm, Cm)
    kernel = kernel or picked
    _check(kernel in ("mma", "simt"), f"kernel {kernel!r}")
    _check(kernel == "simt" or picked == "mma", "the tensor-core kernel "
           "takes bf16 x, Bm, Cm with P, N multiples of 8, a contiguous last "
           "dimension and 16-byte aligned rows")
    _check(block_heads is None or kernel == "simt", "block_heads sets the "
           "SIMT kernel, and the tensor-core kernel runs")
    _check(segments is None or kernel == "mma", "segments sets the "
           "tensor-core kernel, and the SIMT kernel runs")
    _check(x.is_cuda, "x must be a CUDA tensor (CPU inputs take the plain "
           "version through kernels.ops)")

    lib = _lib()
    A = A.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    h0_ptr = None if h0 is None else h0.data_ptr()
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if kernel == "mma":
            n_seg = segment_chunks(S, segments or plan(x))[0]
            # each pass-1 segment's state from zero (P N) and log-decay (1)
            scratch = torch.empty(max(1, (n_seg - 1) * B * H * (P * N + 1)),
                                  dtype=torch.float32, device=x.device)
            err = lib.ssd_scan_mma(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), h0_ptr, y.data_ptr(), h.data_ptr(),
                scratch.data_ptr(), B, S, H, P, N, n_seg,
                *x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                *Cm.stride()[:2], stream)
        else:
            bh = block_heads or _block_heads(B, H, sm_count(x.device))
            _check(1 <= bh <= MAX_HEADS and H % bh == 0,
                   f"block_heads {bh} must be 1..{MAX_HEADS} and divide {H} "
                   f"heads")
            err = lib.ssd_scan(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), h0_ptr, y.data_ptr(), h.data_ptr(), B, S, H,
                P, N, bh, *x.stride(), *dt.stride(), *Bm.stride(),
                *Cm.stride(), _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd launch failed: CUDA error {err}")
    ssd.launches += 1       # the one count of every K4 launch
    return y, h


ssd.launches = 0
