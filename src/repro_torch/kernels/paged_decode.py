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
mapped device address, so the cold pools must be pinned CPU tensors.  Each
CTA covers ``plan_tiles(...)`` KV heads and pages in tiles of that many
tokens; each slot's pages are split over ``plan_splits(...)`` CTAs whose
partial results a second kernel merges
(``kernels/ref.py::paged_decode_split_ref`` is that algorithm in plain
torch); one call counts as one launch.  This wrapper
takes CUDA inputs only: the plain version for CPU tensors is
``kernels/ref.py``, chosen by ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    lib = build.load("paged_decode")
    if lib.paged_decode_attention.argtypes is None:
        lib.paged_decode_attention.argtypes = [_P] * 11 + [_I] * 12 + [
            _F, _F, _I, _P]
        lib.paged_decode_attention.restype = _I
        lib.paged_decode_smem_limit.argtypes = [ctypes.POINTER(_I)]
        lib.paged_decode_smem_limit.restype = _I
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


RING_STAGES = 3         # kStages of csrc/paged_decode.cu


def smem_bytes(H: int, KVH: int, D: int, esize: int, kv_group: int,
               tile: int) -> int:
    """Dynamic shared memory of one split-kernel CTA covering ``kv_group``
    KV heads with ring buffers of ``tile`` tokens, as ``split_smem_bytes``
    in csrc/paged_decode.cu: f32 q, accumulator, scores and three row
    statistics for its query heads, then RING_STAGES buffers of K and V."""
    hq = kv_group * (H // KVH)
    return (4 * (2 * hq * D + hq * tile + 3 * hq) + 16
            + RING_STAGES * 2 * tile * kv_group * D * esize)


def plan_tiles(H: int, KVH: int, D: int, page: int, esize: int,
               smem_limit: int) -> tuple:
    """(KV heads per CTA, tokens per ring buffer): every KV head and whole
    pages where that ring fits in ``smem_limit`` bytes (a page's K for all
    heads is one contiguous block of the pool); else the most KV heads, a
    divisor of KVH, that fit with whole pages; else one KV head and the
    longest tile, a divisor of page, that fits.  Raises where not even one
    token of one head fits."""
    def fits(g, t):
        return smem_bytes(H, KVH, D, esize, g, t) <= smem_limit
    for g in range(KVH, 0, -1):
        if KVH % g == 0 and fits(g, page):
            return g, page
    for t in range(page, 0, -1):
        if page % t == 0 and fits(1, t):
            return 1, t
    raise ValueError(
        f"paged_decode_attention: {H // KVH} query heads of D {D} need "
        f"{smem_bytes(H, KVH, D, esize, 1, 1)} bytes of shared memory per "
        f"CTA, more than the card's {smem_limit}")


def plan_splits(B: int, groups: int, NP: int, n_sm: int) -> int:
    """CTAs each slot's NP logical pages are split over: enough that the
    B * groups * splits CTAs (``groups`` = KVH / KV heads per CTA) give
    every SM about one, at least 1 and at most NP.  Shapes and the SM count
    only: the lengths live on the card, and reading them would stall the
    host every layer."""
    return max(1, min(NP, -(-n_sm // (B * groups))))


@functools.lru_cache(maxsize=None)
def _smem_limit(index: int) -> int:
    """Opt-in shared memory bytes per CTA of card ``index``, asked once."""
    limit = _I()
    with torch.cuda.device(index):
        rc = _lib().paged_decode_smem_limit(ctypes.byref(limit))
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention: shared memory limit "
                           f"query failed (CUDA error {rc})")
    return limit.value


def plan(q: torch.Tensor, KVH: int, page: int, NP: int) -> tuple:
    """(splits, KV heads per CTA, tile) the wrapper launches with on q's
    card."""
    B, H, D = q.shape
    limit = _smem_limit(q.device.index if q.device.index is not None
                        else torch.cuda.current_device())
    group, tile = plan_tiles(H, KVH, D, page, q.element_size(), limit)
    return plan_splits(B, KVH // group, NP, sm_count(q.device)), group, tile


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

    out = _launch(q, k_hot, v_hot, k_cold, v_cold, page_table, page_tier,
                  lengths, window, softcap_val, *plan(q, KVH, page, NP))
    paged_decode_attention.launches += 1
    return out


def _launch(q, k_hot, v_hot, k_cold, v_cold, page_table, page_tier, lengths,
            window, softcap_val, splits, group, tile):
    """Both kernels on checked inputs with ``splits`` CTAs per slot and KV
    head group, each covering ``group`` KV heads in tiles of ``tile``
    tokens (``chip_smoke.py`` also runs other plans through it); raises on a
    failed launch."""
    B, H, D = q.shape
    n_hot, page, KVH, _ = k_hot.shape
    NP = page_table.shape[1]
    lib = _lib()
    out = torch.empty_like(q)
    # the partial o (B, splits, H, D) and then m, l (B, splits, H, 2), f32
    scratch = torch.empty(B * splits * H * (D + 2), dtype=torch.float32,
                          device=q.device)
    o_part = scratch[:B * splits * H * D]
    ml_part = scratch[B * splits * H * D:]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_attention(
            q.data_ptr(), k_hot.data_ptr(), v_hot.data_ptr(),
            _mapped_address(lib, k_cold), _mapped_address(lib, v_cold),
            page_table.data_ptr(), page_tier.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), o_part.data_ptr(), ml_part.data_ptr(), B, H,
            KVH, D, page, NP, n_hot, k_cold.shape[0], int(window),
            int(splits), int(group), int(tile), float(softcap_val),
            float(D ** -0.5),
            _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err}")
    return out


paged_decode_attention.launches = 0


# ----------------------------------------------------- dense -> pool layout ----

def pool_layout(cold_tokens, num_pages: int, page_tokens: int,
                device="cpu"):
    """Layer-independent pool layout from per-slot cold boundaries.

    ``cold_tokens`` (len B, ints): per-slot cold boundary in tokens; pages
    wholly below it go to the cold pool.  Physical pages interleave slots
    (slot-major over logical pages), so the table is a real indirection.
    Returns (page_table, page_tier) int32 (B, num_pages) on ``device`` and
    (hot_idx, cold_idx), the (slot, logical page) each physical page of the
    hot and the cold pool holds, in pool order: computed once per decode
    step, then every layer's pools are gathered from it."""
    B = len(cold_tokens)
    cold_pages = [int(c) // page_tokens for c in cold_tokens]
    hot_idx, cold_idx = [], []
    table = [[0] * num_pages for _ in range(B)]
    tier = [[0] * num_pages for _ in range(B)]
    for i in range(num_pages):
        for b in range(B):
            if i < cold_pages[b]:
                table[b][i], tier[b][i] = len(cold_idx), 1
                cold_idx.append((b, i))
            else:
                table[b][i], tier[b][i] = len(hot_idx), 0
                hot_idx.append((b, i))
    return (torch.tensor(table, dtype=torch.int32, device=device),
            torch.tensor(tier, dtype=torch.int32, device=device),
            tuple(hot_idx), tuple(cold_idx))


def gather_pools(k_cache, v_cache, layout, page_tokens: int):
    """One layer's (k_hot, v_hot, k_cold, v_cold) pools for a shared
    layout; k_cache, v_cache dense (B, S, KVH, D).  An empty pool holds one
    zero page.  The hot pools stay on the caches' device; on a CUDA cache
    the cold pools are copied into pinned host memory."""
    B, S, KVH, D = k_cache.shape
    if S % page_tokens:
        raise ValueError(f"{S} tokens are not whole {page_tokens}-token "
                         "pages")
    NP = S // page_tokens
    _, _, hot_idx, cold_idx = layout

    def gather(cache, idx, cold):
        if not idx:
            pages = torch.zeros((1, page_tokens, KVH, D), dtype=cache.dtype,
                                device=cache.device)
        else:
            paged = cache.reshape(B, NP, page_tokens, KVH, D)
            bs = torch.tensor([b for b, _ in idx], device=cache.device)
            ps = torch.tensor([i for _, i in idx], device=cache.device)
            pages = paged[bs, ps]
        if cold and pages.is_cuda:
            # a copy on the current stream, so it lands before the kernel
            # that reads the pool through its mapped address
            host = torch.empty(pages.shape, dtype=pages.dtype,
                               pin_memory=True)
            pages = host.copy_(pages)
        return pages

    return (gather(k_cache, hot_idx, False), gather(v_cache, hot_idx, False),
            gather(k_cache, cold_idx, True), gather(v_cache, cold_idx, True))


def pack_kv_pools(k_cache, v_cache, cold_tokens, page_tokens: int):
    """Pack dense caches (B, S, KVH, D) into the pool layout: (k_hot, v_hot,
    k_cold, v_cold, page_table, page_tier), from ``pool_layout`` and
    ``gather_pools``, for single-layer callers and the kernel checks."""
    layout = pool_layout(cold_tokens, k_cache.shape[1] // page_tokens,
                         page_tokens, device=k_cache.device)
    return (*gather_pools(k_cache, v_cache, layout, page_tokens),
            layout[0], layout[1])
