"""The plans the port's redesigned kernels run by, checked on the CPU:

- K1 (paged decode) splits each slot's pages over CTAs and merges their
  partial (o, m, l); ``kernels/ref.py::paged_decode_split_ref`` is that
  algorithm in plain torch and must equal the plain paged decode, and the
  JAX package's oracle, at f32 tolerance for every split count, 1 up to
  past NP;
- the split count comes from shapes and the SM count only;
- each K1 CTA covers as many KV heads, and as long a tile of each page, as
  fit in the card's shared memory, for every head shape the repo's
  configurations have;
- K2 (flash attention) loads bf16 tiles through TMA tensor maps that
  ``kernels/flash_attention.py::tma_map`` derives from each tensor's
  strides, and refuses strides TMA cannot take;
- K3 (flash decode) splits each slot's keys over CTAs by a rule of the
  shapes that bounds the keys a CTA reads, and merges the partials
  (``kernels/ref.py::decode_attention_split_ref``);
- K4's tensor-core kernel cuts the sequence into segments with a
  state-passing step and rounds its f32 operands to bf16 pairs
  (``kernels/ref.py::ssd_split_ref``), inside the card's limits.

Inputs are made with numpy from a seed."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, list_archs
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as k3
from repro_torch.kernels import flash_attention as k2
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import ref
from repro_torch.kernels import ssd as k4

F32_TOL = dict(atol=1e-5, rtol=1e-5)     # same math, other summation order

# B, S, H, KVH, D, page: the K1 sweep of tests/test_torch_kernels.py
K1_SWEEP = [(2, 64, 4, 2, 16, 8), (3, 128, 8, 4, 32, 16),
            (1, 32, 2, 1, 128, 8), (2, 96, 6, 2, 64, 16)]


def k1_case(B, S, H, KVH, D, page, seed=11, free_last=False):
    """Plain-version inputs: dense caches packed into pools with the first
    half of each slot's tokens cold, table entries past each slot's length
    FREE (-1), and optionally a last slot that is wholly unmapped."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, D), np.float32))
    kd = torch.from_numpy(rng.standard_normal((B, S, KVH, D), np.float32))
    vd = torch.from_numpy(rng.standard_normal((B, S, KVH, D), np.float32))
    lengths = [S - 1 - (5 * b) % (S // 2) for b in range(B)]
    kh, vh, kc, vc, tab, tier = pd.pack_kv_pools(
        kd, vd, [n // 2 for n in lengths], page)
    for b, n in enumerate(lengths):
        used = 0 if free_last and b == B - 1 else -(-n // page)
        tab[b, used:] = -1
        tier[b, used:] = -1
    return (q, kh, vh, kc, vc, tab, tier,
            torch.tensor(lengths, dtype=torch.int32))


def _split_counts(NP):
    return sorted({1, 2, 3, max(1, NP // 2), NP, NP + 1})


@pytest.mark.parametrize("shape", K1_SWEEP)
@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 0.0), (0, 30.0),
                                        (16, 50.0)])
def test_split_ref_matches_plain(shape, window, cap):
    args = k1_case(*shape)
    want = ref.paged_decode_attention_ref(*args, window=window,
                                          softcap_val=cap)
    oracle = torch.from_numpy(np.array(jref.paged_decode_attention_ref(
        *(jnp.asarray(t.numpy()) for t in args), window=window,
        softcap_val=cap)))
    NP = shape[1] // shape[5]
    for n_split in _split_counts(NP):
        got = ref.paged_decode_split_ref(*args, n_split=n_split,
                                         window=window, softcap_val=cap)
        assert got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(got, want, **F32_TOL,
                                   msg=lambda m: f"{n_split} splits: {m}")
        torch.testing.assert_close(
            got, oracle, **F32_TOL,
            msg=lambda m: f"{n_split} splits against the JAX oracle: {m}")


@pytest.mark.parametrize("window", [0, 24])
def test_split_ref_unmapped_slot(window):
    """A wholly unmapped slot reads clipped page 0 for its length, as the
    plain version does, whatever the split."""
    args = k1_case(3, 96, 6, 2, 32, 16, seed=4, free_last=True)
    want = ref.paged_decode_attention_ref(*args, window=window)
    for n_split in _split_counts(6):
        got = ref.paged_decode_split_ref(*args, n_split=n_split,
                                         window=window)
        torch.testing.assert_close(got, want, **F32_TOL)


def test_split_ref_empty_splits_carry_no_weight():
    """Splits wholly past a short slot's length, or before its window, hold
    m = NEG_INF and l = 0; the merge gives them weight 0 and no NaN."""
    args = list(k1_case(2, 128, 4, 2, 16, 8, seed=9))
    args[7] = torch.tensor([3, 127], dtype=torch.int32)    # one page used
    want = ref.paged_decode_attention_ref(*args, window=16)
    got = ref.paged_decode_split_ref(*args, n_split=16, window=16)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.parametrize("B", [1, 2, 8, 64, 512])
@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("NP", [1, 4, 64, 256])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_plan_splits_bounds(B, groups, NP, n_sm):
    n = pd.plan_splits(B, groups, NP, n_sm)
    assert isinstance(n, int) and 1 <= n <= NP


def test_plan_splits_reads_shapes_only():
    """The count is a function of B, the KV head groups, NP and the SM
    count: nothing that lives on the card (the lengths) is an argument, and
    more slots or more groups never ask for more splits per slot."""
    assert list(inspect.signature(pd.plan_splits).parameters) == \
        ["B", "groups", "NP", "n_sm"]
    for counts in ([pd.plan_splits(B, 1, 64, 132) for B in (1, 2, 4, 8, 64)],
                   [pd.plan_splits(8, g, 64, 132) for g in (1, 2, 3, 5)]):
        assert counts == sorted(counts, reverse=True)


H100_SMEM = 227 * 1024      # opt-in shared memory per CTA on sm_90
# (H, KVH, D) of every registered configuration, with each element size
# whose rows are whole 16-byte chunks (the wrapper refuses the others, such
# as lstm-ptb's D 650, before planning)
CONFIG_HEADS = sorted({((c.num_heads, c.num_kv_heads, c.head_dim), esize)
                       for c in map(get_config, list_archs())
                       for esize in (4, 2) if c.head_dim * esize % 16 == 0})


@pytest.mark.parametrize("heads,esize", CONFIG_HEADS)
@pytest.mark.parametrize("page", [8, 16, 64])
def test_plan_tiles_fits_every_config(heads, esize, page):
    """Every head shape of the repo's configurations, in f32 and bf16, gets
    a plan that fits the card: a divisor of KVH heads a CTA and a divisor
    of the page a tile, all heads and whole pages wherever those fit, and
    fewer KV heads before shorter tiles."""
    H, KVH, D = heads
    group, tile = pd.plan_tiles(H, KVH, D, page, esize, H100_SMEM)
    assert KVH % group == 0 and page % tile == 0
    assert pd.smem_bytes(H, KVH, D, esize, group, tile) <= H100_SMEM
    if pd.smem_bytes(H, KVH, D, esize, KVH, page) <= H100_SMEM:
        assert (group, tile) == (KVH, page)
    if tile < page:
        assert group == 1


@pytest.mark.parametrize("heads,esize,page,want", [
    ((15, 5, 64), 2, 16, (5, 16)),       # smollm-360m: all heads, whole pages
    ((24, 24, 64), 2, 16, (12, 16)),     # musicgen-medium: 2 CTAs a slot
    ((16, 8, 256), 2, 16, (4, 16)),      # gemma3-12b
    ((8, 4, 256), 4, 16, (2, 16)),       # gemma2-2b in f32
    ((8, 4, 256), 2, 16, (4, 16)),       # gemma2-2b in bf16: all heads
    ((16, 8, 128), 2, 16, (8, 16)),      # internlm2-1.8b
    ((24, 8, 64), 2, 16, (8, 16)),       # granite-moe-3b
    ((8, 1, 256), 4, 64, (1, 32)),       # paligemma-3b in f32, 64-token pages
])
def test_plan_tiles_at_config_shapes(heads, esize, page, want):
    assert pd.plan_tiles(*heads, page, esize, H100_SMEM) == want


def test_plan_tiles_raises_when_one_head_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        pd.plan_tiles(8, 1, 256, 16, 4, 8 * 1024)


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("make,want", [
    # contiguous (B, S, heads, D)
    (lambda: _bf16(2, 300, 4, 112),
     (112, 300, 4, 2, 4 * 112 * 2, 112 * 2, 300 * 4 * 112 * 2, 64, 128)),
    (lambda: torch.zeros(1, 64, 2, 64),                          # f32
     (64, 64, 2, 1, 2 * 64 * 4, 64 * 4, 64 * 2 * 64 * 4, 32, 128)),
    # q, k and v as head slices of one fused projection (B, S, H + 2 KVH, D)
    (lambda: _bf16(2, 130, 12, 64)[:, :, 8:10],
     (64, 130, 2, 2, 12 * 64 * 2, 64 * 2, 130 * 12 * 64 * 2, 64, 128)),
    # (B, heads, S, D) storage seen as (B, S, heads, D)
    (lambda: _bf16(2, 8, 50, 128).transpose(1, 2),
     (128, 50, 8, 2, 128 * 2, 50 * 128 * 2, 8 * 50 * 128 * 2, 64, 128)),
])
def test_tma_map(make, want):
    assert k2.tma_map(make()) == want


def _strided(shape, strides):
    return torch.zeros(4096, dtype=torch.bfloat16).as_strided(shape, strides)


@pytest.mark.parametrize("make", [
    lambda: _bf16(1, 16, 2, 12),                  # heads 24 bytes apart
    lambda: _strided((1, 16, 2, 8), (512, 20, 8, 1)),     # S 40 bytes apart
    lambda: _strided((2, 4, 2, 8), (100, 16, 8, 1)),      # B 200 bytes apart
    lambda: _bf16(1, 16, 2, 24)[..., 4:20],       # base 8 bytes off
    lambda: _bf16(1, 16, 2, 32)[..., ::2],        # last dim not contiguous
])
def test_tma_map_refuses(make):
    with pytest.raises(ValueError, match="tensor map"):
        k2.tma_map(make())


# ---------------------------------------------------------------- K3 ----
# K3 (flash decode over a contiguous cache) splits each slot's keys over
# CTAs and merges their partials; ``ref.decode_attention_split_ref`` is
# that algorithm.

# B, S, H, KVH, D, window: tests/test_kernels.py's decode sweep
K3_SWEEP = [(2, 256, 8, 2, 64, 0), (1, 100, 4, 4, 32, 0),
            (3, 512, 8, 1, 64, 64), (2, 64, 16, 8, 128, 16)]


def k3_case(B, S, H, KVH, D, window, seed=21):
    """f32 inputs; slot 0 has length 0 and, with a window and three slots,
    the last starts its window past S: both see no key (R5)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, KVH, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, KVH, D), np.float32))
    lengths = [0] + [S // 2 + 3 * b + 1 for b in range(1, B)]
    if window and B >= 3:
        lengths[-1] = S + window + 3
    return q, k, v, torch.tensor(lengths, dtype=torch.int32)


@pytest.mark.parametrize("shape", K3_SWEEP)
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_decode_split_ref_matches_plain(shape, cap):
    """For every split count, 1 up to past S (splits with an empty range,
    and splits that miss a slot's visible range, carry no weight), the
    split mirror equals the plain flash decode and the JAX package's
    oracle at f32 tolerance, rows without a visible key included."""
    *dims, window = shape
    args = k3_case(*dims, window)
    want = ref.decode_attention_ref(*args, window=window, softcap_val=cap)
    oracle = torch.from_numpy(np.array(jref.decode_attention_ref(
        *(jnp.asarray(t.numpy()) for t in args), window=window,
        softcap_val=cap)))
    S = dims[1]
    for n_split in sorted({1, 2, 3, 7, S // 3, S, S + 5}):
        got = ref.decode_attention_split_ref(*args, n_split=n_split,
                                             window=window, softcap_val=cap)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, **F32_TOL,
                                   msg=lambda m: f"{n_split} splits: {m}")
        torch.testing.assert_close(
            got, oracle, **F32_TOL,
            msg=lambda m: f"{n_split} splits against the JAX oracle: {m}")


def test_decode_split_ref_bf16_keeps_the_oracles_r5_rounding():
    """In bf16 a slot with no visible key still takes p = 1/S rounded to
    bf16, as the oracle does, whatever the split: the same output as the
    plain version on that slot (a mean of v in f32, rounded once)."""
    q, k, v, n = k3_case(2, 100, 4, 2, 32, 0, seed=3)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    want = ref.decode_attention_ref(q, k, v, n)
    for n_split in (1, 3, 100):
        got = ref.decode_attention_split_ref(q, k, v, n, n_split=n_split)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   atol=2e-3, rtol=8e-3)


@pytest.mark.parametrize("B", [1, 2, 8, 64])
@pytest.mark.parametrize("KVH", [1, 5, 32])
@pytest.mark.parametrize("S", [1, 100, 1024, 4096, 32768])
@pytest.mark.parametrize("D", [8, 64, 112, 256])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_decode_plan_splits_bounds(B, KVH, S, D, n_sm):
    """1 <= splits <= S, and no split holds more than KV_BYTES_PER_SPLIT
    of K and V in bf16 where S allows one key a split."""
    n = k3.plan_splits(B, KVH, S, D, n_sm)
    assert isinstance(n, int) and 1 <= n <= S
    keys = -(-S // n)
    assert keys * 4 * D <= max(k3.KV_BYTES_PER_SPLIT, 4 * D)


@pytest.mark.parametrize("scratch", [
    lambda n: torch.zeros(n - 1),                       # one short
    lambda n: torch.zeros(n, dtype=torch.float64),
    lambda n: torch.zeros(2 * n)[::2],                  # strided
])
def test_decode_launch_refuses_bad_scratch(scratch):
    """A caller's scratch for the partials must be B n_split H (D + 2)
    contiguous f32 on q's device; anything else raises before a launch."""
    q, k, v, n = k3_case(2, 64, 4, 2, 16, 0)
    size = k3.scratch_size(2, 4, 16, 3)
    assert size == 2 * 3 * 4 * (16 + 2)
    with pytest.raises(ValueError, match="scratch"):
        k3._launch(q, k, v, n, 0, 0.0, 3, scratch=scratch(size))


def test_decode_plan_splits_reads_shapes_only():
    """The count is a function of shapes and the SM count (the lengths
    live on the card): more slots or KV heads never ask for more splits,
    and the long cache (B 8 x KVH 32 x S 4096, D 112) gets more than one
    split on a 132-SM card, unlike K1's rule."""
    assert list(inspect.signature(k3.plan_splits).parameters) == \
        ["B", "KVH", "S", "D", "n_sm"]
    for counts in ([k3.plan_splits(B, 5, 1024, 64, 132)
                    for B in (1, 2, 4, 8, 64)],
                   [k3.plan_splits(8, kv, 1024, 64, 132)
                    for kv in (1, 2, 5, 32)]):
        assert counts == sorted(counts, reverse=True)
    assert k3.plan_splits(8, 32, 4096, 112, 132) == 15
    assert k3.plan_splits(8, 5, 1024, 64, 132) == 7
    assert pd.plan_splits(8, 32, 4096 // 16, 132) == 1


# ---------------------------------------------------------------- K4 ----
# K4's tensor-core kernel cuts the sequence into segments with a
# state-passing step and rounds its f32 operands to bf16 pairs;
# ``ref.ssd_split_ref`` is that algorithm.

SAME_TOL = 1e-4          # the same algorithm, other summation order
ORACLE_TOL = 1e-3        # another algorithm: test_kernels.py's SSD limit


def ssd_case(B, S, H, P, N, seed=0, with_h0=False):
    """numpy inputs as the reference kernel test draws them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.5).astype(np.float32) \
        if with_h0 else None
    return [x, dt, A, Bm, Cm], h0


def _err(got, want):
    return float((got.float() - torch.from_numpy(np.array(
        want, np.float32))).abs().max())


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 128, 8, 32, 64, 32), (2, 96, 2, 8, 32, 32),   # ragged internal chunk
    (1, 400, 2, 8, 16, 16)])                          # 7 chunks of 64
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_split_ref_matches_chunked(B, S, H, P, N, chunk, with_h0):
    """With f32 operands the segmented scan equals ssd_chunked_ref (same
    algorithm), the JAX package's ssd_chunked_ref and ssd_ref, at one
    segment, at segment counts that do not divide the chunk count, and at
    more segments than chunks."""
    arrs, h0 = ssd_case(B, S, H, P, N, seed=7, with_h0=with_h0)
    ta = [torch.from_numpy(a) for a in arrs]
    th0 = None if h0 is None else torch.from_numpy(h0)
    y_c, h_c = ref.ssd_chunked_ref(*ta, chunk=chunk, h0=th0)
    ja = [jnp.asarray(a) for a in arrs]
    jh0 = None if h0 is None else jnp.asarray(h0)
    y_j, h_j = jref.ssd_chunked_ref(*ja, chunk=chunk, h0=jh0)
    y_s, h_s = jref.ssd_ref(*ja, h0=jh0)
    for segments in (1, 2, 3, 5, 9):
        y, h = ref.ssd_split_ref(*ta, segments=segments, h0=th0)
        assert y.shape == (B, S, H, P) and h.dtype == torch.float32
        assert _err(y, y_c) < SAME_TOL and _err(h, h_c) < SAME_TOL, segments
        assert _err(y, y_j) < SAME_TOL and _err(h, h_j) < SAME_TOL, segments
        assert _err(y, y_s) < ORACLE_TOL and _err(h, h_s) < ORACLE_TOL


def test_ssd_split_ref_segments_pass_the_state():
    """A cut into segments changes nothing but rounding: the state a
    segment starts from is the state the one before ends in."""
    arrs, h0 = ssd_case(1, 640, 2, 16, 16, seed=8, with_h0=True)
    ta = [torch.from_numpy(a) for a in arrs]
    y1, h1 = ref.ssd_split_ref(*ta, segments=1, h0=torch.from_numpy(h0))
    for segments in (2, 4, 10):
        y, h = ref.ssd_split_ref(*ta, segments=segments,
                                 h0=torch.from_numpy(h0))
        torch.testing.assert_close(y, y1, atol=SAME_TOL, rtol=0.0)
        torch.testing.assert_close(h, h1, atol=SAME_TOL, rtol=0.0)


def k4_tol(dtype):
    """chip_smoke.py::_k4_tol: atol 1e-3 in f32 and for the f32 state;
    atol 2e-3 + rtol 8e-3 for a bf16 y."""
    return dict(atol=1e-3, rtol=0.0) if dtype == torch.float32 \
        else dict(atol=2e-3, rtol=8e-3)


@pytest.mark.parametrize("segments", [1, 3])
def test_ssd_bf16x2_operands_stay_inside_the_card_limits(segments):
    """The kernel's precision plan before the card tests it: bf16 inputs
    over 16 chunks (B 1 x S 1024 x H 4, P = N = 64), G, w x and h each
    split into two bf16 parts; y and the f32 state stay inside
    chip_smoke.py's K4 limits against the f32 chunked plain version."""
    arrs, h0 = ssd_case(1, 1024, 4, 64, 64, seed=9, with_h0=True)
    ta = [torch.from_numpy(a) for a in arrs]
    ta = [t if i == 2 else t.to(torch.bfloat16) for i, t in enumerate(ta)]
    th0 = torch.from_numpy(h0)
    y_w, h_w = ref.ssd_chunked_ref(*ta, chunk=256, h0=th0)
    y, h = ref.ssd_split_ref(*ta, segments=segments, h0=th0,
                             operands="bf16x2")
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), y_w.float(),
                               **k4_tol(torch.bfloat16))
    torch.testing.assert_close(h, h_w, **k4_tol(torch.float32))


def test_round_operand():
    t = torch.tensor([1.0 + 2.0 ** -12, -3.3e-3, 1234.567, 0.0])
    assert torch.equal(ref.round_operand(t, "f32"), t)
    r = ref.round_operand(t, "bf16x2")
    assert float(((r - t).abs() / t.abs().clamp(min=1e-30)).max()) < 2 ** -16
    r = ref.round_operand(t, "tf32")
    assert float(((r - t).abs() / t.abs().clamp(min=1e-30)).max()) <= 2 ** -11
    with pytest.raises(ValueError):
        ref.round_operand(t, "fp8")


@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("S", [1, 40, 64, 1000, 4096])
@pytest.mark.parametrize("H", [1, 4, 112])
@pytest.mark.parametrize("n_sm", [1, 132])
@pytest.mark.parametrize("ctas", [1, 2, 4])
def test_ssd_plan_segments_bounds(B, S, H, n_sm, ctas):
    """1 <= segments <= chunks, every segment holds a chunk, the count is
    what segment_chunks gives back for it, and a count above 1 keeps the
    last pass's B * H * segments CTAs within one wave of ``ctas`` an SM."""
    n = k4.plan_segments(B, S, H, n_sm, ctas)
    nc = -(-S // k4.INTERNAL_CHUNK)
    assert isinstance(n, int) and 1 <= n <= nc
    got, cps = k4.segment_chunks(S, n)
    assert got == n and (n - 1) * cps < nc <= n * cps
    assert n == 1 or B * H * n <= ctas * n_sm


def test_ssd_plan_segments_at_zamba2():
    """zamba2-7b's layer on a 132-SM card at two CTAs an SM: 1 segment at
    B 2, 2 of 32 chunks at B 1; the count reads shapes and the card only,
    and more rows or heads never ask for more segments."""
    assert list(inspect.signature(k4.plan_segments).parameters) == \
        ["B", "S", "H", "n_sm", "ctas_per_sm"]
    assert k4.plan_segments(2, 4096, 112, 132, 2) == 1
    assert k4.plan_segments(1, 4096, 112, 132, 2) == 2
    counts = [k4.plan_segments(B, 4096, 112, 132, 2) for B in (1, 2, 4, 8)]
    assert counts == sorted(counts, reverse=True)
    assert k4.segment_chunks(4096, 3) == (3, 22)
    assert k4.segment_chunks(4096, 100) == (64, 1)


@pytest.mark.parametrize("dtype,opt,msg", [
    (torch.bfloat16, {"block_heads": 2}, "block_heads"),     # runs mma
    (torch.bfloat16, {"kernel": "simt", "segments": 2}, "segments"),
    (torch.float32, {"segments": 2}, "segments"),            # runs simt
    (torch.float32, {"kernel": "mma"}, "tensor-core kernel takes"),
    (torch.bfloat16, {"kernel": "simt", "block_heads": 2}, "CUDA tensor"),
    (torch.bfloat16, {"segments": 2}, "CUDA tensor"),
])
def test_ssd_launch_refuses_options_of_the_other_kernel(dtype, opt, msg):
    """An option of one kernel given to a call that runs the other raises
    before anything launches (no option is dropped in silence); options
    that fit reach the card check, which a CPU tensor fails."""
    arrs, _ = ssd_case(1, 64, 2, 16, 16)
    ta = [t if i == 2 else t.to(dtype)
          for i, t in enumerate(torch.from_numpy(a) for a in arrs)]
    with pytest.raises(ValueError, match=msg):
        k4._launch(*ta, chunk=64, h0=None, **opt)


@pytest.mark.parametrize("make,want", [
    (lambda: (_bf16(2, 64, 4, 64), _bf16(2, 64, 64), _bf16(2, 64, 64)),
     "mma"),
    (lambda: (torch.zeros(2, 64, 4, 64), torch.zeros(2, 64, 64),
              torch.zeros(2, 64, 64)), "simt"),                 # f32
    (lambda: (_bf16(1, 64, 2, 12), _bf16(1, 64, 16), _bf16(1, 64, 16)),
     "simt"),                                                   # P 12
    (lambda: (_bf16(1, 64, 2, 16), _bf16(1, 64, 20), _bf16(1, 64, 20)),
     "simt"),                                                   # N 20
    # the model's layout: x, B and C as column slices of one projection
    (lambda: (lambda xbc: (xbc[..., :448].reshape(2, 64, 7, 64),
                           xbc[..., 448:512], xbc[..., 512:]))(
        _bf16(2, 64, 576)), "mma"),
    # rows 8 bytes off 16-byte alignment
    (lambda: (lambda xbc: (xbc[..., 4:68].reshape(2, 64, 1, 64),
                           xbc[..., 68:132], xbc[..., 132:196]))(
        _bf16(2, 64, 200)), "simt"),
])
def test_ssd_path_rule(make, want):
    x, Bm, Cm = make()
    assert k4.path(x, Bm, Cm) == want
