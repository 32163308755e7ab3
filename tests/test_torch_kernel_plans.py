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
  strides, and refuses strides TMA cannot take.

Inputs are made with numpy from a seed."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, list_archs
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as k2
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import ref

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
    kh, vh, kc, vc, tab, tier = ref.pack_kv_pools(
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
