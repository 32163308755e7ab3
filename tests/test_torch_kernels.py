"""The port's plain paged-decode version (repro_torch.kernels.ref) against
the reference's jnp oracle on the same inputs (made with numpy, packed by
the reference's pack_kv_pools, with FREE entries past each slot's length),
against the reference's dense decode oracle, and the dispatch rules: only
kernels.ops picks the plain version, and only for a CPU query."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_decode import pack_kv_pools
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import ref

F32_TOL = dict(atol=1e-5, rtol=1e-5)     # same math, other summation order
# the output's bf16 rounding may differ by one ulp, at most 2**-7 of the
# value: rtol at the output's own scale, atol for values near zero
BF16_TOL = dict(atol=2e-3, rtol=8e-3)


def make_case(B, S, H, KVH, D, page, dtype, seed=11, cold_frac=0.5):
    """(jax args, torch args, dense caches) for one paged-decode call."""
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.standard_normal((B, H, D), np.float32), dtype)
    kc = jnp.asarray(rng.standard_normal((B, S, KVH, D), np.float32), dtype)
    vc = jnp.asarray(rng.standard_normal((B, S, KVH, D), np.float32), dtype)
    lengths = np.array([S - 1 - (5 * b) % (S // 2) for b in range(B)],
                       np.int32)
    cold = [int(n * cold_frac) for n in lengths]
    kh, vh, kcold, vcold, tab, tier = pack_kv_pools(kc, vc, cold, page)
    tab, tier = np.array(tab), np.array(tier)
    for b, n in enumerate(lengths):           # unmapped pages past the end
        tab[b, -(-n // page):] = -1
        tier[b, -(-n // page):] = -1
    jargs = (q, kh, vh, kcold, vcold, jnp.asarray(tab), jnp.asarray(tier),
             jnp.asarray(lengths))

    def to_torch(a):
        a = np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 \
            else np.asarray(a)
        t = torch.from_numpy(a.copy())
        return t.to(torch.bfloat16) if dtype == jnp.bfloat16 and \
            t.is_floating_point() else t

    return jargs, tuple(to_torch(a) for a in jargs), (kc, vc)


def _close(out, want_jax, dtype):
    want = torch.from_numpy(np.array(want_jax.astype(jnp.float32)))
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), want, **tol)


@pytest.mark.parametrize("B,S,H,KVH,D,page", [
    (2, 64, 4, 2, 16, 8),
    (3, 128, 8, 4, 32, 16),
    (1, 32, 2, 1, 128, 8),       # MQA, page smaller than D
    (2, 96, 6, 2, 64, 16),       # non-power-of-two heads
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_matches_reference_oracle(B, S, H, KVH, D, page, dtype):
    jargs, targs, _ = make_case(B, S, H, KVH, D, page, dtype)
    out = ref.paged_decode_attention_ref(*targs)
    assert out.dtype == targs[0].dtype and out.shape == (B, H, D)
    _close(out, jref.paged_decode_attention_ref(*jargs), dtype)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 0.0), (0, 30.0),
                                        (16, 50.0)])
def test_plain_window_softcap_matches_reference(window, cap):
    jargs, targs, _ = make_case(2, 96, 4, 2, 32, 16, jnp.float32)
    out = ref.paged_decode_attention_ref(*targs, window=window,
                                         softcap_val=cap)
    want = jref.paged_decode_attention_ref(*jargs, window=window,
                                           softcap_val=cap)
    _close(out, want, jnp.float32)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 0.0), (8, 30.0)])
def test_plain_matches_dense_decode(window, cap):
    """Paging and the hot/cold split are a layout change only: the port's
    paged version agrees with the reference's dense decode oracle."""
    jargs, targs, (kc, vc) = make_case(2, 64, 4, 2, 32, 8, jnp.float32)
    out = ref.paged_decode_attention_ref(*targs, window=window,
                                         softcap_val=cap)
    want = jref.decode_attention_ref(jargs[0], kc, vc, jargs[7],
                                     window=window, softcap_val=cap)
    assert float((out - torch.from_numpy(np.array(want))).abs().max()) \
        < 1e-4


def test_kernel_wrapper_raises_on_cpu_tensors():
    """The wrapper launches the kernel or raises; it never computes the
    plain version itself."""
    _, targs, _ = make_case(2, 64, 4, 2, 16, 8, jnp.float32)
    before = pd.paged_decode_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        pd.paged_decode_attention(*targs)
    assert pd.paged_decode_attention.launches == before


def test_ops_dispatch_cpu_query_takes_plain_version():
    _, targs, _ = make_case(2, 64, 4, 2, 16, 8, jnp.float32)
    assert torch.equal(ops.paged_decode_attention(*targs),
                       ref.paged_decode_attention_ref(*targs))


def test_pack_kv_pools_matches_reference():
    """The port's pool packing gives the reference's layout exactly."""
    rng = np.random.default_rng(5)
    kc = rng.standard_normal((3, 64, 2, 16), np.float32)
    vc = rng.standard_normal((3, 64, 2, 16), np.float32)
    cold = [16, 0, 40]
    want = pack_kv_pools(jnp.asarray(kc), jnp.asarray(vc), cold, 8)
    got = pd.pack_kv_pools(torch.from_numpy(kc), torch.from_numpy(vc), cold,
                           8)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
