"""The port's plain flash attention and flash decode
(``repro_torch.kernels.ref.attention_ref`` / ``decode_attention_ref``, the
CPU route of ``kernels.ops.flash_attention`` / ``decode_attention``)
against the reference's Pallas kernels in interpret mode and against its
jnp oracles, on the same inputs made with numpy; the entry points'
dispatch; and the refusals of the K2 / K3 wrappers, which need no card.

Tolerances:
- f32: atol 1e-5, the same math summed in another order.
- bf16 against the JAX oracle: atol 2e-3 + rtol 8e-3 (K1's limit): both
  round p to bf16 before P.V, so the outputs may differ by one bf16 ulp,
  at most 2**-7 of the value (atol for values near zero).
- bf16 against the JAX kernel: that limit plus 2**-8 * (p . |v|).  The
  kernel keeps p in f32 where the oracle rounds it to bf16, and rounding
  moves each p by at most 2**-8 of itself.  Without the term the K1 limit
  is exceeded (by up to 1.7 times on the reference sweep).

Rows with no visible key (causal with Sq > Skv; a decode slot of length 0)
are held to the JAX oracle, whose softmax over scores that are all NEG_INF
is uniform: the mean of v over every real key.  The JAX kernels differ
there, because they also average in their zero padding (R5 in ROADMAP.md),
so those rows are left out of the comparison with the kernel, and the test
shows the difference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import decode_attention as k3
from repro_torch.kernels import flash_attention as k2
from repro_torch.kernels import ops
from repro_torch.kernels import ref

F32_TOL = dict(atol=1e-5, rtol=0.0)
BF16_TOL = dict(atol=2e-3, rtol=8e-3)
P_ROUNDING = 2.0 ** -8
DTYPES = [jnp.float32, jnp.bfloat16]

# B, Sq, Skv, H, KVH, D: tests/test_kernels.py's flash sweep
FLASH_SWEEP = [(2, 128, 128, 4, 2, 64), (1, 64, 256, 8, 8, 32),
               (2, 100, 100, 6, 2, 64), (1, 1, 160, 4, 1, 64),
               (1, 32, 32, 2, 1, 128)]
# B, S, H, KVH, D, window: tests/test_kernels.py's decode sweep
DECODE_SWEEP = [(2, 256, 8, 2, 64, 0), (1, 100, 4, 4, 32, 0),
                (3, 512, 8, 1, 64, 64), (2, 64, 16, 8, 128, 16)]
WINDOW_SOFTCAP = [(0, 0.0), (16, 0.0), (0, 50.0), (8, 30.0)]


def arrays(shapes, dtype, seed):
    """Standard normal arrays of ``shapes``, as (jax arrays, torch tensors)
    holding the same values in ``dtype``."""
    rng = np.random.default_rng(seed)
    js, ts = [], []
    for shape in shapes:
        j = jnp.asarray(rng.standard_normal(shape, np.float32), dtype)
        js.append(j)
        t = torch.from_numpy(np.array(j.astype(jnp.float32)))
        ts.append(t.to(torch.bfloat16) if dtype == jnp.bfloat16 else t)
    return js, ts


def as_torch(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


def assert_close(out, want, dtype, *, p_abs_v=None, rows=None):
    """``out`` (torch, the port's plain version) against ``want`` (jax) at
    the limits of the module docstring; ``p_abs_v`` adds the p-rounding
    term; ``rows`` selects what to compare along the second axis."""
    want = as_torch(want)
    out = out.float()
    if rows is not None:
        out, want = out[:, rows], want[:, rows]
        p_abs_v = None if p_abs_v is None else p_abs_v[:, rows]
    if dtype == jnp.float32:
        torch.testing.assert_close(out, want, **F32_TOL)
        return
    err = (out - want).abs()
    limit = BF16_TOL["atol"] + BF16_TOL["rtol"] * want.abs()
    if p_abs_v is not None:
        limit = limit + P_ROUNDING * p_abs_v
    worst = float((err / limit).max())
    assert worst <= 1.0, f"max error / limit {worst:.3f}"


def flash_case(B, Sq, Skv, H, KVH, D, dtype, seed=3):
    return arrays([(B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D)],
                  dtype, seed)


def check_flash(shape, dtype, *, block=32, rows=None, **kw):
    """The port's attention_ref against the JAX oracle and, on ``rows``,
    the JAX kernel in interpret mode.  Returns the three outputs."""
    (qj, kj, vj), (q, k, v) = flash_case(*shape, dtype)
    out = ref.attention_ref(q, k, v, **kw)
    assert out.dtype == q.dtype and out.shape == q.shape
    want = jref.attention_ref(qj, kj, vj, **kw)
    assert_close(out, want, dtype)
    kern = jax_flash(qj, kj, vj, block_q=block, block_k=block,
                     interpret=True, **kw)
    p_abs_v = ref.attention_ref(q.float(), k.float(), v.float().abs(), **kw)
    assert_close(out, kern, dtype, p_abs_v=p_abs_v, rows=rows)
    return out, want, kern


@pytest.mark.parametrize("shape", FLASH_SWEEP)
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_matches_reference(shape, dtype):
    check_flash(shape, dtype)


@pytest.mark.parametrize("window,cap", WINDOW_SOFTCAP)
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_window_softcap(window, cap, dtype):
    check_flash((2, 64, 64, 4, 2, 32), dtype, block=16, window=window,
                softcap_val=cap)


@pytest.mark.parametrize("shape,kw", [
    ((1, 40, 96, 6, 2, 112), {}),                   # Sq < Skv, G 3, D 112
    ((1, 24, 24, 2, 1, 256), {}),                   # D 256
    ((2, 50, 80, 6, 2, 16), {"causal": False, "window": 12}),
    ((1, 33, 70, 3, 1, 64), {"causal": False}),
])
def test_attention_further_cases(shape, kw):
    check_flash(shape, jnp.float32, block=16, **kw)


@pytest.mark.parametrize("shape", [(1, 48, 40, 2, 2, 32),
                                   (2, 70, 30, 4, 2, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_rows_without_visible_key(shape, dtype):
    """Causal with Sq > Skv: the first Sq - Skv rows see no key.  The port
    gives the JAX oracle's answer on every row, the mean of v over the Skv
    keys on those; the JAX kernel agrees on the other rows only."""
    Sq, Skv = shape[1], shape[2]
    empty = Sq - Skv
    out, want, kern = check_flash(shape, dtype, block=16,
                                  rows=slice(empty, None))
    _, (_, _, v) = flash_case(*shape, dtype)
    G = shape[3] // shape[4]
    mean = v.float().mean(dim=1).repeat_interleave(G, dim=1)  # (B, H, D)
    torch.testing.assert_close(out[:, :empty].float(),
                               mean[:, None].expand(-1, empty, -1, -1),
                               atol=2e-2 if dtype == jnp.bfloat16 else 1e-5,
                               rtol=0.0)
    gap = float((as_torch(kern)[:, :empty] - as_torch(want)[:, :empty])
                .abs().max())
    assert gap > 1e-2, "the JAX kernel now agrees with its oracle (R5)"


def decode_case(B, S, H, KVH, D, dtype, seed=5, lengths=None):
    (qj, kj, vj), (q, k, v) = arrays(
        [(B, H, D), (B, S, KVH, D), (B, S, KVH, D)], dtype, seed)
    if lengths is None:
        lengths = [S // 2 + 3 * i + 1 for i in range(B)]
    lengths = np.array(lengths, np.int32)
    return (qj, kj, vj, jnp.asarray(lengths)), \
        (q, k, v, torch.from_numpy(lengths))


def check_decode(shape, dtype, *, window=0, cap=0.0, lengths=None,
                 slots=None):
    """The port's decode_attention_ref against the JAX oracle and, on
    ``slots``, the JAX kernel in interpret mode."""
    B, S, H, KVH, D = shape
    jargs, targs = decode_case(B, S, H, KVH, D, dtype, lengths=lengths)
    kw = dict(window=window, softcap_val=cap)
    out = ref.decode_attention_ref(*targs, **kw)
    assert out.dtype == targs[0].dtype and out.shape == (B, H, D)
    want = jref.decode_attention_ref(*jargs, **kw)
    assert_close(out, want, dtype)
    kern = jax_decode(*jargs, block_k=64, interpret=True, **kw)
    q, k, v, n = targs
    p_abs_v = ref.decode_attention_ref(q.float(), k.float(),
                                       v.float().abs(), n, **kw)
    sel = slice(None) if slots is None else slots
    assert_close(out[sel][None], kern[sel][None], dtype,
                 p_abs_v=p_abs_v[sel][None])
    return out, want, kern, targs


@pytest.mark.parametrize("case", DECODE_SWEEP)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_reference(case, dtype):
    *shape, window = case
    check_decode(tuple(shape), dtype, window=window)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 0.0), (0, 30.0),
                                        (16, 50.0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_window_softcap(window, cap, dtype):
    check_decode((2, 96, 4, 2, 32), dtype, window=window, cap=cap)


@pytest.mark.parametrize("shape,lengths", [
    ((3, 200, 15, 5, 64), [200, 37, 1]),       # smollm's heads, G 3
    ((2, 130, 4, 4, 112), [130, 65]),          # D 112, G 1
    ((1, 70, 2, 1, 256), [69]),                # D 256
])
def test_decode_further_cases(shape, lengths):
    check_decode(shape, jnp.float32, lengths=lengths)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_slot_without_visible_key(window, dtype):
    """A slot of length 0 sees no key: the port gives the JAX oracle's
    answer, the mean of v over all S rows; the JAX kernel agrees on the
    other slots only."""
    B, S, H, KVH, D = 3, 100, 4, 2, 32
    out, want, kern, (_, _, v, _) = check_decode(
        (B, S, H, KVH, D), dtype, window=window, lengths=[0, 57, 100],
        slots=slice(1, None))
    mean = v[0].float().mean(dim=0).repeat_interleave(H // KVH, dim=0)
    torch.testing.assert_close(out[0].float(), mean,
                               atol=2e-2 if dtype == jnp.bfloat16 else 1e-5,
                               rtol=0.0)
    gap = float((as_torch(kern)[0] - as_torch(want)[0]).abs().max())
    assert gap > 1e-2, "the JAX kernel now agrees with its oracle (R5)"


# ---------------------------------------------------- entry points ----

def _flash_args(dtype=torch.float32, D=16, H=4, KVH=2, device="cpu"):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(2, 9, H, D, generator=g).to(dtype).to(device),
            torch.randn(2, 12, KVH, D, generator=g).to(dtype),
            torch.randn(2, 12, KVH, D, generator=g).to(dtype))


def _decode_args(dtype=torch.float32, D=16, H=4, KVH=2, device="cpu",
                 lengths_dtype=torch.int32):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(2, H, D, generator=g).to(dtype).to(device),
            torch.randn(2, 12, KVH, D, generator=g).to(dtype),
            torch.randn(2, 12, KVH, D, generator=g).to(dtype),
            torch.tensor([12, 5], dtype=lengths_dtype))


@pytest.mark.parametrize("op", ["flash_attention", "decode_attention"])
def test_ops_cpu_query_takes_plain_version(op):
    if op == "flash_attention":
        args, plain = _flash_args(), ref.attention_ref
        kw = dict(causal=True, window=5, softcap_val=20.0)
    else:
        args, plain = _decode_args(), ref.decode_attention_ref
        kw = dict(window=5, softcap_val=20.0)
    assert torch.equal(getattr(ops, op)(*args, **kw), plain(*args, **kw))


BAD_FLASH = [
    ("head_dim 12", dict(D=12), {}),
    ("head_dim 264", dict(D=264), {}),
    ("float16", dict(dtype=torch.float16), {}),
    ("3 query heads", dict(H=3), {}),
    ("window -1", {}, dict(window=-1)),
    ("CUDA", {}, {}),                       # a CPU q: the wrapper refuses
    ("not on meta", dict(device="meta"), {}),   # q elsewhere than its KV
]
BAD_DECODE = BAD_FLASH + [("int32", dict(lengths_dtype=torch.int64), {})]


@pytest.mark.parametrize("match,make,kw", BAD_FLASH)
def test_flash_wrapper_refuses_without_launching(match, make, kw):
    """K2's wrapper launches the kernel or raises; every refusal comes
    before a launch (and before the kernel is built).  The meta-device q
    stands for a CUDA q with its KV in host memory: the device check comes
    before the check for a CUDA q, so it needs no card (chip_smoke.py
    checks a CUDA q with CPU KV on the card)."""
    before = k2.flash_attention.launches
    with pytest.raises(ValueError, match=match):
        k2.flash_attention(*_flash_args(**make), **kw)
    assert k2.flash_attention.launches == before


@pytest.mark.parametrize("match,make,kw", BAD_DECODE)
def test_decode_wrapper_refuses_without_launching(match, make, kw):
    """As for K2, for K3's wrapper; lengths must be int32 as well."""
    before = k3.decode_attention.launches
    with pytest.raises(ValueError, match=match):
        k3.decode_attention(*_decode_args(**make), **kw)
    assert k3.decode_attention.launches == before


@pytest.mark.parametrize("op", ["flash_attention", "decode_attention"])
def test_wrappers_refuse_bad_shapes(op):
    if op == "flash_attention":
        q, k, v = _flash_args()
        bad = (q, k, v[:, :-1])
        fn = k2.flash_attention
    else:
        q, k, v, n = _decode_args()
        bad = (q, k, v, n[:1])
        fn = k3.decode_attention
    with pytest.raises(ValueError, match="shape"):
        fn(*bad)
