"""The port's plain SSD versions (repro_torch.kernels.ref ssd_ref and
ssd_chunked_ref) against the reference's on the same inputs, made with
numpy: the same-named jnp oracle at atol 1e-4, the sequential oracle and the
Pallas kernel body (mamba2.ssd in interpret mode) at atol 1e-3, the
reference kernel test's own limit.  Also the dispatch rules: only
kernels.ops picks the plain version, and only for a CPU tensor; the kernel
wrapper raises on CPU tensors and on the chunk contract."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mamba2 import ssd as pallas_ssd
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd as k4

SAME_TOL = 1e-4          # the same algorithm, other summation order
ORACLE_TOL = 1e-3        # another algorithm: test_kernels.py's limit
SHAPES = [(2, 64, 4, 16, 16, 16), (1, 128, 8, 32, 64, 32),
          (2, 96, 2, 8, 32, 32)]           # test_kernels.py's SSD shapes


def make_case(B, S, H, P, N, seed=0, with_h0=False):
    """numpy inputs as the reference kernel test draws them: x, B, C at
    scale 0.5, dt = softplus(normal), A = -exp(0.3 normal)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.5).astype(np.float32) \
        if with_h0 else None
    return x, dt, A, Bm, Cm, h0


def _jax(args):
    *a, h0 = args
    return [jnp.asarray(v) for v in a], None if h0 is None else \
        jnp.asarray(h0)


def _torch(args):
    *a, h0 = args
    return [torch.from_numpy(v) for v in a], None if h0 is None else \
        torch.from_numpy(h0)


def _err(got, want):
    return float(np.max(np.abs(got.numpy() - np.asarray(want))))


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_sequential_oracle_matches_reference(B, S, H, P, N, chunk, with_h0):
    args = make_case(B, S, H, P, N, with_h0=with_h0)
    (ja, jh0), (ta, th0) = _jax(args), _torch(args)
    y, h = ref.ssd_ref(*ta, h0=th0)
    y_j, h_j = jref.ssd_ref(*ja, h0=jh0)
    assert y.dtype == torch.float32 and h.shape == (B, H, P, N)
    assert _err(y, y_j) < SAME_TOL and _err(h, h_j) < SAME_TOL


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES + [
    (2, 52, 4, 16, 16, 16),      # ragged: the tail is padded with dt = 0
    (1, 24, 2, 8, 16, 32)])      # S < chunk: one chunk of S
@pytest.mark.parametrize("with_h0", [False, True])
def test_chunked_matches_reference_and_oracles(B, S, H, P, N, chunk,
                                               with_h0):
    """ssd_chunked_ref against the reference's ssd_chunked_ref (same
    algorithm), and against both packages' sequential oracles."""
    args = make_case(B, S, H, P, N, seed=1, with_h0=with_h0)
    (ja, jh0), (ta, th0) = _jax(args), _torch(args)
    y, h = ref.ssd_chunked_ref(*ta, chunk=chunk, h0=th0)
    y_j, h_j = jref.ssd_chunked_ref(*ja, chunk=chunk, h0=jh0)
    assert y.shape == (B, S, H, P) and h.dtype == torch.float32
    assert _err(y, y_j) < SAME_TOL and _err(h, h_j) < SAME_TOL
    y_s, h_s = jref.ssd_ref(*ja, h0=jh0)
    assert _err(y, y_s) < ORACLE_TOL and _err(h, h_s) < ORACLE_TOL
    y_t, h_t = ref.ssd_ref(*ta, h0=th0)
    assert _err(y, y_t.numpy()) < ORACLE_TOL
    assert _err(h, h_t.numpy()) < ORACLE_TOL


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_chunked_matches_pallas_kernel_body(B, S, H, P, N, chunk):
    """The port's chunked version against the TPU kernel's body, run in
    interpret mode as the reference's own kernel test runs it."""
    args = make_case(B, S, H, P, N, seed=2)
    (ja, _), (ta, _) = _jax(args), _torch(args)
    y_k, h_k = pallas_ssd(*ja, chunk=chunk, block_heads=min(2, H),
                          interpret=True)
    y, h = ref.ssd_chunked_ref(*ta, chunk=chunk)
    assert _err(y, y_k) < ORACLE_TOL and _err(h, h_k) < ORACLE_TOL


def test_bf16_inputs_give_bf16_output():
    """y comes back in x's dtype and the state in float32, as the
    reference's; in float32 arithmetic on the same bf16 values."""
    args = make_case(1, 32, 2, 8, 16, seed=3)
    ta, _ = _torch(args)
    tb = [t.to(torch.bfloat16) if i != 2 else t for i, t in enumerate(ta)]
    y, h = ref.ssd_chunked_ref(*tb, chunk=16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y32, h32 = ref.ssd_chunked_ref(*[t.float() for t in tb], chunk=16)
    assert torch.equal(y, y32.to(torch.bfloat16)) and torch.equal(h, h32)


def test_ops_dispatch_cpu_tensor_takes_plain_version():
    args = make_case(2, 64, 4, 16, 16, seed=4, with_h0=True)
    ta, th0 = _torch(args)
    before = k4.ssd.launches
    for h0 in (None, th0):
        got = ops.ssd(*ta, chunk=16, h0=h0)
        want = ref.ssd_chunked_ref(*ta, chunk=16, h0=h0)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert k4.ssd.launches == before


def test_kernel_wrapper_raises_on_cpu_tensors_and_ragged_chunks():
    """The wrapper launches the kernel or raises; it never computes the
    plain version itself, and it holds the reference's chunk contract."""
    ta, _ = _torch(make_case(2, 64, 4, 16, 16, seed=5))
    before = k4.ssd.launches
    with pytest.raises(ValueError, match="CUDA"):
        k4.ssd(*ta, chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        k4.ssd(*ta, chunk=24)
    assert k4.ssd.launches == before
    assert k4.check_chunk(64, 256) == 64 and k4.check_chunk(64, 16) == 16


def test_default_block_heads():
    """Heads per CTA at the full-width shapes on a 132-SM card: one head per
    CTA at B 1 (112 CTAs), two at B 2 (112 CTAs)."""
    assert k4._block_heads(1, 112, 132) == 1
    assert k4._block_heads(2, 112, 132) == 2
    assert k4._block_heads(2, 4, 132) == 1
