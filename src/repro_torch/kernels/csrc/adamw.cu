// AdamW's update, the global-norm clip included, as one multi-tensor pass
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves
// src/repro/optim/adamw.py::update to XLA, which fuses each leaf's
// elementwise ops.  Run eagerly (optim/adamw.py::eager_update) the same
// update is about 24 kernels a leaf, some 8,000 launches a step on
// smollm-360m's 290 leaves, and the card idles while the host issues them.
// Here it is one copy of a leaf table and two launches, whatever the leaf
// count.
//
// What it computes, over every leaf of the table (kernels/adamw.py packs
// it: each row the addresses of a parameter p, its gradient g and its two
// float32 moments m and v, its element count and its first chunk):
//   norm   = sqrt(sum over the leaves of sum(float(g)^2))
//   scale  = min(1, clip * (1 / max(norm, 1e-8)))
//   count' = count + 1; lr = the warm-up and cosine schedule at count';
//   b1c = 1 - b1^count', b2c = 1 - b2^count'
//   and for each element:
//   g   = float(grad) * scale
//   m   = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
//   upd = (m / b1c) / (sqrt(v / b2c) + eps) + wd float(p)
//   p   = float(p) - lr upd, rounded to p's dtype (to nearest even)
// Every operation is rounded to float32 on its own, in the order the eager
// ops take on the card (the __f*_rn intrinsics, which nvcc never contracts
// into a fused multiply-add; a division by a host scalar as PyTorch's CUDA
// kernels take it, times the float32 reciprocal), so wherever the norm
// agrees to the bit, or the clip is not engaged, the parameters and the
// moments agree with the eager update's to the bit.  The norm itself sums
// in another order than the eager per-leaf sums.
//
// What bounds it: bytes.  A parameter costs 22 B in bf16 (p read and
// written, g read, m and v read and written, 4 B each way) and about 15
// flops, some 0.7 flops a byte: far under the card's line, so the lever is
// to read and write each byte once and keep enough of them in flight.
//
// What the design does about that:
// - Each leaf is cut into chunks of `chunk` elements (65,536 from the
//   wrapper); CTA c takes chunk c of the whole table and finds its leaf by
//   a binary search of the rows' first-chunk column.  A chunk starts at a
//   multiple of the vector width, so a leaf whose four addresses are
//   16-byte aligned is read in vectors of 4 elements (16-byte loads of the
//   moments, 8 or 16 bytes of p and g), each thread with kUnroll vectors
//   of all four loaded before it computes any; the elements past the
//   chunk's last whole vector, and every element of a leaf that is not
//   aligned, go one at a time.  Any element count, one included.
// - Two kernels.  sumsq_kernel: each CTA writes its chunk's sum of squares
//   to partials[c] (thread t sums its vectors t, t + T, ... in order, then a
//   halving tree in shared memory).  The CTA that finishes last (an integer
//   counter in the table's header, zero in every copy of the table) sums
//   the partials in a fixed order, thread t partials t, t + T, ..., then the
//   same tree, and writes the norm, the scale, lr, b1c, b2c and count'.
//   No float atomics, and the order never depends on which CTA came last:
//   one input gives the same bits every run.  update_kernel: each CTA reads
//   those scalars and updates its chunk in place.
// - kernels/ref.py::adamw_fused_ref is this algorithm in plain torch, the
//   same chunks and the same order of every sum.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (kernels/build.py); kernels/adamw.py is its wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // kernels/adamw.py::THREADS
constexpr int kVec = 4;        // elements a vector
constexpr int kUnroll = 4;     // vectors a thread loads before it computes
constexpr int kHeader = 64;    // bytes before the first row: the counter

enum : long long { kParamBf16 = 1, kGradBf16 = 2, kVector = 4 };

// One row of the table, as kernels/adamw.py::pack_table writes it.
struct Leaf {
  long long p, g, m, v;  // device addresses
  long long numel;
  long long first_chunk;  // of the whole table's chunks
  long long flags;        // kParamBf16 | kGradBf16 | kVector
  long long pad;
};
static_assert(sizeof(Leaf) == 64, "a row is 8 int64");

// The float32 constants of the step, as kernels/adamw.py::constants
// rounds them.
struct Hyper {
  float lr, inv_warm, warmup, inv_prog, pi, b1, b2, omb1, omb2, eps, wd,
      clip;
};

// What sumsq_kernel's last CTA writes and update_kernel reads.
enum { kNorm = 0, kScale, kLr, kB1c, kB2c };

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static void load4(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  }
  __device__ static void store4(float* p, const float* i) {
    *reinterpret_cast<float4*>(p) = make_float4(i[0], i[1], i[2], i[3]);
  }
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float x) { *p = x; }
};

template <>
struct Io<__nv_bfloat16> {
  __device__ static void load4(const __nv_bfloat16* p, float* o) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    o[0] = a.x;
    o[1] = a.y;
    o[2] = b.x;
    o[3] = b.y;
  }
  __device__ static void store4(__nv_bfloat16* p, const float* i) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(i[0], i[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(i[2], i[3]);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&a);
    u.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);  // to nearest even, as Tensor.to rounds
  }
};

// The row whose chunks hold chunk c: the last with first_chunk <= c.
__device__ __forceinline__ const Leaf& leaf_of(const Leaf* rows, int n,
                                               long long c) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (rows[mid].first_chunk <= c)
      lo = mid;
    else
      hi = mid - 1;
  }
  return rows[lo];
}

// The CTA's sum of x over its threads: a halving tree in shared memory, the
// same order every call.  Every thread gets the sum.
__device__ float block_sum(float x, float* sh) {
  sh[threadIdx.x] = x;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      sh[threadIdx.x] = __fadd_rn(sh[threadIdx.x], sh[threadIdx.x + s]);
    __syncthreads();
  }
  const float r = sh[0];
  __syncthreads();
  return r;
}

// This thread's share of the sum of squares of g[lo, hi): its vectors t,
// t + T, ... in order, element by element, then its element of the tail.
template <typename G>
__device__ float chunk_sumsq(const G* g, long long lo, long long hi,
                             bool vector) {
  const long long nvec = vector ? (hi - lo) / kVec : 0;
  float acc = 0.f;
#pragma unroll 4
  for (long long j = threadIdx.x; j < nvec; j += kThreads) {
    float x[kVec];
    Io<G>::load4(g + lo + j * kVec, x);
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc = __fadd_rn(acc, __fmul_rn(x[k], x[k]));
  }
  for (long long e = lo + nvec * kVec + threadIdx.x; e < hi; e += kThreads) {
    const float x = Io<G>::load(g + e);
    acc = __fadd_rn(acc, __fmul_rn(x, x));
  }
  return acc;
}

// count', the norm, the scale, lr, b1c and b2c from the whole sum of
// squares, in the eager update's float32 operations.
__device__ void finalize(float total, const Hyper& h, const int* count_in,
                         int* count_out, float* scalars) {
  const float norm = __fsqrt_rn(total);
  const float den = norm < 1e-8f ? 1e-8f : norm;  // a NaN stays a NaN
  float scale = __fmul_rn(__frcp_rn(den), h.clip);
  if (scale > 1.f) scale = 1.f;
  const int count = *count_in + 1;
  const float step = static_cast<float>(count);
  float warm = __fmul_rn(step, h.inv_warm);
  if (warm > 1.f) warm = 1.f;
  float prog = __fmul_rn(__fsub_rn(step, h.warmup), h.inv_prog);
  prog = fminf(fmaxf(prog, 0.f), 1.f);
  const float lr =
      __fmul_rn(__fmul_rn(__fmul_rn(h.lr, warm), 0.5f),
                __fadd_rn(1.f, cosf(__fmul_rn(h.pi, prog))));
  scalars[kNorm] = norm;
  scalars[kScale] = scale;
  scalars[kLr] = lr;
  scalars[kB1c] = __fsub_rn(1.f, powf(h.b1, step));
  scalars[kB2c] = __fsub_rn(1.f, powf(h.b2, step));
  *count_out = count;
}

__global__ void __launch_bounds__(kThreads)
    sumsq_kernel(char* table, int n_leaves, long long chunk, float* partials,
                 const int* count_in, int* count_out, float* scalars,
                 Hyper h) {
  __shared__ float sh[kThreads];
  __shared__ bool last;
  const Leaf* rows = reinterpret_cast<const Leaf*>(table + kHeader);
  const long long c = blockIdx.x;
  const Leaf& L = leaf_of(rows, n_leaves, c);
  const long long lo = (c - L.first_chunk) * chunk;
  const long long hi = min(lo + chunk, L.numel);
  const bool vector = L.flags & kVector;
  const float acc =
      (L.flags & kGradBf16)
          ? chunk_sumsq(reinterpret_cast<const __nv_bfloat16*>(L.g), lo, hi,
                        vector)
          : chunk_sumsq(reinterpret_cast<const float*>(L.g), lo, hi, vector);
  const float part = block_sum(acc, sh);
  if (threadIdx.x == 0) {
    partials[c] = part;
    __threadfence();  // the partial is visible before the count says so
    const unsigned done =
        atomicAdd(reinterpret_cast<unsigned*>(table), 1u);
    last = done == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // every other CTA's partial is in L2: read past this SM's L1
  float s = 0.f;
  for (long long i = threadIdx.x; i < gridDim.x; i += kThreads)
    s = __fadd_rn(s, __ldcg(partials + i));
  const float total = block_sum(s, sh);
  if (threadIdx.x == 0) finalize(total, h, count_in, count_out, scalars);
}

struct Step {
  float scale, lr, b1c, b2c;
};

__device__ __forceinline__ void adamw1(const Hyper& h, const Step& s,
                                       float grad, float& p, float& m,
                                       float& v) {
  const float g = __fmul_rn(grad, s.scale);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.b2c)), h.eps);
  const float upd = __fadd_rn(__fdiv_rn(__fdiv_rn(m, s.b1c), den),
                              __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, upd));
}

template <typename P, typename G>
__device__ void update_chunk(const Leaf& L, long long lo, long long hi,
                             const Hyper& h, const Step& s) {
  P* p = reinterpret_cast<P*>(L.p);
  const G* g = reinterpret_cast<const G*>(L.g);
  float* m = reinterpret_cast<float*>(L.m);
  float* v = reinterpret_cast<float*>(L.v);
  const long long nvec = (L.flags & kVector) ? (hi - lo) / kVec : 0;
  for (long long j0 = threadIdx.x; j0 < nvec; j0 += kThreads * kUnroll) {
    float pr[kUnroll][kVec], gr[kUnroll][kVec], mr[kUnroll][kVec],
        vr[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + u * kThreads;
      if (j < nvec) {
        const long long e = lo + j * kVec;
        Io<P>::load4(p + e, pr[u]);
        Io<G>::load4(g + e, gr[u]);
        Io<float>::load4(m + e, mr[u]);
        Io<float>::load4(v + e, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + u * kThreads;
      if (j < nvec) {
        const long long e = lo + j * kVec;
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          adamw1(h, s, gr[u][k], pr[u][k], mr[u][k], vr[u][k]);
        Io<P>::store4(p + e, pr[u]);
        Io<float>::store4(m + e, mr[u]);
        Io<float>::store4(v + e, vr[u]);
      }
    }
  }
  for (long long e = lo + nvec * kVec + threadIdx.x; e < hi; e += kThreads) {
    float pe = Io<P>::load(p + e), me = m[e], ve = v[e];
    adamw1(h, s, Io<G>::load(g + e), pe, me, ve);
    Io<P>::store(p + e, pe);
    m[e] = me;
    v[e] = ve;
  }
}

__global__ void __launch_bounds__(kThreads)
    update_kernel(const char* table, int n_leaves, long long chunk,
                  const float* scalars, Hyper h) {
  const Leaf* rows = reinterpret_cast<const Leaf*>(table + kHeader);
  const long long c = blockIdx.x;
  const Leaf& L = leaf_of(rows, n_leaves, c);
  const long long lo = (c - L.first_chunk) * chunk;
  const long long hi = min(lo + chunk, L.numel);
  const Step s{scalars[kScale], scalars[kLr], scalars[kB1c], scalars[kB2c]};
  switch (L.flags & (kParamBf16 | kGradBf16)) {
    case 0:
      update_chunk<float, float>(L, lo, hi, h, s);
      break;
    case kParamBf16:
      update_chunk<__nv_bfloat16, float>(L, lo, hi, h, s);
      break;
    case kGradBf16:
      update_chunk<float, __nv_bfloat16>(L, lo, hi, h, s);
      break;
    default:
      update_chunk<__nv_bfloat16, __nv_bfloat16>(L, lo, hi, h, s);
  }
}

}  // namespace

extern "C" {

// Launch both kernels on `stream`; returns cudaGetLastError() after the
// launches (0 = ok).  table: on the device, a header of 64 bytes whose
// first 4 hold 0, then n_leaves rows of 8 int64 (Leaf), every leaf at
// least one element, in order of first_chunk, which starts at 0 and grows
// by each leaf's chunks; n_chunks their sum, at most 2^31 - 1; chunk a
// positive multiple of 4.  partials: n_chunks float32; count_in and
// count_out: int32 on the device; scalars: 5 float32 (norm, scale, lr,
// b1c, b2c).  The rest: kernels/adamw.py::constants.
int adamw_fused(void* table, int n_leaves, int n_chunks, long long chunk,
                void* partials, const void* count_in, void* count_out,
                void* scalars, float lr, float inv_warm, float warmup,
                float inv_prog, float pi, float b1, float b2, float omb1,
                float omb2, float eps, float wd, float clip, void* stream) {
  if (n_leaves < 1 || n_chunks < 1 || chunk < kVec || chunk % kVec)
    return (int)cudaErrorInvalidValue;
  const Hyper h{lr, inv_warm, warmup, inv_prog, pi,  b1,
                b2, omb1,     omb2,   eps,      wd,  clip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sumsq_kernel<<<n_chunks, kThreads, 0, s>>>(
      static_cast<char*>(table), n_leaves, chunk,
      static_cast<float*>(partials), static_cast<const int*>(count_in),
      static_cast<int*>(count_out), static_cast<float*>(scalars), h);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  update_kernel<<<n_chunks, kThreads, 0, s>>>(
      static_cast<const char*>(table), n_leaves, chunk,
      static_cast<const float*>(scalars), h);
  return (int)cudaGetLastError();
}

}  // extern "C"
