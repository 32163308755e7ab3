// Mamba2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba2.py :: ssd (body
// `_kernel`).  Inputs x (B, S, H, P), dt (B, S, H), A (H,) float32, Bm and
// Cm (B, S, N) shared by every head, and an optional start state h0
// (B, H, P, N) float32.  For each (batch b, head h) the sequence is cut into
// chunks of kQ tokens; with l the inclusive cumsum of dt * A[h] inside a
// chunk,
//
//   y_t  = sum_{s<=t} (C_t . B_s) exp(l_t - l_s) dt_s x_s    (intra-chunk)
//        + exp(l_t) C_t h^T                                   (inter-chunk)
//   h'   = exp(l_T) h + sum_s exp(l_T - l_s) dt_s x_s B_s^T    (state update)
//
// where h (P, N) is the state at the chunk's start.  y is written in x's
// dtype and the final state (B, H, P, N) in float32.  All arithmetic is
// float32, as the TPU kernel's (preferred_element_type=f32).  The exponent
// of the intra-chunk decay is masked for s > t before the exp: there it is
// positive and would overflow.
//
// The internal chunk is kQ = 64, whatever chunk the caller names: the SSD
// result does not depend on the chunk length beyond rounding, and a 64-token
// chunk keeps every (kQ x kQ) tile at 16 KB of shared memory (a 256-token
// chunk's f32 tile would be 256 KB, above the 227 KB a block may have) and
// halves the arithmetic of the quadratic intra-chunk term.  A ragged last
// chunk is padded with dt = 0, x = B = C = 0, which is neutral.
//
// Layout: the kernel reads x, dt, Bm and Cm through their strides (element
// units), so the model's slices of its projections need no transposed
// copies; y and h are written contiguous.
//
// What bounds it: at the full-width shape (S 4096, H 112, P = N = 64) the
// float32 products on CUDA cores, against about 2 B S H P elt bytes of x
// and y.  This kernel does 2 (S/kQ) [kQ^2 N + H (kQ^2 P + 2 kQ N P)] flops
// per batch row (whole kQ x kQ tiles, the masked half included); the
// fewest the function needs (the causal half, at the best chunk) are
// counted by chip_smoke.py :: k4_bound.  What this first design does: one CTA per (batch row, block
// of bh heads, bh = 1 or 2) walks the chunks in order, one group of 256
// threads per head, each head's state in shared memory; C B^T of a chunk is
// computed once per CTA and shared by its heads; every product is a
// register-tiled (4 x 4 per thread) float32 loop over shared memory.  wgmma,
// TMA and a split over chunks with a state-passing step are a later
// change's work.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (kernels/build.py); kernels/ssd.py is its wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;            // internal chunk (tokens)
constexpr int kHeadThreads = 256;  // (kQ / 4) * (64 / 4) register tiles
constexpr int kMaxHeads = 2;       // heads per CTA: up to 512 threads
constexpr int kMaxDim = 64;        // P and N at most this, multiples of 4

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
struct Store;
template <>
struct Store<float> {
  __device__ static float from_float(float v) { return v; }
};
template <>
struct Store<__nv_bfloat16> {
  __device__ static __nv_bfloat16 from_float(float v) {
    return __float2bfloat16(v);
  }
};

struct Args {
  const void* x;
  const void* dt;
  const float* A;
  const void* bm;
  const void* cm;
  const float* h0;  // may be null: the state starts at zero
  void* y;
  float* h;
  int S, H, P, N, bh;
  long long sx_b, sx_s, sx_h, sx_p;
  long long sdt_b, sdt_s, sdt_h;
  long long sb_b, sb_s, sb_n;
  long long sc_b, sc_s, sc_n;
};

// acc[i][j] += sum_k a[k][m0 + i] * b[k][n0 + j]: both operands k-major in
// shared memory, rows of lda / ldb floats (multiples of 4, 16-byte aligned).
__device__ __forceinline__ void mm_tile(float acc[4][4], const float* a,
                                        int lda, const float* b, int ldb,
                                        int K, int m0, int n0) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * lda + m0);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * ldb + n0);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// Shared memory, in floats: the chunk's C and B (shared by the CTA's heads),
// then one region per head.
__host__ __device__ inline size_t shared_floats(int N) {
  return (size_t)3 * N * kQ + kQ * kQ;
}
__host__ __device__ inline size_t head_floats(int P, int N) {
  return (size_t)kQ * kQ + (size_t)kQ * P + 2 * kQ + (size_t)N * P;
}
__host__ __device__ inline size_t smem_floats(int P, int N, int bh) {
  return shared_floats(N) + (size_t)bh * head_floats(P, N);
}

// One CTA per (head block, batch row); bh groups of 256 threads, group g
// running head hb * bh + g.  All groups step through the chunks together.
template <typename T>
__global__ void __launch_bounds__(kMaxHeads * kHeadThreads)
    ssd_kernel(Args a) {
  const int P = a.P, N = a.N, bh = a.bh, H = a.H, S = a.S;
  const int hb = blockIdx.x;  // head block
  const int b = blockIdx.y;   // batch row
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int g = tid / kHeadThreads;    // this thread's head in the block
  const int lt = tid % kHeadThreads;   // its rank in the head's group
  const int head = hb * bh + g;
  const T* x = static_cast<const T*>(a.x);
  const T* dt = static_cast<const T*>(a.dt);
  const T* bm = static_cast<const T*>(a.bm);
  const T* cm = static_cast<const T*>(a.cm);
  T* y = static_cast<T*>(a.y);

  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* cT = sm;              // (N, kQ)  C, n-major
  float* bT = cT + N * kQ;     // (N, kQ)  B, n-major
  float* bs = bT + N * kQ;     // (kQ, N)  B, token-major
  float* cbT = bs + kQ * N;    // (kQ s, kQ t)  C_t . B_s
  float* wT = sm + shared_floats(N) + (size_t)g * head_floats(P, N);
  float* xs = wT + kQ * kQ;    // (kQ s, kQ t) masked weights; (kQ, P) x
  float* dts = xs + kQ * P;    // (kQ,)
  float* ls = dts + kQ;        // (kQ,)    inclusive cumsum of dt * A
  float* hT = ls + kQ;         // (N, P)   this head's state, n-major
  const float Ah = a.A[head];

  for (int i = lt; i < N * P; i += kHeadThreads) {
    const int n = i / P, p = i % P;
    hT[i] = a.h0 ? a.h0[(((size_t)b * H + head) * P + p) * N + n] : 0.f;
  }

  const int nc = (S + kQ - 1) / kQ;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kQ;
    const int rows = min(kQ, S - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < kQ * N; i += nthreads) {
      const int t = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (t < rows) {
        const long long s = t0 + t;
        bv = to_float(bm[b * a.sb_b + s * a.sb_s + n * a.sb_n]);
        cv = to_float(cm[b * a.sc_b + s * a.sc_s + n * a.sc_n]);
      }
      bT[n * kQ + t] = bv;
      cT[n * kQ + t] = cv;
      bs[t * N + n] = bv;
    }
    for (int i = lt; i < kQ * P; i += kHeadThreads) {
      const int t = i / P, p = i % P;
      xs[i] = t < rows ? to_float(x[b * a.sx_b + (long long)(t0 + t) * a.sx_s +
                                    head * a.sx_h + p * a.sx_p])
                       : 0.f;
    }
    if (lt < kQ)
      dts[lt] = lt < rows ? to_float(dt[b * a.sdt_b +
                                        (long long)(t0 + lt) * a.sdt_s +
                                        head * a.sdt_h])
                          : 0.f;
    __syncthreads();
    if (tid < kHeadThreads) {  // C B^T once per chunk for all bh heads
      const int m0 = (tid / (kQ / 4)) * 4, n0 = (tid % (kQ / 4)) * 4;
      float acc[4][4] = {};
      mm_tile(acc, cT, kQ, bT, kQ, N, m0, n0);  // tile (t, s)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cbT[(n0 + j) * kQ + m0 + i] = acc[i][j];
    }
    if (lt < 32) {  // inclusive cumsum of dt * A over the kQ = 64 tokens
      const float v0 = dts[2 * lt] * Ah, v1 = dts[2 * lt + 1] * Ah;
      float s = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, s, o);
        if (lt >= o) s += u;
      }
      const float before = s - (v0 + v1);
      ls[2 * lt] = before + v0;
      ls[2 * lt + 1] = before + v0 + v1;
    }
    __syncthreads();
    for (int i = lt; i < kQ * kQ; i += kHeadThreads) {
      const int s = i / kQ, t = i % kQ;
      // masked before the exp: for s > t the exponent is positive
      wT[i] = s <= t ? cbT[i] * expf(ls[t] - ls[s]) * dts[s] : 0.f;
    }
    __syncthreads();
    if (lt < (kQ / 4) * (P / 4)) {  // y tile (t, p)
      const int m0 = (lt / (P / 4)) * 4, n0 = (lt % (P / 4)) * 4;
      float acc[4][4] = {};
      mm_tile(acc, wT, kQ, xs, P, kQ, m0, n0);
      float inter[4][4] = {};
      mm_tile(inter, cT, kQ, hT, P, N, m0, n0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = m0 + i;
        if (t >= rows) continue;
        const float e = expf(ls[t]);
        T* yr = y + (((size_t)b * S + t0 + t) * H + head) * P + n0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          yr[j] = Store<T>::from_float(acc[i][j] + e * inter[i][j]);
      }
    }
    __syncthreads();  // every reader of xs and of the old state is done
    const float lT = ls[kQ - 1];
    for (int i = lt; i < kQ * P; i += kHeadThreads) {
      const int s = i / P;
      xs[i] *= expf(lT - ls[s]) * dts[s];
    }
    __syncthreads();
    if (lt < (N / 4) * (P / 4)) {  // state tile (n, p)
      const int m0 = (lt / (P / 4)) * 4, n0 = (lt % (P / 4)) * 4;
      float acc[4][4] = {};
      mm_tile(acc, bs, N, xs, P, kQ, m0, n0);
      const float d = expf(lT);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* hv = hT + (m0 + i) * P + n0 + j;
          *hv = d * *hv + acc[i][j];
        }
    }
  }
  __syncthreads();
  for (int i = lt; i < N * P; i += kHeadThreads) {
    const int n = i / P, p = i % P;
    a.h[(((size_t)b * H + head) * P + p) * N + n] = hT[i];
  }
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(a.P, a.N, a.bh);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<dim3(a.H / a.bh, B), a.bh * kHeadThreads, smem, stream>>>(
      a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// dtype: 0 = float32, 1 = bfloat16 (x, dt, Bm, Cm and y); A, h0 and h are
// float32, h0 and h contiguous (B, H, P, N), y contiguous (B, S, H, P).
// Strides are in elements.  h0 may be null.
int ssd_scan(const void* x, const void* dt, const void* A, const void* bm,
             const void* cm, const void* h0, void* y, void* h, int B, int S,
             int H, int P, int N, int bh, long long sx_b, long long sx_s,
             long long sx_h, long long sx_p, long long sdt_b, long long sdt_s,
             long long sdt_h, long long sb_b, long long sb_s, long long sb_n,
             long long sc_b, long long sc_s, long long sc_n, int dtype,
             void* stream) {
  if (B < 1 || S < 1 || bh < 1 || bh > kMaxHeads || H % bh || P % 4 ||
      N % 4 || P < 4 || N < 4 || P > kMaxDim || N > kMaxDim)
    return (int)cudaErrorInvalidValue;
  Args a{x,     dt,    static_cast<const float*>(A),
         bm,    cm,    static_cast<const float*>(h0),
         y,     static_cast<float*>(h),
         S,     H,     P,
         N,     bh,    sx_b,
         sx_s,  sx_h,  sx_p,
         sdt_b, sdt_s, sdt_h,
         sb_b,  sb_s,  sb_n,
         sc_b,  sc_s,  sc_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, B, s);
  if (dtype == 0) return (int)launch<float>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
