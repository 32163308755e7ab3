// Flash decode over a contiguous KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py ::
// decode_attention (body `_kernel`).  For each (slot b, KV head h) the
// G = H / KVH query heads of one new token attend over the slot's visible
// keys of k_cache / v_cache (B, S, KVH, D): positions max(0, len - window)
// (0 without a window) to min(len, S), len = lengths[b].  Scores are scaled
// by D^-0.5, tanh-softcapped when softcap != 0, and folded block by block
// into an fp32 online softmax that starts at the finite NEG_INF = -2**20,
// never -inf, so exp(NEG_INF - NEG_INF) is 1 and never a NaN.  The output
// (B, H, D) is written once, in q's dtype.
//
// A slot with no visible key (length 0, or a window that starts past S)
// takes its own branch: the oracle (kernels/ref.py::decode_attention_ref)
// scores all S keys NEG_INF, so its softmax is uniform and the output is
// the mean of v over all S rows, with p = 1/S rounded to v's dtype as the
// oracle rounds it.  (The TPU kernel differs there: it also averages in
// its zero padding.)
//
// What bounds it: bytes.  Each visible key costs 2 * D * sizeof(T) bytes
// (K and V) per KV head, read once; the arithmetic, 4 * G * D flops per key
// and KV head, is far below what the card can do per byte.
//
// What this first design does about that: it reads only the visible keys,
// each once, with one 16-byte load per thread and chunk, and shares one
// read of K and V among the G query heads of the KV head, which form one
// (G, D) tile.  One CTA per (b, h) walks the visible range in blocks of
// kBlock keys staged in shared memory as f32.  The (g, key) scores are
// spread over all threads, one warp per query head runs the online-softmax
// step with shuffles, and the (G, D) accumulator stays in shared memory.
// Splitting a long slot over several CTAs with a combine step (B * KVH CTAs
// do not fill 132 SMs at small batch), cp.async double buffering and
// tensor-core products are a later change's work.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (kernels/build.py); kernels/decode_attention.py is its wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1048576.0f;  // -2**20, as kernels/ref.py
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 64;  // keys per block: two per lane in the softmax

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kVec = 4;  // elements per 16-byte chunk
  __device__ static void unpack(const uint4& u, float* out) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  }
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& u, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
  __device__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  int S, H, KVH, D, window;
  float softcap, scale;
  long long sq_b, sq_h;        // q strides (elements); d is contiguous
  long long sk_b, sk_s, sk_h;  // k_cache strides
  long long sv_b, sv_s, sv_h;  // v_cache strides
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

inline size_t smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)2 * G * D + (size_t)kBlock * (2 * D + 1) +
                          (size_t)G * kBlock + 3 * (size_t)G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_kernel(Args a) {
  constexpr int kVec = Pack<T>::kVec;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int D = a.D;
  const int G = a.H / a.KVH;
  const int Dp = D + 1;  // padded K row: column reads hit distinct banks
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* kb = static_cast<const T*>(a.k) + b * a.sk_b + h * a.sk_h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv_b + h * a.sv_h;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq_b;
  // the G query heads of KV head h are rows h*G .. h*G+G-1 of out[b]
  T* ob = static_cast<T*>(a.out) + ((size_t)b * a.H + (size_t)h * G) * D;

  const int len = a.lengths[b];
  const int hi = min(len, a.S);
  const int lo = a.window ? max(0, len - a.window) : 0;
  if (hi <= lo) {
    // no visible key: the oracle's uniform softmax over all S rows
    const float p = Pack<T>::to_float(Pack<T>::from_float(1.f / a.S));
    for (int d = tid; d < D; d += kThreads) {
      float sum = 0.f;
      for (int t = 0; t < a.S; ++t)
        sum += Pack<T>::to_float(vb[t * a.sv_s + d]);
      for (int g = 0; g < G; ++g) ob[g * D + d] = Pack<T>::from_float(p * sum);
    }
    return;
  }

  extern __shared__ float smem[];
  float* q_s = smem;                // (G, D)
  float* acc_s = q_s + G * D;       // (G, D) fp32 accumulator
  float* k_s = acc_s + G * D;       // (kBlock, Dp)
  float* v_s = k_s + kBlock * Dp;   // (kBlock, D)
  float* p_s = v_s + kBlock * D;    // (G, kBlock) scores, then probabilities
  float* m_s = p_s + G * kBlock;    // (G,) running max
  float* l_s = m_s + G;             // (G,) running sum
  float* a_s = l_s + G;             // (G,) rescale of this block's update

  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D;
    q_s[e] = Pack<T>::to_float(qb[(h * G + g) * a.sq_h + e % D]);
    acc_s[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int row_chunks = D / kVec;
  for (int base = lo; base < hi; base += kBlock) {
    const int n = min(kBlock, hi - base);  // every one of them is visible
    __syncthreads();  // the previous block's readers of k_s / v_s are done
    for (int c = tid; c < n * row_chunks; c += kThreads) {
      const int t = c / row_chunks;
      const int d0 = (c % row_chunks) * kVec;
      const uint4 kr = *reinterpret_cast<const uint4*>(
          kb + (base + t) * a.sk_s + d0);
      const uint4 vr = *reinterpret_cast<const uint4*>(
          vb + (base + t) * a.sv_s + d0);
      float kf[kVec], vf[kVec];
      Pack<T>::unpack(kr, kf);
      Pack<T>::unpack(vr, vf);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        k_s[t * Dp + d0 + j] = kf[j];
        v_s[t * D + d0 + j] = vf[j];
      }
    }
    __syncthreads();
    for (int e = tid; e < G * kBlock; e += kThreads) {
      const int g = e / kBlock;
      const int t = e % kBlock;
      float s = kNegInf;
      if (t < n) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d)
          dot = fmaf(q_s[g * D + d], k_s[t * Dp + d], dot);
        s = dot * a.scale;
        if (a.softcap != 0.f) s = a.softcap * tanhf(s / a.softcap);
      }
      p_s[e] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      float* row = p_s + g * kBlock;
      const float s0 = row[lane];
      const float s1 = row[lane + 32];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = lane < n ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < n ? expf(s1 - m_new) : 0.f;
      row[lane] = p0;
      row[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D;
      const int d = e % D;
      const float* row = p_s + g * kBlock;
      float pv = 0.f;
      for (int t = 0; t < n; ++t) pv = fmaf(row[t], v_s[t * D + d], pv);
      acc_s[e] = acc_s[e] * a_s[g] + pv;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads)
    ob[e] = Pack<T>::from_float(acc_s[e] / fmaxf(l_s[e / D], 1e-30f));
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.H / a.KVH, a.D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  decode_kernel<T><<<dim3(B, a.KVH), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// dtype: 0 = float32, 1 = bfloat16.  q (B, H, D), k_cache / v_cache
// (B, S, KVH, D) through the given strides (elements; the last dimension
// contiguous, every row 16-byte aligned); lengths (B,) int32 on the device;
// out (B, H, D) contiguous.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* lengths, void* out, int B, int S, int H,
                     int KVH, int D, int window, float softcap, float scale,
                     long long sq_b, long long sq_h, long long sk_b,
                     long long sk_s, long long sk_h, long long sv_b,
                     long long sv_s, long long sv_h, int dtype,
                     void* stream) {
  const Args a{q,    k,    v,    static_cast<const int*>(lengths),
               out,  S,    H,    KVH,
               D,    window, softcap, scale,
               sq_b, sq_h, sk_b, sk_s,
               sk_h, sv_b, sv_s, sv_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, B, s);
  if (dtype == 0) return (int)launch<float>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
