// Paged flash-decode over tiered KV pools, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode.py ::
// paged_decode_attention (body `_kernel`).  For each (slot b, KV head h) the
// G = H / KVH query heads of one new token attend over the slot's
// lengths[b] tokens of KV, held in `page`-token pages: logical page i is
// page_table[b, i] in the hot pool (tier 0, device memory) or in the cold
// pool (any other tier, pinned host memory).  Scores are scaled by D^-0.5,
// tanh-softcapped when softcap != 0, masked beyond the length and outside
// `window`, and folded into an fp32 online softmax that starts at the first
// page inside the window.  The output is (B, H, D) in q's dtype.
//
// What bounds it: bytes.  Each visited page costs page * KVH * D * 2 *
// sizeof(T) bytes over all KV heads (K and V); hot pages arrive at device
// memory bandwidth, cold pages at the host link's, read straight from the
// pinned host pool through its mapped device pointer — this card's form of
// the TPU kernel's host->VMEM DMA.  The arithmetic (4 * G * D flops per
// token and KV head) is far below what the card can do per byte.
//
// What this first design does about that: nothing yet; it is simple first.
// One CTA per (b, h); each page's K and V are loaded with one 16-byte read
// per thread and chunk, then the G query heads' scores, the online-softmax
// update and the fp32 (G, D) accumulator run out of shared memory.  Splitting
// long slots over several CTAs, double-buffering pages with cp.async so the
// cold read of page i+1 overlaps page i, and wgmma for the two products are
// a later change's work.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (kernels/build.py); kernels/paged_decode.py is its wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1048576.0f;  // -2**20, as kernels/ref.py
constexpr int kThreads = 128;

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

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_hot,
    const T* __restrict__ v_hot, const T* __restrict__ k_cold,
    const T* __restrict__ v_cold, const int* __restrict__ table,
    const int* __restrict__ tier, const int* __restrict__ lengths,
    T* __restrict__ out, int H, int KVH, int D, int page, int NP, int n_hot,
    int n_cold, int window, float softcap, float scale) {
  constexpr int kVec = Pack<T>::kVec;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int Dp = D + 1;  // padded K row: column reads hit distinct banks

  extern __shared__ float smem[];
  float* q_s = smem;               // (G, D)
  float* acc_s = q_s + G * D;      // (G, D) fp32 accumulator
  float* k_s = acc_s + G * D;      // (page, Dp)
  float* v_s = k_s + page * Dp;    // (page, D)
  float* s_s = v_s + page * D;     // (G, page) scores, then probabilities
  float* m_s = s_s + G * page;     // (G,) running max
  float* l_s = m_s + G;            // (G,) running sum
  float* a_s = l_s + G;            // (G,) rescale of this page's update

  // the G query heads of KV head h are rows h*G .. h*G+G-1 of q[b]
  const size_t qo = ((size_t)b * H + (size_t)h * G) * D;
  for (int e = tid; e < G * D; e += kThreads) {
    q_s[e] = Pack<T>::to_float(q[qo + e]);
    acc_s[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int len = lengths[b];
  const int npages = (len + page - 1) / page;
  const int lo = window ? max(0, (len - window) / page) : 0;
  const int row_chunks = D / kVec;
  const int chunks = page * row_chunks;
  const size_t page_elems = (size_t)page * KVH * D;

  for (int i = lo; i < npages; ++i) {
    const int phys = table[(size_t)b * NP + i];
    const T* kp;
    const T* vp;
    if (tier[(size_t)b * NP + i] == 0) {
      // unmapped entries (FREE = -1) clip into the pool, as the reference
      const int p = min(max(phys, 0), n_hot - 1);
      kp = k_hot + p * page_elems;
      vp = v_hot + p * page_elems;
    } else {
      const int p = min(max(phys, 0), n_cold - 1);
      kp = k_cold + p * page_elems;
      vp = v_cold + p * page_elems;
    }
    __syncthreads();  // the previous page's readers of k_s / v_s are done
    for (int c = tid; c < chunks; c += kThreads) {
      const int t = c / row_chunks;
      const int d0 = (c % row_chunks) * kVec;
      const size_t off = ((size_t)t * KVH + h) * D + d0;
      const uint4 kr = *reinterpret_cast<const uint4*>(kp + off);
      const uint4 vr = *reinterpret_cast<const uint4*>(vp + off);
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
    for (int e = tid; e < G * page; e += kThreads) {
      const int g = e / page;
      const int t = e % page;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(q_s[g * D + d], k_s[t * Dp + d], dot);
      float s = dot * scale;
      if (softcap != 0.f) s = softcap * tanhf(s / softcap);
      const int kpos = i * page + t;
      bool ok = kpos < len;
      if (window) ok = ok && kpos >= len - window;
      s_s[e] = ok ? s : kNegInf;
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      float mx = m_s[g];
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, s_s[g * page + t]);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = expf(s_s[g * page + t] - mx);
        s_s[g * page + t] = p;
        sum += p;
      }
      const float alpha = expf(m_s[g] - mx);
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = mx;
      a_s[g] = alpha;
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D;
      const int d = e % D;
      float pv = 0.f;
      for (int t = 0; t < page; ++t) pv = fmaf(s_s[g * page + t], v_s[t * D + d], pv);
      acc_s[e] = acc_s[e] * a_s[g] + pv;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D;
    out[qo + e] = Pack<T>::from_float(acc_s[e] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_hot, const void* v_hot,
                   const void* k_cold, const void* v_cold, const void* table,
                   const void* tier, const void* lengths, void* out, int B,
                   int H, int KVH, int D, int page, int NP, int n_hot,
                   int n_cold, int window, float softcap, float scale,
                   cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem =
      sizeof(float) * ((size_t)2 * G * D + (size_t)page * (D + 1) +
                       (size_t)page * D + (size_t)G * page + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  paged_decode_kernel<T><<<dim3(B, KVH), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_hot),
      static_cast<const T*>(v_hot), static_cast<const T*>(k_cold),
      static_cast<const T*>(v_cold), static_cast<const int*>(table),
      static_cast<const int*>(tier), static_cast<const int*>(lengths),
      static_cast<T*>(out), H, KVH, D, page, NP, n_hot, n_cold, window,
      softcap, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Device address of a mapped, pinned host allocation (cudaHostAlloc'd).
int host_device_pointer(void* host, void** device) {
  return (int)cudaHostGetDevicePointer(device, host, 0);
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// dtype: 0 = float32, 1 = bfloat16.  Pools are contiguous
// (n, page, KVH, D); table / tier (B, NP) and lengths (B,) are int32 on the
// device; k_cold / v_cold are device addresses of pinned host memory.
int paged_decode_attention(const void* q, const void* k_hot,
                           const void* v_hot, const void* k_cold,
                           const void* v_cold, const void* table,
                           const void* tier, const void* lengths, void* out,
                           int B, int H, int KVH, int D, int page, int NP,
                           int n_hot, int n_cold, int window, float softcap,
                           float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k_hot, v_hot, k_cold, v_cold, table,
                                      tier, lengths, out, B, H, KVH, D, page,
                                      NP, n_hot, n_cold, window, softcap,
                                      scale, s);
  if (dtype == 0)
    return (int)launch<float>(q, k_hot, v_hot, k_cold, v_cold, table, tier,
                              lengths, out, B, H, KVH, D, page, NP, n_hot,
                              n_cold, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
