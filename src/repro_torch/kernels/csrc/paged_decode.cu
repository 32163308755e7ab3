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
// page inside the window.  Unmapped entries (FREE = -1) clip into the pool,
// as the reference does.  The output is (B, H, D) in q's dtype.
//
// What bounds it: bytes.  Each visited page costs page * KVH * D * 2 *
// sizeof(T) bytes over all KV heads (K and V); hot pages arrive at device
// memory bandwidth, cold pages at the host link's, read straight from the
// pinned host pool through its mapped device pointer — this card's form of
// the TPU kernel's host->VMEM DMA.  The arithmetic (4 * G * D flops per
// token and KV head) is far below what the card can do per byte.
//
// What the design does about that (flash-decoding):
// - Each slot's logical pages are split over n_split CTAs (split s owns
//   pages [s P, s P + P), P = ceil(NP / n_split)), one CTA per (split,
//   slot), so a long slot is read by many SMs at once rather than by one
//   CTA walking a chain of host-link round trips.  The wrapper picks n_split
//   from B, NP and the SM count only, never from the lengths, which live on
//   the card.  Each CTA writes its partial (o, m, l) in f32 to scratch; a
//   CTA whose range lies wholly past the length or before the window writes
//   m = NEG_INF, l = 0, o = 0.  A second small kernel merges the partials:
//   m = max m_i, o = sum exp(m_i - m) o_i / sum exp(m_i - m) l_i, so an
//   empty partial gets weight 0 (or, when every partial is empty, the
//   output is 0 as before): finite arithmetic, never a NaN.
// - Grouping: a CTA covers kv_group KV heads of its slot, all of them
//   wherever they fit.  The pool layout (n, page, KVH, D) makes one page's K
//   for all heads one contiguous block (10 KB for smollm-360m in bf16), so a
//   warp's 16-byte copies cover 512 contiguous bytes and the host link sees
//   long reads; per-head CTAs would read rows of D * sizeof(T) bytes (128 B)
//   spread KVH rows apart.  Where a ring of whole pages for all heads does
//   not fit in shared memory (musicgen-medium's 24 KV heads, gemma3-12b's
//   D 256), the wrapper gives each CTA fewer KV heads (a divisor of KVH),
//   and at one KV head fewer tokens per ring buffer (`tile`, a divisor of
//   page): so every shape whose one page of one head fits still runs.
//   kernels/paged_decode.py::plan_tiles makes that choice from the shapes.
// - Pages stay in flight: a CTA copies its tiles' K and V with 16-byte
//   cp.async (from device memory for hot pages, from the mapped host
//   address for cold ones) into a ring of kStages buffers, kStages - 1
//   tiles ahead of the one it computes on, so the host-link reads of pages
//   i + 1 .. overlap page i.  (A TMA bulk copy per page, cp.async.bulk,
//   also reads the mapped pool, but read cold pages more slowly than the
//   16-byte copies on this card, so the ring keeps cp.async.)
// - Compute is by warps: for the scores each warp takes (token, query head)
//   pairs of the tile, a group of `lanes` lanes per pair (the power of two
//   at or above D / 8 in bf16, D / 4 in f32, at most 32), each lane every
//   lanes-th 16-byte chunk of the key row, so a warp reduces several q.k at
//   once by shuffles (eight lanes and four pairs a warp at D 64 in bf16;
//   at D 256 in f32 one pair of 32 lanes, two chunks a lane); each warp
//   takes query heads for the online softmax, with the tile's scores
//   spread over its lanes; every thread takes output elements for the P.V
//   update of the f32 accumulator.
// The wrapper (kernels/paged_decode.py) counts one launch per call, for the
// two kernels together, so a decode step still counts one per layer.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (kernels/build.py); kernels/paged_decode.py is its wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1048576.0f;  // -2**20, as kernels/ref.py
constexpr int kThreads = 256;

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
      const float2 f = __bfloat1622float2(h[k]);
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, global (device memory or mapped host memory) -> shared
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) x += __shfl_xor_sync(~0u, x, w);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, w));
  return x;
}

constexpr int kStages = 3;  // page buffers in the ring
constexpr int kWarps = kThreads / 32;

struct Args {
  const void* q;
  const void* k_hot;
  const void* v_hot;
  const void* k_cold;
  const void* v_cold;
  const int* table;
  const int* tier;
  const int* lengths;
  float* o_part;   // (B, n_split, H, D) f32, unnormalised
  float* ml_part;  // (B, n_split, H, 2) f32: m, l
  void* out;
  int H, KVH, D, page, NP, n_hot, n_cold, window, n_split;
  int kv_group;  // KV heads per CTA, a divisor of KVH
  int tile;      // tokens per ring buffer, a divisor of page
  float softcap, scale;
};

// as kernels/paged_decode.py::smem_bytes
inline size_t split_smem_bytes(const Args& a, size_t esize) {
  const size_t hq = (size_t)a.kv_group * (a.H / a.KVH);
  return sizeof(float) * (2 * hq * a.D + hq * a.tile + 3 * hq) + 16 +
         (size_t)kStages * 2 * a.tile * a.kv_group * a.D * esize;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) paged_split_kernel(Args a) {
  constexpr int kVec = Pack<T>::kVec;
  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int G = a.H / a.KVH;
  const int hg = a.kv_group;        // this CTA's KV heads ...
  const int kv0 = blockIdx.z * hg;  // ... from kv0
  const int Hg = hg * G;            // its query heads, from kv0 * G
  const int h0 = kv0 * G;
  const int D = a.D;
  const int page = a.page;
  const int tile = a.tile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ float smem[];
  float* q_s = smem;             // (Hg, D)
  float* acc_s = q_s + Hg * D;   // (Hg, D) f32 accumulator
  float* s_s = acc_s + Hg * D;   // (Hg, tile) scores, then probabilities
  float* m_s = s_s + Hg * tile;  // (Hg,) running max
  float* l_s = m_s + Hg;         // (Hg,) running sum
  float* a_s = l_s + Hg;         // (Hg,) rescale of this tile's update
  // kStages buffers of one tile's K and V for the CTA's KV heads, each
  // (tile, hg, D) in T; 16-byte aligned
  T* ring = reinterpret_cast<T*>(
      (reinterpret_cast<uintptr_t>(a_s + Hg) + 15) & ~(uintptr_t)15);
  const int row = hg * D;          // one token's K (or V) for those heads
  const int buf = tile * row;
  const size_t pool_page = (size_t)page * a.KVH * D;

  const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.H + h0) * D;
  for (int e = tid; e < Hg * D; e += kThreads) {
    q_s[e] = Pack<T>::to_float(q[e]);
    acc_s[e] = 0.f;
  }
  for (int hq = tid; hq < Hg; hq += kThreads) {
    m_s[hq] = kNegInf;
    l_s[hq] = 0.f;
  }

  // this CTA's pages: its split's range within [lo, npages), as tiles
  const int len = a.lengths[b];
  const int npages = min((len + page - 1) / page, a.NP);
  const int lo = a.window ? max(0, (len - a.window) / page) : 0;
  const int per = (a.NP + a.n_split - 1) / a.n_split;
  const int first = max(split * per, lo);
  const int tiles = page / tile;  // per page
  const int nt = max(min(split * per + per, npages) - first, 0) * tiles;

  // copy tile j's K and V rows (token t0 + t, heads kv0 .. kv0 + hg) into
  // ring buffer `st`; consecutive threads take consecutive 16-byte chunks,
  // and with every KV head in the CTA the tile is one contiguous block
  auto load = [&](int j, int st) {
    const int i = first + j / tiles;
    const int t0 = (j % tiles) * tile;
    const int phys = a.table[(size_t)b * a.NP + i];
    const T* kp;
    const T* vp;
    if (a.tier[(size_t)b * a.NP + i] == 0) {
      const size_t p = min(max(phys, 0), a.n_hot - 1);
      kp = static_cast<const T*>(a.k_hot) + p * pool_page;
      vp = static_cast<const T*>(a.v_hot) + p * pool_page;
    } else {
      const size_t p = min(max(phys, 0), a.n_cold - 1);
      kp = static_cast<const T*>(a.k_cold) + p * pool_page;
      vp = static_cast<const T*>(a.v_cold) + p * pool_page;
    }
    const size_t src0 = ((size_t)t0 * a.KVH + kv0) * D;
    T* kd = ring + (size_t)st * 2 * buf;
    T* vd = kd + buf;
    for (int c = tid * kVec; c < buf; c += kThreads * kVec) {
      const int t = c / row;
      const size_t src = src0 + (size_t)t * a.KVH * D + (c - t * row);
      cp_async16(kd + c, kp + src);
      cp_async16(vd + c, vp + src);
    }
  };

  // scores: a (token, query head) pair per group of `lanes` lanes, lane
  // `chunk` taking the row's 16-byte chunks chunk, chunk + lanes, ...; a
  // warp reduces 32 / lanes dot products at once by shuffles
  const int chunks = D / kVec;
  int lanes = 1;
  while (lanes < chunks && lanes < 32) lanes *= 2;
  const int sub = lane / lanes;    // which pair of the warp's
  const int chunk = lane % lanes;  // which 16-byte chunks of it
  const int per_warp = 32 / lanes;
  const int units = tile * Hg;     // (token, query head) pairs

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) load(s, s);
    cp_async_commit();  // one group per ring slot, empty or not
  }

  for (int j = 0; j < nt; ++j) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile j landed
    __syncthreads();  // everyone's, and everyone is done with tile j - 1
    const int ahead = j + kStages - 1;
    if (ahead < nt) load(ahead, ahead % kStages);
    cp_async_commit();

    const int base = (first + j / tiles) * page + (j % tiles) * tile;
    const T* k_s = ring + (size_t)(j % kStages) * 2 * buf;
    const T* v_s = k_s + buf;
    for (int u0 = warp * per_warp; u0 < units; u0 += kWarps * per_warp) {
      const int u = u0 + sub;
      const int t = u / Hg;
      const int hq = u % Hg;
      float dot = 0.f;
      if (u < units) {
        const T* kr = k_s + (t * hg + hq / G) * D;
        const float* qr = q_s + hq * D;
        for (int c = chunk; c < chunks; c += lanes) {
          float kf[kVec];
          Pack<T>::unpack(*reinterpret_cast<const uint4*>(kr + c * kVec), kf);
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            dot = fmaf(qr[c * kVec + e], kf[e], dot);
        }
      }
      for (int w = lanes / 2; w > 0; w /= 2)
        dot += __shfl_xor_sync(~0u, dot, w);
      if (chunk == 0 && u < units) {
        const int kpos = base + t;
        bool ok = kpos < len;
        if (a.window) ok = ok && kpos >= len - a.window;
        float sc = dot * a.scale;
        if (a.softcap != 0.f) sc = a.softcap * tanhf(sc / a.softcap);
        s_s[hq * tile + t] = ok ? sc : kNegInf;
      }
    }
    __syncthreads();
    // online softmax: a warp per query head, lanes over the tile's tokens
    for (int hq = warp; hq < Hg; hq += kWarps) {
      float mx = m_s[hq];
      for (int t = lane; t < tile; t += 32)
        mx = fmaxf(mx, s_s[hq * tile + t]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < tile; t += 32) {
        const float p = expf(s_s[hq * tile + t] - mx);
        s_s[hq * tile + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_s[hq] - mx);
        l_s[hq] = l_s[hq] * alpha + sum;
        m_s[hq] = mx;
        a_s[hq] = alpha;
      }
    }
    __syncthreads();
    // P.V: every thread takes output elements
    for (int e = tid; e < Hg * D; e += kThreads) {
      const int hq = e / D;
      const T* vcol = v_s + (hq / G) * D + e % D;
      const float* p = s_s + hq * tile;
      float pv = 0.f;
      for (int t = 0; t < tile; ++t)
        pv = fmaf(p[t], Pack<T>::to_float(vcol[t * row]), pv);
      acc_s[e] = acc_s[e] * a_s[hq] + pv;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const size_t part = (size_t)b * a.n_split + split;
  for (int e = tid; e < Hg * D; e += kThreads)
    a.o_part[(part * a.H + h0) * D + e] = acc_s[e];
  for (int hq = tid; hq < Hg; hq += kThreads) {
    a.ml_part[(part * a.H + h0 + hq) * 2] = m_s[hq];
    a.ml_part[(part * a.H + h0 + hq) * 2 + 1] = l_s[hq];
  }
}

// Merge the n_split partials of each slot into the output.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(Args a) {
  const int b = blockIdx.x;
  const int H = a.H;
  const int D = a.D;
  const size_t part0 = (size_t)b * a.n_split;
  T* out = static_cast<T*>(a.out) + (size_t)b * H * D;
  for (int e = threadIdx.x; e < H * D; e += kThreads) {
    const int hq = e / D;
    float m = kNegInf;
    for (int s = 0; s < a.n_split; ++s)
      m = fmaxf(m, a.ml_part[((part0 + s) * H + hq) * 2]);
    float l = 0.f, o = 0.f;
    for (int s = 0; s < a.n_split; ++s) {
      const float w = expf(a.ml_part[((part0 + s) * H + hq) * 2] - m);
      l = fmaf(w, a.ml_part[((part0 + s) * H + hq) * 2 + 1], l);
      o = fmaf(w, a.o_part[(part0 + s) * H * D + e], o);
    }
    out[e] = Pack<T>::from_float(o / fmaxf(l, 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  // raise the split kernel's dynamic shared memory cap to the card's
  // opt-in limit once per device, not on every call
  constexpr int kMaxDevices = 64;
  static int configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t smem = split_smem_bytes(a, sizeof(T));
  if (smem > (size_t)limit) return cudaErrorInvalidValue;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(paged_split_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[dev] = 1;
  }
  paged_split_kernel<T>
      <<<dim3(a.n_split, B, a.KVH / a.kv_group), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T><<<B, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Device address of a mapped, pinned host allocation (cudaHostAlloc'd).
int host_device_pointer(void* host, void** device) {
  return (int)cudaHostGetDevicePointer(device, host, 0);
}

// The largest dynamic shared memory one CTA may opt in to on the current
// device, in bytes (0 = ok).
int paged_decode_smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Launch both kernels on `stream`; returns cudaGetLastError() after the
// launches (0 = ok).  dtype: 0 = float32, 1 = bfloat16.  Pools are
// contiguous (n, page, KVH, D); table / tier (B, NP) and lengths (B,) are
// int32 on the device; k_cold / v_cold are device addresses of pinned host
// memory.  o_part (B, n_split, H, D) and ml_part (B, n_split, H, 2) are f32
// scratch on the device; 1 <= n_split <= max(NP, 1); kv_group divides KVH,
// tile divides page, and their ring must fit the card's shared memory.
int paged_decode_attention(const void* q, const void* k_hot,
                           const void* v_hot, const void* k_cold,
                           const void* v_cold, const void* table,
                           const void* tier, const void* lengths, void* out,
                           void* o_part, void* ml_part, int B, int H, int KVH,
                           int D, int page, int NP, int n_hot, int n_cold,
                           int window, int n_split, int kv_group, int tile,
                           float softcap, float scale, int dtype,
                           void* stream) {
  if (n_split < 1 || n_split > max(NP, 1) || kv_group < 1 ||
      KVH % kv_group != 0 || tile < 1 || page % tile != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q,        k_hot,    v_hot,   k_cold,
               v_cold,   static_cast<const int*>(table),
               static_cast<const int*>(tier),
               static_cast<const int*>(lengths),
               static_cast<float*>(o_part), static_cast<float*>(ml_part),
               out,      H,        KVH,     D,
               page,     NP,       n_hot,   n_cold,
               window,   n_split,  kv_group, tile,
               softcap,  scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, B, s);
  if (dtype == 0) return (int)launch<float>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
