// Flash decode over a contiguous KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py ::
// decode_attention (body `_kernel`).  For each (slot b, KV head h) the
// G = H / KVH query heads of one new token attend over the slot's visible
// keys of k_cache / v_cache (B, S, KVH, D): positions lo = max(0, len -
// window) (0 without a window) to hi = min(len, S), len = lengths[b].
// Scores are scaled by D^-0.5, tanh-softcapped when softcap != 0, and
// folded into an fp32 online softmax that starts at the finite NEG_INF =
// -2**20, never -inf, so exp(NEG_INF - NEG_INF) is 1 and never a NaN.  The
// output (B, H, D) is written once, in q's dtype.
//
// A slot with no visible key (length 0, or a window that starts past S)
// gives the oracle's answer (kernels/ref.py::decode_attention_ref scores all
// S keys NEG_INF, so its softmax is uniform): the mean of v over all S rows,
// with p = 1/S rounded to v's dtype as the oracle rounds it.  Every split
// sums its range of v with that weight, m = 0, and split 0 alone carries
// l = 1, so the merge below gives p * sum(v).  (The TPU kernel differs
// there: it also averages in its zero padding.)
//
// What bounds it: bytes.  Each visible key costs 2 * D * sizeof(T) bytes
// (K and V) per KV head, read once.  The arithmetic, 4 * G * D flops a key
// and KV head (G = 3 on smollm-360m's serving KV, 1 on zamba2-7b's shared
// block), is two orders of magnitude below the byte line of this card
// (about 295 flops a byte in bf16), so tensor cores are not the lever:
// keeping enough bytes in flight on every SM is.
//
// What the design does about that (flash-decoding, as K1 in
// paged_decode.cu):
// - Each slot's key range is split over n_split CTAs: split s owns keys
//   [s per, s per + per), per = ceil(S / n_split), and folds those of them
//   in [lo, hi).  A CTA covers one (split, slot, KV head, group of at most
//   kMaxG query heads): G > kMaxG heads are cut into ceil(G / kMaxG)
//   groups, each reading the KV head's keys again.  The grid runs the KV
//   heads fastest, so the CTAs in flight together read neighbouring
//   D-element rows of one (B, S, KVH, D) block rather than one head's rows
//   KVH * D apart.  Each split writes its partial (o, m, l) in f32 to
//   scratch (B, n_split, H, D + 2); a split whose range misses [lo, hi)
//   reads nothing and writes the empty partial, o = 0, m = NEG_INF, l = 0,
//   as K1's splits do (paged_decode.cu), so the merge reads no scratch that
//   was not written this call.  A second small kernel merges the partials,
//   m = max m_i, o = sum exp(m_i - m) o_i / max(sum exp(m_i - m) l_i,
//   1e-30): an empty partial adds nothing to either sum, since its o and l
//   are 0 (and its weight is 0 beside any split that saw a key).
// - The split count comes from shapes only (kernels/decode_attention.py::
//   plan_splits, never the lengths, which live on the card): enough CTAs
//   for two per SM at B * KVH CTAs a split, and at least enough splits that
//   no CTA reads more than 128 KB of K and V in bf16, so a long slot is
//   read by many SMs at once.  n_split = clamp(max(ceil(2 SMs / (B KVH)),
//   ceil(S / floor(128 KB / (4 D)))), 1, S).  On a 132-SM H100: 7 splits
//   (147 keys each) at the serving KV (B 8, S 1024, KVH 5, D 64) and 15
//   (274 keys each) at the long cache (B 8, S 4096, KVH 32, D 112).
// - Keys stay in flight: each of the CTA's four warps owns a ring of
//   kStages = 2 stages in shared memory, in the cache's own dtype, and takes
//   every fourth stage of the CTA's range; a stage is as many keys as fit
//   in kStageBytes of K (and as many of V).  A warp copies its stages with
//   16-byte cp.async, neighbouring lanes on neighbouring 16-byte chunks of
//   a key row, one stage ahead of the one it computes on.  Nothing but
//   cp.async.wait_group and __syncwarp stands between a stage's load and its
//   use: no block-wide barrier until the CTA merges its warps.  The ring is
//   kept short (32 KB a CTA) so that many CTAs share an SM: the bytes in
//   flight come from CTAs, and a deeper ring costs CTAs an SM.
// - Compute by warps, keys in registers: a key row's 16-byte chunks are
//   spread over `lanes` lanes (the power of two at or above D / 8 in bf16,
//   D / 4 in f32, at most 32; a lane takes chunks lane and lane + 32 past
//   32 chunks), so a warp folds 32 / lanes keys at once, one online-softmax
//   stream per group of lanes.  q and the accumulator of each query head
//   stay in registers, each lane holding its chunks' elements; a q.k is the
//   lane's partial dot reduced over its group by shuffles.  At the end the
//   CTA's streams merge in shared memory (the ring, then free) into the
//   split's partial.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (kernels/build.py); kernels/decode_attention.py is its wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1048576.0f;  // -2**20, as kernels/ref.py
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;         // ring stages per warp
constexpr int kStageBytes = 2048;  // K (and as many V) bytes per stage
constexpr int kMaxG = 4;           // query heads per CTA
constexpr int kBatch = 4;          // keys a stream folds at once
constexpr int kSmem = kWarps * kStages * 2 * kStageBytes;  // 32 KB
// The CTA's streams merge in the ring once it is free: at most 32 streams
// a warp (one lane a key row at D 8 in bf16), each with kMaxG rows of at
// most 8 elements a lane (D / lanes), and an m and an l per row.
static_assert(kSmem >= 4 * kMaxG * kWarps * 32 * (8 + 2),
              "the ring cannot hold the merge of the CTA's streams");
constexpr int kCombineThreads = 256;

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kVec = 4;  // elements per 16-byte chunk
  static constexpr int kCpl = 2;  // chunks per lane: D 256 is 64 chunks
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
  static constexpr int kCpl = 1;  // D 256 is 32 chunks
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  float* o_part;   // (B, n_split, H, D) f32
  float* ml_part;  // (B, n_split, H, 2) f32: m, l
  void* out;       // (B, H, D) contiguous
  int S, H, KVH, D, window;
  int n_split, per;  // splits per slot, keys per split
  int hgroups, gc;   // query-head groups per KV head, heads per group
  float softcap, scale;
  long long sq_b, sq_h;        // q strides (elements); d is contiguous
  long long sk_b, sk_s, sk_h;  // k_cache strides
  long long sv_b, sv_s, sv_h;  // v_cache strides
};

// Slot b's visible keys [lo, hi); with none (R5), all S keys, uniform.
__device__ __forceinline__ bool slot_range(const Args& a, int b, int& lo,
                                           int& hi) {
  const int len = a.lengths[b];
  hi = min(len, a.S);
  lo = a.window ? max(0, len - a.window) : 0;
  if (hi > lo) return false;
  lo = 0;
  hi = a.S;
  return true;
}

template <typename T, int kG>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(Args a) {
  constexpr int kVec = Pack<T>::kVec;
  constexpr int kCpl = Pack<T>::kCpl;
  constexpr int kE = kVec * kCpl;  // elements of a row a lane holds
  const int kvh = blockIdx.x / a.hgroups;
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.KVH;
  const int h0 = kvh * G + (blockIdx.x % a.hgroups) * a.gc;  // first head
  const int gn = min(a.gc, kvh * G + G - h0);  // this CTA's heads, <= kG
  int lo, hi;
  const bool uniform = slot_range(a, b, lo, hi);
  const int first = max(lo, split * a.per);
  const int last = min(hi, split * a.per + a.per);
  const int D = a.D;
  const int tid = threadIdx.x;
  const size_t part = (size_t)b * a.n_split + split;
  if (first >= last) {  // the empty partial: no weight in the merge
    const size_t hrow = part * a.H + h0;  // this CTA's gn heads, in a row
    for (int e = tid; e < gn * D; e += kThreads)
      a.o_part[hrow * D + e] = 0.f;
    for (int g = tid; g < gn; g += kThreads) {
      a.ml_part[(hrow + g) * 2] = kNegInf;
      a.ml_part[(hrow + g) * 2 + 1] = 0.f;
    }
    return;
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int chunks = D / kVec;
  int lanes = 1;
  while (lanes < chunks && lanes < 32) lanes *= 2;
  const int per_pass = 32 / lanes;  // keys a warp folds at once
  const int sub = lane / lanes;     // this lane's stream in the warp
  const int cl = lane % lanes;      // its chunks: cl, cl + lanes
  const int row = D * (int)sizeof(T);
  const int kps = (kStageBytes / row) / per_pass * per_pass;  // keys/stage
  const int n = last - first;
  const int nstages = (n + kps - 1) / kps;
  const int mine = nstages > warp ? (nstages - warp + kWarps - 1) / kWarps
                                  : 0;  // this warp's stages: warp + 4 t

  const T* kb = static_cast<const T*>(a.k) + b * a.sk_b + kvh * a.sk_h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv_b + kvh * a.sv_h;
  extern __shared__ uint4 smem[];
  char* ring = reinterpret_cast<char*>(smem) +
               (size_t)warp * kStages * 2 * kStageBytes;

  // copy this warp's stage t (the CTA's stage warp + 4 t) into ring slot
  // t % kStages: key rows of D elements, K then V
  auto load = [&](int t) {
    const int k0 = first + (warp + kWarps * t) * kps;
    const int nk = min(kps, last - k0);
    T* kd = reinterpret_cast<T*>(ring + (t % kStages) * 2 * kStageBytes);
    T* vd = kd + kStageBytes / sizeof(T);
    for (int c = lane; c < nk * chunks; c += 32) {
      const int key = c / chunks;
      const int col = (c - key * chunks) * kVec;
      if (!uniform)
        cp_async16(kd + key * D + col, kb + (k0 + key) * a.sk_s + col);
      cp_async16(vd + key * D + col, vb + (k0 + key) * a.sv_s + col);
    }
  };

  auto row_chunks = [&](const T* r, float* f) {
#pragma unroll
    for (int c = 0; c < kCpl; ++c) {
      const int ch = cl + c * lanes;
      if (ch < chunks) {
        Pack<T>::unpack(*reinterpret_cast<const uint4*>(r + ch * kVec),
                        f + c * kVec);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) f[c * kVec + e] = 0.f;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine) load(s);
    cp_async_commit();  // one group per stage, empty or not
  }
  // q while the first stages are in flight
  float q[kG][kE], acc[kG][kE], m[kG], l[kG];
  {
    const T* qb = static_cast<const T*>(a.q) + b * a.sq_b;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      m[g] = uniform ? 0.f : kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int c = 0; c < kCpl; ++c) {
        const int ch = cl + c * lanes;
        float f[kVec] = {};
        if (g < gn && ch < chunks)
          Pack<T>::unpack(*reinterpret_cast<const uint4*>(
                              qb + (h0 + g) * a.sq_h + ch * kVec),
                          f);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          q[g][c * kVec + e] = f[e];
          acc[g][c * kVec + e] = 0.f;
        }
      }
    }
  }

  for (int t = 0; t < mine; ++t) {
    cp_async_wait<kStages - 2>();  // this lane's copies of stage t landed
    __syncwarp();  // every lane's, and every lane is done with stage t - 1
    if (t + kStages - 1 < mine) load(t + kStages - 1);
    cp_async_commit();
    const int nk = min(kps, last - (first + (warp + kWarps * t) * kps));
    const T* ks =
        reinterpret_cast<const T*>(ring + (t % kStages) * 2 * kStageBytes);
    const T* vs = ks + kStageBytes / sizeof(T);
    // kBatch keys a stream at once: independent dot products and exps,
    // one rescale of the accumulator a batch
    for (int k0 = 0; k0 < nk; k0 += kBatch * per_pass) {
      bool valid[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        valid[i] = k0 + i * per_pass + sub < nk;
      if (uniform) {
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          if (!valid[i]) continue;
          float vf[kE];
          row_chunks(vs + (k0 + i * per_pass + sub) * D, vf);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[g][e] += vf[e];
          }
        }
        continue;
      }
      float s[kBatch][kG];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        float kf[kE];
        row_chunks(ks + (valid[i] ? k0 + i * per_pass + sub : 0) * D, kf);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < kE; ++e) dot = fmaf(q[g][e], kf[e], dot);
          s[i][g] = dot;
        }
      }
#pragma unroll
      for (int w = 16; w > 0; w /= 2) {  // over the stream's `lanes` lanes
        if (w >= lanes) continue;
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
#pragma unroll
          for (int g = 0; g < kG; ++g)
            s[i][g] += __shfl_xor_sync(~0u, s[i][g], w);
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g >= gn) break;  // the same for every lane of the CTA
        float m_new = m[g];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          float sc = s[i][g] * a.scale;
          if (a.softcap != 0.f) sc = a.softcap * tanhf(sc / a.softcap);
          s[i][g] = sc;
          if (valid[i]) m_new = fmaxf(m_new, sc);
        }
        const float alpha = expf(m[g] - m_new);
        m[g] = m_new;
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (!valid[i]) continue;
        float vf[kE];
        row_chunks(vs + (k0 + i * per_pass + sub) * D, vf);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          if (g >= gn) break;
          const float p = expf(s[i][g] - m[g]);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it

  // merge the CTA's 4 * per_pass streams into the split's partial
  const int streams = kWarps * per_pass;
  const int st = warp * per_pass + sub;
  float* ms = reinterpret_cast<float*>(smem);  // (streams, kG) m
  float* ls = ms + streams * kG;               // (streams, kG) l
  float* os = ls + streams * kG;               // (streams, kG, D) o
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g >= gn) break;
    if (cl == 0) {
      ms[st * kG + g] = m[g];
      ls[st * kG + g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < kCpl; ++c) {
      const int ch = cl + c * lanes;
      if (ch < chunks) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          os[(st * kG + g) * D + ch * kVec + e] = acc[g][c * kVec + e];
      }
    }
  }
  __syncthreads();
  const float pu = Pack<T>::to_float(Pack<T>::from_float(1.f / a.S));
  for (int e = tid; e < gn * (D + 1); e += kThreads) {
    const int g = e / (D + 1);
    const int d = e - g * (D + 1);  // d == D: the row's m and l
    float mx = kNegInf;
    for (int i = 0; i < streams; ++i) mx = fmaxf(mx, ms[i * kG + g]);
    float o = 0.f, lsum = 0.f;
    for (int i = 0; i < streams; ++i) {
      const float w = expf(ms[i * kG + g] - mx);
      if (d < D) o = fmaf(w, os[(i * kG + g) * D + d], o);
      lsum = fmaf(w, ls[i * kG + g], lsum);
    }
    const size_t hrow = part * a.H + h0 + g;
    if (d < D) {
      a.o_part[hrow * D + d] = uniform ? pu * o : o;
    } else {
      a.ml_part[hrow * 2] = uniform ? 0.f : mx;
      a.ml_part[hrow * 2 + 1] = uniform ? (split == 0 ? 1.f : 0.f) : lsum;
    }
  }
}

// Merge slot b's partials: one CTA per (query head, slot).  The threads
// take the splits in turn for m and l (a block reduction each), keep the
// first kCombineW weights in shared memory, then take the d's.
__device__ __forceinline__ float block_reduce(float x, float* red, bool max) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(~0u, x, o);
    x = max ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // an earlier reduction's readers of red are done
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < (int)blockDim.x / 32; ++w)
    x = max ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

constexpr int kCombineW = 1024;  // split weights kept in shared memory

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    decode_combine_kernel(Args a) {
  __shared__ float wsh[kCombineW];
  __shared__ float red[kCombineThreads / 32];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float* ml = a.ml_part + ((size_t)b * a.n_split * a.H + h) * 2;
  const size_t mstride = (size_t)a.H * 2;  // between splits
  float m = kNegInf;
  for (int s = threadIdx.x; s < a.n_split; s += blockDim.x)
    m = fmaxf(m, ml[s * mstride]);
  m = block_reduce(m, red, true);
  float l = 0.f;
  for (int s = threadIdx.x; s < a.n_split; s += blockDim.x) {
    const float w = expf(ml[s * mstride] - m);
    if (s < kCombineW) wsh[s] = w;
    l = fmaf(w, ml[s * mstride + 1], l);
  }
  l = block_reduce(l, red, false);  // its barriers publish wsh too
  const float* op = a.o_part + ((size_t)b * a.n_split * a.H + h) * a.D;
  const size_t ostride = (size_t)a.H * a.D;
  for (int d = threadIdx.x; d < a.D; d += blockDim.x) {
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < a.n_split; ++s) {
      const float w = s < kCombineW ? wsh[s] : expf(ml[s * mstride] - m);
      o = fmaf(w, op[s * ostride + d], o);
    }
    static_cast<T*>(a.out)[((size_t)b * a.H + h) * a.D + d] =
        Pack<T>::from_float(o / fmaxf(l, 1e-30f));
  }
}

// Raise `kernel`'s dynamic shared memory cap once per device.
template <typename K>
cudaError_t allow_smem(K kernel, int* configured) {
  constexpr int kMaxDevices = 64;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && configured[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess && dev < kMaxDevices) configured[dev] = 1;
  return err;
}

template <typename T, int kG>
cudaError_t launch_heads(const Args& a, int B, cudaStream_t stream) {
  static int configured[64] = {};
  cudaError_t err = allow_smem(decode_split_kernel<T, kG>, configured);
  if (err != cudaSuccess) return err;
  // KV heads fastest: the CTAs that run together read neighbouring rows
  // of the (B, S, KVH, D) cache, not one head's rows KVH * D apart alone
  decode_split_kernel<T, kG>
      <<<dim3(a.KVH * a.hgroups, a.n_split, B), kThreads, kSmem, stream>>>(
          a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(a.H, B), 128, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(Args a, int B, cudaStream_t stream) {
  const int G = a.H / a.KVH;
  if (G == 1) {
    a.hgroups = a.gc = 1;
    return launch_heads<T, 1>(a, B, stream);
  }
  a.hgroups = (G + kMaxG - 1) / kMaxG;
  a.gc = (G + a.hgroups - 1) / a.hgroups;
  return launch_heads<T, kMaxG>(a, B, stream);
}

}  // namespace

extern "C" {

// Launch both kernels on `stream`; returns cudaGetLastError() after the
// launches (0 = ok).  dtype: 0 = float32, 1 = bfloat16.  q (B, H, D),
// k_cache / v_cache (B, S, KVH, D) through the given strides (elements; the
// last dimension contiguous, every row 16-byte aligned); lengths (B,) int32
// on the device; out (B, H, D) contiguous; o_part (B, n_split, H, D) and
// ml_part (B, n_split, H, 2) f32 scratch on the device;
// 1 <= n_split <= min(S, 65535), B <= 65535.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* lengths, void* out, void* o_part,
                     void* ml_part, int B, int S, int H, int KVH, int D,
                     int window, int n_split, float softcap, float scale,
                     long long sq_b, long long sq_h, long long sk_b,
                     long long sk_s, long long sk_h, long long sv_b,
                     long long sv_s, long long sv_h, int dtype,
                     void* stream) {
  if (B < 1 || B > 65535 || S < 1 || KVH < 1 || H % KVH || D < 8 ||
      D > 256 || D % 8 || n_split < 1 || n_split > S || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{q,
         k,
         v,
         static_cast<const int*>(lengths),
         static_cast<float*>(o_part),
         static_cast<float*>(ml_part),
         out,
         S,
         H,
         KVH,
         D,
         window,
         n_split,
         (S + n_split - 1) / n_split,
         1,
         1,
         softcap,
         scale,
         sq_b,
         sq_h,
         sk_b,
         sk_s,
         sk_h,
         sv_b,
         sv_s,
         sv_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, B, s);
  if (dtype == 0) return (int)launch<float>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
