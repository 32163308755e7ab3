// Blocked online-softmax (flash) attention, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention (body `_kernel`).  q (B, Sq, H, D); k, v (B, Skv, KVH, D);
// query head h reads KV head h / G (G = H / KVH) through its strides, so KV
// is never repeated in memory.  Queries are right-aligned to the end of the
// KV timeline: row i sits at qpos = i + Skv - Sq.  Key kpos is visible to
// row i when kpos < Skv, kpos <= qpos (causal) and qpos - kpos < window
// (window > 0).  Scores are scaled by D^-0.5, tanh-softcapped when
// softcap != 0, masked to the finite NEG_INF = -2**20 (never -inf, so
// exp(NEG_INF - NEG_INF) is 1 and never a NaN), and folded tile by tile into
// an fp32 online softmax.  The output (B, Sq, H, D) is written once, in q's
// dtype.
//
// Rows with no visible key (causal and qpos < 0, when Sq > Skv) take the
// oracle's answer (kernels/ref.py::attention_ref): every score is NEG_INF,
// the softmax is uniform, and the row is the mean of v over all Skv real
// keys, with p = 1/Skv rounded to v's dtype as the oracle rounds it.  The
// kernel computes that mean in a pass of its own, only in tiles that hold
// such rows.  (The TPU kernel differs there: it also averages in its zero
// padding.)  Every other row sees at least one key; the tiles it visits
// before its first visible key add finite values that the rescale
// exp(NEG_INF - m) = 0 wipes out when that key arrives.
//
// What bounds it: operations.  4 B H D flops per visible (query, key) pair;
// at zamba2-7b's shared block (B 2, S 4096, H 32, D 112, causal, bf16) that
// is 240.6 GFLOP, 0.243 ms at the card's bf16 tensor-core rate against
// 0.070 ms for q, k, v and o moved once.
//
// What this first design does: two paths, each one CTA per (query tile of
// kBQ = 64 rows, head, batch row), the tiles that see the most keys
// launched first.  Each walks KV tiles of kBK = 64 keys staged in shared
// memory, only from the first key the tile's window reaches to the causal
// diagonal of its last row; the ragged ends of Sq and Skv are masked by
// bounds, with no padding.
// - bf16 at D 16, 32, 64, 112, 128 or 256 (every head_dim of the repo's
//   configs): mma.sync tensor-core products, described at flash_mma_kernel
//   below.
// - f32, and bf16 at any other D: a SIMT kernel of 256 threads.  Both
//   products are register-tiled f32 FMAs on CUDA cores: each thread holds a
//   4 x 4 tile of the scores and a 4-row by 4-column tile of each
//   64-column chunk of the output (up to 4 chunks, D <= 256), and the row
//   statistics reduce over the 16 threads of a row with shuffles.  Shared
//   memory is 4 (3 kBQ D + kBQ kBK + D) bytes, 214 KB at D 256 (under the
//   227 KB a block may have) and 103 KB at D 112.
// wgmma with TMA loads and a warp-specialised pipeline, which would bring
// the bf16 path toward the operation bound, are a later change's work.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (kernels/build.py); kernels/flash_attention.py is its wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1048576.0f;  // -2**20, as kernels/ref.py
constexpr int kBQ = 64;                 // query rows per CTA
constexpr int kBK = 64;                 // keys per KV tile
constexpr int kThreads = 256;           // 16 x 16 threads, 4 x 4 each
constexpr int kChunks = 4;              // 64-column output chunks, D <= 256

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
  void* out;
  int Sq, Skv, H, KVH, D, causal, window;
  float softcap, scale;
  long long sq_b, sq_s, sq_h;  // strides (elements); d is contiguous
  long long sk_b, sk_s, sk_h;
  long long sv_b, sv_s, sv_h;
};

inline size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)3 * kBQ * D + (size_t)kBQ * kBK + D);
}

// Stage rows [r0, r0 + n) of one head of a (B, S, heads, D) tensor into
// shared memory as f32, zero-filling rows n .. 63.  transpose: dst[d][row]
// (a kBQ- or kBK-wide column per d); else dst[row][d].  Consecutive
// threads take consecutive rows when transposing, consecutive 16-byte
// chunks of a row otherwise, so the shared-memory writes stay spread over
// the banks.
template <typename T, bool transpose>
__device__ __forceinline__ void stage(float* dst, const T* src, long long s_s,
                                      int r0, int n, int D) {
  constexpr int kVec = Pack<T>::kVec;
  const int row_chunks = D / kVec;
  for (int c = threadIdx.x; c < 64 * row_chunks; c += kThreads) {
    const int t = transpose ? c % 64 : c / row_chunks;
    const int d0 = (transpose ? c / 64 : c % row_chunks) * kVec;
    float f[kVec];
    if (t < n) {
      const uint4 u =
          *reinterpret_cast<const uint4*>(src + (r0 + t) * s_s + d0);
      Pack<T>::unpack(u, f);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (transpose)
        dst[(d0 + j) * 64 + t] = f[j];
      else
        dst[t * D + d0 + j] = f[j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(Args a) {
  const int n_tiles = gridDim.x;
  const int tile = n_tiles - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = a.D;
  const int G = a.H / a.KVH;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // keys tx*4 .. +3; output columns c*64 + tx*4 ..
  const int off = a.Skv - a.Sq;  // qpos = i + off

  const int q0 = tile * kBQ;
  const int nq = min(kBQ, a.Sq - q0);
  const T* qb = static_cast<const T*>(a.q) + b * a.sq_b + h * a.sq_h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk_b + kvh * a.sk_h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv_b + kvh * a.sv_h;

  extern __shared__ float smem[];
  float* q_t = smem;              // (D, kBQ): q transposed
  float* k_t = q_t + D * kBQ;     // (D, kBK): k transposed
  float* v_s = k_t + D * kBK;     // (kBK, D)
  float* p_t = v_s + kBK * D;     // (kBK, kBQ): probabilities transposed
  float* vsum = p_t + kBK * kBQ;  // (D,): sum of v over all keys

  stage<T, true>(q_t, qb, a.sq_s, q0, nq, D);

  // the keys any row of this tile can see: from the first key the window
  // reaches for its first row to the causal diagonal of its last row
  const int hi = a.causal ? min(a.Skv, q0 + nq + off) : a.Skv;
  const int lo = a.window ? max(0, q0 + off - a.window + 1) : 0;

  float o[kChunks][4][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[c][i][j] = 0.f;
  }

  for (int base = lo; base < hi; base += kBK) {
    const int n = min(kBK, hi - base);
    __syncthreads();  // the previous tile's readers of k_t / v_s / p_t
    stage<T, true>(k_t, kb, a.sk_s, base, n, D);
    stage<T, false>(v_s, vb, a.sv_s, base, n, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(q_t + d * kBQ + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(k_t + d * kBK + tx * 4);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kr[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + off;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = base + tx * 4 + j;
        float x = s[i][j] * a.scale;
        if (a.softcap != 0.f) x = a.softcap * tanhf(x / a.softcap);
        bool ok = j + tx * 4 < n;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window) ok = ok && qpos - kpos < a.window;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, w));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // keys past the tile's end (zero-filled) never count
        s[i][j] = j + tx * 4 < n ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) sum += __shfl_xor_sync(~0u, sum, w);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_t + (tx * 4 + j) * kBQ + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[c][i][j] *= alpha[i];
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float4 pv = *reinterpret_cast<const float4*>(p_t + t * kBQ + ty * 4);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = c * 64 + tx * 4;
        if (col < D) {
          const float4 vv = *reinterpret_cast<const float4*>(v_s + t * D + col);
          const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) o[c][i][j] = fmaf(pr[i], vr[j], o[c][i][j]);
        }
      }
    }
  }

  // rows with no visible key (causal, qpos < 0): the mean of v over all
  // Skv keys, as the oracle's uniform softmax gives
  const bool empty_rows = a.causal && q0 + off < 0;
  if (empty_rows) {
    for (int d = tid; d < D; d += kThreads) {
      float sum = 0.f;
      for (int t = 0; t < a.Skv; ++t)
        sum += Pack<T>::to_float(vb[t * a.sv_s + d]);
      vsum[d] = sum;
    }
    __syncthreads();
  }
  const float p_empty = Pack<T>::to_float(Pack<T>::from_float(1.f / a.Skv));
  T* ob = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nq) continue;
    const bool empty = a.causal && q0 + r + off < 0;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = ob + (((size_t)b * a.Sq + q0 + r) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = c * 64 + tx * 4;
      if (col >= D) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        orow[col + j] = Pack<T>::from_float(
            empty ? p_empty * vsum[col + j] : o[c][i][j] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}


// ------------------------------------------------ bf16 tensor-core path ----
//
// For bf16 inputs with D in {16, 32, 64, 112, 128, 256} (every head_dim of
// the repo's configs): one CTA of four warps per (query tile of kBQ rows,
// head, batch row), each warp owning 16 query rows.  q, K and V tiles are
// staged in shared memory as bf16 with cp.async (rows padded by 16 bytes
// so ldmatrix hits distinct banks); K(j + 1) loads while P.V(j) runs and
// V(j) while Q.K(j)^T runs.  Both products are mma.sync m16n8k16 with bf16
// operands and f32 accumulation: bf16 q.k products are exact in f32, and p
// goes from the score accumulators to the P.V operands in registers,
// rounded to bf16 (the plain version rounds p to bf16 too, after
// normalising; the two roundings differ by at most 2**-8 of each p).  The
// masks, the online softmax and the rows with no visible key are the SIMT
// kernel's.

constexpr int kMmaThreads = 128;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

template <int kD>
inline size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * 3 * kBQ * (kD + 8) + sizeof(float) * kD;
}

// Stage rows [r0, r0 + n) of one head into a (64, kD + 8) bf16 tile with
// cp.async, zero-filling rows n .. 63.
template <int kD>
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            long long s_s, int r0, int n) {
  constexpr int kRowChunks = kD / 8;
  for (int c = threadIdx.x; c < 64 * kRowChunks; c += kMmaThreads) {
    const int t = c / kRowChunks;
    const int d0 = (c % kRowChunks) * 8;
    const bool valid = t < n;
    cp_async16(dst + t * (kD + 8) + d0,
               valid ? src + (r0 + t) * s_s + d0 : src, valid);
  }
}

template <int kD>
__global__ void __launch_bounds__(kMmaThreads) flash_mma_kernel(Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = kD + 8;  // padded row, in elements
  constexpr int kDT = kD / 8;  // output n-tiles of 8 columns
  const int tile = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.KVH;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // accumulator rows g and g + 8 of the warp
  const int tq = lane % 4;  // accumulator columns 2 tq, 2 tq + 1
  const int off = a.Skv - a.Sq;
  const int q0 = tile * kBQ;
  const int nq = min(kBQ, a.Sq - q0);
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq_b + h * a.sq_h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk_b + kvh * a.sk_h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv_b + kvh * a.sv_h;

  extern __shared__ float smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // (kBQ, kLd)
  bf16* k_s = q_s + kBQ * kLd;                 // (kBK, kLd)
  bf16* v_s = k_s + kBK * kLd;                 // (kBK, kLd)
  float* vsum = reinterpret_cast<float*>(v_s + kBK * kLd);  // (kD,)

  const int hi = a.causal ? min(a.Skv, q0 + nq + off) : a.Skv;
  const int lo = a.window ? max(0, q0 + off - a.window + 1) : 0;

  stage_async<kD>(q_s, qb, a.sq_s, q0, nq);
  if (lo < hi) stage_async<kD>(k_s, kb, a.sk_s, lo, min(kBK, hi - lo));
  cp_async_commit();

  float o[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  // ldmatrix row addresses: matrix lane / 8, row lane % 8 of it
  const int mi = lane / 8;
  const int mr = lane % 8;
  const bf16* q_frag = q_s + (warp * 16 + mr + (mi & 1) * 8) * kLd + (mi >> 1) * 8;
  const bf16* k_frag = k_s + (mr + (mi >> 1) * 8) * kLd + (mi & 1) * 8;
  const bf16* v_frag = v_s + (mr + (mi & 1) * 8) * kLd + (mi >> 1) * 8;

  for (int base = lo; base < hi; base += kBK) {
    const int n = min(kBK, hi - base);
    cp_async_wait_all();
    __syncthreads();  // K(base) landed; every warp is done with V
    stage_async<kD>(v_s, vb, a.sv_s, base, n);
    cp_async_commit();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      unsigned qa[4];
      ldsm_x4(qa, q_frag + ks * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned kr[4];
        ldsm_x4(kr, k_frag + np * 16 * kLd + ks * 16);
        mma_bf16(s[2 * np], qa, kr[0], kr[1]);
        mma_bf16(s[2 * np + 1], qa, kr[2], kr[3]);
      }
    }

    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + warp * 16 + g + r * 8 + off;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + 2 * tq + e;
          const int kpos = base + col;
          float x = s[j][2 * r + e] * a.scale;
          if (a.softcap != 0.f) x = a.softcap * tanhf(x / a.softcap);
          bool ok = col < n;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window) ok = ok && qpos - kpos < a.window;
          s[j][2 * r + e] = ok ? x : kNegInf;
          mx = fmaxf(mx, s[j][2 * r + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // keys past the tile's end (zero-filled) never count
          const float p = j * 8 + 2 * tq + e < n
                              ? __expf(s[j][2 * r + e] - m_new) : 0.f;
          s[j][2 * r + e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(~0u, sum, 1);
      sum += __shfl_xor_sync(~0u, sum, 2);
      alpha[r] = __expf(m[r] - m_new);
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kDT; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    cp_async_wait_all();
    __syncthreads();  // V(base) landed; every warp is done with K
    if (base + kBK < hi) {
      stage_async<kD>(k_s, kb, a.sk_s, base + kBK, min(kBK, hi - base - kBK));
      cp_async_commit();
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // keys kk*16 .. kk*16+15
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        unsigned vr[4];
        ldsm_x4_trans(vr, v_frag + kk * 16 * kLd + dp * 16);
        mma_bf16(o[2 * dp], pa, vr[0], vr[1]);
        mma_bf16(o[2 * dp + 1], pa, vr[2], vr[3]);
      }
    }
  }
  cp_async_wait_all();

  // rows with no visible key (causal, qpos < 0): the mean of v over all
  // Skv keys, as the oracle's uniform softmax gives
  if (a.causal && q0 + off < 0) {
    for (int d = tid; d < kD; d += kMmaThreads) {
      float sum = 0.f;
      for (int t = 0; t < a.Skv; ++t) sum += __bfloat162float(vb[t * a.sv_s + d]);
      vsum[d] = sum;
    }
    __syncthreads();
  }
  const float p_empty = __bfloat162float(__float2bfloat16(1.f / a.Skv));
  bf16* ob = static_cast<bf16*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + r * 8;
    if (row >= nq) continue;
    const bool empty = a.causal && q0 + row + off < 0;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = ob + (((size_t)b * a.Sq + q0 + row) * a.H + h) * kD;
#pragma unroll
    for (int i = 0; i < kDT; ++i) {
      const int col = i * 8 + 2 * tq;
      const float x0 = empty ? p_empty * vsum[col] : o[i][2 * r] * inv;
      const float x1 = empty ? p_empty * vsum[col + 1] : o[i][2 * r + 1] * inv;
      *reinterpret_cast<__nv_bfloat162*>(orow + col) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

template <int kD>
cudaError_t launch_mma(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  flash_mma_kernel<kD><<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The tensor-core path where it has an instance for D, else the SIMT one.
cudaError_t launch_bf16(const Args& a, int B, cudaStream_t stream) {
  switch (a.D) {
    case 16: return launch_mma<16>(a, B, stream);
    case 32: return launch_mma<32>(a, B, stream);
    case 64: return launch_mma<64>(a, B, stream);
    case 112: return launch_mma<112>(a, B, stream);
    case 128: return launch_mma<128>(a, B, stream);
    case 256: return launch_mma<256>(a, B, stream);
    default: return launch<__nv_bfloat16>(a, B, stream);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// dtype: 0 = float32, 1 = bfloat16.  q (B, Sq, H, D), k / v (B, Skv, KVH, D)
// through the given strides (elements; the last dimension contiguous, every
// row 16-byte aligned); out (B, Sq, H, D) contiguous.  D is a multiple of 8
// and at most 256.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int Sq, int Skv, int H, int KVH, int D, int causal,
                    int window, float softcap, float scale, long long sq_b,
                    long long sq_s, long long sq_h, long long sk_b,
                    long long sk_s, long long sk_h, long long sv_b,
                    long long sv_s, long long sv_h, int dtype, void* stream) {
  const Args a{q,    k,    v,      out,     Sq,    Skv,  H,    KVH,
               D,    causal, window, softcap, scale, sq_b, sq_s, sq_h,
               sk_b, sk_s, sk_h,   sv_b,    sv_s,  sv_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch_bf16(a, B, s);
  if (dtype == 0) return (int)launch<float>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
