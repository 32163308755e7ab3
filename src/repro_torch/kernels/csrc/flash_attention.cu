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
// The design: three kernels, each one CTA per (query tile, head, batch
// row), the tiles that see the most keys launched first, each walking KV
// tiles only from the first key the tile's window reaches to the causal
// diagonal of its last row; the ragged ends of Sq and Skv are masked by
// position, with no padding.
// - bf16 at D 64, 112 and 128 (smollm, granite and musicgen; zamba2;
//   internlm2): a warp-specialised wgmma kernel fed by TMA through a ring
//   of KV stages, described at flash_wgmma_kernel below.
// - bf16 at D 16, 32 and 256: mma.sync tensor-core products, described at
//   flash_mma_kernel below (the kernel D 64, 112 and 128 took before the
//   wgmma kernel; flash_attention_mma still reaches it there, for timing).
// - f32, and bf16 at any other D: a SIMT kernel of 256 threads.  Both
//   products are register-tiled f32 FMAs on CUDA cores: each thread holds a
//   4 x 4 tile of the scores and a 4-row by 4-column tile of each
//   64-column chunk of the output (up to 4 chunks, D <= 256), and the row
//   statistics reduce over the 16 threads of a row with shuffles.  Shared
//   memory is 4 (3 kBQ D + kBQ kBK + D) bytes, 214 KB at D 256 (under the
//   227 KB a block may have) and 103 KB at D 112.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (kernels/build.py); kernels/flash_attention.py is its wrapper.

#include <cuda.h>
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
// Instances at D 16, 32, 64, 112, 128 and 256 (every head_dim of the repo's
// configs); flash_attention routes bf16 at D 16, 32 and 256 here: one CTA
// of four warps per (query tile of kBQ rows, head, batch row), each warp
// owning 16 query rows.  q, K and V tiles are
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


// ------------------------------------------------- bf16 wgmma path ----
//
// For bf16 at D 64, 112 and 128: a warp-specialised kernel built on what
// Hopper added.  One CTA of three warpgroups per (query tile of kWgBQ = 128
// rows, head, batch row), the tiles that see the most keys launched first.
// - Warpgroup 0, the producer, gives up registers (setmaxnreg 24); one of
//   its threads starts the TMA loads: the Q tile once, then each KV tile of
//   kWgBK = 128 keys into a ring of kStages stages (4 at D 64, 3 at D 112
//   and 128: about 145 KiB and 226 KiB of shared memory), K and V each with
//   a full and an empty mbarrier, so loads run ahead of the products.
// - Warpgroups 1 and 2, the consumers, take 240 registers each and 64 query
//   rows each.  Per KV tile: S = Q K^T by wgmma m64n128k16 from shared
//   memory (Q and K K-major); the online softmax on S in registers, in base
//   2 with the scale folded in (one FFMA and one ex2 a score on a tile that
//   needs no mask), row statistics over the four threads of a row by
//   shuffles; p rounded to bf16 straight into wgmma's A-operand registers;
//   O += P V by wgmma with A from registers and V from shared memory as an
//   MN-major B (the transpose bit); each stage released on its empty
//   barrier as soon as its product is in.  Within a consumer, S of tile j
//   goes to the tensor cores with P V of tile j - 1, and the softmax of tile j
//   runs while P V of tile j - 1 is still on the tensor cores; the two
//   consumers run on their own, so one's softmax also overlaps the other's
//   products.  (Making them take turns with named barriers, as FlashAttention
//   3 does, did not move the time beyond run-to-run noise on this card, so
//   it is not done.)
// - Tiles come from the 4-D tensor maps (D, S, heads, B) that the wrapper
//   derives from the tensors' strides, 64 columns (128 bytes, one 128-byte
//   swizzle span) per box: two boxes per row at D 112 and 128.  TMA
//   zero-fills rows past Sq or Skv and, at D 112, columns 112..127, so Q K^T
//   walks 7 k-steps of 16 and P V runs at N 128 and drops 16 zero columns at
//   the store (N 112 would save 1/8 of the P V products; N 128 keeps every
//   B operand whole 128-byte swizzle atoms).
// - A consumer masks only the tiles that straddle its rows' causal
//   diagonal, window edge or Skv, and skips tiles that none of its rows can
//   see (still waiting and releasing them, so the ring stays in step).
//   Rows with no visible key take the oracle's mean of v, as above.
// D 256 stays on mma.sync: a 64 x 256 f32 output accumulator alone is 128
// registers a consumer thread, beside the 64 of the scores.  D 16 and 32
// (reduced configs only) stay there too, and f32 on the SIMT kernel.

constexpr int kWgBQ = 128;       // query rows per CTA, 64 per consumer
constexpr int kWgBK = 128;       // keys per KV tile
constexpr int kWgThreads = 384;  // producer + two consumer warpgroups
constexpr int kBoxCols = 64;     // bf16 columns per TMA box: 128 bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf2 = kNegInf * kLog2e;  // NEG_INF in base-2 units

template <int kD>
struct WgCfg {
  static constexpr int kCB = (kD + kBoxCols - 1) / kBoxCols;  // column boxes
  static constexpr int kDp = kBoxCols * kCB;  // D padded to whole boxes
  static constexpr int kStages = kCB == 1 ? 4 : 3;
  static constexpr int kQBlock = kWgBQ * 128;  // bytes of one Q column box
  static constexpr int kKVBlock = kWgBK * 128;  // of one K or V column box
  static constexpr int kQBytes = kQBlock * kCB;
  static constexpr int kKVBytes = kKVBlock * kCB;  // one K or V tile
  static constexpr size_t kSmem = 1024 /* alignment slack */ + kQBytes +
                                  2 * (size_t)kStages * kKVBytes +
                                  8 * (1 + 4 * kStages) + 4 * kDp;
};

// wgmma shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups of this warpgroup's wgmma are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of r across the asynchronous
// wgmma that reads or writes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(unsigned (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one 64 x 128 score tile of a consumer warpgroup,
// in registers and in base 2.  s[i] is row g + 8 ((i % 4) / 2) of the
// thread's warp and key key0 + 8 (i / 4) + 2 tq + i % 2; the four threads
// tq of a row reduce its max by shuffles.  The mask and the softcap are
// template arguments, so a tile that needs neither runs neither.
struct Softmax {
  const Args& a;
  int qpos0;  // the position of the thread's row g; row g + 8 is + 8
  int tq;

  template <bool kMask, bool kCap>
  __device__ __forceinline__ void run(float (&s)[64], float (&m)[2],
                                      float (&l)[2], float (&alpha)[2],
                                      int key0) const {
    const float c = a.scale * kLog2e;
    const float cap_in = kCap ? a.scale / a.softcap : 0.f;
    const float cap_out = a.softcap * kLog2e;
    // each row's max and sum are kept in four partials (score i goes to
    // partial (i % 2) + 2 ((i / 4) % 2)), so no chain of dependent
    // instructions is longer than 8
    float mx[2][4], sum[2][4];
    if (!kMask && !kCap) {
      // p = 2^(s c - m) in one FFMA per score: the row max of s c is c
      // times the row max of s (c > 0)
#pragma unroll
      for (int i = 0; i < 8; ++i) mx[(i % 4) / 2][i % 2 + 2 * (i / 4)] = s[i];
#pragma unroll
      for (int i = 8; i < 64; ++i) {
        float& x = mx[(i % 4) / 2][i % 2 + 2 * ((i / 4) % 2)];
        x = fmaxf(x, s[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mx[r][0] = c * fmaxf(fmaxf(mx[r][0], mx[r][1]),
                             fmaxf(mx[r][2], mx[r][3]));
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i % 4) / 2;
        float x = kCap ? cap_out * tanhf(s[i] * cap_in) : s[i] * c;
        if (kMask) {
          const int kpos = key0 + (i / 4) * 8 + 2 * tq + i % 2;
          const int qpos = qpos0 + 8 * r;
          bool ok = kpos < a.Skv;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window) ok = ok && qpos - kpos < a.window;
          x = ok ? x : kNegInf2;
        }
        s[i] = x;
        float& y = mx[r][i % 2 + 2 * ((i / 4) % 2)];
        y = i < 8 ? x : fmaxf(y, x);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mx[r][0] = fmaxf(fmaxf(mx[r][0], mx[r][1]),
                         fmaxf(mx[r][2], mx[r][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = fmaxf(m[r], mx[r][0]);
      x = fmaxf(x, __shfl_xor_sync(~0u, x, 1));
      x = fmaxf(x, __shfl_xor_sync(~0u, x, 2));
      alpha[r] = ex2(m[r] - x);
      m[r] = x;
#pragma unroll
      for (int k = 0; k < 4; ++k) sum[r][k] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i % 4) / 2;
      float p = !kMask && !kCap ? ex2(fmaf(s[i], c, -m[r])) : ex2(s[i] - m[r]);
      // keys past Skv (zero-filled) never count
      if (kMask) p = key0 + (i / 4) * 8 + 2 * tq + i % 2 < a.Skv ? p : 0.f;
      sum[r][i % 2 + 2 * ((i / 4) % 2)] += p;
      s[i] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = l[r] * alpha[r] + ((sum[r][0] + sum[r][1]) +
                                (sum[r][2] + sum[r][3]));
  }

  // a tile whose keys every row of the warpgroup (rows r0 .. r0 + nw - 1)
  // sees runs unmasked
  __device__ __forceinline__ void tile(float (&s)[64], float (&m)[2],
                                       float (&l)[2], float (&alpha)[2],
                                       int key0, int nw, int r0) const {
    const int off = a.Skv - a.Sq;
    const bool mask = (a.causal && key0 + kWgBK - 1 > r0 + off) ||
                      (a.window && r0 + nw - 1 + off - key0 >= a.window) ||
                      key0 + kWgBK > a.Skv;
    if (a.softcap != 0.f) {
      if (mask) run<true, true>(s, m, l, alpha, key0);
      else run<false, true>(s, m, l, alpha, key0);
    } else {
      if (mask) run<true, false>(s, m, l, alpha, key0);
      else run<false, false>(s, m, l, alpha, key0);
    }
  }
};

// d (64 x 128, f32) = A (64 x 16) * B (16 x 128) + (scale_d ? d : 0),
// A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const unsigned (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const unsigned (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int kN>
__device__ __forceinline__ void wgmma_pv(float (&o)[kN / 2],
                                         const unsigned (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const unsigned (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const unsigned (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

template <int kD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, Args a) {
  using C = WgCfg<kD>;
  constexpr int kS = C::kStages;
  extern __shared__ uint8_t wg_smem[];
  // 1024-byte aligned: the 128-byte swizzle repeats every 8 rows of 128 B
  uint8_t* q_s = wg_smem + ((1024 - (smem_addr(wg_smem) & 1023)) & 1023);
  uint8_t* k_s = q_s + C::kQBytes;    // kS tiles of kCB boxes (128 x 128 B)
  uint8_t* v_s = k_s + kS * C::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kS * C::kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kS;
  uint64_t* k_empty = v_full + kS;
  uint64_t* v_empty = k_empty + kS;
  float* vsum = reinterpret_cast<float*>(v_empty + kS);  // (kDp,)

  const int tile = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const int off = a.Skv - a.Sq;  // qpos = i + off
  const int q0 = tile * kWgBQ;
  const int nq = min(kWgBQ, a.Sq - q0);
  const int hi = a.causal ? min(a.Skv, q0 + nq + off) : a.Skv;
  const int lo = a.window ? max(0, q0 + off - a.window + 1) : 0;
  const int n_kv = hi > lo ? (hi - lo + kWgBK - 1) / kWgBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 256);  // every consumer thread releases
      mbar_init(&v_empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int cb = 0; cb < C::kCB; ++cb)
        tma_load_4d(q_s + cb * C::kQBlock, &tm_q, q_full, cb * kBoxCols, q0,
                    h, b);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % kS;
        const int ph = (j / kS) & 1;
        const int key0 = lo + j * kWgBK;
        mbar_wait(&k_empty[st], ph ^ 1);  // passes at once on the first lap
        mbar_expect_tx(&k_full[st], C::kKVBytes);
        for (int cb = 0; cb < C::kCB; ++cb)
          tma_load_4d(k_s + st * C::kKVBytes + cb * C::kKVBlock, &tm_k,
                      &k_full[st], cb * kBoxCols, key0, kvh, b);
        mbar_wait(&v_empty[st], ph ^ 1);
        mbar_expect_tx(&v_full[st], C::kKVBytes);
        for (int cb = 0; cb < C::kCB; ++cb)
          tma_load_4d(v_s + st * C::kKVBytes + cb * C::kKVBlock, &tm_v,
                      &v_full[st], cb * kBoxCols, key0, kvh, b);
      }
    }
  } else {
    // ---- consumers: warpgroup w takes rows 64 w .. 64 w + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;   // accumulator rows g and g + 8 of the warp
    const int tq = lane % 4;  // accumulator columns 2 tq, 2 tq + 1 of 8
    const int r0 = q0 + 64 * w;
    const int nw = max(0, min(64, a.Sq - r0));
    // the keys this warpgroup's rows can see
    const int hi_w = a.causal ? min(a.Skv, r0 + nw + off) : a.Skv;
    const int lo_w = a.window ? max(0, r0 + off - a.window + 1) : 0;
    const int qpos0 = r0 + warp * 16 + g + off;  // row g; row g + 8 is + 8
    const Softmax sm{a, qpos0, tq};

    float o[C::kDp / 2];
#pragma unroll
    for (int i = 0; i < C::kDp / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf2, kNegInf2};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    float s[64];              // scores, then probabilities, of a tile
    unsigned pa[kWgBK / 16][4];  // probabilities as wgmma A fragments
    const uint32_t q_addr = smem_addr(q_s) + w * 64 * 128;
    mbar_wait(q_full, 0);

    // tiles j_lo .. j_hi - 1 hold a key some row of this warpgroup sees;
    // the others are only waited for and released, to keep the ring in step
    int j_lo = 0, j_hi = 0;
    if (nw > 0 && hi_w > lo_w) {
      j_lo = (lo_w - lo) / kWgBK;
      j_hi = min(n_kv, (hi_w - lo + kWgBK - 1) / kWgBK);
    }
    auto qk = [&](int j) {  // start S = Q K_j^T (K_j has landed)
      const uint32_t k_addr = smem_addr(k_s) + (j % kS) * C::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss_n128(
            s,
            gmma_desc(q_addr + (kk / 4) * C::kQBlock + (kk % 4) * 32, 16,
                      1024),
            gmma_desc(k_addr + (kk / 4) * C::kKVBlock + (kk % 4) * 32, 16,
                      1024),
            kk > 0);
      wgmma_commit();
    };
    auto pv = [&](int j) {  // start O += P V_j (V_j has landed)
      const uint32_t v_addr = smem_addr(v_s) + (j % kS) * C::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        wgmma_pv<C::kDp>(o, pa[kk],
                         gmma_desc(v_addr + kk * 16 * 128, C::kKVBlock, 1024));
      wgmma_commit();
    };
    auto k_in = [&](int j) { mbar_wait(&k_full[j % kS], (j / kS) & 1); };
    auto v_in = [&](int j) { mbar_wait(&v_full[j % kS], (j / kS) & 1); };
    auto to_pa = [&]() {
#pragma unroll
      for (int i = 0; i < 64; i += 2)
        pa[i / 8][(i % 8) / 2] = pack_bf16(s[i], s[i + 1]);
    };

    auto pass = [&](int j) {
      k_in(j);
      mbar_arrive(&k_empty[j % kS]);
      v_in(j);
      mbar_arrive(&v_empty[j % kS]);
    };
    for (int j = 0; j < j_lo; ++j) pass(j);
    if (j_lo < j_hi) {
      float alpha[2];
      k_in(j_lo);
      wgmma_fence();
      qk(j_lo);
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(&k_empty[j_lo % kS]);
      sm.tile(s, m, l, alpha, lo + j_lo * kWgBK, nw, r0);
      to_pa();
      // S of tile j on the tensor cores while P V of tile j - 1 runs, and
      // the softmax of tile j while P V of tile j - 1 finishes
      for (int j = j_lo + 1; j < j_hi; ++j) {
        k_in(j);
        v_in(j - 1);
        fence_regs(o);
        wgmma_fence();
        qk(j);
        pv(j - 1);
        wgmma_wait<1>();  // S of tile j is in
        fence_regs(s);
        mbar_arrive(&k_empty[j % kS]);
        sm.tile(s, m, l, alpha, lo + j * kWgBK, nw, r0);
        wgmma_wait<0>();  // P V of tile j - 1 is in
        fence_regs(o);
        fence_regs(pa);
        mbar_arrive(&v_empty[(j - 1) % kS]);
#pragma unroll
        for (int i = 0; i < C::kDp / 2; ++i) o[i] *= alpha[(i % 4) / 2];
        to_pa();
      }
      v_in(j_hi - 1);
      fence_regs(o);
      wgmma_fence();
      pv(j_hi - 1);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(&v_empty[(j_hi - 1) % kS]);
    }
    for (int j = max(j_hi, j_lo); j < n_kv; ++j) pass(j);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(~0u, l[r], 1);
      l[r] += __shfl_xor_sync(~0u, l[r], 2);
    }
    // rows with no visible key (causal, qpos < 0): the mean of v over all
    // Skv keys, as the oracle's uniform softmax gives
    const __nv_bfloat16* vb =
        static_cast<const __nv_bfloat16*>(a.v) + b * a.sv_b + kvh * a.sv_h;
    if (a.causal && q0 + off < 0) {
      for (int d = threadIdx.x - 128; d < kD; d += 256) {
        float sum = 0.f;
        for (int t = 0; t < a.Skv; ++t)
          sum += __bfloat162float(vb[t * a.sv_s + d]);
        vsum[d] = sum;
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // consumers only
    }
    const float p_empty = __bfloat162float(__float2bfloat16(1.f / a.Skv));
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      if (row >= nw) continue;
      const bool empty = a.causal && qpos0 + 8 * r < 0;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = ob + (((size_t)b * a.Sq + r0 + row) * a.H + h) * kD;
#pragma unroll
      for (int jb = 0; jb < kD / 8; ++jb) {  // drops the padded columns
        const int col = jb * 8 + 2 * tq;
        const float x0 = empty ? p_empty * vsum[col] : o[jb * 4 + 2 * r] * inv;
        const float x1 =
            empty ? p_empty * vsum[col + 1] : o[jb * 4 + 2 * r + 1] * inv;
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// cuTensorMapEncodeTiled lives in libcuda, not in the CUDA runtime this
// library links, so it is looked up through the runtime's entry-point query
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// One bf16 tensor map from the wrapper's nine numbers (kernels/
// flash_attention.py::tma_map): dims (D, S, heads, B) in elements, the byte
// strides of S, heads and B, and the box (columns, rows).  The box must be
// the kernel's: kBoxCols columns and `rows` rows.
cudaError_t encode_map(CUtensorMap* map, const void* ptr,
                       const long long* m, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (m[7] != kBoxCols || m[8] != rows) return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)m[0], (cuuint64_t)m[1],
                              (cuuint64_t)m[2], (cuuint64_t)m[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)m[4], (cuuint64_t)m[5],
                                 (cuuint64_t)m[6]};
  const cuuint32_t box[4] = {(cuuint32_t)m[7], (cuuint32_t)m[8], 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kD>
cudaError_t launch_wgmma(const Args& a, int B, const long long* maps,
                         cudaStream_t stream) {
  if (maps == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tm[3];
  const void* ptrs[3] = {a.q, a.k, a.v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err =
        encode_map(&tm[i], ptrs[i], maps + 9 * i, i == 0 ? kWgBQ : kWgBK);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = WgCfg<kD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kWgBQ - 1) / kWgBQ, a.H, B);
  flash_wgmma_kernel<kD><<<grid, kWgThreads, smem, stream>>>(tm[0], tm[1],
                                                             tm[2], a);
  return cudaGetLastError();
}

// The head_dims each bf16 path takes (every other D: the SIMT kernel).
inline bool wgmma_d(int D) { return D == 64 || D == 112 || D == 128; }
inline bool mma_d(int D) { return D == 16 || D == 32 || D == 256; }

// bf16: the wgmma kernel at D 64, 112 and 128, mma.sync at D 16, 32 and
// 256, else the SIMT kernel.  `maps`: the three tensor maps' numbers (9
// each, q, k, v), which the wgmma kernel needs.
cudaError_t launch_bf16(const Args& a, int B, const long long* maps,
                        cudaStream_t stream) {
  switch (a.D) {
    case 16: return launch_mma<16>(a, B, stream);
    case 32: return launch_mma<32>(a, B, stream);
    case 64: return launch_wgmma<64>(a, B, maps, stream);
    case 112: return launch_wgmma<112>(a, B, maps, stream);
    case 128: return launch_wgmma<128>(a, B, maps, stream);
    case 256: return launch_mma<256>(a, B, stream);
    default: return launch<__nv_bfloat16>(a, B, stream);
  }
}

// The mma.sync kernel at every D it has an instance for.
cudaError_t launch_mma_any(const Args& a, int B, cudaStream_t stream) {
  switch (a.D) {
    case 16: return launch_mma<16>(a, B, stream);
    case 32: return launch_mma<32>(a, B, stream);
    case 64: return launch_mma<64>(a, B, stream);
    case 112: return launch_mma<112>(a, B, stream);
    case 128: return launch_mma<128>(a, B, stream);
    case 256: return launch_mma<256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// dtype: 0 = float32, 1 = bfloat16.  q (B, Sq, H, D), k / v (B, Skv, KVH, D)
// through the given strides (elements; the last dimension contiguous, every
// row 16-byte aligned); out (B, Sq, H, D) contiguous.  D is a multiple of 8
// and at most 256.  maps: for bf16, the tensor maps of q, k and v, nine
// numbers each (kernels/flash_attention.py::tma_map); may be null for f32.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int Sq, int Skv, int H, int KVH, int D, int causal,
                    int window, float softcap, float scale, long long sq_b,
                    long long sq_s, long long sq_h, long long sk_b,
                    long long sk_s, long long sk_h, long long sv_b,
                    long long sv_s, long long sv_h, const long long* maps,
                    int dtype, void* stream) {
  const Args a{q,    k,    v,      out,     Sq,    Skv,  H,    KVH,
               D,    causal, window, softcap, scale, sq_b, sq_s, sq_h,
               sk_b, sk_s, sk_h,   sv_b,    sv_s,  sv_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch_bf16(a, B, maps, s);
  if (dtype == 0) return (int)launch<float>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

// The name of the kernel flash_attention launches at head_dim D and dtype.
const char* flash_attention_kernel(int D, int dtype) {
  if (dtype != 1) return "simt";
  return wgmma_d(D) ? "wgmma" : mma_d(D) ? "mma.sync" : "simt";
}

// The earlier bf16 mma.sync kernel at D 16, 32, 64, 112, 128 or 256, with
// flash_attention's arguments (bf16 only, no maps).  For timing beside the
// wgmma kernel; flash_attention never routes 64, 112 or 128 here.
int flash_attention_mma(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Skv, int H, int KVH,
                        int D, int causal, int window, float softcap,
                        float scale, long long sq_b, long long sq_s,
                        long long sq_h, long long sk_b, long long sk_s,
                        long long sk_h, long long sv_b, long long sv_s,
                        long long sv_h, void* stream) {
  const Args a{q,    k,    v,      out,     Sq,    Skv,  H,    KVH,
               D,    causal, window, softcap, scale, sq_b, sq_s, sq_h,
               sk_b, sk_s, sk_h,   sv_b,    sv_s,  sv_h};
  return (int)launch_mma_any(a, B, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
