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
// dtype and the final state (B, H, P, N) in float32.  The TPU kernel's
// arithmetic is float32 (preferred_element_type=f32); so is the SIMT
// kernel's, and the tensor-core kernel keeps its f32 operands to about
// 2**-16 (below).  The exponent
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
// Two kernels, chosen by kernels/ssd.py::path from the inputs alone.
//
// What bounds the function: bytes.  At zamba2-7b's layer (S 4096, H 112,
// P = N = 64, bf16, B 2) it must move about 242 MB (x and y, dt, B, C, the
// f32 state): 0.072 ms at 3.35 TB/s.  Its fewest flops (the causal half of
// each chunk, chip_smoke.py :: k4_bound) are about 16 GFLOP: 0.24 ms on
// the f32 CUDA cores, 0.016 ms (0.032 with each f32 operand counted twice)
// at the 989 TFLOP/s bf16 tensor-core rate.  So on CUDA cores the products
// bound it; on tensor cores, bytes.
//
// ssd_kernel, the SIMT kernel (f32 inputs, and every shape the tensor-core
// kernel does not take): one CTA per (batch row, block of bh heads, bh = 1
// or 2) walks all the chunks in order, one group of 256 threads per head,
// each head's state in shared memory; C B^T of a chunk is computed once per
// CTA and shared by its heads; every product is a register-tiled (4 x 4 per
// thread) float32 loop over shared memory.  Exact f32, as the reference.
//
// ssd_mma_kernel, the tensor-core kernel (bf16 x, B, C with P and N
// multiples of 8 up to 64, 16-byte aligned rows):
// - The sequence is split into segments with a state-passing step, the
//   chunked SSD's own decomposition, so B 1 fills the card too.  With
//   cps = ceil(chunks / n_seg) chunks a segment: (1) every segment but the
//   last runs the state update alone from a zero state, giving its state
//   dS_k and its total log-decay L_k (ssd_mma_kernel<false>, one CTA per
//   segment); (2) the start state of a segment is h run through the
//   segments before it in order, h = exp(L_k) h + dS_k from h0 (or 0),
//   which (3) each segment's CTA computes in its prologue from the scratch
//   before it runs the full chunked scan from there and writes y
//   (ssd_mma_kernel<true>); the last segment writes h.
//   kernels/ssd.py::plan_segments takes as many segments as pass 3's CTAs
//   fit in one wave of the card (the CTAs an SM holds, from the occupancy
//   API through ssd_mma_ctas_per_sm, times the SMs): at zamba2-7b's layer
//   on a 132-SM H100 (two CTAs an SM), 1 segment (no pass 1) at B 2; 2
//   segments of 32 chunks at B 1.  Scratch: (n_seg - 1) B H (P N + 1) f32.
// - Warp roles: one CTA per (head, batch row, segment).  In pass
//   3, eight warps: warps 0-3 compute y for 16 rows of t each from the
//   chunk's start state, while warps 4-7 each advance 16 rows of p of the
//   state to the chunk's end in registers and publish it, as bf16 high and
//   low parts, in the other of two h buffers; the two roles run their own
//   loops and meet once a chunk at a barrier.sync that does not need one
//   program counter.  Pass 1 runs the four state warps alone.
// - Products on the tensor cores with mma.sync m16n8k16 (bf16 operands,
//   f32 accumulation): C B^T, G x, C h^T and (w x)^T B per chunk, operands
//   by ldmatrix (.trans where shared memory holds the other major).
//   mma.sync and not wgmma: each product is a 64 x 64 x 64 tile per head,
//   the G and w x operands are built in registers (the C B^T accumulator's
//   layout is an A fragment's), and a y warp's 16 rows of t bound its
//   causal work (it takes the s-tiles up to its diagonal only); a 64-row
//   wgmma tile would put a whole warpgroup on each product, with its B
//   operand and, for a register A, its layout fixed, and leave no warps to
//   overlap the state update with y.
// - Precision: C, B and x are bf16 inputs, exact as bf16 operands, so C B^T
//   is exact up to f32 accumulation.  The three f32 operands, G = (C B^T)
//   exp(l_t - l_s) dt_s, w_s x_s with w_s = exp(lT - l_s) dt_s, and the
//   state h in C h^T, are each split into a bf16 high part and a bf16 low
//   part (the f32 value minus the high part) and multiplied twice, which
//   keeps about 2**-16 of the operand: the f32 state, held to atol 1e-3
//   after 64 chunks, reaches |h| near 18 on zamba2-7b's first layer, where
//   TF32's 2**-11 would be about 9e-3 and a bf16 pair's 2**-16 is about
//   3e-4.  G and w x are built in registers, G
//   from the C B^T accumulator, w x from x's ldmatrix fragment; the state
//   stays f32 in registers, in the accumulator layout of the (w x)^T B
//   product.  The intra-chunk decay stays masked before the exp.  Its exps
//   use the fast __expf (about 2**-21 of the value, far inside the f32
//   state's limit).
// - Loads: x, B and C of chunk c + 1 are copied by 16-byte cp.async (zero
//   fill past S) into the second of two buffers while chunk c computes; dt
//   (any stride) is read a chunk ahead into a register.  Tiles are 64 x 64
//   bf16 with XOR-swizzled 16-byte chunks: 83 KB of shared memory in pass 3
//   (two CTAs an SM, 128 registers a thread at most), 35 KB in pass 1.
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


// ---------------------------------------------------------------------------
// The bf16 tensor-core kernel (see the note at the top).

constexpr int kTile = kQ * 64;    // a (64, 64) bf16 tile, swizzled

// Threads of a CTA: pass 3 runs four warps on y (16 rows of t each) beside
// four on the state (16 rows of p each); pass 1 runs the four state warps.
template <bool kFull>
__host__ __device__ constexpr int mma_threads() {
  return kFull ? 256 : 128;
}

// Tiles in shared memory: x, B, C, h high and h low, twice each (pass 1:
// x and B twice).
template <bool kFull>
__host__ __device__ constexpr int mma_tiles() {
  return kFull ? 10 : 4;
}

template <bool kFull>
__host__ __device__ constexpr size_t mma_smem() {
  return (size_t)mma_tiles<kFull>() * kTile * 2 +
         sizeof(float) * (2 * kQ + mma_threads<kFull>() / 32 * kQ);
}

// Element (row, col) of a tile: rows of 64 bf16 (128 bytes) whose 16-byte
// chunks are XOR-swizzled by the row, so the eight rows an ldmatrix reads
// at one column, and a cp.async row's chunks, fall on distinct banks.
__device__ __forceinline__ int sw(int row, int col) {
  return row * 64 + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

struct MmaArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* dt;
  const float* A;
  const __nv_bfloat16* bm;
  const __nv_bfloat16* cm;
  const float* h0;  // may be null: the state starts at zero
  __nv_bfloat16* y;
  float* h;
  float* ds;  // (n_seg - 1, B, H, P, N): each pass-1 state from zero
  float* L;   // (n_seg - 1, B, H): each pass-1 segment's total log-decay
  int B, S, H, P, N;
  int cps, n_seg;  // chunks a segment, segments
  long long sx_b, sx_s, sx_h;
  long long sdt_b, sdt_s, sdt_h;
  long long sb_b, sb_s;
  long long sc_b, sc_s;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !full (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b, m16n8k16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma(float* d, const unsigned* a, unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x0, x1) as a bf16 pair `hi` and the pair of what it misses, `lo`:
// hi + lo keeps about 2**-16 of each value
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - f.x, x1 - f.y));
}

// One CTA per (head, batch row, segment).  kFull: the whole chunked scan of
// the segment from its start state (pass 3, with pass 2 folded into its
// prologue), writing y and, in the last segment, h; warps 0-3 compute y
// for their rows t from the chunk's start state while warps 4-7 advance the
// state of their rows p to the chunk's end, in registers, and publish it
// in the other of two h buffers.  Else (pass 1) four warps run the state
// update alone from a zero state and write the segment's state and total
// log-decay to scratch.  One block-wide barrier a chunk.
template <bool kFull>
__global__ void __launch_bounds__(mma_threads<kFull>(), 2)
    ssd_mma_kernel(MmaArgs a) {
  constexpr int kThreadsM = mma_threads<kFull>();
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int seg = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool ywarp = kFull && warp < 4;
  const int strip = 16 * (warp & 3);  // rows t (y warps) or p (state warps)
  const int g = lane / 4;             // fragment row (and row + 8)
  const int c2 = 2 * (lane % 4);      // fragment column pair
  const int P = a.P, N = a.N, S = a.S, H = a.H;
  const int nc = (S + kQ - 1) / kQ;
  const int c_begin = seg * a.cps;
  const int c_end = min(nc, c_begin + a.cps);
  const int nk16 = (N + 15) / 16;  // 16-wide steps over n
  const int np16 = (P + 15) / 16;  // 16-wide steps over p
  const int r8 = lane % 8;         // ldmatrix: this lane's row of its matrix
  const int mlo = (lane / 8) % 2;  // ... which of the 8-row halves
  const int mhi = lane / 16;       // ... which of the 8-column halves

  extern __shared__ uint4 msm[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(msm);  // [2] (s,p)
  __nv_bfloat16* bs = xs + 2 * kTile;                           // [2] (s,n)
  __nv_bfloat16* cs = bs + 2 * kTile;                           // [2] (t,n)
  __nv_bfloat16* hh = cs + 2 * kTile;   // [2] (p, n) state, high part
  __nv_bfloat16* hl = hh + 2 * kTile;   // [2] ... low part
  float* dts = reinterpret_cast<float*>(xs + mma_tiles<kFull>() * kTile);
  float* lw = dts + 2 * kQ + warp * kQ;  // this warp's cumsum of dt * A

  for (int i = tid; i < (int)(mma_smem<kFull>() / 16); i += kThreadsM)
    msm[i] = make_uint4(0, 0, 0, 0);  // padding rows and columns stay 0
  __syncthreads();

  const float Ah = a.A[head];
  const __nv_bfloat16* xg = a.x + b * a.sx_b + head * a.sx_h;
  const __nv_bfloat16* bg = a.bm + b * a.sb_b;
  const __nv_bfloat16* cg = a.cm + b * a.sc_b;
  const __nv_bfloat16* dtg = a.dt + b * a.sdt_b + head * a.sdt_h;

  // chunk c's x, B (and C) into buffer `buf`, rows past S zero-filled: a
  // thread per 16-byte chunk of a 64-column row, chunks past P (or N) not
  // copied
  auto load = [&](int c, int buf) {
    const long long t0 = (long long)c * kQ;
    const int rows = min(kQ, S - c * kQ);
#pragma unroll
    for (int i = tid; i < kQ * 8; i += kThreadsM) {
      const int t = i >> 3, k = (i & 7) * 8;
      const bool ok = t < rows;
      const long long row = t0 + (ok ? t : 0);
      if (k < P)
        cp_async16(xs + buf * kTile + sw(t, k), xg + row * a.sx_s + k, ok);
      if (k < N) {
        cp_async16(bs + buf * kTile + sw(t, k), bg + row * a.sb_s + k, ok);
        if (kFull)
          cp_async16(cs + buf * kTile + sw(t, k), cg + row * a.sc_s + k, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto load_dt = [&](int c) {
    const int t = c * kQ + tid;
    return tid < kQ && t < S ? __bfloat162float(dtg[t * a.sdt_s]) : 0.f;
  };

  float dt_next = load_dt(c_begin);
  load(c_begin, 0);
  if (tid < kQ) dts[tid] = dt_next;

  // The start of chunk c for every warp: wait for its copies, meet the
  // other warps (chunk c landed and its start state is published; every
  // warp is done with chunk c - 1's buffers, so they take chunk c + 1 and
  // its state), copy chunk c + 1, and compute this warp's l, the inclusive
  // cumsum of dt * A, two tokens a lane.  The two roles run their own loops
  // and meet at a barrier that does not need one program counter.
  auto begin_chunk = [&](int c, int buf) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("barrier.sync 0;\n" ::: "memory");
    if (c + 1 < c_end) {  // one chunk ahead
      load(c + 1, buf ^ 1);
      dt_next = load_dt(c + 1);
    }
    const float* DT = dts + buf * kQ;
    const float v0 = DT[2 * lane] * Ah, v1 = DT[2 * lane + 1] * Ah;
    float sum = v0 + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, sum, o);
      if (lane >= o) sum += u;
    }
    const float before = sum - (v0 + v1);
    lw[2 * lane] = before + v0;
    lw[2 * lane + 1] = before + v0 + v1;
    __syncwarp();
  };
  auto end_chunk = [&](int c, int buf) {
    if (c + 1 < c_end && tid < kQ) dts[(buf ^ 1) * kQ + tid] = dt_next;
  };

  if (ywarp) {  // y for rows t in [strip, strip + 16)
    const int ta = strip + g, tb = ta + 8;
    for (int c = c_begin; c < c_end; ++c) {
      const int buf = (c - c_begin) & 1;  // data and h buffers of chunk c
      begin_chunk(c, buf);
      const __nv_bfloat16* X = xs + buf * kTile;
      const __nv_bfloat16* Bt = bs + buf * kTile;
      const __nv_bfloat16* Ct = cs + buf * kTile;
      const __nv_bfloat16* Hh = hh + buf * kTile;
      const __nv_bfloat16* Hl = hl + buf * kTile;
      const float* DT = dts + buf * kQ;
      const int rows = min(kQ, S - c * kQ);
      // C rows t as the A fragment of the 16 n at kk
      auto c_frag = [&](unsigned* f, int kk) {
        ldsm_x4(f, Ct + sw(strip + r8 + 8 * mlo, 16 * kk + 8 * mhi));
      };
      float acc[8][4] = {};
      // inter-chunk: C h^T (h high and low), then rows scaled by exp(l_t)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= nk16) continue;
        unsigned ac[4];
        c_frag(ac, kk);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp >= np16) continue;
          const int off = sw(16 * jp + r8 + 8 * mhi, 16 * kk + 8 * mlo);
          unsigned bh[4], bl[4];
          ldsm_x4(bh, Hh + off);
          ldsm_x4(bl, Hl + off);
          mma(acc[2 * jp], ac, bh[0], bh[1]);
          mma(acc[2 * jp + 1], ac, bh[2], bh[3]);
          mma(acc[2 * jp], ac, bl[0], bl[1]);
          mma(acc[2 * jp + 1], ac, bl[2], bl[3]);
        }
      }
      const float la = lw[ta], lb = lw[tb];
      const float ea = __expf(la), eb = __expf(lb);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= ea;
        acc[j][1] *= ea;
        acc[j][2] *= eb;
        acc[j][3] *= eb;
      }
      // intra-chunk, 16 tokens s a step up to the diagonal (s < strip +
      // 16): the step's C B^T tiles, then G = (C B^T) exp(l_t - l_s) dt_s
      // masked to s <= t before the exp, split into high and low A
      // fragments, then G x
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk > strip) continue;
        float cb[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks >= nk16) continue;
          unsigned ac[4], bb[4];
          c_frag(ac, ks);
          ldsm_x4(bb, Bt + sw(16 * kk + r8 + 8 * mhi, 16 * ks + 8 * mlo));
          mma(cb[0], ac, bb[0], bb[1]);
          mma(cb[1], ac, bb[2], bb[3]);
        }
        unsigned gh[4], gl[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int s0 = 16 * kk + 8 * half + c2;
          const float l0 = lw[s0], l1 = lw[s0 + 1];
          const float d0 = DT[s0], d1 = DT[s0 + 1];
          split2(s0 <= ta ? cb[half][0] * __expf(la - l0) * d0 : 0.f,
                 s0 + 1 <= ta ? cb[half][1] * __expf(la - l1) * d1 : 0.f,
                 gh[2 * half], gl[2 * half]);
          split2(s0 <= tb ? cb[half][2] * __expf(lb - l0) * d0 : 0.f,
                 s0 + 1 <= tb ? cb[half][3] * __expf(lb - l1) * d1 : 0.f,
                 gh[2 * half + 1], gl[2 * half + 1]);
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp >= np16) continue;
          unsigned xb[4];
          ldsm_x4_t(xb, X + sw(16 * kk + r8 + 8 * mlo, 16 * jp + 8 * mhi));
          mma(acc[2 * jp], gh, xb[0], xb[1]);
          mma(acc[2 * jp + 1], gh, xb[2], xb[3]);
          mma(acc[2 * jp], gl, xb[0], xb[1]);
          mma(acc[2 * jp + 1], gl, xb[2], xb[3]);
        }
      }
      const long long row0 = (long long)b * S + (long long)c * kQ;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + c2;
        if (p >= P) continue;
        if (ta < rows)
          *reinterpret_cast<__nv_bfloat162*>(
              a.y + ((row0 + ta) * H + head) * P + p) =
              __floats2bfloat162_rn(acc[j][0], acc[j][1]);
        if (tb < rows)
          *reinterpret_cast<__nv_bfloat162*>(
              a.y + ((row0 + tb) * H + head) * P + p) =
              __floats2bfloat162_rn(acc[j][2], acc[j][3]);
      }
      end_chunk(c, buf);
    }
    return;
  }

  // A state warp: its rows p in [strip, strip + 16), in the layout of an
  // mma accumulator: hr[j][e] is h[strip + g + 8 (e / 2)][8 j + c2 + e % 2]
  const size_t pn = (size_t)P * N;
  const bool prows = strip < P;
  float hr[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = strip + g + 8 * (e / 2), n = 8 * j + c2 + e % 2;
      float v = 0.f;
      if (kFull && p < P && n < N) {
        const size_t i = p * N + n;
        if (a.h0) v = a.h0[((size_t)b * H + head) * pn + i];
        for (int k = 0; k < seg; ++k) {  // pass 2: the segments before
          // this one, in order
          const size_t r = ((size_t)k * a.B + b) * H + head;
          v = __expf(a.L[r]) * v + a.ds[r * pn + i];
        }
      }
      hr[j][e] = v;
    }
  // h's bf16 high and low parts, the B operand of C h^T, into buffer hb
  auto store_h = [&](int hb) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        if (j >= 2 * nk16) continue;
        const int i = hb * kTile + sw(strip + g + 8 * (e / 2), 8 * j + c2);
        unsigned hi, lo;
        split2(hr[j][e], hr[j][e + 1], hi, lo);
        *reinterpret_cast<unsigned*>(hh + i) = hi;
        *reinterpret_cast<unsigned*>(hl + i) = lo;
      }
  };
  if (kFull && prows) store_h(0);

  float l_total = 0.f;
  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    begin_chunk(c, buf);
    const float lT = lw[kQ - 1];
    l_total += lT;
    if (prows) {  // h = exp(lT) h + (w x)^T B
      const __nv_bfloat16* X = xs + buf * kTile;
      const __nv_bfloat16* Bt = bs + buf * kTile;
      const float* DT = dts + buf * kQ;
      const float d = __expf(lT);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hr[j][e] *= d;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 tokens s a step
        // x^T rows p as an A fragment, each column s weighted by w_s =
        // exp(lT - l_s) dt_s in f32 and split into high and low parts
        unsigned xa[4], wh[4], wl[4];
        ldsm_x4_t(xa, X + sw(16 * kk + r8 + 8 * mhi, strip + 8 * mlo));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int s0 = 16 * kk + 8 * half + c2;
          const float w0 = __expf(lT - lw[s0]) * DT[s0];
          const float w1 = __expf(lT - lw[s0 + 1]) * DT[s0 + 1];
#pragma unroll
          for (int r = 0; r < 2; ++r) {  // rows p and p + 8
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&xa[2 * half + r]));
            split2(w0 * xv.x, w1 * xv.y, wh[2 * half + r], wl[2 * half + r]);
          }
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp >= nk16) continue;
          unsigned bb[4];
          ldsm_x4_t(bb, Bt + sw(16 * kk + r8 + 8 * mlo, 16 * jp + 8 * mhi));
          mma(hr[2 * jp], wh, bb[0], bb[1]);
          mma(hr[2 * jp + 1], wh, bb[2], bb[3]);
          mma(hr[2 * jp], wl, bb[0], bb[1]);
          mma(hr[2 * jp + 1], wl, bb[2], bb[3]);
        }
      }
      if (kFull) store_h(buf ^ 1);  // chunk c + 1's start state
    }
    end_chunk(c, buf);
  }

  // the end state: h (last segment) or this segment's scratch (pass 1)
  const size_t r = ((size_t)seg * a.B + b) * H + head;
  if (!kFull && tid == 0) a.L[r] = l_total;
  if (kFull && seg != a.n_seg - 1) return;
  float* out = kFull ? a.h + ((size_t)b * H + head) * pn : a.ds + r * pn;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = strip + g + 8 * (e / 2), n = 8 * j + c2 + e % 2;
      if (p < P && n < N) out[p * N + n] = hr[j][e];
    }
}

// Raise both tensor-core kernels' dynamic shared memory caps, once per
// device.
cudaError_t configure_mma() {
  constexpr int kMaxDevices = 64;
  static int configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && configured[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(ssd_mma_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)mma_smem<false>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_mma_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)mma_smem<true>());
  if (err == cudaSuccess && dev < kMaxDevices) configured[dev] = 1;
  return err;
}

cudaError_t launch_mma(const MmaArgs& a, cudaStream_t stream) {
  cudaError_t err = configure_mma();
  if (err != cudaSuccess) return err;
  if (a.n_seg > 1) {
    ssd_mma_kernel<false><<<dim3(a.H, a.B, a.n_seg - 1),
                            mma_threads<false>(), mma_smem<false>(),
                            stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ssd_mma_kernel<true><<<dim3(a.H, a.B, a.n_seg), mma_threads<true>(),
                         mma_smem<true>(), stream>>>(a);
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

// The bf16 tensor-core scan on `stream` (returns cudaGetLastError(), 0 =
// ok): x, Bm, Cm with a contiguous last dimension and 16-byte aligned rows,
// P and N multiples of 8 up to 64; dt through any strides; h0 (may be null)
// and h contiguous f32 (B, H, P, N); y contiguous (B, S, H, P).  The chunks
// are cut into n_seg segments of ceil(chunks / n_seg) chunks, n_seg being
// the count that cut gives; scratch holds (n_seg - 1) B H (P N + 1) f32.
int ssd_scan_mma(const void* x, const void* dt, const void* A,
                 const void* bm, const void* cm, const void* h0, void* y,
                 void* h, void* scratch, int B, int S, int H, int P, int N,
                 int n_seg, long long sx_b, long long sx_s,
                 long long sx_h, long long sdt_b, long long sdt_s,
                 long long sdt_h, long long sb_b, long long sb_s,
                 long long sc_b, long long sc_s, void* stream) {
  const int nc = (S + kQ - 1) / kQ;
  if (B < 1 || B > 65535 || S < 1 || H < 1 || P % 8 || N % 8 || P < 8 ||
      N < 8 || P > kMaxDim || N > kMaxDim || n_seg < 1 || n_seg > nc)
    return (int)cudaErrorInvalidValue;
  const int cps = (nc + n_seg - 1) / n_seg;
  if ((nc + cps - 1) / cps != n_seg) return (int)cudaErrorInvalidValue;
  float* ds = static_cast<float*>(scratch);
  MmaArgs a{static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(dt),
            static_cast<const float*>(A),
            static_cast<const __nv_bfloat16*>(bm),
            static_cast<const __nv_bfloat16*>(cm),
            static_cast<const float*>(h0),
            static_cast<__nv_bfloat16*>(y),
            static_cast<float*>(h),
            ds,
            ds + (size_t)(n_seg - 1) * B * H * P * N,
            B, S, H, P, N, cps, n_seg,
            sx_b, sx_s, sx_h, sdt_b, sdt_s, sdt_h, sb_b, sb_s, sc_b, sc_s};
  return (int)launch_mma(a, static_cast<cudaStream_t>(stream));
}

// The CTAs of the tensor-core scan's last pass one SM of the current device
// holds at once, by the occupancy API at its block size and shared memory
// (0 = ok).  kernels/ssd.py::plan_segments fills one wave with them.
int ssd_mma_ctas_per_sm(int* ctas) {
  cudaError_t err = configure_mma();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, ssd_mma_kernel<true>, mma_threads<true>(), mma_smem<true>());
}

}  // extern "C"
