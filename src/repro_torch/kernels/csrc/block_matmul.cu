// block_matmul.cu -- y = epilogue(x @ w.T + b) for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/block_matmul.py::_kernel (pallas_call in
// block_matmul(), wrapped by kernels/ops.py::matmul / matmul_nd / mixer_mlp)
// of the JAX package.  It carries every GEMM of a WeatherMixer forecast step.
//
//   x: [M, K], w: [N, K] (row-major, K contiguous), b: [N] f32 or none,
//   y: [M, N] in x's dtype.  The sum over K is kept in f32; the bias is added
//   in f32 and the epilogue (none | gelu, tanh form | silu) runs on the f32
//   value before the one rounding to the output dtype.
//
// Bound: at the shapes of weathermixer-1b (M, N, K all >= 4320) every GEMM
// does 1,900 to 2,500 FLOP per byte it must move (each operand read once,
// y written once), far above the ~295 FLOP/byte at which an H100 stops
// being memory-bound in bf16.  So the kernel is bound by tensor-core FLOPs,
// and what matters is how close the MMA issue rate gets to the card's peak.
//
// Design (simple first, correct on ragged shapes):
//   * bf16: 128x128 output tile per block of 8 warps (each warp 64x32),
//     K in steps of 32 through a 3-stage cp.async ring in shared memory,
//     WMMA 16x16x16 bf16 fragments (mma.sync on the tensor cores) with f32
//     accumulators.  The f32 tile then goes through shared memory once for
//     the bias + activation epilogue and a masked store.
//   * f32: exact f32 FMA on the CUDA cores (no TF32), 128x128 tile, each
//     thread 8x8 outputs; K runs sequentially per output element.
//   * Ragged edges are masked in the kernel: rows past M/N and columns past K
//     are zero-filled in shared memory (cp.async with src-size 0), and the
//     store is masked.  Nothing is padded in device memory.
//   * Global loads use the widest vector the row stride and base pointers
//     allow (16, 8, 4 bytes, or 2 with plain loads): a bf16 row of
//     K = 16380 is 32,760 bytes, not a multiple of 16, so tok_fc1 runs
//     8-byte copies.  The wrapper picks the width; the kernel is templated
//     on it.
//   * Batch invariance: the K order of every output element is fixed by K
//     alone (the same k-tiles in the same order, no split-K), so row r of y
//     does not depend on how many rows share the launch.
//
// Left for later: wgmma and TMA (the only path to the card's full tensor-core
// rate), a warp-specialised producer, a persistent tile scheduler, and
// bank-conflict-free swizzled shared-memory layouts.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

enum { EPI_NONE = 0, EPI_GELU = 1, EPI_SILU = 2 };

__device__ __forceinline__ float apply_epilogue(float v, int epi) {
  if (epi == EPI_GELU) {
    // tanh form, as jax.nn.gelu's default and F.gelu(approximate="tanh")
    const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
    const float kKappa = 0.044715f;
    const float v3 = v * v * v;
    return 0.5f * v * (1.0f + tanhf(kBeta * (v + kKappa * v3)));
  }
  if (epi == EPI_SILU) return v / (1.0f + expf(-v));
  return v;
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// ---------------------------------------------------------------------------
// bf16 operands: tensor cores through WMMA
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int LDS = BK + 8;  // smem row stride in elements: 80 B rows keep
                             // every fragment pointer 32 B aligned
constexpr int LDC = BN + 4;  // epilogue tile stride in floats
constexpr int STAGE_ELEMS = (BM + BN) * LDS;
constexpr size_t SMEM_PIPE = size_t(STAGES) * STAGE_ELEMS * sizeof(bf16);
constexpr size_t SMEM_EPI = size_t(BM) * LDC * sizeof(float);
constexpr size_t SMEM_BF16 = SMEM_PIPE > SMEM_EPI ? SMEM_PIPE : SMEM_EPI;

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? BYTES : 0;  // src-size 0: fill the destination with 0
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(s), "l"(src), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// One [128 rows x BK] tile of a row-major [rows, K] operand into shared
// memory at row stride LDS.  VE = elements per copy; K % VE == 0, so a copy
// is either wholly inside the matrix or wholly outside (zero-filled).
template <int VE>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int rows,
                                          int row0, int k0, int K, int tid) {
  constexpr int CPR = BK / VE;  // copies per tile row
  constexpr int TOTAL = BM * CPR;
  static_assert(BM == BN, "one loader serves both operands");
#pragma unroll
  for (int c = tid; c < TOTAL; c += THREADS) {
    const int r = c / CPR, kc = (c % CPR) * VE;
    const int gr = row0 + r, gk = k0 + kc;
    const bool ok = gr < rows && gk < K;
    const bf16* src = ok ? g + size_t(gr) * K + gk : g;
    bf16* dst = s + r * LDS + kc;
    if constexpr (VE == 1) {
      *dst = ok ? *src : __float2bfloat16(0.0f);
    } else {
      cp_async<VE * 2>(dst, src, ok);
    }
  }
}

template <int VE>
__global__ void __launch_bounds__(THREADS)
bm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ y,
               int M, int N, int K, int epi) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps, each 64 x 32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      bf16* st = smem + s * STAGE_ELEMS;
      load_tile<VE>(st, x, M, m0, s * BK, K, tid);
      load_tile<VE>(st + BM * LDS, w, N, n0, s * BK, K, tid);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // k-tile kt has landed
    __syncthreads();              // ...for every thread; stage kt-1 is free
    const int pf = kt + STAGES - 1;
    if (pf < nk) {
      bf16* st = smem + (pf % STAGES) * STAGE_ELEMS;
      load_tile<VE>(st, x, M, m0, pf * BK, K, tid);
      load_tile<VE>(st + BM * LDS, w, N, n0, pf * BK, K, tid);
    }
    cp_async_commit();

    const bf16* As = smem + (kt % STAGES) * STAGE_ELEMS;
    const bf16* Bs = As + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 64 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)  // w tile [n][k] is B = w.T in col-major
        wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline's shared memory becomes the f32 tile

  float* Cs = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      float v = Cs[r * LDC + c];
      if (bias != nullptr) v += bias[gn];
      store_out(y + size_t(gm) * N + gn, apply_epilogue(v, epi));
    }
  }
}

template <int VE>
cudaError_t launch_bf16(const void* x, const void* w, const void* bias,
                        void* y, int M, int N, int K, int epi,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bm_bf16_kernel<VE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(SMEM_BF16));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bm_bf16_kernel<VE><<<grid, THREADS, SMEM_BF16, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(y), M, N, K, epi);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 operands: exact FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int FBM = 128, FBN = 128, FBK = 8, FTHREADS = 256;
constexpr int FLD = FBM + 4;  // 528 B rows: float4 reads stay aligned

__global__ void __launch_bounds__(FTHREADS)
bm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ y,
              int M, int N, int K, int epi) {
  __shared__ __align__(16) float As[FBK][FLD];  // k-major: As[k][m]
  __shared__ __align__(16) float Bs[FBK][FLD];  // Bs[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;      // 16 x 16 threads, 8 x 8 each
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  const int lr = tid / 2, lk = (tid % 2) * 4;  // loader: row, first k

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
    const int gm = m0 + lr, gn = n0 + lr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + lk + j;
      As[lk + j][lr] = (gm < M && gk < K) ? x[size_t(gm) * K + gk] : 0.0f;
      Bs[lk + j][lr] = (gn < N && gk < K) ? w[size_t(gn) * K + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8 + 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty * 8 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx * 8 + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[gn];
      store_out(y + size_t(gm) * N + gn, apply_epilogue(v, epi));
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (bound with ctypes).  Each returns the cudaError_t of the
// launch; the caller raises on anything but 0.
// ---------------------------------------------------------------------------

extern "C" int block_matmul_bf16(const void* x, const void* w,
                                 const void* bias, void* y, int M, int N,
                                 int K, int epi, int vec_bytes,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch_bf16<8>(x, w, bias, y, M, N, K, epi, s);
    case 8: return launch_bf16<4>(x, w, bias, y, M, N, K, epi, s);
    case 4: return launch_bf16<2>(x, w, bias, y, M, N, K, epi, s);
    case 2: return launch_bf16<1>(x, w, bias, y, M, N, K, epi, s);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" int block_matmul_f32(const void* x, const void* w,
                                const void* bias, void* y, int M, int N,
                                int K, int epi, void* stream) {
  const dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
  bm_f32_kernel<<<grid, FTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), M, N, K, epi);
  return int(cudaGetLastError());
}

extern "C" const char* block_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
