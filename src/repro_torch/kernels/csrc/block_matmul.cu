// block_matmul.cu -- C = epilogue(A @ B.T + b) for Hopper (sm_90a), with
// each operand read in either of its two layouts.
//
// Replaces the TPU kernel kernels/block_matmul.py::_kernel (pallas_call in
// block_matmul(), wrapped by kernels/ops.py::matmul / matmul_nd / mixer_mlp
// and by the custom VJP _matmul_bwd) of the JAX package.  It carries every
// GEMM of a WeatherMixer forecast step and of a training step, forward and
// backward.
//
//   A [M, K] is read from x, stored either [M, K] (K contiguous, x_t = 0)
//   or [K, M] (M contiguous, x_t = 1);
//   B [N, K] is read from w, stored either [N, K] (w_t = 0) or [K, N]
//   (w_t = 1);
//   b: [N] f32 or none; C: [M, N] row-major in the operands' dtype.
//
// The backward GEMMs need the transposed reads: dx = dz @ w reads w [N, K]
// as B = w.T (w_t = 1), and dw = dz.T @ x reads dz [M, N] as A = dz.T
// (x_t = 1) and x [M, K] as B = x.T (w_t = 1).  No operand is transposed in
// device memory: the tile loads run along whichever dimension is contiguous,
// and the WMMA fragments are loaded row_major or col_major to match.
//
// The sum over K is kept in f32; the bias is added in f32 and the epilogue
// (none | gelu, tanh form | silu) runs on the f32 value before the one
// rounding to the output dtype.
//
// Bound: at the shapes of weathermixer-1b (M, N, K all >= 4320) every GEMM
// does 1,900 to 2,500 FLOP per byte it must move (each operand read once,
// C written once), far above the ~295 FLOP/byte at which an H100 stops
// being memory-bound in bf16.  So the kernel is bound by tensor-core FLOPs,
// and what matters is how close the MMA issue rate gets to the card's peak.
//
// Design (simple first, correct on ragged shapes; the tile main loops are
// in gemm_core.cuh, shared with wx.cu, and this file adds the epilogues):
//   * bf16: 128x128 output tile per block of 8 warps (each warp 64x32),
//     K in steps of 32 through a 3-stage cp.async ring in shared memory,
//     WMMA 16x16x16 bf16 fragments (mma.sync on the tensor cores) with f32
//     accumulators.  A K-contiguous operand lands in shared memory as
//     [128 rows][32 k], an M- or N-contiguous one as [32 k][128 rows]; the
//     f32 tile then goes through shared memory once for the bias +
//     activation epilogue and a masked store.
//   * f32: exact f32 FMA on the CUDA cores (no TF32), 128x128 tile, each
//     thread 8x8 outputs; K runs sequentially per output element.  The
//     loaders read along the contiguous dimension of each layout.
//   * Ragged edges are masked in the kernel: rows past M/N and k past K are
//     zero-filled in shared memory (cp.async with src-size 0), and the
//     store is masked.  Nothing is padded in device memory.
//   * Global loads use the widest vector that the row stride and base
//     pointer of every operand, as stored, allow (16, 8, 4 bytes, or 2 with
//     plain loads): a bf16 row of 16,380 elements is 32,760 bytes, not a
//     multiple of 16, so tok_fc1's x and tok_fc2's dz run 8-byte copies.
//     The wrapper picks the width; the kernel is templated on it.
//   * Batch invariance and determinism: the K order of every output element
//     is fixed by K alone (the same k-tiles in the same order, no split-K),
//     so row r of C does not depend on how many rows share the launch, and
//     a training step gives the same bits run to run.
//
// Left for later: wgmma and TMA (the only path to the card's full tensor-core
// rate), a warp-specialised producer, a persistent tile scheduler, and
// bank-conflict-free swizzled shared-memory layouts.

#include "gemm_core.cuh"

namespace {

using gemm::bf16;
using gemm::store_out;

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

// ---------------------------------------------------------------------------
// bf16 operands: tensor cores through WMMA (gemm::bf16_tile)
// ---------------------------------------------------------------------------

template <int VE, bool XT, bool WT>
__global__ void __launch_bounds__(gemm::THREADS)
bm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ y,
               int M, int N, int K, int epi) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int m0 = blockIdx.y * gemm::BM, n0 = blockIdx.x * gemm::BN;
  gemm::bf16_tile<VE, XT, WT>(x, w, M, N, K, m0, n0, smem_raw);

  const float* Cs = reinterpret_cast<const float*>(smem_raw);
  for (int idx = threadIdx.x; idx < gemm::BM * gemm::BN;
       idx += gemm::THREADS) {
    const int r = idx / gemm::BN, c = idx % gemm::BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      float v = Cs[r * gemm::LDC + c];
      if (bias != nullptr) v += bias[gn];
      store_out(y + size_t(gm) * N + gn, apply_epilogue(v, epi));
    }
  }
}

template <int VE, bool XT, bool WT>
cudaError_t launch_bf16(const void* x, const void* w, const void* bias,
                        void* y, int M, int N, int K, int epi,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bm_bf16_kernel<VE, XT, WT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(gemm::SMEM_BF16));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + gemm::BN - 1) / gemm::BN, (M + gemm::BM - 1) / gemm::BM);
  bm_bf16_kernel<VE, XT, WT><<<grid, gemm::THREADS, gemm::SMEM_BF16, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(y), M, N, K, epi);
  return cudaGetLastError();
}

template <int VE>
cudaError_t launch_bf16_layout(const void* x, const void* w,
                               const void* bias, void* y, int M, int N,
                               int K, int epi, int x_t, int w_t,
                               cudaStream_t s) {
  if (x_t && w_t) return launch_bf16<VE, true, true>(x, w, bias, y, M, N, K,
                                                     epi, s);
  if (x_t) return launch_bf16<VE, true, false>(x, w, bias, y, M, N, K, epi, s);
  if (w_t) return launch_bf16<VE, false, true>(x, w, bias, y, M, N, K, epi, s);
  return launch_bf16<VE, false, false>(x, w, bias, y, M, N, K, epi, s);
}

// ---------------------------------------------------------------------------
// f32 operands: exact FMA on the CUDA cores (gemm::f32_tile)
// ---------------------------------------------------------------------------

template <bool XT, bool WT>
__global__ void __launch_bounds__(gemm::FTHREADS)
bm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ y,
              int M, int N, int K, int epi) {
  __shared__ __align__(16) float As[gemm::FBK][gemm::FLD];  // As[k][m]
  __shared__ __align__(16) float Bs[gemm::FBK][gemm::FLD];  // Bs[k][n]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * gemm::FBM, n0 = blockIdx.x * gemm::FBN;
  float acc[8][8];
  gemm::f32_tile<XT, WT>(x, w, M, N, K, m0, n0, As, Bs, acc);

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

template <bool XT, bool WT>
cudaError_t launch_f32(const void* x, const void* w, const void* bias,
                       void* y, int M, int N, int K, int epi,
                       cudaStream_t stream) {
  const dim3 grid((N + gemm::FBN - 1) / gemm::FBN,
                  (M + gemm::FBM - 1) / gemm::FBM);
  bm_f32_kernel<XT, WT><<<grid, gemm::FTHREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), M, N, K, epi);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (bound with ctypes).  Each returns the cudaError_t of the
// launch; the caller raises on anything but 0.  x_t / w_t: 0 = the operand
// is stored K-contiguous ([M, K] / [N, K]), 1 = stored [K, M] / [K, N].
// ---------------------------------------------------------------------------

extern "C" int block_matmul_bf16(const void* x, const void* w,
                                 const void* bias, void* y, int M, int N,
                                 int K, int epi, int x_t, int w_t,
                                 int vec_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16:
      return launch_bf16_layout<8>(x, w, bias, y, M, N, K, epi, x_t, w_t, s);
    case 8:
      return launch_bf16_layout<4>(x, w, bias, y, M, N, K, epi, x_t, w_t, s);
    case 4:
      return launch_bf16_layout<2>(x, w, bias, y, M, N, K, epi, x_t, w_t, s);
    case 2:
      return launch_bf16_layout<1>(x, w, bias, y, M, N, K, epi, x_t, w_t, s);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" int block_matmul_f32(const void* x, const void* w,
                                const void* bias, void* y, int M, int N,
                                int K, int epi, int x_t, int w_t,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_t && w_t) return launch_f32<true, true>(x, w, bias, y, M, N, K, epi, s);
  if (x_t) return launch_f32<true, false>(x, w, bias, y, M, N, K, epi, s);
  if (w_t) return launch_f32<false, true>(x, w, bias, y, M, N, K, epi, s);
  return launch_f32<false, false>(x, w, bias, y, M, N, K, epi, s);
}

extern "C" const char* block_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
