// wx.cu -- out[l] = a[l] + W @ x[l] for Hopper (sm_90a): the transposed-
// Cannon multiply-accumulate step of the 2-D token mix.
//
// Replaces the TPU kernel kernels/fused_ring.py::_wx_kernel (pallas_call in
// _wx_raw(), wrapped by the custom VJP _wx_acc and by cannon_t_step) of the
// JAX package.  Every Cannon step of a token-mix linear under scheme="2d"
// is one launch, forward and dx.
//
//   W [M, K] is read from w, stored either [M, K] (K contiguous, w_t = 0:
//   the forward, W = w[m, t]) or [K, M] (w_t = 1: dx = w.T @ dy, w read
//   across its rows);
//   x: [L, K, N], each batch element stored [K, N] (N contiguous): the
//   product contracts x's second-to-last dim, so x is never transposed;
//   a: [L, M, N] in the output dtype, or none (a zero accumulator);
//   out: [L, M, N], f32 or bf16 (the accumulator's dtype).
//
// In block_matmul's terms each batch element is A = W times B = x[l].T,
// with B stored [K, N]: the N-contiguous layout (BT).  The sum over K is
// kept in f32, a is up-cast and added in the epilogue, and the sum is
// rounded once to the output dtype.  out may alias a: each element of a is
// read once, by the thread that then writes the same element of out.
//
// Bound: at the full-width shapes (M 4,320-16,380, K 4,320-16,380, N 2,160
// or 4,320) a step does ~1,000-2,000 FLOP per byte it must move in bf16,
// above the ~295 FLOP/byte ridge: tensor-core FLOPs bound it, as they bound
// block_matmul.  dx runs f32 operands (the reference takes dy, the f32
// cotangent of the f32 accumulator) on the CUDA cores, 67 TFLOP/s at most.
//
// Design: the tile main loops of gemm_core.cuh (bf16 WMMA 128x128 tiles
// through a 3-stage cp.async ring; f32 FMA 128x128 tiles), with
// blockIdx.z = l and each operand offset by its batch stride (W's is 0);
// ragged M, N, K masked in the kernel; copy width from the row and batch
// strides (the wrapper picks it: a 2x2 rank's w rows of 8,190 bf16 are
// 16,380 bytes, so only 4-byte copies fit).  No split-K, so results repeat
// bit for bit.  Left for later: wgmma and TMA, and a bf16 route for dx.

#include "gemm_core.cuh"

namespace {

using gemm::bf16;
using gemm::store_out;
using gemm::to_float;

template <int VE, bool WT, typename OutT>
__global__ void __launch_bounds__(gemm::THREADS)
wx_bf16_kernel(const bf16* __restrict__ w, const bf16* __restrict__ x,
               const OutT* a, OutT* out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int m0 = blockIdx.y * gemm::BM, n0 = blockIdx.x * gemm::BN;
  const size_t l = blockIdx.z;
  gemm::bf16_tile<VE, WT, true>(w, x + l * size_t(K) * N, M, N, K, m0, n0,
                                smem_raw);

  const float* Cs = reinterpret_cast<const float*>(smem_raw);
  const size_t base = l * size_t(M) * N;
  for (int idx = threadIdx.x; idx < gemm::BM * gemm::BN;
       idx += gemm::THREADS) {
    const int r = idx / gemm::BN, c = idx % gemm::BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      const size_t o = base + size_t(gm) * N + gn;
      float v = Cs[r * gemm::LDC + c];
      if (a != nullptr) v = to_float(a[o]) + v;
      store_out(out + o, v);
    }
  }
}

template <int VE, bool WT, typename OutT>
cudaError_t launch_bf16(const void* w, const void* x, const void* a,
                        void* out, int L, int M, int N, int K,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wx_bf16_kernel<VE, WT, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(gemm::SMEM_BF16));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + gemm::BN - 1) / gemm::BN,
                  (M + gemm::BM - 1) / gemm::BM, L);
  wx_bf16_kernel<VE, WT, OutT>
      <<<grid, gemm::THREADS, gemm::SMEM_BF16, stream>>>(
          static_cast<const bf16*>(w), static_cast<const bf16*>(x),
          static_cast<const OutT*>(a), static_cast<OutT*>(out), M, N, K);
  return cudaGetLastError();
}

template <int VE, typename OutT>
cudaError_t launch_bf16_layout(const void* w, const void* x, const void* a,
                               void* out, int L, int M, int N, int K,
                               int w_t, cudaStream_t s) {
  if (w_t) return launch_bf16<VE, true, OutT>(w, x, a, out, L, M, N, K, s);
  return launch_bf16<VE, false, OutT>(w, x, a, out, L, M, N, K, s);
}

template <typename OutT>
cudaError_t launch_bf16_vec(const void* w, const void* x, const void* a,
                            void* out, int L, int M, int N, int K, int w_t,
                            int vec_bytes, cudaStream_t s) {
  switch (vec_bytes) {
    case 16:
      return launch_bf16_layout<8, OutT>(w, x, a, out, L, M, N, K, w_t, s);
    case 8:
      return launch_bf16_layout<4, OutT>(w, x, a, out, L, M, N, K, w_t, s);
    case 4:
      return launch_bf16_layout<2, OutT>(w, x, a, out, L, M, N, K, w_t, s);
    case 2:
      return launch_bf16_layout<1, OutT>(w, x, a, out, L, M, N, K, w_t, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool WT, typename OutT>
__global__ void __launch_bounds__(gemm::FTHREADS)
wx_f32_kernel(const float* __restrict__ w, const float* __restrict__ x,
              const OutT* a, OutT* out, int M, int N, int K) {
  __shared__ __align__(16) float As[gemm::FBK][gemm::FLD];  // As[k][m]
  __shared__ __align__(16) float Bs[gemm::FBK][gemm::FLD];  // Bs[k][n]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * gemm::FBM, n0 = blockIdx.x * gemm::FBN;
  const size_t l = blockIdx.z;
  float acc[8][8];
  gemm::f32_tile<WT, true>(w, x + l * size_t(K) * N, M, N, K, m0, n0, As,
                           Bs, acc);

  const size_t base = l * size_t(M) * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty * 8 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx * 8 + j;
      if (gn >= N) continue;
      const size_t o = base + size_t(gm) * N + gn;
      float v = acc[i][j];
      if (a != nullptr) v = to_float(a[o]) + v;
      store_out(out + o, v);
    }
  }
}

template <bool WT, typename OutT>
cudaError_t launch_f32(const void* w, const void* x, const void* a,
                       void* out, int L, int M, int N, int K,
                       cudaStream_t stream) {
  const dim3 grid((N + gemm::FBN - 1) / gemm::FBN,
                  (M + gemm::FBM - 1) / gemm::FBM, L);
  wx_f32_kernel<WT, OutT><<<grid, gemm::FTHREADS, 0, stream>>>(
      static_cast<const float*>(w), static_cast<const float*>(x),
      static_cast<const OutT*>(a), static_cast<OutT*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_f32_layout(const void* w, const void* x, const void* a,
                              void* out, int L, int M, int N, int K, int w_t,
                              cudaStream_t s) {
  if (w_t) return launch_f32<true, OutT>(w, x, a, out, L, M, N, K, s);
  return launch_f32<false, OutT>(w, x, a, out, L, M, N, K, s);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (bound with ctypes).  Each returns the cudaError_t of the
// launch; the caller raises on anything but 0.  w_t: 0 = w stored [M, K],
// 1 = stored [K, M].  out_bf16: 0 = a and out are f32, 1 = bf16.
// ---------------------------------------------------------------------------

extern "C" int wx_bf16(const void* w, const void* x, const void* a,
                       void* out, int L, int M, int N, int K, int w_t,
                       int out_bf16, int vec_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_bf16_vec<bf16>(w, x, a, out, L, M, N, K, w_t, vec_bytes, s);
  return launch_bf16_vec<float>(w, x, a, out, L, M, N, K, w_t, vec_bytes, s);
}

extern "C" int wx_f32(const void* w, const void* x, const void* a, void* out,
                      int L, int M, int N, int K, int w_t, int out_bf16,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_f32_layout<bf16>(w, x, a, out, L, M, N, K, w_t, s);
  return launch_f32_layout<float>(w, x, a, out, L, M, N, K, w_t, s);
}

extern "C" const char* wx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
