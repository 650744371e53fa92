// block_matmul.cu -- C = epilogue(A @ B.T + b) for Hopper (sm_90a), with
// each operand read in either of its two layouts.
//
// Replaces the TPU kernel kernels/block_matmul.py::_kernel (pallas_call in
// block_matmul(), wrapped by kernels/ops.py::matmul / matmul_nd / mixer_mlp
// and by the custom VJP _matmul_bwd) of the JAX package.  It carries every
// GEMM of a WeatherMixer forecast step and of a training step, forward and
// backward, and every linear of the Mamba-2 model.
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
// device memory: the loads run along whichever dimension is contiguous.
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
// Design, three routes (the wrapper picks one by dtype and shape):
//   * bf16, the Hopper loop (gemm_sm90.cuh): wgmma m64n256k16 from
//     128-byte-swizzled shared memory, fed by a TMA producer thread
//     through a 4-stage mbarrier ring of [128 x 64] A and [64 x 256] B
//     tiles, one persistent 384-thread block per SM walking the [128 x
//     256] output tiles.  Every layout: A K-major (x [M, K]) or M-major (x
//     stored [K, M]); B K-major (w [N, K], transpose-B off) or N-major (w
//     stored [K, N]).  The epilogue runs on the accumulator registers:
//     bias, activation and one rounding per element, stored in bf16 pairs.
//     Each operand carries its own row stride (TMA takes multiples of 16
//     bytes: the wrapper pads rows of 16,380 once per call).
//   * bf16, the WMMA loop (gemm_core.cuh): 128x128 tiles, cp.async in
//     32-wide k-steps, mma.sync through WMMA fragments, the f32 tile
//     through shared memory.  The wrapper takes it where a [128 x 256]
//     tile would be mostly empty (M or N under 64: Mamba-2's decode, M =
//     4, and its in_dt, N = 24).
//   * f32: exact f32 FMA on the CUDA cores (no TF32), gemm_core.cuh's
//     pipelined loop: 128x128 tiles in bands of 8 rows of tiles, each
//     thread 8x8 outputs; K runs sequentially per output element.
//
// Bit for bit across the two bf16 routes: both zero the accumulators and
// give each output element the same k16 steps, 2 * ceil(K / 32) of them,
// in K order (wgmma's k16 step rounds as mma.sync's on this card: checked
// by chip_smoke.py and the card tests at every smoke shape), the same
// epilogue (apply_epilogue below, one source) and the same rounding.  No
// split-K, no atomics: row r of C does not depend on how many rows share
// the launch, and a training step gives the same bits run to run.
//
// Ragged edges: TMA fills zeros past every edge of an operand (the WMMA
// loop's cp.async with src-size 0 likewise), and the stores are masked.

#include "gemm_core.cuh"
#include "gemm_sm90.cuh"

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
// bf16 operands on the Hopper loop (gemm_sm90.cuh)
// ---------------------------------------------------------------------------

// Tiles: C [M, N] in sm90::grouped_tile's order.  A = x, K-major
// ([M, K], row stride ld_x) or M-major (XT: [K, M]); B = w, K-major
// ([N, K], row stride ld_w) or N-major (WT: [K, N]).
template <bool XT, bool WT, int EPI>
struct BmProblem {
  static constexpr bool B_KMAJOR = !WT;
  const CUtensorMap* mx;
  const CUtensorMap* mw;
  const float* bias;
  bf16* y;
  int M, N, K, tiles_m, tiles_n, vec2;

  __device__ int tiles() const { return tiles_m * tiles_n; }

  __device__ sm90::Tile tile(int t) const {
    int tm, tn;
    sm90::grouped_tile(t, tiles_m, tiles_n, tm, tn);
    return {0, tm * sm90::BM, tn * sm90::BN, 0, K};
  }

  __device__ bool a_mn(int) const { return XT; }

  __device__ void load(const sm90::Tile& tl, int k0, uint32_t a, uint32_t b,
                       uint32_t bar) const {
    if (XT) {
      sm90::tma_load(a, mx, tl.m0, k0, 0, bar);
      sm90::tma_load(a + sm90::BOX_BYTES, mx, tl.m0 + 64, k0, 0, bar);
    } else {
      sm90::tma_load(a, mx, k0, tl.m0, 0, bar);
    }
    if (WT) {
#pragma unroll
      for (int i = 0; i < sm90::BN / 64; ++i)
        sm90::tma_load(b + i * sm90::BOX_BYTES, mw, tl.n0 + 64 * i, k0, 0,
                       bar);
    } else {
      sm90::tma_load(b, mw, k0, tl.n0, 0, bar);
      sm90::tma_load(b + 2 * sm90::BOX_BYTES, mw, k0, tl.n0 + 128, 0, bar);
    }
  }

  __device__ void store(const sm90::Tile& tl, const float (&acc)[sm90::ACC],
                        int row, int col) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row + 8 * h;
      if (gm >= M) continue;
      bf16* o = y + size_t(gm) * N;
#pragma unroll
      for (int j = 0; j < sm90::BN / 8; ++j) {
        const int gn = col + 8 * j;
        if (gn >= N) continue;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        const bool two = gn + 1 < N;
        if (bias != nullptr) {
          v0 += bias[gn];
          if (two) v1 += bias[gn + 1];
        }
        v0 = apply_epilogue(v0, EPI);
        v1 = apply_epilogue(v1, EPI);
        if (vec2) {  // N even: gn < N means gn + 1 < N
          sm90::store_pair(o + gn, v0, v1);
        } else {
          store_out(o + gn, v0);
          if (two) store_out(o + gn + 1, v1);
        }
      }
    }
  }

  __device__ void copy(int, int) const {}
};

template <bool XT, bool WT, int EPI>
__global__ void __launch_bounds__(sm90::THREADS, 1)
bm_sm90_kernel(const __grid_constant__ CUtensorMap mx,
               const __grid_constant__ CUtensorMap mw,
               BmProblem<XT, WT, EPI> st) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BmProblem<XT, WT, EPI> p = st;
  p.mx = &mx;
  p.mw = &mw;
  sm90::run(p, smem_raw);
}

template <bool XT, bool WT, int EPI>
int launch_sm90(const void* x, const void* w, const void* bias, void* y,
                int M, int N, int K, int ld_x, int ld_w, int vec2,
                cudaStream_t s) {
  auto kernel = bm_sm90_kernel<XT, WT, EPI>;
  static const int reg_err = sm90::check_registers(kernel);
  if (reg_err != 0) return reg_err;
  CUtensorMap mx, mw;
  const int mx_err = XT ? sm90::make_map(&mx, x, M, K, 1, ld_x, 64, 64)
                        : sm90::make_map(&mx, x, K, M, 1, ld_x, 64, 128);
  const int mw_err = WT ? sm90::make_map(&mw, w, N, K, 1, ld_w, 64, 64)
                        : sm90::make_map(&mw, w, K, N, 1, ld_w, 64, 128);
  if (mx_err != 0 || mw_err != 0) return sm90::TENSOR_MAP_ERROR;
  BmProblem<XT, WT, EPI> st;
  st.mx = st.mw = nullptr;
  st.bias = static_cast<const float*>(bias);
  st.y = static_cast<bf16*>(y);
  st.M = M;
  st.N = N;
  st.K = K;
  st.tiles_m = (M + sm90::BM - 1) / sm90::BM;
  st.tiles_n = (N + sm90::BN - 1) / sm90::BN;
  st.vec2 = vec2;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(sm90::SMEM_BYTES));
  if (e != cudaSuccess) return int(e);
  kernel<<<sm90::grid_size(st.tiles_m * st.tiles_n, false), sm90::THREADS,
           sm90::SMEM_BYTES, s>>>(mx, mw, st);
  return int(cudaGetLastError());
}

template <int EPI>
int launch_sm90_layout(const void* x, const void* w, const void* bias,
                       void* y, int M, int N, int K, int ld_x, int ld_w,
                       int x_t, int w_t, int vec2, cudaStream_t s) {
  if (x_t && w_t)
    return launch_sm90<true, true, EPI>(x, w, bias, y, M, N, K, ld_x, ld_w,
                                        vec2, s);
  if (x_t)
    return launch_sm90<true, false, EPI>(x, w, bias, y, M, N, K, ld_x, ld_w,
                                         vec2, s);
  if (w_t)
    return launch_sm90<false, true, EPI>(x, w, bias, y, M, N, K, ld_x, ld_w,
                                         vec2, s);
  return launch_sm90<false, false, EPI>(x, w, bias, y, M, N, K, ld_x, ld_w,
                                        vec2, s);
}

template <bool XT, bool WT>
int sm90_attrs(int epi, int* out) {
  switch (epi) {
    case EPI_NONE:
      return sm90::kernel_attrs(bm_sm90_kernel<XT, WT, EPI_NONE>,
                                sm90::SMEM_BYTES, out);
    case EPI_GELU:
      return sm90::kernel_attrs(bm_sm90_kernel<XT, WT, EPI_GELU>,
                                sm90::SMEM_BYTES, out);
    case EPI_SILU:
      return sm90::kernel_attrs(bm_sm90_kernel<XT, WT, EPI_SILU>,
                                sm90::SMEM_BYTES, out);
    default: return int(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16 operands: tensor cores through WMMA (gemm::bf16_tile), for shapes
// whose [128 x 256] tiles would be mostly empty
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

template <int VE>
int wmma_attrs(int x_t, int w_t, int* out) {
  const size_t smem = gemm::SMEM_BF16;
  if (x_t && w_t)
    return sm90::kernel_attrs(bm_bf16_kernel<VE, true, true>, smem, out);
  if (x_t)
    return sm90::kernel_attrs(bm_bf16_kernel<VE, true, false>, smem, out);
  if (w_t)
    return sm90::kernel_attrs(bm_bf16_kernel<VE, false, true>, smem, out);
  return sm90::kernel_attrs(bm_bf16_kernel<VE, false, false>, smem, out);
}

// ---------------------------------------------------------------------------
// f32 operands: exact FMA on the CUDA cores (gemm::f32_tile)
// ---------------------------------------------------------------------------

// Tiles: C [M, N] in sm90::grouped_tile's bands of 8 rows of tiles, one
// [128 x 128] tile a block.
template <bool XT, bool WT>
__global__ void __launch_bounds__(gemm::FTHREADS, 2)
bm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ y,
              int M, int N, int K, int epi, int tiles_m, int tiles_n) {
  __shared__ __align__(16) gemm::F32Smem sm;
  int tm, tn;
  sm90::grouped_tile(blockIdx.x, tiles_m, tiles_n, tm, tn);
  const int m0 = tm * gemm::FBM, n0 = tn * gemm::FBN;
  float acc[8][8];
  gemm::f32_tile<XT, WT>(x, w, M, N, K, m0, n0, sm, acc);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + gemm::f32_row(i);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + gemm::f32_col(j);
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
  const int tiles_m = (M + gemm::FBM - 1) / gemm::FBM;
  const int tiles_n = (N + gemm::FBN - 1) / gemm::FBN;
  bm_f32_kernel<XT, WT><<<tiles_m * tiles_n, gemm::FTHREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), M, N, K, epi,
      tiles_m, tiles_n);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (bound with ctypes).  Each returns the cudaError_t of the
// launch, or sm90::TENSOR_MAP_ERROR / sm90::REGISTER_ERROR; the caller
// raises on anything but 0.  x_t / w_t: 0 = the operand is stored
// K-contiguous ([M, K] / [N, K]), 1 = stored [K, M] / [K, N].
// block_matmul_sm90 takes each operand's row stride (ld_x, ld_w: multiples
// of 8 elements, bases 16-byte aligned); vec2: N is even and y 4-byte
// aligned (pairs of columns per store).  block_matmul_bf16 (the WMMA
// loop) and block_matmul_f32 take the operands contiguous.
// ---------------------------------------------------------------------------

extern "C" int block_matmul_sm90(const void* x, const void* w,
                                 const void* bias, void* y, int M, int N,
                                 int K, int ld_x, int ld_w, int epi, int x_t,
                                 int w_t, int vec2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case EPI_NONE:
      return launch_sm90_layout<EPI_NONE>(x, w, bias, y, M, N, K, ld_x, ld_w,
                                          x_t, w_t, vec2, s);
    case EPI_GELU:
      return launch_sm90_layout<EPI_GELU>(x, w, bias, y, M, N, K, ld_x, ld_w,
                                          x_t, w_t, vec2, s);
    case EPI_SILU:
      return launch_sm90_layout<EPI_SILU>(x, w, bias, y, M, N, K, ld_x, ld_w,
                                          x_t, w_t, vec2, s);
    default: return int(cudaErrorInvalidValue);
  }
}

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

// Attributes of a kernel variant (sm90::kernel_attrs: registers, local
// bytes, static and dynamic shared bytes, block size): route 0 the Hopper
// loop at (x_t, w_t, epi), 1 the WMMA loop at load width vec_bytes and
// (x_t, w_t), 2 the f32 kernel at (x_t, w_t).
extern "C" int block_matmul_attrs(int route, int x_t, int w_t, int epi,
                                  int vec_bytes, int* out) {
  if (route == 0) {
    if (x_t && w_t) return sm90_attrs<true, true>(epi, out);
    if (x_t) return sm90_attrs<true, false>(epi, out);
    if (w_t) return sm90_attrs<false, true>(epi, out);
    return sm90_attrs<false, false>(epi, out);
  }
  if (route == 2) {
    if (x_t && w_t)
      return sm90::kernel_attrs(bm_f32_kernel<true, true>, 0, out);
    if (x_t) return sm90::kernel_attrs(bm_f32_kernel<true, false>, 0, out);
    if (w_t) return sm90::kernel_attrs(bm_f32_kernel<false, true>, 0, out);
    return sm90::kernel_attrs(bm_f32_kernel<false, false>, 0, out);
  }
  if (route != 1) return int(cudaErrorInvalidValue);
  switch (vec_bytes) {
    case 16: return wmma_attrs<8>(x_t, w_t, out);
    case 8: return wmma_attrs<4>(x_t, w_t, out);
    case 4: return wmma_attrs<2>(x_t, w_t, out);
    case 2: return wmma_attrs<1>(x_t, w_t, out);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* block_matmul_error_string(int err) {
  if (err == sm90::TENSOR_MAP_ERROR)
    return "cuTensorMapEncodeTiled refused an operand";
  if (err == sm90::REGISTER_ERROR)
    return "the kernel's register count leaves setmaxnreg no room";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
