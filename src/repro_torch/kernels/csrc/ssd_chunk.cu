// ssd_chunk.cu -- the Mamba-2 intra-chunk SSD term for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/ssd_chunk.py::_kernel (pallas_call in
// ssd_intra_chunk(), entry point kernels/ops.py::ssd_intra) of the JAX
// package.  Under the port's _ssd_chunked (models/layers.py) every Mamba-2
// layer's forward is one launch.
//
// One thread block per group g of G = batch x chunks x heads, with
//   c, b: [G, Q, N] and x: [G, Q, P] in T (float or bf16), dt, dac: [G, Q]
//   in f32 (dt after softplus, dac the within-chunk cumsum of dt * A);
//   y: [G, Q, P] in T:
//
//   s[i][j]   = sum_n c[i][n] * b[j][n]                    (f32 FMA)
//   att[i][j] = i >= j ? (s[i][j] * exp(dac[i] - dac[j])) * dt[j] : 0
//   y[i][p]   = sum_j T(att[i][j]) * x[j][p]                (f32 FMA)
//
// and y rounded once to T.  For bf16 x, att is rounded to bf16 before the
// second product, as the TPU kernel's att.astype(x.dtype).
//
// The mask is a select, never a multiply by 0: dac decreases along the
// chunk (dt > 0, A < 0), so above the diagonal dac[i] - dac[j] > 0 and exp
// can overflow to inf, and inf * 0 is NaN.  exp is not even evaluated there.
//
// Bound: at mamba2-130m's shapes (Q = 64, N = 128, P = 64, f32) a group
// moves 98,816 bytes (c, b, x, dt, dac in, y out) for ~0.8 MFLOP of the
// causal half, ~8 FLOP per byte, below the card's f32 ridge of ~20: device
// memory bounds it (PERF.md).
//
// Design (a first, simple kernel): the group's c and b are loaded into
// shared memory transposed ([n][i], one padding column so the transposed
// stores do not collide in a bank), x as stored, dt and dac; 256 threads,
// each a 4 x 4 tile of s (tiles wholly above the diagonal skip the sum and
// write zeros), then a 4-row by P/16-column tile of y with its columns 16
// apart, so a warp's loads of a row of x are consecutive.  Rows Q..63 of a
// ragged chunk are zeros in shared memory and are not stored.  Up to
// 116,480 bytes of dynamic shared memory (N = 128, P = 128), so the limit
// is raised before each launch.  Plain FFMA, no TF32, no tensor cores:
// wgmma, TMA and a load/compute overlap are left for a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int QMAX = 64;           // rows of a chunk the kernel holds
constexpr int NMAX = 128;          // state width
constexpr int PMAX = 128;          // head width
constexpr int PITCH = QMAX + 1;    // row pitch of the transposed c, b and att

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_intra_kernel(const T* __restrict__ c, const T* __restrict__ b,
                 const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ dac, T* __restrict__ y, int Q,
                 int N, int P) {
  extern __shared__ float smem[];
  float* cT = smem;                     // [N][PITCH]
  float* bT = cT + N * PITCH;           // [N][PITCH]
  float* att = bT + N * PITCH;          // [QMAX][PITCH]
  float* xs = att + QMAX * PITCH;       // [QMAX][P]
  float* dts = xs + QMAX * P;           // [QMAX]
  float* dacs = dts + QMAX;             // [QMAX]

  const size_t g = blockIdx.x;
  const T* cg = c + g * size_t(Q) * N;
  const T* bg = b + g * size_t(Q) * N;
  const T* xg = x + g * size_t(Q) * P;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < QMAX * N; idx += THREADS) {
    const int i = idx / N, n = idx % N;
    const bool in = i < Q;
    cT[n * PITCH + i] = in ? to_float(cg[size_t(i) * N + n]) : 0.f;
    bT[n * PITCH + i] = in ? to_float(bg[size_t(i) * N + n]) : 0.f;
  }
  for (int idx = tid; idx < QMAX * P; idx += THREADS) {
    const int j = idx / P;
    xs[idx] = j < Q ? to_float(xg[idx]) : 0.f;
  }
  if (tid < QMAX) {
    dts[tid] = tid < Q ? dt[g * Q + tid] : 0.f;
    dacs[tid] = tid < Q ? dac[g * Q + tid] : 0.f;
  }
  __syncthreads();

  // s and att: thread (ty, tx) holds rows 4ty..4ty+3, columns 4tx..4tx+3
  const int ty = tid / 16, tx = tid % 16;
  const int i0 = 4 * ty, j0 = 4 * tx;
  if (tx <= ty) {
    float acc[4][4] = {};
    for (int n = 0; n < N; ++n) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = cT[n * PITCH + i0 + r];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = bT[n * PITCH + j0 + q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + q;
        float v = 0.f;
        if (i >= j && i < Q) {
          v = (acc[r][q] * expf(dacs[i] - dacs[j])) * dts[j];
          v = to_float(from_float<T>(v));   // att.astype(x.dtype)
        }
        att[i * PITCH + j] = v;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) att[(i0 + r) * PITCH + j0 + q] = 0.f;
  }
  __syncthreads();

  // y: thread (ty, tx) holds rows 4ty..4ty+3, columns tx + 16k; att is 0
  // for j > i, so row i sums j = 0..i and the tile stops at its last row
  T* yg = y + g * size_t(Q) * P;
  const int jend = min(i0 + 4, Q);
  for (int p0 = 0; p0 < P; p0 += 64) {
    float acc[4][4] = {};
    for (int j = 0; j < jend; ++j) {
      float av[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = att[(i0 + r) * PITCH + j];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = p0 + tx + 16 * k;
        xv[k] = p < P ? xs[j * P + p] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(av[r], xv[k], acc[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r;
      if (i >= Q) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = p0 + tx + 16 * k;
        if (p < P) yg[size_t(i) * P + p] = from_float<T>(acc[r][k]);
      }
    }
  }
}

size_t smem_bytes(int N, int P) {
  return sizeof(float) *
         (size_t(2) * N * PITCH + size_t(QMAX) * PITCH + size_t(QMAX) * P +
          2 * QMAX);
}

template <typename T>
cudaError_t launch(const void* c, const void* b, const void* x,
                   const void* dt, const void* dac, void* y, int G, int Q,
                   int N, int P, cudaStream_t s) {
  if (Q < 1 || Q > QMAX || N < 1 || N > NMAX || P < 1 || P > PMAX || G < 1)
    return cudaErrorInvalidValue;
  // above 48 KB only as opted-in dynamic shared memory (per device, so
  // raised on every launch: a host-side call)
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_intra_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem_bytes(NMAX, PMAX)));
  if (e != cudaSuccess) return e;
  ssd_intra_kernel<T><<<G, THREADS, smem_bytes(N, P), s>>>(
      static_cast<const T*>(c), static_cast<const T*>(b),
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(dac), static_cast<T*>(y), Q, N, P);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (bound with ctypes).  Each returns the cudaError_t of the
// launch; the caller raises on anything but 0.
// ---------------------------------------------------------------------------

extern "C" int ssd_chunk_f32(const void* c, const void* b, const void* x,
                             const void* dt, const void* dac, void* y, int G,
                             int Q, int N, int P, void* stream) {
  return launch<float>(c, b, x, dt, dac, y, G, Q, N, P,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int ssd_chunk_bf16(const void* c, const void* b, const void* x,
                              const void* dt, const void* dac, void* y, int G,
                              int Q, int N, int P, void* stream) {
  return launch<__nv_bfloat16>(c, b, x, dt, dac, y, G, Q, N, P,
                               static_cast<cudaStream_t>(stream));
}

extern "C" const char* ssd_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
