// cannon.cu -- the transposed Cannon of the 2-D token mix for Hopper
// (sm_90a): one Cannon step of one rank per launch, its GEMM and its two
// rotate hops in one grid.
//
// Replaces the TPU kernel kernels/fused_ring.py::_cannon_kernel (pallas_call
// in _cannon_fwd_tpu) of the JAX package, reached through fused_cannon_t
// from jigsaw_matmul_2d_t under kernel="pallas" at q > 1.  The TPU kernel is
// one pallas_call over q grid steps with remote DMAs to the mtp and mdom
// predecessors; here each of the q steps is one launch, and a hop is a
// store through a pointer into the predecessor's receive slot (its own
// memory on the same card, peer memory over NVLink on another card: the
// kernel code is the same).
//
// Step s of rank (i, j) (w [M, K] and x [L, K, N]: at s = 0 the rank's
// skewed blocks, after that what arrived in its receive slots (s-1) % 2):
//   out[l] = (s == 0 ? 0 : out[l]) + w @ x[l]   f32 sum over K, the add in
//                                              f32, one rounding to out's
//                                              dtype (the accumulator's)
//   w_dest = w   the mtp predecessor's slot s % 2   (s < q-1)
//   x_dest = x   the mdom predecessor's slot s % 2  (s < q-1)
// The predecessor is the rank one position down its group, so after the
// step it holds the block of the rank one up: comm.rotate(x, group, 1),
// the reference's perm (t, (t-1) % q).
//
// The GEMM blocks are wx.cu's, with a = out: the same main loop
// (gemm_core.cuh), the same K order and the same epilogue, so the q launches
// give bit for bit what the step loop (cannon_t_loop: one wx launch per
// step, rotations between) gives.  out is [L, M, N]: the TPU kernel's
// [M, L, N] accumulator and its moveaxis are a TPU layout.  out is read and
// written by the same thread, element by element, as wx's a and out.
//
// Slot discipline: ring.cu's.  Before every step the caller synchronises
// its stream and meets the model group at a barrier (one process per rank),
// or orders the launches of all ranks on one stream (one process holding
// every rank); a rank reads its slot (s-1) % 2 and writes its predecessors'
// slots s % 2, so no slot is read before its write has finished or
// rewritten before its last read.  The barrier stands for the TPU kernel's
// 4-neighbour barrier semaphore.  A persistent launch with device-side
// flags, hops overlapping the GEMM, is later work.
//
// Bound: a 2x2 rank's token-mix step at weathermixer-1b's full width is
// 2 L M N K = 1.53e11 FLOP per batch element (M 4,320 or 8,190, K 8,190 or
// 4,320, N 2,160) against ~0.3 GB moved (the operands read once, the f32
// accumulator read and written, the hops written): ~500 FLOP per byte,
// above the ~295 FLOP/byte ridge, so tensor-core FLOPs bound it.  The hop
// copies run beside the GEMM blocks, in the same launch.
//
// Copy widths: the GEMM loads as wx's, the widest that w's and x's rows
// allow (a 2x2 rank's tok_fc1 w has rows of 8,190 bf16, 16,380 bytes: 4-byte
// loads; tok_fc2's rows of 4,320 and x's of 2,160: 16-byte); the hops 16
// bytes a thread when the sizes and addresses allow, else 2.

#include "gemm_core.cuh"

namespace {

using gemm::bf16;
using gemm::store_out;
using gemm::to_float;

// The blocks of one launch: n_gemm output tiles (l-major, then row tiles,
// then column tiles), then n_copy blocks that copy w to w_dest and x to
// x_dest (either may be null).
struct Step {
  void* w_dest;
  void* x_dest;
  size_t w_bytes, x_bytes;
  int M, N, K, first, tiles_n, tiles_mn, n_gemm, n_copy, vec16_w, vec16_x;
};

__device__ __forceinline__ void copy_part(const void* w, const void* x,
                                          const Step& st, int blk) {
  if (st.w_dest != nullptr)
    gemm::copy_bytes(w, st.w_dest, st.w_bytes, st.vec16_w, blk, st.n_copy);
  if (st.x_dest != nullptr)
    gemm::copy_bytes(x, st.x_dest, st.x_bytes, st.vec16_x, blk, st.n_copy);
}

template <int VE, typename OutT>
__global__ void __launch_bounds__(gemm::THREADS)
cannon_bf16_kernel(const bf16* __restrict__ w, const bf16* __restrict__ x,
                   OutT* out, Step st) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int b = blockIdx.x;
  if (b >= st.n_gemm) {
    copy_part(w, x, st, b - st.n_gemm);
    return;
  }
  const size_t l = b / st.tiles_mn;
  const int t = b % st.tiles_mn;
  const int m0 = (t / st.tiles_n) * gemm::BM, n0 = (t % st.tiles_n) * gemm::BN;
  const int M = st.M, N = st.N, K = st.K;
  gemm::bf16_tile<VE, false, true>(w, x + l * size_t(K) * N, M, N, K, m0, n0,
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
      if (!st.first) v = to_float(out[o]) + v;
      store_out(out + o, v);
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(gemm::FTHREADS)
cannon_f32_kernel(const float* __restrict__ w, const float* __restrict__ x,
                  OutT* out, Step st) {
  __shared__ __align__(16) float As[gemm::FBK][gemm::FLD];
  __shared__ __align__(16) float Bs[gemm::FBK][gemm::FLD];
  const int b = blockIdx.x;
  if (b >= st.n_gemm) {
    copy_part(w, x, st, b - st.n_gemm);
    return;
  }
  const size_t l = b / st.tiles_mn;
  const int t = b % st.tiles_mn;
  const int m0 = (t / st.tiles_n) * gemm::FBM;
  const int n0 = (t % st.tiles_n) * gemm::FBN;
  const int M = st.M, N = st.N, K = st.K;
  float acc[8][8];
  gemm::f32_tile<false, true>(w, x + l * size_t(K) * N, M, N, K, m0, n0, As,
                              Bs, acc);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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
      if (!st.first) v = to_float(out[o]) + v;
      store_out(out + o, v);
    }
  }
}

Step make_step(void* w_dest, void* x_dest, int L, int M, int N, int K,
               int first, int es, int tile, int vec16_w, int vec16_x) {
  Step st;
  st.w_dest = w_dest;
  st.x_dest = x_dest;
  st.w_bytes = size_t(M) * K * es;
  st.x_bytes = size_t(L) * K * N * es;
  st.M = M;
  st.N = N;
  st.K = K;
  st.first = first;
  st.tiles_n = (N + tile - 1) / tile;
  st.tiles_mn = ((M + tile - 1) / tile) * st.tiles_n;
  st.n_gemm = L * st.tiles_mn;
  size_t hop = 0;
  if (w_dest != nullptr) hop += st.w_bytes;
  if (x_dest != nullptr) hop += st.x_bytes;
  st.n_copy = hop ? gemm::copy_blocks(hop) : 0;
  st.vec16_w = vec16_w;
  st.vec16_x = vec16_x;
  return st;
}

template <int VE, typename OutT>
cudaError_t launch_bf16(const void* w, const void* x, void* out,
                        const Step& st, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      cannon_bf16_kernel<VE, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(gemm::SMEM_BF16));
  if (err != cudaSuccess) return err;
  cannon_bf16_kernel<VE, OutT>
      <<<st.n_gemm + st.n_copy, gemm::THREADS, gemm::SMEM_BF16, s>>>(
          static_cast<const bf16*>(w), static_cast<const bf16*>(x),
          static_cast<OutT*>(out), st);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_bf16_vec(const void* w, const void* x, void* out,
                            const Step& st, int vec_bytes, cudaStream_t s) {
  switch (vec_bytes) {
    case 16: return launch_bf16<8, OutT>(w, x, out, st, s);
    case 8: return launch_bf16<4, OutT>(w, x, out, st, s);
    case 4: return launch_bf16<2, OutT>(w, x, out, st, s);
    case 2: return launch_bf16<1, OutT>(w, x, out, st, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename OutT>
cudaError_t launch_f32(const void* w, const void* x, void* out,
                       const Step& st, cudaStream_t s) {
  cannon_f32_kernel<OutT><<<st.n_gemm + st.n_copy, gemm::FTHREADS, 0, s>>>(
      static_cast<const float*>(w), static_cast<const float*>(x),
      static_cast<OutT*>(out), st);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (bound with ctypes).  Each returns the cudaError_t of the
// launch; the caller raises on anything but 0.  w [M, K], x [L, K, N], out
// [L, M, N]; w_dest and x_dest the predecessors' slots, or null (the last
// step).  first: out is not read (step 0).  out_bf16: out is bf16, else
// f32.  vec_bytes: the GEMM's load width; vec16_w / vec16_x: the hops'.
// ---------------------------------------------------------------------------

extern "C" int cannon_bf16(const void* w, const void* x, void* out,
                           void* w_dest, void* x_dest, int L, int M, int N,
                           int K, int first, int out_bf16, int vec_bytes,
                           int vec16_w, int vec16_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Step st = make_step(w_dest, x_dest, L, M, N, K, first, 2, gemm::BM,
                            vec16_w, vec16_x);
  if (out_bf16) return launch_bf16_vec<bf16>(w, x, out, st, vec_bytes, s);
  return launch_bf16_vec<float>(w, x, out, st, vec_bytes, s);
}

extern "C" int cannon_f32(const void* w, const void* x, void* out,
                          void* w_dest, void* x_dest, int L, int M, int N,
                          int K, int first, int out_bf16, int vec16_w,
                          int vec16_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Step st = make_step(w_dest, x_dest, L, M, N, K, first, 4, gemm::FBM,
                            vec16_w, vec16_x);
  if (out_bf16) return launch_f32<bf16>(w, x, out, st, s);
  return launch_f32<float>(w, x, out, st, s);
}

extern "C" const char* cannon_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
