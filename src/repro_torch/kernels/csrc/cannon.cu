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
// Bit for bit the step loop (cannon_t_loop: one wx launch per step,
// rotations between), whose kernel runs gemm_core.cuh's WMMA loop: the
// bf16 kernel's loop (gemm_sm90.cuh) gives every output element the same
// k16 steps in the same K order, and the same epilogue, out + acc in f32.
// out is [L, M, N]: the TPU kernel's [M, L, N] accumulator and its
// moveaxis are a TPU layout.
//
// Slot discipline: ring.cu's.  Before every step the caller synchronises
// its stream and meets the model group at a barrier (one process per rank),
// or orders the launches of all ranks on one stream (one process holding
// every rank); a rank reads its slot (s-1) % 2 and writes its predecessors'
// slots s % 2, so no slot is read before its write has finished or
// rewritten before its last read.  The barrier stands for the TPU kernel's
// 4-neighbour barrier semaphore.  A persistent launch per loop with
// device-side flags is later work.
//
// Bound: a 2x2 rank's token-mix step at weathermixer-1b's full width is
// 2 L M N K = 1.53e11 FLOP per batch element (M 4,320 or 8,190, K 8,190 or
// 4,320, N 2,160) against ~0.3 GB moved (the operands read once, the f32
// accumulator read and written, the hops written): ~500 FLOP per byte,
// above the ~295 FLOP/byte ridge, so tensor-core FLOPs bound it.
//
// What the bf16 design does about it (gemm_sm90.cuh): wgmma from
// 128-byte-swizzled shared memory fed by a TMA producer warp through a
// 4-stage mbarrier ring of [128 x 256] tiles, one persistent 384-thread
// block per SM, and the epilogue read-add-written as float2 (bf16x2)
// pairs straight from the accumulator registers, with no shared f32 tile.
// Each operand has its own row stride `ld` (a multiple of 8 elements,
// which TMA takes), so one operand's odd rows (tok_fc1's w: 8,190 bf16)
// cost its own padding, not every operand's load width: the caller pads
// w or x once per loop and the receive slots hold the padded layout.  The
// hops are copied by the producer warpgroup's three idle warps while the
// consumers compute, 16 bytes a thread when the sizes and addresses
// allow, else 2.  The f32 variant (exact FMA on the CUDA cores,
// gemm_core.cuh) takes w and x contiguous; no bf16 path runs it.

#include "gemm_core.cuh"
#include "gemm_sm90.cuh"

namespace {

using gemm::bf16;
using gemm::store_out;
using gemm::to_float;

// ---------------------------------------------------------------------------
// bf16: the Hopper loop (gemm_sm90.cuh)
// ---------------------------------------------------------------------------

// Tiles: l-major, then row tiles, then column tiles of out [L, M, N].  A =
// w [M, K] (K-major, row stride ld_w), B = x[l] [K, N] (N-major, row
// stride ld_x).  The hop sources are w and x as stored (ld included).
template <typename OutT>
struct CannonStep {
  const CUtensorMap* mw;
  const CUtensorMap* mx;
  const void* w;
  const void* x;
  OutT* out;
  void* w_dest;
  void* x_dest;
  size_t w_bytes, x_bytes;
  int M, N, K, L, first, tiles_n, tiles_mn, vec2, vec16_w, vec16_x;

  __device__ int tiles() const { return L * tiles_mn; }

  __device__ sm90::Tile tile(int t) const {
    const int r = t % tiles_mn;
    return {0, (r / tiles_n) * sm90::BM, (r % tiles_n) * sm90::BN,
            t / tiles_mn, K};
  }

  __device__ bool a_mn(int) const { return false; }
  static constexpr bool B_KMAJOR = false;

  __device__ void load(const sm90::Tile& tl, int k0, uint32_t a, uint32_t b,
                       uint32_t bar) const {
    sm90::tma_load(a, mw, k0, tl.m0, 0, bar);
#pragma unroll
    for (int i = 0; i < sm90::BN / 64; ++i)
      sm90::tma_load(b + i * sm90::BOX_BYTES, mx, tl.n0 + 64 * i, k0, tl.l,
                     bar);
  }

  __device__ void store(const sm90::Tile& tl, const float (&acc)[sm90::ACC],
                        int row, int col) const {
    OutT* base = out + size_t(tl.l) * M * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row + 8 * h;
      if (gm >= M) continue;
      OutT* o = base + size_t(gm) * N;
#pragma unroll
      for (int j = 0; j < sm90::BN / 8; ++j) {
        const int gn = col + 8 * j;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (vec2) {  // N even: gn < N means gn + 1 < N
          if (gn < N) {
            if (!first) {
              const float2 a = sm90::load_pair(o + gn);
              v0 = a.x + v0;
              v1 = a.y + v1;
            }
            sm90::store_pair(o + gn, v0, v1);
          }
        } else {
          if (gn < N) {
            if (!first) v0 = to_float(o[gn]) + v0;
            store_out(o + gn, v0);
          }
          if (gn + 1 < N) {
            if (!first) v1 = to_float(o[gn + 1]) + v1;
            store_out(o + gn + 1, v1);
          }
        }
      }
    }
  }

  __device__ void copy(int thread, int threads) const {
    sm90::copy_span(w, w_dest, w_bytes, vec16_w, thread, threads);
    sm90::copy_span(x, x_dest, x_bytes, vec16_x, thread, threads);
  }
};

template <typename OutT>
__global__ void __launch_bounds__(sm90::THREADS, 1)
cannon_bf16_kernel(const __grid_constant__ CUtensorMap mw,
                   const __grid_constant__ CUtensorMap mx,
                   CannonStep<OutT> st) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  CannonStep<OutT> p = st;
  p.mw = &mw;
  p.mx = &mx;
  sm90::run(p, smem_raw);
}

template <typename OutT>
int launch_bf16(const void* w, const void* x, void* out, void* w_dest,
                void* x_dest, int L, int M, int N, int K, int ld_w, int ld_x,
                int first, int vec2, int vec16_w, int vec16_x,
                cudaStream_t s) {
  auto kernel = cannon_bf16_kernel<OutT>;
  static const int reg_err = sm90::check_registers(kernel);
  if (reg_err != 0) return reg_err;
  CUtensorMap mw, mx;
  if (sm90::make_map(&mw, w, K, M, 1, ld_w, 64, 128) != 0 ||
      sm90::make_map(&mx, x, N, K, L, ld_x, 64, 64) != 0)
    return sm90::TENSOR_MAP_ERROR;
  CannonStep<OutT> st;
  st.mw = st.mx = nullptr;
  st.w = w;
  st.x = x;
  st.out = static_cast<OutT*>(out);
  st.w_dest = w_dest;
  st.x_dest = x_dest;
  st.w_bytes = size_t(M) * ld_w * 2;
  st.x_bytes = size_t(L) * K * ld_x * 2;
  st.M = M;
  st.N = N;
  st.K = K;
  st.L = L;
  st.first = first;
  st.tiles_n = (N + sm90::BN - 1) / sm90::BN;
  st.tiles_mn = ((M + sm90::BM - 1) / sm90::BM) * st.tiles_n;
  st.vec2 = vec2;
  st.vec16_w = vec16_w;
  st.vec16_x = vec16_x;
  const int grid = sm90::grid_size(L * st.tiles_mn,
                                   w_dest != nullptr || x_dest != nullptr);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(sm90::SMEM_BYTES));
  if (e != cudaSuccess) return int(e);
  kernel<<<grid, sm90::THREADS, sm90::SMEM_BYTES, s>>>(mw, mx, st);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: exact FMA on the CUDA cores (gemm_core.cuh), unchanged
// ---------------------------------------------------------------------------

// The blocks of one f32 launch: n_gemm output tiles (l-major, then row
// tiles, then column tiles), then n_copy blocks that copy w to w_dest and
// x to x_dest (either may be null).
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
               int first, int vec16_w, int vec16_x) {
  Step st;
  st.w_dest = w_dest;
  st.x_dest = x_dest;
  st.w_bytes = size_t(M) * K * sizeof(float);
  st.x_bytes = size_t(L) * K * N * sizeof(float);
  st.M = M;
  st.N = N;
  st.K = K;
  st.first = first;
  st.tiles_n = (N + gemm::FBN - 1) / gemm::FBN;
  st.tiles_mn = ((M + gemm::FBM - 1) / gemm::FBM) * st.tiles_n;
  st.n_gemm = L * st.tiles_mn;
  size_t hop = 0;
  if (w_dest != nullptr) hop += st.w_bytes;
  if (x_dest != nullptr) hop += st.x_bytes;
  st.n_copy = hop ? gemm::copy_blocks(hop) : 0;
  st.vec16_w = vec16_w;
  st.vec16_x = vec16_x;
  return st;
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
// launch, or sm90::TENSOR_MAP_ERROR / sm90::REGISTER_ERROR; the caller
// raises on anything but 0.  w [M, K] (row stride ld_w), x [L, K, N] (row
// stride ld_x, batch stride K * ld_x), out [L, M, N] contiguous; w_dest
// and x_dest the predecessors' slots in the same layout as w and x, or
// null (the last step).  first: out is not read (step 0).  out_bf16: out
// is bf16, else f32.  vec2: N is even and out's base 8-byte aligned (pairs
// of columns per access).  vec16_w / vec16_x: the hops' width.  The f32
// entry point takes w, x and the slots contiguous.
// ---------------------------------------------------------------------------

extern "C" int cannon_bf16(const void* w, const void* x, void* out,
                           void* w_dest, void* x_dest, int L, int M, int N,
                           int K, int ld_w, int ld_x, int first, int out_bf16,
                           int vec2, int vec16_w, int vec16_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_bf16<bf16>(w, x, out, w_dest, x_dest, L, M, N, K, ld_w,
                             ld_x, first, vec2, vec16_w, vec16_x, s);
  return launch_bf16<float>(w, x, out, w_dest, x_dest, L, M, N, K, ld_w, ld_x,
                            first, vec2, vec16_w, vec16_x, s);
}

extern "C" int cannon_f32(const void* w, const void* x, void* out,
                          void* w_dest, void* x_dest, int L, int M, int N,
                          int K, int first, int out_bf16, int vec16_w,
                          int vec16_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Step st = make_step(w_dest, x_dest, L, M, N, K, first, vec16_w,
                            vec16_x);
  if (out_bf16) return launch_f32<bf16>(w, x, out, st, s);
  return launch_f32<float>(w, x, out, st, s);
}

// Attributes of a kernel variant (sm90::kernel_attrs: registers, local
// bytes, static and dynamic shared bytes, block size): bf16 operands with
// an f32 or bf16 out, or the f32 kernel (f32 = 1).
extern "C" int cannon_attrs(int f32, int out_bf16, int* out) {
  if (f32)
    return out_bf16 ? sm90::kernel_attrs(cannon_f32_kernel<bf16>, 0, out)
                    : sm90::kernel_attrs(cannon_f32_kernel<float>, 0, out);
  return out_bf16 ? sm90::kernel_attrs(cannon_bf16_kernel<bf16>,
                                       sm90::SMEM_BYTES, out)
                  : sm90::kernel_attrs(cannon_bf16_kernel<float>,
                                       sm90::SMEM_BYTES, out);
}

extern "C" const char* cannon_error_string(int err) {
  if (err == sm90::TENSOR_MAP_ERROR)
    return "cuTensorMapEncodeTiled refused an operand";
  if (err == sm90::REGISTER_ERROR)
    return "the kernel's register count leaves setmaxnreg no room";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
