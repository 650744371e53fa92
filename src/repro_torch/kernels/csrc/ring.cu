// ring.cu -- the 1-D Jigsaw ring for Hopper (sm_90a): one ring step of one
// rank per launch, forward and backward, plus the receive slots the steps
// write into and their CUDA IPC mapping.
//
// Replaces the TPU kernels kernels/fused_ring.py::_ring_fwd_kernel
// (pallas_call in _ring_fwd_tpu) and ::_ring_bwd_kernel (pallas_call in
// _ring_bwd_tpu) of the JAX package, reached through fused_ring_matmul
// under impl="ring_fused".  The TPU kernel is one pallas_call over p grid
// steps with remote DMAs between neighbours; here each of the p steps is
// one launch, and a hop is a store through a pointer into the successor's
// receive slot (its own memory on the same card, peer memory over NVLink on
// another card: the kernel code is the same).
//
// Forward step s of rank `my` (x [R, Dl] the rank's activation block,
// w [M, Dl] its weight block, MC = M / p, chunk j = (my - 1 - s) mod p):
//   y    = x @ w[j*MC:(j+1)*MC].T        f32 sum, block_matmul's K order
//   y    = acc(wire(y))                  wire = x.dtype, acc = accum dtype
//   tot  = acc(acc(prev) + y)            prev: the partial that arrived in
//                                        this rank's slot (s-1) % 2 (none
//                                        at s = 0)
//   dest = wire(tot)                     dest: the successor's slot s % 2
//                                        while s < p-1; the rank's output
//                                        chunk at s = p-1
// The cast points are ring_reduce_scatter's (the reference's
// fused_ring.py:224-227, :262-269), so the result is bit for bit the
// `ring` of block_matmul's product: a column chunk of that product is the
// chunk product, the same k-tiles in the same order.
//
// Backward step s (dy chunks ride the ring in the all-gather direction;
// cur = dy [R, MC] at s = 0, else the chunk that arrived in slot
// (s-1) % 2, which is rank j = (my - s) mod p's):
//   dw[j*MC:(j+1)*MC] = cur.T @ x        [MC, Dl], K = R, in cur's dtype:
//                                        block_matmul's dw of the gathered
//                                        cotangent, bit for bit
//   dx_acc (+)= cur @ w[j*MC:(j+1)*MC]   [R, Dl] f32, K = MC (= at s = 0)
//   dx = x.dtype(dx_acc)                 at s = p-1
//   fwd = cur                            the successor's slot s % 2, s < p-1
// One launch does all three: its blocks are the dw tiles, then the dx
// tiles, then the blocks that copy cur.  dx sums over m in another order
// than a monolithic dx GEMM (per chunk, then across chunks in f32), as the
// reference documents for its TPU kernel (fused_ring.py:362-365).
//
// Slot discipline (the counterpart of fused_ring.py:203-212).  Each rank
// owns two receive slots; at step s it reads its own slot (s-1) % 2 and
// writes its successor's slot s % 2.  Before every step the caller
// synchronises its stream and then meets the group at a barrier (one
// process per rank), or orders the launches of all ranks on one stream
// (one process holding every rank).  So:
//   * a slot is read only after the write into it has finished: the write
//     was step s-1's, and every rank's step s-1 completed before the
//     barrier;
//   * a slot is rewritten only after its last read: the successor read
//     its slot s % 2 at step s-1 (it holds step s-2's write), before the
//     barrier of step s;
//   * the barrier before step 0 orders one ring call after the previous
//     one, whose last step may still read the slot the next call's first
//     step writes.
// No flags or credits are needed; the price is one host synchronisation
// and one barrier per step.  A persistent one-launch form with device-side
// flags, hops overlapping the next chunk's GEMM, is later work.
//
// The slots are a raw cudaMalloc (not a tensor of torch's caching
// allocator, whose blocks are offsets into larger segments), exported with
// cudaIpcGetMemHandle; each rank opens its successor's handle with
// cudaIpcOpenMemHandle, which works between processes on one card and
// between peer cards alike.
//
// Bound: at weathermixer-1b's full width every step is a GEMM of 1,000+
// FLOP per byte it must move (the hop is R x MC in the wire dtype, read
// once and written once), above the ~295 FLOP/byte ridge: tensor-core
// FLOPs bound it.  The f32 variants run gemm_core.cuh's exact FMA loop on
// the CUDA cores.
//
// What the bf16 design does about the bound: both steps run the Hopper
// loop of gemm_sm90.cuh, wgmma fed by a TMA producer warp through a
// 4-stage mbarrier ring of [128 x 256] tiles, one persistent 384-thread
// block per SM walking the launch's tiles, the epilogue from the
// accumulator registers.  Each operand has its own row stride `ld` (a
// multiple of 8 elements, which TMA takes), so one operand's odd rows
// (tok_fc1's x and w: 8,190 or 4,095 bf16; tok_fc2's dy) cost its own
// padding, not every operand's load width: the caller pads x, w and dy
// once per ring call where their rows need it, and the backward's receive
// slots hold cur in that layout.
//   * Forward: the chunk product's tiles in bands of 8 rows of tiles
//     (sm90::grouped_tile), x and w_j both K-major; the epilogue runs the
//     cast chain above on the accumulators and stores tot straight into
//     the successor's slot (or the output), in bf16 pairs where MC is
//     even.  Bit for bit the ring of block_matmul's products: the same k16
//     steps, 2 * ceil(K / 32), in K order, the same roundings.
//   * Backward: the long dw tiles (K = R) first and the short dx tiles (K
//     = MC) after them, so that the dx tiles fill the dw tiles' last wave.
//     dw is bit for bit block_matmul's dw of the gathered cotangent and
//     dx's f32 accumulator bit for bit wx's step loop (acc = wx(cur,
//     w_j[None], acc)): the same k16 steps in the same K order, the same
//     roundings.  The hop is copied by the producer warpgroup's three idle
//     warps while the consumers compute.
//
// Left for later: a single persistent launch per ring.

#include "gemm_core.cuh"
#include "gemm_sm90.cuh"

#include <string.h>

namespace {

using gemm::bf16;
using gemm::to_float;

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// fwd's cast chain for one output element: y is the f32 chunk product, a
// the arrived partial (read as f32) when has_prev; returns tot, which the
// caller rounds to the wire dtype T.
template <typename T>
__device__ __forceinline__ float fwd_total(float y, float a, bool has_prev,
                                           bool acc_bf16) {
  float v = to_float(from_float<T>(y));        // y.astype(wire)
  if (acc_bf16) v = round_bf16(v);             // .astype(acc)
  if (has_prev) {
    if (acc_bf16) a = round_bf16(a);           // prev.astype(acc)
    v = a + v;
    if (acc_bf16) v = round_bf16(v);
  }
  return v;
}

// One output element of a forward step: dest[o] = tot.astype(wire).
template <typename T>
__device__ __forceinline__ void fwd_store(float y, const T* prev, T* dest,
                                          size_t o, bool acc_bf16) {
  const bool has_prev = prev != nullptr;
  dest[o] = from_float<T>(
      fwd_total<T>(y, has_prev ? to_float(prev[o]) : 0.0f, has_prev,
                   acc_bf16));
}

// One element of the dx accumulator: v is this step's f32 product.
template <typename T>
__device__ __forceinline__ void dx_store(float v, float* dx_acc, T* dx,
                                         size_t o, bool first, bool last) {
  if (!first) v = dx_acc[o] + v;
  dx_acc[o] = v;
  if (last) dx[o] = from_float<T>(v);
}

// ---------------------------------------------------------------------------
// bf16: the Hopper loop (gemm_sm90.cuh)
// ---------------------------------------------------------------------------

// The bf16 forward step on the Hopper loop.  Tiles: the chunk product y
// [R, MC] in sm90::grouped_tile's bands; A = x [R, K], K-major (row stride
// ld_x); B = w_j [MC, K], K-major (row stride ld_w), read with transpose-B
// off, as block_matmul's forward.  The epilogue is fwd_store's cast chain
// on the accumulator registers, written straight to dest (the successor's
// slot, or the output): the store is the hop.  prev and dest are
// contiguous [R, MC].
struct RingFwdStep {
  static constexpr bool B_KMAJOR = true;
  const CUtensorMap* m_x;
  const CUtensorMap* m_wj;
  const bf16* prev;
  bf16* dest;
  int R, MC, K, tiles_m, tiles_n, acc_bf16, vec2;

  __device__ int tiles() const { return tiles_m * tiles_n; }

  __device__ sm90::Tile tile(int t) const {
    int tm, tn;
    sm90::grouped_tile(t, tiles_m, tiles_n, tm, tn);
    return {0, tm * sm90::BM, tn * sm90::BN, 0, K};
  }

  __device__ bool a_mn(int) const { return false; }

  __device__ void load(const sm90::Tile& tl, int k0, uint32_t a, uint32_t b,
                       uint32_t bar) const {
    sm90::tma_load(a, m_x, k0, tl.m0, 0, bar);
    sm90::tma_load(b, m_wj, k0, tl.n0, 0, bar);
    sm90::tma_load(b + 2 * sm90::BOX_BYTES, m_wj, k0, tl.n0 + 128, 0, bar);
  }

  __device__ void store(const sm90::Tile&, const float (&acc)[sm90::ACC],
                        int row, int col) const {
    const bool has_prev = prev != nullptr, ab = acc_bf16 != 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row + 8 * h;
      if (gm >= R) continue;
      const size_t o = size_t(gm) * MC;
#pragma unroll
      for (int j = 0; j < sm90::BN / 8; ++j) {
        const int gn = col + 8 * j;
        if (gn >= MC) continue;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (vec2) {  // MC even: gn < MC means gn + 1 < MC
          const float2 a = has_prev ? sm90::load_pair(prev + o + gn)
                                    : make_float2(0.0f, 0.0f);
          sm90::store_pair(dest + o + gn,
                           fwd_total<bf16>(v0, a.x, has_prev, ab),
                           fwd_total<bf16>(v1, a.y, has_prev, ab));
        } else {
          fwd_store(v0, prev, dest, o + gn, ab);
          if (gn + 1 < MC) fwd_store(v1, prev, dest, o + gn + 1, ab);
        }
      }
    }
  }

  __device__ void copy(int, int) const {}
};

__global__ void __launch_bounds__(sm90::THREADS, 1)
ring_fwd_bf16_kernel(const __grid_constant__ CUtensorMap m_x,
                     const __grid_constant__ CUtensorMap m_wj,
                     RingFwdStep st) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  RingFwdStep p = st;
  p.m_x = &m_x;
  p.m_wj = &m_wj;
  sm90::run(p, smem_raw);
}

int launch_fwd_bf16(const void* x, const void* wj, const void* prev,
                    void* dest, int R, int MC, int K, int ld_x, int ld_w,
                    int acc_bf16, int vec2, cudaStream_t s) {
  auto kernel = ring_fwd_bf16_kernel;
  static const int reg_err = sm90::check_registers(kernel);
  if (reg_err != 0) return reg_err;
  CUtensorMap m_x, m_wj;
  if (sm90::make_map(&m_x, x, K, R, 1, ld_x, 64, 128) != 0 ||
      sm90::make_map(&m_wj, wj, K, MC, 1, ld_w, 64, 128) != 0)
    return sm90::TENSOR_MAP_ERROR;
  RingFwdStep st;
  st.m_x = st.m_wj = nullptr;
  st.prev = static_cast<const bf16*>(prev);
  st.dest = static_cast<bf16*>(dest);
  st.R = R;
  st.MC = MC;
  st.K = K;
  st.tiles_m = (R + sm90::BM - 1) / sm90::BM;
  st.tiles_n = (MC + sm90::BN - 1) / sm90::BN;
  st.acc_bf16 = acc_bf16;
  st.vec2 = vec2;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(sm90::SMEM_BYTES));
  if (e != cudaSuccess) return int(e);
  kernel<<<sm90::grid_size(st.tiles_m * st.tiles_n, false), sm90::THREADS,
           sm90::SMEM_BYTES, s>>>(m_x, m_wj, st);
  return int(cudaGetLastError());
}

// The bf16 backward step on the Hopper loop (gemm_sm90.cuh).  Tiles: the
// dw tiles of dw_j [MC, D] (A = cur read as [K = R, M = MC], M-major; B =
// x [R, D], N-major), then the dx tiles of dx [R, D] (A = cur [R, MC],
// K-major; B = w_j [MC, D], N-major); tiles_n column tiles per row of
// tiles in both.  cur, x and w_j carry their own row strides (the tensor
// maps'); dw_j, dx_acc and dx are contiguous with rows of D.
struct RingBwdStep {
  const CUtensorMap* m_cur_mn;
  const CUtensorMap* m_x;
  const CUtensorMap* m_cur_k;
  const CUtensorMap* m_wj;
  const void* cur;
  void* fwd;
  size_t cur_bytes;
  float* dx_acc;
  bf16* dx;
  bf16* dw_j;
  int R, D, MC, first, last, n_dw, n_dx, tiles_n, vec2, vec16;

  __device__ int tiles() const { return n_dw + n_dx; }

  __device__ sm90::Tile tile(int t) const {
    const int kind = t < n_dw ? 0 : 1;
    const int b = kind ? t - n_dw : t;
    return {kind, (b / tiles_n) * sm90::BM, (b % tiles_n) * sm90::BN, 0,
            kind ? MC : R};
  }

  __device__ bool a_mn(int kind) const { return kind == 0; }
  static constexpr bool B_KMAJOR = false;

  __device__ void load(const sm90::Tile& tl, int k0, uint32_t a, uint32_t b,
                       uint32_t bar) const {
    const CUtensorMap* mb = tl.kind ? m_wj : m_x;
    if (tl.kind) {
      sm90::tma_load(a, m_cur_k, k0, tl.m0, 0, bar);
    } else {
      sm90::tma_load(a, m_cur_mn, tl.m0, k0, 0, bar);
      sm90::tma_load(a + sm90::BOX_BYTES, m_cur_mn, tl.m0 + 64, k0, 0, bar);
    }
#pragma unroll
    for (int i = 0; i < sm90::BN / 64; ++i)
      sm90::tma_load(b + i * sm90::BOX_BYTES, mb, tl.n0 + 64 * i, k0, 0, bar);
  }

  __device__ void store(const sm90::Tile& tl, const float (&acc)[sm90::ACC],
                        int row, int col) const {
    const int rows = tl.kind ? R : MC;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row + 8 * h;
      if (gm >= rows) continue;
      const size_t o = size_t(gm) * D;
#pragma unroll
      for (int j = 0; j < sm90::BN / 8; ++j) {
        const int gn = col + 8 * j;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (tl.kind == 0) {
          if (vec2) {  // D even: gn < D means gn + 1 < D
            if (gn < D) sm90::store_pair(dw_j + o + gn, v0, v1);
          } else {
            if (gn < D) dw_j[o + gn] = from_float<bf16>(v0);
            if (gn + 1 < D) dw_j[o + gn + 1] = from_float<bf16>(v1);
          }
        } else if (vec2) {
          if (gn < D) {
            float2 v = make_float2(v0, v1);
            if (!first) {
              const float2 a = sm90::load_pair(dx_acc + o + gn);
              v = make_float2(a.x + v0, a.y + v1);
            }
            sm90::store_pair(dx_acc + o + gn, v.x, v.y);
            if (last) sm90::store_pair(dx + o + gn, v.x, v.y);
          }
        } else {
          if (gn < D) dx_store(v0, dx_acc, dx, o + gn, first != 0, last != 0);
          if (gn + 1 < D)
            dx_store(v1, dx_acc, dx, o + gn + 1, first != 0, last != 0);
        }
      }
    }
  }

  __device__ void copy(int thread, int threads) const {
    sm90::copy_span(cur, fwd, cur_bytes, vec16, thread, threads);
  }
};

__global__ void __launch_bounds__(sm90::THREADS, 1)
ring_bwd_bf16_kernel(const __grid_constant__ CUtensorMap m_cur_mn,
                     const __grid_constant__ CUtensorMap m_x,
                     const __grid_constant__ CUtensorMap m_cur_k,
                     const __grid_constant__ CUtensorMap m_wj,
                     RingBwdStep st) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  RingBwdStep p = st;
  p.m_cur_mn = &m_cur_mn;
  p.m_x = &m_x;
  p.m_cur_k = &m_cur_k;
  p.m_wj = &m_wj;
  sm90::run(p, smem_raw);
}

int launch_bwd_bf16(const void* x, const void* wj, const void* cur,
                    void* fwd, void* dx_acc, void* dx, void* dw_j, int R,
                    int D, int MC, int ld_x, int ld_w, int ld_c, int first,
                    int last, int vec2, int vec16, cudaStream_t s) {
  auto kernel = ring_bwd_bf16_kernel;
  static const int reg_err = sm90::check_registers(kernel);
  if (reg_err != 0) return reg_err;
  // the dx maps are not read when there is no dx (dx_acc null): they then
  // describe cur again
  const bool has_dx = dx_acc != nullptr;
  CUtensorMap m_cur_mn, m_x, m_cur_k, m_wj;
  if (sm90::make_map(&m_cur_mn, cur, MC, R, 1, ld_c, 64, 64) != 0 ||
      sm90::make_map(&m_x, x, D, R, 1, ld_x, 64, 64) != 0 ||
      sm90::make_map(&m_cur_k, cur, MC, R, 1, ld_c, 64, 128) != 0 ||
      sm90::make_map(&m_wj, has_dx ? wj : cur, has_dx ? D : MC,
                     has_dx ? MC : R, 1, has_dx ? ld_w : ld_c, 64, 64) != 0)
    return sm90::TENSOR_MAP_ERROR;
  RingBwdStep st;
  st.m_cur_mn = st.m_x = st.m_cur_k = st.m_wj = nullptr;
  st.cur = cur;
  st.fwd = fwd;
  st.cur_bytes = size_t(R) * ld_c * sizeof(bf16);
  st.dx_acc = static_cast<float*>(dx_acc);
  st.dx = static_cast<bf16*>(dx);
  st.dw_j = static_cast<bf16*>(dw_j);
  st.R = R;
  st.D = D;
  st.MC = MC;
  st.first = first;
  st.last = last;
  st.tiles_n = (D + sm90::BN - 1) / sm90::BN;
  st.n_dw = ((MC + sm90::BM - 1) / sm90::BM) * st.tiles_n;
  st.n_dx = has_dx ? ((R + sm90::BM - 1) / sm90::BM) * st.tiles_n : 0;
  st.vec2 = vec2;
  st.vec16 = vec16;
  const int grid = sm90::grid_size(st.n_dw + st.n_dx, fwd != nullptr);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(sm90::SMEM_BYTES));
  if (e != cudaSuccess) return int(e);
  kernel<<<grid, sm90::THREADS, sm90::SMEM_BYTES, s>>>(m_cur_mn, m_x, m_cur_k,
                                                       m_wj, st);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: exact FMA on the CUDA cores (gemm::f32_tile)
// ---------------------------------------------------------------------------

// Tiles: y [R, MC] in sm90::grouped_tile's bands, one [128 x 128] tile a
// block.
__global__ void __launch_bounds__(gemm::FTHREADS, 2)
ring_fwd_f32_kernel(const float* __restrict__ x,
                    const float* __restrict__ wj, const float* prev,
                    float* dest, int R, int MC, int K, int acc_bf16) {
  __shared__ __align__(16) gemm::F32Smem sm;
  const int tiles_m = (R + gemm::FBM - 1) / gemm::FBM;
  const int tiles_n = (MC + gemm::FBN - 1) / gemm::FBN;
  int tm, tn;
  sm90::grouped_tile(blockIdx.x, tiles_m, tiles_n, tm, tn);
  const int m0 = tm * gemm::FBM, n0 = tn * gemm::FBN;
  float acc[8][8];
  gemm::f32_tile<false, false>(x, wj, R, MC, K, m0, n0, sm, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + gemm::f32_row(i);
    if (gm >= R) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + gemm::f32_col(j);
      if (gn < MC)
        fwd_store(acc[i][j], prev, dest, size_t(gm) * MC + gn,
                  acc_bf16 != 0);
    }
  }
}

// Blocks: the dw tiles of dw_j [MC, D], then the dx tiles of dx [R, D],
// each in sm90::grouped_tile's bands, then n_copy blocks that copy cur to
// fwd.
__global__ void __launch_bounds__(gemm::FTHREADS, 2)
ring_bwd_f32_kernel(const float* __restrict__ x,
                    const float* __restrict__ wj, const float* cur,
                    float* fwd, float* dx_acc, float* dx, float* dw_j, int R,
                    int D, int MC, int first, int last, int n_dw, int n_dx,
                    int n_copy, int vec16) {
  __shared__ __align__(16) gemm::F32Smem sm;
  const int tiles_n = (D + gemm::FBN - 1) / gemm::FBN;
  int b = blockIdx.x;
  if (b >= n_dw + n_dx) {
    gemm::copy_bytes(cur, fwd, size_t(R) * MC * sizeof(float), vec16,
              b - n_dw - n_dx, n_copy);
    return;
  }
  const bool is_dw = b < n_dw;
  if (!is_dw) b -= n_dw;
  int tm, tn;
  sm90::grouped_tile(b, (is_dw ? n_dw : n_dx) / tiles_n, tiles_n, tm, tn);
  const int m0 = tm * gemm::FBM, n0 = tn * gemm::FBN;
  float acc[8][8];
  if (is_dw) {
    gemm::f32_tile<true, true>(cur, x, MC, D, R, m0, n0, sm, acc);
  } else {
    gemm::f32_tile<false, true>(cur, wj, R, D, MC, m0, n0, sm, acc);
  }
  const int rows = is_dw ? MC : R;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + gemm::f32_row(i);
    if (gm >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + gemm::f32_col(j);
      if (gn >= D) continue;
      const size_t o = size_t(gm) * D + gn;
      if (is_dw) {
        dw_j[o] = acc[i][j];
      } else {
        dx_store(acc[i][j], dx_acc, dx, o, first != 0, last != 0);
      }
    }
  }
}

// Tiles of a GEMM with R x C outputs in tiles of T x T.
inline int tiles(int rows, int cols, int t) {
  return ((rows + t - 1) / t) * ((cols + t - 1) / t);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (bound with ctypes).  Each returns a cudaError_t; the caller
// raises on anything but 0.  The w pointer is the whole block [M, K]; j
// selects the chunk of MC rows.  prev may be null (step 0); fwd may be null
// (the last backward step), and so may dx_acc / dx (no dx wanted: the
// encoder's input is data).  acc_bf16: the accumulator dtype is bf16.
// ---------------------------------------------------------------------------

// ring_fwd_bf16: x [R, K] (row stride ld_x), w [M, K] (row stride ld_w),
// prev and dest [R, MC] contiguous.  vec2: MC is even and prev, dest
// 4-byte aligned (pairs of columns per access).
extern "C" int ring_fwd_bf16(const void* x, const void* w, const void* prev,
                             void* dest, int R, int MC, int K, int j,
                             int ld_x, int ld_w, int acc_bf16, int vec2,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* wj = static_cast<const bf16*>(w) + size_t(j) * MC * ld_w;
  return launch_fwd_bf16(x, wj, prev, dest, R, MC, K, ld_x, ld_w, acc_bf16,
                         vec2, s);
}

extern "C" int ring_fwd_f32(const void* x, const void* w, const void* prev,
                            void* dest, int R, int MC, int K, int j,
                            int acc_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wj = static_cast<const float*>(w) + size_t(j) * MC * K;
  ring_fwd_f32_kernel<<<tiles(R, MC, gemm::FBM), gemm::FTHREADS, 0, s>>>(
      static_cast<const float*>(x), wj, static_cast<const float*>(prev),
      static_cast<float*>(dest), R, MC, K, acc_bf16);
  return int(cudaGetLastError());
}

// ring_bwd_bf16: x [R, D] (row stride ld_x), w [M, D] (row stride ld_w),
// cur [R, MC] (row stride ld_c) and fwd in cur's layout; dw [M, D], dx_acc
// and dx [R, D] contiguous.  vec2: D is even and dw, dx_acc, dx 8-byte
// aligned (pairs of columns per access); vec16: the hop's width.
extern "C" int ring_bwd_bf16(const void* x, const void* w, const void* cur,
                             void* fwd, void* dx_acc, void* dx, void* dw,
                             int R, int D, int MC, int j, int ld_x, int ld_w,
                             int ld_c, int first, int last, int vec2,
                             int vec16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* wj = static_cast<const bf16*>(w) + size_t(j) * MC * ld_w;
  void* dw_j = static_cast<bf16*>(dw) + size_t(j) * MC * D;
  return launch_bwd_bf16(x, wj, cur, fwd, dx_acc, dx, dw_j, R, D, MC, ld_x,
                         ld_w, ld_c, first, last, vec2, vec16, s);
}

extern "C" int ring_bwd_f32(const void* x, const void* w, const void* cur,
                            void* fwd, void* dx_acc, void* dx, void* dw,
                            int R, int D, int MC, int j, int first, int last,
                            int vec16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wj = static_cast<const float*>(w) + size_t(j) * MC * D;
  float* dw_j = static_cast<float*>(dw) + size_t(j) * MC * D;
  const int n_dw = tiles(MC, D, gemm::FBM);
  const int n_dx = dx_acc != nullptr ? tiles(R, D, gemm::FBM) : 0;
  const int n_copy =
      fwd != nullptr ? gemm::copy_blocks(size_t(R) * MC * sizeof(float)) : 0;
  ring_bwd_f32_kernel<<<n_dw + n_dx + n_copy, gemm::FTHREADS, 0, s>>>(
      static_cast<const float*>(x), wj, static_cast<const float*>(cur),
      static_cast<float*>(fwd), static_cast<float*>(dx_acc),
      static_cast<float*>(dx), dw_j, R, D, MC, first, last, n_dw, n_dx,
      n_copy, vec16);
  return int(cudaGetLastError());
}

// The receive slots: nbytes of device memory on `device`, exported for
// CUDA IPC (handle: ring_ipc_handle_bytes() bytes).
extern "C" int ring_slots_alloc(int device, size_t nbytes, void** ptr,
                                void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  err = cudaMalloc(ptr, nbytes);
  if (err != cudaSuccess) return int(err);
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, *ptr);
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
    return int(err);
  }
  memcpy(handle, &h, sizeof(h));
  return 0;
}

// Map another process's slots (its handle) into this one, on `device`.
extern "C" int ring_slots_open(int device, const void* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return int(cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int ring_slots_close(void* ptr) {
  return int(cudaIpcCloseMemHandle(ptr));
}

extern "C" int ring_slots_free(void* ptr) { return int(cudaFree(ptr)); }

extern "C" int ring_ipc_handle_bytes() {
  return int(sizeof(cudaIpcMemHandle_t));
}

// Attributes of a kernel (sm90::kernel_attrs: registers, local bytes,
// static and dynamic shared bytes, block size): 0 the bf16 backward, 1 the
// f32 backward, 2 the bf16 forward, 3 the f32 forward.
extern "C" int ring_attrs(int kernel, int* out) {
  switch (kernel) {
    case 0: return sm90::kernel_attrs(ring_bwd_bf16_kernel, sm90::SMEM_BYTES, out);
    case 1: return sm90::kernel_attrs(ring_bwd_f32_kernel, 0, out);
    case 2: return sm90::kernel_attrs(ring_fwd_bf16_kernel, sm90::SMEM_BYTES, out);
    case 3: return sm90::kernel_attrs(ring_fwd_f32_kernel, 0, out);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* ring_error_string(int err) {
  if (err == sm90::TENSOR_MAP_ERROR)
    return "cuTensorMapEncodeTiled refused an operand";
  if (err == sm90::REGISTER_ERROR)
    return "the kernel's register count leaves setmaxnreg no room";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
