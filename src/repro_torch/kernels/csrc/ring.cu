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
// FLOPs bound it, as they bound block_matmul, whose main loops
// (gemm_core.cuh) it runs.  The f32 variants run the exact FMA tiles.
//
// Left for later: wgmma and TMA, overlap of the hop with the GEMM, and a
// single persistent launch per ring.

#include "gemm_core.cuh"

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

// One output element of a forward step: y is the f32 chunk product.
template <typename T>
__device__ __forceinline__ void fwd_store(float y, const T* prev, T* dest,
                                          size_t o, bool acc_bf16) {
  float v = to_float(from_float<T>(y));        // y.astype(wire)
  if (acc_bf16) v = round_bf16(v);             // .astype(acc)
  if (prev != nullptr) {
    float a = to_float(prev[o]);               // prev.astype(acc)
    if (acc_bf16) a = round_bf16(a);
    v = a + v;
    if (acc_bf16) v = round_bf16(v);
  }
  dest[o] = from_float<T>(v);                  // tot.astype(wire)
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
// bf16: tensor cores through WMMA (gemm::bf16_tile)
// ---------------------------------------------------------------------------

template <int VE>
__global__ void __launch_bounds__(gemm::THREADS)
ring_fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wj,
                     const bf16* prev, bf16* dest, int R, int MC, int K,
                     int acc_bf16) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int m0 = blockIdx.y * gemm::BM, n0 = blockIdx.x * gemm::BN;
  gemm::bf16_tile<VE, false, false>(x, wj, R, MC, K, m0, n0, smem_raw);

  const float* Cs = reinterpret_cast<const float*>(smem_raw);
  for (int idx = threadIdx.x; idx < gemm::BM * gemm::BN;
       idx += gemm::THREADS) {
    const int r = idx / gemm::BN, c = idx % gemm::BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < R && gn < MC)
      fwd_store(Cs[r * gemm::LDC + c], prev, dest, size_t(gm) * MC + gn,
                acc_bf16 != 0);
  }
}

// Blocks: n_dw tiles of dw_j [MC, D] (tiles_n per row of tiles), then n_dx
// tiles of dx [R, D], then n_copy blocks copying cur to fwd.
template <int VE>
__global__ void __launch_bounds__(gemm::THREADS)
ring_bwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wj,
                     const bf16* cur, bf16* fwd, float* dx_acc, bf16* dx,
                     bf16* dw_j, int R, int D, int MC, int first, int last,
                     int n_dw, int n_dx, int n_copy, int vec16) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tiles_n = (D + gemm::BN - 1) / gemm::BN;
  int b = blockIdx.x;
  if (b >= n_dw + n_dx) {
    gemm::copy_bytes(cur, fwd, size_t(R) * MC * sizeof(bf16), vec16,
              b - n_dw - n_dx, n_copy);
    return;
  }
  const bool is_dw = b < n_dw;
  if (!is_dw) b -= n_dw;
  const int m0 = (b / tiles_n) * gemm::BM, n0 = (b % tiles_n) * gemm::BN;
  if (is_dw) {
    // dw_j = cur.T @ x: A = cur stored [R, MC] ([K, M]), B = x stored
    // [R, D] ([K, N]), K = R
    gemm::bf16_tile<VE, true, true>(cur, x, MC, D, R, m0, n0, smem_raw);
  } else {
    // dx += cur @ w_j: A = cur [R, MC] (K contiguous), B = w_j stored
    // [MC, D] ([K, N]), K = MC
    gemm::bf16_tile<VE, false, true>(cur, wj, R, D, MC, m0, n0, smem_raw);
  }
  const float* Cs = reinterpret_cast<const float*>(smem_raw);
  const int rows = is_dw ? MC : R;
  for (int idx = threadIdx.x; idx < gemm::BM * gemm::BN;
       idx += gemm::THREADS) {
    const int r = idx / gemm::BN, c = idx % gemm::BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < rows && gn < D) {
      const size_t o = size_t(gm) * D + gn;
      const float v = Cs[r * gemm::LDC + c];
      if (is_dw) {
        dw_j[o] = from_float<bf16>(v);
      } else {
        dx_store(v, dx_acc, dx, o, first != 0, last != 0);
      }
    }
  }
}

template <int VE>
cudaError_t launch_fwd_bf16(const void* x, const void* wj, const void* prev,
                            void* dest, int R, int MC, int K, int acc_bf16,
                            cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      ring_fwd_bf16_kernel<VE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(gemm::SMEM_BF16));
  if (err != cudaSuccess) return err;
  const dim3 grid((MC + gemm::BN - 1) / gemm::BN,
                  (R + gemm::BM - 1) / gemm::BM);
  ring_fwd_bf16_kernel<VE><<<grid, gemm::THREADS, gemm::SMEM_BF16, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wj),
      static_cast<const bf16*>(prev), static_cast<bf16*>(dest), R, MC, K,
      acc_bf16);
  return cudaGetLastError();
}

template <int VE>
cudaError_t launch_bwd_bf16(const void* x, const void* wj, const void* cur,
                            void* fwd, void* dx_acc, void* dx, void* dw_j,
                            int R, int D, int MC, int first, int last,
                            int n_dw, int n_dx, int n_copy, int vec16,
                            cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      ring_bwd_bf16_kernel<VE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(gemm::SMEM_BF16));
  if (err != cudaSuccess) return err;
  ring_bwd_bf16_kernel<VE>
      <<<n_dw + n_dx + n_copy, gemm::THREADS, gemm::SMEM_BF16, s>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(wj),
          static_cast<const bf16*>(cur), static_cast<bf16*>(fwd),
          static_cast<float*>(dx_acc), static_cast<bf16*>(dx),
          static_cast<bf16*>(dw_j), R, D, MC, first, last, n_dw, n_dx,
          n_copy, vec16);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: exact FMA on the CUDA cores (gemm::f32_tile)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(gemm::FTHREADS)
ring_fwd_f32_kernel(const float* __restrict__ x,
                    const float* __restrict__ wj, const float* prev,
                    float* dest, int R, int MC, int K, int acc_bf16) {
  __shared__ __align__(16) float As[gemm::FBK][gemm::FLD];
  __shared__ __align__(16) float Bs[gemm::FBK][gemm::FLD];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * gemm::FBM, n0 = blockIdx.x * gemm::FBN;
  float acc[8][8];
  gemm::f32_tile<false, false>(x, wj, R, MC, K, m0, n0, As, Bs, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty * 8 + i;
    if (gm >= R) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx * 8 + j;
      if (gn < MC)
        fwd_store(acc[i][j], prev, dest, size_t(gm) * MC + gn,
                  acc_bf16 != 0);
    }
  }
}

__global__ void __launch_bounds__(gemm::FTHREADS)
ring_bwd_f32_kernel(const float* __restrict__ x,
                    const float* __restrict__ wj, const float* cur,
                    float* fwd, float* dx_acc, float* dx, float* dw_j, int R,
                    int D, int MC, int first, int last, int n_dw, int n_dx,
                    int n_copy, int vec16) {
  __shared__ __align__(16) float As[gemm::FBK][gemm::FLD];
  __shared__ __align__(16) float Bs[gemm::FBK][gemm::FLD];
  const int tiles_n = (D + gemm::FBN - 1) / gemm::FBN;
  int b = blockIdx.x;
  if (b >= n_dw + n_dx) {
    gemm::copy_bytes(cur, fwd, size_t(R) * MC * sizeof(float), vec16,
              b - n_dw - n_dx, n_copy);
    return;
  }
  const bool is_dw = b < n_dw;
  if (!is_dw) b -= n_dw;
  const int m0 = (b / tiles_n) * gemm::FBM, n0 = (b % tiles_n) * gemm::FBN;
  float acc[8][8];
  if (is_dw) {
    gemm::f32_tile<true, true>(cur, x, MC, D, R, m0, n0, As, Bs, acc);
  } else {
    gemm::f32_tile<false, true>(cur, wj, R, D, MC, m0, n0, As, Bs, acc);
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int rows = is_dw ? MC : R;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty * 8 + i;
    if (gm >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx * 8 + j;
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

extern "C" int ring_fwd_bf16(const void* x, const void* w, const void* prev,
                             void* dest, int R, int MC, int K, int j,
                             int acc_bf16, int vec_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* wj = static_cast<const bf16*>(w) + size_t(j) * MC * K;
  switch (vec_bytes) {
    case 16: return launch_fwd_bf16<8>(x, wj, prev, dest, R, MC, K, acc_bf16, s);
    case 8: return launch_fwd_bf16<4>(x, wj, prev, dest, R, MC, K, acc_bf16, s);
    case 4: return launch_fwd_bf16<2>(x, wj, prev, dest, R, MC, K, acc_bf16, s);
    case 2: return launch_fwd_bf16<1>(x, wj, prev, dest, R, MC, K, acc_bf16, s);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" int ring_fwd_f32(const void* x, const void* w, const void* prev,
                            void* dest, int R, int MC, int K, int j,
                            int acc_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wj = static_cast<const float*>(w) + size_t(j) * MC * K;
  const dim3 grid((MC + gemm::FBN - 1) / gemm::FBN,
                  (R + gemm::FBM - 1) / gemm::FBM);
  ring_fwd_f32_kernel<<<grid, gemm::FTHREADS, 0, s>>>(
      static_cast<const float*>(x), wj, static_cast<const float*>(prev),
      static_cast<float*>(dest), R, MC, K, acc_bf16);
  return int(cudaGetLastError());
}

extern "C" int ring_bwd_bf16(const void* x, const void* w, const void* cur,
                             void* fwd, void* dx_acc, void* dx, void* dw,
                             int R, int D, int MC, int j, int first,
                             int last, int vec_bytes, int vec16,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* wj = static_cast<const bf16*>(w) + size_t(j) * MC * D;
  void* dw_j = static_cast<bf16*>(dw) + size_t(j) * MC * D;
  const int n_dw = tiles(MC, D, gemm::BM);
  const int n_dx = dx_acc != nullptr ? tiles(R, D, gemm::BM) : 0;
  const int n_copy =
      fwd != nullptr ? gemm::copy_blocks(size_t(R) * MC * sizeof(bf16)) : 0;
  switch (vec_bytes) {
    case 16: return launch_bwd_bf16<8>(x, wj, cur, fwd, dx_acc, dx, dw_j, R, D, MC, first, last, n_dw, n_dx, n_copy, vec16, s);
    case 8: return launch_bwd_bf16<4>(x, wj, cur, fwd, dx_acc, dx, dw_j, R, D, MC, first, last, n_dw, n_dx, n_copy, vec16, s);
    case 4: return launch_bwd_bf16<2>(x, wj, cur, fwd, dx_acc, dx, dw_j, R, D, MC, first, last, n_dw, n_dx, n_copy, vec16, s);
    case 2: return launch_bwd_bf16<1>(x, wj, cur, fwd, dx_acc, dx, dw_j, R, D, MC, first, last, n_dw, n_dx, n_copy, vec16, s);
    default: return int(cudaErrorInvalidValue);
  }
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

extern "C" const char* ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
