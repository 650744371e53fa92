// gemm_core.cuh -- the tile main loops shared by the port's GEMM kernels
// (block_matmul.cu, wx.cu, ring.cu, cannon.cu): one [128 x 128] f32 tile of
// A @ B.T, with
// A [M, K] read from `a`, stored [M, K] (K contiguous) or [K, M] (AT), and
// B [N, K] read from `b`, stored [N, K] or [K, N] (BT).  The kernels add
// their own epilogues.
//
//   * bf16: 8 warps, each 64 x 32 of the tile; K in steps of 32 through a
//     3-stage cp.async ring in shared memory; WMMA 16x16x16 bf16 fragments
//     (mma.sync on the tensor cores) with f32 accumulators.  A K-contiguous
//     operand lands in shared memory as [128 rows][32 k], an M- or
//     N-contiguous one as [32 k][128 rows], and the fragment is loaded
//     row_major or col_major to match.  The finished tile is left in shared
//     memory as f32 [128][LDC].
//   * f32: exact f32 FMA on the CUDA cores (no TF32), each thread 8 x 8
//     outputs held in registers; K runs in order per output element.
//   * Ragged edges: rows past M/N and k past K are zero-filled in shared
//     memory (cp.async with src-size 0); the epilogues mask the store.
//   * The K order of every output element is fixed by K alone (the same
//     k-tiles in the same order, no split-K), so a row does not depend on
//     how many rows share the launch, and results repeat bit for bit.
//   * copy_bytes: the hop of a ring or Cannon step, done by the launch's
//     copy blocks beside its GEMM blocks.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace gemm {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// ---------------------------------------------------------------------------
// bf16 operands: tensor cores through WMMA
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
static_assert(BM == BN, "one tile shape serves both operands");
constexpr int LDK = BK + 8;  // [rows][k] tile stride: 80 B rows keep every
                             // fragment pointer 32 B aligned
constexpr int LDR = BM + 8;  // [k][rows] tile stride: 272 B rows, likewise
constexpr int LDC = BN + 4;  // f32 result tile stride in floats
constexpr int OPERAND_ELEMS = BM * LDK > BK * LDR ? BM * LDK : BK * LDR;
constexpr int STAGE_ELEMS = 2 * OPERAND_ELEMS;
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

// One [R x C] tile of a row-major operand g [rows, cols] (cols contiguous,
// so the row stride is cols) from (r0, c0) into shared memory at row stride
// lds.  VE = elements per copy; cols % VE == 0, so a copy is either wholly
// inside the matrix or wholly outside (zero-filled).
template <int VE, int R, int C>
__device__ __forceinline__ void load_tile(bf16* s, int lds, const bf16* g,
                                          int rows, int cols, int r0, int c0,
                                          int tid) {
  constexpr int CPR = C / VE;  // copies per tile row
  constexpr int TOTAL = R * CPR;
#pragma unroll
  for (int c = tid; c < TOTAL; c += THREADS) {
    const int r = c / CPR, cc = (c % CPR) * VE;
    const int gr = r0 + r, gc = c0 + cc;
    const bool ok = gr < rows && gc < cols;
    const bf16* src = ok ? g + size_t(gr) * cols + gc : g;
    bf16* dst = s + r * lds + cc;
    if constexpr (VE == 1) {
      *dst = ok ? *src : __float2bfloat16(0.0f);
    } else {
      cp_async<VE * 2>(dst, src, ok);
    }
  }
}

// The k-tile at k0 of one operand (`rows` = M for A, N for B): from a
// K-contiguous store [rows, K] into a [128][LDK] tile, or from a
// rows-contiguous store [K, rows] into a [BK][LDR] tile.
template <int VE, bool T>
__device__ __forceinline__ void load_operand(bf16* s, const bf16* g, int rows,
                                             int K, int row0, int k0,
                                             int tid) {
  if constexpr (T) {
    load_tile<VE, BK, BM>(s, LDR, g, K, rows, k0, row0, tid);
  } else {
    load_tile<VE, BM, BK>(s, LDK, g, rows, K, row0, k0, tid);
  }
}

// The f32 tile (m0, n0) of A @ B.T into shared memory: on return, smem_raw
// holds it as float [BM][LDC], visible to every thread of the block.
// smem_raw must hold SMEM_BF16 bytes, 128-byte aligned.
template <int VE, bool AT, bool BT>
__device__ __forceinline__ void bf16_tile(const bf16* __restrict__ a,
                                          const bf16* __restrict__ b, int M,
                                          int N, int K, int m0, int n0,
                                          unsigned char* smem_raw) {
  // A [m][k] from a [k][m] tile is a col-major fragment; B.T [k][n] from a
  // [n][k] tile is col-major, from a [k][n] tile row-major.
  using ALayout = std::conditional_t<AT, wmma::col_major, wmma::row_major>;
  using BLayout = std::conditional_t<BT, wmma::row_major, wmma::col_major>;
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps, each 64 x 32
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
      load_operand<VE, AT>(st, a, M, K, m0, s * BK, tid);
      load_operand<VE, BT>(st + OPERAND_ELEMS, b, N, K, n0, s * BK, tid);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // k-tile kt has landed
    __syncthreads();              // ...for every thread; stage kt-1 is free
    const int pf = kt + STAGES - 1;
    if (pf < nk) {
      bf16* st = smem + (pf % STAGES) * STAGE_ELEMS;
      load_operand<VE, AT>(st, a, M, K, m0, pf * BK, tid);
      load_operand<VE, BT>(st + OPERAND_ELEMS, b, N, K, n0, pf * BK, tid);
    }
    cp_async_commit();

    const bf16* As = smem + (kt % STAGES) * STAGE_ELEMS;
    const bf16* Bs = As + OPERAND_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16;
        if constexpr (AT) {
          wmma::load_matrix_sync(fa[i], As + kk * LDR + r, LDR);
        } else {
          wmma::load_matrix_sync(fa[i], As + r * LDK + kk, LDK);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * 32 + j * 16;
        if constexpr (BT) {
          wmma::load_matrix_sync(fb[j], Bs + kk * LDR + c, LDR);
        } else {
          wmma::load_matrix_sync(fb[j], Bs + c * LDK + kk, LDK);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
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
}

// ---------------------------------------------------------------------------
// f32 operands: exact FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int FBM = 128, FBN = 128, FBK = 8, FTHREADS = 256;
constexpr int FLD = FBM + 4;  // 528 B rows: float4 reads stay aligned

// Fill Ts[k][r] (r < 128 rows of the tile at row0, k < FBK at k0) from an
// operand stored [rows, K] (T = false) or [K, rows] (T = true); each thread
// loads 4 values, neighbouring threads along the contiguous dimension.
template <bool T>
__device__ __forceinline__ void load_f32(float (*Ts)[FLD], const float* g,
                                         int rows, int K, int row0, int k0,
                                         int tid) {
  if constexpr (T) {
    const int r = tid % FBM, kb = (tid / FBM) * 4;
    const int gr = row0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + kb + j;
      Ts[kb + j][r] = (gr < rows && gk < K) ? g[size_t(gk) * rows + gr]
                                            : 0.0f;
    }
  } else {
    const int r = tid / 2, kb = (tid % 2) * 4;
    const int gr = row0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + kb + j;
      Ts[kb + j][r] = (gr < rows && gk < K) ? g[size_t(gr) * K + gk] : 0.0f;
    }
  }
}

// The f32 tile (m0, n0) of A @ B.T into registers: thread (tx, ty) =
// (tid % 16, tid / 16) holds rows m0 + ty*8 + [0, 8) and columns
// n0 + tx*8 + [0, 8) in acc.  As and Bs are the block's shared k-major
// staging tiles.
template <bool AT, bool BT>
__device__ __forceinline__ void f32_tile(const float* __restrict__ a,
                                         const float* __restrict__ b, int M,
                                         int N, int K, int m0, int n0,
                                         float (*As)[FLD], float (*Bs)[FLD],
                                         float (&acc)[8][8]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;      // 16 x 16 threads, 8 x 8 each
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
    load_f32<AT>(As, a, M, K, m0, k0, tid);
    load_f32<BT>(Bs, b, N, K, n0, k0, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float av[8], bv[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8 + 4]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// copies: a step's hop into a peer's receive slot
// ---------------------------------------------------------------------------

// Blocks [0, nblocks) of a launch's copy part copy nbytes from src to dst:
// 16 bytes a thread where vec16 (nbytes, src and dst 16-byte aligned), else
// 2 bytes a thread (nbytes even).  blockDim.x threads each.
__device__ __forceinline__ void copy_bytes(const void* src, void* dst,
                                           size_t nbytes, int vec16, int blk,
                                           int nblocks) {
  const size_t stride = size_t(nblocks) * blockDim.x;
  const size_t start = size_t(blk) * blockDim.x + threadIdx.x;
  if (vec16) {
    const int4* s = static_cast<const int4*>(src);
    int4* d = static_cast<int4*>(dst);
    for (size_t i = start; i < nbytes / 16; i += stride) d[i] = s[i];
  } else {
    const unsigned short* s = static_cast<const unsigned short*>(src);
    unsigned short* d = static_cast<unsigned short*>(dst);
    for (size_t i = start; i < nbytes / 2; i += stride) d[i] = s[i];
  }
}

// Copy blocks for nbytes: up to 2 per SM, 256 threads of 16 bytes each.
inline int copy_blocks(size_t nbytes) {
  const size_t per = size_t(THREADS) * 16;
  const size_t n = (nbytes + per - 1) / per;
  return int(n < 264 ? n : 264);
}

}  // namespace gemm
