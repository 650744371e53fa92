// gemm_core.cuh -- the tile main loops shared by the port's GEMM kernels
// (block_matmul.cu, wx.cu, ring.cu, cannon.cu): one [128 x 128] f32 tile of
// A @ B.T, with
// A [M, K] read from `a`, stored [M, K] (K contiguous) or [K, M] (AT), and
// B [N, K] read from `b`, stored [N, K] or [K, N] (BT).  The kernels add
// their own epilogues.
//
//   * bf16 (block_matmul's route under 64 wide; the other bf16 launches
//     run gemm_sm90.cuh): 8 warps, each 64 x 32 of the tile; K in steps of
//     32 through a 3-stage cp.async ring in shared memory; WMMA 16x16x16
//     bf16 fragments (mma.sync on the tensor cores) with f32 accumulators.
//     A K-contiguous operand lands in shared memory as [128 rows][32 k], an
//     M- or N-contiguous one as [32 k][128 rows], and the fragment is
//     loaded row_major or col_major to match.  The finished tile is left in
//     shared memory as f32 [128][LDC].
//   * f32: exact f32 FMA on the CUDA cores (no TF32), each thread 8 x 8
//     outputs held in registers; K runs in order per output element, in
//     k-tiles of 16 through two shared-memory stages (below).
//   * Ragged edges: rows past M/N and k past K are zero-filled in shared
//     memory (cp.async with src-size 0, or zeros stored); the epilogues
//     mask the store.
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
//
// Bound: f32 FMAs on the CUDA cores (67 TFLOP/s on an H100 SXM; the
// tensor cores' TF32 would round the operands).  Each output is one fmaf
// chain over k in ascending order from 0.0f, 8 * ceil(K / 8) steps (k past
// K reads 0 in both operands, so no 0 * inf enters the chain): the chain
// of a loop in k-tiles of 8, whatever FBK, so a result's bits depend on K
// alone.
// What the design does about the bound:
//   * two shared-memory stages of FBK = 16: k-tile t+1 is fetched while t
//     computes, one __syncthreads per k-tile.  An operand stored [K, rows]
//     (k-major, T = true) lands by cp.async; one stored [rows, K] (T =
//     false) is loaded into registers and stored transposed after the
//     compute;
//   * 16-byte global loads where the base and the row stride allow (K % 4
//     == 0 for [rows, K], rows % 4 == 0 for [K, rows]), else 4 bytes, with
//     the same zeros;
//   * warps of 32 x 64 outputs: lane (lane / 8, lane % 8) holds 2 x 2
//     sub-tiles of 4 x 4 (rows 16 apart, columns 32 apart), so a warp's
//     float4 reads of a k-row touch 16 and 32 consecutive floats: no bank
//     conflicts, 64 FMAs per four shared reads;
//   * 33 KiB of static shared memory and at most 128 registers, so two
//     blocks share an SM.

constexpr int FBM = 128, FBN = 128, FBK = 16, FTHREADS = 256, FSTAGES = 2;
constexpr int FLD = FBM + 4;  // 528 B rows: float4 reads and cp.async
                              // destinations stay aligned, and a [rows, K]
                              // operand's transposed stores conflict at
                              // most two ways

// The block's shared staging: A and B k-tiles [k][rows] per stage.
struct F32Smem {
  float a[FSTAGES][FBK][FLD];
  float b[FSTAGES][FBK][FLD];
};

// Row (i < 8) and column (j < 8) within the [FBM x FBN] tile of the
// output this thread holds in acc[i][j].
__device__ __forceinline__ int f32_row(int i) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / 2) * 32 + (i / 4) * 16 + (lane / 8) * 4 + i % 4;
}
__device__ __forceinline__ int f32_col(int j) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % 2) * 64 + (j / 4) * 32 + (lane % 8) * 4 + j % 4;
}

// Start the k-tile at k0 of one operand (128 rows from row0) towards Ts
// [FBK][FLD]: stored [K, rows] (T), by cp.async straight into Ts; stored
// [rows, K], into this thread's registers r (two float4 along K), which
// f32_land stores.  Zeros past `rows` and K.  vec: 16-byte loads.
template <bool T>
__device__ __forceinline__ void f32_fetch(float (*Ts)[FLD], float4 (&r)[2],
                                          const float* g, int rows, int K,
                                          int row0, int k0, bool vec,
                                          int tid) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int idx = tid + c * FTHREADS;
    if constexpr (T) {
      const int kk = idx / 32, rr = (idx % 32) * 4;
      const int gk = k0 + kk, gr = row0 + rr;
      const float* p = g + size_t(gk) * rows + gr;
      if (vec) {
        const bool ok = gk < K && gr < rows;
        cp_async<16>(&Ts[kk][rr], ok ? p : g, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gk < K && gr + e < rows;
          cp_async<4>(&Ts[kk][rr + e], ok ? p + e : g, ok);
        }
      }
    } else {
      const int gr = row0 + idx / 4, gk = k0 + (idx % 4) * 4;
      const float* p = g + size_t(gr) * K + gk;
      if (vec) {
        r[c] = gr < rows && gk < K ? *reinterpret_cast<const float4*>(p)
                                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        const bool in = gr < rows;
        r[c].x = in && gk < K ? p[0] : 0.0f;
        r[c].y = in && gk + 1 < K ? p[1] : 0.0f;
        r[c].z = in && gk + 2 < K ? p[2] : 0.0f;
        r[c].w = in && gk + 3 < K ? p[3] : 0.0f;
      }
    }
  }
}

// Store a [rows, K] operand's registers (f32_fetch<false>) into Ts,
// transposed.
template <bool T>
__device__ __forceinline__ void f32_land(float (*Ts)[FLD],
                                         const float4 (&r)[2], int tid) {
  if constexpr (!T) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int idx = tid + c * FTHREADS;
      const int rr = idx / 4, kb = (idx % 4) * 4;
      Ts[kb][rr] = r[c].x;
      Ts[kb + 1][rr] = r[c].y;
      Ts[kb + 2][rr] = r[c].z;
      Ts[kb + 3][rr] = r[c].w;
    }
  }
}

// The f32 tile (m0, n0) of A @ B.T into registers: acc[i][j] is output
// (m0 + f32_row(i), n0 + f32_col(j)).  A [M, K] is read from a, stored
// [M, K] or [K, M] (AT); B [N, K] from b, stored [N, K] or [K, N] (BT).
template <bool AT, bool BT>
__device__ __forceinline__ void f32_tile(const float* __restrict__ a,
                                         const float* __restrict__ b, int M,
                                         int N, int K, int m0, int n0,
                                         F32Smem& sm, float (&acc)[8][8]) {
  const int tid = threadIdx.x;
  const bool va = (AT ? M : K) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vb = (BT ? N : K) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int ar = f32_row(0), bc = f32_col(0);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float4 ra[2], rb[2];
  const int nk = (K + FBK - 1) / FBK;
  f32_fetch<AT>(sm.a[0], ra, a, M, K, m0, 0, va, tid);
  f32_fetch<BT>(sm.b[0], rb, b, N, K, n0, 0, vb, tid);
  f32_land<AT>(sm.a[0], ra, tid);
  f32_land<BT>(sm.b[0], rb, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < nk;
    if (more) {
      f32_fetch<AT>(sm.a[cur ^ 1], ra, a, M, K, m0, (t + 1) * FBK, va, tid);
      f32_fetch<BT>(sm.b[cur ^ 1], rb, b, N, K, n0, (t + 1) * FBK, vb, tid);
      cp_async_commit();
    }
    // the last k-tile runs its second 8 steps only where some k of them is
    // below K: 8 * ceil(K / 8) steps in all
    const bool full = K - t * FBK > FBK / 2;
    const float(*As)[FLD] = sm.a[cur];
    const float(*Bs)[FLD] = sm.b[cur];
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      if (kk < FBK / 2 || full) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ar]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ar + 16]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][bc]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][bc + 32]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (more) {
      f32_land<AT>(sm.a[cur ^ 1], ra, tid);
      f32_land<BT>(sm.b[cur ^ 1], rb, tid);
      cp_async_wait<0>();
    }
    __syncthreads();  // stage cur ^ 1 is full, stage cur free
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
