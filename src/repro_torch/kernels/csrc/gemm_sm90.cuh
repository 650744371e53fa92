// gemm_sm90.cuh -- the Hopper main loop of the port's redesigned bf16 GEMM
// kernels (cannon.cu's step and ring.cu's backward step): a persistent,
// warp-specialised loop that feeds the tensor cores through TMA and
// mbarriers, with the epilogue straight from the accumulator registers.
//
//   * Block: 384 threads.  Warpgroups 0 and 1 are the consumers, each 64
//     rows of a [128 x 256] output tile; warpgroup 2 is the producer: its
//     first thread issues the TMA loads, its other three warps copy the
//     launch's hop (the ring's or Cannon's store into a peer's slot) while
//     the consumers compute.  setmaxnreg gives the consumers 232 registers
//     (128 of them accumulators) and the producer 40 (one block per SM:
//     193 KiB of shared memory).
//   * Pipeline: 4 stages of BK = 64, each an A tile [128 x 64] and a B tile
//     [64 x 256] bf16 in 128-byte-swizzled shared memory, with a full and
//     an empty mbarrier per stage.  A is K-major ([rows][k], one TMA box of
//     [128][64]) or M-major ([k][rows], two boxes of [64][64]); B is
//     N-major ([k][n], four boxes of [64][64]).  A [128 x 256] tile moves
//     48 KiB from L2 per k-tile of 4.2 MFLOP, a third less per FLOP than
//     a [128 x 128] one.  Every operand is read
//     through a 3-D tensor map {cols, rows, batch} whose row stride is the
//     operand's own `ld` (a multiple of 8 elements: TMA takes strides in
//     multiples of 16 bytes), and whose logical width is the operand's, so
//     TMA fills zeros past every edge as gemm_core.cuh's cp.async with
//     src-size 0 does.
//   * Arithmetic: wgmma.mma_async.m64n256k16 (f32 += bf16 x bf16) from
//     shared memory, accumulators zeroed and every k16 step issued with
//     scale-d = 1, as wmma::fill_fragment(0) and mma_sync in gemm_core.cuh.
//     Each output element gets the same k16 steps in the same K order as
//     gemm_core.cuh's bf16_tile: 2 * ceil(K / 32) of them (the last k-tile
//     of 64 may use only 2), no split-K, no atomics; so a result is bit for
//     bit the WMMA loop's wherever the two instructions round a k16 step
//     alike, which chip_smoke.py and the card tests check.
//   * Tiles: one block per SM walks tiles t = blockIdx.x, + gridDim.x, ...
//     in the order the problem lists them (the ring's long dw tiles first).
//     The producer runs ahead across tile boundaries, so the loads of the
//     next tile overlap the epilogue of this one.
//
// A problem P supplies, on the device:
//   int tiles() const;                     the output tiles of the launch
//   Tile tile(int t) const;                kind, m0, n0, l, K of tile t
//   bool a_mn(int kind) const;             A stored M-major for this kind
//   void load(const Tile&, int k0, uint32_t a, uint32_t b, uint32_t bar)
//                                          the TMA loads of one stage
//   void store(const Tile&, const float (&acc)[ACC], int row, int col)
//                                          the epilogue of this thread's
//                                          accumulators (below)
//   void copy(int thread, int threads) const;   the launch's hop
//
// Accumulator layout (wgmma m64nN): thread `lane` of warp w of consumer
// warpgroup g holds acc[4 j + 2 h + c] = C[row + 8 h][col + 8 j + c] for
// j < BN / 8, h, c < 2, where row = m0 + 64 g + 16 w + lane / 4 and
// col = n0 + 2 (lane % 4).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int CONSUMER_THREADS = 256, THREADS = 384;
constexpr int CONSUMER_WARPS = CONSUMER_THREADS / 32;
constexpr int COPY_THREADS = 96;  // producer warpgroup's warps 1-3
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ACC = BN / 2;                       // accumulators a thread
constexpr int BOX_BYTES = 64 * 64 * 2;            // one [64][64] bf16 box
constexpr int A_BYTES = BM * BK * 2;              // A of one stage
constexpr int B_BYTES = BK * BN * 2;              // B of one stage
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr size_t SMEM_BYTES =
    size_t(STAGES) * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + alignment

struct Tile {
  int kind, m0, n0, l, k;
};

// gemm_core.cuh's k16 steps for a reduction of length K, and the k-tiles
// of BK = 64 that hold them.
__host__ __device__ inline int k16_steps(int K) { return 2 * ((K + 31) / 32); }
__host__ __device__ inline int k_tiles(int K) { return (k16_steps(K) + 3) / 4; }

// ---------------------------------------------------------------------------
// PTX: shared addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// One box of a 3-D tensor map at element coordinates (c0, c1, c2) into
// shared memory at dst; completion is counted on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand at
// shared address addr (its swizzle atom 1024-byte aligned); lbo and sbo in
// bytes.  K-major: sbo = 1024 (8 rows of 128 B), lbo unused.  MN-major:
// lbo = the stride between 64-element blocks along M or N, sbo = 1024 (8
// k-rows of 128 B).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d += A [64 x 16] @ B [16 x 256], A K-major (TA = 0) or M-major (TA = 1),
// B N-major; scale-d = 1 on every step.
template <int TA>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[ACC], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, "
      "%128, %129, p, 1, 1, %131, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// ---------------------------------------------------------------------------
// one k-tile of a consumer warpgroup: `four` k16 steps, else the first two
// ---------------------------------------------------------------------------

// Issue (and commit as one group) the k16 steps of the k-tile at a (A) and
// b (B).  Warpgroup g's 64 rows of A start BOX_BYTES * g into the A tile
// in both layouts (64 K-major rows of 128 B, or the second [64][64] box).
template <bool AMN>
__device__ __forceinline__ void ktile(float (&acc)[ACC], uint32_t a,
                                      uint32_t b, bool four, int g) {
  const uint32_t ag = a + g * BOX_BYTES;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < 2 || four) {
      const uint64_t da = AMN ? wgmma_desc(ag + kk * 2048, BOX_BYTES, 1024)
                              : wgmma_desc(ag + kk * 32, 16, 1024);
      const uint64_t db = wgmma_desc(b + kk * 2048, BOX_BYTES, 1024);
      wgmma_m64n256k16<AMN ? 1 : 0>(acc, da, db);
    }
  }
  wgmma_commit();
}

// ---------------------------------------------------------------------------
// the persistent loop
// ---------------------------------------------------------------------------

template <class P>
__device__ __forceinline__ void run(const P& p, unsigned char* smem_raw) {
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  auto stage_a = [&](int s) { return base + uint32_t(s) * STAGE_BYTES; };
  auto stage_b = [&](int s) { return stage_a(s) + A_BYTES; };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int ntiles = p.tiles();

  if (tid >= CONSUMER_THREADS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    const int pt = tid - CONSUMER_THREADS;
    if (pt == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const Tile tl = p.tile(t);
        const int nkt = k_tiles(tl.k);
        for (int kt = 0; kt < nkt; ++kt) {
          mbar_wait(empty(s), ph ^ 1u);
          mbar_expect_tx(full(s), STAGE_BYTES);
          p.load(tl, kt * BK, stage_a(s), stage_b(s), full(s));
          if (++s == STAGES) {
            s = 0;
            ph ^= 1u;
          }
        }
      }
    } else if (pt >= 32) {
      p.copy(blockIdx.x * COPY_THREADS + pt - 32, gridDim.x * COPY_THREADS);
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int g = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
    int s = 0;
    uint32_t ph = 0;
    float acc[ACC];
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const Tile tl = p.tile(t);
      const int steps = k16_steps(tl.k);
      const bool amn = p.a_mn(tl.kind);
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
      // one k-tile's group stays in flight while the next is issued; a
      // stage is released once the group that read it has completed
      int prev = -1;
      for (int k16 = 0; k16 < steps; k16 += 4) {
        mbar_wait(full(s), ph);
        const bool four = steps - k16 >= 4;
        if (amn) {
          ktile<true>(acc, stage_a(s), stage_b(s), four, g);
        } else {
          ktile<false>(acc, stage_a(s), stage_b(s), four, g);
        }
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));
        prev = s;
        if (++s == STAGES) {
          s = 0;
          ph ^= 1u;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty(prev));
      p.store(tl, acc, tl.m0 + 64 * g + 16 * w + lane / 4,
              tl.n0 + 2 * (lane % 4));
    }
  }
}

// ---------------------------------------------------------------------------
// the hop: threads [0, threads) of the launch copy nbytes from src to dst,
// 16 bytes each (four in flight) where vec16, else 2 bytes each
// ---------------------------------------------------------------------------

__device__ __forceinline__ void copy_span(const void* src, void* dst,
                                          size_t nbytes, int vec16,
                                          int thread, int threads) {
  if (dst == nullptr) return;
  const size_t step = size_t(threads);
  size_t i = size_t(thread);
  if (vec16) {
    const int4* s = static_cast<const int4*>(src);
    int4* d = static_cast<int4*>(dst);
    const size_t n = nbytes / 16;
    for (; i + 3 * step < n; i += 4 * step) {
      const int4 a = s[i], b = s[i + step], c = s[i + 2 * step],
                 e = s[i + 3 * step];
      d[i] = a;
      d[i + step] = b;
      d[i + 2 * step] = c;
      d[i + 3 * step] = e;
    }
    for (; i < n; i += step) d[i] = s[i];
  } else {
    const unsigned short* s = static_cast<const unsigned short*>(src);
    unsigned short* d = static_cast<unsigned short*>(dst);
    for (; i < nbytes / 2; i += step) d[i] = s[i];
  }
}

// ---------------------------------------------------------------------------
// epilogue helpers: a pair of neighbouring columns of an f32 or bf16 row
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  // round to nearest even, each, as __float2bfloat16 and torch's .to()
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// host: tensor maps and the launch's grid
// ---------------------------------------------------------------------------

// The return code of a launch whose operand cuTensorMapEncodeTiled refused
// (or whose driver has no such entry point), and of a kernel compiled with
// fewer registers than setmaxnreg redistributes (its consumers would wait
// for registers forever); neither is a cudaError_t.
constexpr int TENSOR_MAP_ERROR = 1000;
constexpr int REGISTER_ERROR = 1001;

// 0 when the kernel starts with the registers that setmaxnreg hands from
// the producer to the consumers (ptxas gives a kernel that uses it the
// most its launch bounds allow: 168 at 384 threads).
template <typename K>
inline int check_registers(K kernel) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return int(err);
  const int need = CONSUMER_REGS * CONSUMER_THREADS +
                   PRODUCER_REGS * (THREADS - CONSUMER_THREADS);
  return a.numRegs * THREADS >= need ? 0 : REGISTER_ERROR;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A bf16 operand [batch, rows, cols] at ptr, row stride ld elements (batch
// stride rows * ld), read in boxes of [box1][box0] with the 128-byte
// swizzle; zeros past every edge.  Returns 0 or TENSOR_MAP_ERROR.
inline int make_map(CUtensorMap* map, const void* ptr, uint64_t cols,
                    uint64_t rows, uint64_t batch, uint64_t ld,
                    uint32_t box0, uint32_t box1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return TENSOR_MAP_ERROR;
  const cuuint64_t dims[3] = {cols, rows, batch};
  const cuuint64_t strides[2] = {ld * 2, rows * ld * 2};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR;
}

// One block per SM, at most one per tile; every SM when there is a hop to
// copy (a block without tiles copies only).
inline int grid_size(int tiles, bool hop) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (hop || tiles > sms) return sms;
  return tiles > 0 ? tiles : 1;
}

// registers, local (spill) bytes, static and dynamic shared bytes and the
// block size of a kernel, for the smoke run's rows
template <typename K>
inline int kernel_attrs(K kernel, size_t dyn_smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return int(err);
  out[0] = a.numRegs;
  out[1] = int(a.localSizeBytes);
  out[2] = int(a.sharedSizeBytes);
  out[3] = int(dyn_smem);
  out[4] = a.maxThreadsPerBlock;
  return 0;
}

}  // namespace sm90
