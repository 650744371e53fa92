// ssd_chunk.cu -- the Mamba-2 intra-chunk SSD term for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/ssd_chunk.py::_kernel (pallas_call in
// ssd_intra_chunk(), entry point kernels/ops.py::ssd_intra) of the JAX
// package.  Under the port's _ssd_chunked (models/layers.py) every Mamba-2
// layer's forward is one launch.
//
// For every chunk of Q <= 64 positions of a head, with c, b [Q, N] (the
// head's group's C and B rows) and x [Q, P] in T (float or bf16), dt, dac
// [Q] in f32 (dt after softplus, dac the within-chunk cumsum of dt * A);
// y [Q, P] in T:
//
//   s[i][j]   = sum_n c[i][n] * b[j][n]                    (f32 FMA)
//   att[i][j] = i >= j ? (s[i][j] * exp(dac[i] - dac[j])) * dt[j] : 0
//   y[i][p]   = sum_j T(att[i][j]) * x[j][p]                (f32 FMA)
//
// and y rounded once to T.  For bf16 x, att is rounded to bf16 before the
// second product, as the TPU kernel's att.astype(x.dtype).  The mask is a
// select, never a multiply by 0: above the diagonal dac[i] - dac[j] > 0
// and exp can overflow to inf (inf * 0 is NaN); exp is not evaluated there.
//
// Two entries, one kernel.  The operands are read where the caller has
// them: x [batch, seq, heads, P], dt and dac [batch, seq, heads], B and C
// [batch, seq, groups, N] (head h reads group h / (heads / groups)), each
// at its own strides (unit inner stride); y is written [batch, seq, heads,
// P].  The model's entry passes _ssd_chunked's tensors as they lie (no
// repeat of B and C over the heads, no copy into groups); the reference's
// [G, Q, N] entry is the case batch = G, seq = Q, heads = groups = 1.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32; PERF.md):
//   * [G, Q, N] at mamba2-130m's groups (G = 3072, Q = 64, N = 128, P = 64,
//     f32): c, b, x, dt, dac in and y out once, 303.6 MB a launch: 90.6 us,
//     2.17 ms for a forward's 24 launches, bound by bytes (~8 FLOP a byte
//     against the f32 FFMA ridge of ~20);
//   * the model's layout (batch 2, seq 4096, 24 heads, 1 group): x and y
//     50.3 MB each, dt and dac 0.79 MB each, B and C once 4.19 MB each,
//     110.6 MB a launch: 33.0 us (0.79 ms a forward), against 0.89 GFLOP
//     (13.2 us at the f32 peak): bytes again.
//
// Design.  One persistent block per SM (288 threads, __launch_bounds__(288,
// 1)) walks work items blockIdx.x, + gridDim.x, ...; an item is one
// (batch, chunk, head group) with a share of the group's heads (all of
// them unless the items are fewer than the SMs).
//   * Warp 8 is the producer.  Its first lane issues TMA loads (4-D tensor
//     maps over the operands as they lie, strides and all): an item's C and
//     B rows into one of one or two C/B stages, in boxes of [64 rows][128
//     bytes] with the 128-byte swizzle; each head's x rows into one of two
//     to four x stages; its 32 lanes copy dt and dac by 4-byte cp.async.
//     Every stage has a full and an empty mbarrier (the TMA bytes and the
//     cp.async arrivals complete a full one), so the producer runs ahead
//     across heads and items: head k+1's x and item i+1's C and B land while
//     head k computes.  Rows TMA cannot take (a base, stride or width that
//     is not a multiple of 16 bytes: odd N or P, a bf16 row of 8 bytes) go
//     by element loads into the same layouts, then a release arrive (route
//     "scalar", counted by the wrapper; the TMA route is "tma").
//   * Warps 0-7 consume.  s once per item: threads 0-127 each a 4 x 4 tile
//     of the causal half (the 120 tiles below the diagonal and the first 8
//     on it), threads 128-207 one element each of the last 8 diagonal
//     tiles' lower triangles, so every SM sub-partition issues about the
//     same work.  A thread reads its tile's rows in an order rotated by its
//     tile index, so the quarter-warps' 128-bit loads of the swizzled rows
//     hit eight different banks.  s is kept transposed in shared memory for
//     all the item's heads (the same fmaf chain, so sharing it changes no
//     bit).  Per head (or pair of heads): att by all 256 threads, only the
//     j <= i < Q elements (four slots of 32 a warp at a time, every load
//     before any store), one named barrier, then y.  The zeros above the
//     diagonal that y reads are written once per launch.
//   * y: a 128-bit shared load costs four cycles whether or not its lanes
//     share an address, so what bounds y is the products each load feeds.
//     The model's items go two heads at a time: warp w holds rows 4w..4w+3
//     and 60-4w..63-4w of both heads (lanes 0-15 one head, 16-31 the
//     other), 4 columns a lane, 32 products per 12 values loaded, every
//     lane of a warp on the same 68 row-steps of the triangle.  Items of
//     one head (the [G, Q, N] entry) take 2 columns a lane.  The att
//     buffers are doubled, so the next head's att needs no second barrier.
//   * Arithmetic: plain FFMA in f32 in both types.  The kernel is bound by
//     bytes (about 8 FLOP a byte, under the f32 FFMA ridge of about 20), so
//     the tensor cores would buy nothing, and their k-step rounding is not
//     this chain.  Each output keeps the chain of the kernel this one
//     replaced, bit for bit: s by fmaf(c[i][n], b[j][n], acc) for
//     n = 0..N-1 from +0; att as (acc * expf(dac_i - dac_j)) * dt_j with the
//     accurate expf (no fast math), then the cast to T; y by
//     fmaf(att[i][j], x[j][p], acc) for j = 0..min(4 floor(i / 4) + 4,
//     Q) - 1 from +0 (the terms past the diagonal are fmaf(+0, x, acc):
//     kept, since they can turn a -0 sum into +0).
//   * Resources (ptxas, sm_90a): 168 registers in f32 and 164 in bf16 (the
//     most 288 threads leave: three warps share a sub-partition's 16K), no
//     spills.  Shared memory (ssd_chunk.py::plan decides, this file
//     checks), mamba2-130m in f32: the [G, Q, N] entry two C/B stages of
//     64 KiB, two x stages of 16.5 KiB, s 17 KiB, two att buffers of
//     16 KiB, 216,192 bytes; the model's items one C/B stage, four x
//     stages, four att buffers, 217,216 bytes.  One block an SM either
//     way.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int QMAX = 64;           // rows of a chunk the kernel holds
constexpr int NMAX = 128;          // state width
constexpr int PMAX = 128;          // head width
constexpr int CONSUMER_WARPS = 8;
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
constexpr int THREADS = CONSUMERS + 32;     // + the producer warp
constexpr int SPITCH = QMAX + 4;   // row pitch (floats) of the transposed s
constexpr int MAX_CB = 2, MAX_X = 4;        // stages
constexpr int BAR_BYTES = 128;     // the mbarriers, at the base
constexpr int ALIGN = 1024;        // the 128-byte swizzle's atom
constexpr int BOX_BYTES = QMAX * 128;       // a [64 rows][128 B] C/B box
constexpr int S_BYTES = QMAX * SPITCH * 4;
constexpr int ATT_BYTES = QMAX * QMAX * 4;  // one of two att buffers
constexpr int DT_BYTES = 2 * QMAX * 4;      // dt and dac of an x stage
constexpr int SMEM_LIMIT = 232448;          // a block's most, H100
// the return code of a launch whose operand cuTensorMapEncodeTiled refused
// (or whose driver has no such entry point); not a cudaError_t
constexpr int TENSOR_MAP_ERROR = 1000;

struct Params {
  const char* x;
  const float* dt;
  const float* dac;
  const char* B;
  const char* C;
  char* y;
  long long sx[3], sdt[3], sdac[3], sB[3], sC[3];   // (batch, seq, head)
  int batch, seqlen, heads, groups, Q, N, P;
  int shares, items;           // head shares of a group; work items
  int vec;                     // 1: TMA (and 4-byte cp.async), 0: elements
  int cb_stages, x_stages;
  int boxes;                   // 128-byte boxes of a C/B row
  int xpitch;                  // bytes of an x row in shared memory
  int pairs;                   // 1: heads two at a time (four att buffers)
};

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

// ---------------------------------------------------------------------------
// PTX: shared memory, mbarriers, cp.async and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// loads and stores at 32-bit shared addresses (ld.shared / st.shared: the
// consumers never go through generic addressing)
__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a));
  return v;
}
__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ uint32_t lds16(uint32_t a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts16(uint32_t a, unsigned short v) {
  asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(a), "h"(v) : "memory");
}
__device__ __forceinline__ void sts32(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(a), "f"(v) : "memory");
}
__device__ __forceinline__ float bf_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// Four consecutive elements of type T at shared address a (16 bytes f32,
// 8 bf16), two (8 bytes f32, 4 bf16) and one, as f32.
template <typename T> struct Lds;
template <> struct Lds<float> {
  static __device__ __forceinline__ float4 four(uint32_t a) {
    return lds128(a);
  }
  static __device__ __forceinline__ float2 two(uint32_t a) {
    const uint2 u = lds64(a);
    return make_float2(__uint_as_float(u.x), __uint_as_float(u.y));
  }
  static __device__ __forceinline__ float one(uint32_t a) {
    return __uint_as_float(lds32(a));
  }
};
template <> struct Lds<__nv_bfloat16> {
  static __device__ __forceinline__ float4 four(uint32_t a) {
    const uint2 u = lds64(a);
    return make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
  }
  static __device__ __forceinline__ float2 two(uint32_t a) {
    const uint32_t u = lds32(a);
    return make_float2(bf_lo(u), bf_hi(u));
  }
  static __device__ __forceinline__ float one(uint32_t a) {
    return bf_lo(lds16(a));
  }
};

// one element of type T from device memory into shared memory
__device__ __forceinline__ void copy_elem(uint32_t dst, const float* src) {
  sts32(dst, *src);
}
__device__ __forceinline__ void copy_elem(uint32_t dst,
                                          const __nv_bfloat16* src) {
  sts16(dst, *reinterpret_cast<const unsigned short*>(src));
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16(a);
  v.y = __float2bfloat16(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// A wait that outlasts ~2^34 cycles (about 10 s) traps: a deadlock becomes
// a launch error the wrapper raises, not a card that never returns.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// one arrival, and `bytes` more to land (TMA) before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// an arrival when every cp.async this thread has issued so far has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// one box of a 4-D tensor map at element coordinates (c0, c1, c2, c3)
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* m,
                                          int c0, int c1, int c2, int c3,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
}

// ---------------------------------------------------------------------------
// Work items and shared memory
// ---------------------------------------------------------------------------

struct Item {
  int b, c, g, h0, h1;         // batch, chunk, group, heads [h0, h1)
};

__device__ __forceinline__ Item item_of(const Params& p, int it) {
  Item r;
  const int sh = it % p.shares;
  it /= p.shares;
  r.g = it % p.groups;
  it /= p.groups;
  const int chunks = p.seqlen / p.Q;
  r.c = it % chunks;
  r.b = it / chunks;
  const int rep = p.heads / p.groups;
  const int per = (rep + p.shares - 1) / p.shares;
  r.h0 = r.g * rep + sh * per;
  r.h1 = min(r.h0 + per, (r.g + 1) * rep);
  return r;
}

// A C or B row r sits in 128-byte boxes of [64 rows][128 B], its 16-byte
// chunk k of a box at chunk k ^ (r & 7): TMA's 128-byte swizzle.  This is
// the swizzled base of row r (its bits 4-6 the XOR), so that the byte b of
// a box is at swz_row(...) ^ b.
__device__ __forceinline__ uint32_t swz_row(uint32_t base, int r) {
  return (base + r * 128) ^ ((r & 7) << 4);
}

struct Smem {                  // shared addresses (32-bit)
  uint32_t full_cb, empty_cb, full_x, empty_x;   // barrier arrays
  uint32_t cb;                 // cb_stages x (C boxes, B boxes), 1024-aligned
  uint32_t xs;                 // x_stages x (x [QMAX rows], dt, dac)
  uint32_t sT;                 // [QMAX][SPITCH] f32: sT[j][i] = s[i][j]
  uint32_t att;                // 2 x [QMAX][QMAX] f32: att[j][i]
  int cb_bytes, x_bytes;       // one stage
};

__device__ __forceinline__ Smem smem_of(const Params& p, const char* base) {
  Smem s;
  const uint32_t b = smem_u32(base);
  s.full_cb = b;
  s.empty_cb = b + 8 * MAX_CB;
  s.full_x = b + 16 * MAX_CB;
  s.empty_x = b + 16 * MAX_CB + 8 * MAX_X;
  s.cb = (b + BAR_BYTES + ALIGN - 1) & ~uint32_t(ALIGN - 1);
  s.cb_bytes = 2 * p.boxes * BOX_BYTES;
  s.xs = s.cb + p.cb_stages * s.cb_bytes;
  s.x_bytes = QMAX * p.xpitch + DT_BYTES;
  s.sT = s.xs + p.x_stages * s.x_bytes;
  s.att = s.sT + S_BYTES;      // (pairs ? 4 : 2) buffers of ATT_BYTES
  return s;
}

// ---------------------------------------------------------------------------
// The producer warp
// ---------------------------------------------------------------------------

// The scalar route: rows [0, Q) of one [seq, cols] slice (`base` at the
// chunk's first row of the group or head) element by element into shared
// memory, in the C/B box layout (CB) or as rows of `pitch` bytes.  Lane l
// takes elements l, l + 32, ... in row order, stepping without a division.
template <typename T, bool CB>
__device__ __forceinline__ void load_elems(const Params& p, uint32_t dst,
                                           const T* base, long long srow,
                                           int cols, int pitch, int lane) {
  const int es = sizeof(T);
  const int dr = 32 / cols, dc = 32 % cols;
  int r = lane / cols, e = lane % cols;
  while (r < p.Q) {
    const int byte = e * es;
    const uint32_t a = CB ? swz_row(dst + (byte >> 7) * BOX_BYTES, r)
                                ^ (byte & 127)
                          : dst + r * pitch + byte;
    copy_elem(a, base + r * srow + e);
    r += dr;
    e += dc;
    if (e >= cols) { e -= cols; ++r; }
  }
}

template <typename T>
__device__ __forceinline__ void produce(const Params& p, const Smem& sm,
                                        const CUtensorMap* mC,
                                        const CUtensorMap* mB,
                                        const CUtensorMap* mX, int lane) {
  const int es = sizeof(T);
  int cb_stage = 0, cb_phase = 0, x_stage = 0, x_phase = 0;
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    const Item w = item_of(p, it);
    const int row0 = w.c * p.Q;
    mbar_wait(sm.empty_cb + 8 * cb_stage, cb_phase ^ 1);
    const uint32_t dst = sm.cb + cb_stage * sm.cb_bytes;
    const uint32_t bar = sm.full_cb + 8 * cb_stage;
    if (p.vec) {
      if (lane == 0) {
        mbar_expect_tx(bar, 2 * p.boxes * p.Q * 128);
        for (int k = 0; k < p.boxes; ++k) {
          tma_load4(dst + k * BOX_BYTES, mC, k * (128 / es), w.g, row0, w.b,
                    bar);
          tma_load4(dst + (p.boxes + k) * BOX_BYTES, mB, k * (128 / es), w.g,
                    row0, w.b, bar);
        }
      }
    } else {
      const T* c = reinterpret_cast<const T*>(p.C) + w.b * p.sC[0] +
                   row0 * p.sC[1] + w.g * p.sC[2];
      const T* b = reinterpret_cast<const T*>(p.B) + w.b * p.sB[0] +
                   row0 * p.sB[1] + w.g * p.sB[2];
      load_elems<T, true>(p, dst, c, p.sC[1], p.N, 0, lane);
      load_elems<T, true>(p, dst + p.boxes * BOX_BYTES, b, p.sB[1], p.N, 0,
                          lane);
      mbar_arrive(bar);
    }
    if (++cb_stage == p.cb_stages) { cb_stage = 0; cb_phase ^= 1; }

    for (int h = w.h0; h < w.h1; ++h) {
      mbar_wait(sm.empty_x + 8 * x_stage, x_phase ^ 1);
      const uint32_t xd = sm.xs + x_stage * sm.x_bytes;
      const uint32_t xbar = sm.full_x + 8 * x_stage;
      if (p.vec) {
        if (lane == 0) {
          mbar_expect_tx(xbar, p.Q * p.P * es);
          tma_load4(xd, mX, 0, h, row0, w.b, xbar);
        }
      } else {
        const T* x = reinterpret_cast<const T*>(p.x) + w.b * p.sx[0] +
                     row0 * p.sx[1] + h * p.sx[2];
        load_elems<T, false>(p, xd, x, p.sx[1], p.P, p.xpitch, lane);
      }
      const uint32_t dts = xd + QMAX * p.xpitch;
      for (int k = lane; k < 2 * p.Q; k += 32) {
        const bool is_dt = k < p.Q;
        const int i = is_dt ? k : k - p.Q;
        const float* src =
            is_dt ? p.dt + w.b * p.sdt[0] + (long long)(row0 + i) * p.sdt[1]
                        + h * p.sdt[2]
                  : p.dac + w.b * p.sdac[0]
                        + (long long)(row0 + i) * p.sdac[1] + h * p.sdac[2];
        const uint32_t d = dts + 4 * (is_dt ? i : QMAX + i);
        if (p.vec) cp_async4(d, src);
        else sts32(d, *src);
      }
      if (p.vec) cp_async_arrive(xbar);
      else mbar_arrive(xbar);
      if (++x_stage == p.x_stages) { x_stage = 0; x_phase ^= 1; }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The consumer warps
// ---------------------------------------------------------------------------

// s of one item into sT from the C/B stage at cb: a 4 x 4 tile (ti, tj) of
// the thread; n runs 0..N-1 in order for every output.  The thread reads
// its tile's rows rotated by (ti / 2) % 4 (C) and (tj / 2) % 4 (B), so that
// the eight lanes of a quarter-warp, on the rows of consecutive tiles, hit
// rows of eight different swizzles.
template <typename T>
__device__ __forceinline__ void s_tile(const Params& p, uint32_t cb,
                                       uint32_t sT, int ti, int tj) {
  constexpr int es = sizeof(T), step = 4 * es;
  const int rc = (ti >> 1) & 3, rb = (tj >> 1) & 3;
  const uint32_t bB = cb + p.boxes * BOX_BYTES;
  uint32_t Rc[4], Rb[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    Rc[s] = swz_row(cb, 4 * ti + ((s + rc) & 3));
    Rb[s] = swz_row(bB, 4 * tj + ((s + rb) & 3));
  }
  float acc[4][4] = {};
  const int full = (p.N * es) >> 7;           // whole 128-byte boxes
  for (int k = 0; k < full; ++k) {
    const uint32_t kb = k * BOX_BYTES;
#pragma unroll
    for (int bb = 0; bb < 128; bb += step) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) cv[s] = Lds<T>::four((Rc[s] + kb) ^ bb);
#pragma unroll
      for (int t = 0; t < 4; ++t) bv[t] = Lds<T>::four((Rb[t] + kb) ^ bb);
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[s][t] = fmaf(cv[s].x, bv[t].x, acc[s][t]);
          acc[s][t] = fmaf(cv[s].y, bv[t].y, acc[s][t]);
          acc[s][t] = fmaf(cv[s].z, bv[t].z, acc[s][t]);
          acc[s][t] = fmaf(cv[s].w, bv[t].w, acc[s][t]);
        }
    }
  }
  int n = full * (128 / es);
  for (; n < p.N; ++n) {       // the part of a box past the whole ones
    const int byte = n * es;
    const uint32_t kb = (byte >> 7) * BOX_BYTES, bb = byte & 127;
    float cv[4], bv[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) cv[s] = Lds<T>::one((Rc[s] + kb) ^ bb);
#pragma unroll
    for (int t = 0; t < 4; ++t) bv[t] = Lds<T>::one((Rb[t] + kb) ^ bb);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[s][t] = fmaf(cv[s], bv[t], acc[s][t]);
  }
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int t = 0; t < 4; ++t)
      sts32(sT + 4 * ((4 * tj + ((t + rb) & 3)) * SPITCH + 4 * ti
                      + ((s + rc) & 3)),
            acc[s][t]);
}

// s[i][j] alone (the diagonal tiles 8-15)
template <typename T>
__device__ __forceinline__ void s_elem(const Params& p, uint32_t cb,
                                       uint32_t sT, int i, int j) {
  constexpr int es = sizeof(T), step = 4 * es;
  const uint32_t Rc = swz_row(cb, i);
  const uint32_t Rb = swz_row(cb + p.boxes * BOX_BYTES, j);
  float acc = 0.f;
  const int full = (p.N * es) >> 7;
  for (int k = 0; k < full; ++k) {
    const uint32_t kb = k * BOX_BYTES;
#pragma unroll
    for (int bb = 0; bb < 128; bb += step) {
      const float4 cv = Lds<T>::four((Rc + kb) ^ bb);
      const float4 bv = Lds<T>::four((Rb + kb) ^ bb);
      acc = fmaf(cv.x, bv.x, acc);
      acc = fmaf(cv.y, bv.y, acc);
      acc = fmaf(cv.z, bv.z, acc);
      acc = fmaf(cv.w, bv.w, acc);
    }
  }
  for (int n = full * (128 / es); n < p.N; ++n) {
    const int byte = n * es;
    const uint32_t kb = (byte >> 7) * BOX_BYTES, bb = byte & 127;
    acc = fmaf(Lds<T>::one((Rc + kb) ^ bb), Lds<T>::one((Rb + kb) ^ bb), acc);
  }
  sts32(sT + 4 * (j * SPITCH + i), acc);
}

// y[i][col], y[i][col + 1] of row i, where below Q and P
template <typename T>
__device__ __forceinline__ void store_pair(const Params& p, T* dst, int i,
                                           int col, const float (&a)[2]) {
  if (i >= p.Q) return;
  if (p.vec) {                 // P even: the pair is in the row
    st2(dst, a[0], a[1]);
  } else {
    dst[0] = from_float<T>(a[0]);
    if (col + 1 < p.P) dst[1] = from_float<T>(a[1]);
  }
}

// y[i][col..col + 3] of row i, where below Q and P
template <typename T>
__device__ __forceinline__ void store_four(const Params& p, T* dst, int i,
                                           int col, const float (&a)[4]) {
  if (i >= p.Q) return;
  if (p.vec) {                 // P a multiple of 4: the four are in the row
    st2(dst, a[0], a[1]);
    st2(dst + 2, a[2], a[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col + c < p.P) dst[c] = from_float<T>(a[c]);
  }
}

// y rows of warp w for one head: R1 = rows 4w..4w+3 (chain length
// min(4w + 4, Q)), R2 = rows 60-4w..63-4w (min(64 - 4w, Q)); lane's columns
// p0 + 2 lane, + 1.  att is read as a broadcast, x as a whole row.
template <typename T>
__device__ __forceinline__ void y_rows(const Params& p, uint32_t att,
                                       uint32_t xs, T* yh, long long ys,
                                       int w, int lane) {
  const int Q = p.Q;
  const int a0 = 4 * w, b0 = 60 - 4 * w;
  const bool r1 = a0 < Q, r2 = b0 < Q;
  if (!r1) return;
  const int L1 = min(a0 + 4, Q);
  const int L2 = r2 ? min(64 - 4 * w, Q) : 0;
  const uint32_t xpitch = p.xpitch;
  for (int p0 = 0; p0 < p.P; p0 += 64) {
    const int col = p0 + 2 * lane;
    if (col >= p.P) continue;
    float acc1[4][2] = {}, acc2[4][2] = {};
    uint32_t xa = xs + col * int(sizeof(T));
    uint32_t ua = att + 4 * a0, va = att + 4 * b0;
    if (r2) {
      int j = 0;
#pragma unroll 4
      for (; j < L1; ++j) {
        const float4 u = lds128(ua);
        const float4 v = lds128(va);
        const float2 xv = Lds<T>::two(xa);
        ua += 4 * QMAX;
        va += 4 * QMAX;
        xa += xpitch;
        acc1[0][0] = fmaf(u.x, xv.x, acc1[0][0]);
        acc1[0][1] = fmaf(u.x, xv.y, acc1[0][1]);
        acc1[1][0] = fmaf(u.y, xv.x, acc1[1][0]);
        acc1[1][1] = fmaf(u.y, xv.y, acc1[1][1]);
        acc1[2][0] = fmaf(u.z, xv.x, acc1[2][0]);
        acc1[2][1] = fmaf(u.z, xv.y, acc1[2][1]);
        acc1[3][0] = fmaf(u.w, xv.x, acc1[3][0]);
        acc1[3][1] = fmaf(u.w, xv.y, acc1[3][1]);
        acc2[0][0] = fmaf(v.x, xv.x, acc2[0][0]);
        acc2[0][1] = fmaf(v.x, xv.y, acc2[0][1]);
        acc2[1][0] = fmaf(v.y, xv.x, acc2[1][0]);
        acc2[1][1] = fmaf(v.y, xv.y, acc2[1][1]);
        acc2[2][0] = fmaf(v.z, xv.x, acc2[2][0]);
        acc2[2][1] = fmaf(v.z, xv.y, acc2[2][1]);
        acc2[3][0] = fmaf(v.w, xv.x, acc2[3][0]);
        acc2[3][1] = fmaf(v.w, xv.y, acc2[3][1]);
      }
#pragma unroll 4
      for (; j < L2; ++j) {
        const float4 v = lds128(va);
        const float2 xv = Lds<T>::two(xa);
        va += 4 * QMAX;
        xa += xpitch;
        acc2[0][0] = fmaf(v.x, xv.x, acc2[0][0]);
        acc2[0][1] = fmaf(v.x, xv.y, acc2[0][1]);
        acc2[1][0] = fmaf(v.y, xv.x, acc2[1][0]);
        acc2[1][1] = fmaf(v.y, xv.y, acc2[1][1]);
        acc2[2][0] = fmaf(v.z, xv.x, acc2[2][0]);
        acc2[2][1] = fmaf(v.z, xv.y, acc2[2][1]);
        acc2[3][0] = fmaf(v.w, xv.x, acc2[3][0]);
        acc2[3][1] = fmaf(v.w, xv.y, acc2[3][1]);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < L1; ++j) {
        const float4 u = lds128(ua);
        const float2 xv = Lds<T>::two(xa);
        ua += 4 * QMAX;
        xa += xpitch;
        acc1[0][0] = fmaf(u.x, xv.x, acc1[0][0]);
        acc1[0][1] = fmaf(u.x, xv.y, acc1[0][1]);
        acc1[1][0] = fmaf(u.y, xv.x, acc1[1][0]);
        acc1[1][1] = fmaf(u.y, xv.y, acc1[1][1]);
        acc1[2][0] = fmaf(u.z, xv.x, acc1[2][0]);
        acc1[2][1] = fmaf(u.z, xv.y, acc1[2][1]);
        acc1[3][0] = fmaf(u.w, xv.x, acc1[3][0]);
        acc1[3][1] = fmaf(u.w, xv.y, acc1[3][1]);
      }
    }
    // stores: rows below Q, columns below P
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      store_pair(p, yh + (a0 + r) * ys + col, a0 + r, col, acc1[r]);
      if (r2) store_pair(p, yh + (b0 + r) * ys + col, b0 + r, col, acc2[r]);
    }
  }
}

// y of two heads at once (the model's items) by all eight warps: warp w
// holds rows 4w..4w+3 and 60-4w..63-4w (chain lengths as y_rows) of both
// heads, lanes 0-15 head A's and 16-31 head B's, each lane columns
// p0 + 4 (lane % 16), .. + 3: every lane of a warp runs the same steps,
// and a thread reads 12 values a step for 32 products (a 128-bit shared
// load costs the same four cycles whether its lanes share addresses or
// not, so the products a load feeds set the rate)
template <typename T>
__device__ __forceinline__ void y_two(const Params& p, uint32_t att_a,
                                      uint32_t att_b, uint32_t x_a,
                                      uint32_t x_b, T* y_a, T* y_b,
                                      long long ys, int w, int lane) {
  const int Q = p.Q;
  const int slot = lane >> 4, cg = lane & 15;
  const uint32_t att = slot ? att_b : att_a, xs = slot ? x_b : x_a;
  T* const yh = slot ? y_b : y_a;
  const int a0 = 4 * w, b0 = 60 - 4 * w;
  const bool r1 = a0 < Q, r2 = b0 < Q;
  if (!r1) return;
  const int L1 = min(a0 + 4, Q);
  const int L2 = r2 ? min(64 - 4 * w, Q) : 0;
  const uint32_t xpitch = p.xpitch;
  for (int p0 = 0; p0 < p.P; p0 += 64) {
    const int col = p0 + 4 * cg;
    if (col >= p.P) continue;
    float acc1[4][4] = {}, acc2[4][4] = {};
    uint32_t xa = xs + col * int(sizeof(T));
    uint32_t ua = att + 4 * a0, va = att + 4 * b0;
    int j = 0;
    if (r2) {
#pragma unroll 2
      for (; j < L1; ++j) {
        const float4 u = lds128(ua);
        const float4 v = lds128(va);
        const float4 xv = Lds<T>::four(xa);
        ua += 4 * QMAX;
        va += 4 * QMAX;
        xa += xpitch;
        const float uu[4] = {u.x, u.y, u.z, u.w};
        const float vv[4] = {v.x, v.y, v.z, v.w};
        const float xx[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc1[r][c] = fmaf(uu[r], xx[c], acc1[r][c]);
            acc2[r][c] = fmaf(vv[r], xx[c], acc2[r][c]);
          }
      }
#pragma unroll 2
      for (; j < L2; ++j) {
        const float4 v = lds128(va);
        const float4 xv = Lds<T>::four(xa);
        va += 4 * QMAX;
        xa += xpitch;
        const float vv[4] = {v.x, v.y, v.z, v.w};
        const float xx[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc2[r][c] = fmaf(vv[r], xx[c], acc2[r][c]);
      }
    } else {
#pragma unroll 2
      for (; j < L1; ++j) {
        const float4 u = lds128(ua);
        const float4 xv = Lds<T>::four(xa);
        ua += 4 * QMAX;
        xa += xpitch;
        const float uu[4] = {u.x, u.y, u.z, u.w};
        const float xx[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc1[r][c] = fmaf(uu[r], xx[c], acc1[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      store_four(p, yh + (a0 + r) * ys + col, a0 + r, col, acc1[r]);
      if (r2) store_four(p, yh + (b0 + r) * ys + col, b0 + r, col, acc2[r]);
    }
  }
}

// att[j][i] = T((s[i][j] * exp(dac_i - dac_j)) * dt_j) for j <= i < Q of
// NH (1 or 2) heads, at x stages xs[h] into att buffers att[h].  Warp w
// takes the rows j = w, w + 8, ... (about the same count of elements
// each) in slots of 32 elements: (j, i = j + lane) and, where j + 32 < Q,
// (j, i = j + 32 + lane); rows with two slots come first.  Four slots at a
// time, every load before any store (the shared loads and stores keep
// their order), so 4 NH exps are in flight.  Only i >= j is evaluated;
// the zeros above the diagonal that y reads were written at the start.
template <typename T, int NH>
__device__ __forceinline__ void att_rows(const Params& p, uint32_t sT,
                                         const uint32_t (&xs)[2],
                                         const uint32_t (&att)[2], int w,
                                         int lane) {
  const int Q = p.Q;
  const int rows = w < Q ? (Q - w + CONSUMER_WARPS - 1) / CONSUMER_WARPS : 0;
  const int two = Q - 32 > w ? (Q - 32 - w + CONSUMER_WARPS - 1) /
                                   CONSUMER_WARPS : 0;
  const int slots = rows + two;
  for (int s0 = 0; s0 < slots; s0 += 4) {
    int jj[4], ii[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int sl = s0 + k < slots ? s0 + k : s0;
      const bool pair = sl < 2 * two;
      jj[k] = w + CONSUMER_WARPS * (pair ? sl >> 1 : sl - two);
      const int i = jj[k] + lane + (pair && (sl & 1) ? 32 : 0);
      ii[k] = s0 + k < slots && i < Q ? i : -1;   // -1: nothing to store
    }
    float sv[4], e[NH][4], dj[NH][4], tj[NH][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = ii[k] < 0 ? Q - 1 : ii[k];   // on or below the diagonal
      sv[k] = Lds<float>::one(sT + 4 * (jj[k] * SPITCH + i));
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const uint32_t dts = xs[h] + QMAX * p.xpitch, dacs = dts + 4 * QMAX;
        dj[h][k] = Lds<float>::one(dacs + 4 * jj[k]);
        tj[h][k] = Lds<float>::one(dts + 4 * jj[k]);
        e[h][k] = Lds<float>::one(dacs + 4 * i);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int h = 0; h < NH; ++h)   // att.astype(x.dtype)
        e[h][k] = to_float(from_float<T>(
            (sv[k] * expf(e[h][k] - dj[h][k])) * tj[h][k]));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (ii[k] < 0) continue;
#pragma unroll
      for (int h = 0; h < NH; ++h)
        sts32(att[h] + 4 * (jj[k] * QMAX + ii[k]), e[h][k]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void consume(const Params& p, const Smem& sm,
                                        int tid) {
  const int warp = tid / 32, lane = tid % 32;
  // this thread's share of s: a 4 x 4 tile (threads 0-127: the tiles below
  // the diagonal and the first 8 on it, row by row) or one element of the
  // lower triangles of diagonal tiles 8-15 (threads 128-207)
  int ti = -1, tj = -1, ei = -1, ej = -1;
  if (tid < 128) {
    int rem = tid, t = 0;
    while (rem >= t + (t < 8 ? 1 : 0)) { rem -= t + (t < 8 ? 1 : 0); ++t; }
    ti = t;
    tj = rem;
  } else if (tid < 208) {
    const int e = tid - 128, d = 8 + e / 10, k = e % 10;
    const int r = k >= 6 ? 3 : k >= 3 ? 2 : k >= 1 ? 1 : 0;
    ei = 4 * d + r;
    ej = 4 * d + k - r * (r + 1) / 2;
  }
  const long long ys = (long long)p.heads * p.P;     // y's row stride
  // the zeros y reads above the diagonal, in its 4 x 4 blocks (att[j][i],
  // i < j <= 4 (i / 4) + 3), once: the att rows write only j <= i
  for (int k = tid; k < (p.pairs ? 4 : 2) * 16 * 6; k += CONSUMERS) {
    const int e = k % 6, blk = (k / 6) % 16, b = k / 96;
    const int i = e < 3 ? 0 : e < 5 ? 1 : 2;
    const int j = i + 1 + (e < 3 ? e : e < 5 ? e - 3 : 0);
    sts32(sm.att + b * ATT_BYTES + 4 * ((4 * blk + j) * QMAX + 4 * blk + i),
          0.f);
  }
  int cb_stage = 0, cb_phase = 0, x_stage = 0, x_phase = 0, buf = 0;
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    const Item w = item_of(p, it);
    mbar_wait(sm.full_cb + 8 * cb_stage, cb_phase);
    const uint32_t cb = sm.cb + cb_stage * sm.cb_bytes;
    if (ti >= 0 && 4 * ti < p.Q) s_tile<T>(p, cb, sm.sT, ti, tj);
    else if (ei >= 0 && ei < p.Q) s_elem<T>(p, cb, sm.sT, ei, ej);
    consumers_sync();          // sT whole; the C/B stage read
    if (lane == 0) mbar_arrive(sm.empty_cb + 8 * cb_stage);
    if (++cb_stage == p.cb_stages) { cb_stage = 0; cb_phase ^= 1; }

    T* y0 = reinterpret_cast<T*>(p.y) +
            ((long long)w.b * p.seqlen + (long long)w.c * p.Q) * ys;
    // one head at a time, or (pairs: the model's items) two
    for (int h = w.h0; h < w.h1; h += 1 + p.pairs) {
      const int nh = p.pairs && h + 1 < w.h1 ? 2 : 1;
      mbar_wait(sm.full_x + 8 * x_stage, x_phase);
      const uint32_t xa = sm.xs + x_stage * sm.x_bytes;
      const uint32_t empty_a = sm.empty_x + 8 * x_stage;
      if (++x_stage == p.x_stages) { x_stage = 0; x_phase ^= 1; }
      uint32_t xb = xa, empty_b = empty_a;
      if (nh > 1) {
        mbar_wait(sm.full_x + 8 * x_stage, x_phase);
        xb = sm.xs + x_stage * sm.x_bytes;
        empty_b = sm.empty_x + 8 * x_stage;
        if (++x_stage == p.x_stages) { x_stage = 0; x_phase ^= 1; }
      }
      const uint32_t aa = sm.att + (p.pairs ? 2 * buf : buf) * ATT_BYTES;
      const uint32_t ab = aa + ATT_BYTES;
      const uint32_t xst[2] = {xa, xb}, atts[2] = {aa, ab};
      if (nh > 1) att_rows<T, 2>(p, sm.sT, xst, atts, warp, lane);
      else att_rows<T, 1>(p, sm.sT, xst, atts, warp, lane);
      consumers_sync();        // att whole
      if (nh > 1) {
        y_two<T>(p, aa, ab, xa, xb, y0 + (long long)h * p.P,
                 y0 + (long long)(h + 1) * p.P, ys, warp, lane);
      } else {
        y_rows<T>(p, aa, xa, y0 + (long long)h * p.P, ys, warp, lane);
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(empty_a);
        if (nh > 1) mbar_arrive(empty_b);
      }
      buf ^= 1;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_intra_kernel(const __grid_constant__ CUtensorMap mC,
                 const __grid_constant__ CUtensorMap mB,
                 const __grid_constant__ CUtensorMap mX, Params p) {
  extern __shared__ __align__(128) char smem[];
  const Smem sm = smem_of(p, smem);
  const int tid = threadIdx.x;
  if (tid == 0) {
    // full: the TMA lane's arrival (and, for x, the 32 lanes' cp.async of
    // dt and dac), or the 32 lanes' arrivals after their element copies
    for (int k = 0; k < p.cb_stages; ++k) {
      mbar_init(sm.full_cb + 8 * k, p.vec ? 1 : 32);
      mbar_init(sm.empty_cb + 8 * k, CONSUMER_WARPS);
    }
    for (int k = 0; k < p.x_stages; ++k) {
      mbar_init(sm.full_x + 8 * k, p.vec ? 33 : 32);
      mbar_init(sm.empty_x + 8 * k, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= CONSUMERS) produce<T>(p, sm, &mC, &mB, &mX, tid - CONSUMERS);
  else consume<T>(p, sm, tid);
}

size_t smem_bytes(const Params& p) {
  return size_t(BAR_BYTES) + ALIGN +
         size_t(p.cb_stages) * 2 * p.boxes * BOX_BYTES +
         size_t(p.x_stages) * (size_t(QMAX) * p.xpitch + DT_BYTES) + S_BYTES +
         (p.pairs ? 4 : 2) * size_t(ATT_BYTES);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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

// A [d3, d2, d1, d0] operand (batch, seq, head or group, width) at ptr with
// element strides s3, s2, s1 (unit inner stride), read in boxes of
// [box2 rows][box0 elements] of one head or group; zeros past every edge.
template <typename T>
int make_map(CUtensorMap* map, const void* ptr, const long long* s,
             uint64_t d0, uint64_t d1, uint64_t d2, uint64_t d3,
             uint32_t box0, uint32_t box2, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return TENSOR_MAP_ERROR;
  const int es = sizeof(T);
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const cuuint64_t strides[3] = {cuuint64_t(s[2]) * es, cuuint64_t(s[1]) * es,
                                 cuuint64_t(s[0]) * es};
  const cuuint32_t box[4] = {box0, 1, box2, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        4, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR;
}

// dims (int64): batch, seqlen, heads, groups, Q, N, P, the strides of x,
// dt, dac, B, C (three each: batch, seq, head or group), vec, shares,
// cb_stages, x_stages, boxes, xpitch, pairs
constexpr int NDIMS = 7 + 15 + 7;

template <typename T>
int launch(const void* x, const void* dt, const void* dac, const void* B,
           const void* C, void* y, const long long* d, cudaStream_t s) {
  Params p;
  p.x = static_cast<const char*>(x);
  p.dt = static_cast<const float*>(dt);
  p.dac = static_cast<const float*>(dac);
  p.B = static_cast<const char*>(B);
  p.C = static_cast<const char*>(C);
  p.y = static_cast<char*>(y);
  p.batch = int(d[0]);
  p.seqlen = int(d[1]);
  p.heads = int(d[2]);
  p.groups = int(d[3]);
  p.Q = int(d[4]);
  p.N = int(d[5]);
  p.P = int(d[6]);
  for (int k = 0; k < 3; ++k) {
    p.sx[k] = d[7 + k];
    p.sdt[k] = d[10 + k];
    p.sdac[k] = d[13 + k];
    p.sB[k] = d[16 + k];
    p.sC[k] = d[19 + k];
  }
  p.vec = int(d[22]);
  p.shares = int(d[23]);
  p.cb_stages = int(d[24]);
  p.x_stages = int(d[25]);
  p.boxes = int(d[26]);
  p.xpitch = int(d[27]);
  p.pairs = int(d[28]);
  const int es = sizeof(T);
  if (p.Q < 1 || p.Q > QMAX || p.N < 1 || p.N > NMAX || p.P < 1 ||
      p.P > PMAX || p.batch < 1 || p.seqlen % p.Q != 0 || p.groups < 1 ||
      p.heads % p.groups != 0 || p.shares < 1 ||
      p.shares > p.heads / p.groups || p.cb_stages < 1 ||
      p.cb_stages > MAX_CB || p.x_stages < 2 || p.x_stages > MAX_X ||
      p.boxes != (p.N * es + 127) / 128 || p.xpitch < p.P * es ||
      p.xpitch % 16 || (p.pairs != 0 && p.pairs != 1))
    return cudaErrorInvalidValue;
  if (p.vec && ((p.N * es) % 16 || p.xpitch != p.P * es))
    return cudaErrorInvalidValue;
  const long long items = (long long)p.batch * (p.seqlen / p.Q) * p.groups *
                          p.shares;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  p.items = int(items);
  const size_t smem = smem_bytes(p);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  CUtensorMap mC, mB, mX;
  memset(&mC, 0, sizeof(mC));
  memset(&mB, 0, sizeof(mB));
  memset(&mX, 0, sizeof(mX));
  if (p.vec) {
    int e = make_map<T>(&mC, C, p.sC, p.N, p.groups, p.seqlen, p.batch,
                        128 / es, p.Q, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e == 0)
      e = make_map<T>(&mB, B, p.sB, p.N, p.groups, p.seqlen, p.batch,
                      128 / es, p.Q, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e == 0)
      e = make_map<T>(&mX, x, p.sx, p.P, p.heads, p.seqlen, p.batch, p.P,
                      p.Q, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != 0) return e;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // above 48 KB only as opted-in dynamic shared memory (per device, so
  // raised on every launch: a host-side call)
  e = cudaFuncSetAttribute(ssd_intra_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_LIMIT);
  if (e != cudaSuccess) return e;
  const int grid = p.items < sms ? p.items : sms;
  ssd_intra_kernel<T><<<grid, THREADS, smem, s>>>(mC, mB, mX, p);
  return cudaGetLastError();
}

template <typename T>
int attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, ssd_intra_kernel<T>);
  if (err != cudaSuccess) return int(err);
  out[0] = a.numRegs;
  out[1] = int(a.localSizeBytes);
  out[2] = int(a.sharedSizeBytes);
  out[3] = 0;
  out[4] = a.maxThreadsPerBlock;
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (bound with ctypes).  Each returns a cudaError_t, or
// TENSOR_MAP_ERROR; the caller raises on anything but 0.
// ---------------------------------------------------------------------------

extern "C" int ssd_chunk_ndims() { return NDIMS; }

extern "C" int ssd_chunk_launch(int bf16, const void* x, const void* dt,
                                const void* dac, const void* B,
                                const void* C, void* y,
                                const long long* dims, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, dt, dac, B, C, y, dims, s)
              : launch<float>(x, dt, dac, B, C, y, dims, s);
}

// registers, local (spill) bytes, static shared bytes, 0 (the dynamic
// shared bytes are the plan's) and block size of the kernel for one type
extern "C" int ssd_chunk_attrs(int bf16, int* out) {
  return bf16 ? attrs<__nv_bfloat16>(out) : attrs<float>(out);
}

extern "C" const char* ssd_chunk_error_string(int err) {
  if (err == TENSOR_MAP_ERROR)
    return "cuTensorMapEncodeTiled refused an operand";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
