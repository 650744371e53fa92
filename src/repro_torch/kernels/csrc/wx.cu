// wx.cu -- out[l] = a[l] + W @ x[l] for Hopper (sm_90a): the transposed-
// Cannon multiply-accumulate step of the 2-D token mix, and its dx.
//
// Replaces the TPU kernel kernels/fused_ring.py::_wx_kernel (pallas_call in
// _wx_raw(), wrapped by the custom VJP _wx_acc and by cannon_t_step) of the
// JAX package.  Every Cannon step of a token-mix linear under scheme="2d"
// is one launch, forward and dx.
//
//   W [M, K] is read from w, stored either [M, K] (K contiguous, w_t = 0:
//   the forward, W = w[m, t]) or [K, M] (w_t = 1: dx = w.T @ dy, w read
//   across its rows);
//   x: [L, K, N], each batch element stored [K, N] (N contiguous): the
//   product contracts x's second-to-last dim, so x is never transposed;
//   a: [L, M, N] in the output dtype, or none (a zero accumulator);
//   out: [L, M, N], f32 or bf16 (the accumulator's dtype).
//
// The sum over K is kept in f32, a is up-cast and added in the epilogue,
// and the sum is rounded once to the output dtype.  out may alias a: each
// element of a is read once, by the thread that then writes the same
// element of out.
//
// Bound: at the full-width shapes (M 4,320-16,380, K 4,320-16,380, N 2,160
// or 4,320) a step does ~1,000-2,000 FLOP per byte it must move in bf16,
// above the ~295 FLOP/byte ridge: tensor-core FLOPs bound it.
//
// Design: bf16 operands run the Hopper loop of gemm_sm90.cuh (wgmma fed by
// a TMA producer through a 4-stage mbarrier ring of [128 x 256] tiles, one
// persistent 384-thread block per SM): A = W, K-major (w_t = 0) or M-major
// (w_t = 1); B = x[l], N-major, read through a 3-D tensor map {N, K, L}
// (W's batch stride is 0: one map of batch 1); tiles l-major, then in
// bands of 8 rows of tiles (sm90::grouped_tile), without a hop.  The
// epilogue adds a and rounds from the accumulator registers.  Each operand
// carries its own row stride (TMA takes multiples of 16 bytes: the wrapper
// pads a 2x2 rank's w rows of 8,190 once per call).  The forward is bit
// for bit the WMMA kernel it replaces (gemm_core.cuh's loop): the same k16
// steps, 2 * ceil(K / 32), in K order, zeroed accumulators, the same
// epilogue; wgmma's k16 step rounds as mma.sync's on this card.
//
// dx on the tensor cores.  The reference computes dx = w.T.astype(f32) @
// dy with dy the f32 cotangent of the accumulator.  Every bf16 w is exact
// in f32, so the product is exact where dy is too; and any f32 dy is the
// sum of three bf16 terms, hi = bf16(dy), mid = bf16(dy - hi), lo =
// bf16(dy - hi - mid), exactly (bf16 keeps 8 of f32's 24 significand bits
// and f32's exponent range).  So dx = W @ hi + W @ mid + W @ lo, each
// product exact in f32: wx_split writes the three terms as one bf16 buffer
// [3 L, K, N] and a device flag that says whether mid and lo are zero
// everywhere; the GEMM reads the flag on the device and contracts over
// [hi; mid; lo] (K' = 3 k-tiled K, W's tile loaded again for each term) or
// over hi alone, at f32 accumulation.  No host sync, no data-dependent
// host branch.  On the 2-D path dy is the f32 image of a bf16 cotangent
// (the Cannon product is cast to bf16 before anything reads it), so the
// flag is clear and dx costs one bf16 GEMM plus the split pass.  The GEMM
// adds one to counts[terms] (block 0's first thread), so a run can show
// how many terms its dx launches took.
//
// f32 operands (the fp32 policy) keep gemm_core.cuh's exact FMA tiles on
// the CUDA cores, blockIdx.z = l.

#include "gemm_core.cuh"
#include "gemm_sm90.cuh"

namespace {

using gemm::bf16;
using gemm::store_out;
using gemm::to_float;

// ---------------------------------------------------------------------------
// bf16 operands: the Hopper loop (gemm_sm90.cuh)
// ---------------------------------------------------------------------------

// Tiles: l-major, then out[l] [M, N] in sm90::grouped_tile's order.  A =
// W (K-major w [M, K], or M-major w stored [K, M] when WT; row stride
// ld_w), B = x[l] [K, N] (N-major, row stride ld_x, batch stride K * ld_x).
// With `flag`, x holds `terms` split terms of the cotangent, term i at
// batch i * L + l, and a tile contracts over them in turn: k-tiles of
// kpad = 64 * k_tiles(K) columns each.
template <bool WT, typename OutT>
struct WxProblem {
  static constexpr bool B_KMAJOR = false;
  const CUtensorMap* mw;
  const CUtensorMap* mx;
  const OutT* a;
  OutT* out;
  const int* flag;
  int* counts;
  int M, N, K, L, kpad, terms, tiles_m, tiles_n, vec2;

  __device__ int tiles() const { return L * tiles_m * tiles_n; }

  __device__ sm90::Tile tile(int t) const {
    int tm, tn;
    sm90::grouped_tile(t % (tiles_m * tiles_n), tiles_m, tiles_n, tm, tn);
    return {0, tm * sm90::BM, tn * sm90::BN, t / (tiles_m * tiles_n),
            terms == 1 ? K : terms * kpad};
  }

  __device__ bool a_mn(int) const { return WT; }

  __device__ void load(const sm90::Tile& tl, int k0, uint32_t a, uint32_t b,
                       uint32_t bar) const {
    const int term = k0 / kpad;   // 0 with one term: k0 < K <= kpad
    const int kk = k0 - term * kpad;
    if (WT) {
      sm90::tma_load(a, mw, tl.m0, kk, 0, bar);
      sm90::tma_load(a + sm90::BOX_BYTES, mw, tl.m0 + 64, kk, 0, bar);
    } else {
      sm90::tma_load(a, mw, kk, tl.m0, 0, bar);
    }
#pragma unroll
    for (int i = 0; i < sm90::BN / 64; ++i)
      sm90::tma_load(b + i * sm90::BOX_BYTES, mx, tl.n0 + 64 * i, kk,
                     term * L + tl.l, bar);
  }

  __device__ void store(const sm90::Tile& tl, const float (&acc)[sm90::ACC],
                        int row, int col) const {
    const size_t base = size_t(tl.l) * M * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row + 8 * h;
      if (gm >= M) continue;
      const size_t o = base + size_t(gm) * N;
#pragma unroll
      for (int j = 0; j < sm90::BN / 8; ++j) {
        const int gn = col + 8 * j;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (vec2) {  // N even: gn < N means gn + 1 < N
          if (gn < N) {
            if (a != nullptr) {
              const float2 p = sm90::load_pair(a + o + gn);
              v0 = p.x + v0;
              v1 = p.y + v1;
            }
            sm90::store_pair(out + o + gn, v0, v1);
          }
        } else {
          if (gn < N) {
            if (a != nullptr) v0 = to_float(a[o + gn]) + v0;
            store_out(out + o + gn, v0);
          }
          if (gn + 1 < N) {
            if (a != nullptr) v1 = to_float(a[o + gn + 1]) + v1;
            store_out(out + o + gn + 1, v1);
          }
        }
      }
    }
  }

  __device__ void copy(int, int) const {}
};

template <bool WT, typename OutT>
__global__ void __launch_bounds__(sm90::THREADS, 1)
wx_sm90_kernel(const __grid_constant__ CUtensorMap mw,
               const __grid_constant__ CUtensorMap mx,
               WxProblem<WT, OutT> st) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WxProblem<WT, OutT> p = st;
  p.mw = &mw;
  p.mx = &mx;
  // the split route: three terms unless the split found mid and lo zero
  if (p.flag != nullptr) {
    p.terms = *p.flag ? 3 : 1;
    if (blockIdx.x == 0 && threadIdx.x == 0 && p.counts != nullptr)
      atomicAdd(p.counts + p.terms, 1);
  }
  sm90::run(p, smem_raw);
}

template <bool WT, typename OutT>
int launch_sm90(const void* w, const void* x, const void* a, void* out,
                const int* flag, int* counts, int L, int M, int N, int K,
                int ld_w, int ld_x, int vec2, cudaStream_t s) {
  auto kernel = wx_sm90_kernel<WT, OutT>;
  static const int reg_err = sm90::check_registers(kernel);
  if (reg_err != 0) return reg_err;
  const int batches = flag != nullptr ? 3 * L : L;
  CUtensorMap mw, mx;
  const int mw_err = WT ? sm90::make_map(&mw, w, M, K, 1, ld_w, 64, 64)
                        : sm90::make_map(&mw, w, K, M, 1, ld_w, 64, 128);
  if (mw_err != 0 ||
      sm90::make_map(&mx, x, N, K, batches, ld_x, 64, 64) != 0)
    return sm90::TENSOR_MAP_ERROR;
  WxProblem<WT, OutT> st;
  st.mw = st.mx = nullptr;
  st.a = static_cast<const OutT*>(a);
  st.out = static_cast<OutT*>(out);
  st.flag = flag;
  st.counts = counts;
  st.M = M;
  st.N = N;
  st.K = K;
  st.L = L;
  st.kpad = sm90::k_tiles(K) * sm90::BK;
  st.terms = 1;
  st.tiles_m = (M + sm90::BM - 1) / sm90::BM;
  st.tiles_n = (N + sm90::BN - 1) / sm90::BN;
  st.vec2 = vec2;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(sm90::SMEM_BYTES));
  if (e != cudaSuccess) return int(e);
  kernel<<<sm90::grid_size(L * st.tiles_m * st.tiles_n, false), sm90::THREADS,
           sm90::SMEM_BYTES, s>>>(mw, mx, st);
  return int(cudaGetLastError());
}

template <typename OutT>
int launch_sm90_layout(const void* w, const void* x, const void* a,
                       void* out, const int* flag, int* counts, int L, int M,
                       int N, int K, int ld_w, int ld_x, int w_t, int vec2,
                       cudaStream_t s) {
  if (w_t)
    return launch_sm90<true, OutT>(w, x, a, out, flag, counts, L, M, N, K,
                                   ld_w, ld_x, vec2, s);
  return launch_sm90<false, OutT>(w, x, a, out, flag, counts, L, M, N, K,
                                  ld_w, ld_x, vec2, s);
}

// ---------------------------------------------------------------------------
// the split of an f32 cotangent into three bf16 terms
// ---------------------------------------------------------------------------

// x [rows, N] f32 contiguous (rows = L * K) -> parts [3][rows][ld] bf16:
// hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), each rounded
// to nearest even (v - hi and its remainder are exact in f32).  *flag is
// set where any mid or lo is not zero (the caller zeroes it first).
// Threads take pairs of columns when N is even (PAIR = 2), else one.
template <int PAIR>
__global__ void __launch_bounds__(256)
wx_split_kernel(const float* __restrict__ x, bf16* __restrict__ parts,
                int* flag, int rows, int N, int ld) {
  constexpr int pair = PAIR;
  const size_t part = size_t(rows) * ld;
  const int per_row = N / pair;
  int nonzero = 0;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < per_row;
         c += gridDim.x * blockDim.x) {
      float v[2];
      const int n0 = c * pair;
      if constexpr (pair == 2) {
        const float2 p =
            *reinterpret_cast<const float2*>(x + size_t(r) * N + n0);
        v[0] = p.x;
        v[1] = p.y;
      } else {
        v[0] = x[size_t(r) * N + n0];
      }
      bf16 t[3][2];
#pragma unroll
      for (int i = 0; i < pair; ++i) {
        t[0][i] = __float2bfloat16(v[i]);
        const float r1 = v[i] - __bfloat162float(t[0][i]);
        t[1][i] = __float2bfloat16(r1);
        t[2][i] = __float2bfloat16(r1 - __bfloat162float(t[1][i]));
        nonzero |= (__bfloat16_as_ushort(t[1][i]) |
                    __bfloat16_as_ushort(t[2][i])) & 0x7fff;  // not +-0
      }
      const size_t o = size_t(r) * ld + n0;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if constexpr (pair == 2) {
          *reinterpret_cast<__nv_bfloat162*>(parts + j * part + o) =
              __halves2bfloat162(t[j][0], t[j][1]);
        } else {
          parts[j * part + o] = t[j][0];
        }
      }
    }
  }
  if (__syncthreads_or(nonzero) && threadIdx.x == 0) atomicOr(flag, 1);
}

// ---------------------------------------------------------------------------
// f32 operands: exact FMA on the CUDA cores (gemm::f32_tile)
// ---------------------------------------------------------------------------

template <bool WT, typename OutT>
__global__ void __launch_bounds__(gemm::FTHREADS)
wx_f32_kernel(const float* __restrict__ w, const float* __restrict__ x,
              const OutT* a, OutT* out, int M, int N, int K) {
  __shared__ __align__(16) float As[gemm::FBK][gemm::FLD];  // As[k][m]
  __shared__ __align__(16) float Bs[gemm::FBK][gemm::FLD];  // Bs[k][n]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * gemm::FBM, n0 = blockIdx.x * gemm::FBN;
  const size_t l = blockIdx.z;
  float acc[8][8];
  gemm::f32_tile<WT, true>(w, x + l * size_t(K) * N, M, N, K, m0, n0, As,
                           Bs, acc);

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
      if (a != nullptr) v = to_float(a[o]) + v;
      store_out(out + o, v);
    }
  }
}

template <bool WT, typename OutT>
cudaError_t launch_f32(const void* w, const void* x, const void* a,
                       void* out, int L, int M, int N, int K,
                       cudaStream_t stream) {
  const dim3 grid((N + gemm::FBN - 1) / gemm::FBN,
                  (M + gemm::FBM - 1) / gemm::FBM, L);
  wx_f32_kernel<WT, OutT><<<grid, gemm::FTHREADS, 0, stream>>>(
      static_cast<const float*>(w), static_cast<const float*>(x),
      static_cast<const OutT*>(a), static_cast<OutT*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_f32_layout(const void* w, const void* x, const void* a,
                              void* out, int L, int M, int N, int K, int w_t,
                              cudaStream_t s) {
  if (w_t) return launch_f32<true, OutT>(w, x, a, out, L, M, N, K, s);
  return launch_f32<false, OutT>(w, x, a, out, L, M, N, K, s);
}

template <bool WT>
int sm90_attrs(int out_bf16, int* out) {
  return out_bf16 ? sm90::kernel_attrs(wx_sm90_kernel<WT, bf16>,
                                       sm90::SMEM_BYTES, out)
                  : sm90::kernel_attrs(wx_sm90_kernel<WT, float>,
                                       sm90::SMEM_BYTES, out);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (bound with ctypes).  Each returns the cudaError_t of the
// launch, or sm90::TENSOR_MAP_ERROR / sm90::REGISTER_ERROR; the caller
// raises on anything but 0.  w_t: 0 = w stored [M, K], 1 = stored [K, M].
// out_bf16: 0 = a and out are f32, 1 = bf16.  a and out contiguous [L, M,
// N].
//
// wx_bf16: w at row stride ld_w, x [L, K, N] at row stride ld_x (multiples
// of 8 elements, bases 16-byte aligned); flag null: x is bf16 x; else x is
// wx_split's parts [3 L, K, N] and flag its flag, and counts (or null) an
// int[4] the launch adds one to at its term count.  vec2: N is even and a,
// out 8-byte aligned (pairs of columns per access).
// wx_split: x [L, K, N] f32 contiguous -> parts at row stride ld, *flag.
// wx_f32: w, x contiguous f32.
// ---------------------------------------------------------------------------

extern "C" int wx_bf16(const void* w, const void* x, const void* a,
                       void* out, const int* flag, int* counts, int L, int M,
                       int N, int K, int ld_w, int ld_x, int w_t,
                       int out_bf16, int vec2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_sm90_layout<bf16>(w, x, a, out, flag, counts, L, M, N, K,
                                    ld_w, ld_x, w_t, vec2, s);
  return launch_sm90_layout<float>(w, x, a, out, flag, counts, L, M, N, K,
                                   ld_w, ld_x, w_t, vec2, s);
}

extern "C" int wx_split(const void* x, void* parts, int* flag, int L, int K,
                        int N, int ld, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flag, 0, sizeof(int), s);
  if (e != cudaSuccess) return int(e);
  const int rows = L * K;
  const int pair = (N % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 8 == 0) ? 2 : 1;
  const int per_row = N / pair;
  const dim3 grid((per_row + 255) / 256, rows < 65535 ? rows : 65535);
  const float* xf = static_cast<const float*>(x);
  bf16* pb = static_cast<bf16*>(parts);
  if (pair == 2) {
    wx_split_kernel<2><<<grid, 256, 0, s>>>(xf, pb, flag, rows, N, ld);
  } else {
    wx_split_kernel<1><<<grid, 256, 0, s>>>(xf, pb, flag, rows, N, ld);
  }
  return int(cudaGetLastError());
}

extern "C" int wx_f32(const void* w, const void* x, const void* a, void* out,
                      int L, int M, int N, int K, int w_t, int out_bf16,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_f32_layout<bf16>(w, x, a, out, L, M, N, K, w_t, s);
  return launch_f32_layout<float>(w, x, a, out, L, M, N, K, w_t, s);
}

// Attributes of a kernel variant (sm90::kernel_attrs: registers, local
// bytes, static and dynamic shared bytes, block size): kernel 0 the Hopper
// loop at (w_t, out_bf16), 1 the split pass (pairs of columns).
extern "C" int wx_attrs(int kernel, int w_t, int out_bf16, int* out) {
  switch (kernel) {
    case 0: return w_t ? sm90_attrs<true>(out_bf16, out)
                       : sm90_attrs<false>(out_bf16, out);
    case 1: return sm90::kernel_attrs(wx_split_kernel<2>, 0, out);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* wx_error_string(int err) {
  if (err == sm90::TENSOR_MAP_ERROR)
    return "cuTensorMapEncodeTiled refused an operand";
  if (err == sm90::REGISTER_ERROR)
    return "the kernel's register count leaves setmaxnreg no room";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
