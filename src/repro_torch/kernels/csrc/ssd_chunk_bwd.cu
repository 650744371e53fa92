// ssd_chunk_bwd.cu -- the backward of the Mamba-2 intra-chunk SSD term for
// Hopper (sm_90a), in f32, at the models' layout.
//
// Replaces no TPU kernel: the JAX package differentiates its plain jnp
// intra-chunk term (models/layers.py::_ssd_chunked) with autodiff, and its
// Pallas kernel (kernels/ssd_chunk.py::_kernel, whose forward ssd_chunk.cu
// ports) has no VJP.  The port's forward runs the term on ssd_chunk.cu,
// so its gradient needs a kernel of its own: the backward of
// kernels/ops.py::ssd_intra_heads on CUDA tensors, once per Mamba-2 layer
// of a training step.
//
// For every chunk of Q <= 64 positions of a head k of group g, with c, b
// [Q, N] (the group's C and B rows), x, dy [Q, P], dt, dac [Q]:
//
//   s[i][j]    = sum_n c[i][n] * b[j][n]
//   E[i][j]    = exp(dac[i] - dac[j])          for i >= j (never above)
//   att[i][j]  = (s[i][j] * E[i][j]) * dt[j]   for i >= j, else 0
//   datt[i][j] = sum_p dy[i][p] * x[j][p]      for i >= j, else 0
//   dx[j][p]   = sum_i att[i][j] * dy[i][p]
//   ddt[j]     = sum_i datt[i][j] * E[i][j] * s[i][j]
//   W          = datt * att,  ddac[i] = sum_j W[i][j] - sum_i' W[i'][i]
//   ds_k       = datt * E * dt[j]
//   dC_g[i][n] = sum_j (sum_k ds_k)[i][j] * b[j][n]
//   dB_g[j][n] = sum_i (sum_k ds_k)[i][j] * c[i][n]
//
// (kernels/ref.py::ssd_intra_heads_bwd_ref, its oracle.)  Above the
// diagonal dac[i] - dac[j] > 0 and exp can overflow to inf; exp is never
// evaluated there (nor on the rows past a ragged Q), so no 0 * inf is
// formed.
//
// Operands are read where the caller has them, at their strides (any,
// element loads): x and dy [batch, seq, heads, P], dt and dac [batch, seq,
// heads], B and C [batch, seq, groups, N] (head k reads group
// k / (heads / groups)).  dx is written [batch, seq, heads, P], ddt and
// ddac [batch, seq, heads], dB and dC [batch, seq, groups, N], contiguous.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): at one mamba2-130m
// layer (batch 2, seq 4096, 24 heads, 1 group, N 128, P 64) the kernel
// reads x, dy (50.3 MB each), dt, dac (0.79 MB each), B, C (4.19 MB each)
// and writes dx, ddt, ddac, dB and dC: 171 MB, 51 us; against 1.84 GFLOP
// (27 us at the f32 peak) of the causal half.  Bytes bound it, as the
// forward's.
//
// Design: simple first.  One block of 256 threads per item = (batch,
// chunk, group), so the item's heads never split across blocks: every sum
// is taken in one fixed order (no atomics), and two launches on the same
// inputs agree bit for bit (remat, a data mesh).  The block holds c and b
// [Q, N], s, and the heads' running sum of ds in shared memory for the
// whole item, and walks the group's heads in order; per head it loads x
// and dy [Q, P] and dt, dac, then
//   A. datt (a [64 x 64] product over P) and att, elementwise;
//   B. dx (a [64 x P] product over i >= j), written out; ds added into
//      the sum; ddt and the row and column sums of W;
//   C. ddac written out.
// At the item's end dC and dB ([64 x N] products over the sum) are written
// out.  Each product gives a thread a 4-row x (4 or 8)-column tile: rows
// 4 ty.. of the output, columns tx + 16 c; shared rows have an odd pitch,
// so the 16 threads of a tile row read 16 different banks.  Arithmetic:
// plain FFMA in f32, as the forward's; expf accurate (no fast math).
//
// Shared memory at N 128, P 64: c and b 2 x 64 x 129 floats, s, att, datt
// and the ds sum 4 x 64 x 65, x and dy 2 x 64 x 65, 3 x 64 vectors: 167
// KB; at P 128, 200 KB.  One block an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QMAX = 64;           // rows of a chunk the kernel holds
constexpr int NMAX = 128;          // state width
constexpr int PMAX = 128;          // head width
constexpr int THREADS = 256;
constexpr int QP = QMAX + 1;       // pitch (floats) of the [64][64] tiles
constexpr int SMEM_LIMIT = 232448; // a block's most, H100

struct Params {
  const float* x;
  const float* dt;
  const float* dac;
  const float* B;
  const float* C;
  const float* dy;
  float* dx;
  float* ddt;
  float* ddac;
  float* dB;
  float* dC;
  int batch, seqlen, heads, groups, Q, N, P;
  long long sx[4], sdt[3], sdac[3], sB[4], sC[4], sdy[4];
  int nc16, pc16;                  // 16-column blocks of N and of P
  int npitch, ppitch;              // shared row pitches (odd)
};

// the shared layout, in floats
struct Smem {
  float *c, *b, *s, *att, *datt, *dsum, *x, *dy, *dt, *dac, *roww;
};

__device__ __forceinline__ Smem carve(float* base, const Params& p) {
  Smem m;
  m.c = base;
  m.b = m.c + QMAX * p.npitch;
  m.s = m.b + QMAX * p.npitch;
  m.att = m.s + QMAX * QP;
  m.datt = m.att + QMAX * QP;
  m.dsum = m.datt + QMAX * QP;
  m.x = m.dsum + QMAX * QP;
  m.dy = m.x + QMAX * p.ppitch;
  m.dt = m.dy + QMAX * p.ppitch;
  m.dac = m.dt + QMAX;
  m.roww = m.dac + QMAX;
  return m;
}

size_t smem_floats(const Params& p) {
  return size_t(QMAX) * (2 * p.npitch + 4 * QP + 2 * p.ppitch) + 3 * QMAX;
}

// rows [Q, 64) and columns [width, 16 * blocks) zero, so the products run
// over whole tiles and add nothing from them
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const float* src,
                                          const long long* st, int bb,
                                          int row0, int col, int Q,
                                          int width, int blocks) {
  const int w = 16 * blocks;
  for (int idx = threadIdx.x; idx < QMAX * w; idx += THREADS) {
    const int i = idx / w, e = idx - i * w;
    float v = 0.f;
    if (i < Q && e < width)
      v = src[bb * st[0] + (long long)(row0 + i) * st[1] + col * st[2] +
              e * st[3]];
    dst[i * pitch + e] = v;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    ssd_bwd_kernel(const Params p) {
  extern __shared__ float smem_raw[];
  const Smem sm = carve(smem_raw, p);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int Q = p.Q;
  const int nchunks = p.seqlen / Q;
  const int item = blockIdx.x;
  const int g = item % p.groups;
  const int rest = item / p.groups;
  const int chunk = rest % nchunks;
  const int bb = rest / nchunks;
  const int row0 = chunk * Q;
  const int rep = p.heads / p.groups;

  load_rows(sm.c, p.npitch, p.C, p.sC, bb, row0, g, Q, p.N, p.nc16);
  load_rows(sm.b, p.npitch, p.B, p.sB, bb, row0, g, Q, p.N, p.nc16);
  for (int idx = tid; idx < QMAX * QP; idx += THREADS) sm.dsum[idx] = 0.f;
  __syncthreads();

  // s: rows 4 ty + r, columns tx + 16 c; sum over n from +0 in order
  {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int n = 0; n < p.N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = sm.c[(4 * ty + r) * p.npitch + n];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = sm.b[(tx + 16 * c) * p.npitch + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sm.s[(4 * ty + r) * QP + tx + 16 * c] = acc[r][c];
  }

  for (int kr = 0; kr < rep; ++kr) {
    const int k = g * rep + kr;
    // the head's rows (the previous head's readers passed the barrier
    // that ended its phase B)
    load_rows(sm.x, p.ppitch, p.x, p.sx, bb, row0, k, Q, p.P, p.pc16);
    load_rows(sm.dy, p.ppitch, p.dy, p.sdy, bb, row0, k, Q, p.P, p.pc16);
    if (tid < QMAX) {
      float t = 0.f, a = 0.f;
      if (tid < Q) {
        const long long r = bb * p.sdt[0] + (long long)(row0 + tid) * p.sdt[1]
                            + k * p.sdt[2];
        const long long ra = bb * p.sdac[0] +
                             (long long)(row0 + tid) * p.sdac[1] +
                             k * p.sdac[2];
        t = p.dt[r];
        a = p.dac[ra];
      }
      sm.dt[tid] = t;
      sm.dac[tid] = a;
    }
    __syncthreads();

    // A. datt = dy x^T (masked to j <= i < Q), then att elementwise
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int e = 0; e < p.P; ++e) {
        float dv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) dv[r] = sm.dy[(4 * ty + r) * p.ppitch + e];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = sm.x[(tx + 16 * c) * p.ppitch + e];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(dv[r], xv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * ty + r, j = tx + 16 * c;
          sm.datt[i * QP + j] = (j <= i && i < Q) ? acc[r][c] : 0.f;
        }
    }
    for (int idx = tid; idx < QMAX * QMAX; idx += THREADS) {
      const int i = idx >> 6, j = idx & 63;
      float a = 0.f;
      if (j <= i && i < Q)
        a = (sm.s[i * QP + j] * expf(sm.dac[i] - sm.dac[j])) * sm.dt[j];
      sm.att[i * QP + j] = a;
    }
    __syncthreads();

    // B. ds into the sum; the column (ddt, W) and row (W) sums; dx
    for (int idx = tid; idx < QMAX * QMAX; idx += THREADS) {
      const int i = idx >> 6, j = idx & 63;
      if (j <= i && i < Q)
        sm.dsum[i * QP + j] +=
            (sm.datt[i * QP + j] * expf(sm.dac[i] - sm.dac[j])) * sm.dt[j];
    }
    float colw = 0.f;
    if (tid < QMAX) {
      // column j = tid: every thread of a warp on one row at a time
      const int j = tid;
      float dd = 0.f;
      for (int i = 0; i < Q; ++i) {
        if (i >= j && j < Q) {
          const float gd = sm.datt[i * QP + j];
          dd = fmaf(gd * expf(sm.dac[i] - sm.dac[j]), sm.s[i * QP + j], dd);
          colw = fmaf(gd, sm.att[i * QP + j], colw);
        }
      }
      if (j < Q)
        p.ddt[((long long)bb * p.seqlen + row0 + j) * p.heads + k] = dd;
    } else if (tid < 2 * QMAX) {
      // row i = tid - 64 (odd pitch: 32 rows, 32 banks)
      const int i = tid - QMAX;
      float rw = 0.f;
      for (int j = 0; j <= i && i < Q; ++j)
        rw = fmaf(sm.datt[i * QP + j], sm.att[i * QP + j], rw);
      sm.roww[i] = rw;
    }
    // dx: rows j = 4 ty + r, columns tx + 16 c; over i >= 4 ty (att is 0
    // above the diagonal)
    {
      float acc[4][PMAX / 16];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < PMAX / 16; ++c) acc[r][c] = 0.f;
      for (int i = 4 * ty; i < Q; ++i) {
        float av[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = sm.att[i * QP + 4 * ty + r];
#pragma unroll
        for (int c = 0; c < PMAX / 16; ++c) {
          if (c < p.pc16) {
            const float d = sm.dy[i * p.ppitch + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(av[r], d, acc[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 4 * ty + r;
        if (j < Q) {
          float* out = p.dx + (((long long)bb * p.seqlen + row0 + j) *
                                   p.heads + k) * p.P;
#pragma unroll
          for (int c = 0; c < PMAX / 16; ++c) {
            const int e = tx + 16 * c;
            if (c < p.pc16 && e < p.P) out[e] = acc[r][c];
          }
        }
      }
    }
    __syncthreads();

    // C. ddac
    if (tid < Q)
      p.ddac[((long long)bb * p.seqlen + row0 + tid) * p.heads + k] =
          sm.roww[tid] - colw;
  }
  __syncthreads();

  // dC = dsum b (rows i, over j <= i) and dB = dsum^T c (rows j, over
  // i >= j); columns tx + 16 c of N
  {
    float acc[4][NMAX / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NMAX / 16; ++c) acc[r][c] = 0.f;
    for (int j = 0; j < 4 * ty + 4 && j < Q; ++j) {
      float dv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dv[r] = sm.dsum[(4 * ty + r) * QP + j];
#pragma unroll
      for (int c = 0; c < NMAX / 16; ++c) {
        if (c < p.nc16) {
          const float bv = sm.b[j * p.npitch + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(dv[r], bv, acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ty + r;
      if (i < Q) {
        float* out = p.dC + (((long long)bb * p.seqlen + row0 + i) *
                                 p.groups + g) * p.N;
#pragma unroll
        for (int c = 0; c < NMAX / 16; ++c) {
          const int e = tx + 16 * c;
          if (c < p.nc16 && e < p.N) out[e] = acc[r][c];
        }
      }
    }
  }
  {
    float acc[4][NMAX / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NMAX / 16; ++c) acc[r][c] = 0.f;
    for (int i = 4 * ty; i < Q; ++i) {
      float dv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dv[r] = sm.dsum[i * QP + 4 * ty + r];
#pragma unroll
      for (int c = 0; c < NMAX / 16; ++c) {
        if (c < p.nc16) {
          const float cv = sm.c[i * p.npitch + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(dv[r], cv, acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * ty + r;
      if (j < Q) {
        float* out = p.dB + (((long long)bb * p.seqlen + row0 + j) *
                                 p.groups + g) * p.N;
#pragma unroll
        for (int c = 0; c < NMAX / 16; ++c) {
          const int e = tx + 16 * c;
          if (c < p.nc16 && e < p.N) out[e] = acc[r][c];
        }
      }
    }
  }
}

// dims (int64): batch, seqlen, heads, groups, Q, N, P, then the strides
// of x, dy, B, C (four each: batch, seq, head or group, element) and of
// dt, dac (three each)
constexpr int NDIMS = 7 + 16 + 6;

int launch(const float* x, const float* dt, const float* dac, const float* B,
           const float* C, const float* dy, float* dx, float* ddt,
           float* ddac, float* dB, float* dC, const long long* d,
           cudaStream_t s) {
  Params p;
  p.x = x;
  p.dt = dt;
  p.dac = dac;
  p.B = B;
  p.C = C;
  p.dy = dy;
  p.dx = dx;
  p.ddt = ddt;
  p.ddac = ddac;
  p.dB = dB;
  p.dC = dC;
  p.batch = int(d[0]);
  p.seqlen = int(d[1]);
  p.heads = int(d[2]);
  p.groups = int(d[3]);
  p.Q = int(d[4]);
  p.N = int(d[5]);
  p.P = int(d[6]);
  for (int k = 0; k < 4; ++k) {
    p.sx[k] = d[7 + k];
    p.sdy[k] = d[11 + k];
    p.sB[k] = d[15 + k];
    p.sC[k] = d[19 + k];
  }
  for (int k = 0; k < 3; ++k) {
    p.sdt[k] = d[23 + k];
    p.sdac[k] = d[26 + k];
  }
  if (p.Q < 1 || p.Q > QMAX || p.N < 1 || p.N > NMAX || p.P < 1 ||
      p.P > PMAX || p.batch < 1 || p.seqlen < p.Q || p.seqlen % p.Q != 0 ||
      p.groups < 1 || p.heads % p.groups != 0)
    return cudaErrorInvalidValue;
  p.nc16 = (p.N + 15) / 16;
  p.pc16 = (p.P + 15) / 16;
  p.npitch = 16 * p.nc16 + 1;
  p.ppitch = 16 * p.pc16 + 1;
  const long long items = (long long)p.batch * (p.seqlen / p.Q) * p.groups;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem = smem_floats(p) * sizeof(float);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_LIMIT);
  if (e != cudaSuccess) return e;
  ssd_bwd_kernel<<<int(items), THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (bound with ctypes).  Each returns a cudaError_t; the caller
// raises on anything but 0.
// ---------------------------------------------------------------------------

extern "C" int ssd_chunk_bwd_ndims() { return NDIMS; }

extern "C" int ssd_chunk_bwd_launch(const void* x, const void* dt,
                                    const void* dac, const void* B,
                                    const void* C, const void* dy, void* dx,
                                    void* ddt, void* ddac, void* dB, void* dC,
                                    const long long* dims, void* stream) {
  return launch(static_cast<const float*>(x), static_cast<const float*>(dt),
                static_cast<const float*>(dac), static_cast<const float*>(B),
                static_cast<const float*>(C), static_cast<const float*>(dy),
                static_cast<float*>(dx), static_cast<float*>(ddt),
                static_cast<float*>(ddac), static_cast<float*>(dB),
                static_cast<float*>(dC), dims,
                static_cast<cudaStream_t>(stream));
}

// the dynamic shared bytes a launch at (N, P) takes
extern "C" long long ssd_chunk_bwd_smem_bytes(int n, int p) {
  Params q;
  q.npitch = 16 * ((n + 15) / 16) + 1;
  q.ppitch = 16 * ((p + 15) / 16) + 1;
  return (long long)(smem_floats(q) * sizeof(float));
}

// registers, local (spill) bytes, static shared bytes and block size
extern "C" int ssd_chunk_bwd_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, ssd_bwd_kernel);
  if (err != cudaSuccess) return int(err);
  out[0] = a.numRegs;
  out[1] = int(a.localSizeBytes);
  out[2] = int(a.sharedSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  return 0;
}

extern "C" const char* ssd_chunk_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
