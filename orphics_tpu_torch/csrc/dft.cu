// Column and row DFTs of re/im fp32 planes in the doubly-permuted ("pp")
// layout (kernels B3 and B4 of the port).
//
//   forward:  X[k] = sum_n x[n] w_N^(n k),  w_N = exp(-2 pi i / N)
//             stored at p = 128 k2 + k1 for k = k2 + Bk k1 (row_perm order)
//   inverse:  input in row_perm order, natural output, 1/N included
//
// along axis -2 of (batch, N, C) planes (B3, "COL") or axis -1 of
// (batch, R, N) planes (B4, "ROW"); N = 128 Bk with 2 <= Bk <= 32. A row
// transform may multiply its input by a (R, N) plane on load.
//
// Replaces orphics_tpu/ops/pallas_fft.py:_call (colfft/colifft; kernels
// _fwd_kernel, _inv_kernel) and :_row_call (rowfft/rowifft/
// rowifft_scaled_y; _rowfft_kernel, _rowifft_scaled_kernel). The TPU
// evaluates the 128-point stage as bf16-split matmuls on its MXU.
//
// Bound: device memory, 16 B per complex element (read re/im, write
// re/im) against 5 N log2 N flops per transform; at N = 512 that is ~3
// flops per byte, far below the card's balance point, so the design keeps
// each transform's whole working set in shared memory and touches device
// memory once in and once out.
//
// Design: the TPU's split N = 128 Bk, n = a + 128 b, k = k2 + Bk k1:
//   stage 1  G[k2, a] = sum_b x[a + 128 b] w_Bk^(b k2)   (direct Bk-point DFT)
//            H[k2, a] = G[k2, a] w_N^(a k2)               (twiddle)
//   stage 2  X[k2 + Bk k1] = sum_a H[k2, a] w_128^(a k1)  (radix-2 FFT)
// A block holds T whole transforms (T columns of one batch entry, or T
// rows) in shared memory. Stage 1 runs one thread per (a, transform) with
// the Bk values in registers; stage 2 is a decimation-in-frequency radix-2
// FFT over every 128-row segment, which leaves k1 in bit-reversed order,
// undone for free in the store's index. The inverse runs the two stages
// the other way round and writes the natural rows straight from stage 1.
// All twiddles come from tables built in float64 on the host and rounded
// to fp32 (no sincosf of fp32 angles). A simple kernel: no tensor cores,
// no pipelining of loads against compute.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int A = 128;
constexpr int THREADS = 256;
constexpr int MAX_SMEM = 200 * 1024;

__device__ __forceinline__ float2 cmul(float2 u, float2 w) {
  return make_float2(u.x * w.x - u.y * w.y, u.x * w.y + u.y * w.x);
}

__device__ __forceinline__ int brev7(int k) { return __brev(k) >> 25; }

// Tables (complex, fp32): w128[64] = w_128^j, wb[Bk] = w_Bk^j,
// tw[Bk][128] = w_N^(k2 a); conjugated for the inverse.
struct Tables {
  const float2* w128;
  const float2* wb;
  const float2* tw;
};

__device__ __forceinline__ Tables tables(const float2* t, int Bk) {
  return Tables{t, t + 64, t + 64 + Bk};
}

// Shared-memory slot of element t of transform r: transforms are rows of
// length N (ROW) or interleaved columns (COL), so that neighbouring
// threads touch neighbouring slots in every phase.
template <bool ROW>
__device__ __forceinline__ int slot(int t, int r, int N, int T) {
  return ROW ? r * N + t : t * T + r;
}

template <bool ROW, bool INV, int MAXBK>
__global__ void __launch_bounds__(THREADS)
dft_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
           float* __restrict__ ore, float* __restrict__ oim,
           const float2* __restrict__ tab, const float* __restrict__ scale,
           int N, int Bk, int T, int M, int C, int R) {
  extern __shared__ float2 s[];
  const Tables tb = tables(tab, Bk);
  const int tid = threadIdx.x;
  // this block's transforms: rows r0 .. r0+nr of (M, N), or columns
  // c0 .. c0+nr of batch entry b of (batch, N, C)
  int64_t base;
  int64_t tstride, rstride;
  int nr;
  if (ROW) {
    const int r0 = blockIdx.x * T;
    nr = min(T, M - r0);
    base = static_cast<int64_t>(r0) * N;
    tstride = 1;
    rstride = N;
  } else {
    const int c0 = blockIdx.x * T;
    nr = min(T, C - c0);
    base = static_cast<int64_t>(blockIdx.y) * N * C + c0;
    tstride = C;
    rstride = 1;
  }

  // load (rows optionally scaled); slots of missing transforms hold zeros
  for (int e = tid; e < N * T; e += THREADS) {
    const int t = ROW ? e % N : e / T;
    const int r = ROW ? e / N : e % T;
    float2 v = make_float2(0.0f, 0.0f);
    if (r < nr) {
      const int64_t g = base + t * tstride + r * rstride;
      v = make_float2(xre[g], xim[g]);
      if (ROW && scale) {
        const float sc =
            scale[(static_cast<int64_t>(blockIdx.x * T + r) % R) * N + t];
        v.x *= sc;
        v.y *= sc;
      }
    }
    s[slot<ROW>(t, r, N, T)] = v;
  }
  __syncthreads();

  if (!INV) {
    // stage 1: Bk-point DFT over the block index b, then the twiddle;
    // a thread reads and writes only the Bk slots of its own (a, r)
    for (int i = tid; i < A * T; i += THREADS) {
      const int a = ROW ? i % A : i / T;
      const int r = ROW ? i / A : i % T;
      float2 v[MAXBK];
#pragma unroll
      for (int b = 0; b < MAXBK; ++b)
        if (b < Bk) v[b] = s[slot<ROW>(a + A * b, r, N, T)];
#pragma unroll
      for (int k2 = 0; k2 < MAXBK; ++k2) {
        if (k2 < Bk) {
          float2 g = make_float2(0.0f, 0.0f);
          int m = 0;  // (b * k2) mod Bk
#pragma unroll
          for (int b = 0; b < MAXBK; ++b) {
            if (b < Bk) {
              const float2 w = tb.wb[m];
              g.x += v[b].x * w.x - v[b].y * w.y;
              g.y += v[b].x * w.y + v[b].y * w.x;
              m += k2;
              if (m >= Bk) m -= Bk;
            }
          }
          s[slot<ROW>(A * k2 + a, r, N, T)] = cmul(g, tb.tw[k2 * A + a]);
        }
      }
    }
    __syncthreads();
  }

  // the 128-point radix-2 DIF FFT of every segment (k2, r): natural in,
  // bit-reversed out
  const int nbfly = (A / 2) * Bk * T;
  for (int span = A / 2; span >= 1; span >>= 1) {
    const int wstep = (A / 2) / span;
    for (int i = tid; i < nbfly; i += THREADS) {
      int j, k2, r;
      if (ROW) {
        j = i % (A / 2);
        const int seg = i / (A / 2);
        k2 = seg % Bk;
        r = seg / Bk;
      } else {
        r = i % T;
        const int rest = i / T;
        j = rest % (A / 2);
        k2 = rest / (A / 2);
      }
      const int pos = j & (span - 1);
      const int t0 = A * k2 + (j - pos) * 2 + pos;
      const int s0 = slot<ROW>(t0, r, N, T);
      const int s1 = slot<ROW>(t0 + span, r, N, T);
      const float2 u = s[s0];
      const float2 v = s[s1];
      s[s0] = make_float2(u.x + v.x, u.y + v.y);
      s[s1] = cmul(make_float2(u.x - v.x, u.y - v.y), tb.w128[pos * wstep]);
    }
    __syncthreads();
  }

  if (!INV) {
    // store row p = 128 k2 + k1 from the bit-reversed slot
    for (int e = tid; e < N * T; e += THREADS) {
      const int t = ROW ? e % N : e / T;
      const int r = ROW ? e / N : e % T;
      if (r >= nr) continue;
      const int k2 = t / A;
      const float2 v = s[slot<ROW>(A * k2 + brev7(t % A), r, N, T)];
      const int64_t g = base + t * tstride + r * rstride;
      ore[g] = v.x;
      oim[g] = v.y;
    }
    return;
  }

  // inverse stage 1: twiddle, then the Bk-point DFT over k2, straight to
  // the natural rows a + 128 b
  const float inv_n = 1.0f / static_cast<float>(N);
  for (int i = tid; i < A * T; i += THREADS) {
    const int a = ROW ? i % A : i / T;
    const int r = ROW ? i / A : i % T;
    if (r >= nr) continue;
    float2 v[MAXBK];
    const int ar = brev7(a);
#pragma unroll
    for (int k2 = 0; k2 < MAXBK; ++k2)
      if (k2 < Bk)
        v[k2] = cmul(s[slot<ROW>(A * k2 + ar, r, N, T)], tb.tw[k2 * A + a]);
    for (int b = 0; b < Bk; ++b) {
      float2 g = make_float2(0.0f, 0.0f);
      int m = 0;  // (b * k2) mod Bk
#pragma unroll
      for (int k2 = 0; k2 < MAXBK; ++k2) {
        if (k2 < Bk) {
          const float2 w = tb.wb[m];
          g.x += v[k2].x * w.x - v[k2].y * w.y;
          g.y += v[k2].x * w.y + v[k2].y * w.x;
          m += b;
          if (m >= Bk) m -= Bk;
        }
      }
      const int64_t gi = base + (a + A * b) * tstride + r * rstride;
      ore[gi] = g.x * inv_n;
      oim[gi] = g.y * inv_n;
    }
  }
}

template <bool ROW, bool INV, int MAXBK>
int launch(const float* xre, const float* xim, float* ore, float* oim,
           const float2* tab, const float* scale, int N, int Bk, int T,
           int M, int C, int R, dim3 grid, cudaStream_t stream) {
  const int smem = N * T * static_cast<int>(sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      dft_kernel<ROW, INV, MAXBK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dft_kernel<ROW, INV, MAXBK><<<grid, THREADS, smem, stream>>>(
      xre, xim, ore, oim, tab, scale, N, Bk, T, M, C, R);
  return static_cast<int>(cudaGetLastError());
}

template <bool ROW, bool INV>
int launch_bk(const float* xre, const float* xim, float* ore, float* oim,
              const float2* tab, const float* scale, int N, int Bk, int T,
              int M, int C, int R, dim3 grid, cudaStream_t stream) {
  if (Bk <= 4)
    return launch<ROW, INV, 4>(xre, xim, ore, oim, tab, scale, N, Bk, T, M,
                               C, R, grid, stream);
  if (Bk <= 8)
    return launch<ROW, INV, 8>(xre, xim, ore, oim, tab, scale, N, Bk, T, M,
                               C, R, grid, stream);
  if (Bk <= 16)
    return launch<ROW, INV, 16>(xre, xim, ore, oim, tab, scale, N, Bk, T, M,
                                C, R, grid, stream);
  return launch<ROW, INV, 32>(xre, xim, ore, oim, tab, scale, N, Bk, T, M, C,
                              R, grid, stream);
}

// transforms per block: as many as fit 64 KB of shared memory (at least 8
// columns, so a warp's loads span 32-byte sectors), at most 32
int tile(int n, int row) {
  int t = 8192 / n;
  if (!row && t < 8) t = 8;
  if (t > 32) t = 32;
  if (t < 1) t = 1;
  while (t > 1 && n * t * static_cast<int>(sizeof(float2)) > MAX_SMEM) --t;
  return t;
}

}  // namespace

extern "C" {

int dft_max_n() { return 32 * A; }

// row = 1: planes (batch, other, n), transform along the last axis; scale
// (other, n) or null. row = 0: planes (batch, n, other), transform along
// axis -2; scale must be null. tab: the tables of dft.py:_tables.
int dft_launch(const float* xre, const float* xim, float* ore, float* oim,
               const void* tab, const float* scale, int row, int inverse,
               int batch, int n, int other, void* stream) {
  const int Bk = n / A;
  if (Bk * A != n || Bk < 2 || Bk > 32 || batch < 1 || other < 1
      || (!row && scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = tile(n, row);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* tb = static_cast<const float2*>(tab);
  if (row) {
    const int M = batch * other;
    const dim3 grid((M + T - 1) / T);
    return inverse
        ? launch_bk<true, true>(xre, xim, ore, oim, tb, scale, n, Bk, T, M, 0,
                                other, grid, st)
        : launch_bk<true, false>(xre, xim, ore, oim, tb, scale, n, Bk, T, M,
                                 0, other, grid, st);
  }
  const dim3 grid((other + T - 1) / T, batch);
  return inverse
      ? launch_bk<false, true>(xre, xim, ore, oim, tb, scale, n, Bk, T, 0,
                               other, 0, grid, st)
      : launch_bk<false, false>(xre, xim, ore, oim, tb, scale, n, Bk, T, 0,
                                other, 0, grid, st);
}

}  // extern "C"
