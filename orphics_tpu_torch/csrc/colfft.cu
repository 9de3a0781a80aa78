// Column DFTs of re/im fp32 planes on the register-resident core (kernels B3
// colfft / colifft and B3s colfft_scaled of the port, for Bk = n / 128 a
// power of two from 2 to 32; dft.cu's dft_launch sends every other Bk to
// its radix-2 kernel).
//
//   forward:  X[k] = sum_t x[t] w_N^(t k) along axis -2 of (batch, N, C)
//             planes, stored at row p = 128 k2 + k1 for k = k2 + Bk k1
//             (row_perm order); B3s multiplies x by an (N, C) window shared
//             by the batch on the load
//   inverse:  row_perm-ordered rows in, natural rows out, 1/N included
//
// Replaces orphics_tpu/ops/pallas_fft.py:_call (colfft / colifft; kernels
// _fwd_kernel, _inv_kernel) and :colfft_scaled (_fwd_scaled_kernel).
//
// Bound: device memory, 16 B per complex element (read re/im, write re/im;
// B3s 4 B more per window element) against ~60 fp32 operations per
// element. dft.cu's radix-2 core ran seven barrier-separated sweeps of a
// 128 KB block and reached 0.35 TB/s; this kernel runs dft_core.cuh's
// register-resident split with two block barriers:
//
// Forward, thread (c, a) of a block of CW columns (lanes vary over c first,
// so each load and store of a warp covers CW contiguous floats of a row):
//   1. load x[a + 128 b, c] for b < Bk into registers (all loads in flight
//      together), the Bk-point FFT there (fft_regs), the w_N^(a k2)
//      twiddle, G[k2, a] to slot a of segment (c, k2);
//   2. after one barrier, 8 lanes per segment run the 128-point DFT as
//      16 x 8 (fft128_seg); a warp owns whole segments, so __syncwarp is its
//      only barrier; X[k2 + Bk k1] ends at slot k1 of segment (c, k2);
//   3. after a second barrier, row p = 128 k2 + k1 of column c is read from
//      segment (c, k2), slot k1 and stored.
// Inverse, the same steps the other way round: rows p into segment
// (p / 128), slot p % 128; fft128_seg<true> (natural order in and out);
// then thread (c, a) gathers its Bk values over k2, multiplies by the
// conjugate twiddle (the inverse tables), runs fft_regs<Bk, true>, scales
// by 1/N and stores rows a + 128 b.
//
// Shapes: a thread holds R values of a (a = a0 + (128 / R) r), each with
// its Bk values, so every thread has 16 values at Bk <= 16 (32 at Bk = 32)
// and every block holds CW whole columns in ~137 KB of shared memory (70
// KB at Bk = 2): CW = 32 at Bk = 2, 4 (128-byte rows), 16 at 8, 8 at 16
// (32-byte rows: 8 columns of 2048 rows are all that fit), 4 at 32. So an
// SM holds one block (two at Bk = 2), whose loads nothing overlaps: each
// block, once its own loads are issued (forward) or stored to the segments
// (inverse), asks L2 for the input of the block half a wave of SMs ahead
// (prefetch.global.L2), so that block's loads hit L2 while this one
// transforms. B3s runs the grid in groups of
// 64 columns over the batch, so the window's tiles stay in L2 while every
// batch entry reads them. Column c's Bk segments of SEG = 136 slots lie SEG
// apart, so the two segments a half-warp of fft128_seg works on (k2 and
// k2 + 1 of one column) start 8 banks apart as dft_core.cuh requires;
// columns lie Bk SEG + 16 / min(CW, 16) slots apart, so the half-warp's
// stage-1 stores and step-3 reads (min(CW, 16) columns x 16 / min(CW, 16)
// neighbouring slots) fall on 16 distinct 8-byte banks too. Columns past C
// load zeros and store nothing.
//
// Tried on the H100 and left out (PERF.md, section 6): 4 columns a block at
// 512 threads, two blocks per SM (16-byte rows: slower at n = 2048); pairs
// of blocks in a thread-block cluster, each loading 64-byte rows for 16
// columns into the other's segments (slower at n = 2048, faster only at
// n = 4096 with four blocks); a persistent grid loading the next tile
// during the stores; 16-byte loads staged through shared memory.
#include <cuda_runtime.h>
#include <cstdint>

#include "dft_core.cuh"

namespace {

// Columns a block holds at Bk, values of a per thread, threads per block
__host__ __device__ constexpr int col_cw(int bk) {
  return bk <= 4 ? 32 : bk == 8 ? 16 : bk == 16 ? 8 : 4;
}
__host__ __device__ constexpr int col_r(int bk) {
  return bk >= 16 ? 1 : 16 / bk;
}
__host__ __device__ constexpr int col_threads(int bk) {
  return col_cw(bk) * A / col_r(bk);
}
// slots from one column's segments to the next
__host__ __device__ constexpr int col_stride(int bk) {
  return bk * SEG + 16 / (col_cw(bk) < 16 ? col_cw(bk) : 16);
}
__host__ __device__ constexpr int col_smem(int bk) {
  return (col_cw(bk) * col_stride(bk) + A) * static_cast<int>(sizeof(float2));
}
// blocks per SM: 64 registers a thread at Bk <= 16, 128 at Bk = 32
__host__ __device__ constexpr int col_blocks_per_sm(int bk) {
  return bk == 32 ? 1 : 1024 / col_threads(bk);
}

// Column tile and batch entry of block `blk`. The grid runs in groups of
// `group` column tiles: the group's tiles for every batch entry, then the
// next group (group = all tiles: each batch entry's tiles in turn).
__device__ __forceinline__ bool col_block(int blk, int ntiles, int batch,
                                          int group, int& tile, int& entry) {
  const int per = group * batch;
  const int g = blk / per;
  const int rest = blk - g * per;
  entry = rest / group;
  tile = g * group + rest % group;
  return tile < ntiles;
}

// Asks L2 for the sectors that thread (ct, a0) of block `blk` loads: rows
// a0 + AR i (i < BK R) of its column of both planes
template <int BK>
__device__ __forceinline__ void prefetch_block(const float* xre,
                                               const float* xim, int blk,
                                               int C, int batch, int group,
                                               int ct, int a0) {
  constexpr int CW = col_cw(BK);
  constexpr int AR = A / col_r(BK);
  int tile, entry;
  if (blk >= static_cast<int>(gridDim.x) ||
      !col_block(blk, (C + CW - 1) / CW, batch, group, tile, entry) ||
      tile * CW + ct >= C)
    return;
  const int64_t base = static_cast<int64_t>(entry) * A * BK * C +
                       static_cast<int64_t>(a0) * C + tile * CW + ct;
#pragma unroll
  for (int i = 0; i < BK * col_r(BK); ++i) {
    const int64_t g = base + static_cast<int64_t>(AR) * i * C;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(xre + g));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(xim + g));
  }
}

// The 128-point DFT of every segment of the block (seg g = column g / BK,
// k2 = g % BK), 8 lanes each
template <int BK, bool INV>
__device__ __forceinline__ void col_fft128(float2* s, const float2* tws) {
  constexpr int GROUPS = col_threads(BK) / 8;
  constexpr int NSEG = col_cw(BK) * BK;
  static_assert(NSEG % GROUPS == 0, "whole segments per lane group");
#pragma unroll
  for (int it = 0; it < NSEG / GROUPS; ++it) {
    const int g = threadIdx.x / 8 + GROUPS * it;
    fft128_seg<INV>(s + (g / BK) * col_stride(BK) + (g % BK) * SEG, tws,
                    threadIdx.x % 8);
  }
}

template <int BK, bool SCALED>
__global__ void __launch_bounds__(col_threads(BK), col_blocks_per_sm(BK))
col_fwd_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
               const float* __restrict__ scale,
               const float2* __restrict__ tab, float* __restrict__ ore,
               float* __restrict__ oim, int C, int batch, int group,
               int ahead) {
  constexpr int N = A * BK;
  constexpr int CW = col_cw(BK);
  constexpr int R = col_r(BK);
  constexpr int SC = col_stride(BK);
  constexpr int AR = A / R;  // a0 < AR
  extern __shared__ float2 s[];  // [CW][BK][SEG] (+ pad per column), tws
  int tile, entry;
  if (!col_block(blockIdx.x, (C + CW - 1) / CW, batch, group, tile, entry))
    return;
  float2* tws = s + CW * SC;
  const Tables tb = tables(tab, BK);
  const int cl = threadIdx.x % CW;
  const int a0 = threadIdx.x / CW;
  const int c = tile * CW + cl;
  const bool live = c < C;
  const int64_t plane = static_cast<int64_t>(entry) * N * C;
  float2* const own = s + cl * SC;  // column c's segments
  stage_tw128(tws, tb);

  // 1. column c's rows a + 128 b to registers, the Bk-point FFT, the
  // twiddle, segments
  {
    float2 v[R][BK];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int b = 0; b < BK; ++b) {
        const int64_t t = a0 + AR * r + A * b;
        v[r][b] = make_float2(0.0f, 0.0f);
        if (live) {
          v[r][b] = make_float2(xre[plane + t * C + c], xim[plane + t * C + c]);
          if (SCALED) {
            const float w = scale[t * C + c];
            v[r][b].x *= w;
            v[r][b].y *= w;
          }
        }
      }
    prefetch_block<BK>(xre, xim, blockIdx.x + ahead, C, batch, group, cl,
                       a0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      fft_regs<BK, false>(v[r]);
      const int a = a0 + AR * r;
#pragma unroll
      for (int k2 = 0; k2 < BK; ++k2) {
        float2 g = v[r][bitrev(k2, ilog2(BK))];
        if (k2) g = cmul(g, tb.tw[k2 * A + a]);
        own[k2 * SEG + a] = g;
      }
    }
  }
  __syncthreads();

  // 2. the 128-point DFT of every segment
  col_fft128<BK, false>(s, tws);
  __syncthreads();

  // 3. row p = 128 k2 + k1 of column c from segment (c, k2), slot k1
  if (!live) return;
#pragma unroll
  for (int i = 0; i < BK * R; ++i) {
    const int p = a0 + AR * i;
    const float2 z = own[(p / A) * SEG + p % A];
    const int64_t g = plane + static_cast<int64_t>(p) * C + c;
    ore[g] = z.x;
    oim[g] = z.y;
  }
}

template <int BK>
__global__ void __launch_bounds__(col_threads(BK), col_blocks_per_sm(BK))
col_inv_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
               const float2* __restrict__ tab, float* __restrict__ ore,
               float* __restrict__ oim, int C, int batch, int group,
               int ahead) {
  constexpr int N = A * BK;
  constexpr int CW = col_cw(BK);
  constexpr int R = col_r(BK);
  constexpr int SC = col_stride(BK);
  constexpr int AR = A / R;
  extern __shared__ float2 s[];
  int tile, entry;
  if (!col_block(blockIdx.x, (C + CW - 1) / CW, batch, group, tile, entry))
    return;
  float2* tws = s + CW * SC;
  const Tables tb = tables(tab, BK);  // conjugated: the inverse tables
  const int cl = threadIdx.x % CW;
  const int a0 = threadIdx.x / CW;
  const int c = tile * CW + cl;
  const bool live = c < C;
  const int64_t plane = static_cast<int64_t>(entry) * N * C;
  float2* const own = s + cl * SC;
  stage_tw128(tws, tb);

  // 1. row p = 128 k2 + k1 of column c to segment (c, k2), slot k1
  {
    float2 v[BK * R];
#pragma unroll
    for (int i = 0; i < BK * R; ++i) {
      const int64_t g = plane + static_cast<int64_t>(a0 + AR * i) * C + c;
      v[i] = live ? make_float2(xre[g], xim[g]) : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < BK * R; ++i) {
      const int p = a0 + AR * i;
      own[(p / A) * SEG + p % A] = v[i];
    }
  }
  prefetch_block<BK>(xre, xim, blockIdx.x + ahead, C, batch, group, cl, a0);
  __syncthreads();

  // 2. the inverse 128-point DFT of every segment: slot a now holds
  // sum_k1 X[k2 + Bk k1] w_128^(-a k1)
  col_fft128<BK, true>(s, tws);
  __syncthreads();

  // 3. the conjugate twiddle, the inverse Bk-point FFT over k2, rows
  // a + 128 b
  if (!live) return;
  const float inv_n = 1.0f / static_cast<float>(N);
  // one pass of r at a time at Bk = 4: unrolled, its four passes spilled
  // 8 bytes at the 64 registers that 1024 threads leave
#pragma unroll(BK == 4 ? 1 : R)
  for (int r = 0; r < R; ++r) {
    const int a = a0 + AR * r;
    float2 v[BK];
#pragma unroll
    for (int k2 = 0; k2 < BK; ++k2) {
      v[k2] = own[k2 * SEG + a];
      if (k2) v[k2] = cmul(v[k2], tb.tw[k2 * A + a]);
    }
    fft_regs<BK, true>(v);
#pragma unroll
    for (int b = 0; b < BK; ++b) {
      const float2 z = v[bitrev(b, ilog2(BK))];
      const int64_t g = plane + static_cast<int64_t>(a + A * b) * C + c;
      ore[g] = z.x * inv_n;
      oim[g] = z.y * inv_n;
    }
  }
}

// The kernel that takes (BK, inverse, scaled)
template <int BK>
const void* col_kernel(int inverse, bool scaled) {
  if (inverse) return reinterpret_cast<const void*>(col_inv_kernel<BK>);
  return scaled ? reinterpret_cast<const void*>(col_fwd_kernel<BK, true>)
                : reinterpret_cast<const void*>(col_fwd_kernel<BK, false>);
}

long long col_launches = 0;

template <int BK>
int launch_col(const float* xre, const float* xim, float* ore, float* oim,
               const float2* tab, const float* scale, int inverse, int batch,
               int C, cudaStream_t stream) {
  const void* fn = col_kernel<BK>(inverse, scale != nullptr);
  int dev = 0, sms = 0;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, col_smem(BK));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntiles = (C + col_cw(BK) - 1) / col_cw(BK);
  // B3s: groups of 64 columns (the window's tiles stay in L2); else all
  const int group =
      scale ? (64 / col_cw(BK) < ntiles ? 64 / col_cw(BK) : ntiles) : ntiles;
  const int64_t blocks =
      static_cast<int64_t>((ntiles + group - 1) / group) * group * batch;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int ahead = sms * col_blocks_per_sm(BK) / 2;  // half a wave
  const dim3 grid(static_cast<unsigned>(blocks));
  const int nt = col_threads(BK);
  const int smem = col_smem(BK);
  if (inverse)
    col_inv_kernel<BK><<<grid, nt, smem, stream>>>(xre, xim, tab, ore, oim,
                                                   C, batch, group, ahead);
  else if (scale)
    col_fwd_kernel<BK, true><<<grid, nt, smem, stream>>>(
        xre, xim, scale, tab, ore, oim, C, batch, group, ahead);
  else
    col_fwd_kernel<BK, false><<<grid, nt, smem, stream>>>(
        xre, xim, nullptr, tab, ore, oim, C, batch, group, ahead);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++col_launches;
  return static_cast<int>(err);
}

}  // namespace

// dft.cu's dft_launch for row = 0 when n / 128 is a power of two: planes
// (batch, n, C); scale (n, C) or null (forward only); tab: dft.py:_tables(n,
// inverse). Returns a CUDA error code.
int col_dft_launch(const float* xre, const float* xim, float* ore,
                   float* oim, const float2* tab, const float* scale,
                   int inverse, int batch, int n, int C, cudaStream_t stream) {
  if (batch < 1 || C < 1 || (inverse && scale))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n % A ? 0 : n / A) {
    case 2: return launch_col<2>(xre, xim, ore, oim, tab, scale, inverse,
                                 batch, C, stream);
    case 4: return launch_col<4>(xre, xim, ore, oim, tab, scale, inverse,
                                 batch, C, stream);
    case 8: return launch_col<8>(xre, xim, ore, oim, tab, scale, inverse,
                                 batch, C, stream);
    case 16: return launch_col<16>(xre, xim, ore, oim, tab, scale, inverse,
                                   batch, C, stream);
    case 32: return launch_col<32>(xre, xim, ore, oim, tab, scale, inverse,
                                   batch, C, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" {

// Launches of the register-resident column kernel since the library was
// loaded (every B3 / B3s launch at power-of-two Bk, none at other Bk)
long long colfft_regs_launches() { return col_launches; }

}  // extern "C"
