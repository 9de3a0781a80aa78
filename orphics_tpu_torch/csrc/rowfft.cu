// Row DFTs of re/im fp32 planes on the register-resident core (kernels B4
// rowfft / rowifft / rowifft_scaled_y and B5 rowifft_noise_y of the port,
// for Bk = n / 128 a power of two from 2 to 32; dft.cu's dft_launch and
// dft_noise_launch send every other Bk to its radix-2 kernel).
//
//   forward:  X[k] = sum_t x[t] w_N^(t k) along axis -1 of (batch, R, N)
//             planes, stored at column p = 128 k2 + k1 for k = k2 + Bk k1
//             (row_perm order)
//   inverse:  row_perm-ordered columns in, natural columns out, 1/N
//             included; rowifft_scaled_y multiplies the input by an (R, N)
//             plane on the load, B5 replaces the load by the draw
//             scale * eta (philox.cuh's stream), so that B5(scale, w, batch)
//             equals rowifft(noise_planes(scale, w, batch)) bit for bit: the
//             same template, whose two instances differ in the load alone
//
// Replaces orphics_tpu/ops/pallas_fft.py:_row_call (rowfft / rowifft /
// rowifft_scaled_y; kernels _rowfft_kernel, _rowifft_scaled_kernel) and
// :rowifft_noise_y (_rowifft_noise_kernel).
//
// Bound: device memory for B4, 16 B per complex element (read re/im, write
// re/im; the scaled form 4 B more per scale element) against ~60 fp32
// operations per element. B5 reads no plane and writes 8 B per element;
// Philox-4x32-10 (~30 integer operations per element) and two erfinvf per
// element make it bound by instructions. dft.cu's radix-2 core ran seven
// barrier-separated sweeps of a 64 KB block, 0.37-0.75 TB/s; this kernel
// runs dft_core.cuh's register-resident split, as rowpower.cu's B6 does:
//
// A block of 256 threads takes ROWS = 32 / Bk rows (2 at Bk = 32): Bk
// segments of 128 values a row, one per k2 (or b). Thread (m, a),
// m = tid / 128, works on rows 2 i + m.
// Forward:
//   1. each warp loads its own four segments: segment (row, b), slot a from
//      column 128 b + a, two neighbouring columns a lane (8-byte loads, all
//      issued before the first store: 256 contiguous bytes a warp and
//      plane);
//   2. after a block barrier thread (m, a) reads slot a of its row's Bk
//      segments, runs the Bk-point FFT in registers (fft_regs), multiplies
//      by the w_N^(a k2) twiddle (none at k2 = 0) and writes G[k2, a] back
//      to slot a of segment (row, k2): the slots it read, so the pass needs
//      no barrier of its own;
//   3. after a second barrier, 8 lanes per segment run the 128-point DFT as
//      16 x 8 (fft128_seg), X[k2 + Bk k1] ending at slot k1 of segment
//      (row, k2); a warp owns four whole segments, so after a __syncwarp it
//      stores them itself: columns 128 k2 + [0, 128) of the row, two
//      neighbouring slots a lane (8-byte stores).
// Inverse, the same steps the other way round:
//   1. each warp fills its own four segments (row, k2), slot k1 with column
//      p = 128 k2 + k1 of the row, as the forward's step 1 (times
//      scale[(row mod R), p] for the scaled form), or with B5's draw: one
//      philox_pair per pair q = e / 2 of the element index e of the
//      (batch, R, N) output gives elements 2q, 2q + 1 in neighbouring slots
//      as scale * normal23 (x, y the real parts, z, w the imaginary ones);
//   2. after a block barrier (which also publishes the 16 x 8 twiddles),
//      fft128_seg<true> on each segment: natural order in and out;
//   3. after a second barrier, thread (m, a) gathers its Bk values over k2,
//      multiplies by the conjugate twiddle (the inverse tables), runs
//      fft_regs<Bk, true>, scales by 1/N and stores columns a + 128 b
//      (coalesced 4-byte stores).
// A block takes 35 KB of shared memory (70 KB at Bk = 32), five blocks an
// SM (two at Bk = 32), 16 values a thread in each register pass (32 at
// Bk = 32). Rows past M load zeros (or draw nothing) and store nothing.
// Segments of SEG = 136 slots lie SEG apart, so the two segments of a
// half-warp in fft128_seg start 8 banks apart as dft_core.cuh requires, and
// every other shared-memory access of a warp covers contiguous slots. The
// global 8-byte accesses need 8-byte aligned planes (dft_launch checks).
//
// Tried on the H100 and left out (PERF.md, section 6): 16-byte stores in the
// forward (slower), streaming (evict-first) loads and stores throughout
// (B5 faster, kept there; the plain inverse slower), loading the forward's
// rows straight into registers with 4-byte loads (as B6 does; no faster).
#include <cuda_runtime.h>
#include <cstdint>

#include "dft_core.cuh"
#include "philox.cuh"

namespace {

enum RowLoad { LOAD_PLAIN = 0, LOAD_SCALED = 1, LOAD_NOISE = 2 };

// Rows a block takes at Bk, and its shared memory: the segments, then the
// 128 twiddles of the 16 x 8 split
__host__ __device__ constexpr int row_rows(int bk) {
  return bk >= 16 ? 2 : 32 / bk;
}
__host__ __device__ constexpr int row_smem(int bk) {
  return (row_rows(bk) * bk * SEG + A) * static_cast<int>(sizeof(float2));
}
// blocks an SM: 48 registers a thread at Bk <= 16 (no spill; 2-4 % faster
// at n = 2048 than four blocks at 64), 128 at Bk = 32
__host__ __device__ constexpr int row_blocks_per_sm(int bk) {
  return bk <= 16 ? 5 : 2;
}

// Fills this warp's segments g = 4 warp + j + 32 it (j < 4, it < NSEG / 32)
// of the block's rows r0 + g / BK: slots 2 sp, 2 sp + 1 (sp = lane + 32 h,
// h < 2) of segment g from columns p = 128 (g % BK) + 2 sp and p + 1 of the
// row (times scale[row mod R, p] where SCALED), one float4 of two complex
// values a lane; rows past M give zeros. All loads are issued before the
// first store.
template <int BK, bool SCALED>
__device__ __forceinline__ void load_segments(
    float2* s, const float* __restrict__ xre, const float* __restrict__ xim,
    const float* __restrict__ scale, int64_t r0, int M, int R) {
  constexpr int N = A * BK;
  constexpr int ITS = row_rows(BK) * BK / 32;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float4 z[4 * ITS][2];
#pragma unroll
  for (int i = 0; i < 4 * ITS; ++i) {
    const int g = 4 * warp + i % 4 + 32 * (i / 4);
    const int64_t row = r0 + g / BK;
    const int p0 = A * (g % BK);
    const float2* re = reinterpret_cast<const float2*>(xre + row * N + p0);
    const float2* im = reinterpret_cast<const float2*>(xim + row * N + p0);
    const float2* sc =
        SCALED ? reinterpret_cast<const float2*>(
                     scale + static_cast<int64_t>(static_cast<int>(row) % R) * N
                     + p0)
               : nullptr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sp = lane + 32 * h;
      z[i][h] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < M) {
        const float2 vr = re[sp];
        const float2 vi = im[sp];
        z[i][h] = make_float4(vr.x, vi.x, vr.y, vi.y);
        if constexpr (SCALED) {
          const float2 w = sc[sp];
          z[i][h] = make_float4(vr.x * w.x, vi.x * w.x, vr.y * w.y,
                                vi.y * w.y);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4 * ITS; ++i) {
    float4* seg = reinterpret_cast<float4*>(
        s + (4 * warp + i % 4 + 32 * (i / 4)) * SEG) + lane;
    seg[0] = z[i][0];
    seg[32] = z[i][1];
  }
}

template <int BK>
__global__ void __launch_bounds__(THREADS, row_blocks_per_sm(BK))
row_fwd_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
               const float2* __restrict__ tab, float* __restrict__ ore,
               float* __restrict__ oim, int M) {
  constexpr int N = A * BK;
  constexpr int ROWS = row_rows(BK);
  constexpr int PER = ROWS / 2;  // rows of each thread
  constexpr int NSEG = ROWS * BK;
  static_assert(THREADS == 2 * A && NSEG % 32 == 0,
                "a thread per (row of a pair, a); 8 lanes per segment");
  extern __shared__ float2 s[];  // [NSEG][SEG], then tws[128]
  float2* tws = s + NSEG * SEG;
  const Tables tb = tables(tab, BK);
  const int tid = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * ROWS;

  // 1. the rows into their segments: segment (row, b) holds columns
  // 128 b + a at slot a
  load_segments<BK, false>(s, xre, xim, nullptr, r0, M, 1);
  stage_tw128(tws, tb);
  __syncthreads();

  // 2. thread (m, a) on rows 2 i + m: slot a of the row's Bk segments, the
  // Bk-point FFT, the twiddle, G[k2, a] back to slot a of segment (row, k2):
  // the slots it read, so no other thread's are touched
  {
    const int a = tid % A;
    const int m = tid / A;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      float2* own = s + (2 * i + m) * BK * SEG + a;
      float2 v[BK];
#pragma unroll
      for (int b = 0; b < BK; ++b) v[b] = own[b * SEG];
      fft_regs<BK, false>(v);
#pragma unroll
      for (int k2 = 0; k2 < BK; ++k2) {
        float2 g = v[bitrev(k2, ilog2(BK))];
        if (k2) g = cmul(g, tb.tw[k2 * A + a]);
        own[k2 * SEG] = g;
      }
    }
  }
  __syncthreads();

  // 3. the 128-point DFT of each segment, 8 lanes each; then the warp
  // stores its own four segments (g = 4 warp + j + 32 it): columns
  // 128 k2 + 2 sp, 128 k2 + 2 sp + 1 of row g / BK from lane sp % 32
  const int lane = tid % 32;
  const int warp = tid / 32;
#pragma unroll
  for (int it = 0; it < NSEG / 32; ++it) {
    fft128_seg<false>(s + (tid / 8 + 32 * it) * SEG, tws, tid % 8);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = 4 * warp + j + 32 * it;
      const int64_t row = r0 + g / BK;
      if (row >= M) continue;
      const float2* seg = s + g * SEG;
      const int64_t o = row * N + A * (g % BK);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sp = lane + 32 * h;
        const float4 z = *reinterpret_cast<const float4*>(seg + 2 * sp);
        *reinterpret_cast<float2*>(ore + o + 2 * sp) = make_float2(z.x, z.z);
        *reinterpret_cast<float2*>(oim + o + 2 * sp) = make_float2(z.y, z.w);
      }
    }
  }
}

template <int BK, int LOAD>
__global__ void __launch_bounds__(THREADS, row_blocks_per_sm(BK))
row_inv_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
               const float* __restrict__ scale, const int* __restrict__ seed,
               const float2* __restrict__ tab, float* __restrict__ ore,
               float* __restrict__ oim, int M, int R) {
  constexpr int N = A * BK;
  constexpr int ROWS = row_rows(BK);
  constexpr int PER = ROWS / 2;
  constexpr int NSEG = ROWS * BK;
  constexpr int ITS = NSEG / 32;
  static_assert(THREADS == 2 * A && NSEG % 32 == 0,
                "a thread per (row of a pair, a); 8 lanes per segment");
  extern __shared__ float2 s[];
  float2* tws = s + NSEG * SEG;
  const Tables tb = tables(tab, BK);  // conjugated: the inverse tables
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * ROWS;

  // 1. this warp's segments as load_segments fills them, from the rows or,
  // for B5, from the draw: the pair of columns p, p + 1 from philox_pair of
  // its element index over 2; the row's offsets once per segment
  if constexpr (LOAD == LOAD_NOISE) {
    const PhiloxKeys keys = philox_round_keys(seed_key(seed));
#pragma unroll 1
    for (int i = 0; i < 4 * ITS; ++i) {
      const int g = 4 * warp + i % 4 + 32 * (i / 4);
      const int64_t row = r0 + g / BK;
      float4* seg = reinterpret_cast<float4*>(s + g * SEG) + lane;
      if (row >= M) {
        seg[0] = seg[32] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        continue;
      }
      const int p0 = A * (g % BK);
      // the pair of columns p0 + 2 lane, p0 + 2 lane + 1
      const int64_t q0 = (row * N + p0) / 2 + lane;
      const float2* sc = reinterpret_cast<const float2*>(
          scale + static_cast<int64_t>(static_cast<int>(row) % R) * N + p0)
          + lane;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 bits = philox_pair(q0 + 32 * h, keys);
        const float2 w = sc[32 * h];
        seg[32 * h] =
            make_float4(w.x * normal23(bits.x), w.x * normal23(bits.z),
                        w.y * normal23(bits.y), w.y * normal23(bits.w));
      }
    }
  } else {
    load_segments<BK, LOAD == LOAD_SCALED>(s, xre, xim, scale, r0, M, R);
  }
  stage_tw128(tws, tb);
  __syncthreads();

  // 2. the inverse 128-point DFT of every segment: slot a now holds
  // sum_k1 X[k2 + Bk k1] w_128^(-a k1)
#pragma unroll
  for (int it = 0; it < ITS; ++it)
    fft128_seg<true>(s + (tid / 8 + 32 * it) * SEG, tws, tid % 8);
  __syncthreads();

  // 3. the conjugate twiddle, the inverse Bk-point FFT over k2, columns
  // a + 128 b of rows 2 i + m
  const int a = tid % A;
  const int m = tid / A;
  const float inv_n = 1.0f / static_cast<float>(N);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int64_t row = r0 + 2 * i + m;
    if (row >= M) continue;
    const float2* own = s + (2 * i + m) * BK * SEG + a;
    float2 v[BK];
#pragma unroll
    for (int k2 = 0; k2 < BK; ++k2) {
      v[k2] = own[k2 * SEG];
      if (k2) v[k2] = cmul(v[k2], tb.tw[k2 * A + a]);
    }
    fft_regs<BK, true>(v);
    const int64_t o = row * N + a;
#pragma unroll
    for (int b = 0; b < BK; ++b) {
      const float2 z = v[bitrev(b, ilog2(BK))];
      if constexpr (LOAD == LOAD_NOISE) {
        // evict-first stores: B5 ran 7 % faster with them at (96, 2048,
        // 2048), the plain inverse 2 % slower (PERF.md, section 6)
        __stcs(ore + o + A * b, z.x * inv_n);
        __stcs(oim + o + A * b, z.y * inv_n);
      } else {
        ore[o + A * b] = z.x * inv_n;
        oim[o + A * b] = z.y * inv_n;
      }
    }
  }
}

long long row_launches = 0;

template <typename Kernel>
cudaError_t prepare(Kernel fn, int bk) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, row_smem(bk));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// What a row launch takes: planes (M, N) = (batch R, N); xre / xim null for
// B5, scale (R, N) or null, seed (2,) words or null
struct RowArgs {
  const float* xre;
  const float* xim;
  const float* scale;
  const int* seed;
  const float2* tab;
  float* ore;
  float* oim;
  int M;
  int R;
  int inverse;
  cudaStream_t stream;
};

template <int BK>
int launch_row(const RowArgs& a) {
  const int64_t blocks = (static_cast<int64_t>(a.M) + row_rows(BK) - 1)
                         / row_rows(BK);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const int smem = row_smem(BK);
  cudaError_t err;
  if (!a.inverse) {
    err = prepare(row_fwd_kernel<BK>, BK);
    if (err == cudaSuccess)
      row_fwd_kernel<BK><<<grid, THREADS, smem, a.stream>>>(
          a.xre, a.xim, a.tab, a.ore, a.oim, a.M);
  } else if (a.seed) {
    err = prepare(row_inv_kernel<BK, LOAD_NOISE>, BK);
    if (err == cudaSuccess)
      row_inv_kernel<BK, LOAD_NOISE><<<grid, THREADS, smem, a.stream>>>(
          nullptr, nullptr, a.scale, a.seed, a.tab, a.ore, a.oim, a.M, a.R);
  } else if (a.scale) {
    err = prepare(row_inv_kernel<BK, LOAD_SCALED>, BK);
    if (err == cudaSuccess)
      row_inv_kernel<BK, LOAD_SCALED><<<grid, THREADS, smem, a.stream>>>(
          a.xre, a.xim, a.scale, nullptr, a.tab, a.ore, a.oim, a.M, a.R);
  } else {
    err = prepare(row_inv_kernel<BK, LOAD_PLAIN>, BK);
    if (err == cudaSuccess)
      row_inv_kernel<BK, LOAD_PLAIN><<<grid, THREADS, smem, a.stream>>>(
          a.xre, a.xim, nullptr, nullptr, a.tab, a.ore, a.oim, a.M, a.R);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) ++row_launches;
  return static_cast<int>(err);
}

}  // namespace

// dft.cu's dft_launch (row = 1) and dft_noise_launch when n / 128 is a power
// of two: planes (M, n) = (batch R, n), 8-byte aligned; scale (R, n) or
// null; seed (2,) i32 words in device memory for B5 (inverse, xre = xim =
// null), else null; tab: dft.py:_tables(n, inverse). Returns a CUDA error
// code.
int row_dft_launch(const float* xre, const float* xim, float* ore,
                   float* oim, const float2* tab, const float* scale,
                   const int* seed, int inverse, int M, int R, int n,
                   cudaStream_t stream) {
  if (M < 1 || R < 1 || (!inverse && (scale || seed)))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowArgs a{xre, xim, scale, seed, tab, ore, oim, M, R, inverse,
                  stream};
  switch (n % A ? 0 : n / A) {
    case 2: return launch_row<2>(a);
    case 4: return launch_row<4>(a);
    case 8: return launch_row<8>(a);
    case 16: return launch_row<16>(a);
    case 32: return launch_row<32>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" {

// Launches of the register-resident row kernels since the library was
// loaded (every B4 / B5 launch at power-of-two Bk on aligned planes, none
// at other Bk)
long long rowfft_regs_launches() { return row_launches; }

}  // extern "C"
