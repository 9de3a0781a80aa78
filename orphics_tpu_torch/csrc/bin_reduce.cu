// Segment sums for radial binning (kernels B1, B2 and B2' of the port).
//
//   B1: out[b, s] = sum_n data[b, n] * w[n] * [ids[n] == s]
//   B2: o1[b, s] = sum_n d1[b, n] [ids[n] == s],  o2 likewise from d2
//   B2': B2 of the two fields of a packed Fourier pair Z and its mirror Zm,
//        formed in fp32 as the planes are loaded and never stored:
//          q = |Z|^2, or (|Z|^2 + |Zm|^2) / 2 with sym;  c = Re(Z Zm)
//   for s in [0, nseg), any nseg
//
// Replaces orphics_tpu/ops/pallas_kernels.py:bin_matmul (_bin_reduce_kernel),
// :bin2_matmul (_bin2_kernel) and :bin_pair_power (_pair_power_kernel),
// one-hot bf16 hi/lo MXU contractions on the TPU.
//
// Bound: reading the data once, 4 B per element and input plane (ids and
// weights are shared by every batch row and stay in L2); the arithmetic is
// one fp64 add per element and summed field (B2' adds ~10 fp32 operations
// per element for its two fields, against 16 B read).
//
// Design: per-warp fp64 partials in shared memory. A block owns one batch
// row, a span of SPAN elements and a tile of at most SEG_CAP segments
// (blockIdx.z; the wrapper tiles larger nseg, and every tile reads the data
// once). Each warp walks its part of the span 32 elements at a time, UNROLL
// steps of loads in flight. In a step, the lanes that hold the same segment
// find each other with __match_any_sync. A group of more than SMALL lanes
// (most steps of a radial binning: beyond the last edge every pixel is in
// the overflow segment) is summed by one xor butterfly over the warp with
// the other lanes' values set to 0; a smaller group is summed by its lowest
// lane in lane order. Either way the group's lowest lane adds the sum to the
// warp's slot for that segment. A warp's steps run in order and each slot
// has one writer per step, so there are no atomics, and every sum runs in
// an order fixed by the ids alone. The block then sums its warps' slots in
// warp order into one fp64 partial per (span, row, segment), and a second
// kernel sums the spans in order: bit-reproducible from run to run. The
// shared memory per block does not grow with nseg. B2 shares each id load
// between its two inputs; B2' is B2 with four planes loaded and its two
// fields formed in registers before the same sums.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SEG_CAP = 256;
constexpr int UNROLL = 8;
constexpr int SPAN = THREADS * UNROLL * 16;
constexpr int SMALL = 4;  // groups up to this size: the leader's loop
constexpr unsigned FULL = 0xffffffffu;

// The same butterfly on every lane: lane i's result is a fixed tree over
// the 32 inputs.
__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// What a block sums: one weighted input (B1), two inputs (B2), or the two
// fields of four planes (B2').
enum Mode { ONE = 0, TWO = 1, PAIR = 2 };

template <Mode MODE>
__global__ void __launch_bounds__(THREADS)
seg_sum_kernel(const float* __restrict__ d0, const float* __restrict__ d1,
               const float* __restrict__ d2, const float* __restrict__ d3,
               const int* __restrict__ ids, const float* __restrict__ w,
               double* __restrict__ scratch, int B, int N, int nseg,
               int tile, bool sym) {
  constexpr int ND = MODE == ONE ? 1 : 2;
  __shared__ double slots[ND][WARPS][SEG_CAP];
  __shared__ double stage[ND][WARPS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int s0 = blockIdx.z * tile;
  const int ns = min(tile, nseg - s0);
  double* flat = &slots[0][0][0];
  for (int i = threadIdx.x; i < ND * WARPS * SEG_CAP; i += THREADS)
    flat[i] = 0.0;
  __syncthreads();

  const int64_t row = static_cast<int64_t>(b) * N;
  const int begin = blockIdx.x * SPAN;
  const int end = min(N, begin + SPAN);
  // warp-uniform loop: every lane reaches each __match_any_sync
  for (int base = begin + warp * 32 * UNROLL; base < end;
       base += THREADS * UNROLL) {
    int seg[UNROLL];
    double v[ND][UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int n = base + k * 32 + lane;
      const bool in = n < end;
      const int id = in ? ids[n] - s0 : -1;
      seg[k] = (id >= 0 && id < ns) ? id : -1;
      if (MODE == PAIR) {
        float q = 0.0f, c = 0.0f;
        if (in) {
          const float zr = d0[row + n], zi = d1[row + n];
          const float mr = d2[row + n], mi = d3[row + n];
          q = sym ? 0.5f * (zr * zr + zi * zi + mr * mr + mi * mi)
                  : zr * zr + zi * zi;
          c = zr * mr - zi * mi;
        }
        v[0][k] = static_cast<double>(q);
        v[ND - 1][k] = static_cast<double>(c);
      } else {
        v[0][k] = in ? static_cast<double>(d0[row + n])
                           * (w ? static_cast<double>(w[n]) : 1.0)
                     : 0.0;
        if (MODE == TWO)
          v[ND - 1][k] = in ? static_cast<double>(d1[row + n]) : 0.0;
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const unsigned peers = __match_any_sync(FULL, seg[k]);
      const bool small = __popc(peers) <= SMALL;
      // large groups, one butterfly each, in the order of their lowest lane
      for (unsigned todo = __ballot_sync(FULL, !small && seg[k] >= 0); todo;) {
        const int leader = __ffs(todo) - 1;
        const int s = __shfl_sync(FULL, seg[k], leader);
        const bool mine = seg[k] == s;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          const double t = warp_sum(mine ? v[d][k] : 0.0);
          if (lane == leader) slots[d][warp][s] += t;
        }
        todo &= ~__ballot_sync(FULL, mine);
      }
      // small groups: the lowest lane sums its group in lane order
      if (__any_sync(FULL, small && seg[k] >= 0)) {
#pragma unroll
        for (int d = 0; d < ND; ++d) stage[d][warp][lane] = v[d][k];
        __syncwarp();
        if (small && seg[k] >= 0 && lane == __ffs(peers) - 1) {
#pragma unroll
          for (int d = 0; d < ND; ++d) {
            double t = 0.0;
            for (unsigned m = peers; m; m &= m - 1)
              t += stage[d][warp][__ffs(m) - 1];
            slots[d][warp][seg[k]] += t;
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // scratch (ND, nspan, B, nseg)
  for (int i = threadIdx.x; i < ND * ns; i += THREADS) {
    const int d = i / ns;
    const int s = i % ns;
    double t = 0.0;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) t += slots[d][wp][s];
    scratch[((static_cast<int64_t>(d) * gridDim.x + blockIdx.x) * B + b)
            * nseg + s0 + s] = t;
  }
}

// out (ND, B, nseg) f32: the spans' partials summed in span order
__global__ void seg_finish_kernel(const double* __restrict__ scratch,
                                  float* __restrict__ out, int nspan,
                                  int total, int per_d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;   // (d, b, s)
  if (i >= total) return;
  const int d = i / per_d;
  const int j = i % per_d;
  const double* p = scratch + static_cast<int64_t>(d) * nspan * per_d + j;
  double t = 0.0;
  for (int c = 0; c < nspan; ++c) t += p[static_cast<int64_t>(c) * per_d];
  out[i] = static_cast<float>(t);
}

template <Mode MODE>
int launch(const float* d0, const float* d1, const float* d2, const float* d3,
           const int* ids, const float* w, double* scratch, float* out, int B,
           int N, int nseg, int tile, int ntiles, bool sym, void* stream) {
  constexpr int ND = MODE == ONE ? 1 : 2;
  if (B < 1 || B > 65535 || N < 1 || nseg < 1 || tile < 1 || tile > SEG_CAP
      || ntiles < 1 || ntiles > 65535
      || static_cast<int64_t>(tile) * ntiles < nseg)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nspan = (N + SPAN - 1) / SPAN;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  seg_sum_kernel<MODE><<<dim3(nspan, B, ntiles), THREADS, 0, s>>>(
      d0, d1, d2, d3, ids, w, scratch, B, N, nseg, tile, sym);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_d = B * nseg;
  const int total = ND * per_d;
  seg_finish_kernel<<<(total + 255) / 256, 256, 0, s>>>(scratch, out, nspan,
                                                        total, per_d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int bin_reduce_span() { return SPAN; }

int bin_reduce_seg_cap() { return SEG_CAP; }

// B1. data (B, N) f32, ids (N,) i32, w (N,) f32 or null, scratch
// (nspan, B, nseg) f64 with nspan = ceil(N / SPAN), out (B, nseg) f32;
// segments in ntiles tiles of tile <= SEG_CAP (ids outside [0, nseg) are
// dropped).
int bin_reduce_launch(const float* data, const int* ids, const float* w,
                      double* scratch, float* out, int B, int N, int nseg,
                      int tile, int ntiles, void* stream) {
  return launch<ONE>(data, nullptr, nullptr, nullptr, ids, w, scratch, out, B,
                     N, nseg, tile, ntiles, false, stream);
}

// B2. d1, d2 (B, N) f32, ids (N,) i32, scratch (2, nspan, B, nseg) f64,
// out (2, B, nseg) f32.
int bin2_reduce_launch(const float* d1, const float* d2, const int* ids,
                       double* scratch, float* out, int B, int N, int nseg,
                       int tile, int ntiles, void* stream) {
  return launch<TWO>(d1, d2, nullptr, nullptr, ids, nullptr, scratch, out, B,
                     N, nseg, tile, ntiles, false, stream);
}

// B2'. zr, zi, zmr, zmi (B, N) f32 (Z and its mirror), ids (N,) i32,
// scratch (2, nspan, B, nseg) f64, out (2, B, nseg) f32: bin(q), bin(c);
// sym != 0 takes q = (|Z|^2 + |Zm|^2) / 2.
int bin_pair_power_launch(const float* zr, const float* zi, const float* zmr,
                          const float* zmi, const int* ids, double* scratch,
                          float* out, int B, int N, int nseg, int tile,
                          int ntiles, int sym, void* stream) {
  return launch<PAIR>(zr, zi, zmr, zmi, ids, nullptr, scratch, out, B, N,
                      nseg, tile, ntiles, sym != 0, stream);
}

}  // extern "C"
