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
// per element for its two fields, against 16 B read). Ids outside
// [0, nseg) are dropped, and their data need not be read at all: FastCl
// passes -1 for the two edge segments it throws away, and at bench config
// 1 those are 89 % of the half plane, so its bound counts only the
// 128-byte lines that hold a kept id.
//
// Design: per-warp fp64 partials in shared memory. A block owns R batch
// rows, a span of elements and a tile of at most SEG_CAP segments
// (blockIdx.z; the wrapper tiles larger nseg, and every tile reads the data
// once). Each warp walks its part of the span 32 elements a step, UNROLL
// steps a batch, with the next batch's ids loaded ahead. The ids and the
// grouping of a step are shared by the R rows:
//   * A step whose ids are all dropped (a warp-uniform ballot) loads no
//     data and does no work; in a live step each lane loads its R rows'
//     data only where its id is kept.
//   * The lanes that hold the same segment find each other once per step
//     with __match_any_sync. A group of more than SMALL lanes (the overflow
//     segment of a radial binning, where the caller keeps it) adds its
//     values to per-lane fp64 running sums of one segment at a time, which
//     one xor butterfly per row and field empties into the warp's slots
//     when another segment's large group comes (and at the end). A smaller
//     group (distinct ids: most live steps of FastCl's permuted rows) is
//     summed by its lowest lane in lane order, which reads its peers by
//     shuffles, or adds its own value where it is alone, and adds the sum
//     to the warp's slots.
// A warp's steps run in order and each slot has one writer per step, so
// there are no atomics, and every sum runs in an order fixed by the ids
// alone. The block then sums its warps' slots in warp order into one fp64
// partial per (span, row, segment), and a second kernel sums the spans in
// order: bit-reproducible from run to run. The slots take ND * R * WARPS *
// tile doubles of dynamic shared memory. B2 shares each id load between
// its two inputs; B2' is B2 with four planes loaded and its two fields
// formed in registers before the same sums. Loads are 4-byte: one 128-byte
// line per warp and row; a lane's 16 consecutive bytes would put four ids
// in each lane and leave 63 % of FastCl's steps dead instead of 82 %.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int R = 4;         // batch rows per block
constexpr int SEG_CAP = 256;
// Elements a block walks: SPAN, halved down to MIN_SPAN while the grid
// holds fewer than GRID_FILL blocks (span_for: it depends on the shapes
// alone, so the order of the sums does too)
constexpr int SPAN = THREADS * 128;
constexpr int MIN_SPAN = THREADS * 8;
constexpr int GRID_FILL = 512;
constexpr int SMALL = 4;     // groups up to this size: summed by their lowest lane
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
struct Shape {
  static constexpr int ND = MODE == ONE ? 1 : 2;     // summed fields
  static constexpr int NP = MODE == PAIR ? 4 : ND;   // planes loaded
  static constexpr int UNROLL = MODE == PAIR ? 2 : 4;
};

template <Mode MODE>
__global__ void __launch_bounds__(THREADS, 2)
seg_sum_kernel(const float* __restrict__ d0, const float* __restrict__ d1,
               const float* __restrict__ d2, const float* __restrict__ d3,
               const int* __restrict__ ids, const float* __restrict__ w,
               double* __restrict__ scratch, int B, int N, int nseg,
               int tile, int span, bool sym) {
  constexpr int ND = Shape<MODE>::ND;
  constexpr int NP = Shape<MODE>::NP;
  constexpr int UNROLL = Shape<MODE>::UNROLL;
  constexpr int STEP = 32 * UNROLL;    // elements of a warp's batch
  extern __shared__ double slots[];    // (ND, R, WARPS, tile)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * R;
  const int nr = min(R, B - b0);
  const int s0 = blockIdx.z * tile;
  const int ns = min(tile, nseg - s0);
  for (int i = threadIdx.x; i < ND * R * WARPS * tile; i += THREADS)
    slots[i] = 0.0;
  __syncthreads();

  const float* planes[4] = {d0, d1, d2, d3};
  const int begin = blockIdx.x * span;
  const int end = min(N, begin + span);
  const int first = begin + warp * STEP;
  constexpr int STRIDE = THREADS * UNROLL;   // a warp's next batch
  // the ids of the warp's next batch, loaded ahead
  int next[UNROLL];
  auto load_ids = [&](int at) {
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int n = at + k * 32 + lane;
      next[k] = n < end ? __ldg(ids + n) : -1;
    }
  };
  load_ids(first);
  // this warp's slots of segment s, row r and field d are
  // slots[((d R + r) WARPS + warp) tile + s]
  auto add_slots = [&](int s, const double (&t)[R][ND]) {
    double* p = slots + warp * tile + s;
    double old[R][ND];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int d = 0; d < ND; ++d) old[r][d] = p[(d * R + r) * WARPS * tile];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int d = 0; d < ND; ++d)
        p[(d * R + r) * WARPS * tile] = old[r][d] + t[r][d];
  };
  // the large groups' running sums, per lane, of segment cur (warp-uniform)
  double acc[R][ND];
  int cur = -1;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < ND; ++d) acc[r][d] = 0.0;
  // the lanes' running sums into the slots of cur: one butterfly each
  auto flush = [&]() {
    if (cur < 0) return;
    double t[R][ND];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        t[r][d] = warp_sum(acc[r][d]);
        acc[r][d] = 0.0;
      }
    if (lane == 0) add_slots(cur, t);
    __syncwarp();
  };
  // warp-uniform loop: every lane reaches each collective
  for (int base = first; base < end; base += STRIDE) {
    int seg[UNROLL];
    unsigned live = 0;   // bit k: step k holds a kept id
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int id = next[k] - s0;
      seg[k] = (id >= 0 && id < ns) ? id : -1;
      if (__ballot_sync(FULL, seg[k] >= 0)) live |= 1u << k;
    }
    if (!live) {
      load_ids(base + STRIDE);
      continue;
    }
    // the R rows' data where the lane's id is kept
    float x[UNROLL][R][NP];
    float wt[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int n = base + k * 32 + lane;
      const bool on = seg[k] >= 0;
      wt[k] = (w && on) ? __ldg(w + n) : 1.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t at = static_cast<int64_t>(b0 + r) * N + n;
#pragma unroll
        for (int q = 0; q < NP; ++q)
          x[k][r][q] = (on && r < nr) ? __ldg(planes[q] + at) : 0.0f;
      }
    }
    load_ids(base + STRIDE);
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (!(live >> k & 1u)) continue;
      const int s = seg[k];
      const bool on = s >= 0;
      double v[R][ND];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (MODE == PAIR) {
          const float zr = x[k][r][0], zi = x[k][r][1];
          const float mr = x[k][r][2], mi = x[k][r][3];
          const float q = sym ? 0.5f * (zr * zr + zi * zi + mr * mr + mi * mi)
                              : zr * zr + zi * zi;
          v[r][0] = static_cast<double>(q);
          v[r][ND - 1] = static_cast<double>(zr * mr - zi * mi);
        } else {
          v[r][0] = static_cast<double>(x[k][r][0])
                    * static_cast<double>(wt[k]);
          if (MODE == TWO) v[r][ND - 1] = static_cast<double>(x[k][r][1]);
        }
      }
      const unsigned peers = __match_any_sync(FULL, s);
      const int size = __popc(peers);
      const bool big = size > SMALL;
      // large groups, in the order of their lowest lane, into the lanes'
      // accumulators of segment cur (flushed when another one comes)
      for (unsigned todo = __ballot_sync(FULL, on && big); todo;) {
        const int sl = __shfl_sync(FULL, s, __ffs(todo) - 1);
        const bool mine = s == sl;
        if (sl != cur) {
          flush();
          cur = sl;
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int d = 0; d < ND; ++d)
            if (mine) acc[r][d] += v[r][d];
        todo &= ~__ballot_sync(FULL, mine);
      }
      // small groups: the lowest lane sums its group in lane order, its
      // peers' values by shuffles
      const bool small = on && !big;
      const int jmax = __reduce_max_sync(FULL, small ? size : 0);
      if (jmax == 0) continue;
      int src[SMALL - 1];
      unsigned rest = peers & (peers - 1);   // the peers after the leader
#pragma unroll
      for (int j = 0; j < SMALL - 1; ++j) {
        src[j] = rest ? __ffs(rest) - 1 : lane;
        rest &= rest - 1;
      }
      double t[R][ND];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int d = 0; d < ND; ++d) t[r][d] = v[r][d];
#pragma unroll
      for (int j = 0; j < SMALL - 1; ++j) {
        if (j + 1 >= jmax) break;   // warp-uniform
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int d = 0; d < ND; ++d) {
            const double u = __shfl_sync(FULL, v[r][d], src[j]);
            if (j + 1 < size) t[r][d] += u;
          }
      }
      if (small && lane == __ffs(peers) - 1) add_slots(s, t);
      __syncwarp();   // the slots' next writer may be another lane
    }
  }
  flush();
  __syncthreads();

  // scratch (ND, nspan, B, nseg)
  for (int i = threadIdx.x; i < ND * nr * ns; i += THREADS) {
    const int d = i / (nr * ns);
    const int r = i / ns % nr;
    const int s = i % ns;
    const double* p = slots + ((d * R + r) * WARPS) * tile + s;
    double t = 0.0;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) t += p[wp * tile];
    scratch[((static_cast<int64_t>(d) * gridDim.x + blockIdx.x) * B + b0 + r)
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

int span_for(int B, int N, int ntiles) {
  const int64_t groups = static_cast<int64_t>((B + R - 1) / R) * ntiles;
  int span = SPAN;
  while (span > MIN_SPAN && (N + span - 1) / span * groups < GRID_FILL)
    span /= 2;
  return span;
}

template <Mode MODE>
int launch(const float* d0, const float* d1, const float* d2, const float* d3,
           const int* ids, const float* w, double* scratch, float* out, int B,
           int N, int nseg, int tile, int ntiles, bool sym, void* stream) {
  constexpr int ND = Shape<MODE>::ND;
  constexpr size_t SLOT_BYTES = sizeof(double) * ND * R * WARPS;
  if (B < 1 || N < 1 || nseg < 1 || tile < 1 || tile > SEG_CAP
      || (B + R - 1) / R > 65535 || ntiles < 1 || ntiles > 65535
      || static_cast<int64_t>(tile) * ntiles < nseg)
    return static_cast<int>(cudaErrorInvalidValue);
  // room for the largest tile's slots (on the current device)
  cudaError_t e = cudaFuncSetAttribute(
      seg_sum_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SLOT_BYTES * SEG_CAP));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int span = span_for(B, N, ntiles);
  const int nspan = (N + span - 1) / span;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  seg_sum_kernel<MODE><<<dim3(nspan, (B + R - 1) / R, ntiles), THREADS,
                         SLOT_BYTES * tile, s>>>(
      d0, d1, d2, d3, ids, w, scratch, B, N, nseg, tile, span, sym);
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

// The number of spans of a launch of (B, N) over ntiles segment tiles: the
// scratch's second extent.
int bin_reduce_nspan(int B, int N, int ntiles) {
  const int span = span_for(B, N, ntiles);
  return (N + span - 1) / span;
}

int bin_reduce_seg_cap() { return SEG_CAP; }

// B1. data (B, N) f32, ids (N,) i32, w (N,) f32 or null, scratch
// (nspan, B, nseg) f64 with nspan = bin_reduce_nspan(B, N, ntiles), out (B, nseg) f32;
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
