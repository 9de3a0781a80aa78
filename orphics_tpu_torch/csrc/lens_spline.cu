// Periodic B-spline evaluation at displaced positions (kernel B8 of the
// port): the lensing displacement of a map held as spline coefficients.
//
//   out[b, c, y, x] = sum_{k, m} wy_k(ty) wx_m(tx)
//                     coef[b, c, (y + fy + oy_k) mod ny, (x + fx + ox_m) mod nx]
//
// with py = clip(alpha[b, 0, y, x] / dy, -D, D), fy = floor(py), ty = py - fy
// (likewise along x), taps oy, ox = (-1..2) for cubic and (-2..3) for
// quintic B-splines.
//
// Replaces orphics_tpu/ops/pallas_lens.py:lens_map_pallas (_lens_kernel),
// which on the TPU DMAs a halo window of each output block and sums
// NS^2 = (2D + order + 1)^2 static shifts of it to avoid gathers.
//
// Bound: device memory traffic of the two alpha planes, the C coefficient
// maps and the C output maps (4 B each per pixel). The first port (one
// thread per pixel, every tap gathered from L1 with its own periodic wrap,
// two runtime `%` and a branchy piecewise weight per tap row and column)
// was bound by those integer and weight instructions instead: 16.6x its
// bound at order 5, 3.2x the order-3 time for 2.25x the taps.
//
// Design: a tile of TY x TX outputs per block, PY a thread down a column,
// for one batch entry and all C components.
//   * Each thread reads its pixels' deflections once, scales them by
//     1 / dy and 1 / dx (a multiply: the IEEE division cost 14 % of the
//     kernel; the quotient differs from the plain version's by an ulp at
//     most, and the spline is continuous where that moves a floor), clips
//     them, and forms the floor and the fraction. At the taps, the
//     2 (order + 1) weights are the polynomial pieces of the B-spline in
//     the fraction t in [0, 1), by Horner (spline_weights below;
//     ops/lens.py:spline_weights is the same table): no fabsf, no branch,
//     no `%`.
//   * The block's min and max of fy and fx (warp reductions, then one
//     shared-memory pass) give its window: the tile plus that range plus
//     order taps. Periodic wrap is resolved once per window row and column
//     into two small tables of wrapped indices; each component's window is
//     loaded into shared memory row by row (coalesced along x).
//   * Taps come from shared memory with 32-bit indices, rows outer and
//     columns inner per component, as the plain version sums them.
//   * A block whose range exceeds the window's capacity (RMAX = 16 pixels
//     per axis, which a clip of D <= 8 never exceeds) takes its taps from
//     device memory with the same weights and the same order of sums, and
//     counts itself in a device counter: FlatLensingSims' unclipped D, or a
//     pathological deflection. The result is the same either way.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int TX = 32;         // tile columns = threads along x
constexpr int TYT = 16;        // threads along y
constexpr int PY = 4;          // pixels per thread: rows ty + TYT * p
constexpr int TY = TYT * PY;   // tile rows
constexpr int RMAX = 16;       // largest fy / fx range a window holds
constexpr int THREADS = TX * TYT;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// The B-spline's polynomial pieces in t in [0, 1): weight k is
// sum_i W[k][i] t^i (ops/lens.py:_SPLINE_POLY).
__constant__ float W3[4][4] = {
    {1.0f / 6.0f, -0.5f, 0.5f, -1.0f / 6.0f},
    {4.0f / 6.0f, 0.0f, -1.0f, 0.5f},
    {1.0f / 6.0f, 0.5f, 0.5f, -0.5f},
    {0.0f, 0.0f, 0.0f, 1.0f / 6.0f}};
__constant__ float W5[6][6] = {
    {1.0f / 120, -5.0f / 120, 10.0f / 120, -10.0f / 120, 5.0f / 120,
     -1.0f / 120},
    {26.0f / 120, -50.0f / 120, 20.0f / 120, 20.0f / 120, -20.0f / 120,
     5.0f / 120},
    {66.0f / 120, 0.0f, -60.0f / 120, 0.0f, 30.0f / 120, -10.0f / 120},
    {26.0f / 120, 50.0f / 120, 20.0f / 120, -20.0f / 120, -20.0f / 120,
     10.0f / 120},
    {1.0f / 120, 5.0f / 120, 10.0f / 120, 10.0f / 120, 5.0f / 120,
     -5.0f / 120},
    {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f / 120}};

template <int ORDER>
__device__ __forceinline__ float poly(int k, int i) {
  if constexpr (ORDER == 3) return W3[k][i];
  else return W5[k][i];
}

template <int ORDER>
__device__ __forceinline__ void spline_weights(float t, float* w) {
#pragma unroll
  for (int k = 0; k <= ORDER; ++k) {
    float p = poly<ORDER>(k, ORDER);
#pragma unroll
    for (int i = ORDER - 1; i >= 0; --i) p = fmaf(p, t, poly<ORDER>(k, i));
    w[k] = p;
  }
}

__device__ __forceinline__ int wrap(int i, int n) { return ((i % n) + n) % n; }

// One pixel: sum_k wy_k sum_m wx_m tap(k, m), rows outer, columns inner.
template <int ORDER, typename Tap>
__device__ __forceinline__ float spline_sum(float ty, float tx, Tap tap) {
  float wy[ORDER + 1], wx[ORDER + 1];
  spline_weights<ORDER>(ty, wy);
  spline_weights<ORDER>(tx, wx);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k <= ORDER; ++k) {
    float t = 0.0f;
#pragma unroll
    for (int m = 0; m <= ORDER; ++m) t += wx[m] * tap(k, m);
    acc += wy[k] * t;
  }
  return acc;
}

template <int ORDER>
__global__ void __launch_bounds__(THREADS, 2)
lens_kernel(const float* __restrict__ coef, const float* __restrict__ alpha,
            float* __restrict__ out, unsigned long long* __restrict__ wide,
            int C, int ny, int nx, float rdy, float rdx, float D) {
  constexpr int O0 = ORDER == 3 ? -1 : -2;
  constexpr int WH = TY + RMAX + ORDER;   // window capacity, rows
  constexpr int WP = TX + RMAX + ORDER;   // and columns = the row pitch
  __shared__ float win[WH * WP];
  __shared__ int wrow[WH], wcol[WP];
  __shared__ int red[4][WARPS];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int bx0 = blockIdx.x * TX, by0 = blockIdx.y * TY;
  const int b = blockIdx.z;
  const int x = bx0 + tx;
  const int plane = ny * nx;
  const float* a = alpha + static_cast<int64_t>(b) * 2 * plane;
  const int64_t boff = static_cast<int64_t>(b) * C * plane;

  // the thread's pixels: floor and fraction of the clipped displacement
  float fry[PY], frx[PY];
  int fy[PY], fx[PY];
  int lo_y = INT_MAX, hi_y = INT_MIN, lo_x = INT_MAX, hi_x = INT_MIN;
#pragma unroll
  for (int p = 0; p < PY; ++p) {
    const int y = by0 + ty + TYT * p;
    const bool valid = x < nx && y < ny;
    float py = 0.0f, px = 0.0f;
    if (valid) {
      py = fminf(fmaxf(a[y * nx + x] * rdy, -D), D);
      px = fminf(fmaxf(a[plane + y * nx + x] * rdx, -D), D);
    }
    const float fly = floorf(py), flx = floorf(px);
    fy[p] = static_cast<int>(fly);
    fx[p] = static_cast<int>(flx);
    fry[p] = py - fly;
    frx[p] = px - flx;
    if (valid) {
      lo_y = min(lo_y, fy[p]);
      hi_y = max(hi_y, fy[p]);
      lo_x = min(lo_x, fx[p]);
      hi_x = max(hi_x, fx[p]);
    }
  }
  // the block's range of floors (every block holds a valid pixel)
  lo_y = __reduce_min_sync(FULL, lo_y);
  hi_y = __reduce_max_sync(FULL, hi_y);
  lo_x = __reduce_min_sync(FULL, lo_x);
  hi_x = __reduce_max_sync(FULL, hi_x);
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = lo_y;
    red[1][tid >> 5] = hi_y;
    red[2][tid >> 5] = lo_x;
    red[3][tid >> 5] = hi_x;
  }
  __syncthreads();
  const int part = (tid & 31) < WARPS ? (tid & 31) : 0;
  lo_y = __reduce_min_sync(FULL, red[0][part]);
  hi_y = __reduce_max_sync(FULL, red[1][part]);
  lo_x = __reduce_min_sync(FULL, red[2][part]);
  hi_x = __reduce_max_sync(FULL, red[3][part]);

  if (hi_y - lo_y > RMAX || hi_x - lo_x > RMAX) {
    // wide block: every tap from device memory, wrapped per tap
    if (tid == 0) atomicAdd(wide, 1ull);
    for (int c = 0; c < C; ++c) {
      const float* src = coef + boff + static_cast<int64_t>(c) * plane;
#pragma unroll
      for (int p = 0; p < PY; ++p) {
        const int y = by0 + ty + TYT * p;
        if (x >= nx || y >= ny) continue;
        const int r0 = y + fy[p] + O0, c0 = x + fx[p] + O0;
        out[boff + static_cast<int64_t>(c) * plane + y * nx + x] =
            spline_sum<ORDER>(fry[p], frx[p], [&](int k, int m) {
              return __ldg(src + wrap(r0 + k, ny) * nx + wrap(c0 + m, nx));
            });
      }
    }
    return;
  }

  // the window: rows y0w .. y0w + h - 1, columns x0w .. x0w + w - 1
  const int h = min(TY, ny - by0) + hi_y - lo_y + ORDER;
  const int w = min(TX, nx - bx0) + hi_x - lo_x + ORDER;
  const int y0w = by0 + lo_y + O0, x0w = bx0 + lo_x + O0;
  if (tid < h) wrow[tid] = wrap(y0w + tid, ny) * nx;
  if (tid < w) wcol[tid] = wrap(x0w + tid, nx);
  int base[PY];
#pragma unroll
  for (int p = 0; p < PY; ++p)
    base[p] = (ty + TYT * p + fy[p] - lo_y) * WP + tx + fx[p] - lo_x;
  constexpr int LR = (WH + TYT - 1) / TYT, LC = (WP + TX - 1) / TX;
  for (int c = 0; c < C; ++c) {
    const float* src = coef + boff + static_cast<int64_t>(c) * plane;
    __syncthreads();   // the tables are written; the last window is read
    // every load of the window issued before any store
    float v[LR][LC];
#pragma unroll
    for (int i = 0; i < LR; ++i)
#pragma unroll
      for (int j = 0; j < LC; ++j) {
        const int r = ty + i * TYT, q = tx + j * TX;
        v[i][j] = (r < h && q < w) ? __ldg(src + wrow[r] + wcol[q]) : 0.0f;
      }
#pragma unroll
    for (int i = 0; i < LR; ++i)
#pragma unroll
      for (int j = 0; j < LC; ++j) {
        const int r = ty + i * TYT, q = tx + j * TX;
        if (r < h && q < w) win[r * WP + q] = v[i][j];
      }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PY; ++p) {
      const int y = by0 + ty + TYT * p;
      if (x >= nx || y >= ny) continue;
      const float* wb = win + base[p];
      out[boff + static_cast<int64_t>(c) * plane + y * nx + x] =
          spline_sum<ORDER>(fry[p], frx[p],
                            [&](int k, int m) { return wb[k * WP + m]; });
    }
  }
}

}  // namespace

extern "C" {

// The output tile of a block (rows, columns) and the largest floor range
// per axis its window holds, for the wrapper and its tests.
int lens_spline_tile_rows() { return TY; }
int lens_spline_tile_cols() { return TX; }
int lens_spline_window_range() { return RMAX; }

// coef, out (B, C, ny, nx) f32; alpha (B, 2, ny, nx) f32 in radians; wide
// one u64 on the device, incremented once per block that takes its taps
// from device memory.
int lens_spline_launch(const float* coef, const float* alpha, float* out,
                       unsigned long long* wide, int B, int C, int ny,
                       int nx, float dy, float dx, int order, int maxdisp_px,
                       void* stream) {
  if (B < 1 || B > 65535 || C < 1 || ny < 1 || nx < 1
      || static_cast<int64_t>(ny) * nx > INT_MAX
      || (ny + TY - 1) / TY > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(TX, TYT);
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float D = static_cast<float>(maxdisp_px);
  if (order == 3)
    lens_kernel<3><<<grid, block, 0, s>>>(coef, alpha, out, wide, C, ny, nx,
                                          1.0f / dy, 1.0f / dx, D);
  else if (order == 5)
    lens_kernel<5><<<grid, block, 0, s>>>(coef, alpha, out, wide, C, ny, nx,
                                          1.0f / dy, 1.0f / dx, D);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
