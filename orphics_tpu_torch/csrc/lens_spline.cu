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
// which on the TPU sums NS^2 = (2D + order + 1)^2 static shifts of a DMA'd
// halo window to avoid gathers.
//
// Bound: device memory traffic of the two alpha planes, the C coefficient
// maps and the C output maps (4 B each per pixel); the (order+1)^2 taps of
// a pixel's neighbourhood are served from L1/L2.
//
// Design: direct taps. One thread per output pixel reads its displacement,
// clips it to the cap, evaluates the (order+1) weights per axis once and
// reuses them for every component c. Neighbouring threads read neighbouring
// coefficients, so the gathers coalesce.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ void bspline3(float t, float* w) {
  const float u = 1.0f - t;
  w[0] = u * u * u / 6.0f;
  w[1] = 2.0f / 3.0f - t * t + 0.5f * t * t * t;
  w[2] = 2.0f / 3.0f - u * u + 0.5f * u * u * u;
  w[3] = t * t * t / 6.0f;
}

// Centered quintic B-spline, piecewise on |x| (same pieces as the
// reference's _bspline5_weights).
__device__ __forceinline__ float b5(float x) {
  const float a = fabsf(x);
  const float a2 = a * a, a3 = a2 * a, a4 = a3 * a, a5 = a4 * a;
  if (a < 1.0f)
    return (33.0f - 30.0f * a2 + 15.0f * a4 - 5.0f * a5) / 60.0f;
  if (a < 2.0f)
    return (51.0f + 75.0f * a - 210.0f * a2 + 150.0f * a3 - 45.0f * a4
            + 5.0f * a5) / 120.0f;
  if (a < 3.0f) {
    const float r = 3.0f - a;
    return r * r * r * r * r / 120.0f;
  }
  return 0.0f;
}

__device__ __forceinline__ int wrap(int i, int n) { return ((i % n) + n) % n; }

template <int ORDER>
__global__ void lens_kernel(const float* __restrict__ coef,
                            const float* __restrict__ alpha,
                            float* __restrict__ out, int C, int ny, int nx,
                            float dy, float dx, float D) {
  constexpr int NT = ORDER + 1;
  constexpr int O0 = ORDER == 3 ? -1 : -2;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= nx || y >= ny) return;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t pix = static_cast<int64_t>(y) * nx + x;
  const float* a = alpha + static_cast<int64_t>(b) * 2 * plane;
  const float py = fminf(fmaxf(a[pix] / dy, -D), D);
  const float px = fminf(fmaxf(a[plane + pix] / dx, -D), D);
  const float fy = floorf(py);
  const float fx = floorf(px);
  const float ty = py - fy;
  const float tx = px - fx;
  float wy[NT], wx[NT];
  if (ORDER == 3) {
    bspline3(ty, wy);
    bspline3(tx, wx);
  } else {
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      wy[k] = b5(ty - static_cast<float>(k + O0));
      wx[k] = b5(tx - static_cast<float>(k + O0));
    }
  }
  int row[NT], col[NT];
  const int y0 = y + static_cast<int>(fy) + O0;
  const int x0 = x + static_cast<int>(fx) + O0;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    row[k] = wrap(y0 + k, ny) * nx;
    col[k] = wrap(x0 + k, nx);
  }
  for (int c = 0; c < C; ++c) {
    const int64_t off = (static_cast<int64_t>(b) * C + c) * plane;
    const float* src = coef + off;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const float* r = src + row[k];
      float t = 0.0f;
#pragma unroll
      for (int m = 0; m < NT; ++m) t += wx[m] * __ldg(r + col[m]);
      acc += wy[k] * t;
    }
    out[off + pix] = acc;
  }
}

}  // namespace

extern "C" {

// coef, out (B, C, ny, nx) f32; alpha (B, 2, ny, nx) f32 in radians.
int lens_spline_launch(const float* coef, const float* alpha, float* out,
                       int B, int C, int ny, int nx, float dy, float dx,
                       int order, int maxdisp_px, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y,
                  B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float D = static_cast<float>(maxdisp_px);
  if (order == 3)
    lens_kernel<3><<<grid, block, 0, s>>>(coef, alpha, out, C, ny, nx, dy, dx,
                                          D);
  else if (order == 5)
    lens_kernel<5><<<grid, block, 0, s>>>(coef, alpha, out, C, ny, nx, dy, dx,
                                          D);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
