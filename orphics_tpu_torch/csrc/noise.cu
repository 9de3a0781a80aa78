// Scaled complex white noise drawn in the kernel (kernel B5n of the port).
//
//   ore[b, i] = scale[i] * eta_re,   oim[b, i] = scale[i] * eta_im
//
// with eta standard normal, for (batch, plane) outputs and a plane-sized
// scale (any layout: the noise is white).
//
// Replaces orphics_tpu/ops/pallas_fft.py:noise_planes
// (_noise_planes_kernel), which draws the TPU's own random bits per block.
//
// Bound: writing the two output planes, 8 B per complex element (the
// scale plane is read once per batch entry and stays in L2), against the
// draw: Philox-4x32-10's ~64 integer instructions per pair of elements and
// ~25 fp32 operations per value (erfinvf, the uniform, the scale). The
// integer and fp32 pipes run side by side, and even their shared issue
// takes less time than the bytes, so the bytes bound the kernel.
//
// Design: counter-based Philox-4x32-10 (philox.cuh), keyed by the two
// 32-bit seed words, which the kernel reads from device memory (as the TPU
// kernel reads them from SMEM), so a caller can draw the words on the
// device without a host round trip. The counter of element e of the flat
// (batch, plane) output is the pair q = e / 2, and the four output words
// give the re and im values of elements 2q and 2q + 1 (philox.cuh), so
// every element of every plane gets its own bits; rowfft.cu's B5 draws the
// same stream. The grid is (plane chunk, batch entry): thread t of a chunk
// takes the four elements i = 4 t .. 4 t + 3 of its plane, its index in
// 32-bit arithmetic and the plane's offset formed once. Where the plane is
// a multiple of 4 and the arrays 16-byte aligned (noise_vec_kernel; every
// plane the pipelines draw) the four elements are pairs q0 and
// q0 + 1 of one plane: scale read as one float4, re and im written as one
// 16-byte evict-first store each (__stcs, as B5's stores). Any other plane
// (noise_any_kernel) takes the same four elements one at a time, the last
// chunk cut at the plane's end, with the one to three pairs they cover, so
// an odd total and a plane that is not a multiple of 4 are drawn exactly.
#include <cuda_runtime.h>
#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
noise_vec_kernel(const float4* __restrict__ scale,
                 const int* __restrict__ seed, float* __restrict__ ore,
                 float* __restrict__ oim, int quads, int batch) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= quads) return;
  const PhiloxKeys keys = philox_round_keys(seed_key(seed));
  const float4 w = scale[t];
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    // element 4 t of plane b is e = 4 (b quads + t), pairs e / 2 and
    // e / 2 + 1
    const int64_t e = 4 * (static_cast<int64_t>(b) * quads + t);
    const uint4 r0 = philox_pair(e >> 1, keys);
    const uint4 r1 = philox_pair((e >> 1) + 1, keys);
    __stcs(reinterpret_cast<float4*>(ore + e),
           make_float4(w.x * normal23(r0.x), w.y * normal23(r0.y),
                       w.z * normal23(r1.x), w.w * normal23(r1.y)));
    __stcs(reinterpret_cast<float4*>(oim + e),
           make_float4(w.x * normal23(r0.z), w.y * normal23(r0.w),
                       w.z * normal23(r1.z), w.w * normal23(r1.w)));
  }
}

__global__ void __launch_bounds__(THREADS)
noise_any_kernel(const float* __restrict__ scale,
                 const int* __restrict__ seed, float* __restrict__ ore,
                 float* __restrict__ oim, int plane, int batch) {
  const int i0 = 4 * (blockIdx.x * THREADS + threadIdx.x);
  if (i0 >= plane) return;
  const int cnt = min(4, plane - i0);
  const PhiloxKeys keys = philox_round_keys(seed_key(seed));
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const int64_t e0 = static_cast<int64_t>(b) * plane + i0;
    int64_t q = e0 >> 1;
    uint4 r = philox_pair(q, keys);
    for (int k = 0; k < cnt; ++k) {
      const int64_t e = e0 + k;
      if (e >> 1 != q) {
        q = e >> 1;
        r = philox_pair(q, keys);
      }
      const float w = scale[i0 + k];
      const bool odd = e & 1;
      ore[e] = w * normal23(odd ? r.y : r.x);
      oim[e] = w * normal23(odd ? r.w : r.z);
    }
  }
}

}  // namespace

extern "C" {

// scale (plane,) f32; seed (2,) i32 in device memory; ore, oim
// (batch, plane) f32; plane < 2^31. The 16-byte kernel where the plane is
// a multiple of 4 and the three arrays are 16-byte aligned, the other one
// else: the same stream.
int noise_planes_launch(const float* scale, const int* seed, float* ore,
                        float* oim, int batch, long long plane,
                        void* stream) {
  if (batch < 1 || plane < 1 || plane > 0x7ffffffcLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(plane);
  const int quads = (n + 3) / 4;
  const dim3 grid((quads + THREADS - 1) / THREADS, batch < 65535 ? batch
                                                                 : 65535);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0
                   && (reinterpret_cast<uintptr_t>(scale)
                       | reinterpret_cast<uintptr_t>(ore)
                       | reinterpret_cast<uintptr_t>(oim)) % 16 == 0;
  if (vec) {
    noise_vec_kernel<<<grid, THREADS, 0, st>>>(
        reinterpret_cast<const float4*>(scale), seed, ore, oim, quads, batch);
  } else {
    noise_any_kernel<<<grid, THREADS, 0, st>>>(scale, seed, ore, oim, n,
                                               batch);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
