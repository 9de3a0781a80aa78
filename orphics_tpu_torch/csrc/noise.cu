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
// scale plane is shared by the batch and stays in L2); Philox-4x32-10 costs
// ~70 integer operations per four 32-bit words, an erfinvf per value.
//
// Design: counter-based Philox-4x32-10 (philox.cuh), keyed by the two
// 32-bit seed words, which the kernel reads from device memory (as the TPU
// kernel reads them from SMEM), so a caller can draw the words on the
// device without a host round trip. One thread per pair of elements: the
// counter is the pair index, and the four output words give the re and im
// values of both elements, so every element of every plane gets its own
// bits. dft.cu's B5 draws with the same layout.
#include <cuda_runtime.h>
#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
noise_kernel(const float* __restrict__ scale, const int* __restrict__ seed,
             float* __restrict__ ore, float* __restrict__ oim,
             int64_t plane, int64_t total) {
  const PhiloxKeys keys = philox_round_keys(seed_key(seed));
  const int64_t npairs = (total + 1) / 2;
  for (int64_t q = blockIdx.x * static_cast<int64_t>(THREADS) + threadIdx.x;
       q < npairs; q += static_cast<int64_t>(gridDim.x) * THREADS) {
    const uint4 r = philox_pair(q, keys);
    const int64_t e = 2 * q;
    const float s0 = scale[e % plane];
    ore[e] = s0 * normal23(r.x);
    oim[e] = s0 * normal23(r.z);
    if (e + 1 < total) {
      const float s1 = scale[(e + 1) % plane];
      ore[e + 1] = s1 * normal23(r.y);
      oim[e + 1] = s1 * normal23(r.w);
    }
  }
}

}  // namespace

extern "C" {

// scale (plane,) f32; seed (2,) i32 in device memory; ore, oim
// (batch, plane) f32.
int noise_planes_launch(const float* scale, const int* seed, float* ore,
                        float* oim, int batch, long long plane,
                        void* stream) {
  if (batch < 1 || plane < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(batch) * plane;
  const int64_t npairs = (total + 1) / 2;
  int64_t blocks = (npairs + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;
  noise_kernel<<<static_cast<int>(blocks), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(scale, seed, ore, oim,
                                                      plane, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
