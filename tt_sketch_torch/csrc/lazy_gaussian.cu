// Lazy-Gaussian DRM rows for Hopper.
//
//   out[r, n] = sample(flat[n], salts[r])     flat (N,), salts (R,) uint64
//                                            -> out (R, N) float32
//
// Replaces tt_sketch_tpu/kernels/pallas_rng.py:_drm_block_kernel (entry
// _generate_pairs, reached from lazy_gaussian_pallas).  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with a plain C interface, loaded by
// tt_sketch_torch/kernels/lazy_gaussian.py through ctypes.
//
// What bounds it.  Per output sample the kernel reads nothing new (the flat
// index is reused across the R rows, the salts sit in shared memory) and
// writes 4 bytes, while it issues 96 instructions (hash64, erfinv, the
// loop and the store; chip_smoke.py counts them in this kernel's sm_90a
// SASS).  At 96 lane-instructions per 4 bytes the H100's CUDA cores
// (33.5e12 lane-instructions/s at the 67 TFLOP/s fp32 peak) need 2.9e-12 s
// per sample against 1.2e-12 s for its 4 bytes at 3.35 TB/s: the kernel is
// bound by operations.
//
// What the design does about it.  One thread per column n: the flat index
// is loaded once into a register and the thread walks the R salts, so the
// 8-byte index costs nothing per sample.  Stores of out[r, n] by a warp are
// 32 consecutive floats (coalesced).  No shared state between threads, no
// synchronization beyond the salt load.
//
// tt_hash_bits exports the bare 64-bit hash so that a caller can hold the
// device's 64-bit integer arithmetic against the host hash bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_rng.cuh"
#include "runtime.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROWS = 4096;  // salts held in shared memory (32 KB)

__global__ void __launch_bounds__(THREADS)
lazy_gaussian_kernel(const uint64_t* __restrict__ flat,
                     const uint64_t* __restrict__ salts,
                     float* __restrict__ out, int64_t N, int R) {
  extern __shared__ uint64_t salts_s[];
  for (int r = threadIdx.x; r < R; r += blockDim.x) salts_s[r] = salts[r];
  __syncthreads();
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const uint64_t f = flat[n];
  for (int r = 0; r < R; ++r) {
    out[(int64_t)r * N + n] = tt_rng::sample(f, salts_s[r]);
  }
}

__global__ void hash_bits_kernel(const uint64_t* __restrict__ x,
                                 uint64_t* __restrict__ out, int64_t N) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n < N) out[n] = tt_rng::hash64(x[n]);
}

}  // namespace

extern "C" {

int tt_lazy_gaussian_max_rows(void) { return MAX_ROWS; }

// Returns the cudaError_t of the launch (0 on success).
int tt_lazy_gaussian(const uint64_t* flat, const uint64_t* salts, float* out,
                     int64_t N, int R, void* stream) {
  if (N <= 0 || R <= 0 || R > MAX_ROWS) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  lazy_gaussian_kernel<<<blocks, THREADS, R * sizeof(uint64_t),
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      flat, salts, out, N, R);
  return (int)cudaGetLastError();
}

int tt_hash_bits(const uint64_t* x, uint64_t* out, int64_t N, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  hash_bits_kernel<<<blocks, THREADS, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(x, out, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
