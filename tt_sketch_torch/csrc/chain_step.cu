// Sparse TT chain step for Hopper: advance the per-nonzero chain state by
// one TT core at the nonzeros' mode indices.
//
//   out[k, j] = Σ_i state[i, j] · core[i, idx[j], k]        (r1, nnz) -> (r2, nnz)
//   out[k, j] = core[0, idx[j], k]                          first step, no state
//
// Replaces tt_sketch_tpu/kernels/pallas_chain.py:_chain_kernel and
// _chain_kernel_first (entry chain_step_t through _chain_blocks), which
// build an (n, C) one-hot of the mode indices and contract the whole core
// against it because that machine cannot gather.  Here the product is the
// direct gather, so its cost does not grow with the mode size and there is
// no cap on n, nnz or the ranks.  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded by tt_sketch_torch/kernels/chain_step.py through ctypes.
//
// What bounds it.  Per nonzero the step reads r1 state floats and an 8-byte
// index and writes r2 floats, (r1 + r2) * 4 + 8 bytes of device memory, and
// spends r1 * r2 FMAs: at ranks 10/10 that is 88 bytes against 100
// lane-instructions, 1.1 per byte against the CUDA cores' ridge of
// 33.5e12 / 3.35e12 = 10, so bytes bound it as long as the core itself
// (n * r1 * r2 floats, read once) stays out of device-memory traffic.
//
// What the design does about it.  State and output stay (r, nnz) row-major:
// thread t of a warp owns nonzero j + t, so its reads of state[i, j] and its
// writes of out[k, j] are 32 consecutive floats.  The wrapper hands the core
// re-laid out as (n, r1 * r2), so a nonzero reads one contiguous run.  A
// core of at most CORE_SMEM_BYTES is staged once per block in shared memory
// (a block walks CHUNK nonzeros, so staging costs a small share of the
// gathers it serves); a larger one (FROSTT-uber's 1140 x 100 floats) is read
// through the read-only cache and stays resident in the 50 MB L2.  Sums run
// over i in increasing order with fmaf, KT outputs at a time in registers:
// the result is deterministic.  An index outside [0, n) gives a column of
// zeros (what the one-hot form gives) and reads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 4096;              // nonzeros per block
constexpr int KT = 8;                    // outputs kept in registers at a time
constexpr size_t CORE_SMEM_BYTES = 96 * 1024;  // two blocks per SM still fit

template <bool FIRST>
__global__ void __launch_bounds__(THREADS)
chain_step_kernel(const float* __restrict__ state,
                  const float* __restrict__ core_t,
                  const int64_t* __restrict__ idx, float* __restrict__ out,
                  int64_t nnz, int n, int r1, int r2, int staged) {
  extern __shared__ float core_s[];
  const int w = r1 * r2;
  const float* core = core_t;
  if (staged) {
    const int total = n * w;
    for (int i = threadIdx.x; i < total; i += THREADS) core_s[i] = core_t[i];
    __syncthreads();
    core = core_s;
  }
  const int64_t j0 = (int64_t)blockIdx.x * CHUNK;
  const int64_t j1 = j0 + CHUNK < nnz ? j0 + CHUNK : nnz;
  for (int64_t j = j0 + threadIdx.x; j < j1; j += THREADS) {
    const int64_t row = idx[j];
    const bool inside = row >= 0 && row < n;
    const float* c = core + (inside ? row : 0) * w;
    for (int k0 = 0; k0 < r2; k0 += KT) {
      float acc[KT];
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) acc[kk] = 0.f;
      if (inside) {
        if (FIRST) {
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) {
            if (k0 + kk < r2) acc[kk] = staged ? c[k0 + kk] : __ldg(c + k0 + kk);
          }
        } else {
          for (int i = 0; i < r1; ++i) {
            const float s = state[(int64_t)i * nnz + j];
            const float* ci = c + i * r2 + k0;
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) {
              if (k0 + kk < r2) {
                acc[kk] = fmaf(s, staged ? ci[kk] : __ldg(ci + kk), acc[kk]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        if (k0 + kk < r2) out[(int64_t)(k0 + kk) * nnz + j] = acc[kk];
      }
    }
  }
}

template <bool FIRST>
cudaError_t launch(const float* state, const float* core_t,
                   const int64_t* idx, float* out, int64_t nnz, int n, int r1,
                   int r2, cudaStream_t stream) {
  const size_t core_bytes = (size_t)n * r1 * r2 * sizeof(float);
  const int staged = core_bytes <= CORE_SMEM_BYTES;
  const size_t smem = staged ? core_bytes : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        chain_step_kernel<FIRST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (nnz + CHUNK - 1) / CHUNK;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  chain_step_kernel<FIRST><<<(unsigned)blocks, THREADS, smem, stream>>>(
      state, core_t, idx, out, nnz, n, r1, r2, staged);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (r2, nnz) from state (r1, nnz) (NULL: the first step, r1 must be 1),
// core_t (n, r1 * r2) with core_t[row, i * r2 + k] = core[i, row, k], and
// idx (nnz,) int64.  Returns the cudaError_t of the launch (0 on success).
int tt_chain_step(const float* state, const float* core_t, const int64_t* idx,
                  float* out, int64_t nnz, int n, int r1, int r2,
                  void* stream) {
  if (nnz <= 0 || n <= 0 || r1 <= 0 || r2 <= 0 || (!state && r1 != 1) ||
      (int64_t)n * r1 * r2 > 0x7FFFFFFF) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = state
      ? launch<false>(state, core_t, idx, out, nnz, n, r1, r2, st)
      : launch<true>(nullptr, core_t, idx, out, nnz, n, r1, r2, st);
  return (int)err;
}

// Bytes of core the kernel stages in shared memory (a larger core is read
// through the cache).
int tt_chain_step_staged_bytes(void) { return (int)CORE_SMEM_BYTES; }

const char* tt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
