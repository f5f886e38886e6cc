// Sparse-sign DRM rows for Hopper.
//
//   out[s - rank_min, n] = column_n[s],  s in [rank_min, rank_max)
//
// where column_n is the sparse-sign column of flat[n] (hash_rng.cuh:
// nnz hashed +-1 shuffled over `rank` slots).  flat (N,), salts (nnz,)
// uint64 -> out (rank_max - rank_min, N) float32 in {-1, 0, +1}, bit-exact.
//
// Replaces tt_sketch_tpu/kernels/pallas_rng.py:_sign_rows_kernel (entry
// _generate_sign_pairs, reached from sparse_sign_pallas_from_pairs).  Built
// with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with a plain C interface, loaded by
// tt_sketch_torch/kernels/sparse_sign.py through ctypes.
//
// What bounds it.  Per column the kernel reads 8 bytes and writes
// 4 * (rank_max - rank_min), and runs nnz hashes, nnz swap positions and
// nnz swaps.  At nnz = rank = 10 or 20 (the ranks the sketches use) that is
// some hundreds of instructions for 48 or 88 bytes, far above the CUDA
// cores' ridge of ~10 instructions per byte: the kernel is bound by its
// instructions, and by the dependent chain of its swaps.
//
// What the design does about it.  One thread per column; the flat index
// sits in a register.
//   - rank <= 32 (sparse_sign_regs, templated on the rank buckets 16 and
//     32): the whole column lives in one register word, 2-bit fields
//     (tt_rng::sign_column_word).  Each draw is hashed once; its sign is
//     set into its field and twice its swap position kept in a register
//     (the loops are unrolled, so no array goes to local memory; draws go
//     in pairs at RB = 16 and fours at RB = 32 under one test of j < nnz,
//     so that their hash chains interleave); then the swaps run on the
//     fields, and the output loop reads fields [rank_min, rank_max) as
//     +-1.0f / 0.0f through one running row pointer.  The hash's first
//     constant is added to the flat index once; the salts sit in shared
//     memory (one broadcast load a draw).  Nothing else touches memory: no
//     slot initialisation, no second hash, no byte loads and stores.
//   - larger ranks (sparse_sign_kernel): the column's `rank` slots are int8
//     in shared memory at slots[s * T + thread] (a swap is two byte loads
//     and two byte stores) and each draw is hashed twice
//     (tt_rng::sign_column).  The block size shrinks as rank grows so that
//     T * rank bytes fit (down to 32 threads at rank 5811 with
//     nnz = rank, the largest it takes: tt_sparse_sign_max_rank).
// Stores of out[r, n] by a warp are 32 consecutive floats.  No state is
// shared between threads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_rng.cuh"
#include "runtime.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr size_t SMEM_LIMIT = 232448;  // opt-in shared memory per block
constexpr int REG_THREADS = 256;       // threads per block, rank <= 32

// draws under one test of j < nnz in the register instance of bucket rb
__host__ __device__ constexpr int draw_group(int rb) {
  return rb > 16 ? 4 : 2;
}

template <int RB>
__global__ void __launch_bounds__(REG_THREADS)
    sparse_sign_regs(const uint64_t* __restrict__ flat,
                     const uint64_t* __restrict__ salts,
                     float* __restrict__ out, int64_t N, int rank, int nnz,
                     int rank_min, int rank_max) {
  __shared__ uint64_t salts_s[RB];  // zero past nnz: a group's tail
  if ((int)threadIdx.x < RB) {
    salts_s[threadIdx.x] = (int)threadIdx.x < nnz ? salts[threadIdx.x] : 0;
  }
  __syncthreads();
  const int64_t n = (int64_t)blockIdx.x * REG_THREADS + threadIdx.x;
  if (n >= N) return;
  const tt_rng::SignWord<RB> w = tt_rng::sign_column_word<RB, draw_group(RB)>(
      flat[n], salts_s, rank, nnz);
  // slot rank_min + r at the fixed shift 2r: one running row pointer
  const tt_rng::SignWord<RB> v = w >> (2 * rank_min);
  float* o = out + n;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r >= rank_max - rank_min) break;
    *o = tt_rng::sign_slot((uint32_t)(v >> (2 * r)));
    o += N;
  }
}

__global__ void sparse_sign_kernel(const uint64_t* __restrict__ flat,
                                   const uint64_t* __restrict__ salts,
                                   float* __restrict__ out, int64_t N,
                                   int rank, int nnz, int rank_min,
                                   int rank_max) {
  extern __shared__ uint64_t smem[];
  uint64_t* salts_s = smem;
  int8_t* slots = reinterpret_cast<int8_t*>(salts_s + nnz);
  const int T = blockDim.x;
  for (int j = threadIdx.x; j < nnz; j += T) salts_s[j] = salts[j];
  __syncthreads();
  const int64_t n = (int64_t)blockIdx.x * T + threadIdx.x;
  if (n >= N) return;
  int8_t* mine = slots + threadIdx.x;
  tt_rng::sign_column(flat[n], salts_s, rank, nnz, mine, T);
#pragma unroll 1
  for (int s = rank_min; s < rank_max; ++s) {
    out[(int64_t)(s - rank_min) * N + n] = (float)mine[s * T];
  }
}

// threads per block so that the salts and T * rank slot bytes fit
int block_threads(int rank, int nnz) {
  const size_t left = SMEM_LIMIT - (size_t)nnz * sizeof(uint64_t);
  size_t t = left / (size_t)rank;
  if (t > MAX_THREADS) t = MAX_THREADS;
  return (int)(t / 32 * 32);
}

template <int RB>
int launch_regs(const uint64_t* flat, const uint64_t* salts, float* out,
                int64_t N, int rank, int nnz, int rank_min, int rank_max,
                cudaStream_t stream) {
  const int64_t blocks = (N + REG_THREADS - 1) / REG_THREADS;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  sparse_sign_regs<RB><<<(unsigned)blocks, REG_THREADS, 0, stream>>>(
      flat, salts, out, N, rank, nnz, rank_min, rank_max);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest rank the kernel takes with nnz = rank.
int tt_sparse_sign_max_rank(void) {
  return (int)(SMEM_LIMIT / (32 + sizeof(uint64_t)));
}

// Returns the cudaError_t of the launch (0 on success).
int tt_sparse_sign_rows(const uint64_t* flat, const uint64_t* salts,
                        float* out, int64_t N, int rank, int nnz,
                        int rank_min, int rank_max, void* stream) {
  if (N <= 0 || rank <= 0 || nnz < 0 || nnz > rank || rank_min < 0 ||
      rank_max <= rank_min || rank_max > rank ||
      rank > tt_sparse_sign_max_rank()) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (rank <= 16) {
    return launch_regs<16>(flat, salts, out, N, rank, nnz, rank_min,
                           rank_max, s);
  }
  if (rank <= 32) {
    return launch_regs<32>(flat, salts, out, N, rank, nnz, rank_min,
                           rank_max, s);
  }
  const int T = block_threads(rank, nnz);
  if (T < 32) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)nnz * sizeof(uint64_t) + (size_t)T * rank;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sparse_sign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (N + T - 1) / T;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  sparse_sign_kernel<<<(unsigned)blocks, T, bytes, s>>>(
      flat, salts, out, N, rank, nnz, rank_min, rank_max);
  return (int)cudaGetLastError();
}

}  // extern "C"
