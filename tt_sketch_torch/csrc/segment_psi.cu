// The Psi segment reduction of a mode without a sort/chunk plan, for Hopper:
//
//   out[n, a, b] = sum over k with idx[k] == n of
//                  left[a, k] * ent[k] * right[b, k]
//
// idx (nnz,) int64, ent (nnz,), left (r1, nnz) or none (r1 = 1, a factor
// of 1), right (r2, nnz) or none (r2 = 1) -> out (n_mu, r1, r2), all float
// or all double.  Indices outside [0, n_mu) are dropped.
//
// Replaces the one-hot segment reduction of
// tt_sketch_tpu/kernels/sketch_kernels.py:_psi_sparse_segment (the form the
// JAX package takes on a TPU; jax.ops.segment_sum elsewhere).  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with a plain C interface, loaded by
// tt_sketch_torch/kernels/segment_psi.py through ctypes.
//
// What bounds it.  Per nonzero the function reads 12 + 4 * (r1 + r2) bytes
// and does r1 * r2 products and adds; at the FROSTT-uber modes it serves
// (183 rows x rank 20, 24 rows x rank 10 x 20) that is 92-132 bytes and up
// to 200 adds per nonzero, into a few thousand outputs.  A scatter with
// atomics (index_add_) collides on so few rows; a one-hot product does
// n_mu times the work.
//
// What the design does about it.  Two kernels, no atomics, a fixed order:
// the result is the same on every run.
//   1. Each block takes a contiguous range of `chunk` nonzeros and a tile
//      of the r1 * r2 rank pairs, and keeps the (n_mu, tile) bins of that
//      tile in shared memory.  It walks its range in steps of tk nonzeros:
//      the block's threads (at least 128, so that a tile of few pairs
//      still has loads in flight) stage the step's indices, the entries
//      times the left rows the tile reads, and the right rows in shared
//      memory, each array read along k by consecutive threads (coalesced),
//      rows padded to tk + 1 values.  Then a thread owns one rank pair (a
//      column of the bins) and adds the step's products in order into the
//      rows idx[k] of its column, four nonzeros' operands loaded ahead of
//      their adds: no two threads touch one bin; a warp's 32 columns lie in
//      32 banks, and its reads of the staged rows (up to 32 right rows at
//      one k, stride tk + 1) in 32 banks too.  The block then writes its
//      bins to partials[chunk][n][pair].  Reading left[a, k] and
//      right[b, k] straight from global memory instead costs a warp one
//      cache line per row at every k (22 lines at rank 10 x 20).
//   2. A second kernel sums the partials over the chunks in a fixed order:
//      a block of 8 warps takes 32 consecutive outputs, warp w the chunks
//      w, w + 8, ..., and warp 0 adds the 8 sums in order.
// The tile of rank pairs is the largest whose bins and a step of MIN_TK
// staged nonzeros fit SMEM_BUDGET bytes (all pairs of a float32 Psi of up
// to 16384 values, the most the package sends; float64 bins may take two
// tiles); tk is then as large as the rest allows, up to TK.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MIN_THREADS = 128;  // staging threads, even for few pairs
constexpr int MAX_THREADS = 256;
constexpr size_t SMEM_BUDGET = 96 * 1024;  // opt-in shared memory per block
constexpr int TK = 128;                    // staged nonzeros per step
constexpr int MIN_TK = 8;
constexpr int AHEAD = 4;  // nonzeros whose operands are loaded ahead
constexpr int REDUCE_WARPS = 8;

template <typename T>
__global__ void segment_partial_kernel(const int64_t* __restrict__ idx,
                                       const T* __restrict__ ent,
                                       const T* __restrict__ left,
                                       const T* __restrict__ right,
                                       T* __restrict__ partials, int64_t nnz,
                                       int n_mu, int r2, int R, int64_t chunk,
                                       int ab_tile, int tk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ab0 = blockIdx.y * ab_tile;
  const int tile = min(ab_tile, R - ab0);
  const int cells = n_mu * tile;
  // the left rows a_lo .. a_lo + na - 1 this tile of pairs reads; every
  // right row
  const int a_lo = ab0 / r2;
  const int na = (ab0 + tile - 1) / r2 - a_lo + 1;
  const int ld = tk + 1;
  T* bins = reinterpret_cast<T*>(smem_raw);
  T* w_s = bins + cells;   // (na, ld): entries times left rows
  T* r_s = w_s + na * ld;  // (r2, ld): right rows
  int* idx_s = reinterpret_cast<int*>(r_s + (right ? r2 * ld : 0));
  for (int i = threadIdx.x; i < cells; i += blockDim.x) bins[i] = T(0);
  const int64_t k0 = (int64_t)blockIdx.x * chunk;
  const int64_t k1 = min(nnz, k0 + chunk);
  for (int64_t kt = k0; kt < k1; kt += tk) {
    const int cnt = (int)min((int64_t)tk, k1 - kt);
    __syncthreads();  // the previous step is consumed, the bins zeroed
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
      const int64_t n = idx[kt + t];
      idx_s[t] = (n >= 0 && n < n_mu) ? (int)n : -1;
    }
#pragma unroll 4
    for (int i = threadIdx.x; i < na * cnt; i += blockDim.x) {
      const int a = i / cnt, t = i - a * cnt;
      const T e = ent[kt + t];
      w_s[a * ld + t] =
          left ? left[(int64_t)(a_lo + a) * nnz + kt + t] * e : e;
    }
    if (right) {
#pragma unroll 4
      for (int i = threadIdx.x; i < r2 * cnt; i += blockDim.x) {
        const int b = i / cnt, t = i - b * cnt;
        r_s[b * ld + t] = right[(int64_t)b * nnz + kt + t];
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < tile; j += blockDim.x) {
      const int ab = ab0 + j;
      const T* wrow = w_s + (ab / r2 - a_lo) * ld;
      const T* rrow = right ? r_s + (ab % r2) * ld : nullptr;
      T* col = bins + j;
      int t = 0;
      for (; t + AHEAD <= cnt; t += AHEAD) {
        int n[AHEAD];
        T v[AHEAD];
#pragma unroll
        for (int q = 0; q < AHEAD; ++q) {
          n[q] = idx_s[t + q];
          v[q] = rrow ? wrow[t + q] * rrow[t + q] : wrow[t + q];
        }
#pragma unroll
        for (int q = 0; q < AHEAD; ++q) {
          if (n[q] >= 0) col[n[q] * tile] += v[q];
        }
      }
      for (; t < cnt; ++t) {
        const int n = idx_s[t];
        const T v = rrow ? wrow[t] * rrow[t] : wrow[t];
        if (n >= 0) col[n * tile] += v;
      }
    }
  }
  __syncthreads();
  T* part = partials + (int64_t)blockIdx.x * n_mu * R + ab0;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int n = i / tile;
    part[(int64_t)n * R + (i - n * tile)] = bins[i];
  }
}

template <typename T>
__global__ void segment_reduce_kernel(const T* __restrict__ partials,
                                      T* __restrict__ out, int n_chunks,
                                      int64_t cells) {
  __shared__ T sums[REDUCE_WARPS][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t i = (int64_t)blockIdx.x * 32 + lane;
  T s = T(0);
  if (i < cells) {
    for (int c = w; c < n_chunks; c += REDUCE_WARPS) {
      s += partials[(int64_t)c * cells + i];
    }
  }
  sums[w][lane] = s;
  __syncthreads();
  if (w == 0 && i < cells) {
    T t = sums[0][lane];
    for (int q = 1; q < REDUCE_WARPS; ++q) t += sums[q][lane];
    out[i] = t;
  }
}

// Shared-memory bytes of a block: the (n_mu, tile) bins and a step of tk
// staged nonzeros (indices, the left rows a tile can span, every right row).
size_t block_bytes(size_t elem, int n_mu, int r1, int r2, bool has_right,
                   int tile, int tk) {
  int na = tile / r2 + 2;
  if (na > r1) na = r1;
  const size_t rows = (size_t)na + (has_right ? (size_t)r2 : 0);
  return elem * ((size_t)n_mu * tile + rows * (tk + 1)) + sizeof(int) * tk;
}

template <typename T>
int launch(const int64_t* idx, const void* ent, const void* left,
           const void* right, void* partials, void* out, int64_t nnz,
           int n_mu, int r1, int r2, int64_t chunk, int n_chunks,
           cudaStream_t stream) {
  const int R = r1 * r2;
  const bool has_right = right != nullptr;
  auto bytes_at = [&](int tile, int tk) {
    return block_bytes(sizeof(T), n_mu, r1, r2, has_right, tile, tk);
  };
  int ab_tile = (int)(SMEM_BUDGET / ((size_t)n_mu * sizeof(T)));
  if (ab_tile > R) ab_tile = R;
  while (ab_tile > 1 && bytes_at(ab_tile, MIN_TK) > SMEM_BUDGET) --ab_tile;
  if (ab_tile < 1 || bytes_at(ab_tile, MIN_TK) > SMEM_BUDGET) {
    return (int)cudaErrorInvalidValue;
  }
  int tk = TK;
  while (bytes_at(ab_tile, tk) > SMEM_BUDGET) --tk;
  const size_t bytes = bytes_at(ab_tile, tk);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        segment_partial_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BUDGET);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = (ab_tile + 31) / 32 * 32;
  if (threads < MIN_THREADS) threads = MIN_THREADS;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const dim3 grid((unsigned)n_chunks,
                  (unsigned)((R + ab_tile - 1) / ab_tile));
  segment_partial_kernel<T><<<grid, threads, bytes, stream>>>(
      idx, static_cast<const T*>(ent), static_cast<const T*>(left),
      static_cast<const T*>(right), static_cast<T*>(partials), nnz, n_mu, r2,
      R, chunk, ab_tile, tk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t cells = (int64_t)n_mu * R;
  segment_reduce_kernel<T>
      <<<(unsigned)((cells + 31) / 32), 32 * REDUCE_WARPS, 0, stream>>>(
          static_cast<const T*>(partials), static_cast<T*>(out), n_chunks,
          cells);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// elem is 4 (float) or 8 (double); nnz > 0; partials holds
// n_chunks * n_mu * r1 * r2 values, chunk * n_chunks >= nnz and
// r1 * r2 <= 65535.  The bins of one rank pair of every row and a step of
// MIN_TK staged nonzeros must fit SMEM_BUDGET: 4096 rows with ranks up to
// about 2000 in float.  Returns the cudaError_t of the launches (0 on
// success).
int tt_segment_psi(int elem, const int64_t* idx, const void* ent,
                   const void* left, const void* right, void* partials,
                   void* out, int64_t nnz, int n_mu, int r1, int r2,
                   int64_t chunk, int n_chunks, void* stream) {
  if ((elem != 4 && elem != 8) || nnz <= 0 || n_mu <= 0 || r1 <= 0 ||
      r2 <= 0 || (left == nullptr && r1 != 1) ||
      (right == nullptr && r2 != 1) || n_chunks <= 0 || chunk <= 0 ||
      chunk * (int64_t)n_chunks < nnz ||
      (int64_t)r1 * r2 > 65535) {  // tiles of rank pairs: grid.y
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (elem == 4) {
    return launch<float>(idx, ent, left, right, partials, out, nnz, n_mu, r1,
                         r2, chunk, n_chunks, s);
  }
  return launch<double>(idx, ent, left, right, partials, out, nnz, n_mu, r1,
                        r2, chunk, n_chunks, s);
}

const char* tt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
