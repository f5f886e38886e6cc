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
// and loaded by tt_sketch_torch/kernels/chain_step.py through ctypes, whose
// chain_schedule() makes every launch decision (layout, buckets, where the
// core lives); this file only checks and follows them.
//
// What bounds it.  Per nonzero the step reads r1 state floats and an 8-byte
// index and writes r2 floats, (r1 + r2) * 4 + 8 bytes of device memory, and
// spends r1 * r2 FMAs: at ranks 10/10 that is 88 bytes against 100
// lane-instructions, 1.1 per byte against the CUDA cores' ridge of
// 33.5e12 / 3.35e12 = 10, so device-memory bytes bound it.  Besides those
// it gathers r1 * r2 * 4 bytes of core row per nonzero from shared memory or
// the cache, 4.5x the device-memory bytes at ranks 10/10: the design keeps
// that gather cheap in instructions and in shared-memory wavefronts.
//
// The design.
//   - One pass per nonzero.  Thread t of a block owns nonzero j; it loads
//     its r1 state values once into registers (coalesced: state is (r1, nnz)
//     row-major), keeps all r2 sums in registers, and stores each output
//     once, streaming (__ldcs/__stcs keep the single-use state and output
//     out of the way of the core's lines in L2).  Templates on rank buckets
//     (r1 in R1_BUCKETS, r2 in R2_BUCKETS) fix the register arrays, and a
//     register budget per instance keeps four blocks on an SM (unbounded,
//     ptxas held a whole row in registers and left one); a rank past the
//     largest bucket takes the generic instance, which tiles the outputs
//     by 32 and reads each state value from device memory once into a
//     shared-memory stage.
//   - 16-byte core rows.  pack_rows lays the core out as rows of quads: the
//     first step's row is core[0, row, :] padded to a multiple of 4; a
//     step's row holds quad (i2, k2) = {c[2i2, 2k2], c[2i2+1, 2k2],
//     c[2i2, 2k2+1], c[2i2+1, 2k2+1]} at i2 * nk2 + k2 (ranks padded to
//     even with zeros).  One LDS.128 / LDG.128 feeds four FMAs and the sums
//     over i still run in increasing order: at ranks 10/10, 25 loads a
//     nonzero where a float at a time took 100.  The row stride is an odd
//     number of quads, so the rows a quarter-warp gathers start on all
//     eight quad positions of the banks.
//   - Persistent blocks.  The grid is the blocks that fit on the card at
//     once (the occupancy calculator times the SM count); each block walks
//     a contiguous share of the nonzeros, THREADS at a time.
//   - Where the core lives (the wrapper decides, by size).  A small core is
//     copied into each block's shared memory once, by 16-byte cp.async,
//     while the block's first indices and state load.  A larger one is read
//     through the read-only cache (ld.global.nc), where L1 and the 50 MB L2
//     hold it; on the card that is as fast as a stage that leaves fewer
//     blocks on an SM.  Splitting a large core across a thread-block
//     cluster's shared memory (read through distributed shared memory) was
//     measured slower than the cache and is not kept.
//   - Sums over i run in increasing order with fmaf and no atomics: two
//     calls give the same bits.  The first step copies: it is exact.  An
//     index outside [0, n) gives a column of zeros and reads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "runtime.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int R1_BUCKETS[] = {4, 8, 16, 32};
constexpr int R2_BUCKETS[] = {4, 8, 12, 16, 32};
constexpr int GENERIC_TILE = 32;  // outputs a generic thread sums at a time

// Blocks an SM must hold at once (__launch_bounds__): caps the registers of
// an instance at 64 for buckets up to 16 + 16.
constexpr int min_blocks(int b1, int b2) {
  return b1 + b2 <= 32 ? 4 : 2;
}

enum Place : int { PLACE_BLOCK = 0, PLACE_CACHE = 1 };

struct Args {
  const float* state;     // (r1, nnz); NULL on the first step
  const float4* core;     // (n, stride4) quads
  const int64_t* idx;     // (nnz,)
  float* out;             // (r2, nnz)
  int64_t nnz;
  int64_t share;          // nonzeros per block, a multiple of 32
  int n, r1, r2;
  int stride4;            // quads between rows
  int nq;                 // quads of a first-step row; nk2 of a step
  int state_cols;         // generic step: nonzeros whose state is staged
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

// One core row, wherever the core lives: get(q) is its q-th quad.
template <int PLACE>
struct Row {
  uint32_t s;        // shared address of the row
  const float4* g;   // the row in device memory
  __device__ __forceinline__ void at(const Args& a, uint32_t s_base,
                                     int64_t row) {
    if (PLACE == PLACE_BLOCK) {
      s = s_base + (uint32_t)row * (uint32_t)a.stride4 * 16u;
    } else {
      g = a.core + row * a.stride4;
    }
  }
  __device__ __forceinline__ float4 get(int q) const {
    if (PLACE == PLACE_BLOCK) return lds128(s + 16u * q);
    return __ldg(g + q);
  }
};

// This thread's nonzero j (if inside its block's share): the index and
// the state column.
template <bool FIRST, int B1>
__device__ __forceinline__ void load_column(const Args& a, int64_t j,
                                            int64_t j_hi, int64_t& row,
                                            float (&s)[B1]) {
  const bool live = j < j_hi;
  row = live ? (int64_t)__ldcs(reinterpret_cast<const long long*>(a.idx) + j)
             : -1;
#pragma unroll
  for (int i = 0; i < B1; ++i) {
    s[i] = (!FIRST && live && i < a.r1) ? __ldcs(a.state + i * a.nnz + j)
                                        : 0.f;
  }
}

// The outputs of nonzero j from its index and state.
template <bool FIRST, int B1, int B2, int PLACE>
__device__ __forceinline__ void gather_store(const Args& a, uint32_t s_base,
                                             int64_t j, int64_t row,
                                             const float (&s)[B1]) {
  float acc[B2];
#pragma unroll
  for (int k = 0; k < B2; ++k) acc[k] = 0.f;
  if (row >= 0 && row < a.n) {
    Row<PLACE> r;
    r.at(a, s_base, row);
    if (FIRST) {
#pragma unroll
      for (int q = 0; q < B2 / 4; ++q) {
        if (q < a.nq) {
          const float4 v = r.get(q);
          acc[4 * q] = v.x;
          acc[4 * q + 1] = v.y;
          acc[4 * q + 2] = v.z;
          acc[4 * q + 3] = v.w;
        }
      }
    } else {
      const int ni2 = (a.r1 + 1) >> 1, nk2 = a.nq;
#pragma unroll
      for (int i2 = 0; i2 < B1 / 2; ++i2) {
        if (i2 >= ni2) break;
        const float s0 = s[2 * i2], s1 = s[2 * i2 + 1];
#pragma unroll
        for (int k2 = 0; k2 < B2 / 2; ++k2) {
          if (k2 < nk2) {
            const float4 v = r.get(i2 * nk2 + k2);
            acc[2 * k2] = fmaf(s0, v.x, acc[2 * k2]);
            acc[2 * k2] = fmaf(s1, v.y, acc[2 * k2]);
            acc[2 * k2 + 1] = fmaf(s0, v.z, acc[2 * k2 + 1]);
            acc[2 * k2 + 1] = fmaf(s1, v.w, acc[2 * k2 + 1]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < B2; ++k) {
    if (k < a.r2) __stcs(a.out + k * a.nnz + j, acc[k]);
  }
}

// Copy the core into this block's shared memory (16-byte cp.async, in
// flight until cp_async_wait_all).
__device__ __forceinline__ void stage_core(const Args& a, uint32_t s_base) {
  const int nq = a.n * a.stride4;
  for (int q = threadIdx.x; q < nq; q += THREADS) {
    cp_async16(s_base + 16u * (uint32_t)q, a.core + q);
  }
}

// The core (r1, n, r2) as rows of quads (module comment; the wrapper's
// chain_schedule gives the stride): every float of `rows`, padding too.
__global__ void __launch_bounds__(THREADS)
pack_rows(const float* __restrict__ core, float* __restrict__ rows, int n,
          int r1, int r2, int stride, int nk2, int first) {
  const int64_t total = (int64_t)n * stride;
  for (int64_t f = (int64_t)blockIdx.x * THREADS + threadIdx.x; f < total;
       f += (int64_t)gridDim.x * THREADS) {
    const int row = (int)(f / stride), c = (int)(f - (int64_t)row * stride);
    float v = 0.f;
    if (first) {
      if (c < r2) v = core[(int64_t)row * r2 + c];
    } else {
      const int quad = c >> 2, i2 = quad / nk2, k2 = quad - i2 * nk2;
      const int i = 2 * i2 + (c & 1), k = 2 * k2 + ((c >> 1) & 1);
      if (i < r1 && k < r2) v = core[((int64_t)i * n + row) * r2 + k];
    }
    rows[f] = v;
  }
}

template <bool FIRST, int B1, int B2, int PLACE>
__global__ void __launch_bounds__(THREADS, min_blocks(FIRST ? 0 : B1, B2))
chain_step_kernel(const Args a) {
  extern __shared__ __align__(16) float4 core_s[];
  const uint32_t s_base = (uint32_t)__cvta_generic_to_shared(core_s);
  if (PLACE == PLACE_BLOCK) stage_core(a, s_base);
  const int64_t j_lo = (int64_t)blockIdx.x * a.share;
  const int64_t j_hi = a.nnz < j_lo + a.share ? a.nnz : j_lo + a.share;
  // the first column loads while the stage copies
  int64_t j = j_lo + threadIdx.x, row;
  float s[B1];
  load_column<FIRST, B1>(a, j, j_hi, row, s);
  if (PLACE == PLACE_BLOCK) {
    cp_async_wait_all();
    __syncthreads();
  }
  for (; j < j_hi; j += THREADS) {
    gather_store<FIRST, B1, B2, PLACE>(a, s_base, j, row, s);
    load_column<FIRST, B1>(a, j + THREADS, j_hi, row, s);
  }
}

// Ranks past the largest bucket: the core through the cache, outputs in
// tiles of GENERIC_TILE sums, the state of state_cols nonzeros staged in
// shared memory (read from device memory once, then once per tile from
// shared memory).
template <bool FIRST>
__global__ void __launch_bounds__(THREADS)
chain_step_generic(const Args a) {
  extern __shared__ float st[];
  const int64_t j_lo = (int64_t)blockIdx.x * a.share;
  const int64_t j_hi = a.nnz < j_lo + a.share ? a.nnz : j_lo + a.share;
  const int W = FIRST ? THREADS : a.state_cols;
  for (int64_t j0 = j_lo; j0 < j_hi; j0 += W) {
    if (!FIRST) {
      __syncthreads();
      for (int e = threadIdx.x; e < a.r1 * W; e += THREADS) {
        const int i = e / W;
        const int64_t jj = j0 + e % W;
        st[e] = jj < j_hi ? __ldcs(a.state + i * a.nnz + jj) : 0.f;
      }
      __syncthreads();
    }
    const int64_t j = j0 + threadIdx.x;
    if (threadIdx.x >= W || j >= j_hi) continue;
    const int64_t row = __ldcs(reinterpret_cast<const long long*>(a.idx) + j);
    const bool inside = row >= 0 && row < a.n;
    const float4* g = a.core + (inside ? row : 0) * a.stride4;
    if (FIRST) {
      for (int q = 0; q < a.nq; ++q) {
        const float4 v = inside ? __ldg(g + q) : make_float4(0, 0, 0, 0);
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (4 * q + e < a.r2) __stcs(a.out + (4 * q + e) * a.nnz + j, vs[e]);
        }
      }
      continue;
    }
    const int ni2 = (a.r1 + 1) >> 1, nk2 = a.nq;
    for (int t2 = 0; t2 < nk2; t2 += GENERIC_TILE / 2) {
      float acc[GENERIC_TILE];
#pragma unroll
      for (int k = 0; k < GENERIC_TILE; ++k) acc[k] = 0.f;
      if (inside) {
        for (int i2 = 0; i2 < ni2; ++i2) {
          const float s0 = st[(2 * i2) * W + threadIdx.x];
          const float s1 =
              2 * i2 + 1 < a.r1 ? st[(2 * i2 + 1) * W + threadIdx.x] : 0.f;
#pragma unroll
          for (int k2 = 0; k2 < GENERIC_TILE / 2; ++k2) {
            if (t2 + k2 < nk2) {
              const float4 v = __ldg(g + i2 * nk2 + t2 + k2);
              acc[2 * k2] = fmaf(s0, v.x, acc[2 * k2]);
              acc[2 * k2] = fmaf(s1, v.y, acc[2 * k2]);
              acc[2 * k2 + 1] = fmaf(s0, v.z, acc[2 * k2 + 1]);
              acc[2 * k2 + 1] = fmaf(s1, v.w, acc[2 * k2 + 1]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < GENERIC_TILE; ++k) {
        const int kk = 2 * t2 + k;
        if (kk < a.r2) __stcs(a.out + kk * a.nnz + j, acc[k]);
      }
    }
  }
}

// Launch a persistent grid of `kernel`: as many blocks as fit on the card
// at once, each with a contiguous share of the nonzeros.
template <class Kernel>
cudaError_t launch(Kernel kernel, Args a, size_t smem, int sms,
                   cudaStream_t stream) {
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t chunks = (a.nnz + THREADS - 1) / THREADS;
  const int64_t blocks =
      (int64_t)per_sm * sms < chunks ? (int64_t)per_sm * sms : chunks;
  const int64_t per = (a.nnz + blocks - 1) / blocks;
  a.share = (per + 31) / 32 * 32;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool FIRST, int B1, int B2>
cudaError_t by_place(const Args& a, int place, size_t smem, int sms,
                     cudaStream_t st) {
  return place == PLACE_BLOCK
             ? launch(chain_step_kernel<FIRST, B1, B2, PLACE_BLOCK>, a, smem,
                      sms, st)
             : launch(chain_step_kernel<FIRST, B1, B2, PLACE_CACHE>, a, 0,
                      sms, st);
}

template <bool FIRST, int B1>
cudaError_t by_r2(const Args& a, int b2, int place, size_t smem, int sms,
                  cudaStream_t st) {
  switch (b2) {
    case 4: return by_place<FIRST, B1, 4>(a, place, smem, sms, st);
    case 8: return by_place<FIRST, B1, 8>(a, place, smem, sms, st);
    case 12: return by_place<FIRST, B1, 12>(a, place, smem, sms, st);
    case 16: return by_place<FIRST, B1, 16>(a, place, smem, sms, st);
    case 32: return by_place<FIRST, B1, 32>(a, place, smem, sms, st);
  }
  return cudaErrorInvalidValue;
}

template <size_t N>
bool in(const int (&list)[N], int v) {
  for (size_t i = 0; i < N; ++i) {
    if (list[i] == v) return true;
  }
  return false;
}

}  // namespace

extern "C" {

// out (r2, nnz) from state (r1, nnz) (NULL: the first step, r1 must be 1),
// the core (r1, n, r2) contiguous, and idx (nnz,) int64; `rows` (n, stride)
// floats is scratch for the core in rows of quads, written here by
// pack_rows before the step reads it.  The launch decisions come from the
// wrapper's chain_schedule: the rank buckets (0 and 0: the generic
// instance), where the core lives (place: 0 each block's shared memory,
// 1 the cache), the dynamic shared memory of a block and, for a generic
// step, the nonzeros whose state a block stages.  Returns the cudaError_t
// of the launches (0 on success).
int tt_chain_step(const float* state, const float* core, float* rows,
                  const int64_t* idx, float* out, int64_t nnz, int n, int r1,
                  int r2, int stride, int r1_bucket, int r2_bucket, int place,
                  int smem_bytes, int state_cols, void* stream) {
  const bool first = state == nullptr;
  const int r1e = (r1 + 1) / 2 * 2, r2e = (r2 + 1) / 2 * 2;
  const int row = first ? (r2 + 3) / 4 * 4 : r1e * r2e;
  const bool generic = r1_bucket == 0 && r2_bucket == 0;
  const size_t smem = (size_t)smem_bytes;
  if (nnz <= 0 || n <= 0 || r1 <= 0 || r2 <= 0 || (first && r1 != 1) ||
      stride % 4 != 0 || stride < row || (int64_t)n * stride > 0x7FFFFFFF ||
      smem_bytes < 0 || (place != PLACE_BLOCK && place != PLACE_CACHE)) {
    return (int)cudaErrorInvalidValue;
  }
  if (generic ? place != PLACE_CACHE ||
                    (!first && (state_cols < 1 || state_cols > THREADS ||
                                smem < (size_t)r1 * state_cols * 4))
              : !in(R2_BUCKETS, r2_bucket) ||
                    (first ? row : r2e) > r2_bucket ||
                    (!first && (!in(R1_BUCKETS, r1_bucket) ||
                                r1e > r1_bucket)) ||
                    (place == PLACE_BLOCK && smem < (size_t)n * stride * 4)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int sms = 0;
  cudaError_t err = tt_runtime::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int64_t quads = ((int64_t)n * stride + THREADS - 1) / THREADS;
  pack_rows<<<(unsigned)(quads < 4 * sms ? quads : 4 * sms), THREADS, 0,
              st>>>(core, rows, n, r1, r2, stride, r2e / 2, first);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  Args a = {};
  a.state = state;
  a.core = reinterpret_cast<const float4*>(rows);
  a.idx = idx;
  a.out = out;
  a.nnz = nnz;
  a.n = n;
  a.r1 = r1;
  a.r2 = r2;
  a.stride4 = stride / 4;
  a.nq = first ? row / 4 : r2e / 2;
  a.state_cols = state_cols;
  if (generic) {
    return (int)(first ? launch(chain_step_generic<true>, a, 0, sms, st)
                       : launch(chain_step_generic<false>, a, smem, sms, st));
  }
  if (first) return (int)by_r2<true, 2>(a, r2_bucket, place, smem, sms, st);
  switch (r1_bucket) {
    case 4: return (int)by_r2<false, 4>(a, r2_bucket, place, smem, sms, st);
    case 8: return (int)by_r2<false, 8>(a, r2_bucket, place, smem, sms, st);
    case 16: return (int)by_r2<false, 16>(a, r2_bucket, place, smem, sms, st);
    default: return (int)by_r2<false, 32>(a, r2_bucket, place, smem, sms, st);
  }
}

}  // extern "C"
