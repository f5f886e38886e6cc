// Both bisect projections of the dense sketch in one pass over X, for Hopper.
//
//   T = X @ R      X (P, S), R (S, rho)  ->  T (P, rho)
//   U = L^T @ X    L (P, r)              ->  U (r, S)
//
// Replaces tt_sketch_tpu/kernels/pallas_project.py:_dual_project_kernel
// (entry dual_project).  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with a plain C interface, loaded by
// tt_sketch_torch/kernels/dual_project.py through ctypes.
//
// What bounds it.  Per element of X the kernel does 2*(r + rho) flops and
// reads 4 bytes.  At the main-path shape (r = 32, rho = 64) that is 48
// flop/byte; the H100's fp32 CUDA-core ridge is 67 TFLOP/s over 3.35 TB/s,
// about 20 flop/byte.  In plain FP32 the kernel is therefore bound by
// operations (1.54 ms for one 2.15 GB slab against 0.64 ms for its bytes),
// not by memory.  Only TF32 or bf16 tensor cores would make it memory-bound.
//
// What the design does about it.  X is read from device memory exactly once
// (streaming loads, so the small R, L and T stay in L2), and every element
// fetched into shared memory feeds both products.  The inner loops are
// register-tiled (4x4 outputs per thread, float4 shared-memory reads) so
// the FMA pipes, not shared memory, are the limit.  Nothing is pipelined
// asynchronously yet: wgmma/TF32, TMA and a persistent schedule are later
// work.
//
// Schedule.  The TPU kernel relied on a sequential grid to keep U resident
// across its inner sweep.  Here blocks run in parallel, so each block owns
// RB = 128 consecutive rows of X and walks all of S in column tiles of BN:
//   - T rows of the block accumulate in registers over the whole walk and
//     are written once; no reduction is needed for T.
//   - U for the current column tile accumulates in registers over the
//     block's rows and is written as a per-block partial Upart[g] (r, S).
//     A second kernel sums the partials over the blocks in a fixed order.
// Both outputs are therefore deterministic: the same inputs give the same
// bits on every run.
//
// Ranks: one launch takes r <= 32 and rho <= 64 (zero-padded below that);
// the wrapper splits larger ranks into several launches.  Ragged P and S
// are masked: any shape is taken.  BF16 rounds X, R and L to bfloat16 as
// they enter shared memory and accumulates in fp32, like the TPU kernel's
// mxu_dtype=bfloat16.
//
// The projector diagnostics (tt_sketch_torch/kernels/projector_diag.py)
// live here too, so that they measure this kernel's own design:
//   - tt_t_only and tt_u_only launch the same kernel with only its T half
//     (WANT_U = false) or only its U half (WANT_T = false): the same tile,
//     block, bf16 rounding, U partials and rank limits.  They replace
//     scripts/bench_projector_diag.py:t_only and :u_only.  T alone does
//     2*rho flops per 4-byte element (32 flop/byte at rho = 64: bound by
//     operations, 1.03 ms per slab); U alone 2*r (16 flop/byte at r = 32:
//     bound by bytes, 0.64 ms).
//   - tt_reduce_read is a read-once pass that writes the row sums of X, and
//     replaces scripts/bench_projector_diag.py:reduce_read.  It is bound by
//     bytes (0.64 ms per slab) and its time is the card's read floor for X.
//     One block per row, 16-byte streaming loads, four in flight per
//     thread, sums in a fixed order (deterministic).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;              // rows of X per tile
constexpr int BN = 128;             // columns of X per tile
constexpr int ROW_TILES = 2;        // row tiles owned by a block
constexpr int RB = BM * ROW_TILES;  // rows of X owned by a block
constexpr int R_MAX = 32;           // columns of L per launch
constexpr int RHO_MAX = 64;         // columns of R per launch
constexpr int THREADS = 256;
constexpr int XS_LD = BN + 4;       // padded row stride of the X tile
constexpr int SMEM_FLOATS = BM * XS_LD + BN * RHO_MAX + RB * R_MAX;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

template <bool BF16>
__device__ __forceinline__ float4 operand4(float4 v) {
  return make_float4(operand<BF16>(v.x), operand<BF16>(v.y),
                     operand<BF16>(v.z), operand<BF16>(v.w));
}

__device__ __forceinline__ void unpack(const float4 v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// One tile of X: rows [row_base, row_base + BM), columns [col0, col0 + BN),
// zero outside (P, S).
template <bool BF16>
__device__ __forceinline__ void load_x_tile(float* Xs, const float* X, int P,
                                            int S, int row_base, int col0,
                                            bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    // S % 4 == 0 and X 16-byte aligned: s < S implies s + 3 < S.
    for (int idx = tid; idx < BM * (BN / 4); idx += THREADS) {
      const int i = idx / (BN / 4);
      const int c = (idx % (BN / 4)) * 4;
      const int row = row_base + i;
      const int s = col0 + c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < P && s < S) {
        v = __ldcs(reinterpret_cast<const float4*>(X + (size_t)row * S + s));
      }
      *reinterpret_cast<float4*>(&Xs[i * XS_LD + c]) = operand4<BF16>(v);
    }
  } else {
    for (int idx = tid; idx < BM * BN; idx += THREADS) {
      const int i = idx / BN;
      const int c = idx % BN;
      const int row = row_base + i;
      const int s = col0 + c;
      Xs[i * XS_LD + c] =
          (row < P && s < S) ? operand<BF16>(__ldcs(X + (size_t)row * S + s))
                             : 0.f;
    }
  }
}

// WANT_T / WANT_U select the halves; dual_project launches both.
template <bool BF16, bool WANT_T, bool WANT_U>
__global__ void __launch_bounds__(THREADS, 2)
dual_project_kernel(const float* __restrict__ X, const float* __restrict__ R,
                    const float* __restrict__ L, float* __restrict__ T,
                    float* __restrict__ Upart, int P, int S, int r, int rho,
                    int s_pad, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;                // [BM][XS_LD]
  float* Rs = Xs + BM * XS_LD;     // [BN][RHO_MAX]
  float* Ls = Rs + BN * RHO_MAX;   // [RB][R_MAX]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * RB;

  // The block's rows of L, once; zero beyond P and r.
  if constexpr (WANT_U) {
    for (int idx = tid; idx < RB * R_MAX; idx += THREADS) {
      const int i = idx / R_MAX;
      const int k = idx % R_MAX;
      const int row = row0 + i;
      Ls[idx] = (row < P && k < r) ? operand<BF16>(L[(size_t)row * r + k]) : 0.f;
    }
  }

  // U: this thread owns L-columns [ur, ur+4) and tile columns [uc, uc+4).
  const int ur = (tid / 32) * 4;
  const int uc = (tid % 32) * 4;
  // T: this thread owns tile rows [tr, tr+4) and R-columns [tc, tc+4).
  const int tr = (tid / 16) * 4;
  const int tc = (tid % 16) * 4;

  float tacc[ROW_TILES][4][4];
#pragma unroll
  for (int it = 0; it < ROW_TILES; ++it)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) tacc[it][m][c] = 0.f;

  const int n_col_tiles = (S + BN - 1) / BN;
  for (int jt = 0; jt < n_col_tiles; ++jt) {
    const int col0 = jt * BN;
    __syncthreads();  // every read of the previous Rs and Xs is done
    if constexpr (WANT_T) {
      for (int idx = tid; idx < BN * RHO_MAX; idx += THREADS) {
        const int k = idx / RHO_MAX;
        const int c = idx % RHO_MAX;
        const int s = col0 + k;
        Rs[idx] = (s < S && c < rho) ? operand<BF16>(R[(size_t)s * rho + c])
                                     : 0.f;
      }
    }

    float uacc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) uacc[a][b] = 0.f;

#pragma unroll
    for (int it = 0; it < ROW_TILES; ++it) {
      if (it > 0) __syncthreads();  // every read of the previous Xs is done
      load_x_tile<BF16>(Xs, X, P, S, row0 + it * BM, col0, vec);
      __syncthreads();

      // U[:, tile] += L[tile rows]^T @ X_tile
      if constexpr (WANT_U) {
#pragma unroll 4
        for (int k = 0; k < BM; ++k) {
          float a[4], b[4];
          unpack(*reinterpret_cast<const float4*>(&Ls[(it * BM + k) * R_MAX + ur]), a);
          unpack(*reinterpret_cast<const float4*>(&Xs[k * XS_LD + uc]), b);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) uacc[i][j] = fmaf(a[i], b[j], uacc[i][j]);
        }
      }

      // T[tile rows] += X_tile @ R[tile columns]
      if constexpr (WANT_T) {
#pragma unroll 2
        for (int k = 0; k < BN; k += 4) {
          float x[4][4], w[4][4];
#pragma unroll
          for (int m = 0; m < 4; ++m)
            unpack(*reinterpret_cast<const float4*>(&Xs[(tr + m) * XS_LD + k]), x[m]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            unpack(*reinterpret_cast<const float4*>(&Rs[(k + q) * RHO_MAX + tc]), w[q]);
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                tacc[it][m][c] = fmaf(x[m][q], w[q][c], tacc[it][m][c]);
        }
      }
    }

    // This block's partial of U for the column tile; s_pad is a multiple of
    // BN, so the float4 stores stay in bounds and aligned.
    if constexpr (WANT_U) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (ur + a < r) {
          float* dst = Upart + ((size_t)blockIdx.x * r + ur + a) * s_pad + col0 + uc;
          *reinterpret_cast<float4*>(dst) =
              make_float4(uacc[a][0], uacc[a][1], uacc[a][2], uacc[a][3]);
        }
      }
    }
  }

  if constexpr (WANT_T) {
#pragma unroll
    for (int it = 0; it < ROW_TILES; ++it) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int row = row0 + it * BM + tr + m;
        if (row < P) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (tc + c < rho) T[(size_t)row * rho + tc + c] = tacc[it][m][c];
          }
        }
      }
    }
  }
}

// U[k, s] = sum over blocks g, in order, of Upart[g, k, s].
__global__ void reduce_u_kernel(const float* __restrict__ Upart,
                                float* __restrict__ U, int G, int r, int S,
                                int s_pad) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)r * S) return;
  const int k = (int)(idx / S);
  const int s = (int)(idx % S);
  float acc = 0.f;
  for (int g = 0; g < G; ++g) acc += Upart[((size_t)g * r + k) * s_pad + s];
  U[idx] = acc;
}

// Row sums of X, one block per row; vec: S % 4 == 0 and X 16-byte aligned,
// so every row starts 16-byte aligned.
constexpr int READ_THREADS = 256;
constexpr int READ_UNROLL = 4;

__global__ void __launch_bounds__(READ_THREADS)
reduce_read_kernel(const float* __restrict__ X, float* __restrict__ out, int S,
                   bool vec) {
  const float* x = X + (size_t)blockIdx.x * S;
  float acc[READ_UNROLL] = {0.f, 0.f, 0.f, 0.f};
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int n4 = S / 4;
    int i = threadIdx.x;
    for (; i + (READ_UNROLL - 1) * READ_THREADS < n4;
         i += READ_UNROLL * READ_THREADS) {
      float4 v[READ_UNROLL];
#pragma unroll
      for (int u = 0; u < READ_UNROLL; ++u) v[u] = __ldcs(x4 + i + u * READ_THREADS);
#pragma unroll
      for (int u = 0; u < READ_UNROLL; ++u)
        acc[u] += (v[u].x + v[u].y) + (v[u].z + v[u].w);
    }
    for (; i < n4; i += READ_THREADS) {
      const float4 v = __ldcs(x4 + i);
      acc[0] += (v.x + v.y) + (v.z + v.w);
    }
  } else {
    for (int i = threadIdx.x; i < S; i += READ_THREADS) acc[0] += __ldcs(x + i);
  }
  float s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  __shared__ float warp_sums[READ_THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < READ_THREADS / 32; ++w) t += warp_sums[w];
    out[blockIdx.x] = t;
  }
}

template <bool BF16, bool WANT_T, bool WANT_U>
cudaError_t launch(const float* X, const float* R, const float* L, float* T,
                   float* U, float* Upart, int P, int S, int r, int rho,
                   cudaStream_t stream) {
  const int G = (P + RB - 1) / RB;
  const int s_pad = ((S + BN - 1) / BN) * BN;
  const bool vec = (S % 4 == 0) && (reinterpret_cast<uintptr_t>(X) % 16 == 0);
  cudaError_t err = cudaFuncSetAttribute(
      dual_project_kernel<BF16, WANT_T, WANT_U>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dual_project_kernel<BF16, WANT_T, WANT_U><<<G, THREADS, SMEM_BYTES, stream>>>(
      X, R, L, T, Upart, P, S, r, rho, s_pad, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || !WANT_U || r == 0) return err;
  const size_t n = (size_t)r * S;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  reduce_u_kernel<<<blocks, threads, 0, stream>>>(Upart, U, G, r, S, s_pad);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tiling constants the wrapper needs to size Upart (G, r, s_pad) with
// G = ceil(P / row_block) and s_pad = ceil(S / col_tile) * col_tile.
int tt_dual_project_row_block(void) { return RB; }
int tt_dual_project_col_tile(void) { return BN; }
int tt_dual_project_max_r(void) { return R_MAX; }
int tt_dual_project_max_rho(void) { return RHO_MAX; }

// Returns the cudaError_t of the launches (0 on success).
int tt_dual_project(const float* X, const float* R, const float* L, float* T,
                    float* U, float* Upart, int P, int S, int r, int rho,
                    int bf16, void* stream) {
  if (P <= 0 || S <= 0 || r < 0 || r > R_MAX || rho < 0 || rho > RHO_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch<true, true, true>(X, R, L, T, U, Upart, P, S, r, rho, st)
           : launch<false, true, true>(X, R, L, T, U, Upart, P, S, r, rho, st);
  return (int)err;
}

// T = X @ R alone: dual_project's kernel without its U half.
int tt_t_only(const float* X, const float* R, float* T, int P, int S, int rho,
              int bf16, void* stream) {
  if (P <= 0 || S <= 0 || rho < 0 || rho > RHO_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch<true, true, false>(X, R, nullptr, T, nullptr, nullptr, P,
                                       S, 0, rho, st)
           : launch<false, true, false>(X, R, nullptr, T, nullptr, nullptr, P,
                                        S, 0, rho, st);
  return (int)err;
}

// U = L^T @ X alone: dual_project's kernel without its T half; Upart as for
// tt_dual_project.
int tt_u_only(const float* X, const float* L, float* U, float* Upart, int P,
              int S, int r, int bf16, void* stream) {
  if (P <= 0 || S <= 0 || r < 0 || r > R_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch<true, false, true>(X, nullptr, L, nullptr, U, Upart, P, S,
                                       r, 0, st)
           : launch<false, false, true>(X, nullptr, L, nullptr, U, Upart, P,
                                        S, r, 0, st);
  return (int)err;
}

// out[i] = sum over s of X[i, s], for i < P.
int tt_reduce_read(const float* X, float* out, int P, int S, void* stream) {
  if (P <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = (S % 4 == 0) && (reinterpret_cast<uintptr_t>(X) % 16 == 0);
  reduce_read_kernel<<<P, READ_THREADS, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(X, out, S, vec);
  return (int)cudaGetLastError();
}

const char* tt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
