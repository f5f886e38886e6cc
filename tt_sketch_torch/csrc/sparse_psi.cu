// Fused sparse Ψ / Ω kernels for Hopper: lazy-Gaussian DRM rows hashed
// inside the kernel and contracted against the sparse tensor's entries.
//
//   psi_fused_slabs      slab[c, s, a, b] = Σ_{k in chunk c, loc[k] = s}
//                                             L[a,k] e[k] R[b,k]
//   omega_fused          om[g, a, b]      = Σ_{k in block g} Lo[a,k] e[k] R[b,k]
//   psi_omega_merged     both from one pass, R hashed once
//
// L[a,k] = sample(lflat[k], lsalts[a]) and likewise for R and Lo
// (hash_rng.cuh).  A missing side (Ψ_0 has no left DRM, Ψ_{d-1} no right
// one) is a single row of ones, so the slab is (span, 1, r2) or
// (span, r1, 1).
//
// Replaces, in tt_sketch_tpu/kernels/pallas_psi.py:
//   _fused_kernel, _fused_kernel_noleft, _fused_kernel_noright
//       (entry psi_fused_slabs)
//   _omega_kernel (entry omega_fused)
//   _merged_kernel, _merged_kernel_noleft (entry psi_omega_merged_slabs)
// Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded by tt_sketch_torch/kernels/sparse_psi.py through ctypes.
//
// What bounds it.  Per nnz the kernels read 8 bytes per flat index stream,
// 4 for the entry and 4 for the local row, and hash (r1 + r2 [+ r1o])
// samples at about 96 instructions each (the count chip_smoke.py takes from
// the lazy_gaussian kernel's SASS, which runs the same generator), then
// spend r1*r2 [+ r1o*r2] FMAs on the contraction.  At FROSTT-uber's mode 2
// (ranks 10/20, merged) that is 40 samples = ~3840 instructions plus 400
// FMAs for 32 bytes: ~130 instructions per byte against the CUDA cores'
// ridge of 33.5e12 / 3.35e12 = 10.  The kernels are bound by operations,
// and the hash and erfinv are ~90 % of them.
//
// What the design does about it.  One block per chunk of the mode-sorted
// nnz stream (per plan chunk for Ψ; per OMEGA_CHUNK nnz for Ω).  The block
// walks its chunk in tiles of T nnz: all threads hash the tile's rows into
// shared memory (every sample is hashed exactly once per kernel, R once
// for both Ψ and Ω in the merged kernel), the entry weighting is folded
// into the left rows, then each thread owns output elements (a, b) and
// sums over the tile.  loc is non-decreasing inside a chunk, so the rows
// s of a slab are contiguous runs: a thread adds its running sum into
// slab[s] only when s changes (r1*r2 FMAs per nnz, not span times that as
// the TPU's one-hot product).  The padding sentinel loc == span is never
// written.  Every output element belongs to one thread of one block and is
// written without atomics: the slabs and the per-block Ω partials are
// deterministic, and the wrapper sums the Ω partials in a fixed order.
// Making it fast (sharing samples across warps, wider per-thread tiles,
// persistent blocks) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_rng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int T = 64;       // nnz per tile
constexpr int TS = T + 1;   // padded row stride in shared memory
constexpr int OMEGA_CHUNK = 4096;
constexpr size_t SMEM_LIMIT = 232448;  // opt-in shared memory per block

struct Args {
  const int* loc;
  const float* e;
  const uint64_t* lflat;
  const uint64_t* rflat;
  const uint64_t* oflat;
  const uint64_t* lsalts;
  const uint64_t* rsalts;
  const uint64_t* osalts;
  float* slabs;  // (n_chunks, span, r1, r2)
  float* om;     // (n_blocks, r1o, r2)
  int64_t nnz;
  int chunk;
  int span;
  int r1;   // rows of the Ψ left side (1 when absent)
  int r2;   // rows of the right side (1 when absent)
  int r1o;  // rows of Ω's left side (0 without Ω)
};

template <bool HAS_L, bool HAS_R, bool PSI, bool OM>
size_t smem_bytes(int r1, int r2, int r1o) {
  const int n_salts = (HAS_L ? r1 : 0) + (HAS_R ? r2 : 0) + (OM ? r1o : 0);
  const int n_rows = r1 + r2 + (OM ? r1o : 0);
  return n_salts * sizeof(uint64_t) + (size_t)n_rows * TS * sizeof(float) +
         T * sizeof(int);
}

template <bool HAS_L, bool HAS_R, bool PSI, bool OM>
__global__ void __launch_bounds__(THREADS) sparse_psi_kernel(Args a) {
  extern __shared__ uint64_t smem[];
  const int r1 = a.r1, r2 = a.r2, r1o = OM ? a.r1o : 0;
  // salts: [L | R | O], then rows: L (r1) | R (r2) | O (r1o), then loc
  uint64_t* salts = smem;
  const int nl = HAS_L ? r1 : 0, nr = HAS_R ? r2 : 0;
  const int n_salts = nl + nr + r1o;
  float* rows = reinterpret_cast<float*>(salts + n_salts);
  float* Ls = rows;
  float* Rs = Ls + r1 * TS;
  float* Os = Rs + r2 * TS;
  int* loc_s = reinterpret_cast<int*>(Os + r1o * TS);

  const int tid = threadIdx.x;
  for (int i = tid; i < n_salts; i += THREADS) {
    salts[i] = i < nl ? a.lsalts[i]
             : i < nl + nr ? a.rsalts[i - nl] : a.osalts[i - nl - nr];
  }
  const int64_t g = blockIdx.x;
  if (PSI) {
    float* slab = a.slabs + g * a.span * r1 * r2;
    for (int i = tid; i < a.span * r1 * r2; i += THREADS) slab[i] = 0.f;
  }
  if (OM) {
    float* om = a.om + g * r1o * r2;
    for (int i = tid; i < r1o * r2; i += THREADS) om[i] = 0.f;
  }
  __syncthreads();

  const int64_t start = g * a.chunk;
  int64_t end = start + a.chunk;
  if (end > a.nnz) end = a.nnz;
  const int n_rows = r1 + r2 + r1o;
  for (int64_t k0 = start; k0 < end; k0 += T) {
    const int tn = (int)(end - k0 < T ? end - k0 : T);
    // 1. hash the tile's rows into shared memory; left rows carry e[k]
    for (int i = tid; i < n_rows * T; i += THREADS) {
      const int row = i / T, t = i - row * T;
      float v = 0.f;
      if (t < tn) {
        const int64_t k = k0 + t;
        if (row < r1) {
          const float ek = a.e[k];
          v = HAS_L ? tt_rng::sample(a.lflat[k], salts[row]) * ek : ek;
        } else if (row < r1 + r2) {
          v = HAS_R ? tt_rng::sample(a.rflat[k], salts[nl + row - r1])
                    : 1.f;
        } else {
          v = tt_rng::sample(a.oflat[k], salts[nl + nr + row - r1 - r2]) *
              a.e[k];
        }
      }
      rows[row * TS + t] = v;
    }
    if (PSI) {
      for (int t = tid; t < T; t += THREADS) {
        loc_s[t] = t < tn ? a.loc[k0 + t] : a.span;
      }
    }
    __syncthreads();

    // 2. contract: each thread owns output elements (i, j)
    if (PSI) {
      float* slab = a.slabs + g * a.span * r1 * r2;
      for (int el = tid; el < r1 * r2; el += THREADS) {
        const int i = el / r2, j = el - i * r2;
        const float* li = Ls + i * TS;
        const float* rj = Rs + j * TS;
        int s = loc_s[0];
        float acc = 0.f;
        for (int t = 0; t < tn; ++t) {
          const int st = loc_s[t];  // the same for every thread: no divergence
          if (st != s) {
            if (s >= 0 && s < a.span) slab[(s * r1 + i) * r2 + j] += acc;
            acc = 0.f;
            s = st;
          }
          acc = fmaf(li[t], rj[t], acc);
        }
        if (s >= 0 && s < a.span) slab[(s * r1 + i) * r2 + j] += acc;
      }
    }
    if (OM) {
      float* om = a.om + g * r1o * r2;
      for (int el = tid; el < r1o * r2; el += THREADS) {
        const int i = el / r2, j = el - i * r2;
        const float* oi = Os + i * TS;
        const float* rj = Rs + j * TS;
        float acc = 0.f;
        for (int t = 0; t < tn; ++t) acc = fmaf(oi[t], rj[t], acc);
        om[el] += acc;
      }
    }
    __syncthreads();
  }
}

template <bool HAS_L, bool HAS_R, bool PSI, bool OM>
cudaError_t launch(const Args& a, int64_t n_blocks, cudaStream_t stream) {
  const size_t bytes = smem_bytes<HAS_L, HAS_R, PSI, OM>(a.r1, a.r2, a.r1o);
  if (bytes > SMEM_LIMIT || n_blocks <= 0 || n_blocks > 0x7FFFFFFF) {
    return cudaErrorInvalidValue;
  }
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sparse_psi_kernel<HAS_L, HAS_R, PSI, OM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  sparse_psi_kernel<HAS_L, HAS_R, PSI, OM>
      <<<(unsigned)n_blocks, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

bool bad_geometry(int64_t nnz, int n_chunks, int span, int chunk) {
  return nnz <= 0 || n_chunks <= 0 || span <= 0 || chunk <= 0 ||
         (int64_t)n_chunks * chunk < nnz;
}

}  // namespace

extern "C" {

int tt_sparse_psi_tile(void) { return T; }

int tt_omega_chunk(void) { return OMEGA_CHUNK; }

int tt_sparse_psi_smem_limit(void) { return (int)SMEM_LIMIT; }

// Ψ slabs (n_chunks, span, r1, r2); lflat == NULL: no left side (r1 must be
// 1), rflat == NULL: no right side (r2 must be 1).  Returns a cudaError_t.
int tt_psi_fused_slabs(const int* loc, const float* e, const uint64_t* lflat,
                       const uint64_t* rflat, const uint64_t* lsalts,
                       const uint64_t* rsalts, float* slabs, int64_t nnz,
                       int n_chunks, int span, int chunk, int r1, int r2,
                       void* stream) {
  if (bad_geometry(nnz, n_chunks, span, chunk) || r1 <= 0 || r2 <= 0 ||
      (!lflat && r1 != 1) || (!rflat && r2 != 1) || (!lflat && !rflat)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{loc, e, lflat, rflat, nullptr, lsalts, rsalts, nullptr,
         slabs, nullptr, nnz, chunk, span, r1, r2, 0};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (lflat && rflat) {
    err = launch<true, true, true, false>(a, n_chunks, st);
  } else if (rflat) {
    err = launch<false, true, true, false>(a, n_chunks, st);
  } else {
    err = launch<true, false, true, false>(a, n_chunks, st);
  }
  return (int)err;
}

// Ω partials (ceil(nnz / OMEGA_CHUNK), r1, r2) in nnz order.
int tt_omega_fused(const float* e, const uint64_t* lflat,
                   const uint64_t* rflat, const uint64_t* lsalts,
                   const uint64_t* rsalts, float* om_part, int64_t nnz,
                   int r1, int r2, void* stream) {
  if (nnz <= 0 || r1 <= 0 || r2 <= 0) return (int)cudaErrorInvalidValue;
  Args a{nullptr, e, nullptr, rflat, lflat, nullptr, rsalts, lsalts,
         nullptr, om_part, nnz, OMEGA_CHUNK, 1, 1, r2, r1};
  const int64_t n_blocks = (nnz + OMEGA_CHUNK - 1) / OMEGA_CHUNK;
  return (int)launch<false, true, false, true>(
      a, n_blocks, reinterpret_cast<cudaStream_t>(stream));
}

// Ψ slabs (n_chunks, span, r1, r2) and Ω partials (n_chunks, r1o, r2) in one
// pass; lflat == NULL: Ψ has no left side (r1 must be 1).
int tt_psi_omega_merged(const int* loc, const float* e, const uint64_t* lflat,
                        const uint64_t* rflat, const uint64_t* oflat,
                        const uint64_t* lsalts, const uint64_t* rsalts,
                        const uint64_t* osalts, float* slabs, float* om_part,
                        int64_t nnz, int n_chunks, int span, int chunk,
                        int r1, int r2, int r1o, void* stream) {
  if (bad_geometry(nnz, n_chunks, span, chunk) || r1 <= 0 || r2 <= 0 ||
      r1o <= 0 || !rflat || !oflat || (!lflat && r1 != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{loc, e, lflat, rflat, oflat, lsalts, rsalts, osalts,
         slabs, om_part, nnz, chunk, span, r1, r2, r1o};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = lflat ? launch<true, true, true, true>(a, n_chunks, st)
                          : launch<false, true, true, true>(a, n_chunks, st);
  return (int)err;
}

const char* tt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
