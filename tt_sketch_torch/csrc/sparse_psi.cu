// Fused sparse Ψ / Ω kernels for Hopper: DRM rows (lazy-Gaussian or
// sparse-sign, per side) hashed inside the kernel and contracted against
// the sparse tensor's entries.
//
//   psi_fused_slabs      slab[c, s, a, b] = Σ_{k in chunk c, loc[k] = s}
//                                             L[a,k] e[k] R[b,k]
//   omega_fused          om[g, a, b]      = Σ_{k in block g} Lo[a,k] e[k] R[b,k]
//   psi_omega_merged     both from one pass, R hashed once
//   psi_window_direct    psi[w*span + s, a, b] = Σ_{k in window w, loc[k] = s}
//                                             L[a,k] e[k] R[b,k]
//   psi_chunk_slabs      the slabs of psi_fused_slabs from rows that are
//                        given: L (r1, nnz) and/or R (r2, nnz) float32 in the
//                        plan's sorted order (a sequential sketch's chain
//                        state, a TT-DRM's rows); R may instead be hashed
//                        (psi_chunk_slabs_genright)
//
// A Gaussian side has L[a,k] = sample(lflat[k], lsalts[a]); a sign side
// has L[:,k] = rows [rank_min, rank_min + r) of the sparse-sign column of
// lflat[k] over `rank` slots, from the nnz salts of columns [0, nnz)
// (hash_rng.cuh); a given side has L[a,k] = lrows[a*nnz + k], loaded into
// the same shared tile instead of hashed; likewise for R and Lo.  A missing
// side (Ψ_0 has no left DRM, Ψ_{d-1} no right one) is a single row of ones,
// so the slab is (span, 1, r2) or (span, r1, 1).
//
// Replaces, in tt_sketch_tpu/kernels/pallas_psi.py:
//   _fused_kernel, _fused_kernel_noleft, _fused_kernel_noright
//       (entry psi_fused_slabs)
//   _omega_kernel (entry omega_fused)
//   _merged_kernel, _merged_kernel_noleft (entry psi_omega_merged_slabs)
//   _window_kernel, _window_kernel_oneside (entry psi_window_direct)
//   _slab_kernel, _slab_kernel_noright (entry psi_chunk_slabs)
//   _slab_genright_kernel (entry psi_chunk_slabs_genright)
//   _gen_spec_rows (the per-side dispatch between the two generators)
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
//
// A sign side cannot be hashed one sample per thread-step: its column is
// one shuffle over `rank` slots.  One thread per tile column runs
// sign_column in place on the side's rows in shared memory (T of the 256
// threads per sign side, before they join the Gaussian samples' loop); a
// sliced side (r < rank) allocates `rank` rows and contracts rows
// [rank_min, rank_min + r).
//
// The window kernel is the same block program over another range.  The TPU
// kernel revisits one output block over adjacent grid steps (init on a
// window's first chunk, accumulate after); blocks here run in parallel, so
// one block owns one window: it finds its chunks in the non-decreasing
// chunk_window (binary search, then chunk_first marks the next window),
// zeroes the window's span rows and walks the chunks with the same run
// trick, since loc is non-decreasing over a window's whole run with the
// pads (sentinel span, entry 0) at its end.  A tile that starts on a pad
// ends the walk.  Ψ leaves the kernel finished: no atomics, no combine.
//
// Given sides.  The TPU's psi_chunk_slabs is the same one-hot product with
// the rows read, not hashed; here a given side is a third kind of Side whose
// tile is filled by coalesced loads (thread t reads column k0 + t of a row),
// so psi_chunk_slabs (both sides given, or the left one alone) and
// psi_chunk_slabs_genright (left given, right hashed) are the slab kernel
// itself.  A call with given sides is bound by bytes: (r1 + r2 + 2) * 4 per
// nnz against r1 * r2 FMAs.  Columns past nnz are never read.
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
static_assert(THREADS >= 3 * T,
              "one tile column per thread for up to three sign sides");

// One side's rows: GAUSS is lazy-Gaussian (one row per salt); SIGN a
// sparse-sign column over `rank` slots from `nnz` salts, rows [rank_min,
// rank_min + rows out) contracted; GIVEN rows read from device memory.
enum Kind { GAUSS = 0, SIGN = 1, GIVEN = 2 };

struct Side {
  int kind;
  int rank;
  int nnz;
  int rank_min;
};

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
  Side ls, rs, os;
  const int* win;    // window kernel: window id per chunk, non-decreasing
  const int* first;  // window kernel: 1 on a window's first chunk
  int n_chunks;
  const float* lrows = nullptr;  // a GIVEN left side's rows (r1, nnz)
  const float* rrows = nullptr;  // a GIVEN right side's rows (r2, nnz)
};

// Shared-memory layout: salts [L | R | O], rows L | R | O, then loc.
struct Layout {
  int nsl, nsr, nso;  // salts per side
  int al, ar, ao;     // rows allocated per side
  int gl, gr, go;     // rows hashed sample by sample (Gaussian or ones)
  __host__ __device__ size_t bytes() const {
    return (size_t)(nsl + nsr + nso) * sizeof(uint64_t) +
           (size_t)(al + ar + ao) * TS * sizeof(float) + T * sizeof(int);
  }
};

template <bool HAS_L, bool HAS_R, bool OM>
__host__ __device__ Layout layout(const Args& a) {
  Layout y;
  const bool sl = HAS_L && a.ls.kind == SIGN, sr = HAS_R && a.rs.kind == SIGN;
  const bool so = OM && a.os.kind == SIGN;
  y.nsl = !HAS_L || a.ls.kind == GIVEN ? 0 : sl ? a.ls.nnz : a.r1;
  y.nsr = !HAS_R || a.rs.kind == GIVEN ? 0 : sr ? a.rs.nnz : a.r2;
  y.nso = !OM ? 0 : so ? a.os.nnz : a.r1o;
  y.al = sl ? a.ls.rank : a.r1;
  y.ar = sr ? a.rs.rank : a.r2;
  y.ao = !OM ? 0 : so ? a.os.rank : a.r1o;
  y.gl = sl ? 0 : a.r1;
  y.gr = sr ? 0 : a.r2;
  y.go = so ? 0 : (OM ? a.r1o : 0);
  return y;
}

// One tile column of a sign side, in place on the side's rows; a left side
// carries the entry.
__device__ __forceinline__ void sign_side(float* rows, const uint64_t* flat,
                                          const uint64_t* salts,
                                          const Side& sd, int r_out,
                                          const float* e, int64_t k0, int t,
                                          int tn) {
  if (t >= tn) return;
  float* col = rows + t;
  tt_rng::sign_column(flat[k0 + t], salts, sd.rank, sd.nnz, col, TS);
  if (e) {
    const float ek = e[k0 + t];
    for (int s = sd.rank_min; s < sd.rank_min + r_out; ++s) col[s * TS] *= ek;
  }
}

template <bool HAS_L, bool HAS_R, bool PSI, bool OM, bool WIN>
__global__ void __launch_bounds__(THREADS) sparse_psi_kernel(Args a) {
  extern __shared__ uint64_t smem[];
  const int r1 = a.r1, r2 = a.r2, r1o = OM ? a.r1o : 0;
  const Layout y = layout<HAS_L, HAS_R, OM>(a);
  uint64_t* salts = smem;
  const uint64_t* salts_l = salts;
  const uint64_t* salts_r = salts + y.nsl;
  const uint64_t* salts_o = salts_r + y.nsr;
  const int n_salts = y.nsl + y.nsr + y.nso;
  float* Ls = reinterpret_cast<float*>(salts + n_salts);
  float* Rs = Ls + y.al * TS;
  float* Os = Rs + y.ar * TS;
  int* loc_s = reinterpret_cast<int*>(Os + y.ao * TS);
  // the rows the contraction reads: a sign side's slice starts at rank_min
  const float* Lc = Ls + (y.gl ? 0 : a.ls.rank_min * TS);
  const float* Rc = Rs + (y.gr ? 0 : a.rs.rank_min * TS);
  const float* Oc = Os + (y.go || !OM ? 0 : a.os.rank_min * TS);

  const int tid = threadIdx.x;
  for (int i = tid; i < n_salts; i += THREADS) {
    salts[i] = i < y.nsl ? a.lsalts[i]
             : i < y.nsl + y.nsr ? a.rsalts[i - y.nsl]
                                 : a.osalts[i - y.nsl - y.nsr];
  }
  const int64_t g = blockIdx.x;
  int64_t start = g * a.chunk;
  int64_t end = start + a.chunk;
  if (WIN) {
    // this window's chunks: [first chunk with win >= g, next first chunk)
    int lo = 0, hi = a.n_chunks;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a.win[mid] < (int)g) lo = mid + 1; else hi = mid;
    }
    int c1 = lo;
    if (lo < a.n_chunks && a.win[lo] == (int)g) {
      c1 = lo + 1;
      while (c1 < a.n_chunks && a.first[c1] == 0) ++c1;
    }
    start = (int64_t)lo * a.chunk;
    end = (int64_t)c1 * a.chunk;
  }
  if (end > a.nnz) end = a.nnz;
  if (PSI) {
    float* slab = a.slabs + g * a.span * r1 * r2;
    for (int i = tid; i < a.span * r1 * r2; i += THREADS) slab[i] = 0.f;
  }
  if (OM) {
    float* om = a.om + g * r1o * r2;
    for (int i = tid; i < r1o * r2; i += THREADS) om[i] = 0.f;
  }
  __syncthreads();

  const int n_hashed = y.gl + y.gr + y.go;
  for (int64_t k0 = start; k0 < end; k0 += T) {
    // a window's pads sit at the end of its run: a tile that starts on one
    // holds nothing more (the same address for every thread: no divergence)
    if (WIN && a.loc[k0] >= a.span) break;
    const int tn = (int)(end - k0 < T ? end - k0 : T);
    // 1a. sign sides: one thread per tile column shuffles the column
    {
      const int job = tid / T, t = tid - job * T;
      int q = 0;
      if (HAS_L && a.ls.kind == SIGN) {
        if (job == q) {
          sign_side(Ls, a.lflat, salts_l, a.ls, r1, a.e, k0, t, tn);
        }
        ++q;
      }
      if (HAS_R && a.rs.kind == SIGN) {
        if (job == q) {
          sign_side(Rs, a.rflat, salts_r, a.rs, r2, nullptr, k0, t, tn);
        }
        ++q;
      }
      if (OM && a.os.kind == SIGN) {
        if (job == q) {
          sign_side(Os, a.oflat, salts_o, a.os, r1o, a.e, k0, t, tn);
        }
      }
    }
    // 1b. Gaussian, given (and missing) sides: one sample or one load per
    // thread-step; left rows carry e[k]
    for (int i = tid; i < n_hashed * T; i += THREADS) {
      const int row = i / T, t = i - row * T;
      if (t >= tn) continue;
      const int64_t k = k0 + t;
      if (row < y.gl) {
        const float ek = a.e[k];
        Ls[row * TS + t] =
            !HAS_L ? ek
            : a.ls.kind == GIVEN ? a.lrows[(int64_t)row * a.nnz + k] * ek
                                 : tt_rng::sample(a.lflat[k], salts_l[row]) * ek;
      } else if (row < y.gl + y.gr) {
        const int b = row - y.gl;
        Rs[b * TS + t] =
            !HAS_R ? 1.f
            : a.rs.kind == GIVEN ? a.rrows[(int64_t)b * a.nnz + k]
                                 : tt_rng::sample(a.rflat[k], salts_r[b]);
      } else {
        const int b = row - y.gl - y.gr;
        Os[b * TS + t] = tt_rng::sample(a.oflat[k], salts_o[b]) * a.e[k];
      }
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
        const float* li = Lc + i * TS;
        const float* rj = Rc + j * TS;
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
        const float* oi = Oc + i * TS;
        const float* rj = Rc + j * TS;
        float acc = 0.f;
        for (int t = 0; t < tn; ++t) acc = fmaf(oi[t], rj[t], acc);
        om[el] += acc;
      }
    }
    __syncthreads();
  }
}

bool bad_side(const Side& sd, int r_out) {
  return sd.kind == SIGN &&
         (sd.rank <= 0 || sd.nnz < 0 || sd.nnz > sd.rank || sd.rank_min < 0 ||
          sd.rank_min + r_out > sd.rank);
}

template <bool HAS_L, bool HAS_R, bool PSI, bool OM, bool WIN = false>
cudaError_t launch(const Args& a, int64_t n_blocks, cudaStream_t stream) {
  const size_t bytes = layout<HAS_L, HAS_R, OM>(a).bytes();
  if (bytes > SMEM_LIMIT || n_blocks <= 0 || n_blocks > 0x7FFFFFFF ||
      (HAS_L && bad_side(a.ls, a.r1)) || (HAS_R && bad_side(a.rs, a.r2)) ||
      (OM && bad_side(a.os, a.r1o))) {
    return cudaErrorInvalidValue;
  }
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sparse_psi_kernel<HAS_L, HAS_R, PSI, OM, WIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  sparse_psi_kernel<HAS_L, HAS_R, PSI, OM, WIN>
      <<<(unsigned)n_blocks, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

// A side's generator from the caller's int[4] {SIGN, rank, nnz, rank_min}
// (NULL: lazy-Gaussian).
Side side_of(const int* spec) {
  if (!spec) return Side{GAUSS, 0, 0, 0};
  return Side{spec[0], spec[1], spec[2], spec[3]};
}

bool bad_geometry(int64_t nnz, int n_chunks, int span, int chunk) {
  return nnz <= 0 || n_chunks <= 0 || span <= 0 || chunk <= 0 ||
         (int64_t)n_chunks * chunk < nnz;
}

}  // namespace

extern "C" {

int tt_omega_chunk(void) { return OMEGA_CHUNK; }

// Every entry returns a cudaError_t.  lflat == NULL: no left side (r1 must
// be 1), rflat == NULL: no right side (r2 must be 1).  A spec is NULL for
// a lazy-Gaussian side (r salts) or int[4] {1, rank, nnz, rank_min} for a
// sparse-sign side (nnz salts, r rows from rank_min).

// Ψ slabs (n_chunks, span, r1, r2).
int tt_psi_fused_slabs(const int* loc, const float* e, const uint64_t* lflat,
                       const uint64_t* rflat, const uint64_t* lsalts,
                       const uint64_t* rsalts, float* slabs, int64_t nnz,
                       int n_chunks, int span, int chunk, int r1, int r2,
                       const int* lspec, const int* rspec, void* stream) {
  if (bad_geometry(nnz, n_chunks, span, chunk) || r1 <= 0 || r2 <= 0 ||
      (!lflat && r1 != 1) || (!rflat && r2 != 1) || (!lflat && !rflat)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{loc, e, lflat, rflat, nullptr, lsalts, rsalts, nullptr,
         slabs, nullptr, nnz, chunk, span, r1, r2, 0,
         side_of(lspec), side_of(rspec), side_of(nullptr),
         nullptr, nullptr, n_chunks};
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

// Ψ slabs (n_chunks, span, r1, r2) from given rows: lrows (r1, nnz) or NULL
// (no left side, r1 == 1); the right side is rrows (r2, nnz), or hashed from
// rflat / rsalts / rspec (rrows NULL), or missing (both NULL, r2 == 1).
int tt_psi_chunk_slabs(const int* loc, const float* e, const float* lrows,
                       const float* rrows, const uint64_t* rflat,
                       const uint64_t* rsalts, float* slabs, int64_t nnz,
                       int n_chunks, int span, int chunk, int r1, int r2,
                       const int* rspec, void* stream) {
  const bool has_r = rrows || rflat;
  if (bad_geometry(nnz, n_chunks, span, chunk) || r1 <= 0 || r2 <= 0 ||
      (!lrows && r1 != 1) || (!has_r && r2 != 1) || (!lrows && !has_r) ||
      (rrows && rflat) || (rflat && !rsalts)) {
    return (int)cudaErrorInvalidValue;
  }
  const Side given{GIVEN, 0, 0, 0};
  Args a{loc, e, nullptr, rflat, nullptr, nullptr, rsalts, nullptr,
         slabs, nullptr, nnz, chunk, span, r1, r2, 0,
         given, rrows ? given : side_of(rspec), side_of(nullptr),
         nullptr, nullptr, n_chunks, lrows, rrows};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (lrows && has_r) {
    err = launch<true, true, true, false>(a, n_chunks, st);
  } else if (has_r) {
    err = launch<false, true, true, false>(a, n_chunks, st);
  } else {
    err = launch<true, false, true, false>(a, n_chunks, st);
  }
  return (int)err;
}

// Finished Ψ rows (n_windows * span, r1, r2) of an aligned-window plan: the
// streams are padded per window to n_chunks * chunk slots (pads: loc ==
// span, e == 0), win (n_chunks,) is the non-decreasing window id per chunk
// and first (n_chunks,) is 1 on a window's first chunk.
int tt_psi_window_direct(const int* win, const int* first, const int* loc,
                         const float* e, const uint64_t* lflat,
                         const uint64_t* rflat, const uint64_t* lsalts,
                         const uint64_t* rsalts, float* psi, int n_chunks,
                         int span, int chunk, int n_windows, int r1, int r2,
                         const int* lspec, const int* rspec, void* stream) {
  if (n_chunks <= 0 || span <= 0 || chunk <= 0 || n_windows <= 0 ||
      r1 <= 0 || r2 <= 0 || !win || !first || (!lflat && r1 != 1) ||
      (!rflat && r2 != 1) || (!lflat && !rflat)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{loc, e, lflat, rflat, nullptr, lsalts, rsalts, nullptr,
         psi, nullptr, (int64_t)n_chunks * chunk, chunk, span, r1, r2, 0,
         side_of(lspec), side_of(rspec), side_of(nullptr),
         win, first, n_chunks};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (lflat && rflat) {
    err = launch<true, true, true, false, true>(a, n_windows, st);
  } else if (rflat) {
    err = launch<false, true, true, false, true>(a, n_windows, st);
  } else {
    err = launch<true, false, true, false, true>(a, n_windows, st);
  }
  return (int)err;
}

// Ω partials (ceil(nnz / OMEGA_CHUNK), r1, r2) in nnz order.
int tt_omega_fused(const float* e, const uint64_t* lflat,
                   const uint64_t* rflat, const uint64_t* lsalts,
                   const uint64_t* rsalts, float* om_part, int64_t nnz,
                   int r1, int r2, const int* lspec, const int* rspec,
                   void* stream) {
  if (nnz <= 0 || r1 <= 0 || r2 <= 0) return (int)cudaErrorInvalidValue;
  Args a{nullptr, e, nullptr, rflat, lflat, nullptr, rsalts, lsalts,
         nullptr, om_part, nnz, OMEGA_CHUNK, 1, 1, r2, r1,
         side_of(nullptr), side_of(rspec), side_of(lspec),
         nullptr, nullptr, 0};
  const int64_t n_blocks = (nnz + OMEGA_CHUNK - 1) / OMEGA_CHUNK;
  return (int)launch<false, true, false, true>(
      a, n_blocks, reinterpret_cast<cudaStream_t>(stream));
}

// Ψ slabs (n_chunks, span, r1, r2) and Ω partials (n_chunks, r1o, r2) in one
// pass.
int tt_psi_omega_merged(const int* loc, const float* e, const uint64_t* lflat,
                        const uint64_t* rflat, const uint64_t* oflat,
                        const uint64_t* lsalts, const uint64_t* rsalts,
                        const uint64_t* osalts, float* slabs, float* om_part,
                        int64_t nnz, int n_chunks, int span, int chunk,
                        int r1, int r2, int r1o, const int* lspec,
                        const int* rspec, const int* ospec, void* stream) {
  if (bad_geometry(nnz, n_chunks, span, chunk) || r1 <= 0 || r2 <= 0 ||
      r1o <= 0 || !rflat || !oflat || (!lflat && r1 != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{loc, e, lflat, rflat, oflat, lsalts, rsalts, osalts,
         slabs, om_part, nnz, chunk, span, r1, r2, r1o,
         side_of(lspec), side_of(rspec), side_of(ospec),
         nullptr, nullptr, n_chunks};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = lflat ? launch<true, true, true, true>(a, n_chunks, st)
                          : launch<false, true, true, true>(a, n_chunks, st);
  return (int)err;
}

const char* tt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
