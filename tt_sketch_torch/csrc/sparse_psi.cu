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
// (hash_rng.cuh); a given side has L[a,k] = lrows[a*nnz + k], staged in
// shared memory instead of hashed; likewise for R and Lo.  A missing side
// (Ψ_0 has no left DRM, Ψ_{d-1} no right one) is a single row of ones, so
// the slab is (span, 1, r2) or (span, r1, 1).
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
// and the hash and erfinv are ~90 % of them.  A sign side's column is one
// thread's serial shuffle (hash_rng.cuh), so sign calls wait on its
// latency: there the blocks an SM holds set the pace.
//
// The block program.  One block per chunk of the mode-sorted nnz stream
// (per plan chunk for Ψ; per OMEGA_CHUNK nnz for Ω; per window for the
// window kernel).  Its range splits into G contiguous parts, one per
// group of threads (G up to GMAX, as many as the micro-tiles allow).
// Each tile, all threads first generate W = G*TG columns into shared
// memory, TG of each part: every sample is hashed once per kernel (R once
// for Ψ and Ω in the merged kernel), a column's flat indices and entry
// are loaded once per side, the entry is folded into the left rows, and a
// column past its part is zero.  After a barrier each group contracts its
// own TG columns.
//
// Micro-tiles.  A thread owns MJ = 4 outputs: rows a0 + c*NA of side A (the
// right side; the left side for a Ψ whose right side has fewer than 4
// rows) against one row b of side B.  In the merged kernel the same A rows
// serve Ψ (B = the left side) and Ω (B = Ω's left side): each R value is
// read once for both.  Reads are 16 bytes along the nnz: per 4 columns a
// thread loads 4 A quads, its B quad, its Ω-left quad and the 4 locs, 7
// LDS.128 for 32 FMAs (0.22 per FMA; Ω alone 5 for 16, 0.31; Ψ alone 6
// for 16, 0.38), against 2 scalar loads per FMA before.  A run that ends
// inside 4 columns reloads those A values one by one.
//
// Row stride.  Rows are TS floats apart, TS one of STRIDES = 252, 172,
// 124, 84, 60 (63, 43, 31, 21, 15 quads): an odd number of 16-byte quads
// puts eight consecutive rows in eight different bank quads, so the
// quarter-warp phases of an LDS.128 (lanes of one group read consecutive A
// rows at one column) are free of conflicts, and a column of a sign side
// or of the generator loops is 32 consecutive words.  The launch code
// takes the widest stride whose layout fits and whose sign columns the
// block's threads can take (below).
//
// Where each output is stored.  loc is non-decreasing inside a plan chunk
// and over a window's whole run, pads last (the plans pin it), so the rows
// s of a slab are contiguous runs and a group's part is a run of runs.  A
// thread keeps the sum of its current run from tile to tile and stores it,
// with a plain store, once: when the row changes or its part ends.  A
// group's first run (its head) and last run (its tail) may continue in the
// groups beside it; they go to shared memory, and after the last tile one
// thread per element adds heads and tails in group order and stores the
// row once.  Ω sums go to shared memory per group and one thread per
// element adds them in group order (G = 1: stored from the thread).  A
// zero pass clears the slab rows no nnz reaches; the tile loop only
// stores, it never reads a slab or Ω, and there are no atomics: the same
// inputs give the same bits.  The sentinel loc == span is never written.
// The window kernel's range ends before the first pad of the window's last
// chunk (counted with __syncthreads_count).
//
// Registers.  Between one tile's contraction and the next a thread's sums
// and run wait in shared memory (a float4 each for Ψ and Ω, an int2): the
// generator's registers and the contraction's are then not live at once,
// and each instance has its own budget: the merged kernel 64 registers,
// four blocks an SM; Ω alone 40, six; Ψ alone 32, eight (ptxas spills
// 80-190 bytes there, which measured faster than fewer blocks).  Held in
// registers across the tile loop instead (94-112 registers, two blocks an
// SM) the merged kernel was no faster and the sign and window calls were
// slower on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).
//
// Threads without an output element.  A group has P micro-tiles (P*G <=
// 256 threads; at ranks 10/20, G = 5 groups of 50); the rest wait at the
// barrier.  Every thread generates.  Past THREADS/2 micro-tiles one group
// takes them in passes over the range, each generating the tiles anew.
//
// Shared-memory limits.  The wrappers admit what the earlier layout held
// (64-column tiles, 65 floats a row: 866 hashed rows with a salt each, or
// 892 + 1 given rows).  The narrowest stride needs 240 bytes a row and the
// parked sums 10 KB at most, so every admitted call fits at TS = 60; wider
// strides are taken only by the calls whose layout fits them.
//
// A sign side cannot be hashed one sample per thread-step: its column is
// one shuffle over `rank` slots, run by one thread, and the tile waits for
// the slowest.  So the side with the most draws gets a thread per column
// and a side with k times fewer draws a thread per k columns, each side
// from a warp of its own (a warp whose lanes shuffle two sides runs both
// one after the other): at ranks 10/20 the merged kernel's right side
// takes 120 threads and each left side 60, and Ω alone takes 160 + 80 over
// 160-column tiles.  A sliced side (r < rank) allocates `rank` rows and
// contracts rows [rank_min, rank_min + r).  Up to rank 32 a column is
// built in registers (hash_rng.cuh:sign_column_word, each draw hashed
// once, swap positions one byte each) and only the contracted rows are
// written, in an instance of its own (SW) so that the registers of the
// others are not spent on it; the merged kernel keeps the in-place
// shuffle (each draw hashed twice), which measured faster there at lbnl's
// three sign sides on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).
//
// The window kernel.  The TPU kernel revisits one output block over
// adjacent grid steps (init on a window's first chunk, accumulate after);
// blocks here run in parallel, so one block owns one window: it finds its
// chunks in the non-decreasing chunk_window (binary search, then
// chunk_first marks the next window), zeroes the window's span rows and
// walks its run with the same program, a run of rows crossing chunk
// boundaries as it crosses tiles.  Ψ leaves the kernel finished.
//
// One-sided calls.  A Ψ with one side missing and the other hashed (Ψ_0
// and Ψ_{d-1}: psi_fused_slabs at uber's last mode and lbnl's first,
// psi_window_direct at lbnl's giant last mode) spends r samples and r
// products an nnz, and the program above gave it 3 micro-tiles a group of
// 256 threads, a round trip of every sample through shared memory and two
// barriers a tile; the window kernel also a prologue and a zero pass for
// each of its 3392 blocks of about 500 nnz.  Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (PERF.md §6): with the hashing replaced by a
// constant, 0.06-0.10 ms of a call remained, and the window kernel's
// hashing was 0.02 ms of 0.18.  So these calls, up to ONE_MAX_ROWS rows
// on the present side (a sign side: of rank), take instances of their own
// (oneside_kernel, below): a lane a column with its samples in registers,
// runs summed over the warp's lanes, a sliding output stage, a warp per
// window and the grid the blocks the card holds.  The dispatch is by shape
// alone: a two-sided call, or a side of more rows, takes the tiled
// block program above; a build or launch failure of either raises.
//
// Given sides.  The TPU's psi_chunk_slabs is the same one-hot product with the
// rows read, not hashed.  psi_chunk_slabs (both sides given, or one alone) is
// bound by bytes: (r1 + r2 + 2) * 4 per nnz against r1 * r2 FMAs;
// psi_chunk_slabs_genright (left given, right hashed) by the right side's
// hashing, with (r1 + 4) * 4 bytes per nnz besides.  Filled by one scalar load
// per row and thread inside the generation step, as a hashed side is, a tile
// paid a whole round trip to device memory per row before its barrier, and the
// genright hashing waited for it (on uber's calls the loads were half of
// psi_chunk_slabs' device time, PERF.md §6).  So the given rows have instances
// of their own (template parameter GV; 64 registers, four blocks an SM: at 32
// they spilled 100-500 bytes and ran 1.2-1.8x slower on an NVIDIA H100 80GB
// HBM3 at 700 W): a tile's given rows, e and loc land in a ring of NS stages
// (up to RING) by cp.async, NS - 1 tiles ahead of the tile being contracted;
// genright issues a tile's copies before hashing its right rows, so that they
// land while the hashing runs, and takes one stage.  A group's segment of a row
// is copied by 16-byte cp.async.cg where its source is 16-byte aligned (the row
// starts at row * nnz floats, so all rows only when nnz % 4 == 0; e and loc
// when chunk % 4 == 0), the columns past the range zero-filled; else by 4-byte
// cp.async per column: the contraction's 16-byte shared loads pin each column's
// place in the stage, so a row whose source is not aligned cannot take 16-byte
// copies at any offset.  A warp's copies cover whole 16-byte quads of the
// groups' segments.  The contraction is the hashed instances' (odd-quad
// strides, 1 x 4 micro-tiles, runs carried across tiles, one store per output,
// heads and tails added in group order) with e folded into the B quads: a
// missing side is always B (with no right side A is the left side) and its
// quads are then the entries themselves.  Past its range a group reads zeros
// and repeats its last row.  The stride and the ring's depth are chosen so that
// the grid's blocks fit the card together where the shared memory and the
// registers allow, widest stride first, three stages, then two; the 892 + 1
// given rows of the limit take one stage at TS = 60.  Hashing tile it + 1 while
// tile it is contracted (two R buffers, one barrier a tile) measured 2-7 %
// slower, and one or two groups a block (long row segments) 1.1-2.7x slower.
// Columns past nnz are never read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_rng.cuh"
#include "runtime.cuh"

namespace {

constexpr int THREADS = 256;
// Row strides (floats) a launch picks from, widest first: each holds an odd
// number of 16-byte quads, so eight consecutive rows fall in eight
// different bank quads.  A stride is also the tile's column count at most.
constexpr int STRIDES[] = {252, 172, 124, 84, 60};
constexpr int MJ = 4;      // outputs of a thread's micro-tile
constexpr int GMAX = 15;   // thread groups per block at most
// blocks per SM the registers must allow: the merged kernel, Ω alone, Ψ
// alone, Ψ from given rows
constexpr int MIN_BLOCKS_MERGED = 4, MIN_BLOCKS_OMEGA = 6, MIN_BLOCKS_PSI = 8,
              MIN_BLOCKS_GIVEN = 4;
constexpr int RING = 3;    // stages of the given rows' copy ring at most
constexpr int OMEGA_CHUNK = 4096;
constexpr size_t SMEM_LIMIT = 232448;  // opt-in shared memory per block
static_assert(3 * STRIDES[4] <= THREADS,
              "the narrowest tile gives three sign sides a thread a column");

// One side's rows: GAUSS is lazy-Gaussian (one row per salt); SIGN a
// sparse-sign column over `rank` slots from `nnz` salts, rows [rank_min,
// rank_min + rows out) contracted.  Given rows are no kind of side: the
// given-rows instances (template parameter GV) stage them.
enum Kind { GAUSS = 0, SIGN = 1 };

// The given-rows instances: GV_NONE hashes every side (the fused, Ω,
// merged and window kernels); GV_LEFT stages a given left side (or none)
// and hashes the right side (or has none); GV_RIGHT stages a given right
// side and a given left side (or none).
enum Given { GV_NONE = 0, GV_LEFT = 1, GV_RIGHT = 2 };

struct Side {
  int kind;
  int rank;
  int nnz;
  int rank_min;
};

// The block program's geometry, chosen by the launch code.  A micro-tile
// is MJ rows a0 + c*NA of side A against one row b of side B: A is the
// right side (B the left side for Ψ, Ω's left side for Ω), or, for a Ψ
// whose right side has fewer than MJ rows, the left side (BYI).
struct Sched {
  int TS;   // row stride in floats, one of STRIDES
  int G;    // thread groups, each over its own contiguous part of the range
  int TG;   // tile columns per group, a multiple of 4
  int NA;   // ceil(rows of A / MJ)
  int P;    // micro-tiles: NA * rows of B (the most of Ψ's and Ω's)
  int GP;   // threads per group: P when G > 1, else THREADS (P > THREADS/2
            // takes ceil(P / THREADS) passes over the range)
  int BYI;  // A is the left side
  // sign sides (0 right, 1 left, 2 Ω's left): threads [SB, SB + SN) of a
  // side take its tile columns u, u + SN, ... (SN = 0: not a sign side)
  int SB[3], SN[3];
  int NS;   // given-rows instances: stages of the copy ring (1 to RING)
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
  const float* lrows = nullptr;  // a given left side's rows (r1, nnz)
  const float* rrows = nullptr;  // a given right side's rows (r2, nnz)
  Sched sc = {};
};

// Shared-memory layout while the tiles run: rows L | R | O (TS floats
// each), loc (TS ints), each thread's parked sums (float4 Ψ, float4 Ω) and
// run (int2), salts [L | R | O]; after the last tile the groups'
// tail sums and Ω sums overlay them.  With G > 1 groups the heads follow:
// rows (G, 2) ints (head, tail) and Ψ sums (G, r1, r2) floats.  The
// given-rows instances hold rows R (hashed right side), the parked sums and
// runs, R's salts, then the copy ring: NS stages of `nst` rows (given left
// rows, given right rows, e, loc), each TS floats.
struct Layout {
  int nsl, nsr, nso;  // salts per side
  int al, ar, ao;     // rows allocated per side
  int gl, gr, go;     // rows hashed sample by sample (Gaussian or ones)
  int nst;            // given-rows instances: rows a ring stage holds
  size_t ring;        // given-rows instances: byte offset of the ring
  size_t heads;       // byte offset of the group heads
  size_t bytes;       // dynamic shared memory of the block
};

template <bool HAS_L, bool HAS_R, bool PSI, bool OM, int GV = GV_NONE>
__host__ __device__ Layout layout(const Args& a) {
  Layout y;
  const size_t ts = a.sc.TS, G = a.sc.G;
  if constexpr (GV != GV_NONE) {
    const bool hashed = GV == GV_LEFT && HAS_R;
    const bool sr = hashed && a.rs.kind == SIGN;
    y.nsl = y.nso = y.al = y.ao = y.gl = y.go = 0;
    y.nsr = !hashed ? 0 : sr ? a.rs.nnz : a.r2;
    y.ar = !hashed ? 0 : sr ? a.rs.rank : a.r2;
    y.gr = hashed && !sr ? a.r2 : 0;
    y.nst = (HAS_L ? a.r1 : 0) + (GV == GV_RIGHT && HAS_R ? a.r2 : 0) + 2;
    const size_t ne = (size_t)a.r1 * a.r2;
    y.ring = ((size_t)y.ar * ts * sizeof(float) +
              THREADS * (sizeof(float4) + sizeof(int2)) +
              (size_t)y.nsr * sizeof(uint64_t) + 15) / 16 * 16;
    const size_t tiles = y.ring + (size_t)a.sc.NS * y.nst * ts * sizeof(float);
    const size_t tails = G > 1 ? G * ne * sizeof(float) : 0;
    y.heads = ((tiles > tails ? tiles : tails) + 15) / 16 * 16;
    y.bytes = y.heads + (G > 1 ? G * (2 * sizeof(int) + ne * sizeof(float))
                               : 0);
    return y;
  }
  y.nst = 0;
  y.ring = 0;
  const bool sl = PSI && HAS_L && a.ls.kind == SIGN;
  const bool sr = HAS_R && a.rs.kind == SIGN;
  const bool so = OM && a.os.kind == SIGN;
  y.nsl = !PSI || !HAS_L ? 0 : sl ? a.ls.nnz : a.r1;
  y.nsr = !HAS_R ? 0 : sr ? a.rs.nnz : a.r2;
  y.nso = !OM ? 0 : so ? a.os.nnz : a.r1o;
  y.al = !PSI ? 0 : sl ? a.ls.rank : a.r1;
  y.ar = sr ? a.rs.rank : a.r2;
  y.ao = !OM ? 0 : so ? a.os.rank : a.r1o;
  y.gl = sl || !PSI ? 0 : a.r1;
  y.gr = sr ? 0 : a.r2;
  y.go = so || !OM ? 0 : a.r1o;
  const size_t ne = PSI ? (size_t)a.r1 * a.r2 : 0;
  const size_t neo = OM ? (size_t)a.r1o * a.r2 : 0;
  const size_t park = THREADS * ((OM ? 2 : 1) * sizeof(float4) + sizeof(int2));
  const size_t tiles = (size_t)(y.al + y.ar + y.ao) * ts * sizeof(float) +
                       ts * sizeof(int) + park +
                       (size_t)(y.nsl + y.nsr + y.nso) * sizeof(uint64_t);
  const size_t tails = G > 1 ? G * (ne + neo) * sizeof(float) : 0;
  y.heads = ((tiles > tails ? tiles : tails) + 15) / 16 * 16;
  y.bytes = y.heads +
            (G > 1 && PSI ? G * (2 * sizeof(int) + ne * sizeof(float)) : 0);
  return y;
}

// Rows [rank_min, rank_min + r_out) of one sign column held in registers
// (rank <= RB <= 32; swap positions packed, one byte each), times ek, into
// the side's rows at `col`.
template <int RB>
__device__ __forceinline__ void sign_word_rows(float* col, int ts,
                                               uint64_t flat,
                                               const uint64_t* salts,
                                               const Side& sd, int r_out,
                                               float ek) {
  const tt_rng::SignWord<RB> v =
      tt_rng::sign_column_word<RB, 1, true>(flat, salts, sd.rank, sd.nnz) >>
      (2 * sd.rank_min);
  float* o = col + sd.rank_min * ts;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r >= r_out) break;
    *o = tt_rng::sign_slot((uint32_t)(v >> (2 * r))) * ek;
    o += ts;
  }
}

// One tile column of a sign side on the side's rows (`col` is the column's
// slot 0, `ts` the row stride); a left side carries the entry.  In a kernel
// instance with sign words (SW) a column of rank <= 32 is built in
// registers and only rows [rank_min, rank_min + r_out) are written; else it
// is shuffled in place over all `rank` rows.  A column past the range
// contributes zeros.
template <bool SW>
__device__ __forceinline__ void sign_side(float* col, int ts,
                                          const uint64_t* flat,
                                          const uint64_t* salts,
                                          const Side& sd, int r_out,
                                          const float* e, int64_t k,
                                          bool valid) {
  if (!valid) {
    for (int s = sd.rank_min; s < sd.rank_min + r_out; ++s) col[s * ts] = 0.f;
    return;
  }
  const float ek = e ? e[k] : 1.f;
  if (SW && sd.rank <= 16) {
    sign_word_rows<16>(col, ts, flat[k], salts, sd, r_out, ek);
    return;
  }
  if (SW && sd.rank <= 32) {
    sign_word_rows<32>(col, ts, flat[k], salts, sd, r_out, ek);
    return;
  }
  tt_rng::sign_column(flat[k], salts, sd.rank, sd.nnz, col, ts);
  if (e) {
    for (int s = sd.rank_min; s < sd.rank_min + r_out; ++s) col[s * ts] *= ek;
  }
}

__device__ __forceinline__ int phase_of(int r0, int base, int rs) {
  return ((r0 - base) % rs + rs) % rs;
}

__device__ __forceinline__ float4 lds4(const float* smem, int off) {
  return *reinterpret_cast<const float4*>(smem + off);
}

// The first `n` bytes (0 to 16) of 16 from global to shared memory, the
// rest zero; both addresses 16-byte aligned.  In flight until waited for.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

// One 4-byte value from global to shared memory.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four columns of a staged row whose first `nv` are in range: one 16-byte
// copy where the source is 16-byte aligned (the tail past the range
// zero-filled), else one 4-byte copy per column in range; columns past the
// range are zero.
__device__ __forceinline__ void stage_quad(float* dst, const float* src,
                                           int64_t nv) {
  if (nv <= 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src, nv >= 4 ? 16 : 4 * (int)nv);
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (v < nv) cp_async4(dst + v, src + v); else dst[v] = 0.f;
    }
  }
}

// A thread's micro-tile: outputs el0 + c*el_step for c < n_ok, from A rows
// at smem offsets a_off + c*a_step and the B row at b_off (Ψ), the Ω-left
// row at o_off.
struct Micro {
  int a_off, a_step, b_off, o_off;
  int el0, el_step, n_ok;
  bool psi, om;
};

__device__ __forceinline__ Micro micro_tile(const Sched& sc, int p, int c0,
                                            int r1, int r2, int r1o, int ts,
                                            int l_at, int r_at, int o_at,
                                            bool psi, bool om) {
  Micro m;
  const bool byi = !om && sc.BYI;
  const int b = p / sc.NA, a0 = p - b * sc.NA;
  const int n_a = byi ? r1 : r2;
  m.a_off = (byi ? l_at : r_at) + a0 * ts + c0;
  m.a_step = sc.NA * ts;
  m.b_off = (byi ? r_at + b * ts : l_at + (b < r1 ? b : 0) * ts) + c0;
  m.o_off = o_at + (b < r1o ? b : 0) * ts + c0;
  m.el0 = byi ? a0 * r2 + b : b * r2 + a0;
  m.el_step = byi ? sc.NA * r2 : sc.NA;
  m.n_ok = 0;
#pragma unroll
  for (int c = 0; c < MJ; ++c) m.n_ok += a0 + c * sc.NA < n_a;
  m.psi = psi && (byi || b < r1);
  m.om = om && b < r1o;
  return m;
}

template <bool HAS_L, bool HAS_R, bool PSI, bool OM, bool WIN, bool SW,
          int GV = GV_NONE>
__global__ void __launch_bounds__(
    THREADS, GV != GV_NONE ? MIN_BLOCKS_GIVEN
             : PSI && OM   ? MIN_BLOCKS_MERGED
             : OM          ? MIN_BLOCKS_OMEGA
                           : MIN_BLOCKS_PSI)
    sparse_psi_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int r1 = a.r1, r2 = a.r2, r1o = OM ? a.r1o : 0, span = a.span;
  const Sched sc = a.sc;
  const int ts = sc.TS;
  const Layout y = layout<HAS_L, HAS_R, PSI, OM, GV>(a);
  // the rows the contraction reads, as offsets into smem: a sign side's
  // slice starts at rank_min (a given-rows instance moves the staged ones
  // to the tile's ring stage)
  const int l_at = y.gl || !PSI ? 0 : a.ls.rank_min * ts;
  const int r_at = y.al * ts + (y.gr ? 0 : a.rs.rank_min * ts);
  const int o_at = (y.al + y.ar) * ts + (y.go || !OM ? 0 : a.os.rank_min * ts);
  float* Ls = smem;
  float* Rs = Ls + y.al * ts;
  float* Os = Rs + y.ar * ts;
  int* loc_s = reinterpret_cast<int*>(Os + y.ao * ts);
  // a thread's sums and run between tiles: (acc, Ω sums, {s, head open})
  float4* park_acc = reinterpret_cast<float4*>(loc_s + (GV ? 0 : ts));
  float4* park_om = park_acc + THREADS;
  int2* park_run = reinterpret_cast<int2*>(park_om + (OM ? THREADS : 0));
  uint64_t* salts = reinterpret_cast<uint64_t*>(park_run + THREADS);
  int* ends = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) + y.heads);
  float* heads = reinterpret_cast<float*>(ends + 2 * sc.G);
  const uint64_t* salts_l = salts;
  const uint64_t* salts_r = salts + y.nsl;
  const uint64_t* salts_o = salts_r + y.nsr;
  const int n_salts = y.nsl + y.nsr + y.nso;

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
  if (WIN && end > start) {
    // the pads (loc == span) fill the end of a window's last chunk: its
    // run ends after the last chunk's real nnz
    const int64_t last = end - a.chunk;
    int real = 0;
    for (int c = 0; c < a.chunk; c += THREADS) {
      real += __syncthreads_count(c + tid < a.chunk &&
                                  a.loc[last + c + tid] < span);
    }
    end = last + real;
  }
  const int ne = r1 * r2, neo = r1o * r2;
  float* slab = PSI ? a.slabs + g * span * ne : nullptr;
  float* om = OM ? a.om + g * neo : nullptr;
  if (PSI) {
    for (int i = tid; i < span * ne; i += THREADS) slab[i] = 0.f;
  }

  // The range [start, end) splits into G contiguous parts of q nnz, whole
  // group tiles each; group c walks its part TG columns per tile, at tile
  // columns [c*TG, (c+1)*TG).
  const int G = sc.G, TG = sc.TG, W = G * TG, RS = THREADS / W;
  const int64_t n = end > start ? end - start : 0;
  int64_t q = (n + G - 1) / G;
  q = (q + TG - 1) / TG * TG;
  const int n_it = (int)(q / TG);

  // generation: this thread's tile column t0 and its first row r0 (rows
  // r0, r0 + RS, ... of the hashed rows in one sequence over the sides)
  const int r0 = tid / W, t0 = tid - r0 * W;
  const bool gen = r0 < RS;
  const int cg = t0 / TG;
  const int64_t col_lo = start + cg * q + (t0 - cg * TG);
  const int64_t col_end = min(start + (cg + 1) * q, end);
  const int64_t col_grp = start + cg * q;
  const int ph_l = phase_of(r0, 0, RS), ph_r = phase_of(r0, y.gl, RS),
            ph_o = phase_of(r0, y.gl + y.gr, RS);

  // contraction: this thread's group and its place in it
  const int grp = tid / sc.GP, in_grp = tid - grp * sc.GP;
  const int64_t my_lo = start + grp * q;
  const int64_t my_hi = min(my_lo + q, end);
  const int64_t my_n = grp < G && my_lo < my_hi ? my_hi - my_lo : 0;
  const int c0 = grp * TG;
  const int passes = (sc.P + sc.GP - 1) / sc.GP;
  const bool lead = in_grp == 0 && grp < G;  // writes the group's rows
  float* const my_heads = heads + grp * ne;

  // Given-rows instances: tile j's given rows, e and loc land in ring stage
  // j % NS by cp.async, issued NS - 1 tiles ahead of the tile being
  // contracted; stage rows are [left rows][right rows][e][loc].  The
  // contraction folds e into its B quads (a missing side is always B and
  // then B is e itself), and reads past its range the group's last row.
  const int NS = GV ? sc.NS : 1;
  const int r1g = GV && HAS_L ? r1 : 0;
  const int r2g = GV == GV_RIGHT && HAS_R ? r2 : 0;
  const int ring_at = (int)(y.ring / sizeof(float));
  const int stage_floats = y.nst * ts;
  const int loc_last = GV && my_n > 0 ? a.loc[my_hi - 1] : 0;
  [[maybe_unused]] auto stage_tile = [&](int j) {
    float* const sb = smem + ring_at + (j % NS) * stage_floats;
    const int nq = TG / 4, per_row = G * nq;
    for (int i = tid; i < y.nst * per_row; i += THREADS) {
      const int row = i / per_row, cq = i - row * per_row;
      const int gc = cq / nq, qd = cq - gc * nq;
      const int64_t k0 = start + gc * q + (int64_t)j * TG;
      const int64_t left = min(start + (gc + 1) * q, end) - k0;
      if (left <= 0) continue;  // past the group's range: never read
      const float* src =
          row < r1g ? a.lrows + (int64_t)row * a.nnz
          : row < r1g + r2g ? a.rrows + (int64_t)(row - r1g) * a.nnz
          : row == r1g + r2g ? a.e
                             : reinterpret_cast<const float*>(a.loc);
      stage_quad(sb + row * ts + gc * TG + 4 * qd, src + k0 + 4 * qd,
                 left - 4 * qd);
    }
  };

  for (int pass = 0; pass < passes; ++pass) {
    const int p = pass * sc.GP + in_grp;
    const bool mine = grp < G && p < sc.P;  // owns a micro-tile
    float acc[MJ] = {}, oacc[MJ] = {};
    int s = 0;
    bool head_open = true;
    // closes the current run of row s and starts row `next`: with G > 1
    // the group's first run is its head, kept in shared memory for the
    // combine; every later run is stored, once
    auto close_run = [&](const Micro& m, int next) {
      if (G > 1 && head_open) {
        if (m.psi) {
#pragma unroll
          for (int c = 0; c < MJ; ++c) {
            if (c < m.n_ok) my_heads[m.el0 + c * m.el_step] = acc[c];
          }
        }
        if (lead) ends[2 * grp] = s;
      } else if (m.psi && s >= 0 && s < span) {
        float* out = slab + (int64_t)s * ne + m.el0;
#pragma unroll
        for (int c = 0; c < MJ; ++c) {
          if (c < m.n_ok) out[c * m.el_step] = acc[c];
        }
      }
      head_open = false;
#pragma unroll
      for (int c = 0; c < MJ; ++c) acc[c] = 0.f;
      s = next;
    };
    if (mine) {
      park_acc[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (OM) park_om[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
      park_run[tid] = make_int2(PSI && my_n > 0 ? a.loc[my_lo] : 0, 1);
    }
    __syncthreads();  // the salts and the zero pass
    if constexpr (GV != GV_NONE) {
      for (int j = 0; j < NS - 1; ++j) {
        if (j < n_it) stage_tile(j);
        cp_async_commit();
      }
    }

    for (int it = 0; it < n_it; ++it) {
      const int64_t k = col_lo + (int64_t)it * TG;
      const bool kv = gen && k < col_end;
      if constexpr (GV != GV_NONE) {
        if (it + NS - 1 < n_it) stage_tile(it + NS - 1);
        cp_async_commit();
      }
      // 1a. sign sides: a side's threads shuffle its tile columns, one
      // column a thread on the side with the most draws and several on a
      // side with fewer (Schedule), so that they finish together
      {
        auto sign_cols = [&](int sd, float* rows, const uint64_t* flat,
                             const uint64_t* sl, const Side& side, int r_out,
                             const float* e) {
          const int u = tid - sc.SB[sd];
          if (u < 0 || u >= sc.SN[sd]) return;
          for (int c = u; c < W; c += sc.SN[sd]) {
            const int gc = c / TG;
            const int64_t kc = start + gc * q + (int64_t)it * TG + (c - gc * TG);
            sign_side<SW>(rows + c, ts, flat, sl, side, r_out, e, kc,
                      kc < min(start + (gc + 1) * q, end));
          }
        };
        if (HAS_R && a.rs.kind == SIGN) {
          sign_cols(0, Rs, a.rflat, salts_r, a.rs, r2, nullptr);
        }
        if (!GV && PSI && HAS_L && a.ls.kind == SIGN) {
          sign_cols(1, Ls, a.lflat, salts_l, a.ls, r1, a.e);
        }
        if (OM && a.os.kind == SIGN) {
          sign_cols(2, Os, a.oflat, salts_o, a.os, r1o, a.e);
        }
      }
      // 1b. Gaussian and missing sides: the column's flat indices and
      // entry are loaded once; left rows carry e[k]; a column past the
      // range is zero.  A given-rows instance hashes its right rows here,
      // while the ring's copies are in flight.
      if (gen) {
        float ek = 0.f;
        uint64_t fl = 0, fr = 0, fo = 0;
        if (kv) {
          if (!GV) ek = a.e[k];
          if (!GV && PSI && HAS_L && y.gl) fl = a.lflat[k];
          if (HAS_R && y.gr) fr = a.rflat[k];
          if (OM && y.go) fo = a.oflat[k];
        }
        if (PSI && !GV) {
          for (int row = ph_l; row < y.gl; row += RS) {
            Ls[row * ts + t0] = !kv ? 0.f
                                : !HAS_L ? ek
                                         : tt_rng::sample(fl, salts_l[row]) * ek;
          }
        }
        for (int row = ph_r; row < y.gr; row += RS) {
          Rs[row * ts + t0] = !kv ? 0.f
                              : !HAS_R ? 1.f
                                       : tt_rng::sample(fr, salts_r[row]);
        }
        if (OM) {
          for (int row = ph_o; row < y.go; row += RS) {
            Os[row * ts + t0] =
                !kv ? 0.f : tt_rng::sample(fo, salts_o[row]) * ek;
          }
        }
        // past the range, a column repeats the group's last row: it
        // closes no run
        if (PSI && !GV && r0 == 0) {
          loc_s[t0] = kv ? a.loc[k]
                      : col_end > col_grp ? a.loc[col_end - 1] : 0;
        }
      }
      if constexpr (GV != GV_NONE) {
        // this thread's copies of tile it have landed
        if (NS == 3) cp_async_wait<RING - 1>();
        else if (NS == 2) cp_async_wait<1>();
        else cp_async_wait<0>();
      }
      __syncthreads();

      // 2. contract the group's TG columns four at a time: each A row is
      // read once for Ψ and Ω
      if (mine && (int64_t)it * TG < my_n) {
        // a given-rows instance reads its staged rows in stage it % NS
        const int sb = ring_at + (it % NS) * stage_floats;
        const int e_at = sb + (r1g + r2g) * ts;
        const int* const locs =
            GV ? reinterpret_cast<const int*>(smem) + e_at + ts : loc_s;
        const int in_tile = GV ? (int)min((int64_t)TG, my_n - (int64_t)it * TG)
                               : TG;
        const Micro m = micro_tile(
            sc, p, c0, r1, r2, r1o, ts,
            !GV ? l_at : HAS_L ? sb : e_at,
            !GV ? r_at : GV == GV_RIGHT ? sb + r1g * ts : HAS_R ? r_at : e_at,
            o_at, PSI, OM);
        {
          const float4 pa = park_acc[tid];
          acc[0] = pa.x, acc[1] = pa.y, acc[2] = pa.z, acc[3] = pa.w;
          const float4 po = OM ? park_om[tid] : pa;
          oacc[0] = po.x, oacc[1] = po.y, oacc[2] = po.z, oacc[3] = po.w;
          const int2 pr = park_run[tid];
          s = pr.x;
          head_open = pr.y;
        }
        for (int t = 0; t < TG; t += 4) {
          int4 lc = PSI ? *reinterpret_cast<const int4*>(locs + c0 + t)
                        : make_int4(0, 0, 0, 0);
          if (GV && t + 4 > in_tile) {
            // past the range the columns repeat the group's last row
            lc.x = t < in_tile ? lc.x : loc_last;
            lc.y = t + 1 < in_tile ? lc.y : loc_last;
            lc.z = t + 2 < in_tile ? lc.z : loc_last;
            lc.w = loc_last;
          }
          const bool same = lc.w == s;  // loc is non-decreasing
          float4 bv = PSI ? lds4(smem, m.b_off + t) : make_float4(0.f, 0.f, 0.f, 0.f);
          if (GV && HAS_L && HAS_R) {
            const float4 ev = lds4(smem, e_at + c0 + t);
            bv.x *= ev.x, bv.y *= ev.y, bv.z *= ev.z, bv.w *= ev.w;
          }
          const float4 ov = OM ? lds4(smem, m.o_off + t) : bv;
#pragma unroll
          for (int c = 0; c < MJ; ++c) {
            if (c < m.n_ok) {
              const float4 av = lds4(smem, m.a_off + c * m.a_step + t);
              if (OM) {
                oacc[c] = fmaf(ov.x, av.x, oacc[c]);
                oacc[c] = fmaf(ov.y, av.y, oacc[c]);
                oacc[c] = fmaf(ov.z, av.z, oacc[c]);
                oacc[c] = fmaf(ov.w, av.w, oacc[c]);
              }
              if (PSI && same) {
                acc[c] = fmaf(bv.x, av.x, acc[c]);
                acc[c] = fmaf(bv.y, av.y, acc[c]);
                acc[c] = fmaf(bv.z, av.z, acc[c]);
                acc[c] = fmaf(bv.w, av.w, acc[c]);
              }
            }
          }
          if (PSI && !same) {
            // a run ends inside these four columns
            const int lcv[4] = {lc.x, lc.y, lc.z, lc.w};
            const float bvv[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              if (lcv[v] != s) close_run(m, lcv[v]);
#pragma unroll
              for (int c = 0; c < MJ; ++c) {
                if (c < m.n_ok) {
                  acc[c] = fmaf(bvv[v], smem[m.a_off + c * m.a_step + t + v],
                                acc[c]);
                }
              }
            }
          }
        }
        park_acc[tid] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        if (OM) park_om[tid] = make_float4(oacc[0], oacc[1], oacc[2], oacc[3]);
        park_run[tid] = make_int2(s, head_open);
      }
      __syncthreads();
    }

    // 3. store: each output element once
    Micro m = {};
    if (mine) {
      m = micro_tile(sc, p, c0, r1, r2, r1o, ts, l_at, r_at, o_at, PSI, OM);
      const float4 pa = park_acc[tid];
      acc[0] = pa.x, acc[1] = pa.y, acc[2] = pa.z, acc[3] = pa.w;
      const float4 po = OM ? park_om[tid] : pa;
      oacc[0] = po.x, oacc[1] = po.y, oacc[2] = po.z, oacc[3] = po.w;
      const int2 pr = park_run[tid];
      s = pr.x;
      head_open = pr.y;
    }
    if (G == 1) {
      if (PSI && mine && my_n > 0) close_run(m, s);  // the tail run
      if (m.om) {
        float* out = om + m.el0;
#pragma unroll
        for (int c = 0; c < MJ; ++c) {
          if (c < m.n_ok) out[c * m.el_step] = oacc[c];
        }
      }
    } else {
      // the groups' tail runs and Ω sums go to shared memory over the tiles
      // (once every thread has read its park); a group that is one run
      // keeps it as its head.  Then one thread per element adds them in
      // group order.
      __syncthreads();
      float* tv = smem;                     // (G, r1, r2)
      float* ov = tv + (PSI ? G * ne : 0);  // (G, r1o, r2)
      if (PSI && (my_n == 0 || head_open)) {
        if (lead) {
          ends[2 * grp] = my_n == 0 ? -1 : s;
          ends[2 * grp + 1] = -1;
        }
        if (m.psi) {
#pragma unroll
          for (int c = 0; c < MJ; ++c) {
            if (c < m.n_ok) my_heads[m.el0 + c * m.el_step] = acc[c];
          }
        }
      } else if (PSI) {
        if (lead) ends[2 * grp + 1] = s;
        if (m.psi) {
#pragma unroll
          for (int c = 0; c < MJ; ++c) {
            if (c < m.n_ok) tv[grp * ne + m.el0 + c * m.el_step] = acc[c];
          }
        }
      }
      if (m.om) {
#pragma unroll
        for (int c = 0; c < MJ; ++c) {
          if (c < m.n_ok) ov[grp * neo + m.el0 + c * m.el_step] = oacc[c];
        }
      }
      __syncthreads();
      if (PSI) {
        for (int el = tid; el < ne; el += THREADS) {
          int cur = -1;
          float sum = 0.f;
          for (int u = 0; u < 2 * G; ++u) {
            const int row = ends[u];
            if (row < 0) continue;
            const float v = ((u & 1) ? tv : heads)[(u >> 1) * ne + el];
            if (row == cur) {
              sum += v;
            } else {
              if (cur >= 0 && cur < span) slab[(int64_t)cur * ne + el] = sum;
              cur = row;
              sum = v;
            }
          }
          if (cur >= 0 && cur < span) slab[(int64_t)cur * ne + el] = sum;
        }
      }
      if (OM) {
        for (int el = tid; el < neo; el += THREADS) {
          float sum = ov[el];
          for (int u = 1; u < G; ++u) sum += ov[u * neo + el];
          om[el] = sum;
        }
      }
    }
  }
}

bool bad_side(const Side& sd, int r_out) {
  return sd.kind == SIGN &&
         (sd.rank <= 0 || sd.nnz < 0 || sd.nnz > sd.rank || sd.rank_min < 0 ||
          sd.rank_min + r_out > sd.rank);
}

// The block program's geometry: micro-tiles along the right side (along
// the left one for a Ψ with fewer than MJ right rows), as many thread
// groups as the block's threads hold (at most GMAX), and the widest row
// stride whose tile gives every sign side a thread per column and whose
// layout fits the shared memory (the narrowest always does where the
// wrappers' limit admits the call).
template <bool HAS_L, bool HAS_R, bool PSI, bool OM>
Sched schedule(Args a) {
  Sched& s = a.sc;
  s.BYI = PSI && !OM && a.r2 < MJ && a.r1 > a.r2;
  int m = PSI ? a.r1 : 0;
  if (OM && a.r1o > m) m = a.r1o;
  s.NA = ((s.BYI ? a.r1 : a.r2) + MJ - 1) / MJ;
  s.P = (s.BYI ? a.r2 : m) * s.NA;
  s.G = 2 * s.P > THREADS ? 1 : (THREADS / s.P < GMAX ? THREADS / s.P : GMAX);
  s.GP = s.G > 1 ? s.P : THREADS;
  // a sign side's weight is its draws; a side takes one thread per
  // (heaviest weight / its weight) tile columns, from a warp of its own
  const bool sign[3] = {HAS_R && a.rs.kind == SIGN,
                        PSI && HAS_L && a.ls.kind == SIGN,
                        OM && a.os.kind == SIGN};
  const int draws[3] = {a.rs.nnz, a.ls.nnz, a.os.nnz};
  int heaviest = 1;
  for (int sd = 0; sd < 3; ++sd) {
    if (sign[sd] && draws[sd] > heaviest) heaviest = draws[sd];
  }
  for (int ts : STRIDES) {
    s.TS = ts;
    s.TG = ts / (4 * s.G) * 4;
    const int W = s.G * s.TG;
    int used = 0;
    for (int sd = 0; sd < 3; ++sd) {
      const int per = sign[sd] ? heaviest / (draws[sd] > 0 ? draws[sd] : 1)
                               : 0;
      s.SB[sd] = (used + 31) / 32 * 32;
      s.SN[sd] = per > 0 ? (W + per - 1) / per : 0;
      used = s.SB[sd] + s.SN[sd];
    }
    if (used <= THREADS &&
        layout<HAS_L, HAS_R, PSI, OM>(a).bytes <= SMEM_LIMIT) {
      break;
    }
  }
  return s;
}

template <bool HAS_L, bool HAS_R, bool PSI, bool OM, bool WIN = false>
cudaError_t launch(Args a, int64_t n_blocks, cudaStream_t stream) {
  a.sc = schedule<HAS_L, HAS_R, PSI, OM>(a);
  const size_t bytes = layout<HAS_L, HAS_R, PSI, OM>(a).bytes;
  if (bytes > SMEM_LIMIT || n_blocks <= 0 || n_blocks > 0x7FFFFFFF ||
      (HAS_L && bad_side(a.ls, a.r1)) || (HAS_R && bad_side(a.rs, a.r2)) ||
      (OM && bad_side(a.os, a.r1o))) {
    return cudaErrorInvalidValue;
  }
  // the instance with sign words where a sign side has rank <= 32, except
  // for the merged kernel (slower there at lbnl's three sign sides,
  // PERF.md); the others keep their registers for the contraction
  const auto word = [](bool on, const Side& sd) {
    return on && sd.kind == SIGN && sd.rank <= 32;
  };
  const bool sw = !(PSI && OM) && (word(HAS_R, a.rs) ||
                                   word(PSI && HAS_L, a.ls) || word(OM, a.os));
  auto kernel = sw ? sparse_psi_kernel<HAS_L, HAS_R, PSI, OM, WIN, true>
                   : sparse_psi_kernel<HAS_L, HAS_R, PSI, OM, WIN, false>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)n_blocks, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

// The given-rows instances' geometry.  A missing side is always side B (the
// left one, or with no right side the right one: then A is the left side),
// so that B's quads are the entries.  The copy ring and the row stride are
// sized so that the grid's blocks are resident together where the shared
// memory allows (at most MIN_BLOCKS_GIVEN an SM): the widest stride first,
// with three stages, then two (a hashed right side: one stage); with fewer
// blocks an SM where nothing fits; one stage at the narrowest stride where
// no ring of two fits a block.
template <bool HAS_L, bool HAS_R, int GV>
Sched schedule_given(Args a, int64_t n_blocks) {
  Sched& s = a.sc;
  s.BYI = !HAS_R || (a.r2 < MJ && a.r1 > a.r2);
  s.NA = ((s.BYI ? a.r1 : a.r2) + MJ - 1) / MJ;
  s.P = (s.BYI ? a.r2 : a.r1) * s.NA;
  s.G = 2 * s.P > THREADS ? 1 : (THREADS / s.P < GMAX ? THREADS / s.P : GMAX);
  s.GP = s.G > 1 ? s.P : THREADS;
  // a hashed side hides a tile's copies behind its hashing: one stage; a
  // hashed sign side takes a thread per tile column
  const bool hashed = GV == GV_LEFT && HAS_R;
  const bool sign = hashed && a.rs.kind == SIGN;
  int n_sm = 0, sm_bytes = 0, reserved = 0;
  tt_runtime::sm_count(&n_sm);
  tt_runtime::smem_per_sm(&sm_bytes);
  tt_runtime::reserved_smem_per_block(&reserved);
  int64_t want = n_sm > 0 ? (n_blocks + n_sm - 1) / n_sm : 1;
  if (want > MIN_BLOCKS_GIVEN) want = MIN_BLOCKS_GIVEN;
  s.SB[0] = s.SB[1] = s.SB[2] = 0;
  s.SN[1] = s.SN[2] = 0;
  for (int64_t b = want > 0 ? want : 1; b >= 1; --b) {
    size_t budget = (size_t)sm_bytes / b - reserved;
    if (budget > SMEM_LIMIT || sm_bytes == 0) budget = SMEM_LIMIT;
    for (int ts : STRIDES) {
      s.TS = ts;
      s.TG = ts / (4 * s.G) * 4;
      s.SN[0] = sign ? s.G * s.TG : 0;
      for (int ns = hashed ? 1 : RING; ns >= (hashed ? 1 : 2); --ns) {
        s.NS = ns;
        if (layout<HAS_L, HAS_R, true, false, GV>(a).bytes <= budget) {
          return s;
        }
      }
    }
  }
  s.TS = STRIDES[sizeof(STRIDES) / sizeof(STRIDES[0]) - 1];
  s.TG = s.TS / (4 * s.G) * 4;
  s.SN[0] = sign ? s.G * s.TG : 0;
  s.NS = 1;
  return s;
}

template <bool HAS_L, bool HAS_R, int GV>
cudaError_t launch_given(Args a, int64_t n_blocks, cudaStream_t stream) {
  a.sc = schedule_given<HAS_L, HAS_R, GV>(a, n_blocks);
  const size_t bytes = layout<HAS_L, HAS_R, true, false, GV>(a).bytes;
  if (bytes > SMEM_LIMIT || n_blocks <= 0 || n_blocks > 0x7FFFFFFF ||
      (GV == GV_LEFT && HAS_R && bad_side(a.rs, a.r2))) {
    return cudaErrorInvalidValue;
  }
  auto kernel = sparse_psi_kernel<HAS_L, HAS_R, true, false, false, false, GV>;
  if constexpr (GV == GV_LEFT && HAS_R) {
    // sign words for a hashed sign side of rank <= 32, as psi_fused_slabs
    if (a.rs.kind == SIGN && a.rs.rank <= 32) {
      kernel = sparse_psi_kernel<HAS_L, HAS_R, true, false, false, true, GV>;
    }
  }
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)n_blocks, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// One-sided instances: a Ψ with one side missing and the other hashed, of at
// most ONE_MAX_ROWS rows (a sign side: of rank at most ONE_MAX_ROWS).  Each
// nnz is then r samples and r products; there is nothing to tile.  A lane
// owns a column: it hashes the column's r samples into registers (acc[],
// RB of them, r <= RB), folds the entry in, and the warp sums runs of equal
// loc in a fixed order; no sample goes through shared memory.
//
//   - a step is 32 consecutive columns, one a lane (loc, e and the flat
//     index are coalesced loads, issued a step ahead);
//   - a step whose 32 columns continue the open run (loc equal to it on
//     both ends: loc is non-decreasing) adds into acc: the run's partial is
//     then spread over the lanes, and the next other step first adds its
//     butterfly sum to the run's row;
//   - any other step sums each of its runs onto the run's first lane (a
//     segmented suffix sum over the lanes, keyed on loc, in as many rounds
//     as its longest run needs), and that lane adds the sums to the run's
//     row;
//   - a row's sums go to the warp's output stage, ONE_STAGE rows of shared
//     memory that slide over the rows the warp owns in increasing order; a
//     row stays open for adds until a row past the stage comes, which
//     flushes the stage to the output with coalesced stores, zeros
//     included, and moves it on ONE_STAGE rows.  Every output row is stored
//     once, zeros included: there is no zero pass.
//
// psi_fused_slabs: one block per plan chunk, its warps over contiguous parts
// of it (ONE_WARPS_MAX warps when the grid fits the card at once, else
// ONE_WARPS).  A warp owns the rows strictly between its part's first row
// (its head) and its last (its tail); the sums of those two rows go to
// slots in shared memory, and after a barrier warp 0 adds the heads and
// tails in warp order, stores each of their rows once and zeroes the rows
// no warp owns.  psi_window_direct: a warp owns whole windows (one
// window's run, all span rows of it: no combine), a block a contiguous run
// of windows, and the grid the blocks the card holds at once.  A warp finds
// its window's chunks in the non-decreasing chunk_window by a 32-way search
// (each lane one probe), and stops at the first step that starts on a pad
// (loc == span, pads last); the pads of a step that has real columns form
// its last run, of row span, which is dropped.
//
// A row's sum is its steps' run sums added in step order (a continuing
// step's partial by the butterfly), and for a fused head or tail the warps'
// sums in warp order: it differs from the tiled program's order within
// PSI_TOL, and two calls give the same bits.
constexpr int ONE_WARPS = 4;       // warps a block (fused: a small grid 8)
constexpr int ONE_WARPS_MAX = 8;
constexpr int ONE_STAGE = 32;      // rows of a warp's output stage
constexpr int ONE_MAX_ROWS = 32;   // rows of the present side at most
// blocks of ONE_WARPS_MAX warps an SM the registers must allow: 64
// registers a thread up to 16 rows, 80 above (where 64 spilled 60-600
// bytes; 40 and 32 registers measured slower on an NVIDIA H100 80GB HBM3 at
// 700 W, PERF.md §6)
constexpr int MIN_BLOCKS_ONE = 4, MIN_BLOCKS_ONE_WIDE = 3;
constexpr int ONE_ILP = 2;         // samples (sign: draws) hashed side by side
constexpr unsigned FULL = 0xFFFFFFFFu;

struct OneArgs {
  const int* loc;
  const float* e;
  const uint64_t* flat;   // the present side's flat indices
  const uint64_t* salts;  // its salts (Gaussian: r, sign: sd.nnz)
  float* out;             // slabs (n_chunks, span, r) or rows (nw * span, r)
  int64_t nnz;            // fused: nnz; window: n_chunks * chunk
  int chunk;
  int span;
  int r;                  // rows of the present side
  Side sd;
  const int* win;         // window: window id per chunk, non-decreasing
  int n_chunks;
  int n_windows;
  int per_block;          // window: windows a block
};

// The bucket of rows a one-sided call takes (the registers of acc), or 0
// when the call is not one-sided with at most ONE_MAX_ROWS rows (a sign side:
// of rank at most ONE_MAX_ROWS): the tiled block program serves it.
int one_bucket(bool has_l, bool has_r, int r, const Side& sd) {
  if (has_l == has_r) return 0;
  const int rows = sd.kind == SIGN ? sd.rank : r;
  if (r <= 0 || rows > ONE_MAX_ROWS) return 0;
  if (sd.kind == SIGN) return rows <= 16 ? 16 : 32;
  return rows <= 8 ? 8 : rows <= 16 ? 16 : rows <= 24 ? 24 : 32;
}

// The warp's output stage: rows [b0, b0 + ONE_STAGE) of the output rows
// [.., hi) it owns, r floats a row, zero where no run lands.
struct Stage {
  float* buf;   // ONE_STAGE * r floats of shared memory
  float* out;   // output row 0
  int b0, hi, r;

  // rows [b0, min(b0 + ONE_STAGE, hi)) to the output, the stage zeroed for
  // the next ONE_STAGE rows
  __device__ __forceinline__ void flush(int lane) {
    __syncwarp();
    const int n = (min(b0 + ONE_STAGE, hi) - b0) * r;
    float* o = out + (int64_t)b0 * r;
    for (int i = lane; i < n; i += 32) {
      o[i] = buf[i];
      buf[i] = 0.f;
    }
    b0 += ONE_STAGE;
    __syncwarp();
  }
  // flush until `row` (the same in every lane) lies in the stage
  __device__ __forceinline__ void reach(int row, int lane) {
    while (row >= b0 + ONE_STAGE) flush(lane);
  }
  __device__ __forceinline__ void finish(int lane) {
    while (b0 < hi) flush(lane);
  }
};

// The sums of acc over the lanes, in lane 0 (a butterfly); the other
// lanes' acc are left undefined.
template <int RB>
__device__ __forceinline__ void lanes_sum(float (&acc)[RB], int r) {
#pragma unroll
  for (int a = 0; a < RB; ++a) {
    if (a >= r) break;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[a] += __shfl_xor_sync(FULL, acc[a], o);
  }
}

template <int RB, int KIND, bool WIN>
struct OneShared {
  uint64_t salts[ONE_MAX_ROWS];
  float stage[WIN ? ONE_WARPS : ONE_WARPS_MAX][ONE_STAGE * RB];
  float ht[WIN ? 1 : ONE_WARPS_MAX][2][RB];  // fused: head, tail sums
  int ht_row[WIN ? 1 : ONE_WARPS_MAX][2];    // their rows (-1: none)
};

// One warp over the columns [lo, hi) of the stream (a plan chunk's part, or
// a window's run): runs summed as the comment above says.  A row's sums are
// added to its place: the `head` slot for row h_row, the `tail` slot for
// row t_row (a fused part's first and last rows; -1 for the window), else
// the stage, whose rows stay open for adds until a row past them comes.
// Columns past hi repeat t_row (fused); the window's columns past hi, and
// its pads, are row span, which is dropped.
template <int RB, int KIND, bool WIN>
__device__ __forceinline__ void one_part(const OneArgs& a,
                                         const uint64_t* salts, int64_t lo,
                                         int64_t hi, int h_row, int t_row,
                                         Stage& st, float* head, float* tail,
                                         int lane) {
  const int r = a.r, span = a.span;
  float acc[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) acc[i] = 0.f;
  int s_cur = a.loc[lo];  // the open run's row
  bool spread = false;    // acc holds a partial of it over the lanes
  // the place of a row's sums (a stage row must lie in the stage)
  auto place = [&](int row) {
    return row == h_row ? head
           : row == t_row ? tail
                          : st.buf + (row - st.b0) * r;
  };
  auto in_stage = [&](int row) {
    return row == h_row || row == t_row || row < st.b0 + ONE_STAGE;
  };
  // a step's loc, entry and flat index, loaded a step ahead
  int n_lc;
  float n_ek;
  uint64_t n_fl;
  auto fetch = [&](int64_t k) {
    n_lc = WIN ? span : t_row;
    n_ek = 0.f;
    n_fl = 0;
    if (k < hi) {
      n_lc = a.loc[k];
      n_ek = a.e[k];
      n_fl = a.flat[k];
    }
  };
  // the spread partial of the open run added to its place, from lane 0
  auto settle = [&]() {
    lanes_sum<RB>(acc, r);
    if (!in_stage(s_cur)) st.reach(s_cur, lane);
    if (lane == 0) {
      float* o = place(s_cur);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        if (i >= r) break;
        o[i] += acc[i];
      }
    }
    spread = false;
  };
  fetch(lo + lane);
  for (int64_t k0 = lo; k0 < hi; k0 += 32) {
    const int lc = n_lc;
    const float ek = n_ek;
    const uint64_t fl = n_fl;
    if (k0 + 32 < hi) fetch(k0 + 32 + lane);
    const int f = __shfl_sync(FULL, lc, 0), l = __shfl_sync(FULL, lc, 31);
    if (WIN && f >= span) break;  // the rest are pads
    const bool cont = f == l && f == s_cur;
    if (!cont && spread) settle();
    // generate: acc[i] = e * row i of the column (added to acc if the step
    // continues the open run)
    if constexpr (KIND == GAUSS) {
      // ONE_ILP samples a group, hashed side by side; the salts past r
      // read as 0 (a sample that is dropped)
      const uint64_t base = fl + tt_rng::HASH_ADD;
#pragma unroll
      for (int i0 = 0; i0 < RB; i0 += ONE_ILP) {
        if (i0 >= r) break;
        float p[ONE_ILP];
#pragma unroll
        for (int j = 0; j < ONE_ILP; ++j) {
          p[j] = ek * tt_rng::normal_from_hash(
                          tt_rng::mix64(base + salts[i0 + j]));
        }
#pragma unroll
        for (int j = 0; j < ONE_ILP; ++j) {
          if (i0 + j < r) acc[i0 + j] = cont ? acc[i0 + j] + p[j] : p[j];
        }
      }
    } else {
      const tt_rng::SignWord<RB> w =
          tt_rng::sign_column_word<RB, ONE_ILP, true>(fl, salts, a.sd.rank,
                                                      a.sd.nnz) >>
          (2 * a.sd.rank_min);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        if (i >= r) break;
        const float p = tt_rng::sign_slot((uint32_t)(w >> (2 * i))) * ek;
        acc[i] = cont ? acc[i] + p : p;
      }
    }
    if (cont) {
      spread = true;
      continue;
    }
    // the step's runs: a run's sum onto its first lane, in a fixed order
    // (a suffix sum over the lanes of equal loc, as many rounds as the
    // longest run needs), then added to the run's row
    const int up = __shfl_up_sync(FULL, lc, 1);
    const bool first = lane == 0 || up != lc;
    const unsigned starts = __ballot_sync(FULL, first);
    const unsigned above = lane == 31 ? 0u : starts >> (lane + 1);
    const int run = first ? (above ? __ffs(above) : 32 - lane) : 0;
    const int longest = __reduce_max_sync(FULL, run);
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int o = 1 << j;
      if (o >= longest) break;
      const bool same = __shfl_down_sync(FULL, lc, o) == lc && lane + o < 32;
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        if (i >= r) break;
        const float y = __shfl_down_sync(FULL, acc[i], o);
        if (same) acc[i] += y;
      }
    }
    bool pend = first && !(WIN && lc >= span);
    while (__any_sync(FULL, pend)) {
      if (pend && in_stage(lc)) {
        float* o = place(lc);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          if (i >= r) break;
          o[i] += acc[i];
        }
        pend = false;
      }
      if (__any_sync(FULL, pend)) st.flush(lane);
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[i] = 0.f;
    s_cur = l;
  }
  if (spread && !(WIN && s_cur >= span)) settle();
  st.finish(lane);
}

// The first index in [0, n) whose value is >= key in the non-decreasing v
// (n if none), 32 probes a round, one a lane.
__device__ __forceinline__ int lower_bound_warp(const int* v, int n, int key,
                                                int lane) {
  int lo = 0, hi = n;  // v[i] < key below lo, >= key from hi
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    const int cnt = __popc(__ballot_sync(FULL, p < hi && v[p] < key));
    if (cnt == 0) {
      hi = lo;
    } else {
      const int nhi = lo + cnt * step;
      lo += (cnt - 1) * step + 1;
      hi = min(hi, nhi);
    }
  }
  return lo;
}

template <int RB, int KIND, bool WIN>
__global__ void __launch_bounds__(ONE_WARPS_MAX * 32,
                                  RB > 16 ? MIN_BLOCKS_ONE_WIDE
                                          : MIN_BLOCKS_ONE)
    oneside_kernel(OneArgs a) {
  __shared__ OneShared<RB, KIND, WIN> sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int r = a.r, span = a.span;
  const int n_salts = KIND == SIGN ? a.sd.nnz : r;
  for (int i = tid; i < ONE_MAX_ROWS; i += blockDim.x) {
    sh.salts[i] = i < n_salts ? a.salts[i] : 0;
  }
  float* const buf = sh.stage[warp];
  for (int i = lane; i < ONE_STAGE * RB; i += 32) buf[i] = 0.f;
  __syncthreads();
  if (WIN) {
    // this block's windows, one a warp at a time
    const int w0 = blockIdx.x * a.per_block;
    const int w1 = min(w0 + a.per_block, a.n_windows);
    for (int w = w0 + warp; w < w1; w += n_warps) {
      const int c_lo = lower_bound_warp(a.win, a.n_chunks, w, lane);
      int c_hi = c_lo;
      for (;;) {
        const int c = c_hi + lane;
        const int cnt = __popc(
            __ballot_sync(FULL, c < a.n_chunks && a.win[c] == w));
        c_hi += cnt;
        if (cnt < 32) break;
      }
      Stage st{buf, a.out + (int64_t)w * span * r, 0, span, r};
      const int64_t lo = (int64_t)c_lo * a.chunk;
      const int64_t hi = min((int64_t)c_hi * a.chunk, a.nnz);
      if (lo < hi) {
        one_part<RB, KIND, WIN>(a, sh.salts, lo, hi, -1, -1, st, nullptr,
                                nullptr, lane);
      } else {
        st.finish(lane);  // an empty window: span rows of zeros
      }
    }
    return;
  }
  // the chunk's range in n_warps contiguous parts of whole steps
  const int64_t g = blockIdx.x;
  const int64_t start = g * a.chunk, end = min(start + a.chunk, a.nnz);
  const int64_t n = end > start ? end - start : 0;
  const int64_t q = ((n + n_warps - 1) / n_warps + 31) / 32 * 32;
  const int64_t lo = start + warp * q, hi = min(lo + q, end);
  float* const slab = a.out + g * span * r;
  const int h_row = lo < hi ? a.loc[lo] : -1;
  const int t_row = lo < hi ? a.loc[hi - 1] : -1;
  for (int i = lane; i < 2 * RB; i += 32) sh.ht[warp][i / RB][i % RB] = 0.f;
  if (lane == 0) {
    sh.ht_row[warp][0] = h_row;
    sh.ht_row[warp][1] = t_row != h_row ? t_row : -1;
  }
  __syncwarp();
  if (lo < hi) {
    Stage st{buf, slab, h_row + 1, t_row, r};
    one_part<RB, KIND, WIN>(a, sh.salts, lo, hi, h_row, t_row, st,
                            sh.ht[warp][0], sh.ht[warp][1], lane);
  }
  __syncthreads();
  if (warp != 0) return;
  // warp 0: the heads and tails in warp order, each row stored once, and
  // zeros on the rows between a warp's tail and the next head
  int cur = -1;       // the row being summed
  float sum = 0.f;    // its element `lane` (lane < r)
  bool owned = false; // the rows after cur up to the next entry are a warp's
  int done = 0;       // rows below done are stored
  auto zero_to = [&](int row) {  // rows [done, row) are zero
    const int64_t z0 = (int64_t)done * r, z1 = (int64_t)row * r;
    for (int64_t i = z0 + lane; i < z1; i += 32) slab[i] = 0.f;
  };
  for (int u = 0; u < 2 * n_warps; ++u) {
    const int row = sh.ht_row[u >> 1][u & 1];
    if (row < 0) continue;
    const float v = lane < r ? sh.ht[u >> 1][u & 1][lane] : 0.f;
    if (row == cur) {
      sum += v;
    } else {
      if (cur >= 0) {
        if (lane < r) slab[(int64_t)cur * r + lane] = sum;
        done = cur + 1;
      }
      if (!owned) zero_to(row);
      cur = row;
      sum = v;
    }
    // a head followed by its own warp's tail: the rows between are the
    // warp's
    owned = (u & 1) == 0 && sh.ht_row[u >> 1][1] >= 0;
    if (!owned) done = row + 1;
  }
  if (cur >= 0 && lane < r) slab[(int64_t)cur * r + lane] = sum;
  done = cur + 1;
  zero_to(span);
}

// The grid of a one-sided call: the window kernel takes the blocks of
// ONE_WARPS warps the card holds at once (at most one a ONE_WARPS windows),
// each a contiguous run of per_block windows; the fused kernel one block a
// chunk, of ONE_WARPS_MAX warps where they all fit the card at once, else
// of ONE_WARPS.
template <int RB, int KIND, bool WIN>
cudaError_t one_grid(int64_t n, int64_t* n_blocks, int* warps,
                     int* per_block) {
  int n_sm = 0, per_sm = 0;
  tt_runtime::sm_count(&n_sm);
  *warps = WIN ? ONE_WARPS : ONE_WARPS_MAX;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, oneside_kernel<RB, KIND, WIN>, *warps * 32, 0);
  if (err != cudaSuccess) return err;
  const int64_t fit = (int64_t)(n_sm > 0 ? n_sm : 1) * (per_sm > 0 ? per_sm : 1);
  *per_block = 0;
  if (!WIN) {
    *n_blocks = n;
    if (n > fit) *warps = ONE_WARPS;
    return cudaSuccess;
  }
  const int64_t want = (n + ONE_WARPS - 1) / ONE_WARPS;
  const int64_t b = want < fit ? want : fit;
  *per_block = (int)((n + b - 1) / b);
  *n_blocks = (n + *per_block - 1) / *per_block;
  return cudaSuccess;
}

template <int RB, int KIND, bool WIN>
cudaError_t launch_one_bucket(OneArgs a, int64_t n_blocks,
                              cudaStream_t stream) {
  int warps = 0;
  cudaError_t err = one_grid<RB, KIND, WIN>(WIN ? a.n_windows : n_blocks,
                                            &n_blocks, &warps, &a.per_block);
  if (err != cudaSuccess) return err;
  oneside_kernel<RB, KIND, WIN><<<(unsigned)n_blocks, warps * 32, 0,
                                  stream>>>(a);
  return cudaGetLastError();
}

// A one-sided call on its instance: the bucket of its rows, a Gaussian or a
// sign side.
template <bool WIN>
cudaError_t launch_one(OneArgs a, int bucket, int64_t n_blocks,
                       cudaStream_t stream) {
  if (n_blocks <= 0 || n_blocks > 0x7FFFFFFF || bad_side(a.sd, a.r)) {
    return cudaErrorInvalidValue;
  }
  if (a.sd.kind == SIGN) {
    return bucket == 16 ? launch_one_bucket<16, SIGN, WIN>(a, n_blocks, stream)
                        : launch_one_bucket<32, SIGN, WIN>(a, n_blocks, stream);
  }
  return bucket == 8 ? launch_one_bucket<8, GAUSS, WIN>(a, n_blocks, stream)
         : bucket == 16
             ? launch_one_bucket<16, GAUSS, WIN>(a, n_blocks, stream)
         : bucket == 24
             ? launch_one_bucket<24, GAUSS, WIN>(a, n_blocks, stream)
             : launch_one_bucket<32, GAUSS, WIN>(a, n_blocks, stream);
}

// A side's generator from the caller's int[4] {SIGN, rank, nnz, rank_min}
// (NULL: lazy-Gaussian).
Side side_of(const int* spec) {
  if (!spec) return Side{GAUSS, 0, 0, 0};
  return Side{spec[0], spec[1], spec[2], spec[3]};
}

// A one-sided call's operands: the present side's streams, rows and spec.
OneArgs one_args(const int* loc, const float* e, const uint64_t* lflat,
                 const uint64_t* rflat, const uint64_t* lsalts,
                 const uint64_t* rsalts, float* out, int64_t nnz, int chunk,
                 int span, int r1, int r2, const int* lspec,
                 const int* rspec) {
  const bool left = lflat != nullptr;
  OneArgs o{};
  o.loc = loc;
  o.e = e;
  o.flat = left ? lflat : rflat;
  o.salts = left ? lsalts : rsalts;
  o.out = out;
  o.nnz = nnz;
  o.chunk = chunk;
  o.span = span;
  o.r = left ? r1 : r2;
  o.sd = side_of(left ? lspec : rspec);
  return o;
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
  const int bucket = one_bucket(lflat, rflat, lflat ? r1 : r2,
                                lflat ? a.ls : a.rs);
  if (bucket) {
    return (int)launch_one<false>(
        one_args(loc, e, lflat, rflat, lsalts, rsalts, slabs, nnz, chunk,
                 span, r1, r2, lspec, rspec),
        bucket, n_chunks, st);
  }
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
  Args a{loc, e, nullptr, rflat, nullptr, nullptr, rsalts, nullptr,
         slabs, nullptr, nnz, chunk, span, r1, r2, 0,
         side_of(nullptr), rrows ? side_of(nullptr) : side_of(rspec),
         side_of(nullptr), nullptr, nullptr, n_chunks, lrows, rrows};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (lrows && rrows) {
    err = launch_given<true, true, GV_RIGHT>(a, n_chunks, st);
  } else if (rrows) {
    err = launch_given<false, true, GV_RIGHT>(a, n_chunks, st);
  } else if (lrows && rflat) {
    err = launch_given<true, true, GV_LEFT>(a, n_chunks, st);
  } else if (rflat) {
    err = launch_given<false, true, GV_LEFT>(a, n_chunks, st);
  } else {
    err = launch_given<true, false, GV_LEFT>(a, n_chunks, st);
  }
  return (int)err;
}

// The schedule tt_psi_chunk_slabs takes on the current device for a call
// with the given sides present (lrows, rrows, rflat: 0 or 1) and n_chunks
// chunks: out[5] = {TS, G, TG, NS, shared-memory bytes}.
int tt_psi_given_schedule(int lrows, int rrows, int rflat, int n_chunks,
                          int r1, int r2, const int* rspec, int* out) {
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, nullptr, 1, 1, 1, r1, r2, 0,
         side_of(nullptr), rrows ? side_of(nullptr) : side_of(rspec),
         side_of(nullptr), nullptr, nullptr, n_chunks};
  size_t bytes;
  if (lrows && rrows) {
    a.sc = schedule_given<true, true, GV_RIGHT>(a, n_chunks);
    bytes = layout<true, true, true, false, GV_RIGHT>(a).bytes;
  } else if (rrows) {
    a.sc = schedule_given<false, true, GV_RIGHT>(a, n_chunks);
    bytes = layout<false, true, true, false, GV_RIGHT>(a).bytes;
  } else if (lrows && rflat) {
    a.sc = schedule_given<true, true, GV_LEFT>(a, n_chunks);
    bytes = layout<true, true, true, false, GV_LEFT>(a).bytes;
  } else if (rflat) {
    a.sc = schedule_given<false, true, GV_LEFT>(a, n_chunks);
    bytes = layout<false, true, true, false, GV_LEFT>(a).bytes;
  } else {
    a.sc = schedule_given<true, false, GV_LEFT>(a, n_chunks);
    bytes = layout<true, false, true, false, GV_LEFT>(a).bytes;
  }
  out[0] = a.sc.TS, out[1] = a.sc.G, out[2] = a.sc.TG, out[3] = a.sc.NS;
  out[4] = (int)bytes;
  return (int)cudaGetLastError();
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
  const int bucket = one_bucket(lflat, rflat, lflat ? r1 : r2,
                                lflat ? a.ls : a.rs);
  if (bucket) {
    OneArgs o = one_args(loc, e, lflat, rflat, lsalts, rsalts, psi, a.nnz,
                         chunk, span, r1, r2, lspec, rspec);
    o.win = win;
    o.n_chunks = n_chunks;
    o.n_windows = n_windows;
    return (int)launch_one<true>(o, bucket, n_windows, st);
  }
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

// The program a call of tt_psi_fused_slabs (window 0; n: its chunks) or of
// tt_psi_window_direct (window 1; n: its windows) takes with the given sides
// present (has_l, has_r: 0 or 1): out[4] = {the one-sided instance's bucket
// of rows (0: the tiled block program), threads a block, blocks, windows a
// block (the window kernel; else 0)}.
int tt_psi_oneside_schedule(int window, int has_l, int has_r, int r1, int r2,
                            const int* lspec, const int* rspec, int n,
                            int* out) {
  const Side sd = side_of(has_l ? lspec : rspec);
  const int bucket = one_bucket(has_l, has_r, has_l ? r1 : r2, sd);
  int64_t blocks = n;
  int warps = THREADS / 32, per = 0;
  cudaError_t err = cudaSuccess;
  if (bucket) {
    const bool sign = sd.kind == SIGN;
#define ONE_GRID(RB, KIND)                                                 \
  (window ? one_grid<RB, KIND, true>(n, &blocks, &warps, &per)             \
          : one_grid<RB, KIND, false>(n, &blocks, &warps, &per))
    err = sign ? (bucket == 16 ? ONE_GRID(16, SIGN) : ONE_GRID(32, SIGN))
          : bucket == 8  ? ONE_GRID(8, GAUSS)
          : bucket == 16 ? ONE_GRID(16, GAUSS)
          : bucket == 24 ? ONE_GRID(24, GAUSS)
                         : ONE_GRID(32, GAUSS);
#undef ONE_GRID
  }
  out[0] = bucket;
  out[1] = warps * 32;
  out[2] = (int)blocks;
  out[3] = per;
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

}  // extern "C"
