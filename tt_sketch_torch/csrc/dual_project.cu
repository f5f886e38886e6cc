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
// What bounds it.  Per element of X the kernel reads 4 bytes and does
// 2 (r + rho) flops, 48 flop/byte at the main-path shape (r = 32, rho = 64).
// On the CUDA cores (67 TFLOP/s fp32) that is bound by operations, 1.54 ms
// for one 2.15 GB slab.  On the TF32 tensor cores (495 TFLOP/s dense, data
// sheet) fp32 accuracy takes three products per flop (3xTF32, below): 0.62
// ms, under the 0.65 ms that the slab's bytes take at 3.35 TB/s, so the
// bound is the bytes.  This kernel uses warp-level mma.sync, which reaches
// a part of that rate only, and in f32 mode its warps read about fifteen
// times an X tile's bytes from shared memory per tile (each R fragment is
// read by four warps, each L fragment by all eight, both split in two), so
// operations and shared memory, not device memory, still set its pace.
//
// What the design does about it.
//   - Products on the tensor cores: mma.sync m16n8k8 TF32, fp32 accumulate.
//     f32 mode splits each operand x = big + small, big = x rounded to TF32
//     (nearest, ties away) and small = the same rounding of x - big, which
//     is exact in fp32; it sums small*big + big*small + big*big and drops
//     small*small, a relative error near 2^-21 per product.  bf16 mode
//     rounds the operands to bf16, which TF32 holds exactly, and takes one
//     product: a third of the f32 mode's tensor work.
//   - Few instructions per mma.  The rounding is an integer add and mask
//     (ptxas expands cvt.rna.tf32.f32 into a test for inf and NaN, a
//     select and the mask).  R is split once per column tile and L once per
//     block, both into fragment order, so a fragment is one 16-byte load
//     into an aligned register quad.  X is split where its fragments are
//     read: cp.async lands raw bytes, each X element feeds one warp per
//     product, so splitting on staging would cost the same conversions and
//     double the ring's shared memory.  T's X fragments come from one
//     ldmatrix per k-step.
//   - No bank conflicts: the X tile is stored with its columns swizzled by
//     the row (swz below), so T's row-wise and U's column-wise fragment
//     reads, ldmatrix and the cp.async stores all hit distinct banks.
//   - X is read from device memory once, by 16-byte cp.async into a ring of
//     3-6 tiles (whatever shared memory R and L leave), two or more tiles
//     ahead of the tensor cores.  Shapes with S % 4 != 0 or a misaligned X
//     take synchronous scalar loads into the same ring.
//   - Short chained sums.  The tensor cores add with truncation inside an
//     mma; each X tile's T products go to a fresh accumulator that is added
//     to the running sum in fp32, and U chains over one column tile's rows.
//
// Schedule.  The TPU kernel relied on a sequential grid to keep U resident
// across its inner sweep.  Here blocks run in parallel, so each block owns
// RB = 256 consecutive rows of X (128 blocks, one wave, at the main shape)
// and walks all of S in column tiles of BN, BM rows at a time:
//   - T rows of the block accumulate in registers over the whole walk and
//     are written once; no reduction is needed for T.
//   - U for the current column tile accumulates in registers over the
//     block's rows and is written as a per-block partial Upart[g] (r, S).
//     A second kernel sums the partials over the blocks in a fixed order.
//     At the main shape the partials are a quarter of X's bytes, written
//     and read back.
// Both outputs are therefore deterministic: the same inputs give the same
// bits on every run.  One U k-step runs beside two T k-steps, so a warp
// has two independent chains of mma in flight.
//
// Ranks: one launch takes r <= 32 and rho <= 64 (zero-padded below that);
// the wrapper splits larger ranks into several launches.  Ragged P and S
// are masked: any shape is taken.  bf16 mode rounds X, R and L to bfloat16
// and accumulates in fp32, like the TPU kernel's mxu_dtype=bfloat16.
//
// The projector diagnostics (tt_sketch_torch/kernels/projector_diag.py)
// live here too, so that they measure this kernel's own design:
//   - tt_t_only and tt_u_only launch the same kernel with only its T half
//     (WANT_U = false) or only its U half (WANT_T = false): the same tile,
//     block, rounding, U partials and rank limits, with the shared memory
//     of the missing half spent on more X stages.  They replace
//     scripts/bench_projector_diag.py:t_only and :u_only.  Both are bound
//     by bytes on the tensor cores (T alone: 3xTF32 at rho = 64, 0.42 ms of
//     products against 0.64 ms of bytes per slab).
//   - tt_reduce_read is a read-once pass that writes the row sums of X, and
//     replaces scripts/bench_projector_diag.py:reduce_read.  It is bound by
//     bytes (0.64 ms per slab) and its time is the card's read floor for X.
//     Persistent blocks (at most as many as the card holds at once, each
//     with as many rows as the others, up to one) walk the rows
//     blockIdx.x, blockIdx.x + gridDim.x, ...; a row is read in rounds of
//     eight 16-byte streaming loads a thread, and the loads of the next
//     round (of this row or the next) are issued before the current round
//     is summed, so a row's block reduction overlaps the next row's loads.
//     Sums in a fixed order (deterministic).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "runtime.cuh"

namespace {

constexpr int BM = 64;              // rows of X per tile
constexpr int BN = 128;             // columns of X per tile
constexpr int ROW_TILES = 4;        // row tiles owned by a block
constexpr int RB = BM * ROW_TILES;  // rows of X owned by a block
constexpr int R_MAX = 32;           // columns of L per launch
constexpr int RHO_MAX = 64;         // columns of R per launch
constexpr int THREADS = 256;        // 8 warps
constexpr int X_TILE = BM * BN;     // floats of one X tile (swizzled, no pad)
constexpr int L_PLANE = RB * R_MAX;  // the block's L, one split part
constexpr int SMEM_FLOATS = 57344;   // 224 KB of the 227 a block may have
static_assert(BN == 2 * BM, "a U k-step runs beside two T k-steps");

// The R tile in fragment order holds two floats a lane (bf16) or four (f32:
// big and small); the block's L one plane or two.
template <bool BF16>
__host__ __device__ constexpr int parts() { return BF16 ? 1 : 2; }
template <bool BF16, bool WANT_T, bool WANT_U>
__host__ __device__ constexpr int side_floats() {
  return (WANT_T ? parts<BF16>() * BN * RHO_MAX : 0) +
         (WANT_U ? parts<BF16>() * L_PLANE : 0);
}
// X tiles in the cp.async ring: whatever shared memory R and L leave (3 in
// the fused f32 instance, 5-6 in the others).
template <bool BF16, bool WANT_T, bool WANT_U>
__host__ __device__ constexpr int stages() {
  return (SMEM_FLOATS - side_floats<BF16, WANT_T, WANT_U>()) / X_TILE;
}
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

// v rounded to bfloat16 (nearest, ties to even), back in fp32.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The TF32 rounding of cvt.rna.tf32.f32 (10 mantissa bits, nearest, ties
// away from zero) before the mask of the low 13 bits: adding half a TF32
// ulp to the magnitude bits carries into the kept bits exactly when the
// dropped ones are at least half.  Hopper has no instruction for the cvt
// (ptxas expands it with a test for inf and NaN, a select and the mask);
// this is one add.  The tensor cores read the top 19 bits of a TF32
// operand only.
__device__ __forceinline__ uint32_t tf32_unmasked(float x) {
  return __float_as_uint(x) + 0x1000u;
}

// An operand as the tensor cores take it: f32 mode splits x = big + small
// (both TF32; x - big is exact in fp32; small is passed unmasked, as
// ptxas's own expansion of cvt.rna.tf32.f32 does for an mma operand), bf16
// mode rounds x to bf16, which TF32 holds exactly (small unused).
template <bool BF16>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  if constexpr (BF16) {
    big = __float_as_uint(bf16_round(x));
  } else {
    big = tf32_unmasked(x) & 0xffffe000u;
    small = tf32_unmasked(x - __uint_as_float(big));
  }
}

// d += a @ b on one 16x8x8 TF32 tile, fp32 accumulate.
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a @ b with the operands as split<BF16> gives them: three products
// in f32 mode (the small terms first, small @ small dropped), one in bf16.
template <bool BF16>
__device__ __forceinline__ void mma3(float* d, const uint32_t* ab,
                                     const uint32_t* as, const uint32_t* bb,
                                     const uint32_t* bs) {
  if constexpr (!BF16) {
    mma(d, as, bb);
    mma(d, ab, bs);
  }
  mma(d, ab, bb);
}

// Column swizzle of the X tile: element (row, col) lies at
// row * BN + (col ^ swz(row)).  It permutes bits 2-4 of the column by the
// row's low three bits, so 16-byte chunks stay whole, and both fragment
// reads of a warp hit 32 distinct banks: the T side reads rows g, columns
// t (A operand), the U side rows t, columns g (B operand), g < 8, t < 4.
__device__ __forceinline__ int swz(int row) {
  return ((row & 3) << 3) | (row & 4);
}

// The four 32-bit A fragments of a 16x8 TF32 tile from a row-major tile
// in shared memory: lane l gives the address of row l % 8 of matrix l / 8
// (rows 0-7 and 8-15 at columns 0-3, then the same at columns 4-7).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* d, const float* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a));
}

// 16 bytes from global to shared memory without passing through registers;
// in == false writes 16 zero bytes and reads nothing (src-size 0).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
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

// Start loading one tile of X: rows [row_base, row_base + BM), columns
// [col0, col0 + BN), zero outside (P, S); raw fp32 (the fragment reads
// round and split).  vec (S % 4 == 0 and X 16-byte aligned, so s < S
// implies s + 3 < S): 16-byte cp.async, in flight until waited for; warp
// w copies rows w + 8 q, lane l columns 4 l .. 4 l + 3, so a thread's
// addresses move by a fixed stride.  Otherwise scalar loads, complete on
// return.
__device__ __forceinline__ void load_x_tile(float* Xs, const float* X, int P,
                                            int S, int row_base, int col0,
                                            bool vec) {
  const int tid = threadIdx.x;
  static_assert(THREADS == 8 * 32 && BN == 4 * 32, "one row a warp");
  if (vec) {
    const int warp = tid / 32;
    const int row = row_base + warp;
    const int s = col0 + 4 * (tid % 32);
    const float* src = X + (size_t)row * S + s;
    float* dst = Xs + warp * BN + ((4 * (tid % 32)) ^ swz(warp));
    const size_t stride = (size_t)8 * S;
#pragma unroll
    for (int q = 0; q < BM / 8; ++q) {
      const bool in = s < S && row + 8 * q < P;
      cp_async16(dst + q * 8 * BN, in ? src + q * stride : X, in);
    }
  } else {
    for (int idx = tid; idx < X_TILE; idx += THREADS) {
      const int i = idx / BN;
      const int c = idx % BN;
      const int row = row_base + i;
      const int s = col0 + c;
      Xs[i * BN + (c ^ swz(i))] =
          (row < P && s < S) ? __ldcs(X + (size_t)row * S + s) : 0.f;
    }
  }
}

// WANT_T / WANT_U select the halves; dual_project launches both.
template <bool BF16, bool WANT_T, bool WANT_U>
__global__ void __launch_bounds__(THREADS, 1)
dual_project_kernel(const float* __restrict__ X, const float* __restrict__ R,
                    const float* __restrict__ L, float* __restrict__ T,
                    float* __restrict__ Upart, int P, int S, int r, int rho,
                    int s_pad, bool vec) {
  constexpr int STAGES = stages<BF16, WANT_T, WANT_U>();
  constexpr int PARTS = parts<BF16>();
  extern __shared__ __align__(16) float smem[];
  float* Xring = smem;                  // STAGES x [BM][BN], swizzled
  float* Rf = Xring + STAGES * X_TILE;  // R tile, split, fragment order
  float* Lb = Rf + (WANT_T ? PARTS * BN * RHO_MAX : 0);  // L, big parts
  float* Lsm = Lb + L_PLANE;            // L, small parts (f32 mode)

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in the group
  const int row0 = blockIdx.x * RB;

  // The X tiles in walk order: q = jt * ROW_TILES + it.  The first
  // STAGES - 1 start now; one group is committed per tile, empty or not.
  const int n_col_tiles = (S + BN - 1) / BN;
  const int n_tiles = n_col_tiles * ROW_TILES;
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) {
    if (q < n_tiles)
      load_x_tile(Xring + q * X_TILE, X, P, S, row0 + (q % ROW_TILES) * BM,
                  (q / ROW_TILES) * BN, vec);
    cp_async_commit();
  }

  // The block's rows of L, split once, in the order of U's A fragments
  // (see below): per k-step ks of 8 rows and m16 tile i, lane (g, t) holds
  // L[8 ks + t, c], L[8 ks + t, c + 1], L[8 ks + t + 4, c], L[8 ks + t + 4,
  // c + 1] with c = 4 g + 2 i, one 16-byte load that lands in an aligned
  // register quad.  Zero beyond P and r.  All loads of a thread are issued
  // before its first store.
  if constexpr (WANT_U) {
    constexpr int N = RB * R_MAX / (4 * THREADS);
    float v[N][4];
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int f = warp + 8 * q;  // 2 ks + i
      const int c = 4 * g + 2 * (f % 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (f / 2) + t + 4 * (e / 2);
        const int k = c + e % 2;
        v[q][e] = (row < P && k < r) ? L[(size_t)row * r + k] : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < N; ++q) {
      uint32_t big[4], small[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < 4; ++e) split<BF16>(v[q][e], big[e], small[e]);
      const int o = ((warp + 8 * q) * 32 + lane) * 4;
      *reinterpret_cast<uint4*>(Lb + o) = make_uint4(big[0], big[1], big[2], big[3]);
      if constexpr (!BF16)
        *reinterpret_cast<uint4*>(Lsm + o) =
            make_uint4(small[0], small[1], small[2], small[3]);
    }
  }

  // T: warp owns tile rows [tm, tm + 16) and the four n8 tiles [tj, tj + 4)
  // of R's columns.  Its A fragments come from one ldmatrix per k-step:
  // lane l points at row tm + l % 8 + 8 (l / 8 % 2), columns k0 + 4 (l / 16)
  // + (0..3); the swizzle of those rows depends on l % 8 only, and k0 is a
  // multiple of 8, so four offsets per lane cover k0 % 32.
  const int tm = (warp % 4) * 16;
  const int tj = (warp / 4) * 4;
  int a_off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    a_off[j] = (tm + lane % 8 + 8 * (lane / 8 % 2)) * BN +
               ((8 * j + 4 * (lane / 16)) ^ swz(lane % 8));
  // U: warp owns tile columns [un, un + 16) and all r <= 32 rows of U.
  // The rows and columns of its mma tiles are permuted so that stores and
  // X loads are vectors: m16 tile i, row slot g (+ 8 h) is U row 4 g + 2 i
  // + h, and n8 tile j, column slot n is tile column un + 2 n + j.  A
  // thread then reads X row k, columns un + 2 g, un + 2 g + 1 (one 8-byte
  // load for both n8 tiles), and owns a 4x4 block of U: rows 4 g .. 4 g +
  // 3, columns un + 4 t .. un + 4 t + 3.
  const int un = warp * 16;
  const int bx0 = t * BN + ((un + 2 * g) ^ swz(t));
  const int bx4 = (t + 4) * BN + ((un + 2 * g) ^ swz(t + 4));

  float tacc[ROW_TILES][4][4];
#pragma unroll
  for (int it = 0; it < ROW_TILES; ++it)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tacc[it][j][e] = 0.f;

  for (int jt = 0; jt < n_col_tiles; ++jt) {
    const int col0 = jt * BN;
    // R for the column tile: warp w stages n8 tile w, lane (g, t) the rows
    // col0 + 8 kk + t and + 4 of column 8 w + g for every k-step kk.  All
    // loads of a thread are issued at once, before the wait for the X
    // tile, so their latencies overlap.
    constexpr int NR = BN / 8;
    float rv[NR][2];
    if constexpr (WANT_T) {
      const int c = 8 * warp + g;
#pragma unroll
      for (int kk = 0; kk < NR; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = col0 + 8 * kk + t + 4 * h;
          rv[kk][h] = (s < S && c < rho) ? R[(size_t)s * rho + c] : 0.f;
        }
    }

    float uacc[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) uacc[i][j][e] = 0.f;

#pragma unroll
    for (int it = 0; it < ROW_TILES; ++it) {
      const int q = jt * ROW_TILES + it;
      cp_async_wait<STAGES - 2>();  // this thread's copies of tile q landed
      // Every thread's copies of tile q are visible, and every warp is done
      // with tile q - 1, whose stage the next load takes.
      __syncthreads();
      const int qn = q + STAGES - 1;
      if (qn < n_tiles)
        load_x_tile(Xring + (qn % STAGES) * X_TILE, X, P, S,
                    row0 + (qn % ROW_TILES) * BM, (qn / ROW_TILES) * BN, vec);
      cp_async_commit();
      if constexpr (WANT_T) {
        if (it == 0) {
          // The previous column tile's reads of Rf are done.  Split R once
          // for every row tile of this one: per k-step and n8 tile, lane
          // (g, t) holds (big b0, big b1, small b0, small b1), or the
          // rounded (b0, b1) in bf16 mode.
#pragma unroll
          for (int kk = 0; kk < NR; ++kk) {
            uint32_t big[2], small[2] = {0, 0};
            split<BF16>(rv[kk][0], big[0], small[0]);
            split<BF16>(rv[kk][1], big[1], small[1]);
            float* dst = Rf + ((kk * 8 + warp) * 32 + lane) * 2 * PARTS;
            if constexpr (BF16) {
              *reinterpret_cast<float2*>(dst) = make_float2(
                  __uint_as_float(big[0]), __uint_as_float(big[1]));
            } else {
              *reinterpret_cast<float4*>(dst) = make_float4(
                  __uint_as_float(big[0]), __uint_as_float(big[1]),
                  __uint_as_float(small[0]), __uint_as_float(small[1]));
            }
          }
          __syncthreads();
        }
      }
      const float* Xs = Xring + (q % STAGES) * X_TILE;

      // U[:, tile] += L[tile rows]^T @ X_tile (M = r in two m16, N = 16
      // columns a warp, K = BM rows) and T[tile rows] += X_tile @ R[tile
      // columns] (M = 16 rows a warp, N = 32 columns, K = BN), one U k-step
      // beside two T k-steps: two independent chains of mma.  U chains over
      // the column tile's RB rows (96 products in f32 mode); T's products
      // go to a fresh accumulator per tile, added to tacc in fp32, so that
      // the tensor cores' chained sums stay short.
      float tpart[4][4] = {};
#pragma unroll
      for (int ku = 0; ku < BM / 8; ++ku) {
        if constexpr (WANT_U) {
          const float* xs = Xs + ku * 8 * BN;
          const float2 x0 = *reinterpret_cast<const float2*>(xs + bx0);
          const float2 x4 = *reinterpret_cast<const float2*>(xs + bx4);
          uint32_t bb[2][2], bs[2][2];
          split<BF16>(x0.x, bb[0][0], bs[0][0]);
          split<BF16>(x0.y, bb[1][0], bs[1][0]);
          split<BF16>(x4.x, bb[0][1], bs[0][1]);
          split<BF16>(x4.y, bb[1][1], bs[1][1]);
          uint4 ab[2], as[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int o = (((it * BM / 8 + ku) * 2 + i) * 32 + lane) * 4;
            ab[i] = *reinterpret_cast<const uint4*>(Lb + o);
            if constexpr (!BF16) as[i] = *reinterpret_cast<const uint4*>(Lsm + o);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              mma3<BF16>(uacc[i][j], &ab[i].x, &as[i].x, bb[j], bs[j]);
        }
        if constexpr (WANT_T) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kk = 2 * ku + h;
            uint32_t xa[4], ab[4], as[4];
            ldmatrix_x4(xa, Xs + (kk / 4) * 32 + a_off[kk % 4]);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split<BF16>(__uint_as_float(xa[e]), ab[e], as[e]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float* rf = Rf + ((kk * 8 + tj + j) * 32 + lane) * 2 * PARTS;
              uint32_t bb[2], bs[2];
              if constexpr (BF16) {
                const float2 b = *reinterpret_cast<const float2*>(rf);
                bb[0] = __float_as_uint(b.x);
                bb[1] = __float_as_uint(b.y);
              } else {
                const float4 b = *reinterpret_cast<const float4*>(rf);
                bb[0] = __float_as_uint(b.x);
                bb[1] = __float_as_uint(b.y);
                bs[0] = __float_as_uint(b.z);
                bs[1] = __float_as_uint(b.w);
              }
              mma3<BF16>(tpart[j], ab, as, bb, bs);
            }
          }
        }
      }
      if constexpr (WANT_T) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tacc[it][j][e] += tpart[j][e];
      }
    }

    // This block's partial of U for the column tile: the thread's 4x4 block
    // (rows 4 g + 2 i + h, columns col0 + un + 4 t + (0..3)).  s_pad is a
    // multiple of BN, so the float4 stores stay in bounds and aligned.
    if constexpr (WANT_U) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 4 * g + 2 * i + h;
          if (k < r) {
            *reinterpret_cast<float4*>(
                Upart + ((size_t)blockIdx.x * r + k) * s_pad + col0 + un +
                4 * t) =
                make_float4(uacc[i][0][2 * h], uacc[i][1][2 * h],
                            uacc[i][0][2 * h + 1], uacc[i][1][2 * h + 1]);
          }
        }
    }
  }

  if constexpr (WANT_T) {
#pragma unroll
    for (int it = 0; it < ROW_TILES; ++it)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + it * BM + tm + g + 8 * h;
        if (row < P) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * (tj + j) + 2 * t + e;
              if (c < rho) T[(size_t)row * rho + c] = tacc[it][j][2 * h + e];
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

// Row sums of X by persistent blocks; VEC: S % 4 == 0 and X 16-byte
// aligned, so every row starts 16-byte aligned and is read as float4.
constexpr int READ_THREADS = 256;
constexpr int READ_UNROLL = 8;  // loads in flight per thread

template <bool VEC>
__global__ void __launch_bounds__(READ_THREADS)
reduce_read_kernel(const float* __restrict__ X, float* __restrict__ out, int P,
                   int S) {
  using V = typename std::conditional<VEC, float4, float>::type;
  const int n = VEC ? S / 4 : S;  // loads of a row
  constexpr int ROUND = READ_THREADS * READ_UNROLL;
  const int rounds = (n + ROUND - 1) / ROUND;
  if ((int)blockIdx.x >= P) return;
  const int my_rows = (P - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int64_t total = (int64_t)my_rows * rounds;
  const int tid = threadIdx.x;
  V v[READ_UNROLL];
  // issue the loads of round i of this block's rows (zero past the row)
  auto issue = [&](int64_t i) {
    const int64_t row = blockIdx.x + (i / rounds) * gridDim.x;
    const int q = (int)(i % rounds);
    const V* x = reinterpret_cast<const V*>(X + row * S);
#pragma unroll
    for (int u = 0; u < READ_UNROLL; ++u) {
      const int j = q * ROUND + u * READ_THREADS + tid;
      if constexpr (VEC) {
        v[u] = j < n ? __ldcs(x + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        v[u] = j < n ? __ldcs(x + j) : 0.f;
      }
    }
  };
  __shared__ float warp_sums[2][READ_THREADS / 32];
  float acc = 0.f;
  issue(0);
  for (int64_t i = 0; i < total; ++i) {
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < READ_UNROLL; ++u) {
      if constexpr (VEC) {
        part += (v[u].x + v[u].y) + (v[u].z + v[u].w);
      } else {
        part += v[u];
      }
    }
    acc += part;
    if (i + 1 < total) issue(i + 1);
    if ((i + 1) % rounds != 0) continue;
    // the row's last round: a block reduction in a fixed order
    const int64_t row = blockIdx.x + (i / rounds) * gridDim.x;
    const int buf = (int)((i / rounds) & 1);
    float s = acc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
    if ((tid & 31) == 0) warp_sums[buf][tid / 32] = s;
    __syncthreads();  // the other buffer is free again after this barrier
    if (tid == 0) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < READ_THREADS / 32; ++w) t += warp_sums[buf][w];
      out[row] = t;
    }
    acc = 0.f;
  }
}

// Blocks of reduce_read_kernel<VEC> the current device holds at once
// (asked once per device and kept).
template <bool VEC>
int read_blocks() {
  constexpr int MAX_DEVICES = 64;
  static int held[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 0;
  if (dev < MAX_DEVICES && held[dev] > 0) return held[dev];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reduce_read_kernel<VEC>, READ_THREADS, 0) != cudaSuccess ||
      tt_runtime::sm_count(&sms) != cudaSuccess) {
    return 0;
  }
  if (dev < MAX_DEVICES) held[dev] = per_sm * sms;
  return per_sm * sms;
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
  const int held = vec ? read_blocks<true>() : read_blocks<false>();
  if (held <= 0) return (int)cudaErrorInvalidConfiguration;
  // as many rows for every block: no block runs a row after the others
  const int per_block = (P + held - 1) / held;
  const unsigned blocks = (unsigned)((P + per_block - 1) / per_block);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (vec) {
    reduce_read_kernel<true><<<blocks, READ_THREADS, 0, st>>>(X, out, P, S);
  } else {
    reduce_read_kernel<false><<<blocks, READ_THREADS, 0, st>>>(X, out, P, S);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
