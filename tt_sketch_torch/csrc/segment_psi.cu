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
// to 200 FMAs per nonzero, into a few thousand outputs: bound by bytes.
// A scatter with atomics (index_add_) collides on so few rows; a one-hot
// product does n_mu times the work.
//
// The indices arrive in runs.  A COO file sorted by its leading modes (as
// FROSTT's are) gives mode 0 sorted (uber: 52 runs of 63,648 nonzeros) and
// mode 1 in runs (uber: 1,248 runs of 2,652).  So the design sums a run in
// registers and touches the bins in shared memory once a run, not once a
// nonzero.
//
// The block program.  Each block takes a contiguous range of `chunk`
// nonzeros (one block per range, as many ranges as the card holds blocks
// at once: tt_segment_psi_blocks) and a set of micro-tiles of rank pairs
// (all of them unless the bins do not fit; then blockIdx.y picks the set).
// A thread owns one micro-tile: TA left rows against TB right rows (1 x 1
// or 2 x 4, whichever issues the fewer instructions per nonzero for the
// ranks).  The block walks its range in steps of tk nonzeros:
//   - Staging, a ring of NSTAGE buffers: a step's indices, left rows, right
//     rows and entries land in shared memory by cp.async (16 bytes where the
//     rows are 16-byte aligned, else one value at a time), rows along k with
//     a stride of an odd number of 16-byte quads, NSTAGE - 1 steps ahead of
//     the step being summed.  Once a step has landed its indices become
//     rows (-1 outside [0, n_mu)) with one flag a quad of four nonzeros:
//     their row if all four share it, else -2.
//   - Summing: a thread reads, per quad of four nonzeros, one 16-byte quad
//     of each of its rows and of the entries (TA + TB + 1 LDS.128 for
//     4 * TA * TB FMAs; without a left side the entries are the weights)
//     through pointers set once a step, the next quad's loads issued before
//     this quad's FMAs.  While the quad's flag is the row of its current
//     run, it adds the four products into its registers.  Otherwise the run
//     ends: when the first three nonzeros of the quad lie on three rows
//     other than each other's and the run's, the run and the three are
//     added to their four bins with all four reads first; else nonzero by
//     nonzero, each row change adding the run to its bins (a
//     read-modify-write of TA * TB values the thread alone owns) and
//     starting the next from zero.  The run of dropped indices (-1) is
//     never added.
//   - After the range, the last run is added, and the block writes its bins
//     to partials[chunk][n][pair].
// A second kernel sums the partials over the chunks in a fixed order: a
// block of 32 warps takes 32 consecutive outputs, warp w the chunks w,
// w + 32, ..., and warp 0 adds the 32 sums in order.  No atomics: every sum
// is taken in an order fixed by the indices, and a product is rounded on
// its own whichever way its run is added, so two calls give the same bits.
//
// Staged rows are interleaved by micro-tile and bins are [n][quad][tile][4],
// so the 16-byte reads of a warp's threads fall in distinct banks.  The
// micro-tiles of a block and its ring must fit SMEM_BUDGET: tk shrinks
// first (down to MIN_TK), then the block's set of micro-tiles.  A shape
// whose bins leave that budget a ring of fewer than TK nonzeros a step
// (uber's mode 1, 24 rows x 20 x 40 in float: a ring of 32 beside 76.8 KB
// of bins) is planned within SQUEEZED_BUDGET instead, the most shared
// memory a block may take while two blocks share an H100's SM (there: a
// ring of 64, 1.7x faster than the ring of 32).

#include <cuda_runtime.h>
#include <stdint.h>

#include "runtime.cuh"

namespace {

constexpr int MAX_TILES = 256;             // micro-tiles (threads) a block
constexpr size_t SMEM_BUDGET = 96 * 1024;  // opt-in shared memory per block
constexpr int TK = 128;     // nonzeros a step at most
constexpr int MIN_TK = 8;
constexpr int NSTAGE = 2;   // steps in the ring: NSTAGE - 1 in flight
// 228 KB of shared memory an SM, 1 KB of it reserved a block: two blocks
constexpr size_t SQUEEZED_BUDGET = 113 * 1024;
constexpr int REDUCE_WARPS = 32;

// 16 bytes from global to shared memory, in flight until waited for.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// One value of N bytes (4 or 8) from global to shared memory.
template <int N>
__device__ __forceinline__ void cp_async_one(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(N)
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

// Four consecutive values of a staged row (16-byte aligned).
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&v)[4]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  const double2 y = *reinterpret_cast<const double2*>(p + 2);
  v[0] = x.x, v[1] = x.y, v[2] = y.x, v[3] = y.y;
}

// p[0..4) += (x, y, z, w) (16-byte aligned).
__device__ __forceinline__ void add4(float* p, float x, float y, float z,
                                     float w) {
  float4 v = *reinterpret_cast<float4*>(p);
  v.x += x, v.y += y, v.z += z, v.w += w;
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void add4(double* p, double x, double y, double z,
                                     double w) {
  double2 u = *reinterpret_cast<double2*>(p);
  double2 v = *reinterpret_cast<double2*>(p + 2);
  u.x += x, u.y += y, v.x += z, v.y += w;
  *reinterpret_cast<double2*>(p) = u;
  *reinterpret_cast<double2*>(p + 2) = v;
}

// Products rounded on their own (never contracted into an add), so a run
// of one nonzero adds the same value on every path.
__device__ __forceinline__ float mul_(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_(double a, double b) {
  return __dmul_rn(a, b);
}

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
struct Args {
  const int64_t* idx;
  const T* ent;
  const T* left;   // nullptr: one row of ones
  const T* right;  // nullptr: one row of ones
  T* partials;
  int64_t nnz;
  int64_t chunk;  // nonzeros a block
  int n_mu, r1, r2;
  int nb;       // micro-tiles along the right side: ceil(r2 / TB)
  int n_tiles;  // micro-tiles of all pairs: ceil(r1 / TA) * nb
  int np;       // micro-tiles of a block: blockIdx.y takes [y np, y np + np)
  int la;       // left rows staged (a multiple of TA)
  int rb;       // right rows staged: nb * TB
  int tk;       // nonzeros a step, a multiple of 8
  int vec;      // rows, entries and chunk 16-byte aligned: 16-byte copies
  int idx_vec;  // idx 16-byte aligned
};

// The row stride of a staged step in values: an odd number of 16 bytes.
template <typename T>
__host__ __device__ int stride_of(int tk) {
  return tk + 16 / (int)sizeof(T);
}

template <typename T>
__host__ __device__ size_t bins_bytes(int n_mu, int np, int tt) {
  return ((size_t)n_mu * np * tt * sizeof(T) + 15) / 16 * 16;
}

// One buffer of the ring: the left rows, the right rows and the entries
// (stride_of(tk) values each), then the step's indices (int64), rows (int)
// and quad flags (int).
template <typename T>
__host__ __device__ size_t stage_bytes(int la, int rb, int tk) {
  return (size_t)(la + rb + 1) * stride_of<T>(tk) * sizeof(T) +
         (size_t)tk * (sizeof(int64_t) + sizeof(int)) +
         ((size_t)tk / 4 * sizeof(int) + 15) / 16 * 16;
}

// Shared memory of a block: the bins, then the ring.
template <typename T>
size_t block_bytes(int n_mu, int np, int tt, int la, int rb, int tk) {
  return bins_bytes<T>(n_mu, np, tt) + NSTAGE * stage_bytes<T>(la, rb, tk);
}

template <typename T, int TA, int TB>
__global__ void __launch_bounds__(MAX_TILES)
    segment_run_kernel(const Args<T> a) {
  constexpr int TT = TA * TB;
  constexpr int U = 16 / sizeof(T);  // values of a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int tk = a.tk, ts = stride_of<T>(tk);
  const int rows = a.la + a.rb + 1;  // staged value rows: L, R, entries
  T* bins = reinterpret_cast<T*>(smem_raw);
  unsigned char* ring = smem_raw + bins_bytes<T>(a.n_mu, a.np, TT);
  const size_t sbytes = stage_bytes<T>(a.la, a.rb, tk);
  auto vals = [&](int s) {
    return reinterpret_cast<T*>(ring + (size_t)s * sbytes);
  };
  auto raw_idx = [&](int s) {
    return reinterpret_cast<int64_t*>(vals(s) + (size_t)rows * ts);
  };
  auto srow = [&](int s) { return reinterpret_cast<int*>(raw_idx(s) + tk); };
  auto sflag = [&](int s) { return srow(s) + tk; };

  // this block's micro-tiles and the left rows they span
  const int tile0 = blockIdx.y * a.np;
  const int np = min(a.np, a.n_tiles - tile0);
  const int a_lo = tile0 / a.nb * TA;
  // this block's range of nonzeros, in steps of tk
  const int64_t k0 = (int64_t)blockIdx.x * a.chunk;
  const int64_t k1 = min(a.nnz, k0 + a.chunk);
  const int64_t n_steps = k1 > k0 ? (k1 - k0 + tk - 1) / tk : 0;

  // rows no copy writes: left and right pads (zero) or an absent side (one
  // row of ones), in every buffer
  const int la_given = a.left ? min(a.la, a.r1 - a_lo) : 0;
  const int rb_given = a.right ? a.r2 : 0;
  // Staged rows are interleaved by micro-tile: left row a_lo + TA x + i at
  // i * (la / TA) + x, right row TB y + j at la + j * nb + y, so the rows
  // the threads of a warp read at once are consecutive and fall in distinct
  // banks.
  const int nla = a.la / TA;
  auto left_at = [&](int a_) { return a_ % TA * nla + a_ / TA; };
  auto right_at = [&](int b_) { return a.la + b_ % TB * a.nb + b_ / TB; };
  for (int r = 0; r < a.la + a.rb; ++r) {
    // the row staged at position r, relative to its side
    const bool is_l = r < a.la;
    const int row = is_l ? r % nla * TA + r / nla
                         : (r - a.la) % a.nb * TB + (r - a.la) / a.nb;
    if (row < (is_l ? la_given : rb_given)) continue;
    const bool ones = row == 0 && !(is_l ? a.left : a.right);
    for (int i = tid; i < NSTAGE * ts; i += nth) {
      vals(i / ts)[(size_t)r * ts + i % ts] = ones ? T(1) : T(0);
    }
  }
  for (int i = tid; i < a.n_mu * np * TT; i += nth) bins[i] = T(0);

  // Start copying step s (nonzeros [k0 + s tk, ...)) into its buffer: the
  // given left rows, the given right rows, the entries and the indices.
  auto issue = [&](int64_t s) {
    if (s >= n_steps) return;
    const int64_t kt = k0 + s * tk;
    const int cnt = (int)min((int64_t)tk, k1 - kt);
    T* base = vals((int)(s % NSTAGE));
    // one row: its cnt values from src into the buffer's row at dst
    auto copy_row = [&](T* dst, const T* src) {
      if (a.vec) {
        for (int u = tid * U; u < cnt; u += nth * U) {
          cp_async16(dst + u, src + u);
        }
      } else {
        for (int u = tid; u < cnt; u += nth) {
          cp_async_one<sizeof(T)>(dst + u, src + u);
        }
      }
    };
    const T* src = a.left + (int64_t)a_lo * a.nnz + kt;
    for (int r = 0; r < la_given; ++r, src += a.nnz) {
      copy_row(base + (size_t)left_at(r) * ts, src);
    }
    src = a.right + kt;
    for (int r = 0; r < rb_given; ++r, src += a.nnz) {
      copy_row(base + (size_t)right_at(r) * ts, src);
    }
    copy_row(base + (size_t)(a.la + a.rb) * ts, a.ent + kt);
    int64_t* di = raw_idx((int)(s % NSTAGE));
    if (a.idx_vec && cnt % 2 == 0) {
      for (int u = 2 * tid; u < cnt; u += 2 * nth) {
        cp_async16(di + u, a.idx + kt + u);
      }
    } else {
      for (int u = tid; u < cnt; u += nth) {
        cp_async_one<8>(di + u, a.idx + kt + u);
      }
    }
  };

  // Turn buffer b's landed indices into rows and quad flags.
  auto rows_of = [&](int b, int cnt) {
    const int64_t* di = raw_idx(b);
    int* rw = srow(b);
    int* fl = sflag(b);
    for (int q = tid; 4 * q < cnt; q += nth) {
      int r[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = 4 * q + c;
        r[c] = k < cnt && (uint64_t)di[k] < (uint64_t)a.n_mu ? (int)di[k]
                                                              : -1;
      }
      *reinterpret_cast<int4*>(rw + 4 * q) = make_int4(r[0], r[1], r[2], r[3]);
      fl[q] = (r[0] == r[1] && r[1] == r[2] && r[2] == r[3]) ? r[0] : -2;
    }
  };

  const int p = tid;  // this thread's micro-tile
  const bool owns = p < np;
  const int tile = tile0 + p;
  const int ia = owns ? tile / a.nb : 0, ib = owns ? tile % a.nb : 0;
  const int lrow = ia - a_lo / TA;  // its rows: lrow + i * nla
  const int rrow = a.la + ib;       // and rrow + j * nb
  T acc[TA][TB];
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int j = 0; j < TB; ++j) acc[i][j] = T(0);
  int cur = -1;  // the row of the run in acc; -1: dropped indices
  // value q = i TB + j of this thread's micro-tile in row n's bins: quad
  // q / 4 of every micro-tile, then the next quad ([n][q / 4][tile][4]),
  // so a warp's 16-byte accesses are consecutive; [n][tile] for 1 x 1
  auto bin_of = [&](int n, int q) {
    return TT % 4 == 0
               ? bins + (((size_t)n * (TT / 4) + q / 4) * np + p) * 4 + q % 4
               : bins + (size_t)n * np + p;
  };
  auto flush = [&]() {
    if (cur < 0) return;
    if constexpr (TB % 4 == 0) {
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int j = 0; j < TB; j += 4)
          add4(bin_of(cur, i * TB + j), acc[i][j], acc[i][j + 1],
               acc[i][j + 2], acc[i][j + 3]);
    } else {
      *bin_of(cur, 0) += acc[0][0];
    }
  };
  // Sum the quad at t (e: entries, w: left rows, r: right rows, f: its
  // flag); w is weighted by the entries here.
  auto sum_quad = [&](const int* rw, int t, int f, const T (&e)[4],
                      T (&w)[TA][4], const T (&r)[TB][4]) {
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        w[i][c] = a.left ? mul_(w[i][c], e[c]) : e[c];
      }
    if (f == cur) {  // the quad continues the run
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int i = 0; i < TA; ++i)
#pragma unroll
          for (int j = 0; j < TB; ++j)
            acc[i][j] = fma_(w[i][c], r[j][c], acc[i][j]);
      return;
    }
    const int4 n = *reinterpret_cast<const int4*>(rw + t);
    if (n.x >= 0 && n.y >= 0 && n.z >= 0 && n.x != cur && n.y != cur &&
        n.z != cur && n.x != n.y && n.x != n.z && n.y != n.z) {
      // the run ends, the first three nonzeros are runs of one on three
      // other rows, and the fourth starts the next run: four read-modify-
      // writes of distinct bins, all reads first
      const int nc = cur >= 0 ? cur : n.x;
      T vx[TT], vy[TT], vz[TT], vc[TT];
#pragma unroll
      for (int q = 0; q < TT; q += (TT % 4 == 0 ? 4 : 1)) {
        if constexpr (TT % 4 == 0) {
          ld4(bin_of(n.x, q), *reinterpret_cast<T(*)[4]>(vx + q));
          ld4(bin_of(n.y, q), *reinterpret_cast<T(*)[4]>(vy + q));
          ld4(bin_of(n.z, q), *reinterpret_cast<T(*)[4]>(vz + q));
          ld4(bin_of(nc, q), *reinterpret_cast<T(*)[4]>(vc + q));
        } else {
          vx[q] = *bin_of(n.x, q), vy[q] = *bin_of(n.y, q);
          vz[q] = *bin_of(n.z, q), vc[q] = *bin_of(nc, q);
        }
      }
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int j = 0; j < TB; ++j) {
          const int q = i * TB + j;
          vx[q] += mul_(w[i][0], r[j][0]);
          vy[q] += mul_(w[i][1], r[j][1]);
          vz[q] += mul_(w[i][2], r[j][2]);
          vc[q] += acc[i][j];
          acc[i][j] = mul_(w[i][3], r[j][3]);
        }
#pragma unroll
      for (int q = 0; q < TT; ++q) {
        *bin_of(n.x, q) = vx[q], *bin_of(n.y, q) = vy[q];
        *bin_of(n.z, q) = vz[q];
        if (cur >= 0) *bin_of(cur, q) = vc[q];
      }
      cur = n.w;
      return;
    }
    const int nq[4] = {n.x, n.y, n.z, n.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (nq[c] != cur) {
        flush();
        cur = nq[c];
#pragma unroll
        for (int i = 0; i < TA; ++i)
#pragma unroll
          for (int j = 0; j < TB; ++j) acc[i][j] = T(0);
      }
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int j = 0; j < TB; ++j)
          acc[i][j] = fma_(w[i][c], r[j][c], acc[i][j]);
    }
  };

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    issue(s);
    cp_async_commit();
  }
  for (int64_t s = 0; s < n_steps; ++s) {
    const int b = (int)(s % NSTAGE);
    const int cnt = (int)min((int64_t)tk, k1 - (k0 + s * tk));
    issue(s + NSTAGE - 1);  // into the buffer step s - 1 used
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();
    rows_of(b, cnt);
    __syncthreads();
    if (owns) {
      const T* buf = vals(b);
      const T* lr = buf + (size_t)lrow * ts;
      const T* rr = buf + (size_t)rrow * ts;
      const T* er = buf + (size_t)(a.la + a.rb) * ts;
      const int* rw = srow(b);
      const int* fl = sflag(b);
      const int nq = cnt / 4;
      const T* lp[TA];
      const T* rp[TB];
#pragma unroll
      for (int i = 0; i < TA; ++i) lp[i] = lr + (size_t)i * nla * ts;
#pragma unroll
      for (int j = 0; j < TB; ++j) rp[j] = rr + (size_t)j * a.nb * ts;
      // two register sets: the next quad's loads are issued before this
      // quad's sums
      T e0[4], w0[TA][4], r0[TB][4], e1[4], w1[TA][4], r1[TB][4];
      int f0 = 0, f1 = 0;
      auto load = [&](int q, int& f, T (&e)[4], T (&w)[TA][4],
                      T (&r)[TB][4]) {
        const int t = 4 * q;
        f = fl[q];
        ld4(er + t, e);
        if (a.left) {  // else the weights are the entries
#pragma unroll
          for (int i = 0; i < TA; ++i) ld4(lp[i] + t, w[i]);
        }
#pragma unroll
        for (int j = 0; j < TB; ++j) ld4(rp[j] + t, r[j]);
      };
      if (nq > 0) load(0, f0, e0, w0, r0);
      for (int q = 0; q < nq; q += 2) {
        if (q + 1 < nq) load(q + 1, f1, e1, w1, r1);
        sum_quad(rw, 4 * q, f0, e0, w0, r0);
        if (q + 1 >= nq) break;
        if (q + 2 < nq) load(q + 2, f0, e0, w0, r0);
        sum_quad(rw, 4 * q + 4, f1, e1, w1, r1);
      }
      for (int t = 4 * nq; t < cnt; ++t) {  // a last step's tail
        const int n = rw[t];
        if (n != cur) {
          flush();
          cur = n;
#pragma unroll
          for (int i = 0; i < TA; ++i)
#pragma unroll
            for (int j = 0; j < TB; ++j) acc[i][j] = T(0);
        }
        const T e = er[t];
#pragma unroll
        for (int i = 0; i < TA; ++i) {
          const T wi = a.left ? mul_(lp[i][t], e) : e;
#pragma unroll
          for (int j = 0; j < TB; ++j)
            acc[i][j] = fma_(wi, rp[j][t], acc[i][j]);
        }
      }
    }
    __syncthreads();  // buffer b consumed: step s + NSTAGE may land in it
  }
  if (owns) flush();
  __syncthreads();

  // bins -> partials[blockIdx.x][n][a * r2 + b]
  if (owns) {
    T* part = a.partials + (int64_t)blockIdx.x * a.n_mu * a.r1 * a.r2;
    for (int n = 0; n < a.n_mu; ++n) {
#pragma unroll
      for (int i = 0; i < TA; ++i) {
        const int ai = ia * TA + i;
#pragma unroll
        for (int j = 0; j < TB; ++j) {
          const int bj = ib * TB + j;
          if (ai < a.r1 && bj < a.r2) {
            part[((int64_t)n * a.r1 + ai) * a.r2 + bj] = *bin_of(n, i * TB + j);
          }
        }
      }
    }
  }
}

// out[i] = the sum over chunks c of partials[c][i], in a fixed order: warp w
// of a block of REDUCE_WARPS takes the chunks w, w + REDUCE_WARPS, ... of
// 32 consecutive outputs, and warp 0 adds the warps' sums in order.
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
#pragma unroll 4
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

// Warp instructions a thread issues per quad of four nonzeros in a TA x TB
// micro-tile (loads, weights, FMAs, flag and loop), times the warps of a
// block that holds every micro-tile: the instance with the fewest is
// launched.
int quad_cost(int r1, int r2, int ta, int tb) {
  const int tiles = ((r1 + ta - 1) / ta) * ((r2 + tb - 1) / tb);
  const int warps = (tiles + 31) / 32;
  return warps * (6 + ta + tb + 4 * ta + 4 * ta * tb);
}

// The micro-tile with the fewer instructions per nonzero: 2 x 4 or 1 x 1.
bool wide_tiles(int r1, int r2) {
  return quad_cost(r1, r2, 2, 4) < quad_cost(r1, r2, 1, 1);
}

// A launch's geometry: micro-tiles a block (np), its threads, the left
// rows it stages (la), the right rows (rb), the step (tk), the extent of
// the grid in y, the shared memory and the budget it was planned in; 0
// threads: the bins of one micro-tile do not fit.
struct Plan {
  int nb, n_tiles, np, threads, la, rb, tk, grid_y;
  size_t bytes, budget;
};

// The plan within `budget` bytes: as many micro-tiles a block as fit
// beside a ring of MIN_TK nonzeros, then the largest step that fits.
template <typename T, int TA, int TB>
Plan plan_at(int n_mu, int r1, int r2, size_t budget) {
  constexpr int TT = TA * TB;
  Plan g;
  g.budget = budget;
  g.nb = (r2 + TB - 1) / TB;
  g.rb = g.nb * TB;
  const int na = (r1 + TA - 1) / TA;
  g.n_tiles = na * g.nb;
  // the left rows a block of np micro-tiles can span
  auto la_of = [&](int np) {
    return (na < np / g.nb + 2 ? na : np / g.nb + 2) * TA;
  };
  g.np = g.n_tiles < MAX_TILES ? g.n_tiles : MAX_TILES;
  while (g.np > 1 && block_bytes<T>(n_mu, g.np, TT, la_of(g.np), g.rb,
                                    MIN_TK) > budget) {
    --g.np;
  }
  g.la = la_of(g.np);
  g.threads = (g.np + 31) / 32 * 32;
  g.tk = TK;
  while (g.tk > MIN_TK &&
         block_bytes<T>(n_mu, g.np, TT, g.la, g.rb, g.tk) > budget) {
    g.tk -= 8;
  }
  g.bytes = block_bytes<T>(n_mu, g.np, TT, g.la, g.rb, g.tk);
  if (g.bytes > budget) g.threads = 0;
  g.grid_y = (g.n_tiles + g.np - 1) / g.np;
  return g;
}

// The plan within SMEM_BUDGET, which decides the fit; where its ring holds
// fewer than TK nonzeros a step, the plan within SQUEEZED_BUDGET.
template <typename T, int TA, int TB>
Plan plan_of(int n_mu, int r1, int r2) {
  const Plan g = plan_at<T, TA, TB>(n_mu, r1, r2, SMEM_BUDGET);
  if (g.threads == 0 || g.tk == TK) return g;
  return plan_at<T, TA, TB>(n_mu, r1, r2, SQUEEZED_BUDGET);
}

template <typename T, int TA, int TB>
cudaError_t prepare(const Plan& g) {
  if (g.threads == 0) return cudaErrorInvalidValue;
  if (g.bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(segment_run_kernel<T, TA, TB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)g.budget);
}

template <typename T, int TA, int TB>
int launch(const int64_t* idx, const T* ent, const T* left, const T* right,
           T* partials, T* out, int64_t nnz, int n_mu, int r1, int r2,
           int64_t chunk, int n_chunks, cudaStream_t stream) {
  const Plan g = plan_of<T, TA, TB>(n_mu, r1, r2);
  cudaError_t err = prepare<T, TA, TB>(g);
  if (err != cudaSuccess) return (int)err;
  Args<T> a;
  a.idx = idx, a.ent = ent, a.left = left, a.right = right;
  a.partials = partials, a.nnz = nnz, a.chunk = chunk;
  a.n_mu = n_mu, a.r1 = r1, a.r2 = r2;
  a.nb = g.nb, a.n_tiles = g.n_tiles, a.np = g.np, a.la = g.la, a.rb = g.rb;
  a.tk = g.tk;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  a.vec = (nnz * (int64_t)sizeof(T)) % 16 == 0 && chunk % 4 == 0 &&
          aligned(ent) && (!left || aligned(left)) &&
          (!right || aligned(right));
  a.idx_vec = aligned(idx) && chunk % 2 == 0;
  const dim3 grid((unsigned)n_chunks, (unsigned)g.grid_y);
  segment_run_kernel<T, TA, TB><<<grid, g.threads, g.bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t cells = (int64_t)n_mu * r1 * r2;
  segment_reduce_kernel<T>
      <<<(unsigned)((cells + 31) / 32), 32 * REDUCE_WARPS, 0, stream>>>(
          partials, out, n_chunks, cells);
  return (int)cudaGetLastError();
}

// Blocks of grid.x that fill the card once: the blocks an SM holds at once
// times the SMs, over the grid's extent in y.
template <typename T, int TA, int TB>
int blocks_of(int n_mu, int r1, int r2) {
  const Plan g = plan_of<T, TA, TB>(n_mu, r1, r2);
  if (prepare<T, TA, TB>(g) != cudaSuccess) return 1;
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, segment_run_kernel<T, TA, TB>, g.threads, g.bytes) !=
          cudaSuccess ||
      tt_runtime::sm_count(&sms) != cudaSuccess) {
    return 1;
  }
  const int blocks = per_sm * sms / g.grid_y;
  return blocks > 1 ? blocks : 1;
}

template <typename T>
int launch_any(const int64_t* idx, const void* ent, const void* left,
               const void* right, void* partials, void* out, int64_t nnz,
               int n_mu, int r1, int r2, int64_t chunk, int n_chunks,
               cudaStream_t s) {
  const T* e = static_cast<const T*>(ent);
  const T* l = static_cast<const T*>(left);
  const T* r = static_cast<const T*>(right);
  T* p = static_cast<T*>(partials);
  T* o = static_cast<T*>(out);
  return wide_tiles(r1, r2)
             ? launch<T, 2, 4>(idx, e, l, r, p, o, nnz, n_mu, r1, r2, chunk,
                               n_chunks, s)
             : launch<T, 1, 1>(idx, e, l, r, p, o, nnz, n_mu, r1, r2, chunk,
                               n_chunks, s);
}

template <typename T>
int blocks_any(int n_mu, int r1, int r2) {
  return wide_tiles(r1, r2) ? blocks_of<T, 2, 4>(n_mu, r1, r2)
                            : blocks_of<T, 1, 1>(n_mu, r1, r2);
}

template <typename T>
Plan plan_any(int n_mu, int r1, int r2) {
  return wide_tiles(r1, r2) ? plan_of<T, 2, 4>(n_mu, r1, r2)
                            : plan_of<T, 1, 1>(n_mu, r1, r2);
}

bool valid_shape(int elem, int n_mu, int r1, int r2) {
  return (elem == 4 || elem == 8) && n_mu > 0 && r1 > 0 && r2 > 0 &&
         (int64_t)r1 * r2 <= 65535;  // tiles of rank pairs: grid.y
}

Plan plan_elem(int elem, int n_mu, int r1, int r2) {
  return elem == 4 ? plan_any<float>(n_mu, r1, r2)
                   : plan_any<double>(n_mu, r1, r2);
}

}  // namespace

extern "C" {

// elem is 4 (float) or 8 (double); nnz > 0; partials holds
// n_chunks * n_mu * r1 * r2 values, chunk * n_chunks >= nnz, and the shape
// fits (tt_segment_psi_fits).  Returns the cudaError_t of the launches (0 on
// success).
int tt_segment_psi(int elem, const int64_t* idx, const void* ent,
                   const void* left, const void* right, void* partials,
                   void* out, int64_t nnz, int n_mu, int r1, int r2,
                   int64_t chunk, int n_chunks, void* stream) {
  if (!valid_shape(elem, n_mu, r1, r2) || nnz <= 0 ||
      (left == nullptr && r1 != 1) || (right == nullptr && r2 != 1) ||
      n_chunks <= 0 || chunk <= 0 || chunk * (int64_t)n_chunks < nnz) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return elem == 4 ? launch_any<float>(idx, ent, left, right, partials, out,
                                       nnz, n_mu, r1, r2, chunk, n_chunks, s)
                   : launch_any<double>(idx, ent, left, right, partials, out,
                                        nnz, n_mu, r1, r2, chunk, n_chunks,
                                        s);
}

// 1 if tt_segment_psi takes a Psi of (n_mu, r1, r2) in elem bytes a value,
// else 0: r1 * r2 <= 65535, and the bins of one micro-tile (of the shape
// wide_tiles picks) of every row beside a ring of MIN_TK-nonzero steps fit
// SMEM_BUDGET (in float about 2,900 rows at ranks 20 x 40 and 24,000 at
// rank 1 x 20; in double about half).  No card is asked.
int tt_segment_psi_fits(int elem, int n_mu, int r1, int r2) {
  return valid_shape(elem, n_mu, r1, r2) &&
         plan_elem(elem, n_mu, r1, r2).threads > 0;
}

// The plan of a Psi of (n_mu, r1, r2) into geometry[8]: the micro-tile's
// rows TA and TB, micro-tiles a block, threads, nonzeros a step, the grid's
// extent in y, shared memory bytes a block and the micro-tiles of all
// pairs; returns tt_segment_psi_fits.
int tt_segment_psi_plan(int elem, int n_mu, int r1, int r2, int* geometry) {
  if (!valid_shape(elem, n_mu, r1, r2)) return 0;
  const Plan g = plan_elem(elem, n_mu, r1, r2);
  const bool wide = wide_tiles(r1, r2);
  const int v[8] = {wide ? 2 : 1, wide ? 4 : 1, g.np,         g.threads,
                    g.tk,         g.grid_y,     (int)g.bytes, g.n_tiles};
  for (int i = 0; i < 8; ++i) geometry[i] = v[i];
  return g.threads > 0;
}

// The blocks of one launch's grid.x (its n_chunks) that fill the card once
// for a Psi of this shape, on the current device; at least 1.
int tt_segment_psi_blocks(int elem, int n_mu, int r1, int r2) {
  if (!valid_shape(elem, n_mu, r1, r2)) return 1;
  return elem == 4 ? blocks_any<float>(n_mu, r1, r2)
                   : blocks_any<double>(n_mu, r1, r2);
}

}  // extern "C"
