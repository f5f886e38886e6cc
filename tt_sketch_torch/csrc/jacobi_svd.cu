// Batched one-sided Jacobi SVD of small matrices, for Hopper:
//
//   A[b] = U[b] diag(s[b]) Vh[b]    for each b of a strided batch (b, m, n),
//
// m >= n, float or double, computed in the input's type (no TF32, no tensor
// cores).  U (b, m, n), s (b, n) sorted descending and Vh (b, n, n) are
// written in the layout torch.linalg.svd(full_matrices=False) returns; the
// wrapper transposes wide matrices.  sweeps (b,) gets the sweeps each
// matrix took (see the stopping rule below).
//
// Replaces tt_sketch_tpu/kernels/accurate_linalg.py:jacobi_svd (one-sided
// Hestenes, round-robin pairs, at most 12 sweeps), which the JAX package
// runs on a TPU where the backend's SVD cannot resolve small singular
// values.  Here it serves the TT-core recovery (tt_sketch_torch/utils.py:
// _lstsq): one launch factors every Omega of a request, where
// torch.linalg.svd launched once a mode and synchronised with the host to
// check its info.  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with a plain C interface, loaded by
// tt_sketch_torch/kernels/jacobi_svd.py through ctypes.
//
// What bounds it.  Neither bytes nor operations: a 64 x 32 matrix is 8 KB
// and a sweep some 0.3 MFLOP.  A sweep is n_p - 1 rounds (n_p = n rounded
// up to even), and a round ends at a block-wide barrier, so a matrix costs
// about 2 n + (n_p - 1) x sweeps barriers, each round the latency of one
// pair's loads, sums, shuffles, rotation and updates: latency-bound.  The
// design cuts the sweeps (a pivoted QR first) and the chain of a round
// (16-byte loads, every pair of a round at once), and runs the matrices of
// a batch side by side, one block each.
//
// The block program.  One block per matrix, ceil(n / 4) warps, split into
// groups of GROUP = 8 lanes; a group owns one column in the QR and in U,
// and one pair in a round.  A lane takes VEC = 16 bytes of rows (4 floats,
// 2 doubles) of each chunk of CH = GROUP * VEC rows, so that a group reads
// or writes a chunk of a column with one 16-byte access a lane (128
// contiguous bytes: no bank conflict).  Columns are stored in chunks,
// zero-padded.
//   - Load A (strided: a transposed view costs no copy) into shared memory
//     column by column and scale it by max|A| (NaN propagates), so that
//     every quantity below stays in range, as the JAX function does.
//   - Householder QR with column pivoting, A P = Q R, one step a column
//     (unlike the JAX function, which sweeps over A itself): the warp of
//     column j picks the column p >= j of largest norm over rows >= j (a
//     shuffle argmax of the norms in shared memory; ties to the lowest
//     index, NaN below every number), its owner swaps columns p and j and
//     forms the reflector (v = x - beta e_1, beta = -sign(x_1) |x|, kept in
//     the column, 2 / v.v and beta beside it); one barrier; each group
//     applies it to its column k > j and leaves the norm of its rows > j
//     for the next pick; one barrier.  The sweeps on R^T take 6-10 where
//     those on A take 12-16 for graded or rank-deficient matrices (cond
//     1e6, or rank 10 plus rounding noise, at 64 x 32), and with the
//     pivots 6-9 at the cells' float32 shapes and 7-10 for float64 30 x 30
//     (10 in under 0.1 % of them), where unpivoted R^T took up to 12: the
//     cap leaves two to spare (measured with the plain version over 16,384
//     float32 and 32,760 float64 matrices a kind); a round's sums run over
//     n rows instead of m.
//   - One-sided Jacobi on W = P R^T (n_p columns, zero-padded; R^T's row
//     k at row order[k], the column of A that pivot k took: the sweeps see
//     R^T's columns with their entries permuted alike, and W's rows come
//     out in A's column order), with Z = I
//     accumulating the rotations.  A round takes the n_p / 2 disjoint pairs
//     of the circle method (column 0 fixed, the others rotated one place a
//     round; the JAX function's schedule), pair k on group k.  For a pair
//     (p, q) the group sums alpha = |w_p|^2, beta = |w_q|^2 and gamma =
//     w_p . w_q over its lanes (a butterfly of shuffles, so every lane of
//     the group holds the same sums).  The pair fails the relative
//     orthogonality test when
//       |gamma| > tol |w_p| |w_q|,   tol = eps(T) sqrt(m)
//     (LAPACK's xGESVJ default; eps(T) m, tried first, left uber's float32
//     solves 2.5-3x less accurate than LAPACK's sgesdd, eps sqrt(m) matches
//     it for one sweep more at most: measured with the plain version); a
//     failing pair is rotated by Rutishauser's formulas in their
//     overflow-free form (t = sign(d) gamma / (|d| + hypot(d, gamma)), d =
//     (beta - alpha) / 2, c = 1 / sqrt(1 + t^2), s = c t; w_p <- c w_p - s
//     w_q, w_q <- s w_p + c w_q, and the same on Z's columns).  Rounds are
//     separated by __syncthreads; the last of a sweep is __syncthreads_or of
//     "this thread rotated", and the block stops after the first sweep in
//     which no pair failed.  sweeps[b] is the sweeps run, the clean one
//     included, or MAX_SWEEPS + 1 when the last sweep allowed still
//     rotated.  A non-finite entry never passes or fails the test as a
//     number would (comparisons with NaN are false), so it rotates nothing
//     and comes out as non-finite singular values and vectors.
//   - P R^T Z = W' diag(s) gives A = (Q Z) diag(s) W'^T: s_j = |w_j| (times
//     the scale), Vh's row j = w_j^T / |w_j| (a zero column stays zero), and
//     U's column j = Q z_j, each group applying the reflectors to its column
//     [z_j; 0] in the shared memory that held W.  Each column's place is its
//     rank in descending order of s (ties by index, NaN first).
// No allocation, no host sync, no info: the wrapper reads nothing back.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "runtime.cuh"

namespace {

constexpr int MAX_SWEEPS = 12;
constexpr int MAX_COLS = 64;      // 16 warps of 4 groups
constexpr int GROUP = 8;          // lanes a column or a pair
constexpr int SMEM_BUDGET = 48 * 1024;  // a block's default limit: no opt-in
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double d_abs(double x) { return fabs(x); }
__device__ __forceinline__ float d_hypot(float x, float y) {
  return hypotf(x, y);
}
__device__ __forceinline__ double d_hypot(double x, double y) {
  return hypot(x, y);
}

// 16 bytes of values between shared memory and registers
__device__ __forceinline__ void ld16(float (&d)[4], const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}
__device__ __forceinline__ void ld16(double (&d)[2], const double* s) {
  const double2 v = *reinterpret_cast<const double2*>(s);
  d[0] = v.x;
  d[1] = v.y;
}
__device__ __forceinline__ void st16(float* s, const float (&d)[4]) {
  *reinterpret_cast<float4*>(s) = make_float4(d[0], d[1], d[2], d[3]);
}
__device__ __forceinline__ void st16(double* s, const double (&d)[2]) {
  *reinterpret_cast<double2*>(s) = make_double2(d[0], d[1]);
}

template <typename T> struct Eps;
template <> struct Eps<float> {
  static constexpr float value = 1.1920928955078125e-07f;
};
template <> struct Eps<double> {
  static constexpr double value = 2.220446049250313e-16;
};

inline int padded(int n) { return n + (n & 1); }
inline int chunk_rows(int elem) { return GROUP * 16 / elem; }
// the chunks of a column of W (n_p rows): 1, 2 or 4
inline int w_chunks(int elem, int n) {
  const int c = (padded(n) + chunk_rows(elem) - 1) / chunk_rows(elem);
  return c <= 1 ? 1 : c <= 2 ? 2 : 4;
}

// Shared memory of one block: the reflectors (n columns of m rows rounded
// up to chunks), W = R^T (n_p columns of w_chunks chunks) in a region that
// later holds U (as the reflectors), Z (as W), the column norms (n_p), the
// reflectors' 2 / v.v and R's diagonal (n each), the warps' maxima (32),
// then the order (n_p ints).
inline size_t smem_bytes(int elem, int m, int n) {
  const size_t np = padded(n), ch = chunk_rows(elem);
  const size_t an = (m + ch - 1) / ch * ch * n;
  const size_t wz = w_chunks(elem, n) * ch * np;
  return (size_t)elem * (an + (an > wz ? an : wz) + wz + np + 2 * n + 32) +
         4 * np;
}

inline bool fits(int elem, int m, int n) {
  return (elem == 4 || elem == 8) && n >= 1 && m >= n && n <= MAX_COLS &&
         smem_bytes(elem, m, n) <= (size_t)SMEM_BUDGET;
}

// the sum over a group's GROUP lanes: every lane of it gets the same value
template <typename T>
__device__ __forceinline__ T group_sum(T x) {
#pragma unroll
  for (int o = GROUP / 2; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// max that propagates NaN: every lane ends with the same value
template <typename T>
__device__ __forceinline__ T nan_max(T x, T y) {
  return (y > x || y != y) ? y : x;
}

template <typename T>
__device__ __forceinline__ T warp_max(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = nan_max(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// pair k of round r among n_p columns (the circle method)
__device__ __forceinline__ void round_pair(int np, int r, int k, int& p,
                                           int& q) {
  const int M = np - 1;
  const int x = k - 1 - r, y = np - 2 - k - r;  // both in [-M, M)
  p = k == 0 ? 0 : 1 + (x < 0 ? x + M : x);
  q = 1 + (y < 0 ? y + M : y);
}

// The reflector of step j (v: column j, its rows >= j) on the column col,
// both of lda rows: col -= (v . col) f v over the chunks from the one
// holding row j.  Every lane of the warp calls it (the sums shuffle); a
// group with act false reads and writes nothing.  With NORM, returns the
// squared norm of the updated column's rows > j (the QR's next pivot) to
// every lane of an acting group (0 without).
template <typename T, int VEC, bool NORM>
__device__ __forceinline__ T reflect(const T* v, T* col, T f, int j,
                                     int lda, int row0, bool act) {
  constexpr int CH = GROUP * VEC;
  T dot = T(0), ss = T(0);
  for (int c = j / CH * CH; c < lda; c += CH) {
    if (act) {
      T x[VEC], y[VEC];
      ld16(x, v + c + row0);
      ld16(y, col + c + row0);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (c + row0 + e >= j) dot += x[e] * y[e];
    }
  }
  const T coef = group_sum(dot) * f;
  if (act) {
    for (int c = j / CH * CH; c < lda; c += CH) {
      T x[VEC], y[VEC];
      ld16(x, v + c + row0);
      ld16(y, col + c + row0);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (c + row0 + e >= j) y[e] -= coef * x[e];
        if (NORM && c + row0 + e > j) ss += y[e] * y[e];
      }
      st16(col + c + row0, y);
    }
  }
  return NORM ? group_sum(ss) : T(0);
}

// NaN ranks below every norm as a pivot
template <typename T>
__device__ __forceinline__ T pivot_key(T x) {
  return x == x ? x : T(-1);
}

template <typename T, int R>
__global__ void __launch_bounds__(32 * MAX_COLS / 4)
jacobi_svd_kernel(const T* __restrict__ A, int m, int n, int64_t sb,
                  int64_t sm, int64_t sn, T* __restrict__ U,
                  T* __restrict__ S, T* __restrict__ Vh,
                  int* __restrict__ sweeps) {
  constexpr int VEC = 16 / sizeof(T), CH = GROUP * VEC, LDW = R * CH;
  constexpr int GW = 32 / GROUP;  // groups a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = n + (n & 1);
  const int lda = (m + CH - 1) / CH * CH;
  const size_t an = (size_t)lda * n, wz = (size_t)LDW * np;
  T* a = reinterpret_cast<T*>(smem);  // column j at a[j * lda]
  T* w = a + an;                      // W's column j at w[j * LDW]
  T* z = w + (an > wz ? an : wz);     // Z's column j at z[j * LDW]
  T* nrm = z + wz;
  T* fh = nrm + np;
  T* rd = fh + n;
  T* wmax = rd + n;
  int* order = reinterpret_cast<int*>(wmax + 32);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int grp = warp * GW + lane / GROUP;  // this lane's group
  const int row0 = (lane % GROUP) * VEC;     // its first row of a chunk
  const int64_t b = blockIdx.x;
  const T* Ab = A + b * sb;

  T mx = T(0);
  for (int idx = tid; idx < lda * n; idx += blockDim.x) {
    const int j = idx / lda, i = idx - j * lda;
    const T x = i < m ? Ab[i * sm + j * sn] : T(0);
    a[idx] = x;
    mx = nan_max(mx, d_abs(x));
  }
  for (int idx = tid; idx < LDW * np; idx += blockDim.x) {
    const int j = idx / LDW, i = idx - j * LDW;
    z[idx] = i == j ? T(1) : T(0);
  }
  mx = warp_max(mx);
  if (lane == 0) wmax[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    T x = lane < warps ? wmax[lane] : T(0);
    x = warp_max(x);
    if (lane == 0) wmax[0] = x;
  }
  __syncthreads();
  const T scale = wmax[0];
  const T safe_scale = scale > T(0) ? scale : T(1);
  for (int idx = tid; idx < lda * n; idx += blockDim.x) a[idx] /= safe_scale;
  __syncthreads();
  // the pivots' norms (column k's squared, on group k) and order[k]: the
  // column of A that column k holds
  {
    const bool act = grp < n;
    const T* ak = a + (size_t)(act ? grp : 0) * lda;
    T ss = T(0);
    for (int c = 0; c < lda; c += CH) {
      if (act) {
        T x[VEC];
        ld16(x, ak + c + row0);
#pragma unroll
        for (int e = 0; e < VEC; ++e) ss += x[e] * x[e];
      }
    }
    ss = group_sum(ss);
    if (act && lane % GROUP == 0) {
      nrm[grp] = ss;
      order[grp] = grp;
    }
  }
  __syncthreads();

  // Householder QR with column pivoting: the warp of group j picks the
  // column p >= j of largest norm over rows >= j (ties to the lowest
  // index), group j swaps it with column j and forms the reflector, then
  // each group k > j applies it to its column and leaves the norm of its
  // rows > j in nrm[k]
  for (int j = 0; j < n; ++j) {
    T* aj = a + (size_t)j * lda;
    if (warp == j / GW) {
      const bool me = grp == j;
      T best = T(-2);
      int piv = j;
      for (int k = lane; k < MAX_COLS; k += 32) {
        const T key = k >= j && k < n ? pivot_key(nrm[k]) : T(-2);
        if (key > best) {
          best = key;
          piv = k;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const T ob = __shfl_xor_sync(FULL, best, o);
        const int op = __shfl_xor_sync(FULL, piv, o);
        if (ob > best || (ob == best && op < piv)) {
          best = ob;
          piv = op;
        }
      }
      T ss = T(0);
      if (me && piv != j) {
        T* ap = a + (size_t)piv * lda;
        for (int c = 0; c < lda; c += CH) {
          T x[VEC], y[VEC];
          ld16(x, aj + c + row0);
          ld16(y, ap + c + row0);
          st16(aj + c + row0, y);
          st16(ap + c + row0, x);
        }
        if (lane % GROUP == 0) {
          const int o = order[j];
          order[j] = order[piv];
          order[piv] = o;
        }
      }
      __syncwarp();  // the swapped column, other lanes
      for (int c = j / CH * CH; c < lda; c += CH) {
        if (me) {
          T x[VEC];
          ld16(x, aj + c + row0);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            if (c + row0 + e >= j) ss += x[e] * x[e];
        }
      }
      const T norm = d_sqrt(group_sum(ss));
      if (me) {
        const T x0 = aj[j];
        const T beta = x0 >= T(0) ? -norm : norm;
        const T vv = T(2) * norm * (norm + d_abs(x0));
        __syncwarp(0xffu << (lane / GROUP * GROUP));
        if (lane % GROUP == 0) {
          aj[j] = x0 - beta;
          fh[j] = vv > T(0) ? T(2) / vv : T(0);
          rd[j] = beta;
        }
      }
    }
    __syncthreads();
    if ((warp + 1) * GW - 1 > j) {
      const bool act = grp > j && grp < n;
      const T ss = reflect<T, VEC, true>(aj, a + (size_t)(act ? grp : j) * lda,
                                   fh[j], j, lda, row0, act);
      if (act && lane % GROUP == 0) nrm[grp] = ss;
    }
    __syncthreads();
  }
  // W = P R^T: R^T's row k goes to row order[k] (the sweeps see the same
  // columns, and W's rows come out in A's column order)
  for (int idx = tid; idx < LDW * np; idx += blockDim.x) {
    const int j = idx / LDW, k = idx - j * LDW;  // (R^T)[k][j] = R[j][k]
    w[(size_t)j * LDW + (k < n ? order[k] : k)] =
        (k >= n || j >= n || k < j) ? T(0)
        : k == j                    ? rd[j]
                                    : a[(size_t)k * lda + j];
  }
  __syncthreads();

  // the sweeps: pair k of a round on group k
  const T tol = Eps<T>::value * d_sqrt(T(m));
  const int half = np / 2;
  const bool pairs_here = warp * GW < half, mine = grp < half;
  int used = MAX_SWEEPS + 1;
  for (int sweep = 0; sweep < MAX_SWEEPS && used > MAX_SWEEPS; ++sweep) {
    int rotated = 0;
    for (int r = 0; r < np - 1; ++r) {
      if (pairs_here) {
        int p = 0, q = 1;
        if (mine) round_pair(np, r, grp, p, q);
        T* wp = w + (size_t)p * LDW + row0;
        T* wq = w + (size_t)q * LDW + row0;
        T x[R][VEC], y[R][VEC];
        T al = T(0), be = T(0), ga = T(0);
#pragma unroll
        for (int h = 0; h < R; ++h) {
          if (mine) {
            ld16(x[h], wp + h * CH);
            ld16(y[h], wq + h * CH);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) x[h][e] = y[h][e] = T(0);
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            al += x[h][e] * x[h][e];
            be += y[h][e] * y[h][e];
            ga += x[h][e] * y[h][e];
          }
        }
        al = group_sum(al);
        be = group_sum(be);
        ga = group_sum(ga);
        if (d_abs(ga) > tol * d_sqrt(al) * d_sqrt(be)) {
          const T d = T(0.5) * (be - al);
          const T t = (d < T(0) ? -ga : ga) / (d_abs(d) + d_hypot(d, ga));
          const T c = T(1) / d_sqrt(T(1) + t * t);
          const T s = c * t;
          T* zp = z + (size_t)p * LDW + row0;
          T* zq = z + (size_t)q * LDW + row0;
#pragma unroll
          for (int h = 0; h < R; ++h) {
            T u[VEC], v[VEC], x2[VEC], y2[VEC], u2[VEC], v2[VEC];
            ld16(u, zp + h * CH);
            ld16(v, zq + h * CH);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              x2[e] = c * x[h][e] - s * y[h][e];
              y2[e] = s * x[h][e] + c * y[h][e];
              u2[e] = c * u[e] - s * v[e];
              v2[e] = s * u[e] + c * v[e];
            }
            st16(wp + h * CH, x2);
            st16(wq + h * CH, y2);
            st16(zp + h * CH, u2);
            st16(zq + h * CH, v2);
          }
          rotated = 1;
        }
      }
      if (r < np - 2) {
        __syncthreads();
      } else if (!__syncthreads_or(rotated)) {
        used = sweep + 1;
      }
    }
  }

  // column norms (column j on group j), then each column's place
  {
    const bool act = grp < n;
    const T* wj = w + (size_t)(act ? grp : 0) * LDW + row0;
    T ss = T(0);
#pragma unroll
    for (int h = 0; h < R; ++h) {
      if (act) {
        T x[VEC];
        ld16(x, wj + h * CH);
#pragma unroll
        for (int e = 0; e < VEC; ++e) ss += x[e] * x[e];
      }
    }
    ss = group_sum(ss);
    if (act && lane % GROUP == 0) nrm[grp] = d_sqrt(ss);
  }
  __syncthreads();
  for (int j = tid; j < n; j += blockDim.x) {
    const T kj = nrm[j] != nrm[j] ? T(INFINITY) : nrm[j];
    int rank = 0;
    for (int i = 0; i < n; ++i) {
      const T ki = nrm[i] != nrm[i] ? T(INFINITY) : nrm[i];
      rank += ki > kj || (ki == kj && i < j);
    }
    order[rank] = j;
  }
  __syncthreads();

  T* Sb = S + b * (int64_t)n;
  T* Vb = Vh + b * (int64_t)n * n;
  for (int r = tid; r < n; r += blockDim.x) Sb[r] = nrm[order[r]] * safe_scale;
  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int r = idx / n, i = idx - r * n, j = order[r];
    const T sj = nrm[j];
    Vb[idx] = w[(size_t)j * LDW + i] / (sj > T(0) ? sj : T(1));
  }
  __syncthreads();

  // U's column r = Q [z_order[r]; 0], built where W was (column r at
  // u[r * lda]) by group r
  T* u = w;
  {
    const bool act = grp < n;
    T* ur = u + (size_t)(act ? grp : 0) * lda;
    if (act) {
      const T* zr = z + (size_t)order[grp] * LDW;
      for (int c = 0; c < lda; c += CH) {
        T x[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int i = c + row0 + e;
          x[e] = i < n ? zr[i] : T(0);
        }
        st16(ur + c + row0, x);
      }
    }
    for (int j = n - 1; j >= 0; --j)
      reflect<T, VEC, false>(a + (size_t)j * lda, ur, fh[j], j, lda, row0,
                             act);
  }
  __syncthreads();
  T* Ub = U + b * (int64_t)m * n;
  for (int idx = tid; idx < m * n; idx += blockDim.x) {
    const int i = idx / n, r = idx - i * n;
    Ub[idx] = u[(size_t)r * lda + i];
  }
  if (tid == 0 && sweeps != nullptr) sweeps[b] = used;
}

template <typename T, int R>
int launch_r(const void* A, int64_t batch, int m, int n, int64_t sb,
             int64_t sm, int64_t sn, void* U, void* S, void* Vh, int* sweeps,
             cudaStream_t stream) {
  const int warps = (n + 32 / GROUP - 1) / (32 / GROUP);
  jacobi_svd_kernel<T, R><<<(unsigned)batch, 32 * warps,
                            smem_bytes(sizeof(T), m, n), stream>>>(
      static_cast<const T*>(A), m, n, sb, sm, sn, static_cast<T*>(U),
      static_cast<T*>(S), static_cast<T*>(Vh), sweeps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* A, int64_t batch, int m, int n, int64_t sb,
           int64_t sm, int64_t sn, void* U, void* S, void* Vh, int* sweeps,
           cudaStream_t stream) {
  switch (w_chunks(sizeof(T), n)) {
    case 1:
      return launch_r<T, 1>(A, batch, m, n, sb, sm, sn, U, S, Vh, sweeps,
                            stream);
    case 2:
      return launch_r<T, 2>(A, batch, m, n, sb, sm, sn, U, S, Vh, sweeps,
                            stream);
    default:
      return launch_r<T, 4>(A, batch, m, n, sb, sm, sn, U, S, Vh, sweeps,
                            stream);
  }
}

}  // namespace

extern "C" {

// 1 if tt_jacobi_svd takes an m x n matrix (m >= n, 1 <= n <= MAX_COLS) in
// elem bytes a value (4: float, 8: double), else 0: the block's shared
// memory (smem_bytes) within SMEM_BUDGET.  No card is asked.
int tt_jacobi_svd_fits(int elem, int m, int n) { return fits(elem, m, n); }

// The shared memory bytes of one block for an m x n matrix.
int64_t tt_jacobi_svd_smem(int elem, int m, int n) {
  return (int64_t)smem_bytes(elem, m, n);
}

// A: batch matrices of m x n, element (b, i, j) at A[b * sb + i * sm + j *
// sn]; U (batch, m, n), S (batch, n), Vh (batch, n, n) contiguous; sweeps
// (batch,) int32 or null.  Returns the cudaError_t of the launch (0 on
// success).
int tt_jacobi_svd(int elem, const void* A, int64_t batch, int m, int n,
                  int64_t sb, int64_t sm, int64_t sn, void* U, void* S,
                  void* Vh, int* sweeps, void* stream) {
  if (!fits(elem, m, n) || batch <= 0 || batch > 0x7fffffff ||
      A == nullptr || U == nullptr || S == nullptr || Vh == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return elem == 4 ? launch<float>(A, batch, m, n, sb, sm, sn, U, S, Vh,
                                   sweeps, s)
                   : launch<double>(A, batch, m, n, sb, sm, sn, U, S, Vh,
                                    sweeps, s);
}

}  // extern "C"
