// The DRM generators on the device: lazy-Gaussian samples (lazy_gaussian.cu,
// sparse_psi.cu) and sparse-sign columns (sparse_sign.cu, sparse_psi.cu).
//
// One DRM entry is a pure function of (flat index, column salt):
//   h = splitmix64(flat + salt)            (uint64, wraps mod 2^64)
//   u24 = bits 28..51 of h
//   x = (2*u24 + 1 - 2^24) * 2^-24         (formed exactly in int32)
//   g = sqrt(2) * erfinv_giles_f32(x)
// which is the contract of tt_sketch_tpu/kernels/pallas_rng.py
// (_hash64_pair, _normal_from_pair, _erfinv_f32).  The TPU code emulates
// the 64-bit hash with uint32 limbs; Hopper has 64-bit integer instructions
// (the multiplies become 32-bit IMADs), so the hash is written on uint64_t.
//
// x is formed in int32 because u24 + 0.5f rounds to 2^24 when
// u24 = 2^24 - 1, which gives u = 1 and erfinv(1) = inf.
//
// logf and sqrtf are the accurate library versions (no __logf, no
// --use_fast_math).  nvcc contracts the polynomial into FMAs, so a sample
// can differ from a CPU evaluation of the same formula by a few float32
// ulps (<= 2e-6 absolute at |g| <= 5.5).
//
// Instructions per sample: chip_smoke.py counts them in the built
// lazy_gaussian kernel (cuobjdump -sass), along the path a sample takes
// when it misses the rare erfinv tail (|x| > 0.9966, ~0.3 % of samples,
// which adds sqrtf and its own constants).
//
// A sparse-sign column is nnz hashed +-1 shuffled over `rank` slots, the
// contract of pallas_rng.py (_gen_sign_rows, _swap_position): for draw
// j < nnz, h_j = splitmix64(flat + salt_j) with the salts of columns
// [0, nnz); the sign is bit 52 of h_j, placed at slot j; then a
// Fisher-Yates pass swaps slot j with slot
//   floor(u52_j * (rank - j) / 2^52) + j,   u52_j = low 52 bits of h_j,
// an exact integer.  The TPU code splits the product into uint32 limbs and
// runs each swap as a masked select over the whole block; here one thread
// owns one column and a swap touches two slots.  Values are exactly -1, 0
// or +1.  Two generators:
//   - sign_column_word, for rank <= 32: the column in registers, 2-bit
//     fields of one word; each draw hashed once, its swap position kept in
//     a register until the swaps run;
//   - sign_column, any rank: slots in memory the caller owns (shared
//     memory), each draw hashed twice, so that nothing is kept per draw;
//     __umul64hi gives the high half of the 128-bit product.
#pragma once

#include <stdint.h>

#include <type_traits>

namespace tt_rng {

// The hash's first step adds HASH_ADD; mix64 is the rest, for callers that
// add the constant to a flat index once for all its salts.
constexpr uint64_t HASH_ADD = 0x4BE98134A5976FD3ull;

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ull;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBull;
  x ^= x >> 31;
  return x;
}

__device__ __forceinline__ uint64_t hash64(uint64_t x) {
  return mix64(x + HASH_ADD);
}

// Giles (2010) single-precision erfinv; coefficients highest degree first
// as in pallas_rng.py:_ERFINV_CENTRAL / _ERFINV_TAIL.
__device__ __forceinline__ float erfinv_giles_f32(float x) {
  const float w = -logf((1.0f - x) * (1.0f + x));
  float p;
  if (w < 5.0f) {
    const float wc = w - 2.5f;
    p = 2.81022636e-08f;
    p = 3.43273939e-07f + p * wc;
    p = -3.5233877e-06f + p * wc;
    p = -4.39150654e-06f + p * wc;
    p = 0.00021858087f + p * wc;
    p = -0.00125372503f + p * wc;
    p = -0.00417768164f + p * wc;
    p = 0.246640727f + p * wc;
    p = 1.50140941f + p * wc;
  } else {
    const float wt = sqrtf(w) - 3.0f;
    p = -0.000200214257f;
    p = 0.000100950558f + p * wt;
    p = 0.00134934322f + p * wt;
    p = -0.00367342844f + p * wt;
    p = 0.00573950773f + p * wt;
    p = -0.0076224613f + p * wt;
    p = 0.00943887047f + p * wt;
    p = 1.00167406f + p * wt;
    p = 2.83297682f + p * wt;
  }
  return p * x;
}

__device__ __forceinline__ float normal_from_hash(uint64_t h) {
  const int u24 = (int)((h >> 28) & 0xFFFFFFull);
  const int v = 2 * u24 - (int)0xFFFFFF;  // 2*u24 + 1 - 2^24, exact
  const float x = (float)v * 5.9604644775390625e-08f;  // 2^-24
  return 1.41421354f * erfinv_giles_f32(x);
}

// The N(0,1) sample of DRM column `salt` at flat index `flat`.
__device__ __forceinline__ float sample(uint64_t flat, uint64_t salt) {
  return normal_from_hash(hash64(flat + salt));
}

// Bit 52 of the hash as +-1.
__device__ __forceinline__ int sign_from_hash(uint64_t h) {
  return (int)((h >> 52) & 1ull) * 2 - 1;
}

// floor(u52 * m / 2^52) + j, exact for any m < 2^31: u52 * m < 2^83, its
// bits 52.. are (hi << 12) | (lo >> 52).
__device__ __forceinline__ int swap_position(uint64_t h, int m, int j) {
  const uint64_t u52 = h & 0xFFFFFFFFFFFFFull;
  const uint64_t lo = u52 * (uint64_t)m;
  const uint64_t hi = __umul64hi(u52, (uint64_t)m);
  return (int)((hi << 12) | (lo >> 52)) + j;
}

// One sparse-sign column into slots[s * stride], s in [0, rank): the
// caller's thread owns these slots (registers, shared or local memory; Slot
// is any type holding -1, 0, +1).  salts are those of columns [0, nnz),
// nnz <= rank.  Each draw is hashed twice (once for its sign, once for its
// swap) so that no per-draw state is kept.
template <typename Slot>
__device__ __forceinline__ void sign_column(uint64_t flat,
                                            const uint64_t* salts, int rank,
                                            int nnz, Slot* slots,
                                            int stride) {
#pragma unroll 1
  for (int s = nnz; s < rank; ++s) slots[s * stride] = (Slot)0;
#pragma unroll 1
  for (int j = 0; j < nnz; ++j) {
    slots[j * stride] = (Slot)sign_from_hash(hash64(flat + salts[j]));
  }
#pragma unroll 1
  for (int j = 0; j < nnz; ++j) {
    const int rp = swap_position(hash64(flat + salts[j]), rank - j, j);
    const Slot vj = slots[j * stride];
    slots[j * stride] = slots[rp * stride];
    slots[rp * stride] = vj;
  }
}

// The swap position of swap_position for m <= 4096, in 32-bit arithmetic:
// with u52 = hi20 * 2^32 + lo32, floor(u52 * m / 2^52) =
// (hi20 * m + floor(lo32 * m / 2^32)) >> 20, which is below 2^32 for
// m <= 4096 (the limb form of pallas_rng.py:_swap_position).
__device__ __forceinline__ int swap_position_small(uint64_t h, int m, int j) {
  const uint32_t hi20 = (uint32_t)(h >> 32) & 0xFFFFFu;
  const uint32_t mm = (uint32_t)m;
  return (int)((hi20 * mm + __umulhi((uint32_t)h, mm)) >> 20) + j;
}

// A sign column of at most RB <= 32 slots in one register word: slot s is
// the 2-bit field at bit 2s, read as a two's complement number (00 = 0,
// 01 = +1, 11 = -1).  A 32-bit word holds 16 slots.
template <int RB>
using SignWord =
    typename std::conditional<(RB <= 16), uint32_t, uint64_t>::type;

// Twice the swap positions of a column's draws (each at most 62): an int
// each, or (PACK) one byte each, four to a 32-bit register, for callers
// whose register budget is tight.  Indices are compile-time constants once
// the loops are unrolled, so the array stays in registers.
template <int RB, bool PACK>
struct SwapSlots {
  int v[RB];
  __device__ __forceinline__ void set(int j, int a) { v[j] = a; }
  __device__ __forceinline__ int get(int j) const { return v[j]; }
};

template <int RB>
struct SwapSlots<RB, true> {
  uint32_t v[RB / 4];
  __device__ __forceinline__ void set(int j, int a) {
    const int k = 4 * (j & 3);  // byte j & 3 of word j / 4 takes a
    v[j >> 2] = k == 0 ? (uint32_t)a
                       : __byte_perm(v[j >> 2], (uint32_t)a,
                                     (0x3210u & ~(0xFu << k)) | (4u << k));
  }
  __device__ __forceinline__ int get(int j) const {
    return (int)__byte_perm(v[j >> 2], 0u, 0x4440u | (j & 3));
  }
};

// The sparse-sign column of `flat` for rank <= RB <= 32.  `salts` are those
// of columns [0, nnz) (any memory; every thread reads the same address).
// Pass 1 hashes each draw once: field j starts at 11 (-1) and its high bit
// is flipped when bit 52 is set (01, +1); twice its swap position is kept
// (SwapSlots).  Pass 2 runs the swaps in order on the fields: field j at a
// fixed shift, the other at a variable one, exchanged by an XOR.
//
// Draws go in groups of GROUP under one test of j < nnz, so that a group's
// hash chains interleave.  A draw of the last group past nnz hashes
// salts[j] all the same (the caller makes salts readable up to a multiple
// of GROUP), leaves its field 00 (the flip is masked by the initial word)
// and swaps nothing (a swap range of 0 gives the position j).
template <int RB, int GROUP = 1, bool PACK = false>
__device__ __forceinline__ SignWord<RB> sign_column_word(
    uint64_t flat, const uint64_t* salts, int rank, int nnz) {
  static_assert(RB <= 32 && RB % 4 == 0, "a sign word holds 4..32 slots");
  static_assert(RB % GROUP == 0, "groups of draws tile the bucket");
  using W = SignWord<RB>;
  const uint64_t base = flat + HASH_ADD;
  const W w0 = nnz == RB ? ~(W)0 : ((W)1 << (2 * nnz)) - 1;
  W w = w0;
  SwapSlots<RB, PACK> at;
#pragma unroll
  for (int j0 = 0; j0 < RB; j0 += GROUP) {
    if (j0 >= nnz) break;
#pragma unroll
    for (int j = j0; j < j0 + GROUP; ++j) {
      const uint64_t h = mix64(base + salts[j]);
      w ^= ((W)((h >> 52) & 1u) << (2 * j + 1)) & w0;
      at.set(j, 2 * swap_position_small(h, j < nnz ? rank - j : 0, j));
    }
  }
#pragma unroll
  for (int j0 = 0; j0 < RB; j0 += GROUP) {
    if (j0 >= nnz) break;
#pragma unroll
    for (int j = j0; j < j0 + GROUP; ++j) {
      const int a = at.get(j);
      const W x = ((w >> (2 * j)) ^ (w >> a)) & (W)3;
      w ^= (x << (2 * j)) | (x << a);
    }
  }
  return w;
}

// Slot 0 of a sign word as a float: the field at the top of a 32-bit word
// is 0x40000000 (+1) or 0xC0000000 (-1); less the field's low bit at bit 23
// that is the float 1.0f (0x3F800000) or -1.0f (0xBF800000); 0 stays 0.
__device__ __forceinline__ float sign_slot(uint32_t w) {
  const uint32_t g = w << 30;
  return __uint_as_float(g - ((w & 1u) << 23));
}

}  // namespace tt_rng
