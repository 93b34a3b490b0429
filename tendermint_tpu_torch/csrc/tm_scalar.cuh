// Scalars mod L = 2^252 + 27742317777372353535851937790883648493 for the
// port's CUDA kernels.
//
// Replaces tendermint_tpu/ops/scalar.py (reduce512, lt_L, muladd_mod_L) and
// the comb digit extraction of tendermint_tpu/ops/curve.py (digits10,
// digits12).  The TPU version folds radix-2^8 limbs with Kogge-Stone
// carries in int32; here a scalar is four little-endian uint64 words and
// a 512-bit value is reduced by Barrett's method on 64-bit words (36 word
// products, `__umul64hi` for the high halves, and at most two
// subtractions of L), where a bit-serial long division took 512 dependent
// shift / compare / subtract steps.
#pragma once
#include <stdint.h>

#define TM_SDEV static __device__ __forceinline__

#define SC_L0 0x5812631a5cf5d3edULL
#define SC_L1 0x14def9dea2f79cd6ULL
#define SC_L2 0x0000000000000000ULL
#define SC_L3 0x1000000000000000ULL

TM_SDEV void sc_load(const uint8_t* s, uint64_t w[4]) {
#pragma unroll
  for (int i = 0; i < 4; i++) {
    uint64_t v = 0;
#pragma unroll
    for (int k = 7; k >= 0; k--) v = (v << 8) | s[8 * i + k];
    w[i] = v;
  }
}

TM_SDEV void sc_store(uint8_t* s, const uint64_t w[4]) {
#pragma unroll
  for (int i = 0; i < 4; i++) {
#pragma unroll
    for (int k = 0; k < 8; k++) s[8 * i + k] = (uint8_t)(w[i] >> (8 * k));
  }
}

// a >= L for a 256-bit value
TM_SDEV bool sc_ge_L(const uint64_t a[4]) {
  const uint64_t l[4] = {SC_L0, SC_L1, SC_L2, SC_L3};
#pragma unroll
  for (int i = 3; i >= 0; i--) {
    if (a[i] != l[i]) return a[i] > l[i];
  }
  return true;
}

// Malleability check: little-endian s < L
TM_SDEV bool sc_lt_L(const uint8_t* s) {
  uint64_t w[4];
  sc_load(s, w);
  return !sc_ge_L(w);
}

// floor(2^512 / L), five words (260 bits)
#define SC_MU0 0xed9ce5a30a2c131bULL
#define SC_MU1 0x2106215d086329a7ULL
#define SC_MU2 0xffffffffffffffebULL
#define SC_MU3 0xffffffffffffffffULL
#define SC_MU4 0x000000000000000fULL

// t[k..] += a * b over n words of b, carrying into t[k + n]; t[k + n] is
// overwritten (the caller's columns above k + n - 1 are still zero).
TM_SDEV void sc_mac_row(uint64_t* t, uint64_t a, const uint64_t* b, int n) {
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < n; j++) {
    uint64_t lo = a * b[j];
    uint64_t hi = __umul64hi(a, b[j]);
    uint64_t s = t[j] + lo;
    hi += s < lo;
    s += carry;
    hi += s < carry;
    t[j] = s;
    carry = hi;
  }
  t[n] = carry;
}

// a - b over five words, in place (mod 2^320)
TM_SDEV void sc_sub5(uint64_t a[5], const uint64_t b[5]) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 5; i++) {
    uint64_t d = a[i] - b[i] - borrow;
    borrow = (a[i] < b[i]) | ((a[i] == b[i]) & borrow);
    a[i] = d;
  }
}

// w[0..7] little-endian 512-bit value -> w mod L as four words.
// Barrett with base 2^64 and k = 4 (Handbook of Applied Cryptography,
// algorithm 14.42; 2^192 <= L < 2^256, w < 2^512): q = floor(floor(w /
// 2^192) * mu / 2^320) is floor(w / L) or up to two less, so r = w - q L
// lies in [0, 3L), fits five words and is exact mod 2^320; at most two
// subtractions of L finish it.  Out of line: K5's and K6's per-lane phase
// keep their registers (tests/test_torch_scalar_fold.py models it word for
// word).
static __device__ __noinline__ void sc_reduce_words(const uint64_t* w,
                                                    uint64_t r[4]) {
  const uint64_t mu[5] = {SC_MU0, SC_MU1, SC_MU2, SC_MU3, SC_MU4};
  const uint64_t l[5] = {SC_L0, SC_L1, SC_L2, SC_L3, 0};
  uint64_t q2[10];
#pragma unroll
  for (int i = 0; i < 10; i++) q2[i] = 0;
#pragma unroll
  for (int i = 0; i < 5; i++) sc_mac_row(q2 + i, w[3 + i], mu, 5);
  // q2[5..9] = q; q * L mod 2^320 needs columns 0..4 only
  uint64_t m[6];
#pragma unroll
  for (int i = 0; i < 6; i++) m[i] = 0;
#pragma unroll
  for (int i = 0; i < 5; i++) sc_mac_row(m + i, q2[5 + i], l, 5 - i);
  uint64_t x[5] = {w[0], w[1], w[2], w[3], w[4]};
  sc_sub5(x, m);
#pragma unroll
  for (int k = 0; k < 2; k++) {
    uint64_t y[5] = {x[0], x[1], x[2], x[3], x[4]};
    sc_sub5(y, l);
    bool ge = (y[4] >> 63) == 0;     // x - L >= 0: x < 3L < 2^255
#pragma unroll
    for (int i = 0; i < 5; i++) x[i] = ge ? y[i] : x[i];
  }
#pragma unroll
  for (int i = 0; i < 4; i++) r[i] = x[i];
}

// SHA-512 digest (64 little-endian bytes) -> digest mod L as 32 bytes
TM_SDEV void sc_reduce512(const uint8_t h[64], uint8_t out[32]) {
  uint64_t w[8], r[4];
  sc_load(h, w);
  sc_load(h + 32, w + 4);
  sc_reduce_words(w, r);
  sc_store(out, r);
}

// (r + k*a) mod L: k < L and a < 2^255, so k*a + r < 2^509
TM_SDEV void sc_muladd(const uint8_t k[32], const uint8_t a[32],
                       const uint8_t r[32], uint8_t out[32]) {
  uint64_t kw[4], aw[4], rw[4], t[8], res[4];
  sc_load(k, kw);
  sc_load(a, aw);
  sc_load(r, rw);
#pragma unroll
  for (int i = 0; i < 8; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 4; i++) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 4; j++) {
      uint64_t lo = kw[i] * aw[j];
      uint64_t hi = __umul64hi(kw[i], aw[j]);
      uint64_t s = t[i + j] + lo;
      hi += s < lo;
      s += carry;
      hi += s < carry;
      t[i + j] = s;
      carry = hi;
    }
    t[i + 4] = carry;
  }
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t add = (i < 4) ? rw[i] : 0;
    uint64_t s = t[i] + add;
    uint64_t c1 = s < add;
    s += c;
    c1 += s < c;
    t[i] = s;
    c = c1;
  }
  sc_reduce_words(t, res);
  sc_store(out, res);
}

// Comb digits: bits [pos, pos + width) of a little-endian 256-bit scalar
TM_SDEV int sc_window(const uint64_t w[4], int pos, int width) {
  int idx = pos >> 6, sh = pos & 63;
  uint64_t v = w[idx] >> sh;
  if (sh > 64 - width && idx < 3) v |= w[idx + 1] << (64 - sh);
  return (int)(v & ((1u << width) - 1));
}
