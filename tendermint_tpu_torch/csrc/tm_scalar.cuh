// Scalars mod L = 2^252 + 27742317777372353535851937790883648493 for the
// port's CUDA kernels.
//
// Replaces tendermint_tpu/ops/scalar.py (reduce512, lt_L, muladd_mod_L) and
// the comb digit extraction of tendermint_tpu/ops/curve.py (digits10,
// digits12).  The TPU version folds radix-2^8 limbs with Kogge-Stone
// carries in int32; here a scalar is four little-endian uint64 words.
// reduce512 is bit-serial long division (512 shift / compare / subtract
// steps on 256-bit words): simple and obviously exact; a folded reduction
// is queued as later work (it is ~10% of a verify lane).
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

// w[0..7] little-endian 512-bit value -> w mod L as four words.
static __device__ __noinline__ void sc_reduce_words(const uint64_t* w,
                                                    uint64_t r[4]) {
  const uint64_t l[4] = {SC_L0, SC_L1, SC_L2, SC_L3};
  uint64_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;   // a < L < 2^253 throughout
  for (int bit = 511; bit >= 0; bit--) {
    uint64_t in = (w[bit >> 6] >> (bit & 63)) & 1;
    a3 = (a3 << 1) | (a2 >> 63);
    a2 = (a2 << 1) | (a1 >> 63);
    a1 = (a1 << 1) | (a0 >> 63);
    a0 = (a0 << 1) | in;
    uint64_t a[4] = {a0, a1, a2, a3};
    if (sc_ge_L(a)) {
      uint64_t b = 0;
      uint64_t d0 = a0 - l[0];
      b = a0 < l[0];
      uint64_t d1 = a1 - l[1] - b;
      b = (a1 < l[1]) | ((a1 == l[1]) & b);
      uint64_t d2 = a2 - l[2] - b;
      b = (a2 < l[2]) | ((a2 == l[2]) & b);
      uint64_t d3 = a3 - l[3] - b;
      a0 = d0; a1 = d1; a2 = d2; a3 = d3;
    }
  }
  r[0] = a0; r[1] = a1; r[2] = a2; r[3] = a3;
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
