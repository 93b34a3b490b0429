// GF(2^255 - 19) arithmetic for the port's CUDA kernels.
//
// Replaces the limb layer of tendermint_tpu/ops/field.py.  The TPU version
// holds 32 limbs of 8 bits and multiplies with an f32 convolution because
// the TPU has no 64-bit integer multiply; Hopper has 32x32->64 multiplies
// (IMAD.WIDE), so an element here is 10 limbs in radix 2^25.5 (the ref10
// layout: limb i has weight 2^ceil(25.5 i), 26 bits for even i, 25 for
// odd), and a product is 100 wide multiplies folded by 19 (2^255 = 19).
//
// Invariant: every limb of every element is NONNEGATIVE and below 2^26
// (odd limbs below 2^25 + 2^17).  Products then stay below 2^57.3 and a
// column of ten below 2^61, exact in int64; carries are floor shifts of
// nonnegative values, so no signed-shift corner cases arise.  Subtraction
// adds 2p first to keep values nonnegative.  Only fe_tobytes reduces to the
// canonical representative in [0, p).
#pragma once
#include <stdint.h>

#define TM_DEV static __device__ __forceinline__

struct fe {
  int32_t v[10];
};

// limb widths: 26 bits for even limbs, 25 for odd ones
#define FE_BITS(i) (((i) & 1) ? 25 : 26)
#define FE_MASK(i) (((i) & 1) ? 0x1ffffff : 0x3ffffff)

// Carry a column vector into the invariant: one floor-carry pass over the
// limbs, limb 9's carry folded into limb 0 by 19, then limb 0 -> limb 1.
TM_DEV fe fe_carry(int64_t h[10]) {
#pragma unroll
  for (int i = 0; i < 10; i++) {
    int64_t c = h[i] >> FE_BITS(i);
    h[i] &= FE_MASK(i);
    if (i < 9) h[i + 1] += c;
    else h[0] += 19 * c;
  }
  int64_t c = h[0] >> 26;
  h[0] &= 0x3ffffff;
  h[1] += c;
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = (int32_t)h[i];
  return r;
}

TM_DEV fe fe_zero() {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = 0;
  return r;
}

TM_DEV fe fe_one() {
  fe r = fe_zero();
  r.v[0] = 1;
  return r;
}

TM_DEV fe fe_add(const fe& f, const fe& g) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = (int64_t)f.v[i] + g.v[i];
  return fe_carry(h);
}

// f - g + 2p: 2p's limbs exceed every limb the invariant allows in g
TM_DEV fe fe_sub(const fe& f, const fe& g) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    int64_t two_p = (i == 0) ? 2 * (0x3ffffff - 18) : 2 * (int64_t)FE_MASK(i);
    h[i] = (int64_t)f.v[i] + two_p - g.v[i];
  }
  return fe_carry(h);
}

TM_DEV fe fe_neg(const fe& f) { return fe_sub(fe_zero(), f); }

// kp * p + ax * x + ay * y with ONE carry pass over all limbs at once (no
// serial chain), in int32.  The sum must lie in [0, 2^28) per limb: kp is
// 2 or 4 where a term is negative (x and y below 2^26 + 133 per limb).
// Out: limbs below 2^bits + 7, limb 0 below 2^26 + 133: inside fe_mul's
// and fe_sq's operand bounds (2^26.7), 2p's limbs (so fe_sub stays
// nonnegative) and fe_tobytes' domain, and a further fe_lin of such
// values stays there.
TM_DEV fe fe_lin(int kp, int ax, const fe& x, int ay, const fe& y) {
  int32_t h[10], c[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    int32_t p = (i == 0) ? 0x3ffffed : FE_MASK(i);
    h[i] = kp * p + ax * x.v[i] + ay * y.v[i];
    c[i] = h[i] >> FE_BITS(i);
  }
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++)
    r.v[i] = (h[i] & FE_MASK(i)) + (i ? c[i - 1] : 19 * c[9]);
  return r;
}

// Kept out of line: a verify lane runs ~600 products, and one shared body
// keeps the kernels' code (and nvcc's time) small.  Arguments by value pass
// in registers.  A kernel that defines TM_FE_MUL_INLINE before including
// this header gets the products inline instead (K5: a one- or two-block
// launch, where the lane's latency is the time; K1: its block's inversion,
// one warp's chain, is its tail).
#ifdef TM_FE_MUL_INLINE
#define TM_FE_MUL static __device__ __forceinline__
#else
#define TM_FE_MUL static __device__ __noinline__
#endif
TM_FE_MUL fe fe_mul(fe f, fe g) {
  int32_t g19[10], f2[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    g19[i] = 19 * g.v[i];
    f2[i] = 2 * f.v[i];
  }
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 10; j++) {
      // odd x odd limbs overshoot the product's weight by one bit; limbs
      // past 2^255 wrap with a factor 19
      int32_t a = (i & j & 1) ? f2[i] : f.v[i];
      int32_t b = (i + j >= 10) ? g19[j] : g.v[j];
      h[(i + j) % 10] += (int64_t)a * b;
    }
  }
  return fe_carry(h);
}

// f^2 in 55 wide multiplies: each cross product f_i f_j (i < j) once,
// doubled through its operand (2f, or 4f for odd x odd), with 19f for
// limbs past 2^255.  Operands stay in int32 (4f < 2^29, 19f < 2^31 for
// limbs below 2^26.7) and each column is fe_mul's column, so the same
// int64 bound holds.
TM_FE_MUL fe fe_sq(fe f) {
  int32_t f2[10], f4[10], f19[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    f2[i] = 2 * f.v[i];
    f4[i] = 4 * f.v[i];
    f19[i] = 19 * f.v[i];
  }
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = i; j < 10; j++) {
      int m = (i == j ? 1 : 2) * ((i & j & 1) ? 2 : 1);
      int32_t a = m == 1 ? f.v[i] : (m == 2 ? f2[i] : f4[i]);
      int32_t b = (i + j >= 10) ? f19[j] : f.v[j];
      h[(i + j) % 10] += (int64_t)a * b;
    }
  }
  return fe_carry(h);
}

static __device__ __noinline__ fe fe_sqn(fe f, int n) {
  for (int i = 0; i < n; i++) f = fe_sq(f);
  return f;
}

// Little-endian 32 bytes -> element (all 256 bits: bit 255 folds as 19).
TM_DEV fe fe_frombytes(const uint8_t* s) {
  fe r;
  uint64_t acc = 0;
  int nbits = 0, byte = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    while (nbits < FE_BITS(i)) {
      acc |= (uint64_t)s[byte++] << nbits;
      nbits += 8;
    }
    r.v[i] = (int32_t)(acc & FE_MASK(i));
    acc >>= FE_BITS(i);
    nbits -= FE_BITS(i);
  }
  // 255 bits consumed from 256 loaded: acc holds bit 255
  r.v[0] += 19 * (int32_t)(acc & 1);
  return r;
}

// Canonical little-endian encoding of f mod p as eight 32-bit words.
static __device__ __noinline__ void fe_towords(uint32_t s[8], fe f) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = f.v[i];
  // two carry passes: limbs 1..9 exact, value x < 2^255 + 19*2
#pragma unroll
  for (int pass = 0; pass < 2; pass++) {
#pragma unroll
    for (int i = 0; i < 10; i++) {
      int64_t c = h[i] >> FE_BITS(i);
      h[i] &= FE_MASK(i);
      if (i < 9) h[i + 1] += c;
      else h[0] += 19 * c;
    }
  }
  // q = floor((x + 19) / 2^255) is 1 exactly when x >= p
  int64_t q = (h[0] + 19) >> 26;
#pragma unroll
  for (int i = 1; i < 10; i++) q = (h[i] + q) >> FE_BITS(i);
  h[0] += 19 * q;
  // final pass drops the carry out of limb 9: subtracts q * 2^255
#pragma unroll
  for (int i = 0; i < 9; i++) {
    int64_t c = h[i] >> FE_BITS(i);
    h[i] &= FE_MASK(i);
    h[i + 1] += c;
  }
  h[9] &= FE_MASK(9);
  uint64_t acc = 0;
  int nbits = 0, word = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    acc |= (uint64_t)h[i] << nbits;
    nbits += FE_BITS(i);
    if (nbits >= 32) {
      s[word++] = (uint32_t)acc;
      acc >>= 32;
      nbits -= 32;
    }
  }
  s[7] = (uint32_t)acc;  // the last 31 bits
}

// Canonical little-endian encoding of f mod p as 32 bytes.
TM_DEV void fe_tobytes(uint8_t* s, fe f) {
  uint32_t w[8];
  fe_towords(w, f);
#pragma unroll
  for (int i = 0; i < 32; i++) s[i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
}

// Eight little-endian 32-bit words -> element (bit 255 folds as 19).
TM_DEV fe fe_fromwords(const uint32_t* w) {
  fe r;
  uint64_t acc = 0;
  int nbits = 0, word = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    if (nbits < FE_BITS(i)) {
      acc |= (uint64_t)w[word++] << nbits;
      nbits += 32;
    }
    r.v[i] = (int32_t)(acc & FE_MASK(i));
    acc >>= FE_BITS(i);
    nbits -= FE_BITS(i);
  }
  r.v[0] += 19 * (int32_t)(acc & 1);
  return r;
}

TM_DEV bool fe_iszero(const fe& f) {
  uint8_t s[32];
  fe_tobytes(s, f);
  uint8_t acc = 0;
#pragma unroll
  for (int i = 0; i < 32; i++) acc |= s[i];
  return acc == 0;
}

TM_DEV bool fe_eq(const fe& f, const fe& g) { return fe_iszero(fe_sub(f, g)); }

TM_DEV int fe_parity(const fe& f) {
  uint8_t s[32];
  fe_tobytes(s, f);
  return s[0] & 1;
}

// z^(2^250 - 1) and z^11 by the ref10 addition chain
static __device__ __noinline__ void fe_pow_2_250_1(fe z, fe* t250, fe* z11) {
  fe t0 = fe_sq(z);                      // 2
  fe t1 = fe_mul(z, fe_sqn(t0, 2));      // 9
  fe z_11 = fe_mul(t0, t1);              // 11
  *z11 = z_11;
  t1 = fe_mul(t1, fe_sq(z_11));          // 2^5 - 1
  t1 = fe_mul(fe_sqn(t1, 5), t1);        // 2^10 - 1
  fe t2 = fe_mul(fe_sqn(t1, 10), t1);    // 2^20 - 1
  t2 = fe_mul(fe_sqn(t2, 20), t2);       // 2^40 - 1
  t1 = fe_mul(fe_sqn(t2, 10), t1);       // 2^50 - 1
  t2 = fe_mul(fe_sqn(t1, 50), t1);       // 2^100 - 1
  t2 = fe_mul(fe_sqn(t2, 100), t2);      // 2^200 - 1
  *t250 = fe_mul(fe_sqn(t2, 50), t1);    // 2^250 - 1
}

// z^(p - 2) = z^(2^255 - 21); 0 maps to 0
TM_DEV fe fe_invert(fe z) {
  fe t, z11;
  fe_pow_2_250_1(z, &t, &z11);
  return fe_mul(fe_sqn(t, 5), z11);
}

// z^((p - 5) / 8) = z^(2^252 - 3)
TM_DEV fe fe_pow22523(fe z) {
  fe t, z11;
  fe_pow_2_250_1(z, &t, &z11);
  return fe_mul(fe_sqn(t, 2), z);
}

TM_DEV fe fe_d() {  // d = -121665/121666
  return fe{{56195235, 13857412, 51736253, 6949390, 114729, 24766616,
             60832955, 30306712, 48412415, 21499315}};
}

TM_DEV fe fe_d2() {  // 2d
  return fe{{45281625, 27714825, 36363642, 13898781, 229458, 15978800,
             54557047, 27058993, 29715967, 9444199}};
}

TM_DEV fe fe_sqrt_m1() {  // sqrt(-1) = 2^((p-1)/4)
  return fe{{34513072, 25610706, 9377949, 3500415, 12389472, 33281959,
             41962654, 31548777, 326685, 11406482}};
}

TM_DEV fe fe_sel(bool c, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// Whole-warp shuffles of an element (every lane of the warp must call)
TM_DEV fe fe_shfl_up(const fe& f, int d) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = __shfl_up_sync(0xffffffffu, f.v[i], d);
  return r;
}

TM_DEV fe fe_shfl_down(const fe& f, int d) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++)
    r.v[i] = __shfl_down_sync(0xffffffffu, f.v[i], d);
  return r;
}

TM_DEV fe fe_shfl_lane(const fe& f, int src) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = __shfl_sync(0xffffffffu, f.v[i], src);
  return r;
}

// Montgomery's trick over one warp (every lane must call): *others = the
// product of the other 31 lanes' z, *total = the product of all 32, from
// an inclusive prefix and suffix scan (5 + 5 products per lane).  Then
// 1 / z = others / total: one inversion serves the warp.
static __device__ void fe_warp_products(const fe& z, fe* others, fe* total) {
  int lane = threadIdx.x & 31;
  fe pre = z, suf = z;
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    fe a = fe_shfl_up(pre, d), b = fe_shfl_down(suf, d);
    pre = fe_mul(pre, fe_sel(lane >= d, a, fe_one()));
    suf = fe_mul(suf, fe_sel(lane + d < 32, b, fe_one()));
  }
  fe ep = fe_sel(lane > 0, fe_shfl_up(pre, 1), fe_one());
  fe es = fe_sel(lane < 31, fe_shfl_down(suf, 1), fe_one());
  *others = fe_mul(ep, es);
  *total = fe_shfl_lane(suf, 0);
}

// Montgomery's trick over a block of `nwarps` warps (every thread of the
// block must call; `sm` holds (nwarps + 1) * 10 int32 of shared memory):
// returns 1 / z on every thread, with ONE `fe_invert`, by warp 0, for the
// whole block.  The warps' totals meet in shared memory; each thread
// multiplies the block's inverse by the product of every other z.  Every
// z must be nonzero.
static __device__ fe fe_block_invert(const fe& z, int nwarps, int32_t* sm) {
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  fe others, total;
  fe_warp_products(z, &others, &total);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 10; i++) sm[warp * 10 + i] = total.v[i];
  }
  __syncthreads();
  fe rest = fe_one();         // the other warps' totals
  for (int k = 0; k < nwarps; k++) {
    fe tk;
#pragma unroll
    for (int i = 0; i < 10; i++) tk.v[i] = sm[k * 10 + i];
    if (k != warp) rest = fe_mul(rest, tk);
  }
  if (warp == 0) {
    fe inv = fe_invert(fe_mul(rest, total));
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 10; i++) sm[nwarps * 10 + i] = inv.v[i];
    }
  }
  __syncthreads();
  fe inv;
#pragma unroll
  for (int i = 0; i < 10; i++) inv.v[i] = sm[nwarps * 10 + i];
  return fe_mul(fe_mul(inv, rest), others);
}
