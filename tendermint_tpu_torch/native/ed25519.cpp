// ed25519 on the host: the port's native rung of the crypto ladder.
//
// The JAX package's scalar path runs OpenSSL through the `cryptography`
// wheel (tendermint_tpu/crypto/native.py); the port has its own, built
// with the host compiler beside tmhash.cpp into one library and bound
// with ctypes (tendermint_tpu_torch/utils/nativelib.py).  It links no
// libcrypto: SHA-512, the field, the scalars mod L and the group are here.
//
// Semantics are exactly those of crypto/pure_ed25519.py:
//   - A and R decode with y >= p rejected, and x = 0 with the sign bit
//     set rejected; a y whose x^2 is no square is rejected;
//   - s >= L is rejected;
//   - k = SHA-512(R || A || M) mod L;
//   - cofactorless: [s]B - [k]A == R, compared as points (X1 Z2 == X2 Z1,
//     Y1 Z2 == Y2 Z1), not as encodings.
// Signing follows RFC 8032 and gives pure_ed25519.sign's bytes.
//
// The field is radix 2^51 in five uint64 limbs with unsigned __int128
// products; scalars are four uint64 words reduced by Barrett's method, as
// in csrc/tm_scalar.cuh.  Signing walks its secret scalars with a fixed
// sequence of group operations: 64 windows of 4 bits, four doublings and
// one complete addition each, the addend taken from a 16-entry table of
// multiples of B by a masked scan of every entry.  No branch and no
// memory address depends on the secret.  Verification handles public data
// only and skips zero digits.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

typedef unsigned __int128 u128;

// --- SHA-512 ----------------------------------------------------------------

constexpr uint64_t K512[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

inline uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

struct Sha512 {
  uint64_t h[8] = {0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
                   0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
                   0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
                   0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
  uint8_t buf[128];
  uint64_t total = 0;
  size_t fill = 0;

  void compress(const uint8_t* p) {
    uint64_t w[80];
    for (int i = 0; i < 16; i++) {
      uint64_t v = 0;
      for (int k = 0; k < 8; k++) v = (v << 8) | p[8 * i + k];
      w[i] = v;
    }
    for (int i = 16; i < 80; i++) {
      uint64_t s0 = rotr64(w[i - 15], 1) ^ rotr64(w[i - 15], 8) ^
                    (w[i - 15] >> 7);
      uint64_t s1 = rotr64(w[i - 2], 19) ^ rotr64(w[i - 2], 61) ^
                    (w[i - 2] >> 6);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint64_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint64_t e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 80; i++) {
      uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
      uint64_t ch = (e & f) ^ (~e & g);
      uint64_t t1 = hh + S1 + ch + K512[i] + w[i];
      uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
      uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint64_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* p, size_t n) {
    total += n;
    if (fill) {
      size_t take = 128 - fill < n ? 128 - fill : n;
      std::memcpy(buf + fill, p, take);
      fill += take; p += take; n -= take;
      if (fill == 128) { compress(buf); fill = 0; }
    }
    while (n >= 128) { compress(p); p += 128; n -= 128; }
    if (n) { std::memcpy(buf, p, n); fill = n; }
  }

  void final(uint8_t out[64]) {
    uint64_t bits = total * 8;
    buf[fill++] = 0x80;
    if (fill > 112) {
      std::memset(buf + fill, 0, 128 - fill);
      compress(buf);
      fill = 0;
    }
    std::memset(buf + fill, 0, 120 - fill);   // high 64 length bits: 0
    for (int i = 0; i < 8; i++) buf[120 + i] = uint8_t(bits >> (56 - 8 * i));
    compress(buf);
    for (int i = 0; i < 8; i++)
      for (int k = 0; k < 8; k++) out[8 * i + k] = uint8_t(h[i] >> (56 - 8 * k));
  }
};

void sha512_3(const uint8_t* a, size_t na, const uint8_t* b, size_t nb,
              const uint8_t* c, size_t nc, uint8_t out[64]) {
  Sha512 s;
  s.update(a, na);
  s.update(b, nb);
  if (nc) s.update(c, nc);
  s.final(out);
}

// --- the field GF(2^255 - 19), radix 2^51 -----------------------------------

constexpr uint64_t M51 = (1ULL << 51) - 1;

struct fe { uint64_t v[5]; };

inline uint64_t load64(const uint8_t* s) {
  uint64_t r = 0;
  for (int k = 7; k >= 0; k--) r = (r << 8) | s[k];
  return r;
}

// the low 255 bits of 32 little-endian bytes (the sign bit dropped)
fe fe_frombytes(const uint8_t s[32]) {
  uint64_t w0 = load64(s), w1 = load64(s + 8), w2 = load64(s + 16),
           w3 = load64(s + 24);
  return {{w0 & M51, ((w0 >> 51) | (w1 << 13)) & M51,
           ((w1 >> 38) | (w2 << 26)) & M51, ((w2 >> 25) | (w3 << 39)) & M51,
           (w3 >> 12) & M51}};
}

// one carry chain: every limb < 2^51 but limb 0 (< 2^51 + 19 * carry)
inline void fe_carry(fe& h) {
  uint64_t c;
  c = h.v[0] >> 51; h.v[0] &= M51; h.v[1] += c;
  c = h.v[1] >> 51; h.v[1] &= M51; h.v[2] += c;
  c = h.v[2] >> 51; h.v[2] &= M51; h.v[3] += c;
  c = h.v[3] >> 51; h.v[3] &= M51; h.v[4] += c;
  c = h.v[4] >> 51; h.v[4] &= M51; h.v[0] += 19 * c;
}

// the canonical 32 bytes (value mod p in [0, p)); constant time
void fe_tobytes(uint8_t out[32], const fe& h) {
  fe t = h;
  fe_carry(t);
  fe_carry(t);
  fe_carry(t);                 // limbs < 2^51, value < 2^255
  uint64_t q = (t.v[0] + 19) >> 51;
  q = (t.v[1] + q) >> 51;
  q = (t.v[2] + q) >> 51;
  q = (t.v[3] + q) >> 51;
  q = (t.v[4] + q) >> 51;      // 1 iff value >= p
  t.v[0] += 19 * q;
  uint64_t c;
  c = t.v[0] >> 51; t.v[0] &= M51; t.v[1] += c;
  c = t.v[1] >> 51; t.v[1] &= M51; t.v[2] += c;
  c = t.v[2] >> 51; t.v[2] &= M51; t.v[3] += c;
  c = t.v[3] >> 51; t.v[3] &= M51; t.v[4] += c;
  t.v[4] &= M51;               // drops 2^255: subtracts p when q = 1
  uint64_t w[4] = {t.v[0] | (t.v[1] << 51), (t.v[1] >> 13) | (t.v[2] << 38),
                   (t.v[2] >> 26) | (t.v[3] << 25),
                   (t.v[3] >> 39) | (t.v[4] << 12)};
  for (int i = 0; i < 4; i++)
    for (int k = 0; k < 8; k++) out[8 * i + k] = uint8_t(w[i] >> (8 * k));
}

inline fe fe_add(const fe& a, const fe& b) {
  fe r;
  for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + b.v[i];
  fe_carry(r);
  return r;
}

// a - b + 4p, so no limb goes negative for carried inputs
inline fe fe_sub(const fe& a, const fe& b) {
  fe r;
  r.v[0] = a.v[0] + 0x1fffffffffffb4ULL - b.v[0];
  for (int i = 1; i < 5; i++) r.v[i] = a.v[i] + 0x1ffffffffffffcULL - b.v[i];
  fe_carry(r);
  return r;
}

inline fe fe_neg(const fe& a) { return fe_sub(fe{{0, 0, 0, 0, 0}}, a); }

fe fe_mul(const fe& a, const fe& b) {
  const uint64_t* x = a.v;
  const uint64_t* y = b.v;
  uint64_t y1 = 19 * y[1], y2 = 19 * y[2], y3 = 19 * y[3], y4 = 19 * y[4];
  u128 r0 = (u128)x[0] * y[0] + (u128)x[1] * y4 + (u128)x[2] * y3 +
            (u128)x[3] * y2 + (u128)x[4] * y1;
  u128 r1 = (u128)x[0] * y[1] + (u128)x[1] * y[0] + (u128)x[2] * y4 +
            (u128)x[3] * y3 + (u128)x[4] * y2;
  u128 r2 = (u128)x[0] * y[2] + (u128)x[1] * y[1] + (u128)x[2] * y[0] +
            (u128)x[3] * y4 + (u128)x[4] * y3;
  u128 r3 = (u128)x[0] * y[3] + (u128)x[1] * y[2] + (u128)x[2] * y[1] +
            (u128)x[3] * y[0] + (u128)x[4] * y4;
  u128 r4 = (u128)x[0] * y[4] + (u128)x[1] * y[3] + (u128)x[2] * y[2] +
            (u128)x[3] * y[1] + (u128)x[4] * y[0];
  fe h;
  r1 += (uint64_t)(r0 >> 51); h.v[0] = (uint64_t)r0 & M51;
  r2 += (uint64_t)(r1 >> 51); h.v[1] = (uint64_t)r1 & M51;
  r3 += (uint64_t)(r2 >> 51); h.v[2] = (uint64_t)r2 & M51;
  r4 += (uint64_t)(r3 >> 51); h.v[3] = (uint64_t)r3 & M51;
  u128 t = (u128)h.v[0] + (r4 >> 51) * 19;
  h.v[4] = (uint64_t)r4 & M51;
  h.v[0] = (uint64_t)t & M51;
  h.v[1] += (uint64_t)(t >> 51);
  return h;
}

inline fe fe_sq(const fe& a) { return fe_mul(a, a); }

inline fe fe_sqn(fe a, int n) {
  for (int i = 0; i < n; i++) a = fe_sq(a);
  return a;
}

// z^(2^250 - 1), and z^11 beside it (ref10's chain)
fe fe_pow2_250_1(const fe& z, fe& z11) {
  fe z2 = fe_sq(z);
  fe z9 = fe_mul(fe_sqn(z2, 2), z);
  z11 = fe_mul(z9, z2);
  fe z5 = fe_mul(fe_sq(z11), z9);                 // 2^5 - 1
  fe z10 = fe_mul(fe_sqn(z5, 5), z5);             // 2^10 - 1
  fe z20 = fe_mul(fe_sqn(z10, 10), z10);          // 2^20 - 1
  fe z40 = fe_mul(fe_sqn(z20, 20), z20);          // 2^40 - 1
  fe z50 = fe_mul(fe_sqn(z40, 10), z10);          // 2^50 - 1
  fe z100 = fe_mul(fe_sqn(z50, 50), z50);         // 2^100 - 1
  fe z200 = fe_mul(fe_sqn(z100, 100), z100);      // 2^200 - 1
  return fe_mul(fe_sqn(z200, 50), z50);           // 2^250 - 1
}

fe fe_invert(const fe& z) {                        // z^(p - 2)
  fe z11;
  fe t = fe_pow2_250_1(z, z11);
  return fe_mul(fe_sqn(t, 5), z11);                // 2^255 - 21
}

fe fe_pow22523(const fe& z) {                      // z^((p - 5) / 8)
  fe z11;
  fe t = fe_pow2_250_1(z, z11);
  return fe_mul(fe_sqn(t, 2), z);                  // 2^252 - 3
}

bool fe_eq(const fe& a, const fe& b) {
  uint8_t x[32], y[32];
  fe_tobytes(x, a);
  fe_tobytes(y, b);
  return std::memcmp(x, y, 32) == 0;
}

bool fe_iszero(const fe& a) {
  uint8_t x[32];
  fe_tobytes(x, a);
  uint8_t acc = 0;
  for (int i = 0; i < 32; i++) acc |= x[i];
  return acc == 0;
}

int fe_isodd(const fe& a) {
  uint8_t x[32];
  fe_tobytes(x, a);
  return x[0] & 1;
}

fe fe_small(uint64_t n) { return fe{{n, 0, 0, 0, 0}}; }

// r = b if flag else r, flag in {0, 1}, by mask
inline void fe_cmov(fe& r, const fe& b, uint64_t flag) {
  uint64_t m = 0 - flag;
  for (int i = 0; i < 5; i++) r.v[i] ^= m & (r.v[i] ^ b.v[i]);
}

// --- the group: extended coordinates (X : Y : Z : T), T = XY / Z ------------

struct ge { fe X, Y, Z, T; };

struct FieldConsts { fe d, d2, sqrtm1; };

struct BaseConsts {
  ge B;
  ge tab[16];                  // i * B
};

fe fe_pow_vartime(const fe& z, const uint8_t e[32]) {
  fe r = fe_small(1);
  for (int bit = 255; bit >= 0; bit--) {
    r = fe_sq(r);
    if ((e[bit >> 3] >> (bit & 7)) & 1) r = fe_mul(r, z);
  }
  return r;
}

ge ge_identity() { return ge{fe_small(0), fe_small(1), fe_small(1), fe_small(0)}; }

// d = -121665 / 121666, 2d, sqrt(-1) = 2^((p - 1) / 4); built once
const FieldConsts& field_consts() {
  static const FieldConsts c = [] {
    FieldConsts k;
    k.d = fe_mul(fe_neg(fe_small(121665)), fe_invert(fe_small(121666)));
    k.d2 = fe_add(k.d, k.d);
    uint8_t e[32];
    std::memset(e, 0xff, 32);
    e[0] = 0xfb;                                   // 2^253 - 5
    e[31] = 0x1f;
    k.sqrtm1 = fe_pow_vartime(fe_small(2), e);
    return k;
  }();
  return c;
}

const BaseConsts& base_consts();

// complete addition (add-2008-hwcd-3 with k = 2d), the formula of
// pure_ed25519.pt_add
ge ge_add(const ge& p, const ge& q) {
  const FieldConsts& c = field_consts();
  fe a = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  fe b = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  fe cc = fe_mul(fe_mul(p.T, q.T), c.d2);
  fe zz = fe_mul(p.Z, q.Z);
  fe dd = fe_add(zz, zz);
  fe e = fe_sub(b, a), f = fe_sub(dd, cc), g = fe_add(dd, cc),
     h = fe_add(b, a);
  return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

// doubling (ref10's ge_p2_dbl then p1p1 -> p3); valid for every point
ge ge_dbl(const ge& p) {
  fe xx = fe_sq(p.X), yy = fe_sq(p.Y);
  fe zz = fe_sq(p.Z);
  fe b = fe_add(zz, zz);
  fe s = fe_sq(fe_add(p.X, p.Y));
  fe h = fe_add(yy, xx);
  fe e = fe_sub(s, h);                             // 2XY
  fe g = fe_sub(yy, xx);
  fe f = fe_sub(b, g);
  return ge{fe_mul(e, f), fe_mul(h, g), fe_mul(g, f), fe_mul(e, h)};
}

ge ge_neg(const ge& p) { return ge{fe_neg(p.X), p.Y, p.Z, fe_neg(p.T)}; }

// pure_ed25519.pt_decode: None <-> false
bool ge_decode(ge& out, const uint8_t s[32]) {
  const FieldConsts& c = field_consts();
  // y < p: the low 255 bits are not in [2^255 - 19, 2^255 - 1]
  bool high = (s[31] & 0x7f) == 0x7f && s[0] >= 0xed;
  for (int i = 1; i < 31; i++) high = high && s[i] == 0xff;
  if (high) return false;
  int sign = s[31] >> 7;
  fe y = fe_frombytes(s);
  fe yy = fe_sq(y);
  fe u = fe_sub(yy, fe_small(1));
  fe v = fe_add(fe_mul(c.d, yy), fe_small(1));
  fe x;
  if (fe_iszero(u)) {
    if (sign) return false;                        // x = 0, sign bit set
    x = fe_small(0);
  } else {
    fe v3 = fe_mul(fe_sq(v), v);
    fe v7 = fe_mul(fe_sq(v3), v);
    x = fe_mul(fe_mul(u, v3), fe_pow22523(fe_mul(u, v7)));
    fe vxx = fe_mul(v, fe_sq(x));
    if (fe_eq(vxx, u)) {
    } else if (fe_eq(vxx, fe_neg(u))) {
      x = fe_mul(x, c.sqrtm1);
    } else {
      return false;                                // x^2 is no square
    }
    if (fe_isodd(x) != sign) x = fe_neg(x);
  }
  out = ge{x, y, fe_small(1), fe_mul(x, y)};
  return true;
}

void ge_encode(uint8_t out[32], const ge& p) {
  fe zi = fe_invert(p.Z);
  fe x = fe_mul(p.X, zi), y = fe_mul(p.Y, zi);
  fe_tobytes(out, y);
  out[31] |= uint8_t(fe_isodd(x) << 7);
}

// B (y = 4/5, x even) and its multiples 0..15; built once
const BaseConsts& base_consts() {
  static const BaseConsts c = [] {
    BaseConsts k;
    uint8_t enc[32];
    fe_tobytes(enc, fe_mul(fe_small(4), fe_invert(fe_small(5))));
    ge_decode(k.B, enc);
    k.tab[0] = ge_identity();
    for (int i = 1; i < 16; i++) k.tab[i] = ge_add(k.tab[i - 1], k.B);
    return k;
  }();
  return c;
}

// --- scalars mod L (csrc/tm_scalar.cuh on the host) -------------------------

constexpr uint64_t L_W[5] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                             0, 0x1000000000000000ULL, 0};
constexpr uint64_t MU_W[5] = {0xed9ce5a30a2c131bULL, 0x2106215d086329a7ULL,
                              0xffffffffffffffebULL, 0xffffffffffffffffULL,
                              0x000000000000000fULL};   // floor(2^512 / L)

void sc_load(const uint8_t* s, uint64_t w[4]) {
  for (int i = 0; i < 4; i++) w[i] = load64(s + 8 * i);
}

void sc_store(uint8_t* s, const uint64_t w[4]) {
  for (int i = 0; i < 4; i++)
    for (int k = 0; k < 8; k++) s[8 * i + k] = uint8_t(w[i] >> (8 * k));
}

// t[0..n] += a * b[0..n-1]; t[n] overwritten
void sc_mac_row(uint64_t* t, uint64_t a, const uint64_t* b, int n) {
  uint64_t carry = 0;
  for (int j = 0; j < n; j++) {
    u128 s = (u128)a * b[j] + t[j] + carry;
    t[j] = (uint64_t)s;
    carry = (uint64_t)(s >> 64);
  }
  t[n] = carry;
}

// a -= b over five words; returns the borrow out
uint64_t sc_sub5(uint64_t a[5], const uint64_t b[5]) {
  uint64_t borrow = 0;
  for (int i = 0; i < 5; i++) {
    u128 d = (u128)a[i] - b[i] - borrow;
    a[i] = (uint64_t)d;
    borrow = (uint64_t)(d >> 64) & 1;
  }
  return borrow;
}

// 512-bit w (eight little-endian words) mod L, Barrett with base 2^64
// (HAC 14.42); constant time: the two final subtractions are masked
void sc_reduce_words(const uint64_t w[8], uint64_t r[4]) {
  uint64_t q2[10] = {0};
  for (int i = 0; i < 5; i++) sc_mac_row(q2 + i, w[3 + i], MU_W, 5);
  uint64_t m[6] = {0};
  for (int i = 0; i < 5; i++) sc_mac_row(m + i, q2[5 + i], L_W, 5 - i);
  uint64_t x[5] = {w[0], w[1], w[2], w[3], w[4]};
  sc_sub5(x, m);
  for (int k = 0; k < 2; k++) {
    uint64_t y[5] = {x[0], x[1], x[2], x[3], x[4]};
    uint64_t lt = sc_sub5(y, L_W);                 // 1 iff x < L
    uint64_t keep = 0 - lt;
    for (int i = 0; i < 5; i++) x[i] = (x[i] & keep) | (y[i] & ~keep);
  }
  for (int i = 0; i < 4; i++) r[i] = x[i];
}

void sc_reduce512(const uint8_t h[64], uint8_t out[32]) {
  uint64_t w[8], r[4];
  sc_load(h, w);
  sc_load(h + 32, w + 4);
  sc_reduce_words(w, r);
  sc_store(out, r);
}

// (r + k * a) mod L for k < L, a < 2^255, r < L
void sc_muladd(const uint8_t k[32], const uint8_t a[32], const uint8_t r[32],
               uint8_t out[32]) {
  uint64_t kw[4], aw[4], rw[4], t[8] = {0}, res[4];
  sc_load(k, kw);
  sc_load(a, aw);
  sc_load(r, rw);
  for (int i = 0; i < 4; i++) sc_mac_row(t + i, kw[i], aw, 4);
  uint64_t c = 0;
  for (int i = 0; i < 8; i++) {
    u128 s = (u128)t[i] + (i < 4 ? rw[i] : 0) + c;
    t[i] = (uint64_t)s;
    c = (uint64_t)(s >> 64);
  }
  sc_reduce_words(t, res);
  sc_store(out, res);
}

bool sc_lt_L(const uint8_t s[32]) {
  uint64_t w[5] = {0, 0, 0, 0, 0};
  sc_load(s, w);
  return sc_sub5(w, L_W) == 1;
}

inline int nibble(const uint8_t s[32], int i) {
  return (s[i >> 1] >> (4 * (i & 1))) & 15;
}

// --- scalar multiplication ---------------------------------------------------

// [e]B for a secret 256-bit e: the same 64 x (4 doublings + 1 addition)
// and a masked scan of all 16 table entries for every e
ge ge_scalarmult_base_ct(const uint8_t e[32]) {
  const BaseConsts& c = base_consts();
  ge acc = ge_identity();
  for (int i = 63; i >= 0; i--) {
    for (int k = 0; k < 4; k++) acc = ge_dbl(acc);
    uint64_t digit = (uint64_t)nibble(e, i);
    ge sel = c.tab[0];
    for (uint64_t j = 1; j < 16; j++) {
      uint64_t eq = ((j ^ digit) - 1) >> 63;       // 1 iff j == digit
      fe_cmov(sel.X, c.tab[j].X, eq);
      fe_cmov(sel.Y, c.tab[j].Y, eq);
      fe_cmov(sel.Z, c.tab[j].Z, eq);
      fe_cmov(sel.T, c.tab[j].T, eq);
    }
    acc = ge_add(acc, sel);
  }
  return acc;
}

// [s]B + [k]P for public s, k (4-bit windows, zero digits skipped)
ge ge_double_scalarmult_vartime(const uint8_t s[32], const uint8_t k[32],
                                const ge& P) {
  const BaseConsts& c = base_consts();
  ge ptab[16];
  ptab[0] = ge_identity();
  for (int i = 1; i < 16; i++) ptab[i] = ge_add(ptab[i - 1], P);
  ge acc = ge_identity();
  for (int i = 63; i >= 0; i--) {
    for (int j = 0; j < 4; j++) acc = ge_dbl(acc);
    int ds = nibble(s, i), dk = nibble(k, i);
    if (ds) acc = ge_add(acc, c.tab[ds]);
    if (dk) acc = ge_add(acc, ptab[dk]);
  }
  return acc;
}

// --- the scheme ---------------------------------------------------------------

// RFC 8032 key expansion: clamped a, prefix
void expand(const uint8_t seed[32], uint8_t a[32], uint8_t prefix[32]) {
  uint8_t h[64];
  Sha512 s;
  s.update(seed, 32);
  s.final(h);
  std::memcpy(a, h, 32);
  a[0] &= 248;
  a[31] &= 63;
  a[31] |= 64;
  std::memcpy(prefix, h + 32, 32);
  std::memset(h, 0, sizeof h);
}

bool verify(const uint8_t pub[32], const uint8_t* msg, size_t len,
            const uint8_t sig[64]) {
  ge A, R;
  if (!ge_decode(A, pub)) return false;
  if (!sc_lt_L(sig + 32)) return false;
  if (!ge_decode(R, sig)) return false;
  uint8_t h[64], k[32];
  sha512_3(sig, 32, pub, 32, msg, len, h);
  sc_reduce512(h, k);
  ge Rp = ge_double_scalarmult_vartime(sig + 32, k, ge_neg(A));
  // projective compare with R (Z = 1): X' == x_R Z', Y' == y_R Z'
  return fe_eq(Rp.X, fe_mul(R.X, Rp.Z)) && fe_eq(Rp.Y, fe_mul(R.Y, Rp.Z));
}

void run_threaded(size_t jobs, unsigned threads,
                  const std::function<void(size_t)>& fn) {
  if (threads <= 1 || jobs <= 1) {
    for (size_t i = 0; i < jobs; i++) fn(i);
    return;
  }
  std::vector<std::thread> ts;
  std::atomic<size_t> next{0};
  for (unsigned t = 0; t < threads && t < jobs; t++)
    ts.emplace_back([&] {
      for (size_t i = next.fetch_add(1); i < jobs; i = next.fetch_add(1))
        fn(i);
    });
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// the public key A = enc([a]B) of a 32-byte seed
int tm_ed25519_pubkey(const uint8_t* seed, uint8_t* out) {
  uint8_t a[32], prefix[32];
  expand(seed, a, prefix);
  ge_encode(out, ge_scalarmult_base_ct(a));
  std::memset(a, 0, 32);
  std::memset(prefix, 0, 32);
  return 0;
}

// RFC 8032 signature R || S of msg[0:len] under a 32-byte seed
int tm_ed25519_sign(const uint8_t* seed, const uint8_t* msg, uint64_t len,
                    uint8_t* sig) {
  uint8_t a[32], prefix[32], pub[32], h[64], r[32], k[32];
  expand(seed, a, prefix);
  ge_encode(pub, ge_scalarmult_base_ct(a));
  sha512_3(prefix, 32, msg, len, nullptr, 0, h);
  sc_reduce512(h, r);
  ge_encode(sig, ge_scalarmult_base_ct(r));
  sha512_3(sig, 32, pub, 32, msg, len, h);
  sc_reduce512(h, k);
  sc_muladd(k, a, r, sig + 32);
  std::memset(a, 0, 32);
  std::memset(prefix, 0, 32);
  std::memset(r, 0, 32);
  std::memset(h, 0, 64);
  return 0;
}

// 1 when sig (64 bytes) is pub's (32 bytes) signature of msg[0:len]
int tm_ed25519_verify(const uint8_t* pub, const uint8_t* msg, uint64_t len,
                      const uint8_t* sig) {
  return verify(pub, msg, len, sig) ? 1 : 0;
}

// n lanes of equal-length messages: pubs [n][32], msgs [n][len], sigs
// [n][64] -> out[n] in {0, 1}, over `threads` C++ threads
void tm_ed25519_verify_batch(const uint8_t* pubs, const uint8_t* msgs,
                             uint64_t len, const uint8_t* sigs, uint64_t n,
                             uint8_t* out, uint32_t threads) {
  base_consts();               // built once, before the threads
  run_threaded(n == 0 ? 0 : 1 + (n - 1) / 64, threads, [&](size_t chunk) {
    size_t lo = chunk * 64, hi = lo + 64 < n ? lo + 64 : n;
    for (size_t i = lo; i < hi; i++)
      out[i] = verify(pubs + 32 * i, msgs + len * i, len, sigs + 64 * i);
  });
}
}
