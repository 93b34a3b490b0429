// edwards25519 group operations for the port's CUDA kernels.
//
// Replaces the point layer of tendermint_tpu/ops/curve.py with the same
// formulas (a = -1 twisted Edwards, extended coordinates X, Y, Z, T):
// add-2008-hwcd-3 (9 products), the mixed add with a precomputed
// (y+x, y-x, 2dxy) entry (7 products; (1, 1, 0) is the identity, so digit 0
// needs no branch), the add onto a cached (Y-X, Y+X, 2Z, 2dT) point (8
// products) and dbl-2008-hwcd.  The kernels encode points after one
// batch inversion per block (fe_block_invert), not one per lane.
#pragma once
#include "tm_field.cuh"

struct ge {
  fe X, Y, Z, T;
};

struct ge_aff {
  fe ypx, ymx, xy2d;
};

static __device__ __forceinline__ ge ge_identity() {
  ge r;
  r.X = fe_zero();
  r.Y = fe_one();
  r.Z = fe_one();
  r.T = fe_zero();
  return r;
}

static __device__ ge ge_add(const ge& p, const ge& q) {
  fe a = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  fe b = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  fe c = fe_mul(fe_mul(p.T, q.T), fe_d2());
  fe zz = fe_mul(p.Z, q.Z);
  fe d = fe_add(zz, zz);
  fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

// Q as (Y-X, Y+X, 2Z, 2dT): adding it is 8 products where ge_add takes 9
struct ge_cached {
  fe ymx, ypx, z2, t2d;
};

static __device__ ge_cached ge_to_cached(const ge& p) {
  ge_cached c;
  c.ymx = fe_sub(p.Y, p.X);
  c.ypx = fe_add(p.Y, p.X);
  c.z2 = fe_add(p.Z, p.Z);
  c.t2d = fe_mul(p.T, fe_d2());
  return c;
}

// The adds and subtractions around the products below take one parallel
// carry pass each (fe_lin): p's coordinates are products or constants.
static __device__ ge ge_add_cached(const ge& p, const ge_cached& q) {
  fe a = fe_mul(fe_lin(2, 1, p.Y, -1, p.X), q.ymx);
  fe b = fe_mul(fe_lin(0, 1, p.Y, 1, p.X), q.ypx);
  fe c = fe_mul(p.T, q.t2d);
  fe d = fe_mul(p.Z, q.z2);
  fe e = fe_lin(2, 1, b, -1, a), f = fe_lin(2, 1, d, -1, c);
  fe g = fe_lin(0, 1, d, 1, c), h = fe_lin(0, 1, b, 1, a);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

static __device__ ge ge_add_aff(const ge& p, const ge_aff& q) {
  fe a = fe_mul(fe_lin(2, 1, p.Y, -1, p.X), q.ymx);
  fe b = fe_mul(fe_lin(0, 1, p.Y, 1, p.X), q.ypx);
  fe c = fe_mul(p.T, q.xy2d);
  fe d = fe_lin(0, 2, p.Z, 0, p.Z);
  fe e = fe_lin(2, 1, b, -1, a), f = fe_lin(2, 1, d, -1, c);
  fe g = fe_lin(0, 1, d, 1, c), h = fe_lin(0, 1, b, 1, a);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

static __device__ ge ge_dbl(const ge& p) {
  fe a = fe_sq(p.X);
  fe b = fe_sq(p.Y);
  fe zz = fe_sq(p.Z);
  fe c = fe_add(zz, zz);
  fe e = fe_sub(fe_sub(fe_sq(fe_add(p.X, p.Y)), a), b);  // 2xy
  fe g = fe_sub(b, a);
  fe f = fe_sub(g, c);
  fe h = fe_neg(fe_add(a, b));
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

// 96 bytes (y+x, y-x, 2dxy) at a 16-byte aligned address -> precomputed
// entry, in six 16-byte loads (a gathered entry is one lane's own row:
// byte loads cost 96 uncoalesced load instructions per entry)
static __device__ __forceinline__ ge_aff ge_aff_load(const uint8_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint32_t w[24];
#pragma unroll
  for (int i = 0; i < 6; i++) {
    uint4 u = q[i];
    w[4 * i] = u.x;
    w[4 * i + 1] = u.y;
    w[4 * i + 2] = u.z;
    w[4 * i + 3] = u.w;
  }
  ge_aff r;
  r.ypx = fe_fromwords(w);
  r.ymx = fe_fromwords(w + 8);
  r.xy2d = fe_fromwords(w + 16);
  return r;
}

// little-endian bytes < p = 2^255 - 19
static __device__ __forceinline__ bool bytes_lt_p(const uint8_t b[32]) {
  if (b[31] != 0x7f) return b[31] < 0x7f;
  for (int i = 30; i >= 1; i--) {
    if (b[i] != 0xff) return true;
  }
  return b[0] < 0xed;
}

// Decompress 32 bytes with the reference's exact semantics
// (tendermint_tpu/ops/curve.py decompress): rejects y >= p, a non-square
// x^2, and x == 0 with the sign bit set.  Rejected inputs still yield a
// (garbage) point; the caller masks it with the returned flag.
static __device__ bool ge_decompress(const uint8_t* in, ge& out) {
  uint8_t yb[32];
  for (int i = 0; i < 32; i++) yb[i] = in[i];
  int sign = yb[31] >> 7;
  yb[31] &= 0x7f;
  bool ok = bytes_lt_p(yb);
  fe y = fe_frombytes(yb);
  fe one = fe_one();
  fe y2 = fe_sq(y);
  fe u = fe_sub(y2, one);
  fe v = fe_add(fe_mul(y2, fe_d()), one);
  fe v3 = fe_mul(fe_sq(v), v);
  fe v7 = fe_mul(fe_sq(v3), v);
  fe x = fe_mul(fe_mul(u, v3), fe_pow22523(fe_mul(u, v7)));
  fe vx2 = fe_mul(v, fe_sq(x));
  bool root1 = fe_eq(vx2, u);
  bool root2 = fe_eq(vx2, fe_neg(u));
  if (root2) x = fe_mul(x, fe_sqrt_m1());
  ok = ok && (root1 || root2);
  ok = ok && !(fe_iszero(u) && sign == 1);
  if (fe_parity(x) != sign) x = fe_neg(x);
  out.X = x;
  out.Y = y;
  out.Z = one;
  out.T = fe_mul(x, y);
  return ok;
}
