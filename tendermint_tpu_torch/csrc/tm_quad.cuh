// The quad: four threads of a warp holding one extended point, thread q
// owning coordinate q (0 X, 1 Y, 2 Z, 3 T), for the port's CUDA kernels.
//
// Hisil, Wong, Carter and Dawson 2008, "Twisted Edwards curves
// revisited", section 4's schedules for four processors: an add or a
// doubling is two field products deep (one product on each thread per
// step) where one thread runs 8-10 in a row.  Operands move by
// __shfl_sync within the quad, under the quad's mask, so every thread of
// the quad must run each step.  Used by the raw-lane verify body
// (tm_verify_raw.cuh, kernels K5 and K6) and by K2's doubling chain of
// window bases (build_neg_comb.cu).
#pragma once
#include "tm_group.cuh"

#define RAW_QUAD 4          // threads per point

struct quad_ctx {
  unsigned mask;  // the quad's four lanes of the warp
  int q;          // this thread's coordinate: 0 X, 1 Y, 2 Z, 3 T
};

static __device__ __forceinline__ fe fe_shfl(const quad_ctx& t, const fe& v,
                                             int src) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++)
    r.v[i] = __shfl_sync(t.mask, v.v[i], src, RAW_QUAD);
  return r;
}

// a, b, c or d for thread q = 0, 1, 2 or 3
static __device__ __forceinline__ int q_pick(int q, int a, int b, int c,
                                             int d) {
  return q < 2 ? (q == 0 ? a : b) : (q == 2 ? c : d);
}

// P + Q for Q in cached form, c being this thread's entry of Q.
//   step 1: A = (Y1-X1)c0, B = (Y1+X1)c1, D = Z1 c2, C = T1 c3
//   then each thread forms one of E = B - A, H = B + A, F = D - C,
//   G = D + C (threads 0-3) and reads the two its product needs:
//   X3 = EF, Y3 = GH, Z3 = FG, T3 = EH.
static __device__ __forceinline__ fe quad_add(quad_ctx t, fe p, fe c) {
  int q = t.q;
  fe o = fe_shfl(t, p, q ^ 1);            // thread 0 gets Y1, thread 1 X1
  fe a = fe_lin(q == 0 ? 2 : 0, q == 0 ? -1 : 1, p, q < 2 ? 1 : 0, o);
  fe m = fe_mul(a, c);                    // A, B, D, C
  fe n = fe_shfl(t, m, q ^ 1);            // B, A, C, D
  fe v = fe_lin((q & 1) ? 0 : 2, q == 0 ? -1 : 1, m, q == 2 ? -1 : 1, n);
  return fe_mul(fe_shfl(t, v, q_pick(q, 0, 3, 2, 0)),    // E, G, F, E
                fe_shfl(t, v, q_pick(q, 2, 1, 3, 1)));   // F, H, G, H
}

// 2P (dbl-2008-hwcd, as ge_dbl); T is not read.
//   step 1: X^2, Y^2, Z^2, S = (X+Y)^2
//   then G = Y^2 - X^2, H = -(X^2 + Y^2), -2Z^2 and S on threads 0-3, and
//   E = S + H, F = G - 2Z^2: X3 = EF, Y3 = GH, Z3 = FG, T3 = EH.
static __device__ __forceinline__ fe quad_dbl(quad_ctx t, fe p) {
  int q = t.q;
  fe x = fe_shfl(t, p, 0), y = fe_shfl(t, p, 1);
  fe m = fe_sq(fe_lin(0, 1, q == 3 ? x : p, q == 3 ? 1 : 0, y));
  fe n = fe_shfl(t, m, q ^ 1);            // Y^2, X^2, S, Z^2
  fe v = fe_lin(q_pick(q, 2, 4, 4, 0), q_pick(q, -1, -1, -2, 1), m,
                q < 2 ? (q == 0 ? 1 : -1) : 0, n);
  // operand 1: E = S + H, G, F = G - 2Z^2, E; operand 2: F, H, G, H
  fe a1 = fe_shfl(t, v, q_pick(q, 3, 0, 0, 3));
  fe b1 = fe_shfl(t, v, q_pick(q, 1, 0, 2, 1));
  fe a2 = fe_shfl(t, v, q_pick(q, 0, 1, 0, 1));
  fe b2 = fe_shfl(t, v, 2);
  return fe_mul(fe_lin(0, 1, a1, q == 1 ? 0 : 1, b1),
                fe_lin(0, 1, a2, q == 0 ? 1 : 0, b2));
}

// This thread's entry of P's cached form (Y-X, Y+X, 2Z, 2dT).
static __device__ __forceinline__ fe quad_cache(quad_ctx t, fe p) {
  int q = t.q;
  fe o = fe_shfl(t, p, q ^ 1);
  fe a = fe_lin(q == 0 ? 2 : 0, q_pick(q, -1, 1, 2, 1), p, q < 2 ? 1 : 0,
                o);
  return fe_mul(a, fe_sel(q == 3, fe_d2(), fe_one()));
}

