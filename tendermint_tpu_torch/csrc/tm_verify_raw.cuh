// The raw-lane ed25519 verification body shared by kernels K5
// (verify_raw.cu) and K6 (verify_tally.cu), so the two cannot drift.
//
// Replaces tendermint_tpu/ops/ed25519.py verify (with verify_core,
// curve.scalar_mul and curve.pt_eq) for one signature, with the
// reference's semantics bit for bit:
//   k = SHA-512(R || A || M) mod L (M is a runtime length), decompress A
//   and R (y < p, x^2 a square, no x = 0 with the sign bit set), s < L,
//   and the cofactorless equation [s]B + [k](-A) == R compared
//   projectively.  Lanes whose A or R fails to decompress compute on
//   garbage points and are only masked.  Every group operation below is
//   the complete extended-coordinate law, so any schedule of it gives the
//   same group element, and the mask is the reference's.
//
// Design: a block of 128 threads verifies 32 signatures in two phases.
//   Per lane, one thread per signature (a warp's idle lanes cost the same
//   issue slots as busy ones, so this work is not repeated per quad):
//   warp 0 hashes, reduces k mod L, recodes k into 64 signed 4-bit digits
//   in [-8, 7] (k < L < 2^253, so the top digit takes the carry out of
//   digit 62 and stays in [0, 2]) and checks s < L; warp 1 decompresses
//   A and warp 2 R, side by side.  Results go through shared memory.
//   Per signature, a QUAD of four threads (Hisil, Wong, Carter and
//   Dawson 2008, "Twisted Edwards curves revisited", section 4's
//   schedules for four processors): thread q owns one extended
//   coordinate (q = 0, 1, 2, 3: X, Y, Z, T) of every point on the chain,
//   about ten live limbs where one thread per lane held forty or more.
//   An add or a doubling is two field products deep (one product on each
//   thread per step) where one thread ran 8-10 in a row:
//     add P + Q, Q cached as (Y2-X2, Y2+X2, 2Z2, 2dT2), one entry per
//     thread: A = (Y1-X1)(Y2-X2), B = (Y1+X1)(Y2+X2), D = Z1*2Z2,
//     C = T1*2dT2;
//     doubling (dbl-2008-hwcd, T not read): X^2, Y^2, Z^2, (X+Y)^2;
//     then E, F, G, H, and thread q forms X3 = EF, Y3 = GH, Z3 = FG or
//     T3 = EH from the two operands it reads.
//   Operands move by __shfl_sync within the quad, under the quad's mask;
//   every thread of the block runs the same code, so a lane past the
//   batch's end computes on a copy of a real lane instead of returning
//   early.  The adds around each product take one parallel int32 carry
//   pass (`fe_lin`), not a serial int64 chain.
//
// The quad's lane, in order:
//   1. [1..8](-A) in cached form (2dT multiplied in) into shared memory,
//      one column per thread: the thread that multiplies by Y2-X2 stores
//      Y2-X2, so the table side of an add needs no exchange, and a negated
//      entry (-X, Y, Z, -T) is read from the partner's column (threads 0
//      and 1 swap Y-X and Y+X) or negated in place (thread 3);
//   2. [k](-A) by 64 signed windows MSB first: 4 doublings and one add per
//      window (digit 0 adds the cached identity, so no lane branches);
//   3. [s]B added onto it by 22 mixed adds from the 12-bit base table
//      (each thread loads its own third of an entry; thread 2's is 2);
//   4. the projective comparison with R (Z_R = 1): thread 0 checks
//      X == X_R Z, thread 1 Y == Y_R Z, thread 2 Z != 0.
#pragma once
#include "tm_quad.cuh"
#include "tm_scalar.cuh"
#include "tm_sha512.cuh"

#define RAW_BLOCK 128       // threads per block: 32 signatures, 4 warps
#define RAW_LANES (RAW_BLOCK / RAW_QUAD)
#define RAW_TBL 8           // cached entries [1..8](-A) per signature
#ifndef RAW_MIN_BLOCKS      // blocks per SM asked of the register allocator
#define RAW_MIN_BLOCKS 1
#endif

// The block's shared memory: int32[RAW_TBL][10][RAW_BLOCK], each thread's
// window table in its own column; before the table is built it holds the
// per-lane phase's results, int32[RAW_P1_FIELDS][RAW_LANES].
#define RAW_SMEM_WORDS (RAW_TBL * 10 * RAW_BLOCK)
#define RAW_P1_DIG 0        // 8 words: the signed digits + 8, 4 bits each
#define RAW_P1_AX 8         // A's X, Y and T (10 limbs each)
#define RAW_P1_AY 18
#define RAW_P1_AT 28
#define RAW_P1_RX 38        // R's X and Y
#define RAW_P1_RY 48
#define RAW_P1_OKA 58       // A decompressed, R decompressed, s < L
#define RAW_P1_OKR 59
#define RAW_P1_OKS 60
#define RAW_P1_FIELDS 61

// 64 signed 4-bit digits of k < 2^253, digit w + 8 in bits [4w, 4w + 4)
// of d[0..3]: a nibble of 8 or more (with the carry in) becomes nibble -
// 16 and carries 1 on; digit 63 keeps its carry (at most 2 + 8).
static __device__ __forceinline__ void sc_signed_digits(const uint64_t k[4],
                                                        uint64_t d[4]) {
  int carry = 0;
#pragma unroll
  for (int w = 0; w < 4; w++) d[w] = 0;
#pragma unroll
  for (int w = 0; w < 64; w++) {
    int v = (int)((k[w >> 4] >> (4 * (w & 15))) & 15) + carry;
    carry = (w < 63 && v >= 8) ? 1 : 0;
    d[w >> 4] |= (uint64_t)(v - 16 * carry + 8) << (4 * (w & 15));
  }
}

// Cached entry |digit| of -A (the identity for 0), negated for a negative
// digit: threads 0 and 1 read each other's column (Y-X and Y+X swap),
// thread 3 negates 2dT.
static __device__ __forceinline__ fe quad_entry(const quad_ctx& t,
                                                const int32_t* tbl, int col,
                                                int digit) {
  int mag = digit < 0 ? -digit : digit;
  bool neg = digit < 0;
  int c = (neg && t.q < 2) ? (col ^ 1) : col;
  const int32_t* e = tbl + (mag > 0 ? mag - 1 : 0) * 10 * RAW_BLOCK + c;
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = e[i * RAW_BLOCK];
  bool flip = neg && t.q == 3;
  r = fe_lin(flip ? 2 : 0, flip ? -1 : 1, r, 0, r);
  fe ident = fe_zero();
  ident.v[0] = t.q == 3 ? 0 : (t.q == 2 ? 2 : 1);   // (1, 1, 2, 0)
  return fe_sel(mag == 0, ident, r);
}

static __device__ __forceinline__ void p1_store(int32_t* sm, int field,
                                                int lane, const fe& f) {
#pragma unroll
  for (int i = 0; i < 10; i++) sm[(field + i) * RAW_LANES + lane] = f.v[i];
}

static __device__ __forceinline__ fe p1_load(const int32_t* sm, int field,
                                             int lane) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = sm[(field + i) * RAW_LANES + lane];
  return r;
}

// The block's 32 signatures, RAW_BLOCK threads, every one of which must
// call this.  Thread t serves lane t % 32 of the block in the per-lane
// phase (`lane_*`: its key, message and signature) and the quad's lane
// t / 4 after it (`quad_sig`: that lane's signature).  `sm` is the
// block's RAW_SMEM_WORDS of shared memory.  Returns the quad's verdict on
// every thread of the quad.
static __device__ bool verify_raw_block(const uint8_t* lane_pub,
                                        const uint8_t* lane_msg,
                                        const uint8_t* lane_sig, int msg_len,
                                        const uint8_t* quad_sig,
                                        const uint8_t* base, int32_t* sm) {
  int tid = threadIdx.x;
  quad_ctx t;
  t.q = tid & 3;
  t.mask = 0xfu << (tid & 28);

  // 1. per lane, one thread each: warp 0 hashes and recodes k and checks
  //    s < L, warp 1 decompresses A, warp 2 decompresses R
  {
    int warp = tid / 32, lane = tid & 31;
    if (warp == 0) {
      uint8_t h[64], k[32];
      uint64_t kw[4], dg[4];
      sha512_3(lane_sig, 32, lane_pub, 32, lane_msg, msg_len, h);
      sc_reduce512(h, k);
      sc_load(k, kw);
      sc_signed_digits(kw, dg);
#pragma unroll
      for (int i = 0; i < 8; i++)
        sm[(RAW_P1_DIG + i) * RAW_LANES + lane] =
            (int32_t)(uint32_t)(dg[i >> 1] >> (32 * (i & 1)));
      sm[RAW_P1_OKS * RAW_LANES + lane] = sc_lt_L(lane_sig + 32);
    } else if (warp < 3) {
      ge P;
      bool ok = ge_decompress(warp == 1 ? lane_pub : lane_sig, P);
      if (warp == 1) {
        p1_store(sm, RAW_P1_AX, lane, P.X);
        p1_store(sm, RAW_P1_AY, lane, P.Y);
        p1_store(sm, RAW_P1_AT, lane, P.T);
        sm[RAW_P1_OKA * RAW_LANES + lane] = ok;
      } else {
        p1_store(sm, RAW_P1_RX, lane, P.X);
        p1_store(sm, RAW_P1_RY, lane, P.Y);
        sm[RAW_P1_OKR * RAW_LANES + lane] = ok;
      }
    }
  }
  __syncthreads();
  int lane = tid / RAW_QUAD;
  uint64_t dg[4];
#pragma unroll
  for (int i = 0; i < 4; i++)
    dg[i] = (uint32_t)sm[(RAW_P1_DIG + 2 * i) * RAW_LANES + lane] |
            ((uint64_t)(uint32_t)sm[(RAW_P1_DIG + 2 * i + 1) * RAW_LANES +
                                    lane] << 32);
  bool ok = sm[RAW_P1_OKA * RAW_LANES + lane] &&
            sm[RAW_P1_OKR * RAW_LANES + lane] &&
            sm[RAW_P1_OKS * RAW_LANES + lane];
  // this thread's coordinate of -A = (-X, Y, 1, -T), and R's X or Y
  fe a = p1_load(sm, q_pick(t.q, RAW_P1_AX, RAW_P1_AY, RAW_P1_AY,
                            RAW_P1_AT), lane);
  bool negate = t.q == 0 || t.q == 3;
  fe na = fe_sel(t.q == 2, fe_one(), fe_lin(negate ? 2 : 0, negate ? -1 : 1,
                                            a, 0, a));
  fe r_xy = p1_load(sm, t.q == 0 ? RAW_P1_RX : RAW_P1_RY, lane);
  __syncthreads();            // the table below overwrites these

  // 2. the cached table [1..8](-A), one column per thread
  {
    fe c1 = quad_cache(t, na), pj = na, cj = c1;
    for (int j = 1; j <= RAW_TBL; j++) {
      if (j > 1) {
        pj = quad_add(t, pj, c1);
        cj = quad_cache(t, pj);
      }
      int32_t* e = sm + (j - 1) * 10 * RAW_BLOCK + tid;
#pragma unroll
      for (int i = 0; i < 10; i++) e[i * RAW_BLOCK] = cj.v[i];
    }
    __syncwarp(t.mask);       // the partner's column is read below
  }

  // 3. [k](-A), signed windows MSB first; the top digit is 0..2
  fe acc = fe_zero();         // the identity (0, 1, 1, 0)
  acc.v[0] = (t.q == 1 || t.q == 2) ? 1 : 0;
  for (int w = 63; w >= 0; w--) {
    if (w < 63) {
      for (int j = 0; j < 4; j++) acc = quad_dbl(t, acc);
    }
    int digit = (int)(dg[3] >> 60) - 8;
    dg[3] = (dg[3] << 4) | (dg[2] >> 60);
    dg[2] = (dg[2] << 4) | (dg[1] >> 60);
    dg[1] = (dg[1] << 4) | (dg[0] >> 60);
    dg[0] <<= 4;
    acc = quad_add(t, acc, quad_entry(t, sm, tid, digit));
  }

  // 4. + [s]B: 22 mixed adds of (y+x, y-x, 2dxy) entries, 12-bit digits
  {
    uint64_t sw[4];
    sc_load(quad_sig + 32, sw);
    // the byte offset of this thread's third: y-x, y+x, (2), 2dxy
    int off = q_pick(t.q, 32, 0, 0, 64);
    fe two = fe_zero();
    two.v[0] = 2;
    for (int w = 0; w < 22; w++) {
      int d = (int)(sw[0] & 0xfff);
      sw[0] = (sw[0] >> 12) | (sw[1] << 52);
      sw[1] = (sw[1] >> 12) | (sw[2] << 52);
      sw[2] = (sw[2] >> 12) | (sw[3] << 52);
      sw[3] >>= 12;
      fe c = fe_frombytes(base + ((size_t)w * 4096 + d) * 96 + off);
      acc = quad_add(t, acc, fe_sel(t.q == 2, two, c));
    }
  }

  // 5. acc == R projectively (Z_R = 1), and acc's Z != 0
  fe z = fe_shfl(t, acc, 2);
  fe rhs = fe_sel(t.q < 2, fe_mul(r_xy, z), fe_zero());
  bool zero = fe_iszero(fe_sub(acc, rhs));
  int mine = t.q < 2 ? zero : (t.q == 2 ? !zero : 1);
  mine &= __shfl_xor_sync(t.mask, mine, 1, RAW_QUAD);
  mine &= __shfl_xor_sync(t.mask, mine, 2, RAW_QUAD);
  return ok && mine;
}
