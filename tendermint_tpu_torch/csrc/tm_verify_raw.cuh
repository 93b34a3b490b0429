// The raw-lane ed25519 verification body shared by kernels K5
// (verify_raw.cu) and K6 (verify_tally.cu), so the two cannot drift.
//
// Replaces tendermint_tpu/ops/ed25519.py verify (with verify_core,
// curve.scalar_mul and curve.pt_eq) for one lane, with the reference's
// semantics bit for bit:
//   k = SHA-512(R || A || M) mod L (M is a runtime length), decompress A
//   and R (y < p, x^2 a square, no x = 0 with the sign bit set), s < L,
//   [s]B by 22 mixed adds from the 12-bit base table, [k](-A) by 4-bit
//   windows MSB first over a 16-entry per-lane table (T[0] the identity,
//   4 doublings and one full add per window), and a projective comparison
//   of [s]B + [k](-A) with R.  Lanes whose A or R fails to decompress
//   compute on garbage points and are only masked.
#pragma once
#include "tm_group.cuh"
#include "tm_scalar.cuh"
#include "tm_sha512.cuh"

static __device__ bool verify_raw_lane(const uint8_t* pub,
                                       const uint8_t* msg, int msg_len,
                                       const uint8_t* sig,
                                       const uint8_t* base) {
  uint8_t h[64], k[32];
  sha512_3(sig, 32, pub, 32, msg, msg_len, h);
  sc_reduce512(h, k);
  ge A, R;
  bool ok_a = ge_decompress(pub, A);
  bool ok_r = ge_decompress(sig, R);
  bool ok_s = sc_lt_L(sig + 32);

  uint64_t sw[4], kw[4];
  sc_load(sig + 32, sw);
  sc_load(k, kw);
  ge sB = ge_identity();
  for (int w = 0; w < 22; w++) {
    int d = sc_window(sw, 12 * w, 12);
    sB = ge_add_aff(sB, ge_aff_load(base + ((size_t)w * 4096 + d) * 96));
  }
  ge tbl[16];
  tbl[0] = ge_identity();
  ge negA = ge_neg(A);
  for (int j = 1; j < 16; j++) tbl[j] = ge_add(tbl[j - 1], negA);
  ge kA = ge_identity();
  for (int w = 63; w >= 0; w--) {
    for (int j = 0; j < 4; j++) kA = ge_dbl(kA);
    kA = ge_add(kA, tbl[sc_window(kw, 4 * w, 4)]);
  }
  bool eq = ge_eq(ge_add(sB, kA), R);
  return ok_a && ok_r && ok_s && eq;
}
