// K5: raw-lane ed25519 verification, each lane with its own public key.
//
// Replaces tendermint_tpu/ops/ed25519.py verify / verify_batch (with
// verify_core, curve.scalar_mul and curve.pt_eq): the mempool's signed-tx
// CheckTx lane.  One thread per lane, with the reference's semantics bit
// for bit:
//   k = SHA-512(R || A || M) mod L (M is a runtime length), decompress A
//   and R (y < p, x^2 a square, no x = 0 with the sign bit set), s < L,
//   [s]B by 22 mixed adds from the 12-bit base table, [k](-A) by 4-bit
//   windows MSB first over a 16-entry per-lane table (T[0] the identity,
//   4 doublings and one full add per window), and a projective comparison
//   of [s]B + [k](-A) with R.  Lanes whose A or R fails to decompress
//   compute on garbage points and are only masked.
// What bounds it: integer multiplies.  A lane is ~3.3k field products
// (two decompressions of ~265, 22 x 7 for [s]B, 252 doublings x 8 and
// ~74 adds x 9 for [k](-A), the comparison), each 100 32x32->64
// multiply-adds.  The design keeps lanes independent and simple: the
// 16-entry table (2.5 KB) sits in the lane's local memory, gathered with
// the lane's own digit.  A joint [s]B + [k](-A) ladder, signed windows and
// a table in shared memory are the queued redesigns.
#include <cuda_runtime.h>

#include "tm_group.cuh"
#include "tm_scalar.cuh"
#include "tm_sha512.cuh"

__global__ void verify_raw_kernel(const uint8_t* __restrict__ pubkeys,
                                  const uint8_t* __restrict__ msgs,
                                  int msg_len,
                                  const uint8_t* __restrict__ sigs,
                                  const uint8_t* __restrict__ base,
                                  uint8_t* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* pub = pubkeys + 32 * (size_t)i;
  const uint8_t* sig = sigs + 64 * (size_t)i;
  uint8_t h[64], k[32];
  sha512_3(sig, 32, pub, 32, msgs + (size_t)msg_len * i, msg_len, h);
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
  out[i] = ok_a && ok_r && ok_s && eq;
}

extern "C" int tm_verify_raw(const uint8_t* pubkeys, const uint8_t* msgs,
                             int msg_len, const uint8_t* sigs,
                             const uint8_t* base, uint8_t* out, int n,
                             void* stream) {
  const int threads = 128;
  verify_raw_kernel<<<(n + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(pubkeys, msgs, msg_len, sigs,
                                              base, out, n);
  return (int)cudaGetLastError();
}
