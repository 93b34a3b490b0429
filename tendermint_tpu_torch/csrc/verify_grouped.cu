// K1: grouped ed25519 verification against per-validator comb tables.
//
// Replaces tendermint_tpu/ops/ed25519.py verify_grouped_templated /
// verify_grouped (the fast-sync hot plane), with curve.encode_batch's one
// batch inversion.  One thread per lane, 512 lanes to a block:
//   1. gather the lane's template and public key, k = SHA-512(R || A || M)
//      mod L, check s < L;
//   2. [s]B by 22 mixed adds from the 12-bit base table, [k](-A) by 26
//      mixed adds from the set's 10-bit comb table (each entry in six
//      16-byte loads), one full add;
//   3. one Montgomery batch inversion of Z across the block
//      (fe_block_invert: one `fe_invert`, by warp 0, for 512 lanes);
//   4. encode, byte-compare with R, and mask by pub_ok[val_idx], s < L
//      and Z != 0.
// A Z == 0 lane (a forged lane can reach it) joins the inversion with 1,
// so it cannot poison its neighbours, and is False.  No thread returns
// before the barriers: a lane past N, or with an index out of range (< 0
// or >= its count), computes nothing, joins with Z = 1, and stores
// nothing, or False.
// What bounds it: integer multiplies.  A lane is ~350 field products
// (48 x 7 mixed-add products, 9 for the full add, ~28 for its share of
// the block's scans and 2 for the encode), each 100 32x32->64
// multiply-adds, plus two SHA-512 compressions and a Barrett reduction;
// the block's one inversion (~265 products) runs on one warp in 16.  A
// warp's 32 lanes run in step, so where each lane inverted, every warp
// spent those ~265 products; and the inverting warp of every block sits
// on its SM's first scheduler, so one block per SM, with four warps per
// scheduler, puts one inversion on that scheduler where four blocks of
// 128 put four.  The gathers read 48 x 96 bytes per lane.
#include <cuda_runtime.h>

// Products inline (measured on an H100 against out of line: 0.564 against
// 0.584 ms at 65,536 lanes, 0.276 against 0.302 at 128): the block's
// inversion tail, one warp's dependent chain, shortens most.
#ifndef TM_FE_MUL_INLINE
#define TM_FE_MUL_INLINE
#endif
#include "tm_group.cuh"
#include "tm_scalar.cuh"
#include "tm_sha512.cuh"

#define VERIFY_BLOCK 512

// one block per SM, so its one inversion sits on one scheduler in four
__global__ void __launch_bounds__(VERIFY_BLOCK, 1)
verify_grouped_kernel(
    const uint8_t* __restrict__ tables, int vb,
    const uint8_t* __restrict__ pub_ok, const uint8_t* __restrict__ pubs,
    int n_pubs, const int32_t* __restrict__ pub_idx,
    const int32_t* __restrict__ val_idx,
    const uint8_t* __restrict__ templates, int n_tmpl, int msg_len,
    const int32_t* __restrict__ tmpl_idx, const uint8_t* __restrict__ sigs,
    const uint8_t* __restrict__ base, uint8_t* __restrict__ out, int n) {
  int i = blockIdx.x * VERIFY_BLOCK + (int)threadIdx.x;
  int v = -1, pi = -1, ti = -1;
  if (i < n) {
    v = val_idx[i];
    pi = pub_idx[i];
    ti = tmpl_idx[i];
  }
  // false past N and for an index out of range (< 0 or >= its count)
  bool in = v >= 0 && v < vb && pi >= 0 && pi < n_pubs && ti >= 0 &&
            ti < n_tmpl;
  const uint8_t* sig = sigs + 64 * (size_t)i;
  ge P = ge_identity();
  bool ok = false;
  if (in) {
    uint8_t h[64], k[32];
    sha512_3(sig, 32, pubs + 32 * (size_t)pi, 32,
             templates + (size_t)msg_len * ti, msg_len, h);
    sc_reduce512(h, k);
    ok = pub_ok[v] != 0 && sc_lt_L(sig + 32);
    uint64_t sw[4], kw[4];
    sc_load(sig + 32, sw);
    sc_load(k, kw);
    ge sB = ge_identity();
    for (int w = 0; w < 22; w++) {
      int d = sc_window(sw, 12 * w, 12);
      sB = ge_add_aff(sB, ge_aff_load(base + ((size_t)w * 4096 + d) * 96));
    }
    ge kA = ge_identity();
    for (int w = 0; w < 26; w++) {
      int d = sc_window(kw, 10 * w, 10);
      kA = ge_add_aff(kA, ge_aff_load(
          tables + (((size_t)w * 1024 + d) * vb + v) * 96));
    }
    P = ge_add(sB, kA);
  }
  bool nz = !fe_iszero(P.Z);
  // every thread of the block joins; Z == 0 enters as 1
  __shared__ int32_t sm[(VERIFY_BLOCK / 32 + 1) * 10];
  fe zi = fe_block_invert(fe_sel(nz, P.Z, fe_one()), VERIFY_BLOCK / 32, sm);
  if (i >= n) return;            // no barrier below
  uint8_t enc[32];
  fe_tobytes(enc, fe_mul(P.Y, zi));
  enc[31] |= (uint8_t)(fe_parity(fe_mul(P.X, zi)) << 7);
  bool same = true;
  for (int j = 0; j < 32; j++) same = same && enc[j] == sig[j];
  out[i] = in && ok && nz && same;
}

extern "C" int tm_verify_grouped(
    const uint8_t* tables, int vb, const uint8_t* pub_ok,
    const uint8_t* pubs, int n_pubs, const int32_t* pub_idx,
    const int32_t* val_idx, const uint8_t* templates, int n_tmpl,
    int msg_len, const int32_t* tmpl_idx, const uint8_t* sigs,
    const uint8_t* base, uint8_t* out, int n, void* stream) {
  verify_grouped_kernel<<<(n + VERIFY_BLOCK - 1) / VERIFY_BLOCK,
                          VERIFY_BLOCK, 0, (cudaStream_t)stream>>>(
      tables, vb, pub_ok, pubs, n_pubs, pub_idx, val_idx, templates, n_tmpl,
      msg_len, tmpl_idx, sigs, base, out, n);
  return (int)cudaGetLastError();
}
