// K3: batched RFC 8032 signing against a fixed key set.
//
// Replaces tendermint_tpu/ops/ed25519.py sign_grouped_templated (with
// curve.encode_batch and scalar.muladd_mod_L).  One thread per lane:
//   1. r = SHA-512(prefix || M) mod L;
//   2. R = [r]B by 22 mixed adds from the 12-bit base table;
//   3. one Montgomery batch inversion of Z across the block of 128 lanes
//      (fe_block_invert: a prefix and a suffix scan by shuffles per warp,
//      the warps' totals in shared memory, one `fe_invert` by warp 0);
//   4. encode R;
//   5. k = SHA-512(R || A || M) mod L;
//   6. S = (r + k*a) mod L.
// RFC 8032 is deterministic, so the output equals the golden signer's.
// A lane with no key or no message (an index out of range) and a lane past
// N join the inversion with Z = 1 (the identity); the former writes 64
// zero bytes, the latter nothing.
// What bounds it: integer multiplies.  Per lane ~154 products for [r]B,
// ~16 for the scans and a quarter of a warp's ~265-product inversion
// where every warp ran one (all 32 lanes in step: a warp-wide batch
// inversion would save no instruction slots, a block-wide one saves three in
// four), four SHA-512 compressions, and three mod-L reductions by
// Barrett on 64-bit words (tm_scalar.cuh) where the bit-serial ones cost
// as much as ~117 field products each in one warp.
#include <cuda_runtime.h>

#include "tm_group.cuh"
#include "tm_scalar.cuh"
#include "tm_sha512.cuh"

#define SIGN_BLOCK 128

// four blocks per SM asked of the register allocator (measured fastest)
__global__ void __launch_bounds__(SIGN_BLOCK, 4)
sign_grouped_kernel(
    const uint8_t* __restrict__ a_scalars, const uint8_t* __restrict__ prefixes,
    const uint8_t* __restrict__ pubs, int n_keys,
    const int32_t* __restrict__ val_idx, const int32_t* __restrict__ tmpl_idx,
    const uint8_t* __restrict__ templates, int n_tmpl, int msg_len,
    const uint8_t* __restrict__ base, uint8_t* __restrict__ out, int n) {
  int i = blockIdx.x * SIGN_BLOCK + (int)threadIdx.x;
  int v = -1, t = -1;
  if (i < n) {
    v = val_idx[i];
    t = tmpl_idx[i];
  }
  bool sign = v >= 0 && v < n_keys && t >= 0 && t < n_tmpl;
  const uint8_t* msg = templates + (size_t)msg_len * (sign ? t : 0);
  uint8_t r[32];
  ge acc = ge_identity();
  if (sign) {
    uint8_t h[64];
    sha512_3(prefixes + 32 * (size_t)v, 32, msg, msg_len, nullptr, 0, h);
    sc_reduce512(h, r);
    uint64_t rw[4];
    sc_load(r, rw);
    for (int w = 0; w < 22; w++) {
      int d = sc_window(rw, 12 * w, 12);
      acc = ge_add_aff(acc, ge_aff_load(base + ((size_t)w * 4096 + d) * 96));
    }
  }
  // every thread of the block joins: [r]B is a valid point, so Z != 0
  __shared__ int32_t sm[(SIGN_BLOCK / 32 + 1) * 10];
  fe zi = fe_block_invert(acc.Z, SIGN_BLOCK / 32, sm);
  if (i >= n) return;           // no barrier below
  uint8_t* sig = out + 64 * (size_t)i;
  if (!sign) {
    for (int j = 0; j < 64; j++) sig[j] = 0;   // no key/message: no signature
    return;
  }
  uint8_t h[64], R[32], k[32], S[32];
  fe_tobytes(R, fe_mul(acc.Y, zi));
  R[31] |= (uint8_t)(fe_parity(fe_mul(acc.X, zi)) << 7);
  sha512_3(R, 32, pubs + 32 * (size_t)v, 32, msg, msg_len, h);
  sc_reduce512(h, k);
  sc_muladd(k, a_scalars + 32 * (size_t)v, r, S);
  for (int j = 0; j < 32; j++) {
    sig[j] = R[j];
    sig[32 + j] = S[j];
  }
}

extern "C" int tm_sign_grouped(const uint8_t* a_scalars, const uint8_t* prefixes,
                               const uint8_t* pubs, int n_keys,
                               const int32_t* val_idx, const int32_t* tmpl_idx,
                               const uint8_t* templates, int n_tmpl,
                               int msg_len, const uint8_t* base, uint8_t* out,
                               int n, void* stream) {
  sign_grouped_kernel<<<(n + SIGN_BLOCK - 1) / SIGN_BLOCK, SIGN_BLOCK, 0,
                        (cudaStream_t)stream>>>(
      a_scalars, prefixes, pubs, n_keys, val_idx, tmpl_idx, templates, n_tmpl,
      msg_len, base, out, n);
  return (int)cudaGetLastError();
}
