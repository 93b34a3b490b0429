// K1: grouped ed25519 verification against per-validator comb tables.
//
// Replaces tendermint_tpu/ops/ed25519.py verify_grouped_templated /
// verify_grouped (the fast-sync hot plane).  One thread per lane:
//   gather the lane's template and public key, k = SHA-512(R || A || M)
//   mod L, check s < L, [s]B by 22 mixed adds from the 12-bit base table,
//   [k](-A) by 26 mixed adds from the set's 10-bit comb table, one full
//   add, encode (per-lane Fermat inversion), byte-compare with R, and mask
//   by pub_ok[val_idx] and Z != 0.
// What bounds it: integer multiplies.  A lane is ~610 field products
// (48 x 7 mixed-add products + 9 + ~265 for the inversion), each 100
// 32x32->64 multiply-adds, plus two SHA-512 compressions and a bit-serial
// mod-L reduction; the gathers read 48 x 96 bytes.  The design keeps every
// lane independent (no cross-lane state), reads each table row with the
// lane's own index, and keeps products out of line so the kernel stays
// small; the cross-lane batch inversion that removes ~260 products per
// lane is the queued redesign.
#include <cuda_runtime.h>

#include "tm_group.cuh"
#include "tm_scalar.cuh"
#include "tm_sha512.cuh"

__global__ void verify_grouped_kernel(
    const uint8_t* __restrict__ tables, int vb,
    const uint8_t* __restrict__ pub_ok, const uint8_t* __restrict__ pubs,
    int n_pubs, const int32_t* __restrict__ pub_idx,
    const int32_t* __restrict__ val_idx,
    const uint8_t* __restrict__ templates, int n_tmpl, int msg_len,
    const int32_t* __restrict__ tmpl_idx, const uint8_t* __restrict__ sigs,
    const uint8_t* __restrict__ base, uint8_t* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int v = val_idx[i], pi = pub_idx[i], ti = tmpl_idx[i];
  if (v < 0 || v >= vb || pi < 0 || pi >= n_pubs || ti < 0 || ti >= n_tmpl) {
    out[i] = 0;  // an index out of range is a lane that cannot verify
    return;
  }
  const uint8_t* sig = sigs + 64 * (size_t)i;
  const uint8_t* msg = templates + (size_t)msg_len * ti;
  uint8_t h[64], k[32];
  sha512_3(sig, 32, pubs + 32 * (size_t)pi, 32, msg, msg_len, h);
  sc_reduce512(h, k);
  bool ok_s = sc_lt_L(sig + 32);

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
  uint8_t enc[32];
  bool nz = ge_encode(ge_add(sB, kA), enc);
  bool same = true;
  for (int j = 0; j < 32; j++) same = same && enc[j] == sig[j];
  out[i] = (pub_ok[v] != 0) && ok_s && nz && same;
}

extern "C" int tm_verify_grouped(
    const uint8_t* tables, int vb, const uint8_t* pub_ok,
    const uint8_t* pubs, int n_pubs, const int32_t* pub_idx,
    const int32_t* val_idx, const uint8_t* templates, int n_tmpl,
    int msg_len, const int32_t* tmpl_idx, const uint8_t* sigs,
    const uint8_t* base, uint8_t* out, int n, void* stream) {
  const int threads = 128;
  verify_grouped_kernel<<<(n + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
      tables, vb, pub_ok, pubs, n_pubs, pub_idx, val_idx, templates, n_tmpl,
      msg_len, tmpl_idx, sigs, base, out, n);
  return (int)cudaGetLastError();
}
