// K3: batched RFC 8032 signing against a fixed key set.
//
// Replaces tendermint_tpu/ops/ed25519.py sign_grouped_templated (with
// scalar.muladd_mod_L).  One thread per lane: r = SHA-512(prefix || M) mod
// L, R = [r]B by 22 mixed adds from the 12-bit base table, encoded with a
// per-lane inversion, k = SHA-512(R || A || M) mod L, S = (r + k*a) mod L.
// RFC 8032 is deterministic, so the output equals the golden signer's.
// What bounds it: integer multiplies — ~420 field products per lane
// (22 x 7 + ~265 for the inversion), four SHA-512 compressions and three
// bit-serial mod-L reductions.  Lanes are independent; the cross-lane
// batch inversion is the queued redesign, as for K1.
#include <cuda_runtime.h>

#include "tm_group.cuh"
#include "tm_scalar.cuh"
#include "tm_sha512.cuh"

__global__ void sign_grouped_kernel(
    const uint8_t* __restrict__ a_scalars, const uint8_t* __restrict__ prefixes,
    const uint8_t* __restrict__ pubs, int n_keys,
    const int32_t* __restrict__ val_idx, const int32_t* __restrict__ tmpl_idx,
    const uint8_t* __restrict__ templates, int n_tmpl, int msg_len,
    const uint8_t* __restrict__ base, uint8_t* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t* sig = out + 64 * (size_t)i;
  int v = val_idx[i], t = tmpl_idx[i];
  if (v < 0 || v >= n_keys || t < 0 || t >= n_tmpl) {
    for (int j = 0; j < 64; j++) sig[j] = 0;  // no key/message: no signature
    return;
  }
  const uint8_t* msg = templates + (size_t)msg_len * t;
  uint8_t h[64], r[32], R[32], k[32], S[32];
  sha512_3(prefixes + 32 * (size_t)v, 32, msg, msg_len, nullptr, 0, h);
  sc_reduce512(h, r);
  uint64_t rw[4];
  sc_load(r, rw);
  ge acc = ge_identity();
  for (int w = 0; w < 22; w++) {
    int d = sc_window(rw, 12 * w, 12);
    acc = ge_add_aff(acc, ge_aff_load(base + ((size_t)w * 4096 + d) * 96));
  }
  ge_encode(acc, R);  // [r]B is a valid point: Z != 0
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
  const int threads = 128;
  sign_grouped_kernel<<<(n + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(
      a_scalars, prefixes, pubs, n_keys, val_idx, tmpl_idx, templates, n_tmpl,
      msg_len, base, out, n);
  return (int)cudaGetLastError();
}
