// K2: per-validator-set comb tables of the negated public keys.
//
// Replaces tendermint_tpu/ops/ed25519.py build_neg_comb (curve.decompress,
// _comb_row0, build_affine_comb, _affine_pack).  Output entry [w, j, v] is
// j * 2^(10w) * (-A_v) as canonical affine (y+x, y-x, 2dxy) bytes; digit 0
// is (1, 1, 0).  Canonical affine coordinates are unique, so the bytes
// equal the reference's for every valid key; ok[v] is the decompress flag,
// cleared when any entry has Z == 0 (as the reference's batch inversion
// flags it).
// What bounds it: integer multiplies — 26 x 1024 x V entries (3.4 M at
// V = 128), each ~10 doublings + ~5 adds + one ~265-product inversion.
// The reference builds rows with sequential scans and one batch inversion
// per window (the TPU's one core walks the grid in order); here phase 1
// (one thread per key) decompresses and forms the 26 window bases by
// doubling, and phase 2 gives every entry its own thread, so the whole
// table is one wide independent launch.
#include <cuda_runtime.h>

#include "tm_group.cuh"

#define COMB_WINDOWS 26
#define COMB_DIGITS 1024

__device__ __forceinline__ void ge_store(int32_t* dst, const ge& p) {
  for (int i = 0; i < 10; i++) {
    dst[i] = p.X.v[i];
    dst[10 + i] = p.Y.v[i];
    dst[20 + i] = p.Z.v[i];
    dst[30 + i] = p.T.v[i];
  }
}

__device__ __forceinline__ ge ge_fetch(const int32_t* src) {
  ge p;
  for (int i = 0; i < 10; i++) {
    p.X.v[i] = src[i];
    p.Y.v[i] = src[10 + i];
    p.Z.v[i] = src[20 + i];
    p.T.v[i] = src[30 + i];
  }
  return p;
}

// phase 1: decompress, negate, window bases 2^(10w) * (-A) -> bases[w, v]
__global__ void comb_bases_kernel(const uint8_t* __restrict__ pubkeys,
                                  int nv, int32_t* __restrict__ ok,
                                  int32_t* __restrict__ bases) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= nv) return;
  ge a;
  ok[v] = ge_decompress(pubkeys + 32 * (size_t)v, a) ? 1 : 0;
  ge p = ge_neg(a);
  for (int w = 0; w < COMB_WINDOWS; w++) {
    ge_store(bases + ((size_t)w * nv + v) * 40, p);
    if (w + 1 < COMB_WINDOWS) {
      for (int b = 0; b < 10; b++) p = ge_dbl(p);
    }
  }
}

// phase 2: one thread per table entry (w, j, v)
__global__ void comb_entries_kernel(int nv, const int32_t* __restrict__ bases,
                                    uint8_t* __restrict__ tbl,
                                    int32_t* __restrict__ ok) {
  size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t total = (size_t)COMB_WINDOWS * COMB_DIGITS * nv;
  if (e >= total) return;
  int v = (int)(e % nv);
  size_t wj = e / nv;
  int j = (int)(wj % COMB_DIGITS);
  int w = (int)(wj / COMB_DIGITS);
  ge p = ge_fetch(bases + ((size_t)w * nv + v) * 40);
  ge acc = ge_identity();
  for (int b = 9; b >= 0; b--) {
    acc = ge_dbl(acc);
    if ((j >> b) & 1) acc = ge_add(acc, p);
  }
  uint8_t* out = tbl + e * 96;
  if (fe_iszero(acc.Z)) {
    ok[v] = 0;  // benign race: every writer stores 0
    for (int i = 0; i < 96; i++) out[i] = 0;
    return;
  }
  fe zi = fe_invert(acc.Z);
  fe x = fe_mul(acc.X, zi), y = fe_mul(acc.Y, zi);
  fe_tobytes(out, fe_add(y, x));
  fe_tobytes(out + 32, fe_sub(y, x));
  fe_tobytes(out + 64, fe_mul(fe_mul(x, y), fe_d2()));
}

extern "C" int tm_build_neg_comb(const uint8_t* pubkeys, int nv, uint8_t* tbl,
                                 int32_t* ok, int32_t* bases, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  comb_bases_kernel<<<(nv + 31) / 32, 32, 0, s>>>(pubkeys, nv, ok, bases);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t total = (size_t)COMB_WINDOWS * COMB_DIGITS * nv;
  const int threads = 128;
  comb_entries_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                        0, s>>>(nv, bases, tbl, ok);
  return (int)cudaGetLastError();
}
