// K2: per-validator-set comb tables of the negated public keys.
//
// Replaces tendermint_tpu/ops/ed25519.py build_neg_comb (curve.decompress,
// _comb_row0, build_affine_comb, _affine_pack over field.batch_inv).
// Output entry [w, j, v] is j * 2^(10w) * (-A_v) as canonical affine
// (y+x, y-x, 2dxy) bytes; digit 0 is (1, 1, 0).  Canonical affine
// coordinates are unique, so the bytes equal the reference's for every
// valid key whatever chain of adds reached the point.  ok[v] is the
// decompress flag, cleared when any entry has Z == 0; such an entry is
// written as zero bytes and enters the batch inversion as 1, as the
// reference's batch inversion masks it, so an undecodable key's garbage
// chain cannot reach another entry.
//
// What bounds it: integer multiplies.  Per entry the reference's algorithm
// needs one add onto entry j - 1, three products of a batch inversion and
// four of the affine pack; each thread-per-entry design would spend ~10
// doublings, ~5 adds and its own ~265-product Fermat inversion instead.
// Design, two launches:
//   phase 1, `comb_bases_kernel`: a quad of four threads per key (one
//   extended coordinate each, tm_quad.cuh) decompresses the key and runs
//   the 250 doublings of the window bases 2^(10w) * (-A), two products
//   deep per doubling; the bases go to `bases` in extended coordinates.
//   Its latency (one chain of 250 doublings) is a fixed cost per call.
//   phase 2, `comb_rows_kernel`: one warp per row (w, v) of 1,024 digits,
//   lane s owning digits [32s, 32s + 32).  The lane's start 32s * P_w
//   comes from an exclusive prefix scan of 32 P_w over the warp (5
//   shuffled adds); then it walks its run by one cached add (8 products)
//   per entry, keeping the running product c of the Z's and staging
//   (X * c_prev, Y * c_prev, Z) in the entry's own 96 output bytes (X'
//   and Y' as packed limbs, Z canonical for its zero test).  The block's 128 lanes (four rows) share one inversion of the
//   product of all their Z's (fe_block_invert: one `fe_invert` by warp 0
//   for the block, where all 32 lanes of a warp inverting in step would
//   cost a warp's instruction slots each time); each lane then walks its run
//   backwards with 1 / (Z_0 ... Z_r): x = X' / (Z_0 ... Z_r), likewise y,
//   then multiplies Z_r in (3 products, 5 with x*y*2d), writing the final
//   bytes over the staged ones in 16-byte stores.  ~21 products per entry
//   where the old design spent ~400.  Every thread reaches every barrier
//   (a warp past the last row runs no chain and stores nothing).
#include <cuda_runtime.h>

#include "tm_quad.cuh"

#define COMB_WINDOWS 26
#define COMB_DIGITS 1024
#define COMB_RUN 32                 // digits per lane: one warp per row
#define COMB_BLOCK 128              // threads per block: four rows
#define COMB_ROWS (COMB_BLOCK / 32)

// phase 1: decompress, negate, window bases 2^(10w) * (-A) -> bases[w, v]
__global__ void __launch_bounds__(COMB_BLOCK)
comb_bases_kernel(const uint8_t* __restrict__ pubkeys, int nv,
                  int32_t* __restrict__ ok, int32_t* __restrict__ bases) {
  int v = (blockIdx.x * COMB_BLOCK + (int)threadIdx.x) / RAW_QUAD;
  quad_ctx t;
  t.q = threadIdx.x & 3;
  t.mask = 0xfu << (threadIdx.x & 28);
  bool live = v < nv;       // a quad past the last key runs key 0's copy
  ge a;
  bool dec = ge_decompress(pubkeys + 32 * (size_t)(live ? v : 0), a);
  if (live && t.q == 0) ok[v] = dec ? 1 : 0;
  // this thread's coordinate of -A = (-X, Y, 1, -T)
  fe p = fe_sel(t.q == 0, fe_neg(a.X),
                fe_sel(t.q == 1, a.Y, fe_sel(t.q == 2, a.Z, fe_neg(a.T))));
  for (int w = 0; w < COMB_WINDOWS; w++) {
    if (live) {
      int32_t* dst = bases + ((size_t)w * nv + v) * 40 + 10 * t.q;
#pragma unroll
      for (int i = 0; i < 10; i++) dst[i] = p.v[i];
    }
    if (w + 1 < COMB_WINDOWS) {
      for (int b = 0; b < 10; b++) p = quad_dbl(t, p);
    }
  }
}

static __device__ __forceinline__ ge ge_sel(bool c, const ge& a,
                                            const ge& b) {
  ge r;
  r.X = fe_sel(c, a.X, b.X);
  r.Y = fe_sel(c, a.Y, b.Y);
  r.Z = fe_sel(c, a.Z, b.Z);
  r.T = fe_sel(c, a.T, b.T);
  return r;
}

static __device__ __forceinline__ ge ge_shfl_up(const ge& p, int d) {
  ge r;
  r.X = fe_shfl_up(p.X, d);
  r.Y = fe_shfl_up(p.Y, d);
  r.Z = fe_shfl_up(p.Z, d);
  r.T = fe_shfl_up(p.T, d);
  return r;
}

// A staged element: 10 limbs as fe_carry leaves them (limb 1 below 2^26,
// the others within their widths: every fe_mul result) packed into 256
// bits, no reduction mod p.  Limb i of the stage is STAGE_BITS(i) wide.
#define STAGE_BITS(i) ((i) == 1 ? 26 : FE_BITS(i))

static __device__ __forceinline__ void fe_stage(uint32_t w[8], const fe& f) {
  uint64_t acc = 0;
  int nbits = 0, word = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    acc |= (uint64_t)(uint32_t)f.v[i] << nbits;
    nbits += STAGE_BITS(i);
    if (nbits >= 32) {
      w[word++] = (uint32_t)acc;
      acc >>= 32;
      nbits -= 32;
    }
  }
}

static __device__ __forceinline__ fe fe_unstage(const uint32_t w[8]) {
  fe r;
  uint64_t acc = 0;
  int nbits = 0, word = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    if (nbits < STAGE_BITS(i)) {
      acc |= (uint64_t)w[word++] << nbits;
      nbits += 32;
    }
    r.v[i] = (int32_t)(acc & ((1u << STAGE_BITS(i)) - 1));
    acc >>= STAGE_BITS(i);
    nbits -= STAGE_BITS(i);
  }
  return r;
}

static __device__ __forceinline__ bool words_zero(const uint32_t w[8]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= w[i];
  return acc == 0;
}

// 24 words of an entry's 96 bytes, in 16-byte units
static __device__ __forceinline__ void entry_store(uint8_t* e,
                                                   const uint32_t w[24]) {
  uint4* d = reinterpret_cast<uint4*>(e);
#pragma unroll
  for (int i = 0; i < 6; i++)
    d[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

static __device__ __forceinline__ void entry_load(const uint8_t* e,
                                                  uint32_t w[24]) {
  const uint4* s = reinterpret_cast<const uint4*>(e);
#pragma unroll
  for (int i = 0; i < 6; i++) {
    uint4 u = s[i];
    w[4 * i] = u.x;
    w[4 * i + 1] = u.y;
    w[4 * i + 2] = u.z;
    w[4 * i + 3] = u.w;
  }
}

// phase 2: one warp per row (w, v), COMB_RUN consecutive digits per lane;
// three blocks per SM asked of the register allocator (measured fastest)
__global__ void __launch_bounds__(COMB_BLOCK, 3)
comb_rows_kernel(int nv, const int32_t* __restrict__ bases,
                 uint8_t* __restrict__ tbl, int32_t* __restrict__ ok) {
  __shared__ int32_t sm[(COMB_ROWS + 1) * 10];  // warp totals, inverse
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int row = blockIdx.x * COMB_ROWS + warp;      // row = w * nv + v
  bool live = row < COMB_WINDOWS * nv;          // warp-uniform
  int w = live ? row / nv : 0, v = live ? row % nv : 0;
  // entry (w, j, v) of the lane's first digit; entries of a row lie
  // nv * 96 bytes apart
  uint8_t* out = tbl + (((size_t)w * COMB_DIGITS + COMB_RUN * lane) * nv + v)
                       * 96;
  size_t stride = (size_t)nv * 96;
  fe c = fe_one();              // the product of the run's nonzero Z's
  ge_cached step;
  if (live) {
    const int32_t* src = bases + (size_t)row * 40;
    ge p;
#pragma unroll
    for (int i = 0; i < 10; i++) {
      p.X.v[i] = src[i];
      p.Y.v[i] = src[10 + i];
      p.Z.v[i] = src[20 + i];
      p.T.v[i] = src[30 + i];
    }
    step = ge_to_cached(p);
    // the lane's start 32 lane * P: exclusive scan of 32 P over the warp
    ge q = p;
    for (int b = 0; b < 5; b++) q = ge_dbl(q);
    for (int d = 1; d < 32; d <<= 1)
      q = ge_add(q, ge_sel(lane >= d, ge_shfl_up(q, d), ge_identity()));
    ge acc = ge_sel(lane > 0, ge_shfl_up(q, 1), ge_identity());
    bool zero_seen = false;
    for (int r = 0; r < COMB_RUN; r++) {
      if (r > 0) acc = ge_add_cached(acc, step);
      uint32_t st[24];
      fe_stage(st, fe_mul(acc.X, c));
      fe_stage(st + 8, fe_mul(acc.Y, c));
      fe_towords(st + 16, acc.Z);             // canonical: the zero test
      if (words_zero(st + 16)) zero_seen = true;   // enters the chain as 1
      else c = fe_mul(c, acc.Z);
      entry_store(out + r * stride, st);
    }
    if (zero_seen) ok[v] = 0;   // every writer stores 0
  }

  fe ic = fe_block_invert(c, COMB_ROWS, sm);   // 1 / c
  if (!live) return;            // no barrier below

  // backwards over the run: ic = 1 / (Z_0 ... Z_r) at entry r
  for (int r = COMB_RUN - 1; r >= 0; r--) {
    uint32_t st[24];
    entry_load(out + r * stride, st);
    if (!words_zero(st + 16)) {
      fe x = fe_mul(fe_unstage(st), ic);
      fe y = fe_mul(fe_unstage(st + 8), ic);
      ic = fe_mul(ic, fe_fromwords(st + 16));
      fe_towords(st, fe_lin(0, 1, y, 1, x));
      fe_towords(st + 8, fe_lin(2, 1, y, -1, x));
      fe_towords(st + 16, fe_mul(fe_mul(x, y), fe_d2()));
    } else {
#pragma unroll
      for (int i = 0; i < 16; i++) st[i] = 0;   // Z == 0: zero bytes
    }
    entry_store(out + r * stride, st);
  }
}

extern "C" int tm_build_neg_comb(const uint8_t* pubkeys, int nv, uint8_t* tbl,
                                 int32_t* ok, int32_t* bases, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int quads = nv * RAW_QUAD;
  comb_bases_kernel<<<(quads + COMB_BLOCK - 1) / COMB_BLOCK, COMB_BLOCK, 0,
                      s>>>(pubkeys, nv, ok, bases);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int rows = COMB_WINDOWS * nv;
  comb_rows_kernel<<<(rows + COMB_ROWS - 1) / COMB_ROWS, COMB_BLOCK, 0, s>>>(
      nv, bases, tbl, ok);
  return (int)cudaGetLastError();
}
