// K5: raw-lane ed25519 verification, each lane with its own public key.
//
// Replaces tendermint_tpu/ops/ed25519.py verify / verify_batch: the
// mempool's signed-tx CheckTx lane.  A block of 128 threads runs
// `verify_raw_block` (tm_verify_raw.cuh, shared with K6) on 32 lanes, a
// quad of four threads per lane, with the reference's semantics bit for
// bit.
// What bounds it: integer multiplies, and on the mempool's small flushes
// (32-64 lanes, one or two blocks) the latency of one lane's chain of
// dependent field products.  The quad cuts that chain from ~3.3k products
// to ~1k (an add or a doubling is two products deep, one coordinate per
// thread), keeps each lane's window table in shared memory instead of
// local memory, and holds ~10 live limbs per thread instead of 40 or more.
#include <cuda_runtime.h>

// A flush of the mempool (32-64 lanes) is one or two blocks: the lane's
// latency is the time, so everything is inlined (measured on an H100:
// 0.42 ms at 64 lanes against 0.46 with the field products out of line).
#ifndef TM_FE_MUL_INLINE
#define TM_FE_MUL_INLINE
#endif
#include "tm_verify_raw.cuh"

__global__ void __launch_bounds__(RAW_BLOCK, RAW_MIN_BLOCKS)
verify_raw_kernel(const uint8_t* __restrict__ pubkeys,
                  const uint8_t* __restrict__ msgs, int msg_len,
                  const uint8_t* __restrict__ sigs,
                  const uint8_t* __restrict__ base, uint8_t* __restrict__ out,
                  int n) {
  __shared__ int32_t sm[RAW_SMEM_WORDS];
  int first = blockIdx.x * RAW_LANES;
  // lanes past n run lane 0's copy and store nothing
  int i = first + (int)(threadIdx.x & (RAW_LANES - 1));
  size_t li = i < n ? (size_t)i : 0;
  int qi = first + (int)threadIdx.x / RAW_QUAD;
  size_t lq = qi < n ? (size_t)qi : 0;
  bool ok = verify_raw_block(pubkeys + 32 * li, msgs + (size_t)msg_len * li,
                             sigs + 64 * li, msg_len, sigs + 64 * lq, base,
                             sm);
  if (qi < n && (threadIdx.x & (RAW_QUAD - 1)) == 0) out[qi] = ok;
}

extern "C" int tm_verify_raw(const uint8_t* pubkeys, const uint8_t* msgs,
                             int msg_len, const uint8_t* sigs,
                             const uint8_t* base, uint8_t* out, int n,
                             void* stream) {
  verify_raw_kernel<<<(n + RAW_LANES - 1) / RAW_LANES, RAW_BLOCK, 0,
                      (cudaStream_t)stream>>>(pubkeys, msgs, msg_len, sigs,
                                              base, out, n);
  return (int)cudaGetLastError();
}
