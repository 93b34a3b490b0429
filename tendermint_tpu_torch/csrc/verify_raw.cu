// K5: raw-lane ed25519 verification, each lane with its own public key.
//
// Replaces tendermint_tpu/ops/ed25519.py verify / verify_batch: the
// mempool's signed-tx CheckTx lane.  One thread per lane runs
// `verify_raw_lane` (tm_verify_raw.cuh, shared with K6), the reference's
// semantics bit for bit.
// What bounds it: integer multiplies.  A lane is ~3.3k field products
// (two decompressions of ~265, 22 x 7 for [s]B, 252 doublings x 8 and
// ~74 adds x 9 for [k](-A), the comparison), each 100 32x32->64
// multiply-adds.  The design keeps lanes independent and simple: the
// 16-entry table (2.5 KB) sits in the lane's local memory, gathered with
// the lane's own digit.  A joint [s]B + [k](-A) ladder, signed windows and
// a table in shared memory are the queued redesigns.
#include <cuda_runtime.h>

#include "tm_verify_raw.cuh"

__global__ void verify_raw_kernel(const uint8_t* __restrict__ pubkeys,
                                  const uint8_t* __restrict__ msgs,
                                  int msg_len,
                                  const uint8_t* __restrict__ sigs,
                                  const uint8_t* __restrict__ base,
                                  uint8_t* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = verify_raw_lane(pubkeys + 32 * (size_t)i,
                           msgs + (size_t)msg_len * i, msg_len,
                           sigs + 64 * (size_t)i, base);
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
