// K4: SHA-256 of prefix_byte || msg for N equal-length messages.
//
// Replaces tendermint_tpu/ops/sha256.py sha256 as used by ops/merkle.py
// leaf_hashes (0x00 || leaf): part-set chunks and other leaf batches (the
// trees' roots are K7's).  One thread per message.
// What bounds it: for 64-byte leaves, the 64-round compressions (two per
// message, ~2.8k 32-bit ALU operations) against 97 bytes moved, so
// integer throughput, not memory.  CUDA rather than Triton: the work is
// 32-bit rotate/add/xor rounds with no block-level tensor structure.
#include <cuda_runtime.h>

#include "tm_sha256.cuh"

__global__ void sha256_prefixed_kernel(const uint8_t* __restrict__ msgs,
                                       int msg_len, int prefix,
                                       uint8_t* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  sha256_prefixed((uint32_t)prefix, msgs + (size_t)msg_len * i, msg_len,
                  out + 32 * (size_t)i);
}

extern "C" int tm_sha256_prefixed(const uint8_t* msgs, int msg_len,
                                  int prefix, uint8_t* out, int n,
                                  void* stream) {
  const int threads = 128;
  sha256_prefixed_kernel<<<(n + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(msgs, msg_len, prefix, out,
                                                   n);
  return (int)cudaGetLastError();
}
