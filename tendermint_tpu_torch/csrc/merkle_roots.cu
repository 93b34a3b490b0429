// K7: batched SHA-256 Merkle roots, each tree in one block.
//
// Replaces tendermint_tpu/ops/merkle.py roots / root_from_leaf_hashes:
// the reference-shaped tree (recursive (n+1)//2 split, SHA-256 of 0x00 ||
// leaf for a leaf and of 0x01 || left || right for an inner node) over a
// batch of equal-shaped trees.  One block of 256 threads per tree:
//   1. the leaves' hashes (or the given leaf hashes), one per thread in
//      turn, into a node buffer;
//   2. each level of the flat schedule table (`ops/merkle.plan_table(n)`:
//      per level m, k, then m (left, right) pairs and k singles indexing
//      the level below), the pairs hashed and the singles copied into the
//      other buffer, a __syncthreads between levels;
//   3. the root's 32 bytes.
// The nodes are held as the digests' eight big-endian words, so an inner
// message is formed by shifting words, not by reading bytes.  The two
// node buffers (2 x n x 32 B) are in dynamic shared memory while they fit
// a block (n <= 3,632); past that the same kernel uses a device scratch
// tensor of the wrapper's.  Uploaded once per (n, device), the table is
// the only schedule the kernel reads: a call copies nothing from the host.
// What bounds it: the 64-round compressions, two per leaf of up to 55
// bytes and two per inner node, in 32-bit integer operations (~1.4k per
// block) against ~L + 32 bytes moved per leaf.  CUDA rather than Triton:
// one message per thread, a barrier between levels and a data-dependent
// gather, with no tile structure.
#include <cuda_runtime.h>

#include "tm_sha256.cuh"

#define MERKLE_BLOCK 256

// SHA-256 of 0x01 || l || r for two digests held as words: 65 bytes, two
// blocks, the second holding r's last byte, the 0x80 and the length.
static __device__ void sha256_inner(const uint32_t* l, const uint32_t* r,
                                    uint32_t st[8]) {
  uint32_t w[16];
  w[0] = 0x01000000u | (l[0] >> 8);
#pragma unroll
  for (int j = 1; j < 8; j++) w[j] = (l[j - 1] << 24) | (l[j] >> 8);
  w[8] = (l[7] << 24) | (r[0] >> 8);
#pragma unroll
  for (int j = 9; j < 16; j++) w[j] = (r[j - 9] << 24) | (r[j - 8] >> 8);
  sha256_init(st);
  sha256_compress(st, w);
  w[0] = (r[7] << 24) | 0x00800000u;
#pragma unroll
  for (int j = 1; j < 15; j++) w[j] = 0;
  w[15] = 65 * 8;
  sha256_compress(st, w);
}

__global__ void __launch_bounds__(MERKLE_BLOCK)
merkle_roots_kernel(const uint8_t* __restrict__ data, int n, int leaf_len,
                    int hashed, const int32_t* __restrict__ plan,
                    int plan_len, uint32_t* __restrict__ scratch, int shared,
                    uint8_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  size_t tree = blockIdx.x;
  uint32_t* cur = shared ? smem : scratch + tree * 2 * (size_t)n * 8;
  uint32_t* nxt = cur + (size_t)n * 8;
  int tid = threadIdx.x;
  const uint8_t* leaves = data + tree * (size_t)n * (hashed ? 32 : leaf_len);
  for (int j = tid; j < n; j += MERKLE_BLOCK) {
    uint32_t st[8];
    if (hashed) {
      const uint8_t* h = leaves + 32 * (size_t)j;
#pragma unroll
      for (int i = 0; i < 8; i++)
        st[i] = (uint32_t)h[4 * i] << 24 | (uint32_t)h[4 * i + 1] << 16 |
                (uint32_t)h[4 * i + 2] << 8 | (uint32_t)h[4 * i + 3];
    } else {
      sha256_prefixed_words(0x00, leaves + (size_t)leaf_len * j, leaf_len,
                            st);
    }
#pragma unroll
    for (int i = 0; i < 8; i++) cur[8 * j + i] = st[i];
  }
  __syncthreads();
  // every thread walks the same table, so each level's barrier is reached
  // by all of them
  for (int pos = 0; pos < plan_len;) {
    int m = plan[pos], k = plan[pos + 1];
    const int32_t* pairs = plan + pos + 2;
    const int32_t* singles = pairs + 2 * m;
    for (int j = tid; j < m + k; j += MERKLE_BLOCK) {
      uint32_t st[8];
      if (j < m) {
        sha256_inner(cur + 8 * pairs[2 * j], cur + 8 * pairs[2 * j + 1], st);
      } else {
        const uint32_t* s = cur + 8 * singles[j - m];
#pragma unroll
        for (int i = 0; i < 8; i++) st[i] = s[i];
      }
#pragma unroll
      for (int i = 0; i < 8; i++) nxt[8 * j + i] = st[i];
    }
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
    pos += 2 + 2 * m + k;
  }
  if (tid < 8) {
    uint32_t w = cur[tid];
#pragma unroll
    for (int b = 0; b < 4; b++)
      out[32 * tree + 4 * tid + b] = (uint8_t)(w >> (24 - 8 * b));
  }
}

extern "C" int tm_merkle_roots(const uint8_t* data, int n, int leaf_len,
                               int hashed, const int32_t* plan, int plan_len,
                               uint32_t* scratch, int shared, uint8_t* out,
                               int trees, void* stream) {
  size_t smem = shared ? (size_t)2 * n * 32 : 0;
  if (smem > 48 * 1024) {        // above 48 KB only when asked for
    cudaError_t e = cudaFuncSetAttribute(
        merkle_roots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  merkle_roots_kernel<<<trees, MERKLE_BLOCK, smem, (cudaStream_t)stream>>>(
      data, n, leaf_len, hashed, plan, plan_len, scratch, shared, out);
  return (int)cudaGetLastError();
}
