// K4: SHA-256 of prefix_byte || msg for N equal-length messages.
//
// Replaces tendermint_tpu/ops/merkle.py:98 leaf_hashes over
// tendermint_tpu/ops/sha256.py:114 sha256 (0x00 || leaf): the part sets'
// full 64 KB chunks, snapshot chunks and other leaf batches (the trees'
// roots are K7's).  A row's SHA-256 is a chain of compressions that no
// split of the row shortens, so each row has one lane.
//
// Two routes, chosen in tm_sha256_prefixed from the row length L and the
// alignment of msgs alone (N only sizes the grid); ops/sha256._k4_route
// mirrors the rule:
//  - staged, when L % 16 == 0, L >= K4_STAGE and msgs is 16-byte aligned
//    (the parts and snapshot chunks).  A block of two warps hashes 32
//    rows, one lane per row in each warp.  Warp 0, the schedule warp,
//    copies each stage (K4_STAGE bytes of each row) into a ring of K4_RING
//    stages in shared memory with 16-byte cp.async copies, row by row, lane
//    j copying pieces j, j + 32, ..., so each global read is 512
//    contiguous bytes and stage k + K4_RING - 1 is in flight while stage k
//    is read.  It builds each block's 16 message words, expands them to the
//    64 scheduled words plus the round constants, and hands them to warp 1,
//    the round warp, through a ring of K4_DEPTH blocks in shared memory.
//    Warp 1 runs only the 64 rounds.  The two warps sit on two of the SM's
//    four schedulers, so a row's chain carries ~900 of the ~1,400
//    instructions of a compression.  Lanes past N copy for the other rows
//    and meet every barrier, with no row of their own.
//  - direct, for every other shape (the 64-byte tree leaves, 1,000-byte
//    rows, any L % 16 != 0 or unaligned base): one thread per row, 128 a
//    block, reading 16-byte pieces where L % 16 == 0 and msgs is 16-byte
//    aligned, 4-byte words where L % 4 == 0 and msgs is 4-byte aligned, and
//    else four byte loads per word.
// Both build each message word with one __byte_perm (tm_sha256.cuh
// sha256_word): no branch per byte and no padding logic in the body.  The
// last one or two blocks come from sha256_tail_words, which reads the
// final L % 64 bytes as words (bytes on the unaligned path).
//
// Shared memory (staged route), conflict-free by layout:
//  - the copy ring: row r of the block has a slot of K4_SLOT = K4_STAGE +
//    16 bytes in each stage.  Lane r reads its slot in 16-byte pieces
//    (LDS.128); piece j's 16-byte bank group is (33 r + j) mod 8, up to a
//    constant, when K4_STAGE is a multiple of 128, so any 8 neighbouring
//    lanes hit 8 distinct groups.  Each cp.async row copy writes 512
//    contiguous bytes.
//  - the scheduled ring: word t of row r in slot s is at uint4 (s * 16 +
//    t / 4) * 32 + r, so each STS.128 and LDS.128 of a warp covers 512
//    contiguous bytes.
//
// What bounds it: for 64-byte leaves, the compressions' 32-bit integer
// operations across the card.  For 64 KB parts, the chain: a part is 1,025
// dependent compressions, and 2,048 parts are 64 blocks on 64 SMs, each
// round warp issuing its rounds through its scheduler's 16-lane ALU pipe
// (~2 cycles a warp instruction).  CUDA rather than Triton: 32-bit
// rotate/add/xor rounds, byte permutes, a hand-run copy ring and two
// warps in step on named barriers, with no tile structure.
#include <cuda_runtime.h>

#include "tm_sha256.cuh"

#define K4_STAGE 512          // bytes of each row per stage
#define K4_RING 2             // stages in the copy ring
#define K4_SLOT (K4_STAGE + 16)
#define K4_RING_SMEM (K4_RING * 32 * K4_SLOT)
#define K4_DIRECT_BLOCK 128

static_assert(K4_STAGE % 128 == 0, "a stage is whole blocks, and the slot "
              "stride must be 16 mod 128 for conflict-free LDS.128");
static_assert(K4_RING >= 2, "the ring needs a stage in flight");

enum { K4_STAGED = 0, K4_DIRECT16 = 1, K4_DIRECT4 = 2, K4_DIRECT1 = 3 };

static __device__ __forceinline__ void cp_async16(void* smem,
                                                  const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Stage k: bytes [k * K4_STAGE, ...) of the body (the rows' whole 64-byte
// blocks, `body` bytes) of the warp's `rows` rows, into ring slot k %
// K4_RING.  One commit group per call, empty past the last stage, so the
// count of groups in flight is the same in every iteration.
static __device__ __forceinline__ void stage_issue(uint8_t* ring,
                                                   const uint8_t* base,
                                                   size_t len, int rows,
                                                   int body, int k,
                                                   int lane) {
  const int off = k * K4_STAGE;
  if (off < body) {
    const int pieces = min(K4_STAGE, body - off) / 16;
    uint8_t* slot = ring + (k % K4_RING) * 32 * K4_SLOT;
    for (int r = 0; r < rows; r++) {
      const uint8_t* src = base + r * len + off;
      for (int j = lane; j < pieces; j += 32)
        cp_async16(slot + r * K4_SLOT + 16 * j, src + 16 * j);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The tail's words from a row whose length is a multiple of 4 and whose
// base is 4-byte aligned: r / 4 loaded words, then 0x80, then zeros.
struct WordTail {
  const uint32_t* p;
  int words;
  __device__ __forceinline__ uint32_t operator()(int j) const {
    return j < words ? p[j] : (j == words ? 0x80u : 0u);
  }
};

// The tail's words byte by byte (any alignment and length).
struct ByteTail {
  const uint8_t* p;
  int r;
  __device__ __forceinline__ uint32_t operator()(int j) const {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; k++) {
      const int i = 4 * j + k;
      const uint32_t b = i < r ? p[i] : (i == r ? 0x80u : 0u);
      v |= b << (8 * k);
    }
    return v;
  }
};

#define K4_DEPTH 4            // scheduled blocks in flight between the warps
#define K4_WSLOT (16 * 32)    // uint4 of a scheduled block: 64 words x 32 rows
#define K4_STAGED_SMEM (K4_RING_SMEM + K4_DEPTH * K4_WSLOT * 16)
static_assert(2 * K4_DEPTH < 16, "named barriers 1 .. 2 K4_DEPTH");

// Named barriers of the two warps of a staged block (64 threads): EMPTY(s)
// = 1 + s, the round warp has read scheduled slot s; FULL(s) = 1 + K4_DEPTH
// + s, the schedule warp has written it.  bar.arrive does not wait;
// bar.sync waits for the other warp's arrive, and orders the shared-memory
// accesses before the arrive before those after the sync.
static __device__ __forceinline__ void bar_sync64(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}
static __device__ __forceinline__ void bar_arrive64(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

// Schedule warp: block g's message schedule plus the round constants,
// W[t] + K[t] for t = 0..63 from its first 16 words w, into slot g %
// K4_DEPTH; the lane's words 4q .. 4q + 3 are uint4 q * 32 + lane, so each
// STS.128 / LDS.128 of the warp covers 512 contiguous bytes.
static __device__ __forceinline__ void put_block(uint4* wring, int g,
                                                 uint32_t w[16], int lane) {
  const int s = g % K4_DEPTH;
  bar_sync64(1 + s);
  uint4* slot = wring + s * K4_WSLOT + lane;
#pragma unroll
  for (int q = 0; q < 16; q++) {
    uint32_t kw[4];
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const int t = 4 * q + i;
      if (t >= 16) {
        const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
        const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
        const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
        w[t & 15] += s0 + w[(t - 7) & 15] + s1;
      }
      kw[i] = w[t & 15] + SHA256_K[t];
    }
    slot[q * 32] = make_uint4(kw[0], kw[1], kw[2], kw[3]);
  }
  bar_arrive64(1 + K4_DEPTH + s);
}

// Round warp: the 64 rounds of one block from its W[t] + K[t] in `slot`
// (this lane's first uint4), and the state add.
static __device__ __forceinline__ void rounds_kw(uint32_t st[8],
                                                 const uint4* slot) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int q = 0; q < 16; q++) {
    const uint4 v = slot[q * 32];
    const uint32_t kw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
      const uint32_t ch = (e & f) ^ (~e & g);
      const uint32_t t1 = h + S1 + ch + kw[i];
      const uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
      const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      h = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + S0 + maj;
    }
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// The staged route: warp 0 runs the copy ring, builds the message words
// and schedules them (sha256_compress's 48 scheduled words, ~35 % of its
// instructions), warp 1 runs only the rounds, at most K4_DEPTH blocks
// behind.  Every lane of both warps walks the same blocks, so every
// barrier is met by all 64 threads.
__global__ void __launch_bounds__(64)
sha256_staged_kernel(const uint8_t* __restrict__ msgs, int msg_len,
                    int prefix, uint8_t* __restrict__ out, int n) {
  extern __shared__ uint4 k4_ring[];
  uint8_t* ring = (uint8_t*)k4_ring;
  uint4* wring = k4_ring + K4_RING_SMEM / 16;
  const int lane = threadIdx.x & 31;
  const size_t row0 = (size_t)blockIdx.x * 32;
  const int rows = min(32, n - (int)row0);
  const size_t len = (size_t)msg_len;
  const uint8_t* base = msgs + row0 * len;
  const int body = msg_len & ~63;
  const int r = msg_len - body;
  const int nb = body / 64 + sha256_tail_blocks(r);
  const bool active = lane < rows;
  if (threadIdx.x >= 32) {                 // the round warp
    uint32_t st[8];
    sha256_init(st);
    for (int s = 0; s < min(K4_DEPTH, nb); s++) bar_arrive64(1 + s);
    for (int g = 0; g < nb; g++) {
      const int s = g % K4_DEPTH;
      bar_sync64(1 + K4_DEPTH + s);
      rounds_kw(st, wring + s * K4_WSLOT + lane);
      if (g + K4_DEPTH < nb) bar_arrive64(1 + s);
    }
    if (active) sha256_store(st, out + 32 * (row0 + lane));
    return;
  }
  const int stages = (body + K4_STAGE - 1) / K4_STAGE;
  uint32_t prev = (uint32_t)prefix << 24;
  int g = 0;
#pragma unroll
  for (int k = 0; k < K4_RING - 1; k++)
    stage_issue(ring, base, len, rows, body, k, lane);
  for (int k = 0; k < stages; k++) {
    stage_issue(ring, base, len, rows, body, k + K4_RING - 1, lane);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(K4_RING - 1) : "memory");
    __syncwarp();
    const uint4* p =
        (const uint4*)(ring + ((k % K4_RING) * 32 + lane) * K4_SLOT);
    const int blocks = min(K4_STAGE, body - k * K4_STAGE) / 64;
    for (int b = 0; b < blocks; b++) {
      const uint4 q0 = p[4 * b], q1 = p[4 * b + 1], q2 = p[4 * b + 2],
                  q3 = p[4 * b + 3];
      const uint32_t lw[16] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                               q1.z, q1.w, q2.x, q2.y, q2.z, q2.w,
                               q3.x, q3.y, q3.z, q3.w};
      uint32_t w[16];
      sha256_block_words(lw, prev, w);
      put_block(wring, g++, w, lane);
    }
    __syncwarp();
  }
  // a lane past N reads row 0's tail (its words are never stored)
  const uint8_t* row = base + (active ? lane : 0) * len;
  sha256_tail_words(
      prev, r, 8 * ((uint64_t)msg_len + 1),
      WordTail{(const uint32_t*)(row + body), r / 4},
      [&](uint32_t w[16]) { put_block(wring, g++, w, lane); });
}

// The 16 little-endian words of msg[0..63], read W bytes at a time.
template <int W>
static __device__ __forceinline__ void load_lw(const uint8_t* p,
                                               uint32_t lw[16]) {
  if (W == 16) {
#pragma unroll
    for (int q = 0; q < 4; q++) {
      const uint4 v = ((const uint4*)p)[q];
      lw[4 * q] = v.x;
      lw[4 * q + 1] = v.y;
      lw[4 * q + 2] = v.z;
      lw[4 * q + 3] = v.w;
    }
  } else if (W == 4) {
#pragma unroll
    for (int i = 0; i < 16; i++) lw[i] = ((const uint32_t*)p)[i];
  } else {
#pragma unroll
    for (int i = 0; i < 16; i++)
      lw[i] = (uint32_t)p[4 * i] | (uint32_t)p[4 * i + 1] << 8 |
              (uint32_t)p[4 * i + 2] << 16 | (uint32_t)p[4 * i + 3] << 24;
  }
}

template <int W>
__global__ void __launch_bounds__(K4_DIRECT_BLOCK)
sha256_direct_kernel(const uint8_t* __restrict__ msgs, int msg_len,
                     int prefix, uint8_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* row = msgs + (size_t)msg_len * i;
  const int blocks = msg_len >> 6;
  uint32_t st[8];
  sha256_init(st);
  uint32_t prev = (uint32_t)prefix << 24;
  for (int b = 0; b < blocks; b++) {
    uint32_t lw[16], w[16];
    load_lw<W>(row + 64 * (size_t)b, lw);
    sha256_block_words(lw, prev, w);
    sha256_compress(st, w);
  }
  const uint8_t* rest = row + 64 * (size_t)blocks;
  const int r = msg_len & 63;
  const uint64_t bits = 8 * ((uint64_t)msg_len + 1);
  if (W == 1)
    sha256_tail(st, prev, r, bits, ByteTail{rest, r});
  else
    sha256_tail(st, prev, r, bits, WordTail{(const uint32_t*)rest, r / 4});
  sha256_store(st, out + 32 * (size_t)i);
}

// The route of a launch (ops/sha256._k4_route mirrors it).
static int k4_route(int msg_len, const uint8_t* msgs) {
  const uintptr_t a = (uintptr_t)msgs;
  if (msg_len % 16 == 0 && a % 16 == 0)
    return msg_len >= K4_STAGE ? K4_STAGED : K4_DIRECT16;
  if (msg_len % 4 == 0 && a % 4 == 0) return K4_DIRECT4;
  return K4_DIRECT1;
}

extern "C" int tm_sha256_prefixed(const uint8_t* msgs, int msg_len,
                                  int prefix, uint8_t* out, int n,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  const int direct_grid = (n + K4_DIRECT_BLOCK - 1) / K4_DIRECT_BLOCK;
  switch (k4_route(msg_len, msgs)) {
    case K4_STAGED: {
      const cudaError_t e = cudaFuncSetAttribute(
          sha256_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          K4_STAGED_SMEM);
      if (e != cudaSuccess) return (int)e;
      sha256_staged_kernel<<<(n + 31) / 32, 64, K4_STAGED_SMEM, s>>>(
          msgs, msg_len, prefix, out, n);
      break;
    }
    case K4_DIRECT16:
      sha256_direct_kernel<16><<<direct_grid, K4_DIRECT_BLOCK, 0, s>>>(
          msgs, msg_len, prefix, out, n);
      break;
    case K4_DIRECT4:
      sha256_direct_kernel<4><<<direct_grid, K4_DIRECT_BLOCK, 0, s>>>(
          msgs, msg_len, prefix, out, n);
      break;
    default:
      sha256_direct_kernel<1><<<direct_grid, K4_DIRECT_BLOCK, 0, s>>>(
          msgs, msg_len, prefix, out, n);
  }
  return (int)cudaGetLastError();
}
