// SHA-256 for the port's CUDA kernels (replaces tendermint_tpu/ops/sha256.py).
// Every message is prefix_byte || msg[0:n]: the Merkle leaf (0x00 || leaf)
// and inner-node (0x01 || l || r) hashes.  Two ways to read it:
//  - sha256_prefixed_words (K7's leaves): byte by byte, padded on the fly;
//  - sha256_word, sha256_block_words and sha256_tail_words (K4): whole
//    little-endian message words.  The prefix shifts the stream by one
//    byte, so word i of block b is msg[64b + 4i - 1 .. 64b + 4i + 2]: one
//    __byte_perm of the two neighbouring little-endian words
//    msg[64b + 4i - 4 ..] ("prev") and msg[64b + 4i ..] ("cur"), prev's
//    byte 3 first.  Before block 0, prev is prefix << 24.  The n / 64 whole
//    message blocks carry no padding; the rest of the stream, prev's byte
//    3, the last n % 64 message bytes, 0x80, zeros and the 64-bit bit
//    length, is one block, or two when n % 64 > 54.
#pragma once
#include <stdint.h>

static __constant__ uint32_t SHA256_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static __device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static __device__ __forceinline__ void sha256_compress(uint32_t st[8],
                                                       uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; t++) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
      uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + SHA256_K[t] + wt;
    uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

static __device__ __forceinline__ void sha256_init(uint32_t st[8]) {
  const uint32_t h0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                          0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
#pragma unroll
  for (int i = 0; i < 8; i++) st[i] = h0[i];
}

// SHA-256 of prefix || msg[0:n] -> the digest as eight big-endian words
static __device__ void sha256_prefixed_words(uint32_t prefix,
                                             const uint8_t* msg, int n,
                                             uint32_t st[8]) {
  sha256_init(st);
  const int total = n + 1;
  const int nblocks = (total + 9 + 63) / 64;
  const int lenpos = nblocks * 64 - 8;
  const uint64_t bits = (uint64_t)total * 8;
  for (int blk = 0; blk < nblocks; blk++) {
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; i++) {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; k++) {
        int pos = blk * 64 + i * 4 + k;
        uint32_t byte;
        if (pos == 0) byte = prefix;
        else if (pos < total) byte = msg[pos - 1];
        else if (pos == total) byte = 0x80;
        else if (pos >= lenpos) byte = (uint32_t)(bits >> (8 * (7 - (pos - lenpos)))) & 0xff;
        else byte = 0;
        v = (v << 8) | byte;
      }
      w[i] = v;
    }
    sha256_compress(st, w);
  }
}

// The big-endian stream word whose first byte is prev's byte 3 and whose
// other three are cur's bytes 0..2 (prev, cur: neighbouring little-endian
// message words).
static __device__ __forceinline__ uint32_t sha256_word(uint32_t prev,
                                                       uint32_t cur) {
  return __byte_perm(prev, cur, 0x3456);
}

// The 16 big-endian words w of one whole block of the prefixed stream from
// the 16 little-endian message words lw (msg[64b .. 64b + 63]) and prev,
// the word before them (prefix << 24 for block 0); prev <- lw[15].
static __device__ __forceinline__ void sha256_block_words(
    const uint32_t lw[16], uint32_t& prev, uint32_t w[16]) {
#pragma unroll
  for (int i = 0; i < 16; i++) {
    w[i] = sha256_word(prev, lw[i]);
    prev = lw[i];
  }
}

// The last one or two blocks of the stream after its whole blocks: prev's
// byte 3 (the message's byte 64 * (n / 64) - 1, or the prefix), the r = n %
// 64 message bytes after it, 0x80, zeros, and bits = 8 * (1 + n) as the last
// 8 bytes, each block's 16 big-endian words handed to sink(w).  fetch(j), j
// = 0..31, is the little-endian word of bytes 4j .. 4j + 3 of R' = those r
// bytes, 0x80, zeros: the caller reads no byte past the message.  The 1 + r
// + 1 bytes before the zeros fit one block's first 56 when r <= 54, else
// two blocks, and the length is OR-ed onto zeros.
static __device__ __forceinline__ int sha256_tail_blocks(int r) {
  return r > 54 ? 2 : 1;
}

template <class Fetch, class Sink>
static __device__ __forceinline__ void sha256_tail_words(uint32_t prev,
                                                         int r, uint64_t bits,
                                                         Fetch fetch,
                                                         Sink sink) {
  const int blocks = sha256_tail_blocks(r);
  for (int t = 0; t < blocks; t++) {
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; i++) {
      uint32_t cur = fetch(16 * t + i);
      w[i] = sha256_word(prev, cur);
      prev = cur;
    }
    if (t == blocks - 1) {
      w[14] |= (uint32_t)(bits >> 32);
      w[15] |= (uint32_t)bits;
    }
    sink(w);
  }
}

// sha256_tail_words, each block compressed into st.
template <class Fetch>
static __device__ __forceinline__ void sha256_tail(uint32_t st[8],
                                                   uint32_t prev, int r,
                                                   uint64_t bits,
                                                   Fetch fetch) {
  sha256_tail_words(prev, r, bits, fetch,
                    [&](uint32_t w[16]) { sha256_compress(st, w); });
}

// The digest's eight big-endian words as 32 bytes: two 16-byte stores where
// out is 16-byte aligned, else byte stores.
static __device__ __forceinline__ void sha256_store(const uint32_t st[8],
                                                    uint8_t* out) {
  if (((uintptr_t)out & 15) == 0) {
    uint4* o = (uint4*)out;
    o[0] = make_uint4(__byte_perm(st[0], 0, 0x0123),
                      __byte_perm(st[1], 0, 0x0123),
                      __byte_perm(st[2], 0, 0x0123),
                      __byte_perm(st[3], 0, 0x0123));
    o[1] = make_uint4(__byte_perm(st[4], 0, 0x0123),
                      __byte_perm(st[5], 0, 0x0123),
                      __byte_perm(st[6], 0, 0x0123),
                      __byte_perm(st[7], 0, 0x0123));
  } else {
    for (int i = 0; i < 8; i++)
      for (int k = 0; k < 4; k++)
        out[4 * i + k] = (uint8_t)(st[i] >> (24 - 8 * k));
  }
}
