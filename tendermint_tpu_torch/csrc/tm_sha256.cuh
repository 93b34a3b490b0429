// SHA-256 for the port's CUDA kernels (replaces tendermint_tpu/ops/sha256.py).
// The message is prefix_byte || msg[0:n], read byte by byte and padded on
// the fly: the Merkle leaf (0x00 || leaf) and inner-node (0x01 || l || r)
// hashes.
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

// SHA-256 of prefix || msg[0:n] -> 32 digest bytes
static __device__ void sha256_prefixed(uint32_t prefix, const uint8_t* msg,
                                       int n, uint8_t out[32]) {
  uint32_t st[8];
  sha256_prefixed_words(prefix, msg, n, st);
  for (int i = 0; i < 8; i++) {
    for (int k = 0; k < 4; k++) out[4 * i + k] = (uint8_t)(st[i] >> (24 - 8 * k));
  }
}
