// tmhash: native host-side SHA-256 Merkle engine.
//
// Copy of native/tmhash.cpp for the port.  The framework's hashing hot
// plane runs on the card (kernels K4 and K7 behind
// tendermint_tpu_torch/ops/merkle.py); this library is the HOST runtime
// counterpart for CPU-only nodes and small batches where device
// dispatch would lose: batched leaf hashing and reference-shaped tree
// roots ((n+1)/2 split, 0x00/0x01 domain separation — must match
// tendermint_tpu_torch/types/merkle.py bit for bit), threaded across
// independent trees.  Bound into Python via ctypes
// (tendermint_tpu_torch/utils/nativelib.py); no pybind11 dependency.
//
// Reference analog: the pure-Go merkle/part hashing the sync loop pays
// per block (reference types/part_set.go:95-122, types/tx.go:29-43).

#include <cstdint>
#include <cstring>
#include <atomic>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t K[64] = {
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

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

struct Sha256 {
  uint32_t h[8];
  uint8_t buf[64];
  uint64_t total = 0;
  size_t fill = 0;

  Sha256() { reset(); }

  void reset() {
    static const uint32_t H0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                   0xa54ff53a, 0x510e527f, 0x9b05688c,
                                   0x1f83d9ab, 0x5be0cd19};
    std::memcpy(h, H0, sizeof(h));
    total = 0;
    fill = 0;
  }

  void compress(const uint8_t* p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + s1 + ch + K[i] + w[i];
      uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = s0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* p, size_t n) {
    total += n;
    if (fill) {
      size_t take = 64 - fill < n ? 64 - fill : n;
      std::memcpy(buf + fill, p, take);
      fill += take; p += take; n -= take;
      if (fill == 64) { compress(buf); fill = 0; }
    }
    while (n >= 64) { compress(p); p += 64; n -= 64; }
    if (n) { std::memcpy(buf, p, n); fill = n; }
  }

  void final(uint8_t out[32]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t z = 0;
    while (fill != 56) update(&z, 1);
    uint8_t len[8];
    for (int i = 0; i < 8; i++) len[i] = uint8_t(bits >> (56 - 8 * i));
    update(len, 8);
    for (int i = 0; i < 8; i++) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

void prefixed_hash(uint8_t prefix, const uint8_t* a, size_t alen,
                   const uint8_t* b, size_t blen, uint8_t out[32]) {
  Sha256 s;
  s.update(&prefix, 1);
  s.update(a, alen);
  if (b) s.update(b, blen);
  s.final(out);
}

// reference-shaped tree over precomputed leaf hashes [n][32] (scratch
// must hold n*32 bytes); writes the root to out.
void tree_root(uint8_t* hashes, size_t n, uint8_t* out) {
  if (n == 0) {  // empty tree: sha256("") — matches the host merkle.root
    Sha256 s;
    s.final(out);
    return;
  }
  // plain recursion on the (n+1)/2 split; depth <= log2(n) + 1
  struct Rec {
    uint8_t* hs;
    void run(size_t lo, size_t hi, uint8_t out[32]) {
      if (hi - lo == 1) {
        std::memcpy(out, hs + lo * 32, 32);
        return;
      }
      size_t k = (hi - lo + 1) / 2;
      uint8_t l[32], r[32];
      run(lo, lo + k, l);
      run(lo + k, hi, r);
      prefixed_hash(0x01, l, 32, r, 32, out);
    }
  } rec{hashes};
  rec.run(0, n, out);
}

void run_threaded(size_t jobs, unsigned threads,
                  const std::function<void(size_t)>& fn) {
  if (threads <= 1 || jobs <= 1) {
    for (size_t i = 0; i < jobs; i++) fn(i);
    return;
  }
  std::vector<std::thread> ts;
  std::atomic<size_t> next{0};
  for (unsigned t = 0; t < threads; t++)
    ts.emplace_back([&] {
      for (size_t i = next.fetch_add(1); i < jobs; i = next.fetch_add(1))
        fn(i);
    });
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// n equal-length messages, 0x00 leaf prefix -> [n][32] digests
void tm_leaf_hashes(const uint8_t* in, uint64_t n, uint64_t len,
                    uint8_t* out, uint32_t threads) {
  run_threaded(n == 0 ? 0 : 1 + (n - 1) / 1024, threads, [&](size_t chunk) {
    size_t lo = chunk * 1024, hi = lo + 1024 < n ? lo + 1024 : n;
    for (size_t i = lo; i < hi; i++)
      prefixed_hash(0x00, in + i * len, len, nullptr, 0, out + i * 32);
  });
}

// t trees x n equal-length leaves each -> [t][32] roots
void tm_merkle_roots(const uint8_t* leaves, uint64_t t, uint64_t n,
                     uint64_t leaf_len, uint8_t* roots, uint32_t threads) {
  run_threaded(t, threads, [&](size_t ti) {
    std::vector<uint8_t> hs(n * 32);
    const uint8_t* base = leaves + ti * n * leaf_len;
    for (size_t i = 0; i < n; i++)
      prefixed_hash(0x00, base + i * leaf_len, leaf_len, nullptr, 0,
                    hs.data() + i * 32);
    tree_root(hs.data(), n, roots + ti * 32);
  });
}
}
