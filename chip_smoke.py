#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`tendermint_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any mismatch or exception exits non-zero:

1. build the seven CUDA kernels from `tendermint_tpu_torch/csrc` with
   nvcc (sm_90a) and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card on small
   edge-case inputs, bytes and bools exactly equal (K4 also against
   hashlib on every row, on both of its routes: rows of 55 to 65,536
   bytes at 1, 31, 33 and 2,049 rows, and batches on a base that is not
   16-byte aligned, each batch's route logged; K2 at 1, 4, 100 and 128
   keys, an undecodable key among them;
   K3 at 1, 31, 33, 129, 256 and 65,500 lanes with lanes of no key or no
   template mixed into the warps, every lane, sampled lanes also against
   the golden RFC 8032 signer; K1 on adversarial lanes, on a vote burst
   with per-lane keys, and on both routes at 1, 31, 33, 128, 129 and
   65,536 lanes with forged lanes and indices out of range mixed in; K7
   on [2, 3, n, L] batches at 10 tree sizes (one past the shared-memory
   limit) and 6 leaf lengths, and on given leaf hashes; K5 on edge lanes
   at 32- and 96-byte messages against the golden verifier at 1, 3, 7,
   9, 12, 33 and 200 lanes (not multiples
   of its 4-thread quads or 32-lane blocks); K6 on edge lanes with mixed
   powers at 4,096 lanes in one row and 40 rows of 100);
3. the main paths, each with every launch count set to 0 just before it
   and read just after it:
   a. replay a fast-sync chain at BASELINE config 3's shape (100
      validators, 625-block windows, ~12 KB blocks) through `CudaBackend`
      (fixture signing, comb tables, one verify per window), checking the
      final app hash against a host kvstore run; then BASELINE config
      2's Merkle cell: one `roots` call (K7) over 2,048 trees x 1,024
      leaves x 64 B and the part sets of those 2,048 blocks (K4);
   b. mempool admission: a seeded ~12.4k-submission corpus through
      `Mempool.check_tx` from 1,024 threads, signature lanes coalesced by
      the batch plane onto K5 (with the validators' prevotes riding the
      consensus class on K1), and one block per 2,048-entry round applied
      with the real mempool;
   c. the multi-device crypto plane (`parallel/sharding.py`) on two
      meshes, `make_mesh()` (every visible card) and four virtual shards
      of card 0 (and card 0 alone when more than one card is visible):
      `sharded_verify_fn` over a 100,000-signature vote-set batch with
      int64 powers (K6 per shard), `sharded_merkle_fn` over the Merkle
      call's trees (K7), `training_step_fn` over 1,000 blocks x 100
      validators with 1,024 leaves per block (K6 and K7), the replay's
      chain again through `CudaBackend(mesh=...)` (templated K1 per
      shard) and one of its windows through that backend's
      `verify_grouped` with the messages assembled on the host (K1 with
      per-lane keys and messages per shard);
   d. BASELINE config 3 at its full 100,000 blocks x 100 validators
      (fixture signed by K3): `replay_pipelined` with a `BlockStore` on
      `MemDB`, then two pairs of `replay_pipelined` without a store and
      the serial `replay` (the second pair on the first 50,000 blocks),
      each on a fresh state and under `torch.profiler`'s CUDA
      activity (blocks/s, sigs/s, stage times, each stage's busy seconds,
      K1 launches, device-idle share);
   e. BASELINE config 4 at its full 8 chains x 131,072 header+commit
      pairs x 8 validators (signed by K3): `verify_chains_batched`
      through a `BatchPlane(CudaBackend())` twice (the first pass builds
      the tables), one K1 call of 1,048,576 lanes per chain, then a
      `LightClient` following a short chain through a change of
      validator set;
   f. the consensus core: 100 in-process validators of equal power
      (kvstore, `MemDB` stores, the JAX package's 100-validator live-rig
      timeouts) wired broadcast-to-feed, sharing one `BatchPlane` over a
      `CudaBackend` that records every K1 call: each vote burst
      pre-verified on K1 with per-lane keys at the plane's consensus
      class, each block's LastCommit on templated K1 at its fast-sync
      class, the set's comb tables (K2) and two grouped calls made before
      `start()` (the node's boot); every mempool fed the same 300 kvstore
      txs of 64 bytes; run until every node has committed 5 heights, a
      forged vote (one flipped signature bit) put into every queue during
      a burst; then BASELINE config 1's 4-validator testnet with WALs and
      `SQLiteDB` stores runs 3 heights, stops, restarts through the
      `Handshaker` and its WALs (each seen commit re-verified on K1) and
      commits 2 more, and `Playback` replays node 0's WAL;
4. check that a tampered signature is rejected at the right height and
   lane, sample the roots and part sets against the host's, count the
   host-to-device copies of a `roots` call (one at a new n, none after)
   and time `roots`, run the part-set call again under `torch.profiler`
   and log each of its spans (chunking, join, the device batch, trees)
   and the device time of its copies and of K4, check the mempool's
   accounting, commits, app hash and verdicts (every signed entry
   re-verified by the plain version), and hold each mesh's results
   against K5's mask, numpy int64 tallies and quorums, the single-device
   roots and the single-device replay's masks and app hash; hold the
   three fast-sync runs' app hashes to a host kvstore run and their
   per-block tallies to each other, sampled stored blocks and seen
   commits to the fixture, the asynchronous K1 mask to the synchronous
   route's on every lane of a window (forged lanes mixed in) and to the
   plain version on a sample, and time both routes' whole calls; blame a
   tampered lane on the same height and lane through the pipeline and
   the serial loop; stop a pipelined run on `SQLiteDB` mid-window,
   reopen, handshake a fresh app and resume to the host's app hash;
   blame a tampered lane of the light grid on its height and lane, and
   hold the light follower's verdicts (a tampered header too) to the
   golden verifier's; hold every node of the consensus net to one block
   hash per height and to a host kvstore run's app hash, require a
   consensus-class flush, hold every K1 call of the consensus phase to
   the plain version on every lane, require the forged vote on K1 on at
   least one lane, False on each, and counted by no node; the restarted
   testnet's seen commits verified on K1, its pre-stop prefix unchanged
   and its app hashes the host's, and `Playback`'s blocks and app hash
   node 0's; log heights per second, commit latency, rounds, the share
   of received votes pre-verified on K1, scalar verifies, K1 launches
   and lanes, the flush sizes, the thread CPU of scalar verifies,
   signing and vote accounting, the process CPU and wall over the net's
   run, and the device time of the net's K1 calls (each re-run alone on
   CUDA events);
5. one `kernels` JSON line: per kernel its launches on the main paths
   at the shape its entry is timed at, its time and its plain version's
   at the main path's shapes, the two results held exactly equal there
   (K1 also at the light grid's 1,048,576 lanes, its plain version in
   65,536-lane slices, and at the consensus net's median vote burst and
   median LastCommit, rows 1C and 6C, each with the net's launches at
   that call's shape), and its bound (K5 timed at 32, 64, 1,024, 4,096 and 65,536 lanes, its
   entry at the mempool's 64; K4 at the part sets, with its chain bound
   `chain_bound_ms` beside the operations bound, and beside it at the
   trees' leaves, each shape's route logged); per mesh, the whole call of
   each mesh function likewise.  Logged beside it: a clock64
   microkernel's cycles per dependent field product, quad doubling,
   mod-L reduction, SHA-512 compression and field inversion in one warp,
   built with K3's, K5's and K6's settings, and per dependent SHA-256
   compression and step of the staged route's round warp (its chain
   bound's step) with K4's, with the SM clock over that chain.

The last line printed is {"ok": true, "device": {...}}.  With no CUDA
device, or outside the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

# H100 SXM peaks for the bounds in the kernels line: HBM bandwidth from
# NVIDIA's data sheet; 32-bit integer operations (multiply-add, add, logic,
# shift) at 64 per clock per SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0) x 132 SMs x 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

SEED = 20261017


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clocks() -> str:
    """The card's current and highest SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> tuple:
    """(mean milliseconds of `fn()` on the card over `reps` runs after one
    warm-up run, from CUDA events; the last run's result).  reps = 0: one
    timed run, no warm-up."""
    import torch
    if reps == 0:
        reps = 1
    else:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over two integer (or bool) tensors."""
    return int((got.long() - want.long()).abs().max().item()) \
        if got.numel() else 0


# -- build ---------------------------------------------------------------

def phase_build() -> None:
    from tendermint_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    so, report = kernels.build()
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f} s -> "
        f"{so.name}")
    for line in report.splitlines():
        if (line.startswith("==") or "registers" in line
                or "spill" in line or "Compiling entry" in line):
            log(f"[build] {line.strip()}")


# A diagnostic microkernel: one warp runs a chain of dependent field
# products (where the kernel has field code), of quad doublings (where it
# has the quad lane body), of mod-L reductions of a 64-byte digest, of
# SHA-512 compressions and of field inversions, each timed with clock64()
# on the card.  It is compiled in one translation unit with a kernel's
# source, so every step is built with that kernel's settings (inline or
# out of line, and its launch bounds' register cap).
MICRO_CU = r"""
#include "%(kernel)s.cu"
#ifdef FE_BITS
#include "tm_scalar.cuh"
#include "tm_sha512.cuh"
#if defined(RAW_BLOCK) && defined(RAW_MIN_BLOCKS)
#define MICRO_BOUNDS __launch_bounds__(RAW_BLOCK, RAW_MIN_BLOCKS)
#else
#define MICRO_BOUNDS
#endif
__global__ void MICRO_BOUNDS fe_mul_chain(const int32_t* in, int32_t* out,
                                          long long* cycles, int n) {
  int t = threadIdx.x;
  fe f, g;
  for (int i = 0; i < 10; i++) {
    f.v[i] = in[20 * t + i];
    g.v[i] = in[20 * t + 10 + i];
  }
  __syncwarp();
  long long t0 = clock64();
  for (int j = 0; j < n; j++) f = fe_mul(f, g);
  long long t1 = clock64();
  for (int i = 0; i < 10; i++) out[10 * t + i] = f.v[i];
  if (t == 0) cycles[0] = t1 - t0;
}
#ifdef RAW_QUAD
__global__ void MICRO_BOUNDS quad_dbl_chain(const int32_t* in, int32_t* out,
                                            long long* cycles, int n) {
  int t = threadIdx.x;
  quad_ctx c;
  c.q = t & 3;
  c.mask = 0xfu << (t & 28);
  fe p;
  for (int i = 0; i < 10; i++) p.v[i] = in[20 * t + i];
  __syncwarp();
  long long t0 = clock64();
  for (int j = 0; j < n; j++) p = quad_dbl(c, p);
  long long t1 = clock64();
  for (int i = 0; i < 10; i++) out[10 * t + i] = p.v[i];
  if (t == 0) cycles[1] = t1 - t0;
}
#endif
// x <- (x mod L) + hi * 2^256: each reduction reads the one before it
__global__ void MICRO_BOUNDS sc_reduce_chain(const uint8_t* inb, int32_t* out,
                                             long long* cycles, int n) {
  int t = threadIdx.x;
  uint8_t h[64], r[32];
  for (int i = 0; i < 64; i++) h[i] = inb[256 * t + i];
  __syncwarp();
  long long t0 = clock64();
  for (int j = 0; j < n; j++) {
    sc_reduce512(h, r);
    for (int i = 0; i < 32; i++) h[i] = r[i];
  }
  long long t1 = clock64();
  for (int i = 0; i < 8; i++)
    out[8 * t + i] = (int32_t)((uint32_t)r[4 * i] | (uint32_t)r[4 * i + 1] << 8 |
                               (uint32_t)r[4 * i + 2] << 16 |
                               (uint32_t)r[4 * i + 3] << 24);
  if (t == 0) cycles[2] = t1 - t0;
}
static __device__ uint64_t micro_u64(const uint8_t* b) {
  uint64_t v = 0;
  for (int k = 7; k >= 0; k--) v = (v << 8) | b[k];
  return v;
}
// state <- compress(state, block), the same block every time
__global__ void MICRO_BOUNDS sha512_chain(const uint8_t* inb, int32_t* out,
                                          long long* cycles, int n) {
  int t = threadIdx.x;
  uint64_t st[8], w[16];
  for (int i = 0; i < 8; i++) st[i] = micro_u64(inb + 256 * t + 64 + 8 * i);
  for (int i = 0; i < 16; i++) w[i] = micro_u64(inb + 256 * t + 128 + 8 * i);
  __syncwarp();
  long long t0 = clock64();
  for (int j = 0; j < n; j++) {
    uint64_t x[16];
    for (int i = 0; i < 16; i++) x[i] = w[i];
    sha512_compress(st, x);
  }
  long long t1 = clock64();
  for (int i = 0; i < 8; i++) {
    out[16 * t + 2 * i] = (int32_t)(uint32_t)st[i];
    out[16 * t + 2 * i + 1] = (int32_t)(uint32_t)(st[i] >> 32);
  }
  if (t == 0) cycles[3] = t1 - t0;
}
__global__ void MICRO_BOUNDS fe_invert_chain(const int32_t* in, int32_t* out,
                                             long long* cycles, int n) {
  int t = threadIdx.x;
  fe f;
  for (int i = 0; i < 10; i++) f.v[i] = in[20 * t + i];
  __syncwarp();
  long long t0 = clock64();
  for (int j = 0; j < n; j++) f = fe_invert(f);
  long long t1 = clock64();
  for (int i = 0; i < 10; i++) out[10 * t + i] = f.v[i];
  if (t == 0) cycles[4] = t1 - t0;
}
extern "C" int tm_micro(const int32_t* in, const uint8_t* inb, int32_t* out,
                        long long* cycles, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  fe_mul_chain<<<1, 32, 0, s>>>(in, out, cycles, n);
#ifdef RAW_QUAD
  quad_dbl_chain<<<1, 32, 0, s>>>(in, out + 320, cycles, n);
#endif
  sc_reduce_chain<<<1, 32, 0, s>>>(inb, out + 640, cycles, n / 8);
  sha512_chain<<<1, 32, 0, s>>>(inb, out + 896, cycles, n / 8);
  fe_invert_chain<<<1, 32, 0, s>>>(in, out + 1408, cycles, n / 64);
  return (int)cudaGetLastError();
}
#else
extern "C" int tm_micro(const int32_t*, const uint8_t*, int32_t*, long long*,
                        int, void*) {
  return 0;
}
#endif
#ifdef MICRO_SHA256
static __device__ __forceinline__ long long globaltimer_ns() {
  long long ns;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(ns));
  return ns;
}
// state <- compress(state, w + state), so each block's message depends on
// the state before it (nothing hoists out of the loop), with one add per
// word where the kernels have one byte permute; cycles[1] is the chain's
// nanoseconds on the global timer, for the SM clock
__global__ void sha256_chain(const uint8_t* inb, int32_t* out,
                             long long* cycles, int n) {
  int t = threadIdx.x;
  const uint32_t* in = (const uint32_t*)(inb + 256 * t);
  uint32_t st[8], w[16];
  for (int i = 0; i < 8; i++) st[i] = in[i];
  for (int i = 0; i < 16; i++) w[i] = in[8 + i];
  __syncwarp();
  long long g0 = globaltimer_ns(), t0 = clock64();
  for (int j = 0; j < n; j++) {
    uint32_t x[16];
    for (int i = 0; i < 16; i++) x[i] = w[i] + st[i & 7];
    sha256_compress(st, x);
  }
  long long t1 = clock64(), g1 = globaltimer_ns();
  for (int i = 0; i < 8; i++) out[8 * t + i] = (int32_t)st[i];
  if (t == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = g1 - g0;
  }
}
extern "C" int tm_micro_sha256(const uint8_t* inb, int32_t* out,
                               long long* cycles, int n, void* stream) {
  sha256_chain<<<1, 32, 0, (cudaStream_t)stream>>>(inb, out, cycles, n);
  return (int)cudaGetLastError();
}
#ifdef K4_DEPTH
// K4's staged route: its round warp's dependent step alone, state <-
// rounds_kw(state, scheduled slot j %% K4_DEPTH), the 64 rounds from W[t] +
// K[t] words in the scheduled ring's layout (each lane's 256 bytes of inb
// in every slot) and the state add, with no schedule and no barrier
__global__ void sha256_rounds_chain(const uint8_t* inb, int32_t* out,
                                    long long* cycles, int n) {
  __shared__ uint4 wring[K4_DEPTH * K4_WSLOT];
  int t = threadIdx.x;
  const uint4* in = (const uint4*)(inb + 256 * t);
  for (int s = 0; s < K4_DEPTH; s++)
    for (int q = 0; q < 16; q++) wring[s * K4_WSLOT + q * 32 + t] = in[q];
  uint32_t st[8];
  for (int i = 0; i < 8; i++) st[i] = ((const uint32_t*)in)[i];
  __syncwarp();
  long long t0 = clock64();
  for (int j = 0; j < n; j++)
    rounds_kw(st, wring + (j %% K4_DEPTH) * K4_WSLOT + t);
  long long t1 = clock64();
  for (int i = 0; i < 8; i++) out[8 * t + i] = (int32_t)st[i];
  if (t == 0) cycles[0] = t1 - t0;
}
extern "C" int tm_micro_sha256_rounds(const uint8_t* inb, int32_t* out,
                                      long long* cycles, int n,
                                      void* stream) {
  sha256_rounds_chain<<<1, 32, 0, (cudaStream_t)stream>>>(inb, out, cycles,
                                                          n);
  return (int)cudaGetLastError();
}
#endif
#endif
"""
FE_OFFSETS = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230)
FE_P = 2**255 - 19
SC_L = 2**252 + 27742317777372353535851937790883648493
M32 = (1 << 32) - 1
M64 = (1 << 64) - 1


def _fe_value(limbs) -> int:
    return sum(int(v) << s for v, s in zip(limbs, FE_OFFSETS)) % FE_P


def _dbl_hwcd(x, y, z):
    """dbl-2008-hwcd on integers mod p (T is not read)."""
    a, b, zz = x * x, y * y, z * z
    e, g = (x + y) ** 2 - a - b, b - a
    f, h = g - 2 * zz, -(a + b)
    return tuple(v % FE_P for v in (e * f, g * h, f * g, e * h))


def _sha512_k() -> list:
    """SHA-512's round constants: the first 64 bits of the fractional
    parts of the cube roots of the first 80 primes (FIPS 180-4 4.2.3)."""
    primes, c = [], 2
    while len(primes) < 80:
        if all(c % p for p in primes):
            primes.append(c)
        c += 1
    out = []
    for p in primes:
        x = p << 192                        # cbrt(x) = cbrt(p) * 2^64
        r = 1 << (x.bit_length() // 3 + 1)
        while True:
            y = (2 * r + x // (r * r)) // 3
            if y >= r:
                break
            r = y
        while r ** 3 > x:
            r -= 1
        out.append(r & M64)
    return out


def _sha512_compress(st: list, w: list, k: list) -> list:
    """One SHA-512 compression of the 16 words w into the state st."""
    def rotr(x, n):
        return ((x >> n) | (x << (64 - n))) & M64
    w = list(w)
    for t in range(16, 80):
        s0 = rotr(w[t - 15], 1) ^ rotr(w[t - 15], 8) ^ (w[t - 15] >> 7)
        s1 = rotr(w[t - 2], 19) ^ rotr(w[t - 2], 61) ^ (w[t - 2] >> 6)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M64)
    a, b, c, d, e, f, g, h = st
    for t in range(80):
        s1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41)
        t1 = (h + s1 + ((e & f) ^ (~e & g)) + k[t] + w[t]) & M64
        s0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39)
        t2 = (s0 + ((a & b) ^ (a & c) ^ (b & c))) & M64
        a, b, c, d, e, f, g, h = (t1 + t2) & M64, a, b, c, (d + t1) & M64, \
            e, f, g
    return [(x + y) & M64 for x, y in zip(st, (a, b, c, d, e, f, g, h))]


# dependent compressions of one 64 KB part, prefix byte and padding included
SHA256_PART_BLOCKS = (64 * 1024 + 1 + 9 + 63) // 64


def _sha256_rounds(st: list, kw: list) -> list:
    """The 64 SHA-256 rounds from W[t] + K[t] and the state add, on
    Python integers (K4's `rounds_kw`)."""
    r = lambda x, n: (x >> n | x << (32 - n)) & M32  # noqa: E731
    a, b, c, d, e, f, g, h = st
    for k in kw:
        t1 = h + (r(e, 6) ^ r(e, 11) ^ r(e, 25)) + (e & f ^ ~e & g) + k
        t2 = (r(a, 2) ^ r(a, 13) ^ r(a, 22)) + (a & b ^ a & c ^ b & c)
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & M32, c, b, a,
                                  (t1 + t2) & M32)
    return [(x + y) & M32 for x, y in zip(st, (a, b, c, d, e, f, g, h))]


def fe_mul_cycles(csrc, kernel: str, flags=(), n: int = 256) -> dict:
    """Build the microkernel with `kernel`'s source (`csrc/<kernel>.cu`)
    and extra nvcc `flags`, run it on card 0 and return the cycles of one
    step of each chain in one warp: a dependent `fe_mul` and `quad_dbl`
    (n steps), `sc_reduce512` and SHA-512 compression (n / 8) and
    `fe_invert` (n / 64); None without field code or, for `quad_dbl`,
    without the quad body.  Where the source includes `tm_sha256.cuh`,
    also a SHA-256 compression (a 64 KB part's SHA256_PART_BLOCKS steps)
    and the SM clock in MHz over that chain (its clock64 cycles over its
    %globaltimer nanoseconds, both read in the kernel, so the launch's
    latency is not in it); where it has K4's staged route, also the step
    of its round warp, the 64 rounds from scheduled words
    (`sha256_rounds_cycles`, as many steps).  Each chain's result is
    checked against Python integers."""
    import ctypes
    import tempfile
    from pathlib import Path
    import numpy as np
    import torch
    from tendermint_tpu_torch.ops import kernels
    from tendermint_tpu_torch.ops.sha256 import _compress as sha256_compress
    csrc = Path(csrc).resolve()
    has_sha256 = '"tm_sha256.cuh"' in (csrc / f"{kernel}.cu").read_text()
    flags = [*flags, "-DMICRO_SHA256"] if has_sha256 else list(flags)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="micro-", dir=kernels.BUILD_DIR))
    (work / "micro.cu").write_text(MICRO_CU % {"kernel": kernel})
    so = work / "micro.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-I", str(csrc),
           "-shared", "-o", str(so), str(work / "micro.cu")]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"microkernel build failed:\n{out.stdout}"
                           f"{out.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.tm_micro.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                     ctypes.c_void_p]
    rng = np.random.default_rng(SEED)
    limbs = rng.integers(0, 1 << 25, (32, 20), dtype=np.int64)
    raw = rng.integers(0, 256, (32, 256), dtype=np.uint8)
    dev = torch.device("cuda", 0)
    inp = torch.as_tensor(limbs.astype(np.int32), device=dev)
    inb = torch.as_tensor(raw, device=dev)
    res = torch.zeros(1728, dtype=torch.int32, device=dev)
    cyc = torch.full((5,), -1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for _ in range(2):                      # the second run is timed
        rc = lib.tm_micro(inp.data_ptr(), inb.data_ptr(), res.data_ptr(),
                          cyc.data_ptr(), n, ctypes.c_void_p(stream))
        require(rc == 0, f"microkernel launch failed, error {rc}")
        torch.cuda.synchronize()
    got, cycles = res.cpu().numpy(), cyc.cpu().tolist()
    keys = ("fe_mul_cycles", "quad_dbl_cycles", "sc_reduce512_cycles",
            "sha512_block_cycles", "fe_invert_cycles")
    result = dict.fromkeys(keys + ("sha256_block_cycles", "sm_clock_mhz",
                                   "sha256_rounds_cycles"))
    if has_sha256:
        lib.tm_micro_sha256.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_void_p]
        steps = SHA256_PART_BLOCKS
        sres = torch.zeros(256, dtype=torch.int32, device=dev)
        for _ in range(2):                  # the second run is timed
            rc = lib.tm_micro_sha256(inb.data_ptr(), sres.data_ptr(),
                                     cyc.data_ptr(), steps,
                                     ctypes.c_void_p(stream))
            require(rc == 0, f"SHA-256 microkernel launch failed, error {rc}")
            torch.cuda.synchronize()
        sha_cycles, sha_ns = cyc[:2].tolist()
        words = raw.view("<u4").astype(np.int64)
        sgot = sres.cpu().numpy().astype(np.uint32).reshape(32, 8)
        for t in (0, 13, 31):
            st = words[t, :8].tolist()
            for _ in range(steps):
                st = sha256_compress(st, [(int(w) + st[i & 7]) & 0xFFFFFFFF
                                          for i, w in
                                          enumerate(words[t, 8:24])])
            require(sgot[t].tolist() == st,
                    f"microkernel SHA-256 chain wrong on thread {t}")
        result["sha256_block_cycles"] = sha_cycles / steps
        result["sm_clock_mhz"] = sha_cycles / sha_ns * 1e3
    if has_sha256 and hasattr(lib, "tm_micro_sha256_rounds"):
        lib.tm_micro_sha256_rounds.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_void_p]
        for _ in range(2):                  # the second run is timed
            rc = lib.tm_micro_sha256_rounds(
                inb.data_ptr(), sres.data_ptr(), cyc.data_ptr(), steps,
                ctypes.c_void_p(stream))
            require(rc == 0, f"SHA-256 rounds microkernel launch failed, "
                    f"error {rc}")
            torch.cuda.synchronize()
        sgot = sres.cpu().numpy().astype(np.uint32).reshape(32, 8)
        for t in (0, 13, 31):
            st = words[t, :8].tolist()
            for _ in range(steps):
                st = _sha256_rounds(st, words[t].tolist())
            require(sgot[t].tolist() == st,
                    f"microkernel SHA-256 rounds chain wrong on thread {t}")
        result["sha256_rounds_cycles"] = cyc[0].item() / steps
    if cycles[0] < 0:
        return result
    mul = got[:320].reshape(32, 10)
    for t in range(32):
        f, g = _fe_value(limbs[t, :10]), _fe_value(limbs[t, 10:])
        require(_fe_value(mul[t]) == f * pow(g, n, FE_P) % FE_P,
                f"microkernel fe_mul chain wrong on thread {t}")
    if cycles[1] >= 0:
        quad = got[320:640].reshape(32, 10)
        for b in range(0, 32, 4):
            pt = [_fe_value(limbs[b + q, :10]) for q in range(3)]
            for _ in range(n):
                pt = _dbl_hwcd(*pt[:3])
            require([_fe_value(quad[b + q]) for q in range(4)]
                    == list(pt), f"microkernel quad_dbl chain wrong at "
                    f"quad {b // 4}")
    k = _sha512_k()
    sc_out = got[640:896].reshape(32, 8).astype(np.uint32)
    sha_out = got[896:1408].reshape(32, 16).astype(np.uint32)
    inv = got[1408:1728].reshape(32, 10)
    for t in range(32):
        x = int.from_bytes(raw[t, :64].tobytes(), "little")
        r = x % SC_L
        for _ in range(n // 8 - 1):
            r = (r + (x >> 256 << 256)) % SC_L
        require(int.from_bytes(sc_out[t].tobytes(), "little") == r,
                f"microkernel sc_reduce512 chain wrong on thread {t}")
        words = np.frombuffer(raw[t, 64:].tobytes(), "<u8").tolist()
        st = words[:8]
        for _ in range(n // 8):
            st = _sha512_compress(st, words[8:], k)
        require(np.frombuffer(sha_out[t].tobytes(), "<u8").tolist() == st,
                f"microkernel SHA-512 chain wrong on thread {t}")
        f = _fe_value(limbs[t, :10])
        require(_fe_value(inv[t]) == pow(f, pow(FE_P - 2, n // 64, FE_P - 1),
                                         FE_P),
                f"microkernel fe_invert chain wrong on thread {t}")
    steps = (n, n, n // 8, n // 8, n // 64)
    for key, c, m in zip(keys, cycles, steps):
        result[key] = c / m if c >= 0 else None
    return result


# -- kernels against their plain versions on edge cases ------------------

def _keys(n: int, invalid: int | None = None):
    """n deterministic keys (seed bytes [1, i+1] + 30 zeros); optionally one
    replaced by an undecodable encoding (y >= p)."""
    import numpy as np
    from tendermint_tpu_torch.crypto import pure_ed25519 as ref
    seeds = [bytes([1, i + 1]) + b"\0" * 30 for i in range(n)]
    a = np.zeros((n, 32), np.uint8)
    pre = np.zeros((n, 32), np.uint8)
    pubs = np.zeros((n, 32), np.uint8)
    for i, s in enumerate(seeds):
        ai, pi, pb = ref.expand_seed(s)
        a[i] = np.frombuffer(ai, np.uint8)
        pre[i] = np.frombuffer(pi, np.uint8)
        pubs[i] = np.frombuffer(pb, np.uint8)
    set_pubs = pubs.copy()
    if invalid is not None:
        set_pubs[invalid] = np.frombuffer(
            (2**255 - 19 + 5).to_bytes(32, "little"), np.uint8)
    return seeds, a, pre, pubs, set_pubs


# K4's check grid: row lengths at the padding edges (55, 56, 63, 64, 119,
# 120), across the staged route's stage edges (560: a 48-byte tail, 576: a
# one-block last stage) and at the parts' 64 KB, each at row counts that
# leave a warp part-filled
K4_CHECK_LENGTHS = (55, 56, 63, 64, 119, 120, 560, 576, 1000, 4095, 4096,
                    65535, 65536)
K4_CHECK_COUNTS = (1, 31, 33, 2049)
# (row length, byte offset of the base, rows): batches cut from a flat
# buffer at an offset that is not a multiple of 16, so they take the
# direct route
K4_CHECK_UNALIGNED = ((64, 3, 33), (4096, 4, 33), (65536, 3, 33))
# the plain version runs one compression of every row per step, ~45 s for
# 64 KB rows whatever their count, so it checks rows up to this length
# (the kernels line holds K4 against it at 2,048 x 64 KB)
K4_CHECK_PLAIN_MAX = 4096


def check_k4(rng, dev, lengths=K4_CHECK_LENGTHS, counts=K4_CHECK_COUNTS,
             unaligned=K4_CHECK_UNALIGNED,
             plain_max=K4_CHECK_PLAIN_MAX) -> None:
    """K4 against hashlib on every row, and the plain version against
    hashlib on every row of at most plain_max bytes: for each length and
    prefix 0x00 and 0x01, one batch per row count (each its own
    allocation) and the unaligned batches (the length's first rows, at an
    offset into a flat buffer).  Logs each batch's route."""
    import numpy as np
    import torch
    from tendermint_tpu_torch.ops import sha256 as s256
    routes = {}
    for width in lengths:
        host = rng.integers(0, 256, (sum(counts), width), dtype=np.uint8)
        batches, start = [], 0
        for n in counts:
            batches.append((f"{n}x{width}", torch.as_tensor(
                host[start:start + n], device=dev), start))
            start += n
        for ul, off, n in unaligned:
            if ul == width:
                flat = torch.zeros(n * width + 16, dtype=torch.uint8,
                                   device=dev)
                rows = flat[off:off + n * width].view(n, width)
                rows.copy_(torch.as_tensor(host[:n], device=dev))
                route = s256._k4_route(width, rows.data_ptr())
                require(route[0] == "direct",
                        f"unaligned K4 batch took {route}")
                batches.append((f"{n}x{width}@+{off}", rows, 0))
        for name, rows, _ in batches:
            routes.setdefault(s256._k4_route(width, rows.data_ptr()),
                              []).append(name)
        for prefix in (0, 1):
            want = torch.as_tensor(np.stack([np.frombuffer(hashlib.sha256(
                bytes([prefix]) + row.tobytes()).digest(), np.uint8)
                for row in host]), device=dev)
            if width <= plain_max:
                plain = s256.sha256_prefixed_plain(
                    torch.as_tensor(host, device=dev), prefix)
                require(torch.equal(plain, want),
                        f"plain != hashlib at {width} B, prefix {prefix}")
            for name, rows, first in batches:
                got = s256.sha256_prefixed(rows, prefix)
                bad = (got != want[first:first + rows.shape[0]]).any(1)
                bad = bad.nonzero().flatten().tolist()
                require(not bad, f"K4 != hashlib at {name}, prefix {prefix}, "
                        f"rows {bad[:4]} "
                        f"({s256._k4_route(width, rows.data_ptr())})")
    for route, shapes in sorted(routes.items()):
        log(f"[check] K4 route {route[0]} ({route[1]}-byte reads): "
            f"{', '.join(shapes)}")
    log(f"[check] K4 sha256_prefixed == hashlib on every row, prefixes 0 "
        f"and 1, at lengths {list(lengths)} x counts {list(counts)} and "
        f"unaligned batches {list(unaligned)}; == the plain version there "
        f"up to {plain_max} B")


def phase_check() -> None:
    import numpy as np
    import torch
    from tendermint_tpu_torch.crypto import pure_ed25519 as ref
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.types import canonical
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731

    check_k4(rng, dev)

    # K2 at V = 1, 4 (key 2 undecodable), 100 (key 50 undecodable) and
    # 128: ok masks equal, every valid key's table bytes equal
    for v, bad in K2_CHECK_SETS:
        _, _, _, _, set_v = _keys(v, invalid=bad)
        tbl_v, ok_v = ed.build_neg_comb(t(set_v))
        ptbl, pok = ed.build_neg_comb_plain(t(set_v))
        require(torch.equal(ok_v, pok) and ok_v.tolist() == [
            i != bad for i in range(v)], f"K2 ok mask at V = {v}")
        require(torch.equal(tbl_v[:, :, ok_v], ptbl[:, :, pok]),
                f"K2 table bytes at V = {v}")
        del tbl_v, ptbl
    log(f"[check] K2 build_neg_comb == plain (ok mask + valid-key bytes) at "
        f"(V, undecodable key) = {K2_CHECK_SETS}")
    seeds, a, pre, pubs, set_pubs = _keys(4, invalid=2)
    tbl, ok = ed.build_neg_comb(t(set_pubs))

    # K3 on ragged batches with lanes whose key or template index is out
    # of range mixed into the warps (zero signatures), and on 256 valid
    # lanes; sampled lanes also against the golden signer
    base = ed.base_table(dev)
    T = 8
    templates = rng.integers(0, 256, (T, 128), dtype=np.uint8)
    for n in K3_CHECK_LANES:
        vi = rng.integers(0, 4, n).astype(np.int32)
        ti = rng.integers(0, T, n).astype(np.int32)
        if n not in (1, 256):
            vi[rng.random(n) < 0.1] = 4
            vi[rng.random(n) < 0.05] = -1
            ti[rng.random(n) < 0.1] = T
            ti[rng.random(n) < 0.05] = -3
        valid = (vi >= 0) & (vi < 4) & (ti >= 0) & (ti < T)
        sigs = ed.sign_grouped_templated(t(a), t(pre), t(pubs), t(vi),
                                         t(ti), t(templates), base)
        psigs = ed.sign_grouped_templated_plain(
            t(a), t(pre), t(pubs), t(vi), t(ti), t(templates), base)
        require(torch.equal(sigs, psigs), f"K3 != plain at N = {n}")
        require(not bool(sigs[t(~valid)].any()), f"K3 signed a lane with "
                f"no key or message at N = {n}")
        host_sigs = sigs.cpu().numpy()
        for i in np.flatnonzero(valid)[::max(1, int(valid.sum()) // 8)][:8]:
            want = ref.sign(seeds[vi[i]], templates[ti[i]].tobytes())
            require(host_sigs[i].tobytes() == want,
                    f"K3 lane {i} of {n} != golden")
    log(f"[check] K3 sign_grouped_templated == plain on every lane == "
        f"pure_ed25519.sign (8 lanes each) at N = {K3_CHECK_LANES}, "
        f"out-of-range lanes zero")

    # K1 on adversarial lanes against the K2 tables (key 2 invalid)
    tm = templates.copy()
    tm[7] = tm[0]
    tm[7, 3] ^= 0x01                        # template 7: template 0, one bit
    lanes = []                              # (val, tmpl, sig bytes)
    for i in range(12):
        v, k = i % 4, i % 6
        lanes.append((v, k, ref.sign(seeds[v], tm[k].tobytes())))
    L = ref.L
    v0, k0, s0 = lanes[0]
    s_big = int.from_bytes(s0[32:], "little") + L
    lanes += [
        (v0, k0, s0[:32] + s_big.to_bytes(32, "little")),     # s >= L
        (v0, k0, (2**255 - 19).to_bytes(32, "little") + s0[32:]),  # R >= p
        (0, 7, ref.sign(seeds[0], tm[0].tobytes())),        # flipped msg bit
        (1, 0, ref.sign(seeds[3], tm[0].tobytes())),        # wrong key
        (v0, k0, (1).to_bytes(32, "little") + bytes(32)),   # R = identity
    ]
    nreal = len(lanes)
    lanes += [lanes[0]] * (32 - nreal)      # bucket padding repeats lane 0
    lv = np.asarray([x[0] for x in lanes], np.int32)
    lt = np.asarray([x[1] for x in lanes], np.int32)
    ls = np.frombuffer(b"".join(x[2] for x in lanes),
                       np.uint8).reshape(-1, 64).copy()
    args = (tbl, ok, t(pubs), t(lv), t(lt), t(tm), t(ls), base)
    got = ed.verify_grouped_templated(*args)
    want = ed.verify_grouped_templated_plain(*args)
    require(torch.equal(got, want), "K1 != plain")
    golden = [v != 2 and ref.verify(pubs[v].tobytes(), tm[k].tobytes(), s)
              for v, k, s in lanes]
    require(got.tolist() == golden, "K1 != golden")
    require(not any(got[12:nreal].tolist()), "K1 accepted an adversarial lane")
    log(f"[check] K1 verify_grouped_templated == plain == golden on "
        f"{len(lanes)} lanes ({nreal - 12} adversarial, key 2 invalid, "
        f"{32 - nreal} padding)")

    # K1 with per-lane keys and messages: a consensus vote burst
    args, golden = vote_burst(dev)
    got = ed.verify_grouped(*args)
    require(torch.equal(got, ed.verify_grouped_plain(*args)),
            "K1 (per-lane keys) != plain")
    require(got.tolist() == golden, "K1 (per-lane keys) != golden")
    log(f"[check] K1 verify_grouped (per-lane keys) == plain == golden on a "
        f"vote burst: {len(golden)} lanes, {sum(golden)} valid, Vb "
        f"{args[0].shape[2]}")

    check_k1_lanes(tbl, ok, (a, pre, pubs), tm, base, rng)
    check_k7(rng)

    # K5 on edge lanes, at both message lengths, at lane counts that are
    # not multiples of a quad (4 threads) or a block (32 lanes)
    for msg_len in (32, 96):
        lanes = edge_lanes(msg_len, rng)
        golden = [ref.verify(*x) for x in lanes]
        for n in K5_CHECK_LANES:
            rows = [lanes[i % len(lanes)] for i in range(n)]
            raw = tuple(t(np.frombuffer(b"".join(x[k] for x in rows),
                                        np.uint8).reshape(n, -1).copy())
                        for k in range(3))
            got = ed.verify_batch(*raw, base)
            require(torch.equal(got, ed.verify_batch_plain(*raw, base)),
                    f"K5 != plain (M {msg_len}, N {n})")
            require(got.tolist() == [golden[i % len(lanes)]
                                     for i in range(n)],
                    f"K5 != golden (M {msg_len}, N {n})")
        log(f"[check] K5 verify_raw == plain == golden on {len(lanes)} edge "
            f"lanes x M {msg_len} at N = {K5_CHECK_LANES} "
            f"({sum(golden)} valid)")

    # K6 on the edge lanes (128-byte sign-bytes) with mixed powers: 4,096
    # lanes in one row and 40 rows of 100, each against quorums that pass
    # and fail; in every other row the invalid lanes have power 0, so
    # those rows pass the all-signed check
    lanes = edge_lanes(canonical.SIGN_BYTES_LEN, rng)
    golden = [ref.verify(*x) for x in lanes]
    for n, rows in ((4096, 1), (4000, 40)):
        grid = [lanes[i % len(lanes)] for i in range(n)]
        raw = tuple(t(np.frombuffer(b"".join(x[k] for x in grid),
                                    np.uint8).reshape(n, -1).copy())
                    for k in range(3))
        pw = rng.integers(0, 2**40, n).astype(np.int64)
        pw[rng.random(n) < 0.3] = 0
        valid = np.array([golden[i % len(lanes)] for i in range(n)])
        even_row = (np.arange(n) // (n // rows)) % 2 == 0
        pw[even_row & ~valid] = 0
        pw = t(pw)
        k5 = ed.verify_batch(*raw, base)
        passed = 0
        for total in (0, int(pw.sum()) // rows, 2**62):
            got = ed.verify_tally(*raw, pw, rows, total, base)
            want = ed.verify_tally_plain(*raw, pw, rows, total, base)
            require(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"K6 != plain ({n} lanes, {rows} rows, total {total})")
            require(torch.equal(got[0], k5), "K6 mask != K5 mask")
            passed += int(got[2].sum())
        require(got[0].tolist() == [golden[i % len(lanes)]
                                    for i in range(n)], "K6 != golden")
        log(f"[check] K6 verify_tally == plain (mask, int64 tallies, "
            f"quorums) == K5 == golden on {n} edge lanes x M "
            f"{canonical.SIGN_BYTES_LEN} in {rows} rows, mixed powers, 3 totals "
            f"({passed} row quorums passed)")


K5_CHECK_LANES = (12, 1, 3, 7, 9, 33, 200)
K1_CHECK_LANES = (1, 31, 33, 128, 129, 65536)
K7_CHECK_LEAVES = (1, 2, 3, 5, 7, 64, 1000, 1024, 1025, 4000)
K7_CHECK_LEAF_LENS = (0, 24, 55, 56, 64, 119)


def _forge_lanes(sigs, vi, ti, n_tmpl: int, rng) -> None:
    """Forge about half the lanes of a signed batch in place: R, s and
    message bits, s + L, a wrong key, R = identity, and key and template
    indices of -1 and the count."""
    import numpy as np
    from tendermint_tpu_torch.crypto import pure_ed25519 as ref
    n = len(vi)
    kind = rng.integers(0, 16, n)
    sigs[kind == 1, 3] ^= 0x10                              # R bit
    sigs[kind == 2, 45] ^= 0x01                             # s bit
    for i in np.flatnonzero(kind == 3)[:64]:                # s + L
        s = int.from_bytes(sigs[i, 32:].tobytes(), "little") + ref.L
        sigs[i, 32:] = np.frombuffer(s.to_bytes(32, "little"), np.uint8)
    vi[kind == 4] = (vi[kind == 4] + 1) % 4                 # wrong key
    sigs[kind == 5, :32] = 0
    sigs[kind == 5, 0] = 1                                  # R = identity
    vi[kind == 6] = -1
    vi[kind == 7] = 4
    ti[kind == 8] = -1
    ti[kind == 9] = n_tmpl
    ti[kind == 10] = (ti[kind == 10] + 1) % n_tmpl          # other message


def check_k1_lanes(tbl, ok, keys, tm, base, rng, sizes=None) -> None:
    """K1 on both routes at `sizes` (K1_CHECK_LANES): lanes over the
    four keys of `keys` (a, prefixes, pubkeys) signed by K3 (checked
    before), then forged lanes and indices out of range mixed into the
    warps and blocks; every lane == plain.  On CPU tensors (small
    `sizes`) it rehearses the check with the plain versions."""
    import numpy as np
    import torch
    from tendermint_tpu_torch.ops import ed25519 as ed
    dev = tbl.device
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    a, pre, pubs = keys
    T = len(tm)
    for n in sizes or K1_CHECK_LANES:
        vi = rng.integers(0, 4, n).astype(np.int32)
        ti = rng.integers(0, T, n).astype(np.int32)
        sg = ed.sign_grouped_templated(t(a), t(pre), t(pubs), t(vi), t(ti),
                                       t(tm), base).cpu().numpy()
        if n > 1:
            _forge_lanes(sg, vi, ti, T, rng)
        targs = (tbl, ok, t(pubs), t(vi), t(ti), t(tm), t(sg), base)
        got = ed.verify_grouped_templated(*targs)
        require(torch.equal(got, ed.verify_grouped_templated_plain(*targs)),
                f"K1 != plain at N = {n}")
        vc, tc = vi.clip(0, 3), ti.clip(0, T - 1)
        largs = (tbl, ok, t(vi), t(pubs[vc]), t(tm[tc]), t(sg), base)
        got_l = ed.verify_grouped(*largs)
        require(torch.equal(got_l, ed.verify_grouped_plain(*largs)),
                f"K1 (per-lane keys) != plain at N = {n}")
        inside = (vi >= 0) & (vi < 4) & (ti >= 0) & (ti < T)
        require(not bool(got[t(~inside)].any()) and
                not bool(got_l[t((vi < 0) | (vi >= 4))].any()),
                f"K1 accepted a lane out of range at N = {n}")
        require(n == 1 or 0 < int(got.sum()) < n, f"K1 at N = {n}: "
                f"{int(got.sum())} valid")
    log(f"[check] K1 verify_grouped_templated and verify_grouped == plain on "
        f"every lane at N = {sizes or K1_CHECK_LANES}, forged lanes and "
        f"indices out of range (-1, the count) mixed in")


def check_k7(rng, dev=None, leaves=K7_CHECK_LEAVES) -> None:
    """K7 (`merkle.roots`, `merkle.root_from_leaf_hashes`) against the
    plain versions on [2, 3, n, L] batches at every n of `leaves` and
    every leaf length (n = 4,000 past the shared-memory limit), the
    given-hashes route at each n, and 8 roots against the host tree.
    `dev` = cpu rehearses it with the plain versions."""
    import numpy as np
    import torch
    from tendermint_tpu_torch.ops import merkle
    from tendermint_tpu_torch.types import merkle as host_merkle
    dev = dev or torch.device("cuda")
    shared = [n for n in leaves if 2 * n * 32 <= merkle.MAX_SHARED_BYTES]
    require(len(shared) < len(leaves), "no K7 check past the shared-memory "
            "limit")
    hosted = 0
    for n in leaves:
        for width in K7_CHECK_LEAF_LENS:
            data = torch.as_tensor(rng.integers(0, 256, (2, 3, n, width),
                                                dtype=np.uint8), device=dev)
            got = merkle.roots(data)
            require(got.shape == (2, 3, 32) and
                    torch.equal(got, merkle.roots_plain(data)),
                    f"K7 != plain at n = {n}, L = {width}")
            if width in (0, 119) and hosted < 8:
                host = data[1, 2].cpu().numpy()
                require(got[1, 2].cpu().numpy().tobytes() == host_merkle.root(
                    [host[i].tobytes() for i in range(n)]),
                    f"K7 != host tree at n = {n}, L = {width}")
                hosted += 1
        h = torch.as_tensor(rng.integers(0, 256, (2, 3, n, 32),
                                         dtype=np.uint8), device=dev)
        require(torch.equal(merkle.root_from_leaf_hashes(h),
                            merkle.root_from_leaf_hashes_plain(h)),
                f"K7 (given leaf hashes) != plain at n = {n}")
    require(hosted == 8, f"{hosted} K7 roots held against the host tree")
    log(f"[check] K7 roots == plain on [2, 3, n, L] at n = {leaves} "
        f"(shared memory up to n = {max(shared)}, scratch above) x L = "
        f"{K7_CHECK_LEAF_LENS}, root_from_leaf_hashes == plain at each n, "
        f"{hosted} roots == host tree")
K2_CHECK_SETS = ((1, None), (4, 2), (100, 50), (128, None))
K3_CHECK_LANES = (1, 31, 33, 129, 256, 65500)


def edge_lanes(msg_len: int, rng) -> list:
    """Raw-lane (pubkey, msg, sig) triples: valid lanes, each single
    mutation, malleated s, non-canonical and undecodable encodings, and
    the cofactorless identity case the golden verifier accepts."""
    import numpy as np
    from tendermint_tpu_torch.crypto import pure_ed25519 as ref
    seeds = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
             for _ in range(4)]
    pubs = [ref.pubkey_from_seed(x) for x in seeds]
    msgs = [rng.integers(0, 256, msg_len, dtype=np.uint8).tobytes()
            for _ in range(4)]
    sigs = [ref.sign(x, m) for x, m in zip(seeds, msgs)]
    flip = lambda b, i: b[:i] + bytes([b[i] ^ 1]) + b[i + 1:]  # noqa: E731
    y = 2                                   # smallest y that is no point
    while ref.pt_decode(y.to_bytes(32, "little")) is not None:
        y += 1
    s_big = int.from_bytes(sigs[0][32:], "little") + ref.L
    ident = (1).to_bytes(32, "little")
    return [
        (pubs[0], msgs[0], sigs[0]),                          # valid
        (pubs[1], flip(msgs[1], 0), sigs[1]),                 # message bit
        (pubs[2], msgs[2], flip(sigs[2], 0)),                 # R bit
        (pubs[3], msgs[3], flip(sigs[3], 40)),                # s bit
        (pubs[1], msgs[0], sigs[0]),                          # wrong key
        (pubs[0], msgs[0], sigs[0][:32] + s_big.to_bytes(32, "little")),
        (pubs[1], msgs[1], ref.P.to_bytes(32, "little") + sigs[1][32:]),
        ((ref.P + 3).to_bytes(32, "little"), msgs[2], sigs[2]),  # A y >= p
        (y.to_bytes(32, "little"), msgs[3], sigs[3]),         # A no point
        (ident[:31] + b"\x80", msgs[0], sigs[0]),             # x = 0, sign
        (ident, msgs[1], ident + bytes(32)),                  # identity
        (pubs[2], msgs[2], sigs[2]),                          # valid
    ]


VOTE_VALS = 100                             # the replay's validator count


def vote_burst(dev):
    """Arguments of `ed25519.verify_grouped` for one consensus vote burst
    and each lane's golden verdict: 100 validators (Vb 128), 128 lanes of
    128-byte canonical prevote sign-bytes — one valid vote per validator,
    then adversarial lanes (s + L, R >= p, a flipped message bit, a wrong
    key, R = identity) and valid repeats."""
    import numpy as np
    import torch
    from tendermint_tpu_torch.crypto import pure_ed25519 as ref
    from tendermint_tpu_torch.crypto.backend import CudaBackend
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.types import canonical
    seeds, _, _, pubs, _ = _keys(VOTE_VALS)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    tbl, ok, _, _ = CudaBackend(dev).tables(b"vote-burst", pubs)  # K2
    tmpl = canonical.batch_sign_bytes(
        "vote-chain", np.array([canonical.TYPE_PREVOTE]), np.array([7]),
        np.array([0]), np.full((1, 32), 0x5A, np.uint8),
        np.full((1, 32), 0xA5, np.uint8), np.array([1]))[0]
    msg = tmpl.tobytes()
    lanes = [(v, msg, ref.sign(seeds[v], msg)) for v in range(VOTE_VALS)]
    flipped = bytearray(msg)
    flipped[60] ^= 0x01
    s_big = int.from_bytes(lanes[0][2][32:], "little") + ref.L
    lanes += [
        (0, msg, lanes[0][2][:32] + s_big.to_bytes(32, "little")),
        (1, msg, (2**255 - 19).to_bytes(32, "little") + lanes[1][2][32:]),
        (2, bytes(flipped), lanes[2][2]),
        (3, msg, lanes[4][2]),
        (5, msg, (1).to_bytes(32, "little") + bytes(32)),
    ]
    lanes += [lanes[i] for i in range(128 - len(lanes))]
    vi = np.asarray([x[0] for x in lanes], np.int32)
    msgs = np.frombuffer(b"".join(x[1] for x in lanes),
                         np.uint8).reshape(128, -1)
    sigs = np.frombuffer(b"".join(x[2] for x in lanes),
                         np.uint8).reshape(128, 64)
    golden = [ref.verify(pubs[v].tobytes(), m, sg) for v, m, sg in lanes]
    args = (tbl, ok, t(vi), t(pubs[vi]), t(msgs.copy()), t(sigs.copy()),
            ed.base_table(dev))
    return args, golden


# -- the main path: replay, then the tamper check ------------------------

N_VALS, N_BLOCKS, WINDOW = 100, 2500, 625        # BASELINE config 3 shape
TAMPER_HEIGHT, TAMPER_LANE = 1388, 41


def phase_replay() -> dict:
    """The main path's replay: sign the fixture chain (K3), build the set's
    comb tables (K2) and replay every window (K1 once per window)."""
    import torch
    from tendermint_tpu_torch.abci.app import create_app
    from tendermint_tpu_torch.blockchain import replay as rp
    from tendermint_tpu_torch.crypto.backend import CudaBackend
    from tendermint_tpu_torch.proxy import ClientCreator
    from tendermint_tpu_torch.state.state import get_state
    from tendermint_tpu_torch.utils.db import MemDB

    be = CudaBackend()
    t0 = time.perf_counter()
    chain = rp.build_chain(N_VALS, N_BLOCKS, be)
    log(f"[replay] fixture: {N_BLOCKS} blocks x {N_VALS} validators, "
        f"{N_BLOCKS * N_VALS} seen-commit signatures signed on the card "
        f"(K3), built in {time.perf_counter() - t0:.2f} s")
    state = get_state(MemDB(), chain.genesis)
    conns = ClientCreator("kvstore").new_app_conns()
    vals = state.validators
    t0 = time.perf_counter()
    tbl = be.tables(vals.set_key(), vals.pubs_matrix())[0]
    torch.cuda.synchronize()
    log(f"[replay] comb tables for {N_VALS} validators (Vb "
        f"{tbl.shape[2]}, {tbl.numel() / 1e6:.1f} MB on the card) built in "
        f"{time.perf_counter() - t0:.3f} s (K2)")
    t0 = time.perf_counter()
    res = rp.replay(state, conns.consensus, chain.blocks, chain.commits, be,
                    window=WINDOW)
    wall = time.perf_counter() - t0
    for w in res.windows:
        log(f"[replay] window @{w.first_height}: {w.blocks} blocks, "
            f"{w.lanes} sigs; prepare {w.prepare_s:.4f} s, verify "
            f"{w.verify_s:.4f} s, apply {w.apply_s:.4f} s")
    steady = res.windows[1:]
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    log(f"[replay] first window: prepare {res.windows[0].prepare_s:.4f} s, "
        f"verify {res.windows[0].verify_s:.4f} s, apply "
        f"{res.windows[0].apply_s:.4f} s")
    log(f"[replay] steady window (mean of {len(steady)}): prepare "
        f"{mean([w.prepare_s for w in steady]):.4f} s, verify "
        f"{mean([w.verify_s for w in steady]):.4f} s, apply "
        f"{mean([w.apply_s for w in steady]):.4f} s")
    verify_s = sum(w.verify_s for w in res.windows)
    log(f"[replay] {res.sigs} sigs in {wall:.3f} s: "
        f"{res.sigs / wall:.0f} sigs/s end to end, "
        f"{res.sigs / verify_s:.0f} sigs/s in the verify step, "
        f"{N_BLOCKS / wall:.1f} blocks/s")
    require(res.height == N_BLOCKS and res.sigs == N_BLOCKS * N_VALS,
            "replay did not verify and apply every block")
    app = create_app("kvstore")
    for b in chain.blocks:
        for tx in b.txs:
            app.deliver_tx(tx)
        host_hash = app.commit().data
    require(res.app_hash == host_hash, "app hash != host kvstore run")
    log(f"[replay] final height {res.height}, app hash "
        f"{res.app_hash.hex()} == host kvstore run")
    return {"backend": be, "chain": chain, "vals": vals,
            "set_key": vals.set_key(), "app_hash": res.app_hash}


def phase_tamper(rp_ctx: dict) -> None:
    """Tamper one signature of the third window and re-verify it: the
    error must name the tampered height and lane."""
    from tendermint_tpu_torch.blockchain import replay as rp
    from tendermint_tpu_torch.types.block import CompactCommit
    from tendermint_tpu_torch.types.validator import (CommitSignatureError,
                                                      verify_commits_batched)
    be, chain, vals = rp_ctx["backend"], rp_ctx["chain"], rp_ctx["vals"]
    lo = 2 * WINDOW
    blocks = chain.blocks[lo:lo + WINDOW]
    commits = list(chain.commits[lo:lo + WINDOW])
    j = TAMPER_HEIGHT - 1 - lo
    c = commits[j]
    sigs = c.sigs.copy()
    sigs[TAMPER_LANE, 7] ^= 0x01
    commits[j] = CompactCommit(block_id=c.block_id, height_=c.height_,
                               round_=c.round_, sigs=sigs, present=c.present)
    _, _, items = rp.prepare_window(blocks, commits, vals.hash(), be)
    try:
        verify_commits_batched(vals, chain.genesis.chain_id, items, be)
    except CommitSignatureError as e:
        require((e.height, e.lane) == (TAMPER_HEIGHT, TAMPER_LANE),
                f"tamper blamed height {e.height} lane {e.lane}")
        log(f"[replay] tampered window rejected: {e}")
    else:
        raise AssertionError("tampered window verified")


# -- the main path: Merkle roots, then their check ----------------------

TREES, LEAVES, LEAF_LEN = 2048, 1024, 64          # BASELINE config 2 shape


def phase_merkle(be) -> dict:
    """The main path's Merkle cell, BASELINE config 2's block Merkle and
    part-set roots: one `roots` call over the trees (K7), then the part
    sets of the same blocks through `part_set.from_data_batched` on the
    backend (each block's 1,024 x 64-byte txs one full 64 KB part, hashed
    in one K4 batch)."""
    import torch
    from tendermint_tpu_torch.ops import merkle
    from tendermint_tpu_torch.types import part_set
    g = torch.Generator(device="cuda").manual_seed(SEED)
    data = torch.randint(0, 256, (TREES, LEAVES, LEAF_LEN), generator=g,
                         device="cuda", dtype=torch.uint8)
    roots = merkle.roots(data)
    torch.cuda.synchronize()
    blocks = data.reshape(TREES, -1).cpu().numpy()
    t0 = time.perf_counter()
    parts = part_set.from_data_batched([b.tobytes() for b in blocks],
                                       backend=be)
    part_set_s = time.perf_counter() - t0
    log(f"[merkle] part sets of {TREES} blocks x {blocks.shape[1]} B (one "
        f"full part each, hashed by K4 in one batch) in {part_set_s:.3f} s")
    return {"data": data, "roots": roots, "blocks": blocks, "parts": parts,
            "backend": be, "part_set_s": part_set_s}


def part_set_steps(blocks, be) -> tuple:
    """The Merkle cell's part-set call once more, under `torch.profiler`:
    `part_set.from_data_batched([b.tobytes() for b in blocks], backend=
    be)` -> ({step: ms}, the PartSets).  The steps: the blocks as bytes
    (host clock), the host time of each `part_set.*` span of the call, the
    device time of each copy and of K4 in it, and the call itself (host
    clock, under the profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tendermint_tpu_torch.types import part_set
    CPU = DeviceType.CPU     # each span also has a device twin, no CPU time
    t0 = time.perf_counter()
    datas = [b.tobytes() for b in blocks]
    steps = {"bytes": (time.perf_counter() - t0) * 1e3}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        parts = part_set.from_data_batched(datas, backend=be)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
    for e in prof.key_averages():
        if e.key.startswith("part_set.") and e.device_type == CPU:
            steps[e.key[len("part_set."):]] = e.cpu_time_total / 1e3
        elif e.key.startswith("Memcpy") or e.key.startswith("sha256_"):
            us = (getattr(e, "device_time_total", None)
                  or getattr(e, "cuda_time_total", 0))
            steps[f"device {e.key.split('(')[0].strip()}"] = us / 1e3
    steps["call"] = call_ms
    return steps, parts


def h2d_copies(fn) -> int:
    """Host-to-device copies that one call of `fn` makes, counted from
    `torch.profiler`'s CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if "HtoD" in e.key)


def check_merkle(mk_ctx: dict) -> None:
    """Sample the roots against the host tree and the part sets against
    the host's; time `roots` (K7) and its plain version, held equal; and
    count the host-to-device copies of a call for a new n (the schedule's
    upload) and of the timed call (none)."""
    import torch
    from tendermint_tpu_torch.ops import merkle
    from tendermint_tpu_torch.types import merkle as host_merkle
    from tendermint_tpu_torch.types import part_set
    data, roots = mk_ctx["data"], mk_ctx["roots"]
    host = data[:8].cpu().numpy()
    for b in range(len(host)):
        want = host_merkle.root([host[b, i].tobytes() for i in range(LEAVES)])
        require(roots[b].cpu().numpy().tobytes() == want,
                f"tree {b}: device root != host tree")
    blocks, parts = mk_ctx["blocks"], mk_ctx["parts"]
    for b in range(TREES):
        require(parts[b].header.hash == hashlib.sha256(
            b"\0" + blocks[b].tobytes()).digest(),
            f"block {b}: part-set root != hashlib")
    host_parts = part_set.from_data_batched(
        [blocks[b].tobytes() for b in range(8)])
    require([p.header for p in parts[:8]] == [p.header for p in host_parts],
            "part sets != the host's")
    steps, again = part_set_steps(blocks, mk_ctx["backend"])
    require([p.header for p in again] == [p.header for p in parts],
            "the part-set call under the profiler != the call")
    require({"chunk", "join", "leaf_hashes", "trees"} <= set(steps),
            f"the part-set call's spans missing from the trace: {steps}")
    log(f"[merkle] the part-set call's steps (torch.profiler spans; device "
        f"time of copies and K4), ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in steps.items())
        + f" (the timed call: {mk_ctx['part_set_s'] * 1e3:.4f})")
    cold = h2d_copies(lambda: merkle.roots(data[:2, :LEAVES - 1]))
    warm = h2d_copies(lambda: merkle.roots(data))
    require(cold > 0 and warm == 0, f"roots copies from the host: {cold} "
            f"at a new n, {warm} at n = {LEAVES} (the profiler must see the "
            f"first and no copy in the second)")
    ms, _ = cuda_ms(lambda: merkle.roots(data), 3)
    plain_ms, plain = cuda_ms(lambda: merkle.roots_plain(data), 0)
    require(torch.equal(plain, roots), "roots (K7) != roots_plain")
    bound_ms, bound_by = _bound(*_roots_cost(TREES, LEAVES, LEAF_LEN))
    log(f"[merkle] {TREES} trees x {LEAVES} leaves x {LEAF_LEN} B: "
        f"{ms:.3f} ms per batch, {TREES / ms * 1e3:.0f} trees/s, bound "
        f"{bound_ms:.4f} ms by {bound_by}; plain "
        f"{plain_ms:.1f} ms, == K7 roots; {len(host)} roots == host tree; "
        f"{TREES} part-set roots == hashlib, 8 == the host's; host-to-device "
        f"copies per roots call (torch.profiler): {cold} at a new n, {warm} "
        f"after")


def plain_cuda_ms(fn, swaps) -> tuple:
    """`cuda_ms(fn, 0)` with each (module, name, plain version) of `swaps`
    put in place of the kernel wrapper for the run."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        return cuda_ms(fn, 0)
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def _roots_cost(trees: int, leaves: int, leaf_len: int) -> tuple:
    """(bytes, operations) of `merkle.roots` over trees x leaves x
    leaf_len: SHA-256 of 0x00 || leaf for every leaf and of 0x01 || left
    || right for every inner node; the leaves read once, the roots written
    once."""
    leaf_blocks = (leaf_len + 1 + 9 + 63) // 64
    inner_blocks = (64 + 1 + 9 + 63) // 64
    ops = trees * (leaves * leaf_blocks + (leaves - 1) * inner_blocks) \
        * SHA256_OPS_PER_BLOCK
    return trees * leaves * leaf_len + trees * 32, ops


# -- the main path: mempool admission of signed txs ---------------------

# the JAX package's defaults (`scenarios/ingress.py`): kvstore app,
# MempoolConfig(), the batch plane's 1,024-lane target and 4,096-lane
# flush cap, and Tendermint's MaxBlockSizeTxs (tendermint_tpu/config.py:126)
MEMPOOL_MIX = dict(unsigned=2048, signed=8192, bad_sig=512, dup_frac=0.15,
                   payload_bytes=64, priorities=(0, 1, 2, 5, 9))
MEMPOOL_ROUND, MEMPOOL_WORKERS = 2048, 1024


def _pctl(xs: list, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


class _TimedVerify:
    """The backend, with the wall time of each raw-lane verify call
    (padding, H2D, K5, D2H) summed."""

    def __init__(self, be):
        self.be = be
        self.seconds = 0.0

    def __getattr__(self, name):
        return getattr(self.be, name)

    def verify_batch(self, pubkeys, msgs, sigs):
        t0 = time.perf_counter()
        out = self.be.verify_batch(pubkeys, msgs, sigs)
        self.seconds += time.perf_counter() - t0
        return out


def phase_mempool(be, mix: dict = MEMPOOL_MIX, round_size: int =
                  MEMPOOL_ROUND, workers: int = MEMPOOL_WORKERS,
                  n_vals: int = VOTE_VALS) -> dict:
    """The main path's mempool admission: a seeded corpus (signed on the
    card, K3) through `scenarios.ingress.run_ingress` — every entry offered
    once via a `broadcast_tx_sync`-shaped handler into `Mempool.check_tx`
    from `workers` threads, the batch plane coalescing signature lanes onto
    K5 while the validators' prevotes ride its consensus class (K1 with
    per-lane keys), and one block per round applied with the real
    mempool."""
    import random
    from tendermint_tpu_torch.crypto.backend import _bucket
    from tendermint_tpu_torch.scenarios import ingress, loadgen
    t0 = time.perf_counter()
    corpus = loadgen.build_corpus(random.Random(SEED), loadgen.Mix(**mix),
                                  backend=be)
    corpus_s = time.perf_counter() - t0
    timed = _TimedVerify(be)
    run = ingress.run_ingress(timed, corpus, round_size=round_size,
                              workers=workers, n_vals=n_vals)
    lat = [x[1] for x in run.results]
    admitted = sum(x[0] == "admitted" for x in run.results)
    raw = [(r, n) for k, r, n in run.flushes if k == "raw"]
    sizes = sorted(n for _, n in raw) or [0]
    buckets = {}
    for n in sizes:
        b = _bucket(n)
        buckets[b] = buckets.get(b, 0) + 1
    log(f"[mempool] corpus of {len(corpus)} submissions ({mix['signed']} "
        f"signed, {mix['bad_sig']} bad-signature, {mix['unsigned']} "
        f"unsigned, {mix['dup_frac']} duplicated) signed on the card (K3) "
        f"in {corpus_s:.2f} s")
    log(f"[mempool] {len(run.results)} submissions by {workers} threads in "
        f"{len(run.blocks)} rounds: "
        f"{len(run.results) / run.ingress_s:.0f} submissions/s, "
        f"{admitted / run.ingress_s:.0f} admissions/s; check_tx p50 "
        f"{_pctl(lat, 0.5) * 1e3:.3f} ms, p99 {_pctl(lat, 0.99) * 1e3:.3f} "
        f"ms; stages: ingress {run.ingress_s:.3f} s, block apply "
        f"{run.apply_s:.3f} s ({len(run.blocks)} blocks)")
    log(f"[mempool] {len(raw)} K5 flushes ("
        f"{sum(r == 'full' for r, _ in raw)} full, "
        f"{sum(r == 'deadline' for r, _ in raw)} deadline), lanes per "
        f"flush min {sizes[0]} / p50 {_pctl(sizes, 0.5)} / p99 "
        f"{_pctl(sizes, 0.99)} / max {sizes[-1]}, K5 launches by padded "
        f"size {dict(sorted(buckets.items()))}; the plane's raw verify "
        f"calls (pad, H2D, K5, D2H) took {timed.seconds:.3f} s of the "
        f"ingress, {timed.seconds / len(raw) * 1e3:.3f} ms each")
    return {"corpus": corpus, "run": run, "backend": be,
            "k5_by_size": buckets}


def check_mempool(mp_ctx: dict, launches: dict) -> None:
    """The mempool phase's accounting, commit, app-hash and verify
    checks (every signed entry re-verified by the plain version)."""
    import numpy as np
    import torch
    from tendermint_tpu_torch.abci.app import create_app
    from tendermint_tpu_torch.crypto import pure_ed25519 as ref
    from tendermint_tpu_torch.mempool.mempool import (_priority_digest,
                                                      parse_signed_tx)
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.scenarios.loadgen import OUTCOMES
    corpus, run = mp_ctx["corpus"], mp_ctx["run"]
    results = run.results
    txs = [bytes.fromhex(e["tx"]) for e in corpus]
    outcomes = [r[0] for r in results]
    counts = {k: outcomes.count(k) for k in OUTCOMES}
    require(sum(counts.values()) == len(corpus),
            "outcomes do not sum to the offered count")
    for k in ("full", "backpressure", "encoding", "app", "error"):
        require(counts[k] == 0, f"{counts[k]} submissions ended {k!r}")
    first = {}
    for tx, out in zip(txs, outcomes):
        first.setdefault(tx, []).append(out)
    signed = {tx: parse_signed_tx(tx) for tx in first}
    uniq = list(first)
    # the plain version re-verifies every distinct signed tx on the card
    lanes = [tx for tx in uniq if signed[tx] is not None]
    dev = mp_ctx["backend"].device
    rows = lambda k, w: np.frombuffer(  # noqa: E731
        b"".join(k(signed[tx]) for tx in lanes), np.uint8).reshape(-1, w)
    pubs, sigs = rows(lambda p: p[1], 32), rows(lambda p: p[2], 64)
    digests = rows(lambda p: _priority_digest(p[4], p[3]), 32)
    base = ed.base_table(dev)
    valid = []
    for lo in range(0, len(lanes), 4096):
        valid += ed.verify_batch_plain(
            *(torch.as_tensor(a[lo:lo + 4096].copy(), device=dev)
              for a in (pubs, digests, sigs)), base).tolist()
    valid = dict(zip(lanes, valid))
    n_gold = min(64, len(lanes))
    for i, tx in enumerate(lanes[:n_gold]):
        require(ref.verify(pubs[i].tobytes(), digests[i].tobytes(),
                           sigs[i].tobytes()) == valid[tx],
                "plain verify != pure_ed25519")
    for tx in uniq:
        outs = first[tx]
        if signed[tx] is None or valid[tx]:
            require(outs.count("admitted") == 1 and
                    outs.count("dup") == len(outs) - 1,
                    f"valid tx outcomes {outs}")
        else:
            require(outs.count("bad_sig") >= 1 and
                    outs.count("bad_sig") + outs.count("dup") == len(outs),
                    f"bad-signature tx outcomes {outs}")
    admitted = [tx for tx in uniq if "admitted" in first[tx]]
    committed = [tx for b in run.blocks for tx in b.txs]
    require(sorted(committed) == sorted(admitted),
            "committed txs != admitted txs (each exactly once)")
    require(run.mempool.size() == 0, "pool not empty after the last block")
    state = run.state
    app = create_app("kvstore")
    for b in run.blocks:
        for tx in b.txs:
            app.deliver_tx(tx)
        host_hash = app.commit().data
    require(state.app_hash == host_hash, "app hash != host kvstore run")
    raw = [n for k, _, n in run.flushes if k == "raw"]
    verified = sum(1 for tx, o in zip(txs, outcomes)
                   if signed[tx] is not None and o in ("admitted", "bad_sig"))
    require(launches["K5"] == len(raw) > 0,
            "K5 launches != raw flushes of the plane")
    require(sum(raw) == verified,
            f"K5 saw {sum(raw)} lanes, {verified} signed submissions "
            f"reached the verify")
    votes = run.votes
    require(len(votes) == len(run.blocks) - 1 and
            all(bool(v.all()) for v in votes), "a valid vote was rejected")
    log(f"[mempool] outcomes {counts}; {len(admitted)} admitted txs "
        f"committed once each in {len(run.blocks)} blocks, pool "
        f"empty; app hash {state.app_hash.hex()} == host kvstore run; "
        f"{len(lanes)} signed txs re-verified by the plain version == "
        f"admission ({n_gold} also by pure_ed25519); K5 {launches['K5']} "
        f"launches over {sum(raw)} lanes; {len(votes)} vote bursts valid")


# -- the main path: the multi-device crypto plane -----------------------

# the training step's grid: the first 1,000 blocks of the replay chain x
# 100 validators (BASELINE config 2's 100,000-signature vote-set batch
# when flattened), with 1,024 leaves of 64 B per block
MESH_BLOCKS, MESH_LEAVES = 1000, 1024
FORGED_BLOCK, ZERO_POWER_BLOCK, QUORUM_BLOCK = 17, 523, 999
FORGED_LANE, ZERO_POWER_LANE = 3, 42


def mesh_inputs(rp_ctx: dict) -> dict:
    """The mesh phase's inputs, from the replay fixture's signed chain: the
    first 1,000 blocks' seen commits as a [1000, 100] grid of (key,
    128-byte precommit sign-bytes, signature) lanes and seeded int64 powers
    of the 100 validators.  `flat`: the 100,000 lanes with a seeded 1 % of
    their signatures tampered; `grid`: one block with a forged lane of
    nonzero power, one with a forged lane of power 0, one under quorum
    (its largest powers zeroed); 1,024 random leaves per block."""
    import numpy as np
    import torch
    from tendermint_tpu_torch.types import canonical
    chain, vals = rp_ctx["chain"], rp_ctx["vals"]
    dev = rp_ctx["backend"].device
    nb, nv = MESH_BLOCKS, N_VALS
    bids = [c.block_id for c in chain.commits[:nb]]
    templates = canonical.batch_sign_bytes(
        chain.genesis.chain_id,
        np.full(nb, canonical.TYPE_PRECOMMIT, np.int64),
        np.arange(1, nb + 1, dtype=np.int64), np.zeros(nb, np.int64),
        np.frombuffer(b"".join(b.hash for b in bids), np.uint8).reshape(nb, 32),
        np.frombuffer(b"".join(b.parts.hash for b in bids),
                      np.uint8).reshape(nb, 32),
        np.array([b.parts.total for b in bids], np.int64))
    sigs = np.stack([c.sigs for c in chain.commits[:nb]])     # [nb, nv, 64]
    pubs = np.broadcast_to(vals.pubs_matrix(), (nb, nv, 32))
    msgs = np.broadcast_to(templates[:, None], (nb, nv, templates.shape[1]))
    rng = np.random.default_rng(SEED)
    vpow = rng.integers(1, 2**40, nv, dtype=np.int64)
    total = int(vpow.sum())

    n = nb * nv
    flat_sigs = sigs.reshape(n, 64).copy()
    bad = rng.choice(n, n // 100, replace=False)
    flat_sigs[bad, rng.integers(0, 64, len(bad))] ^= np.left_shift(
        1, rng.integers(0, 8, len(bad))).astype(np.uint8)
    flat_ok = np.ones(n, bool)
    flat_ok[bad] = False

    grid_sigs = sigs.copy()
    powers = np.broadcast_to(vpow, (nb, nv)).copy()
    grid_ok = np.ones((nb, nv), bool)
    grid_sigs[FORGED_BLOCK, FORGED_LANE, 40] ^= 0x01
    grid_sigs[ZERO_POWER_BLOCK, ZERO_POWER_LANE, 7] ^= 0x01
    powers[ZERO_POWER_BLOCK, ZERO_POWER_LANE] = 0
    grid_ok[FORGED_BLOCK, FORGED_LANE] = False
    grid_ok[ZERO_POWER_BLOCK, ZERO_POWER_LANE] = False
    for j in np.argsort(-vpow):
        if powers[QUORUM_BLOCK].sum() * 3 <= total * 2:
            break
        powers[QUORUM_BLOCK, j] = 0
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    leaves = torch.randint(0, 256, (nb, MESH_LEAVES, LEAF_LEN), generator=g,
                           device=dev, dtype=torch.uint8)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x),  # noqa: E731
                                  device=dev)
    return {"flat": (t(pubs.reshape(n, 32)), t(msgs.reshape(n, -1)),
                     t(flat_sigs), t(np.tile(vpow, nb))),
            "flat_ok": flat_ok, "vpow": vpow, "total": total,
            "grid": (t(pubs), t(msgs), t(grid_sigs), t(powers)),
            "grid_ok": grid_ok, "powers": powers, "leaves": leaves}


class _RecordedVerify:
    """The backend, with each grouped templated verify's arguments and
    mask kept."""

    def __init__(self, be):
        self.be = be
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.be, name)

    def verify_grouped_templated(self, *args):
        out = self.be.verify_grouped_templated(*args)
        self.calls.append((args, out))
        return out


def _launched(fn):
    """(fn(), the kernel launches it made, by kernel key)."""
    import torch
    from tendermint_tpu_torch.ops import kernels
    before = dict(kernels.LAUNCHES)
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {KERNEL_KEYS[k]: n - before[k]
                 for k, n in kernels.LAUNCHES.items() if n > before[k]}


def _assembled(args) -> tuple:
    """`verify_grouped` arguments of a `verify_grouped_templated` call:
    each lane's message assembled on the host."""
    set_key, val_pubs, val_idx, tmpl_idx, templates, sigs = args
    return set_key, val_pubs, val_idx, templates[tmpl_idx], sigs


def mesh_label(mesh) -> str:
    from tendermint_tpu_torch.parallel.sharding import device_label
    names = [device_label(d) for d in mesh.devices]
    if len(set(names)) < len(names):
        return f"{names[0]} x {len(names)} virtual shards"
    return f"{len(names)} card{'s' * (len(names) > 1)} ({', '.join(names)})"


def phase_mesh(rp_ctx: dict, mk_ctx: dict, mesh_in: dict, mesh) -> dict:
    """One mesh's pass over rows 8-11 of the multi-device plane:
    `sharded_verify_fn` over the 100,000 flat lanes (K6 per shard),
    `sharded_merkle_fn` over the Merkle cell's trees (K7 per shard),
    `training_step_fn` over the 1,000 x 100 grid and its leaves (K6 and K7
    per shard), the replay's chain again through `CudaBackend(mesh=mesh)`
    (its 65,536-lane windows split over the mesh, templated K1 per shard),
    and the first window once more through that backend's
    `verify_grouped` with its messages assembled on the host (K1 with
    per-lane keys and messages per shard)."""
    from tendermint_tpu_torch.blockchain import replay as rp
    from tendermint_tpu_torch.crypto.backend import CudaBackend
    from tendermint_tpu_torch.parallel import sharding
    from tendermint_tpu_torch.proxy import ClientCreator
    from tendermint_tpu_torch.state.state import get_state
    from tendermint_tpu_torch.utils.db import MemDB
    label = mesh_label(mesh)
    ctx = {"mesh": mesh, "label": label, "launches": {}}
    msg_len = mesh_in["flat"][1].shape[1]

    ctx["verify_fn"] = sharding.sharded_verify_fn(mesh, msg_len)
    (ctx["ok"], ctx["tallied"]), ctx["launches"]["verify"] = _launched(
        lambda: ctx["verify_fn"](*mesh_in["flat"]))
    ctx["merkle_fn"] = sharding.sharded_merkle_fn(mesh)
    ctx["roots"], ctx["launches"]["merkle"] = _launched(
        lambda: ctx["merkle_fn"](mk_ctx["data"]))
    ctx["step_fn"] = sharding.training_step_fn(mesh, msg_len)
    ctx["step"], ctx["launches"]["step"] = _launched(
        lambda: ctx["step_fn"](*mesh_in["grid"], mesh_in["leaves"],
                               mesh_in["total"]))

    chain = rp_ctx["chain"]
    rec = _RecordedVerify(CudaBackend(rp_ctx["backend"].device, mesh=mesh))
    state = get_state(MemDB(), chain.genesis)
    conns = ClientCreator("kvstore").new_app_conns()
    t0 = time.perf_counter()
    ctx["replay"], ctx["launches"]["replay"] = _launched(
        lambda: rp.replay(state, conns.consensus, chain.blocks,
                          chain.commits, rec, window=WINDOW))
    wall = time.perf_counter() - t0
    ctx["backend"], ctx["calls"] = rec.be, rec.calls
    ctx["grouped_args"] = _assembled(ctx["calls"][0][0])
    ctx["grouped"], ctx["launches"]["grouped"] = _launched(
        lambda: rec.be.verify_grouped(*ctx["grouped_args"]))
    res = ctx["replay"]
    log(f"[mesh] {label}: sharded_verify_fn over {len(ctx['ok'])} lanes, "
        f"sharded_merkle_fn over {len(ctx['roots'])} trees, "
        f"training_step_fn over {len(ctx['step'][0])} blocks; replay of "
        f"{res.height} blocks through CudaBackend(mesh) in {wall:.3f} s "
        f"({res.sigs / wall:.0f} sigs/s end to end; verify per window "
        f"{', '.join(f'{w.verify_s:.4f}' for w in res.windows)} s, the "
        f"first with the set's tables); launches {ctx['launches']}")
    return ctx


def check_mesh(rp_ctx: dict, mk_ctx: dict, mesh_in: dict, ctx: dict) -> None:
    """Hold one mesh's results: row 8 against K5's mask on the same lanes
    and a numpy int64 tally, row 9 against the single-device roots, row 10
    against a host int64 recomputation and single-device roots, row 11's
    per-window masks against the single-device K1 and its app hash against
    the single-device replay's, and the host-assembled window's mask
    against the templated one; each sharded kernel launched once per
    shard."""
    import numpy as np
    import torch
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.ops import merkle
    from tendermint_tpu_torch.types import merkle as host_merkle
    mesh, label, launched = ctx["mesh"], ctx["label"], ctx["launches"]
    shards = mesh.size
    base = ed.base_table(rp_ctx["backend"].device)

    # row 8
    k5 = ed.verify_batch(*mesh_in["flat"][:3], base)
    require(torch.equal(ctx["ok"], k5), f"{label}: sharded_verify_fn mask "
            f"!= K5 mask")
    require(ctx["ok"].cpu().numpy().tolist() == mesh_in["flat_ok"].tolist(),
            f"{label}: sharded_verify_fn mask != the untampered lanes")
    w_flat = int(np.where(mesh_in["flat_ok"], np.tile(mesh_in["vpow"],
                                                      MESH_BLOCKS), 0).sum())
    require(ctx["tallied"].dtype == torch.int64 and
            int(ctx["tallied"]) == w_flat, f"{label}: tally "
            f"{int(ctx['tallied'])} != numpy {w_flat}")
    require(launched["verify"] == {"K6": shards}, f"{label}: row 8 "
            f"launches {launched['verify']}")

    # row 9
    require(torch.equal(ctx["roots"], mk_ctx["roots"]),
            f"{label}: sharded_merkle_fn != single-device roots")
    require(launched["merkle"] == {"K7": shards},
            f"{label}: row 9 launches {launched['merkle']}")

    # row 10
    block_ok, tallied, roots = ctx["step"]
    grid_ok, powers = mesh_in["grid_ok"], mesh_in["powers"]
    w_tally = np.where(grid_ok, powers, 0).sum(-1, dtype=np.int64)
    w_block = (grid_ok | (powers == 0)).all(-1) & \
        (w_tally * 3 > mesh_in["total"] * 2)
    require(tallied.cpu().numpy().tolist() == w_tally.tolist(),
            f"{label}: training_step tallies != host int64")
    require(block_ok.cpu().numpy().tolist() == w_block.tolist(),
            f"{label}: training_step block_ok != host")
    require(np.flatnonzero(~w_block).tolist() ==
            [FORGED_BLOCK, QUORUM_BLOCK], "grid: wrong failing blocks")
    leaves = mesh_in["leaves"]
    require(torch.equal(roots, merkle.roots(leaves)),
            f"{label}: training_step roots != single-device roots")
    for b in (0, MESH_BLOCKS - 1):
        host = leaves[b].cpu().numpy()
        require(roots[b].cpu().numpy().tobytes() == host_merkle.root(
            [host[i].tobytes() for i in range(MESH_LEAVES)]),
            f"{label}: block {b} root != host tree")
    require(launched["step"] == {"K6": shards, "K7": shards},
            f"{label}: row 10 launches {launched['step']}")

    # row 11
    res, calls = ctx["replay"], ctx["calls"]
    single = rp_ctx["backend"]
    for args, mask in calls:
        want = ed.verify_grouped_templated(
            *single.templated_args(*args)).cpu().numpy()[:len(mask)]
        require(mask.tolist() == want.tolist() and bool(mask.all()),
                f"{label}: mesh replay mask != single-device K1")
    require(res.app_hash == rp_ctx["app_hash"] and
            res.height == N_BLOCKS, f"{label}: mesh replay app hash != "
            f"single-device replay")
    require(launched["replay"].get("K1") == len(calls) * shards,
            f"{label}: replay K1 launches {launched['replay']} != "
            f"{len(calls)} windows x {shards} shards")
    require(ctx["grouped"].tolist() == calls[0][1].tolist(),
            f"{label}: verify_grouped mask != the templated window's")
    require(launched["grouped"] == {"K1": shards},
            f"{label}: verify_grouped launches {launched['grouped']}")
    log(f"[mesh] {label}: row 8 mask == K5 ({int(ctx['ok'].sum())} of "
        f"{len(ctx['ok'])} valid), tally {w_flat} == numpy int64; row 9 "
        f"== single-device roots; row 10 block_ok/tallies == host int64 "
        f"(blocks {FORGED_BLOCK} and {QUORUM_BLOCK} fail, block "
        f"{ZERO_POWER_BLOCK}'s zero-power forgery passes), roots == "
        f"single-device and host; row 11 {len(calls)} window masks == "
        f"single-device K1, app hash {res.app_hash.hex()} == single-device "
        f"replay, the first window host-assembled == templated; each "
        f"kernel launched once per shard")


# -- the main path: pipelined fast-sync at BASELINE config 3's scale -------

FS_BLOCKS = 100_000                     # BASELINE config 3: 160 windows
FS_PAIR2_BLOCKS = 50_000                # the second pair's depth: 80 windows
FS_STOP, FS_SHORT = 1000, 1500          # the restart check: stop, chain
FS_SAMPLE = 16                          # stored blocks decoded and checked
FS_TIMED_CALLS = 10                     # whole-call timings, each route
FS_FORGED = 100                         # forged lanes in the mask check


def device_busy(fn) -> tuple:
    """(fn(), wall seconds, device seconds of the kernels and copies it
    ran, {name: device ms}) from `torch.profiler`'s CUDA activity; the
    device seconds sum each event's time, so copies overlapping a kernel
    count twice and the idle share 1 - busy / wall is a floor."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    names = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
            names[e.key.split("(")[0].strip()[:40]] = us / 1e3
    return out, wall, sum(names.values()) / 1e3, names


def _fs_run(label: str, chain, be, pipelined: bool, n: int,
            store=None) -> dict:
    """One replay of the chain's first `n` blocks on a fresh state, under
    the profiler: the pipeline (with `store`, or none) or the serial
    loop."""
    from tendermint_tpu_torch.blockchain import replay as rp
    from tendermint_tpu_torch.proxy import ClientCreator
    from tendermint_tpu_torch.state.state import get_state
    from tendermint_tpu_torch.utils.db import MemDB
    state = get_state(MemDB(), chain.genesis)
    conns = ClientCreator("kvstore").new_app_conns()
    args = (state, conns.consensus, chain.blocks[:n], chain.commits[:n], be)
    if pipelined:
        run = lambda: rp.replay_pipelined(  # noqa: E731
            *args, window=WINDOW, store=store)
    else:
        run = lambda: rp.replay(*args, window=WINDOW)  # noqa: E731
    (res, k1), wall, busy, names = device_busy(lambda: _launched(run))
    steady = res.windows[1:]
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    blocks = sum(w.blocks for w in res.windows)
    msg = (f"[fastsync] {label}: {blocks} blocks, {res.sigs} sigs in "
           f"{wall:.3f} s: {blocks / wall:.1f} blocks/s, "
           f"{res.sigs / wall:.0f} sigs/s; steady window (mean of "
           f"{len(steady)}): prepare {mean([w.prepare_s for w in steady]):.4f}"
           f" s, verify {mean([w.verify_s for w in steady]):.4f} s, apply "
           f"{mean([w.apply_s for w in steady]):.4f} s; K1 launches "
           f"{k1.get('K1', 0)}; device busy {busy:.3f} s of {wall:.3f} "
           f"(idle share {1 - busy / wall:.4f}; ms by name {names})")
    if pipelined:
        b = res.busy_s
        msg += (f"; busy s: prepare {b['prepare']:.3f}, verify "
                f"{b['verify']:.3f}, apply {b['apply']:.3f} (sum "
                f"{sum(b.values()):.3f} = {res.overlap:.3f} x the wall "
                f"{res.wall_s:.3f}); windows redone {res.redone}")
    log(msg)
    return {"label": label, "res": res, "state": state, "wall": wall,
            "busy": busy, "names": names, "k1": k1.get("K1", 0), "n": n}


def phase_fastsync() -> dict:
    """BASELINE config 3 at its full 100,000 blocks x 100 validators: sign
    the chain (K3), then replay it on fresh states: the pipeline with a
    `BlockStore` on `MemDB` (each block stored before it is applied, the
    state saved after every block), then two pairs, in turn, of the
    pipeline without a store (the state saved once per window, as the
    benchmark does) and the serial loop: pipelined and serial on every
    block, then serial and pipelined on the first `FS_PAIR2_BLOCKS`, so
    the host's drift between runs shows; K2 builds the set's tables
    once, K1 runs once per window (dispatched ahead of the window's apply
    in the pipeline)."""
    import gc
    from tendermint_tpu_torch.blockchain import replay as rp
    from tendermint_tpu_torch.blockchain.store import BlockStore
    from tendermint_tpu_torch.crypto.backend import CudaBackend
    from tendermint_tpu_torch.types.part_set import PART_SIZE
    from tendermint_tpu_torch.utils.db import MemDB
    be = CudaBackend()
    t0 = time.perf_counter()
    chain = rp.build_chain(N_VALS, FS_BLOCKS, be)
    gc.collect()
    gc.freeze()         # millions of long-lived objects: keep GC off them
    log(f"[fastsync] fixture: {FS_BLOCKS} blocks x {N_VALS} validators, "
        f"{FS_BLOCKS * N_VALS} seen-commit signatures signed on the card "
        f"(K3), built in {time.perf_counter() - t0:.2f} s")
    store = BlockStore(MemDB())
    d = rp.PIPELINE_DEPTH
    runs = [_fs_run(f"pipelined ({d} windows ahead), BlockStore on MemDB",
                    chain, be, True, FS_BLOCKS, store)]
    # two pairs in turn, so the host's drift between runs shows; the
    # second on a prefix, to keep the smoke in its time
    for piped, n in ((True, FS_BLOCKS), (False, FS_BLOCKS),
                     (False, FS_PAIR2_BLOCKS), (True, FS_PAIR2_BLOCKS)):
        runs.append(_fs_run(f"pipelined ({d} windows ahead), no store"
                            if piped else "serial", chain, be, piped, n))
    sizes = [len(b.encode()) for b in chain.blocks]
    full = sum(n // PART_SIZE for n in sizes)
    log(f"[fastsync] blocks of {min(sizes)}-{max(sizes)} B: {full} full "
        f"{PART_SIZE}-byte parts (K4 hashes only those; the rest on the "
        f"host)")
    return {"backend": be, "chain": chain, "store": store, "runs": runs,
            "vals": chain.genesis.validator_set(),
            "full_parts": full}


def _tampered(commits: list, height: int, lane: int) -> list:
    from tendermint_tpu_torch.types.block import CompactCommit
    commits = list(commits)
    c = commits[height - 1]
    sigs = c.sigs.copy()
    sigs[lane, 7] ^= 0x01
    commits[height - 1] = CompactCommit(c.block_id, c.height_, c.round_,
                                        sigs, c.present)
    return commits


def check_fastsync(fs: dict) -> None:
    """Hold the fast-sync runs to the host kvstore run and to each other,
    the store to the fixture, the asynchronous K1 mask to the synchronous
    route's on every lane of a window and to the plain version on a
    sample, the tamper blame of the pipeline to the serial loop's, and a
    stopped-and-restarted pipeline to an uninterrupted one."""
    import numpy as np
    import torch
    from tendermint_tpu_torch.abci.app import create_app
    from tendermint_tpu_torch.blockchain import replay as rp
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.proxy import ClientCreator
    from tendermint_tpu_torch.state.state import get_state
    from tendermint_tpu_torch.types.validator import (CommitSignatureError,
                                                      window_commit_lanes)
    from tendermint_tpu_torch.utils.db import MemDB
    be, chain, store, vals = fs["backend"], fs["chain"], fs["store"], \
        fs["vals"]
    app = create_app("kvstore")
    host = [b""]
    for b in chain.blocks:
        for tx in b.txs:
            app.deliver_tx(tx)
        host.append(app.commit().data)
    tallies = None
    for run in fs["runs"]:
        res, n = run["res"], run["n"]
        require((res.height, res.app_hash) == (n, host[n]),
                f"{run['label']}: height {res.height} / app hash != host "
                f"kvstore run")
        t = [x for w in res.windows for x in w.tallied]
        require(len(t) == n and (tallies is None or t == tallies[:n]),
                f"{run['label']}: per-block tallies differ")
        tallies = tallies or t
        require(run["k1"] == n // WINDOW,
                f"{run['label']}: {run['k1']} K1 launches")
    require(store.height == FS_BLOCKS, f"store height {store.height}")
    rng = np.random.default_rng(SEED)
    for h in sorted(int(x) for x in rng.integers(1, FS_BLOCKS + 1,
                                                 FS_SAMPLE)):
        b, c = chain.blocks[h - 1], chain.commits[h - 1]
        got = store.load_block(h)
        require(got is not None and got.hash() == b.hash()
                and got.encode() == b.encode(), f"stored block {h}")
        require(store.load_block_meta(h).block_id.key() == c.block_id.key()
                and store.load_seen_commit(h).encode()
                == c.encode_commit(vals), f"stored commits of {h}")
    log(f"[fastsync] app hash {host[-1].hex()} == host kvstore run in all "
        f"{len(fs['runs'])} runs (at block {FS_PAIR2_BLOCKS} in the second "
        f"pair); per-block tallies equal; store at height "
        f"{store.height}, {FS_SAMPLE} sampled blocks and seen commits == "
        f"the fixture's")

    # the asynchronous K1 route against the synchronous one (pageable
    # copies and K1 on the current stream) on every lane of a window with
    # forged lanes, and against the plain version on a sample
    _, _, items = rp.prepare_window(chain.blocks[:WINDOW],
                                    chain.commits[:WINDOW], vals.hash(), be)
    templates, tmpl_idx, sigs, idxs, *_ = window_commit_lanes(
        vals, chain.genesis.chain_id, items)
    sigs = sigs.copy()
    forged = rng.choice(len(sigs), FS_FORGED, replace=False)
    sigs[forged, 33] ^= 0x02
    key, pubs = vals.set_key(), vals.pubs_matrix()
    lanes = (idxs, tmpl_idx, templates, sigs)

    def sync_route():
        args = be.templated_args(key, pubs, *lanes)
        return ed.verify_grouped_templated(*args).cpu().numpy()[:len(idxs)]

    def async_route():
        pre = be.prefetch_grouped_lanes(*lanes)
        return be.verify_grouped_templated_async(key, pubs, *pre[:4],
                                                 real_n=pre[4])()

    want = np.ones(len(idxs), bool)
    want[forged] = False
    got_sync, got_async = sync_route(), async_route()
    require(np.array_equal(got_async, got_sync)
            and np.array_equal(got_async, want),
            "async K1 mask != synchronous route on the window")
    sample = np.unique(np.concatenate([forged[:16], rng.choice(
        len(idxs), min(496, len(idxs)), replace=False)]))
    pargs = be.templated_args(key, pubs, idxs[sample], tmpl_idx[sample],
                              templates, sigs[sample])
    plain = ed.verify_grouped_templated_plain(*pargs).cpu().numpy()
    require(np.array_equal(plain[:len(sample)], got_async[sample]),
            "async K1 mask != plain on the sample")
    times = {"sync": [], "async": []}
    for _ in range(FS_TIMED_CALLS):
        for name, fn in (("sync", sync_route), ("async", async_route),
                         ("async", async_route), ("sync", sync_route)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    fs["whole_call_ms"] = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[fastsync] async K1 mask == synchronous route on all {len(idxs)} "
        f"lanes of a window ({FS_FORGED} forged) and == plain on "
        f"{len(sample)}; whole call (stage, copy, K1, copy back), median "
        f"of {2 * FS_TIMED_CALLS} each, ms: synchronous route "
        f"{fs['whole_call_ms']['sync']:.3f} (pageable copies, current "
        f"stream), asynchronous {fs['whole_call_ms']['async']:.3f} (pinned "
        f"staging, the backend's stream)")

    # tamper blame, pipeline against the serial loop, on the first 2,500
    bad = _tampered(chain.commits[:N_BLOCKS], TAMPER_HEIGHT, TAMPER_LANE)
    blame = []
    for run in (rp.replay, rp.replay_pipelined):
        st = get_state(MemDB(), chain.genesis)
        try:
            run(st, ClientCreator("kvstore").new_app_conns().consensus,
                chain.blocks[:N_BLOCKS], bad, be, window=WINDOW)
        except CommitSignatureError as e:
            blame.append((e.height, e.lane, st.last_block_height))
        else:
            raise AssertionError(f"{run.__name__}: tampered lane verified")
    require(blame[0] == blame[1] == (TAMPER_HEIGHT, TAMPER_LANE,
                                     (TAMPER_HEIGHT - 1) // WINDOW * WINDOW),
            f"tamper blame: serial {blame[0]}, pipelined {blame[1]}")
    log(f"[fastsync] tampered lane blamed on height {TAMPER_HEIGHT} lane "
        f"{TAMPER_LANE} by the serial loop and the pipeline alike, both "
        f"stopped at height {blame[0][2]}")
    check_restart(be, chain, host[FS_SHORT])


def check_restart(be, chain, want_hash: bytes) -> None:
    """Stop a pipelined run with a `BlockStore` on `SQLiteDB` mid-window,
    store the next block as a crash after the store's save would, reopen
    the store and the state, handshake a fresh app and resume: the app
    hash must equal the host kvstore run's over the short chain."""
    import tempfile
    from tendermint_tpu_torch.blockchain import replay as rp
    from tendermint_tpu_torch.blockchain.store import BlockStore
    from tendermint_tpu_torch.consensus.replay import Handshaker
    from tendermint_tpu_torch.proxy import ClientCreator
    from tendermint_tpu_torch.state.state import get_state
    from tendermint_tpu_torch.utils.db import SQLiteDB
    blocks, commits = chain.blocks[:FS_SHORT], chain.commits[:FS_SHORT]
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/node.db"
        db = SQLiteDB(path)
        st, store = get_state(db, chain.genesis), BlockStore(db)
        res = rp.replay_pipelined(
            st, ClientCreator("kvstore").new_app_conns().consensus, blocks,
            commits, be, window=WINDOW, store=store,
            stop_when=lambda: st.last_block_height == FS_STOP)
        require(res.stopped and store.height == FS_STOP,
                f"stop at {res.height}, store {store.height}")
        b = blocks[FS_STOP]
        store.save_block(b, b.make_part_set(), commits[FS_STOP],
                         validators=st.validators)
        db.close()
        db = SQLiteDB(path)
        st, store = get_state(db, chain.genesis), BlockStore(db)
        conns = ClientCreator("kvstore").new_app_conns()
        hs = Handshaker(st, store)
        t0 = time.perf_counter()
        hs.handshake(conns)
        hs_s = time.perf_counter() - t0
        h = st.last_block_height
        require((h, hs.n_blocks) == (FS_STOP + 1, FS_STOP + 1),
                f"handshake: state {h}, {hs.n_blocks} blocks replayed")
        res = rp.replay_pipelined(st, conns.consensus, blocks[h:],
                                  commits[h:], be, window=WINDOW, store=store)
        db.close()
    require((st.last_block_height, st.app_hash) == (FS_SHORT, want_hash),
            "restarted run's app hash != host kvstore run")
    log(f"[fastsync] restart: pipelined run on SQLiteDB stopped at "
        f"{FS_STOP} (mid-window), block {FS_STOP + 1} stored as a crash "
        f"leaves it, reopened; the handshake replayed {hs.n_blocks - 1} "
        f"blocks into a fresh app and applied the stored one in "
        f"{hs_s:.2f} s; "
        f"resumed to {FS_SHORT}: app hash {st.app_hash.hex()} == host "
        f"kvstore run")


# -- the main path: the light client's multi-chain grid (config 4) --------

LIGHT_CHAINS, LIGHT_HEADERS, LIGHT_VALS = 8, 131_072, 8
LIGHT_SIGN_HEADERS = 8192               # 65,536 lanes per K3 call
LIGHT_TAMPER = (5, 77_777, 3)           # chain, header index, lane
LC_HEADERS, LC_CHANGE, LC_GROW = 6, 3, 2   # the follower's short chain


def _light_set(c: int, n: int) -> tuple:
    """(validator set, seeds in set order) of chain c's n validators."""
    from tendermint_tpu_torch.crypto import pure_ed25519 as ref
    from tendermint_tpu_torch.types.keys import PubKey
    from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
    seeds = [bytes([0x4C, c + 1, i + 1]) + b"\0" * 29 for i in range(n)]
    by_pub = {ref.pubkey_from_seed(s): s for s in seeds}
    vs = ValidatorSet([Validator(PubKey(p), 10) for p in by_pub])
    return vs, [by_pub[v.pub_key.bytes_] for v in vs.validators]


def light_chains(be, n_chains: int, headers: int, n_vals: int):
    """BASELINE config 4's grid (`bench.py` config 4): per chain, a set of
    n_vals validators and `headers` header+commit pairs — seeded random
    block and part-set hashes, each commit signed by every validator on
    the card (K3) — as `ChainBatch`es of (BlockID, height,
    CompactCommit)."""
    import numpy as np
    from tendermint_tpu_torch.crypto import pure_ed25519 as ref
    from tendermint_tpu_torch.light import ChainBatch
    from tendermint_tpu_torch.types import BlockID, CompactCommit, canonical
    from tendermint_tpu_torch.types.part_set import PartSetHeader
    chains = []
    for c in range(n_chains):
        cid = f"light-{c}"
        vs, seeds = _light_set(c, n_vals)
        rng = np.random.default_rng(SEED + c)
        hashes = rng.integers(0, 256, (headers, 2, 32), dtype=np.uint8)
        templates = canonical.batch_sign_bytes(
            cid, np.full(headers, canonical.TYPE_PRECOMMIT, np.int64),
            np.arange(1, headers + 1, dtype=np.int64),
            np.zeros(headers, np.int64), hashes[:, 0], hashes[:, 1],
            np.ones(headers, np.int64))
        sigs = np.zeros((headers * n_vals, 64), np.uint8)
        step = min(headers, LIGHT_SIGN_HEADERS)
        vi = np.tile(np.arange(n_vals, dtype=np.int32), step)
        ti = np.repeat(np.arange(step, dtype=np.int32), n_vals)
        for off in range(0, headers, step):
            k = (min(off + step, headers) - off) * n_vals
            sigs[off * n_vals:off * n_vals + k] = be.sign_grouped_templated(
                seeds, vi[:k], ti[:k], templates[off:off + step])
        for i in rng.integers(0, len(sigs), 4):
            i = int(i)
            require(ref.verify(vs.validators[i % n_vals].pub_key.bytes_,
                               templates[i // n_vals].tobytes(),
                               sigs[i].tobytes()),
                    f"{cid}: fixture lane {i} does not verify")
        sigs = sigs.reshape(headers, n_vals, 64)
        present = np.ones(n_vals, bool)
        items = []
        for h in range(headers):
            bid = BlockID(hashes[h, 0].tobytes(),
                          PartSetHeader(1, hashes[h, 1].tobytes()))
            items.append((bid, h + 1,
                          CompactCommit(bid, h + 1, 0, sigs[h], present)))
        chains.append(ChainBatch(cid, vs, items))
    return chains


def follower_chain(be):
    """A short header chain for `LightClient.update`: LC_HEADERS headers
    of chain 0's set, which grows by LC_GROW validators at LC_CHANGE (the
    two-set rule carries the client across), commits signed by K3.
    Returns (chain_id, [(header, commit, its set)], genesis set)."""
    import numpy as np
    from tendermint_tpu_torch.blockchain import replay as rp
    from tendermint_tpu_torch.types import (CompactCommit, ZERO_BLOCK_ID,
                                            canonical)
    old, old_seeds = _light_set(0, LIGHT_VALS)
    grown, grown_seeds = _light_set(0, LIGHT_VALS + LC_GROW)
    cid, out, last, prev = "light-0", [], ZERO_BLOCK_ID, old
    for h in range(1, LC_HEADERS + 1):
        vs, seeds = (grown, grown_seeds) if h > LC_CHANGE else \
            (old, old_seeds)
        block, bid = rp.make_block(cid, h, [b"lc%d" % h], last, prev.size(),
                                   vs.hash(), b"")
        tmpl = canonical.sign_bytes(cid, canonical.TYPE_PRECOMMIT, h, 0,
                                    block_hash=bid.hash,
                                    parts_hash=bid.parts.hash,
                                    parts_total=bid.parts.total)
        sigs = be.sign_grouped_templated(
            seeds, np.arange(vs.size(), dtype=np.int32),
            np.zeros(vs.size(), np.int32),
            np.frombuffer(tmpl, np.uint8).reshape(1, -1))
        out.append((block.header, CompactCommit(bid, h, 0, sigs,
                                                np.ones(vs.size(), bool)),
                    vs))
        last, prev = bid, vs
    return cid, out, old


def follow(plane, cid: str, headers: list, genesis_set) -> list:
    """Each header's verdict from a `LightClient` over `plane`: its
    trusted height, or the error's type and message."""
    from tendermint_tpu_torch.light import (LightClient, SignedHeader,
                                            TrustedState)
    lc = LightClient(cid, TrustedState(0, b"", genesis_set), plane)
    out = []
    for header, commit, vs in headers:
        try:
            out.append(lc.update(SignedHeader(header, commit), vs).height)
        except ValueError as e:
            out.append((type(e).__name__, str(e)))
    return out


def phase_light() -> dict:
    """BASELINE config 4 at full scale: 8 chains x 131,072 header+commit
    pairs x 8 validators (8,388,608 lanes) signed by K3, verified twice
    through `verify_chains_batched` on a `BatchPlane(CudaBackend())` —
    the first pass builds each chain's tables (K2), both run one K1 call
    of 1,048,576 lanes per chain — then a `LightClient` follows a short
    chain through a change of validator set (K1 templated on the
    unchanged set, with per-lane keys across the change)."""
    import gc
    from tendermint_tpu_torch.batchplane import BatchPlane
    from tendermint_tpu_torch.crypto.backend import CudaBackend
    from tendermint_tpu_torch.light import verify_chains_batched
    from tendermint_tpu_torch.types.validator import window_commit_lanes
    be = CudaBackend()
    t0 = time.perf_counter()
    chains = light_chains(be, LIGHT_CHAINS, LIGHT_HEADERS, LIGHT_VALS)
    gc.collect()
    gc.freeze()
    pairs = LIGHT_CHAINS * LIGHT_HEADERS
    sigs = pairs * LIGHT_VALS
    log(f"[light] fixture: {LIGHT_CHAINS} chains x {LIGHT_HEADERS} headers "
        f"x {LIGHT_VALS} validators, {sigs} signatures signed on the card "
        f"(K3), built in {time.perf_counter() - t0:.2f} s")
    plane = BatchPlane(be)
    passes = []
    launches = {}
    for name in ("first pass (tables built)", "second pass"):
        t0 = time.perf_counter()
        _, k = _launched(lambda: verify_chains_batched(chains, plane))
        dt = time.perf_counter() - t0
        passes.append(dt)
        for key, n in k.items():
            launches[key] = launches.get(key, 0) + n
        log(f"[light] {name}: {pairs} pairs, {sigs} sigs in {dt:.3f} s: "
            f"{pairs / dt:.0f} pairs/s, {sigs / dt:.0f} sigs/s; launches "
            f"{k}")
    c0 = chains[0]
    t0 = time.perf_counter()
    window_commit_lanes(c0.validators, c0.chain_id, c0.items)
    lanes_s = time.perf_counter() - t0
    log(f"[light] one chain's host lane assembly (window_commit_lanes over "
        f"{LIGHT_HEADERS} CompactCommits): {lanes_s:.3f} s of the second "
        f"pass's {passes[1] / LIGHT_CHAINS:.3f} s per chain")
    cid, headers, genesis_set = follower_chain(be)
    verdicts = follow(plane, cid, headers, genesis_set)
    plane.stop()
    log(f"[light] LightClient over the card: {verdicts}")
    return {"backend": be, "chains": chains, "passes": passes,
            "grid_k1": launches.get("K1", 0), "follower": (cid, headers,
                                                          genesis_set),
            "verdicts": verdicts}


def check_light(lt: dict) -> None:
    """A tampered lane in one chain of the grid raises
    `CommitSignatureError` naming its height and lane; the follower's
    verdicts equal the golden verifier's, the tampered follower's too."""
    from tendermint_tpu_torch.batchplane import BatchPlane
    from tendermint_tpu_torch.crypto.backend import PythonBackend
    from tendermint_tpu_torch.light import ChainBatch, verify_chains_batched
    from tendermint_tpu_torch.types.validator import CommitSignatureError
    require(lt["grid_k1"] == 2 * LIGHT_CHAINS,
            f"{lt['grid_k1']} K1 launches for two passes of the grid")
    c, idx, lane = LIGHT_TAMPER
    ch = lt["chains"][c]
    items = list(ch.items)
    bid, h, cc = items[idx]
    items[idx] = (bid, h, _tampered([cc], 1, lane)[0])
    plane = BatchPlane(lt["backend"])
    try:
        verify_chains_batched([lt["chains"][0],
                               ChainBatch(ch.chain_id, ch.validators, items)],
                              plane)
    except CommitSignatureError as e:
        require((e.height, e.lane) == (idx + 1, lane),
                f"grid tamper blamed height {e.height} lane {e.lane}")
        log(f"[light] tampered lane in {ch.chain_id} rejected: {e}")
    else:
        raise AssertionError("tampered light chain verified")
    finally:
        plane.stop()
    cid, headers, genesis_set = lt["follower"]
    want_heights = list(range(1, LC_HEADERS + 1))
    require(lt["verdicts"] == want_heights,
            f"follower verdicts {lt['verdicts']}")
    bad = list(headers)
    header, cc, vs = bad[LC_CHANGE + 1]
    bad[LC_CHANGE + 1] = (header, _tampered([cc], 1, 1)[0], vs)
    golden = BatchPlane(PythonBackend())
    card = BatchPlane(lt["backend"])
    try:
        got = [follow(p, cid, hs, genesis_set)
               for p in (golden, card) for hs in (headers, bad)]
    finally:
        golden.stop()
        card.stop()
    require(got[0] == got[2] == want_heights and got[1] == got[3]
            and got[1][LC_CHANGE + 1][0] == "CommitSignatureError",
            f"follower verdicts: golden {got[:2]}, card {got[2:]}")
    log(f"[light] follower through the set change at {LC_CHANGE + 1} "
        f"(two-set rule): card verdicts == golden {got[0]}; tampered "
        f"{got[1]}")


# -- the main path: the consensus core (a 100-validator net) -------------

CONS_VALS, CONS_HEIGHTS, CONS_TXS, CONS_TX_BYTES = 100, 5, 300, 64
CONS_DEADLINE_S = 240.0                 # the net must commit by then
CONS_FORGE_HEIGHT = 3                   # the forged vote's height
RESTART_VALS, RESTART_HEIGHTS, RESTART_MORE = 4, 3, 2   # config 1's testnet
RESTART_DEADLINE_S = 120.0
# the JAX package's 100-validator live rig timeouts
# (tendermint_tpu/scenarios/live.py:51-55), on top of test_config()
LIVE_TIMEOUTS_100 = {
    "timeout_propose": 8.0, "timeout_propose_delta": 2.0,
    "timeout_prevote": 4.0, "timeout_prevote_delta": 1.0,
    "timeout_precommit": 4.0, "timeout_precommit_delta": 1.0,
}


def _recording_backend(device="cuda"):
    """A `CudaBackend` that keeps each K1 call's inputs and mask (per-lane
    keys: `verify_grouped`; templated: `verify_grouped_templated`), so the
    phase can hold every call to the plain version afterwards."""
    import threading
    import numpy as np
    from tendermint_tpu_torch.crypto.backend import CudaBackend

    class RecordingBackend(CudaBackend):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = []
            self._rec = threading.Lock()

        def _record(self, kind, set_key, val_pubs, lanes, out):
            if len(out):                  # an empty call launches nothing
                with self._rec:
                    self.calls.append((kind, set_key, val_pubs, tuple(
                        np.array(a) for a in lanes), out.copy()))
            return out

        def verify_grouped(self, set_key, val_pubs, val_idx, msgs, sigs):
            return self._record("grouped", set_key, val_pubs,
                                (val_idx, msgs, sigs),
                                super().verify_grouped(
                                    set_key, val_pubs, val_idx, msgs, sigs))

        def verify_grouped_templated(self, set_key, val_pubs, val_idx,
                                     tmpl_idx, templates, sigs):
            return self._record(
                "templated", set_key, val_pubs,
                (val_idx, tmpl_idx, templates, sigs),
                super().verify_grouped_templated(
                    set_key, val_pubs, val_idx, tmpl_idx, templates, sigs))

    return RecordingBackend(device)


class _HostTimes:
    """Thread CPU seconds, wall seconds and calls per kind of host work,
    summed over every thread.  `timed(kind, fn)` wraps `fn`; a span
    nested in another counts in both."""

    def __init__(self, *kinds):
        import threading
        self.t = {k: [0.0, 0.0, 0] for k in kinds}
        self._lock = threading.Lock()

    def timed(self, kind: str, fn):
        def run(*a, **kw):
            c0, w0 = time.thread_time(), time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                c, w = time.thread_time() - c0, time.perf_counter() - w0
                with self._lock:
                    t = self.t[kind]
                    t[0] += c
                    t[1] += w
                    t[2] += 1
        return run

    def line(self) -> str:
        return "; ".join(
            f"{k} {n} calls, CPU {c:.3f} s ({c / max(n, 1) * 1e3:.3f} ms "
            f"each), wall {w:.3f} s" for k, (c, w, n) in self.t.items())


def _cons_config():
    from tendermint_tpu_torch.config import test_config
    cfg = test_config().consensus
    for k, v in LIVE_TIMEOUTS_100.items():
        setattr(cfg, k, v)
    return cfg


def _cons_keys(n: int, seed: int) -> list:
    from tendermint_tpu_torch.types import PrivKey, PrivValidator
    return [PrivValidator(PrivKey(hashlib.sha256(
        b"%d/%d" % (seed, i)).digest())) for i in range(n)]


def _genesis(chain_id: str, privs):
    from tendermint_tpu_torch.types import GenesisDoc, GenesisValidator
    return GenesisDoc(chain_id=chain_id, validators=[
        GenesisValidator(p.pub_key.bytes_, 10) for p in privs],
        genesis_time_ns=1_000_000_000)


def _wire(nodes: list, deliver=None) -> None:
    """Each node's broadcasts straight into every other node's feed
    methods, the same objects to every queue (no copy); `deliver(me, msg,
    others)`, when given, delivers instead for the messages it claims."""
    from tendermint_tpu_torch.consensus import messages as M

    def make_cb(me):
        others = [o for o in nodes if o is not me]

        def cb(msg):
            if deliver is not None and deliver(me, msg, others):
                return
            if isinstance(msg, M.VoteMessage):
                for o in others:
                    o.add_vote(msg.vote, peer_id="net")
            elif isinstance(msg, M.ProposalMessage):
                for o in others:
                    o.set_proposal(msg.proposal, peer_id="net")
            elif isinstance(msg, M.BlockPartMessage):
                for o in others:
                    o.add_proposal_block_part(msg.height, msg.round,
                                              msg.part, peer_id="net")
        return cb

    for cs in nodes:
        cs.broadcast_cb = make_cb(cs)


def _gossip(nodes: list) -> None:
    """Hand every node what each other node holds of its current height:
    the proposal, its block parts and the votes of every round.  It
    stands in for the consensus reactor's catchup gossip (not ported),
    which recovers the messages a node processed before a stop and its
    peers never did."""
    for src in nodes:
        rs = src.get_round_state()
        others = [o for o in nodes if o is not src]
        for o in others:
            if rs.proposal is not None:
                o.set_proposal(rs.proposal, peer_id="gossip")
            parts = rs.proposal_block_parts
            for i in range(parts.total if parts is not None else 0):
                if parts.has_part(i):
                    o.add_proposal_block_part(rs.height, rs.round,
                                              parts.get_part(i),
                                              peer_id="gossip")
        for r in range(rs.round + 1):
            for vs in (rs.votes.prevotes(r), rs.votes.precommits(r)):
                for v in (vs.get_by_index(i) for i in range(vs.size())):
                    if v is not None:
                        for o in others:
                            o.add_vote(v, peer_id="gossip")


def _stop_all(nodes: list) -> list:
    """Stop every node at once, each `stop()` on a thread of its own (a
    node's stop waits for its receive routine to reach the end of its
    current batch); returns the plane faults the stops raised."""
    import threading
    faults = []

    def stop(cs):
        try:
            cs.stop()
        except Exception as e:            # every node stops; then fail
            faults.append(e)

    threads = [threading.Thread(target=stop, args=(cs,)) for cs in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return faults


def _wait_heights(nodes: list, height: int, deadline_s: float,
                  what: str) -> float:
    """Seconds until every node's store holds `height`; fails past the
    deadline or on a node's plane fault."""
    t0 = time.perf_counter()
    while min(cs.block_store.height for cs in nodes) < height:
        for cs in nodes:
            if cs.fault is not None:
                raise AssertionError(f"{what}: plane fault {cs.fault!r}")
        require(time.perf_counter() - t0 < deadline_s,
                f"{what}: (height, round, step) "
                f"{sorted((cs.height, cs.round, cs.step) for cs in nodes)} "
                f"after {deadline_s} s")
        time.sleep(0.02)
    return time.perf_counter() - t0


def _kv_txs(n: int) -> list:
    return [(b"cons%05d=" % i).ljust(CONS_TX_BYTES, b"v") for i in range(n)]


def _host_app_hashes(blocks) -> list:
    """A host kvstore run over the blocks' txs: the app hash after each."""
    from tendermint_tpu_torch.abci.app import create_app
    app, out = create_app("kvstore"), []
    for b in blocks:
        for tx in b.txs:
            app.deliver_tx(tx)
        out.append(app.commit().data)
    return out


def _node(cfg, gen, plane, priv, db=None, wal_path: str = ""):
    from tendermint_tpu_torch.blockchain.store import BlockStore
    from tendermint_tpu_torch.config import MempoolConfig
    from tendermint_tpu_torch.consensus.replay import Handshaker
    from tendermint_tpu_torch.consensus.state import ConsensusState
    from tendermint_tpu_torch.mempool.mempool import Mempool
    from tendermint_tpu_torch.proxy import ClientCreator
    from tendermint_tpu_torch.state.state import get_state
    from tendermint_tpu_torch.utils.db import MemDB
    conns = ClientCreator("kvstore").new_app_conns()
    state_db = db if db is not None else MemDB()
    store = BlockStore(db if db is not None else MemDB())
    state = get_state(state_db, gen)
    Handshaker(state, store).handshake(conns)
    return ConsensusState(cfg, state, conns.consensus, store,
                          Mempool(conns.mempool, MempoolConfig(),
                                  plane=plane), plane, priv_validator=priv,
                          wal_path=wal_path)


def phase_consensus(be=None) -> dict:
    """The consensus core on the card: 100 in-process validators of equal
    power (kvstore, `MemDB` stores) wired broadcast-to-feed, one
    `BatchPlane` over a recording `CudaBackend` shared by all, each vote
    burst pre-verified on K1 at the plane's consensus class and each
    block's LastCommit verified on templated K1 at its fast-sync class,
    until every node has committed 5 heights; a forged vote (one flipped
    signature bit) goes into every queue during a burst.  Then the restart
    of BASELINE config 1's 4-validator testnet from WALs and `SQLiteDB`
    stores, and `Playback` over one node's WAL."""
    from tendermint_tpu_torch.batchplane import BatchPlane
    from tendermint_tpu_torch.consensus import messages as M
    from tendermint_tpu_torch.crypto import pure_ed25519 as ref
    from tendermint_tpu_torch.types import TYPE_PREVOTE, Vote, ZERO_BLOCK_ID
    from tendermint_tpu_torch.types import events as ev
    from tendermint_tpu_torch.types import keys
    from tendermint_tpu_torch.types.vote import batch_verify_vote_sigs
    be = be or _recording_backend()
    t0 = time.perf_counter()
    privs = _cons_keys(CONS_VALS, SEED)
    gen = _genesis("consensus-smoke", privs)
    vals = gen.validator_set()
    # the node's boot: the set's comb tables (K2), then two grouped calls
    # standing in for the JAX node's pre-warm, which the micro-batch
    # threshold's two-sample rule needs
    be.tables(vals.set_key(), vals.pubs_matrix())
    warm = [Vote(p.address, vals.index_of(p.address), 1, 99, TYPE_PREVOTE,
                 ZERO_BLOCK_ID) for p in privs[:16]]
    warm = [Vote(**{**v.__dict__, "signature": p.priv_key.sign(
        v.sign_bytes(gen.chain_id))}) for v, p in zip(warm, privs)]

    class _Direct:                     # the backend itself, not the plane
        def verify_grouped(self, *a, producer, klass):
            return be.verify_grouped(*a)

    for _ in range(2):
        require(bool(batch_verify_vote_sigs(gen.chain_id, vals, warm,
                                            _Direct()).all()),
                "pre-warm: a valid vote failed")
    flushes = []
    plane = BatchPlane(be, on_flush=lambda kind, reason, lanes, prods:
                       flushes.append((kind, reason, lanes,
                                       tuple(sorted(prods)))))
    cfg = _cons_config()
    nodes = [_node(cfg, gen, plane, p) for p in privs]
    setup_s = time.perf_counter() - t0
    log(f"[consensus] micro-batch threshold after the pre-warm: "
        f"{nodes[0]._microbatch_threshold()} votes ({be.step_count} "
        f"synchronous grouped calls)")

    # a nil prevote of validator 0 at the forge height, signed, then one
    # signature bit flipped
    p0 = privs[0]
    forged = Vote(p0.address, vals.index_of(p0.address), CONS_FORGE_HEIGHT,
                  0, TYPE_PREVOTE, ZERO_BLOCK_ID)
    sig = bytearray(p0.priv_key.sign(forged.sign_bytes(gen.chain_id)))
    sig[17] ^= 0x08
    forged = Vote(**{**forged.__dict__, "signature": bytes(sig)})
    injected = []

    def deliver(me, msg, others):
        """The forged vote rides right behind node 0's real prevote at the
        forge height, into every node's queue (node 0's own too)."""
        v = getattr(msg, "vote", None)
        if (me is not nodes[0] or not isinstance(msg, M.VoteMessage) or
                (v.height, v.round, v.type) !=
                (CONS_FORGE_HEIGHT, 0, TYPE_PREVOTE) or injected):
            return False
        injected.append(time.perf_counter())
        for o in others:
            o.add_vote(v, peer_id="net")
            o.add_vote(forged, peer_id="forger")
        me.add_vote(forged, peer_id="forger")
        return True

    _wire(nodes, deliver)
    # the host's work over the net's run: scalar verifies (the memo's
    # misses reach `pure_ed25519.verify`), signing (votes and proposals)
    # and vote accounting (`_try_add_vote`, its scalar verifies included)
    host = _HostTimes("verify", "sign", "accounting")
    counted_forged, evidence, commits = [], [], {}
    received = [[0, 0] for _ in nodes]
    for i, cs in enumerate(nodes):
        cs.evsw.subscribe("smoke", ev.VOTE, lambda v, i=i: (
            counted_forged.append(i) if v.signature == forged.signature
            else None))
        cs.evsw.subscribe("smoke", "EvidenceDoubleSign", evidence.append)
        cs.evsw.subscribe("smoke", ev.NEW_BLOCK, lambda b, i=i: (
            commits.setdefault(b.height, []).append(
                (i, time.perf_counter()))))

        def counted(vote, peer_id, preverified=False,
                    _f=host.timed("accounting", cs._try_add_vote),
                    _c=received[i]):
            _c[preverified] += 1
            return _f(vote, peer_id, preverified=preverified)

        cs._try_add_vote = counted
    txs = _kv_txs(CONS_TXS)
    for cs in nodes:
        for tx in txs:
            cs.mempool.check_tx(tx)
    memo0 = keys._verify_memo.cache_info().misses
    scalar_fns = (ref.verify, ref.sign)
    ref.verify = host.timed("verify", ref.verify)
    ref.sign = host.timed("sign", ref.sign)
    cpu0, t_start = time.process_time(), time.perf_counter()
    for cs in nodes:
        cs.start()
    try:
        wall = _wait_heights(nodes, CONS_HEIGHTS, CONS_DEADLINE_S,
                             "100-validator net")
    finally:
        t_stop = time.perf_counter()
        faults = _stop_all(nodes)
        stop_s = time.perf_counter() - t_stop
        plane.drain()
        plane.stop()
        run_s = time.perf_counter() - t_start
        cpu_s = time.process_time() - cpu0
        ref.verify, ref.sign = scalar_fns
    require(not faults, f"plane faults on stop: {faults[:3]}")
    scalar = keys._verify_memo.cache_info().misses - memo0
    log(f"[consensus] {CONS_VALS} validators committed {CONS_HEIGHTS} "
        f"heights in {wall:.3f} s ({CONS_HEIGHTS / wall:.3f} heights/s); "
        f"setup (keys, K2, pre-warm, {CONS_VALS} nodes) {setup_s:.2f} s")
    log(f"[consensus] host over the net's run (start to stop, "
        f"{run_s:.3f} s wall, of which the stop {stop_s:.3f} s; process "
        f"CPU {cpu_s:.3f} s): {host.line()}")
    net_calls = len(be.calls)
    restart = phase_restart(be)
    return {"backend": be, "nodes": nodes, "txs": txs, "wall": wall,
            "t_start": t_start, "commits": commits, "received": received,
            "scalar": scalar, "flushes": flushes, "net_calls": net_calls,
            "forged": forged, "injected": injected,
            "counted_forged": counted_forged, "evidence": evidence,
            "host": host.t, "run_s": run_s, "cpu_s": cpu_s,
            "restart": restart}


def phase_restart(be) -> dict:
    """BASELINE config 1's 4-validator testnet with WALs on disk and one
    `SQLiteDB` per node runs 3 heights; all stop, reopen their store and
    state, handshake a fresh kvstore app and restart from their WALs
    (each node's seen commit re-verified on K1 by `add_votes_batched`),
    then commit 2 more heights; `Playback` replays node 0's WAL."""
    import tempfile
    from tendermint_tpu_torch.batchplane import BatchPlane
    from tendermint_tpu_torch.consensus.replay import Playback
    from tendermint_tpu_torch.utils.db import SQLiteDB
    from tendermint_tpu_torch.types import PrivValidator
    cfg = _cons_config()
    privs = _cons_keys(RESTART_VALS, SEED + 1)
    gen = _genesis("restart-smoke", privs)
    plane = BatchPlane(be)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        def open_net():
            nodes, dbs = [], []
            for i in range(RESTART_VALS):
                pv_path = f"{d}/pv{i}.json"
                pv = PrivValidator.load(pv_path) if out else \
                    PrivValidator(privs[i].priv_key, pv_path)
                db = SQLiteDB(f"{d}/node{i}.db")
                dbs.append(db)
                nodes.append(_node(cfg, gen, plane, pv, db=db,
                                   wal_path=f"{d}/cs{i}.wal"))
            _wire(nodes)
            return nodes, dbs

        def run(nodes, dbs, height, what):
            for cs in nodes:
                cs.start()
            _gossip(nodes)
            try:
                _wait_heights(nodes, height, RESTART_DEADLINE_S, what)
            finally:
                faults = _stop_all(nodes)
                for db in dbs:
                    db.close()
            require(not faults, f"{what}: plane faults on stop: "
                    f"{faults[:3]}")

        nodes, dbs = open_net()
        for cs in nodes:
            cs.mempool.check_tx(b"restart=before")
        run(nodes, dbs, RESTART_HEIGHTS, "restart net, first run")
        before = [[cs.block_store.load_block(h).hash()
                   for h in range(1, RESTART_HEIGHTS + 1)] for cs in nodes]
        out["stopped_at"] = [cs.block_store.height for cs in nodes]
        k1 = kernels_k1()
        nodes, dbs = open_net()            # K1: each seen commit
        out["restart_k1"] = kernels_k1() - k1
        for cs in nodes:
            cs.mempool.check_tx(b"restart=after")
        top = max(out["stopped_at"]) + RESTART_MORE
        run(nodes, dbs, top, "restart net, after the restart")
        out["hashes"] = [[cs.block_store.load_block(h).hash()
                          for h in range(1, top + 1)] for cs in nodes]
        out["before"] = before
        out["blocks"] = [nodes[0].block_store.load_block(h)
                         for h in range(1, top + 1)]
        out["app_hashes"] = [cs.state.app_hash for cs in nodes]
        out["heights"] = [cs.state.last_block_height for cs in nodes]
        out["blocks_by_node"] = {
            i: [cs.block_store.load_block(h)
                for h in range(1, cs.state.last_block_height + 1)]
            for i, cs in enumerate(nodes)}
        last = nodes[0].block_store.height
        pb = Playback(gen, f"{d}/cs0.wal", plane, cfg=cfg)
        pb.run_until(last)
        out["playback"] = [pb.cs.block_store.load_block(h).hash()
                           for h in range(1, pb.cs.block_store.height + 1)]
        out["playback_app_hash"] = pb.cs.state.app_hash
        out["node0"] = [b.hash() for b in out["blocks_by_node"][0]]
        out["node0_app_hash"] = nodes[0].state.app_hash
    plane.stop()
    return out


def kernels_k1() -> int:
    from tendermint_tpu_torch.ops import kernels
    return kernels.LAUNCHES["verify_grouped"]


def _plain_k1(be, calls: list) -> tuple:
    """Every recorded K1 call held to the plain version on the card: the
    calls' lanes concatenated per kind and key set (templated calls with
    their template indices rebased), run in 65,536-lane slices.  Returns
    (lanes checked, mismatching lanes, plain seconds)."""
    import numpy as np
    import torch
    from tendermint_tpu_torch.ops import ed25519 as ed
    t0 = time.perf_counter()
    checked = bad = 0
    groups = {}
    for c in calls:
        groups.setdefault((c[0], c[1]), []).append(c)
    base = ed.base_table(be.device)
    step = 65536
    for (kind, set_key), cs in groups.items():
        val_pubs = cs[0][2]
        tbl, ok, _, vp = be.tables(set_key, val_pubs)
        got = np.concatenate([c[4] for c in cs])
        if kind == "grouped":
            vi, msgs, sigs = (np.concatenate([c[3][k] for c in cs])
                              for k in range(3))
            want = []
            for lo in range(0, len(vi), step):
                idx = vi[lo:lo + step]
                want.append(ed.verify_grouped_plain(
                    tbl, ok, *(be._t(a) for a in (
                        idx, val_pubs[idx], msgs[lo:lo + step],
                        sigs[lo:lo + step])), base).cpu().numpy())
        else:
            offs = np.cumsum([0] + [len(c[3][2]) for c in cs[:-1]])
            vi = np.concatenate([c[3][0] for c in cs])
            ti = np.concatenate([c[3][1] + o for c, o in zip(cs, offs)])
            tm = np.concatenate([c[3][2] for c in cs])
            sg = np.concatenate([c[3][3] for c in cs])
            want = []
            for lo in range(0, len(vi), step):
                want.append(ed.verify_grouped_templated_plain(
                    tbl, ok, vp, be._t(vi[lo:lo + step]),
                    be._t(ti[lo:lo + step]), be._t(tm),
                    be._t(sg[lo:lo + step]), base).cpu().numpy())
        want = np.concatenate(want)
        checked += len(got)
        bad += int((got != want).sum())
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return checked, bad, time.perf_counter() - t0


def _k1_call(be, call) -> tuple:
    """One recorded K1 call as the backend launched it: (kernel, plain
    version, device arguments with the lanes padded to their bucket, the
    (bytes, operations) of its real lanes as a thunk)."""
    import numpy as np
    from tendermint_tpu_torch.crypto.backend import _bucket, _pad_rows
    from tendermint_tpu_torch.ops import ed25519 as ed
    kind, set_key, val_pubs, lanes, out = call
    n = len(out)
    if kind == "templated":
        args = be.templated_args(set_key, val_pubs, *lanes)
        real = (*args[:3], args[3][:n], args[4][:n],
                args[5][:len(lanes[2])], args[6][:n])
        return (ed.verify_grouped_templated,
                ed.verify_grouped_templated_plain, args,
                lambda: _templated_cost(real))
    tbl, ok, _, _ = be.tables(set_key, val_pubs)
    vi, msgs, sigs = lanes
    b = _bucket(n)
    vi = _pad_rows(np.asarray(vi, np.int32), b)
    host = (vi, val_pubs[vi], _pad_rows(msgs, b), _pad_rows(sigs, b))
    args = (tbl, ok, *map(be._t, host), ed.base_table(be.device))
    return (ed.verify_grouped, ed.verify_grouped_plain, args,
            lambda: _grouped_verify_cost(host[3][:n], host[1][:n],
                                         host[2][:n], vi[:n],
                                         64 + 4 + 32 + msgs.shape[1] + 1,
                                         ok.numel()))


def _shape(args) -> tuple:
    """A launch's shape: the shapes of its device arguments."""
    return tuple(tuple(a.shape) for a in args)


def check_consensus(cs_ctx: dict, launches: dict) -> None:
    """The consensus phase's agreement, app-hash, flush, forged-vote,
    plain-version and restart checks, and its rates."""
    import numpy as np
    nodes, be = cs_ctx["nodes"], cs_ctx["backend"]
    top = min(cs.block_store.height for cs in nodes)
    require(top >= CONS_HEIGHTS, f"stores reach {top}")
    tallest = max(nodes, key=lambda cs: cs.block_store.height)
    blocks = [tallest.block_store.load_block(h)
              for h in range(1, tallest.block_store.height + 1)]
    for h in range(1, top + 1):
        hashes = {cs.block_store.load_block(h).hash() for cs in nodes}
        require(hashes == {blocks[h - 1].hash()},
                f"stores disagree at height {h}")
    committed = [tx for b in blocks for tx in b.txs]
    require(sorted(committed) == sorted(cs_ctx["txs"]),
            "committed txs != the txs fed to the mempools")
    host = _host_app_hashes(blocks)
    for i, cs in enumerate(nodes):
        h = cs.state.last_block_height
        require(cs.state.app_hash == host[h - 1],
                f"node {i}: app hash at {h} != host kvstore run")
    cons = [f for f in cs_ctx["flushes"] if "consensus" in f[3]]
    require(cons, "no consensus-class flush")
    calls = be.calls                  # every K1 call of the phase
    net = calls[2:cs_ctx["net_calls"]]    # the net's, after the pre-warm
    grouped = [c for c in net if c[0] == "grouped"]
    templated = [c for c in net if c[0] == "templated"]
    require(launches["K1"] == len(calls),
            f"K1 launches {launches['K1']} != {len(calls)} recorded calls")
    checked, bad, plain_s = _plain_k1(be, calls)
    require(bad == 0, f"{bad} K1 lanes of the phase != plain")
    fsig = cs_ctx["forged"].signature
    forged_lanes = [bool(c[4][i]) for c in grouped
                    for i in np.flatnonzero(
                        (c[3][2] == np.frombuffer(fsig, np.uint8)).all(1))]
    require(cs_ctx["injected"], "the forged vote was never injected")
    require(forged_lanes, "the forged vote reached K1 on no lane")
    require(not cs_ctx["counted_forged"],
            f"nodes {cs_ctx['counted_forged'][:5]} counted the forged vote")
    require(not any(forged_lanes), "K1 passed the forged vote")
    require(not cs_ctx["evidence"], "evidence fired in an honest net")
    rs = cs_ctx["restart"]
    require(rs["restart_k1"] >= 1, "no K1 launch verifying seen commits "
            "on restart")
    for i, hs in enumerate(rs["hashes"]):
        require(hs == rs["hashes"][0], f"restart node {i} disagrees")
        require(hs[:RESTART_HEIGHTS] == rs["before"][i],
                f"restart node {i} rewrote its pre-stop prefix")
    for i, bl in rs["blocks_by_node"].items():
        want = _host_app_hashes(bl)[-1]
        require(rs["app_hashes"][i] == want,
                f"restart node {i}: app hash != host kvstore run")
    require(rs["playback"] == rs["node0"] and
            rs["playback_app_hash"] == rs["node0_app_hash"],
            "Playback blocks or app hash != node 0's")
    # rates
    t_all = [max(t for _, t in cs_ctx["commits"][h])
             for h in range(1, CONS_HEIGHTS + 1)]
    lat = np.diff([cs_ctx["t_start"]] + t_all)
    rounds = [nodes[0].block_store.load_seen_commit(h).round() + 1
              for h in range(1, CONS_HEIGHTS + 1)]
    recv = np.array(cs_ctx["received"]).sum(0)
    lanes_g = sorted(len(c[4]) for c in grouped) or [0]
    lanes_t = sorted(len(c[4]) for c in templated) or [0]
    fl = sorted(f[2] for f in cons)
    log(f"[consensus] commit latency per height p50 "
        f"{float(np.median(lat)):.3f} s, max {float(lat.max()):.3f} s "
        f"({', '.join(f'{x:.3f}' for x in lat)}); rounds per height "
        f"{rounds}; {int(recv.sum())} votes received, "
        f"{int(recv[1])} pre-verified on K1 "
        f"({recv[1] / max(1, recv.sum()):.3f}); scalar verifies "
        f"(memo misses) {cs_ctx['scalar']}")
    log(f"[consensus] K1 with per-lane keys: {len(grouped)} launches, "
        f"lanes per launch min {lanes_g[0]} / p50 {_pctl(lanes_g, 0.5)} / "
        f"max {lanes_g[-1]}; templated K1 (LastCommits): {len(templated)} "
        f"launches, lanes min {lanes_t[0]} / p50 {_pctl(lanes_t, 0.5)} / "
        f"max {lanes_t[-1]}; consensus-class flushes {len(cons)}: lanes "
        f"min {fl[0]} / p50 {_pctl(fl, 0.5)} / max {fl[-1]} "
        f"({sum(f[1] == 'deadline' for f in cons)} at the deadline), "
        f"sizes {fl}")
    log(f"[consensus] every K1 call of the phase ({len(calls)} calls, "
        f"{checked} lanes, the pre-warm's and the restart's too) == the "
        f"plain version ({plain_s:.1f} s); the "
        f"forged vote: {len(forged_lanes)} K1 lanes, all False, counted by "
        f"no node; {len(nodes)} stores agree on {top} blocks, every app "
        f"hash == host kvstore run")
    log(f"[consensus] restart: {RESTART_VALS} validators on SQLiteDB "
        f"stopped at {rs['stopped_at']}, restarted from their WALs "
        f"({rs['restart_k1']} K1 launches re-verifying seen commits), "
        f"reached {rs['heights']} agreeing with the pre-stop prefix; "
        f"Playback over node 0's WAL: {len(rs['playback'])} blocks == "
        f"node 0's, app hash == node 0's")
    log(f"[consensus] {card_line()}")


def consensus_kernel_rows(cs_ctx: dict, consensus: dict) -> list:
    """Rows 1C and 6C: templated K1 at the consensus net's median
    LastCommit and K1 with per-lane keys at its median vote burst, each
    against its plain version on the card and the net's mask, counting
    the net's launches at that call's shape (its argument shapes: the
    padded lanes, templates and key set).  Logged: the device time of
    every K1 call of the net, each re-run alone on CUDA events, and every
    launch of the phase that no row counts (the net's at other shapes,
    the pre-warm, the restart and `Playback`, K2)."""
    import collections
    import torch
    be, net_calls = cs_ctx["backend"], cs_ctx["net_calls"]
    net = be.calls[2:net_calls]
    rows, device_ms, off_shape = [], {}, {}
    for row, kind, name, line, what in (
            ("1C", "templated", "verify_grouped_templated", 153,
             "median LastCommit"),
            ("6C", "grouped", "verify_grouped", 78, "median vote burst")):
        calls = sorted((c for c in net if c[0] == kind),
                       key=lambda c: len(c[4]))
        require(calls, f"no {kind} K1 call in the consensus net")
        shapes = []
        device_ms[kind] = 0.0
        for c in calls:
            kernel, _, args, _ = _k1_call(be, c)
            shapes.append(_shape(args))
            device_ms[kind] += cuda_ms(lambda: kernel(*args), 1)[0]
        mid = len(calls) // 2
        call = calls[mid]
        kernel, plain, args, cost = _k1_call(be, call)
        at_shape = shapes.count(shapes[mid])
        ms, got = cuda_ms(lambda: kernel(*args), 10)
        plain_ms, want = cuda_ms(lambda: plain(*args), 1)
        require(torch.equal(got, want), f"K1 ({kind}) != plain at the "
                f"consensus net's {what}")
        require(got[:len(call[4])].cpu().numpy().tolist() ==
                call[4].tolist(), f"K1 ({kind}) at the consensus net's "
                f"{what} != the net's mask")
        # a launch's (padded lanes, padded templates) for templated K1,
        # (padded lanes,) with per-lane keys; every call has the net's set
        dims = ((lambda sh: (sh[3][0], sh[5][0])) if kind == "templated"
                else (lambda sh: (sh[2][0],)))
        lanes = dims(_shape(args))
        off_shape[kind] = sorted(collections.Counter(
            dims(sh) for sh in shapes if sh != shapes[mid]).items())
        rows.append({**_entry(
            f"{name} [consensus {what}]",
            "tendermint_tpu_torch/csrc/verify_grouped.cu",
            f"tendermint_tpu/ops/ed25519.py:{line}", at_shape,
            max_abs_err(got, want), ms, plain_ms, *cost(),
            f"row {row}, the consensus net's {what}: {len(call[4])} lanes, "
            f"padded (lanes[, templates]) to {lanes}, Vb {args[0].shape[2]}"),
            "shape": f"row {row}: padded (lanes[, templates]) {lanes} (the "
                     f"consensus net's {what}, {len(call[4])} real lanes)"})
    rest = be.calls[net_calls:]
    log(f"[consensus] device time of the net's K1 calls, each re-run alone "
        f"on the card (CUDA events): per-lane keys {device_ms['grouped']:.3f}"
        f" ms, templated {device_ms['templated']:.3f} ms, over the net's "
        f"{cs_ctx['wall']:.3f} s to {CONS_HEIGHTS} heights")
    log(f"[consensus] launches in no row: the net's at other shapes, as "
        f"((padded lanes[, templates]), launches): per-lane keys "
        f"{off_shape['grouped']}, templated {off_shape['templated']}; 2 "
        f"pre-warm calls "
        f"({len(be.calls[0][4])} lanes); on restart and in Playback "
        f"({RESTART_VALS} keys) {sum(c[0] == 'grouped' for c in rest)} "
        f"per-lane and {sum(c[0] == 'templated' for c in rest)} templated; "
        f"K2 {consensus['K2']} (the {CONS_VALS}-key set's and the "
        f"{RESTART_VALS}-key set's builds)")
    return rows


# -- the kernels line ----------------------------------------------------

# Bounds count the operations each function needs, not those of the
# kernels' design: a field multiplication is 100 32x32->64 multiply-adds
# (10 x 10 limbs), a squaring 55; point operations are counted in
# (multiplications, squarings); the encode of a batch of points uses
# Montgomery's batch inversion (3 multiplications per point and one
# inversion per call).  The mod-L scalar work (a few dozen word products
# per reduction, < 1 % of a lane) is left out, which can only lower a
# bound.
MACS_MUL, MACS_SQR = 100, 55
MIXED_ADD = (7, 0)      # extended + cached affine (y+x, y-x, 2dxy)
ADD = (9, 0)            # extended + extended
DBL = (4, 4)
INVERT = (11, 254)      # z^(p-2)
DECOMPRESS = (19, 254)  # sqrt by z^((p-5)/8) and its checks
BATCH_INV = (3, 0)      # per point, beside one INVERT per call
# 32-bit integer instructions per SHA-256 block with 3-input adds and logic
# (IADD3, LOP3) and one-instruction rotates: 14 per round, 10 per
# scheduled word, 8 for the final state add
SHA256_OPS_PER_BLOCK = 64 * 14 + 48 * 10 + 8
# per SHA-512 block on 32-bit halves: a 64-bit rotate or shift is 2
# funnel shifts, a 3-input 64-bit add 2 IADD3, 3-input logic 2 LOP3:
# 28 per round, 20 per scheduled word, 16 for the final state add
SHA512_OPS_PER_BLOCK = 80 * 28 + 64 * 20 + 16


def _macs(*terms) -> int:
    """Multiply-adds of `count x (multiplications, squarings)` terms."""
    return sum(n * (m * MACS_MUL + q * MACS_SQR) for n, (m, q) in terms)


def _bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _le_digits(rows, width: int, windows: int):
    """Little-endian `width`-bit digits of the integers in uint8[N, B]
    rows (bits past B * 8 are 0) -> int64[N, windows]."""
    import numpy as np
    rows = np.ascontiguousarray(rows, np.uint8)
    nbits = width * windows
    weights = np.left_shift(1, np.arange(width, dtype=np.int64))
    out = np.zeros((len(rows), windows), np.int64)
    for lo in range(0, len(rows), 65536):
        bits = np.unpackbits(rows[lo:lo + 65536], axis=1, bitorder="little")
        if bits.shape[1] < nbits:
            bits = np.pad(bits, ((0, 0), (0, nbits - bits.shape[1])))
        out[lo:lo + 65536] = bits[:, :nbits].reshape(
            -1, windows, width).astype(np.int64) @ weights
    return out


def _mod_l_digits(digests: list, width: int, windows: int):
    """Comb digits of SHA-512 digests reduced mod L -> int64[N, windows]."""
    import numpy as np
    from tendermint_tpu_torch.crypto import pure_ed25519 as ref
    k = b"".join((int.from_bytes(d, "little") % ref.L).to_bytes(32, "little")
                 for d in digests)
    return _le_digits(np.frombuffer(k, np.uint8).reshape(-1, 32), width,
                      windows)


def _byte_digits(rows, width: int, windows: int):
    return _le_digits(rows, width, windows)


def _distinct_rows(digits, extra=None) -> int:
    """Distinct (window, digit[, key]) table rows a batch gathers."""
    import numpy as np
    n, windows = digits.shape
    packed = (np.arange(windows, dtype=np.int64)[None, :] << 40) | (
        digits.astype(np.int64) << 20)
    if extra is not None:
        packed |= np.asarray(extra, np.int64)[:, None]
    return len(np.unique(packed))


def _grouped_verify_cost(sigs, lane_pubs, lane_msgs, val_idx,
                         lane_bytes: int, fixed_bytes: int) -> tuple:
    """(bytes, operations) of a grouped verify (K1) over these lanes:
    `lane_bytes` moved per lane and `fixed_bytes` once, plus the distinct
    base and comb table rows the lanes' digits gather.  Per lane: SHA-512
    of R || A || M; 21 + 25 mixed adds onto the first entry of each comb
    (1 multiplication to extend it); one add of the two sums; encode
    (batch inversion, x and y)."""
    n, m = lane_msgs.shape
    digests = [hashlib.sha512(sigs[i, :32].tobytes() + lane_pubs[i].tobytes()
                              + lane_msgs[i].tobytes()).digest()
               for i in range(n)]
    kd = _mod_l_digits(digests, 10, 26)
    sd = _byte_digits(sigs[:, 32:], 12, 22)
    nbytes = n * lane_bytes + fixed_bytes + 96 * (
        _distinct_rows(sd) + _distinct_rows(kd, val_idx))
    blocks = (64 + m + 17 + 127) // 128
    ops = (n * blocks * SHA512_OPS_PER_BLOCK
           + _macs((n * 46, MIXED_ADD), (n * 2, (1, 0)), (n, ADD),
                   (n, BATCH_INV), (n * 2, (1, 0)), (1, INVERT)))
    return nbytes, ops


def _templated_cost(args) -> tuple:
    """(bytes, operations) of templated K1 over the device arguments of
    `ed25519.verify_grouped_templated` (`CudaBackend.templated_args`):
    per lane its signature, val_idx, tmpl_idx and result; the templates,
    key matrix and pub_ok once."""
    # args: tables, pub_ok, key matrix, val_idx, tmpl_idx, templates, sigs
    h_vp, h_vi, h_ti, h_tm, h_sg = (a.cpu().numpy() for a in args[2:7])
    return _grouped_verify_cost(
        h_sg, h_vp[h_vi], h_tm[h_ti], h_vi, 64 + 4 + 4 + 1,
        h_tm.nbytes + h_vp.nbytes + args[1].numel())


def _raw_verify_cost(pubs, msgs, sigs) -> tuple:
    """(bytes, operations) of a raw-lane verify (K5) over these lanes.
    Per lane: SHA-512 of R || A || M; two decompressions; [s]B as 21 mixed
    adds onto the first entry (1 multiplication to extend it); the window
    table T[2..15] of -A (14 adds); from the top nonzero 4-bit window of
    k down, 4 doublings per window and one add per nonzero digit; the add
    of the two sums; the comparison with R (Z_R = 1: 2 multiplications).
    Bytes: each lane's key, message, signature and result once, and the
    distinct base-table rows its digits gather."""
    from tendermint_tpu_torch.crypto import pure_ed25519 as ref
    n, m = msgs.shape
    dbl = adds = 0
    for i in range(n):
        k = int.from_bytes(hashlib.sha512(
            sigs[i, :32].tobytes() + pubs[i].tobytes()
            + msgs[i].tobytes()).digest(), "little") % ref.L
        nib = [(k >> (4 * w)) & 15 for w in range(64)]
        top = max((w for w in range(64) if nib[w]), default=0)
        dbl += 4 * top
        adds += sum(1 for w in range(top) if nib[w])
    blocks = (64 + m + 17 + 127) // 128
    ops = (n * blocks * SHA512_OPS_PER_BLOCK
           + _macs((n * 2, DECOMPRESS), (n * 21, MIXED_ADD), (n, (1, 0)),
                   (n * 14, ADD), (dbl, DBL), (adds, ADD), (n, ADD),
                   (n * 2, (1, 0))))
    nbytes = n * (32 + m + 64 + 1) + 96 * _distinct_rows(
        _byte_digits(sigs[:, 32:], 12, 22))
    return nbytes, ops


K5_TIMED_LANES = (32, 64, 1024, 4096, 65536)
K5_ROW_LANES = 64


def phase_kernels(launches: dict, rp_ctx: dict, mk_ctx: dict,
                  mp_ctx: dict) -> list:
    """Time each kernel and its plain version at the main path's shapes,
    hold the two results equal, and work out each kernel's bound."""
    import numpy as np
    import torch
    from tendermint_tpu_torch.blockchain import replay as rp
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.ops import kernels, merkle
    from tendermint_tpu_torch.ops import sha256 as s256
    from tendermint_tpu_torch.types import canonical
    from tendermint_tpu_torch.types.validator import window_commit_lanes
    be, chain, vals = rp_ctx["backend"], rp_ctx["chain"], rp_ctx["vals"]
    dev = be.device
    rows = []

    # K1 at one replay window's shape
    _, _, items = rp.prepare_window(chain.blocks[:WINDOW],
                                    chain.commits[:WINDOW], vals.hash(), be)
    templates, tmpl_idx, sigs, idxs, *_ = window_commit_lanes(
        vals, chain.genesis.chain_id, items)
    args = be.templated_args(rp_ctx["set_key"], vals.pubs_matrix(), idxs,
                             tmpl_idx, templates, sigs)
    n = args[3].shape[0]
    ms, got = cuda_ms(lambda: ed.verify_grouped_templated(*args), 10)
    plain_ms, want = cuda_ms(
        lambda: ed.verify_grouped_templated_plain(*args), 1)
    require(torch.equal(got, want), "K1 != plain at the main path's shape")
    require(bool(got[:len(idxs)].all()), "K1 rejected a valid replay lane")
    err = max_abs_err(got, want)
    rows.append(("verify_grouped_templated", "verify_grouped.cu",
                 "tendermint_tpu/ops/ed25519.py:153", "K1", ms, plain_ms,
                 err, *_templated_cost(args),
                 f"{n} lanes, {args[5].shape[0]} templates"))

    # K1 with per-lane keys and messages at a vote burst's shape
    vargs, _ = vote_burst(dev)
    ms, got = cuda_ms(lambda: ed.verify_grouped(*vargs), 10)
    plain_ms, want = cuda_ms(lambda: ed.verify_grouped_plain(*vargs), 1)
    require(torch.equal(got, want), "K1 (per-lane keys) != plain at the "
            "vote burst's shape")
    err = max_abs_err(got, want)
    # vargs: tables, pub_ok, val_idx, pubkeys, msgs, sigs
    h_vi, h_pk, h_ms, h_sg = (a.cpu().numpy() for a in vargs[2:6])
    n = len(h_vi)
    nbytes, ops = _grouped_verify_cost(h_sg, h_pk, h_ms, h_vi,
                                       64 + 4 + 32 + h_ms.shape[1] + 1,
                                       vargs[1].numel())
    rows.append(("verify_grouped", "verify_grouped.cu",
                 "tendermint_tpu/ops/ed25519.py:78", "K1p", ms, plain_ms,
                 err, nbytes, ops, f"{n} lanes x {h_ms.shape[1]} B, Vb "
                 f"{vargs[0].shape[2]}"))

    # K5 at the mempool's padded flush sizes (32 and 64 lanes: its
    # deadline flushes of ~30-60 lanes), its row's shape, and beside them
    # at the plane's target (1,024), cap (4,096) and at 65,536 lanes
    from tendermint_tpu_torch.mempool.mempool import (_priority_digest,
                                                      parse_signed_tx)
    parsed = [parse_signed_tx(bytes.fromhex(e["tx"]))
              for e in mp_ctx["corpus"]]
    parsed = [p for p in parsed if p is not None]
    lane = lambda k, w: np.frombuffer(  # noqa: E731
        b"".join(k(p) for p in parsed), np.uint8).reshape(-1, w)
    raw = (lane(lambda p: p[1], 32),
           lane(lambda p: _priority_digest(p[4], p[3]), 32),
           lane(lambda p: p[2], 64))
    base = ed.base_table(dev)
    lanes = {n: tuple(np.tile(a, (-(-n // len(a)), 1))[:n] for a in raw)
             for n in K5_TIMED_LANES}
    k5_ms = {}
    for n, h in lanes.items():
        rargs = tuple(torch.as_tensor(a.copy(), device=dev) for a in h)
        k5_ms[n], got = cuda_ms(lambda: ed.verify_batch(*rargs, base), 10)
        if n == K5_ROW_LANES:
            plain_ms, want = cuda_ms(
                lambda: ed.verify_batch_plain(*rargs, base), 1)
            require(torch.equal(got, want),
                    f"K5 != plain at {n} lanes")
            err = max_abs_err(got, want)
    for n in K5_TIMED_LANES:
        b_ms, b_by = _bound(*_raw_verify_cost(*lanes[n]))
        log(f"[kernels] K5 verify_raw at {n} lanes x 32 B: {k5_ms[n]:.3f} "
            f"ms, bound {b_ms:.4f} ms by {b_by}")
    nbytes, ops = _raw_verify_cost(*lanes[K5_ROW_LANES])
    rows.append(("verify_raw", "verify_raw.cu",
                 "tendermint_tpu/ops/ed25519.py:46", "K5",
                 k5_ms[K5_ROW_LANES], plain_ms, err, nbytes, ops,
                 f"{K5_ROW_LANES} lanes x 32 B"))
    for key, kernel in (("K3", "sign_grouped"), ("K5", "verify_raw"),
                        ("K6", "verify_tally")):
        log(f"[kernels] one warp on the card, {key}'s build, cycles per "
            f"dependent step (clock64 microkernel): "
            f"{fe_mul_cycles(kernels.CSRC, kernel)}")

    # K2 at the replay set's shape (100 keys; padding copies column 0)
    pubs = be._t(vals.pubs_matrix())
    v = pubs.shape[0]
    ms, (tbl, ok) = cuda_ms(lambda: ed.build_neg_comb(pubs), 3)
    plain_ms, (ptbl, pok) = cuda_ms(lambda: ed.build_neg_comb_plain(pubs), 0)
    require(torch.equal(ok, pok) and bool(ok.all()),
            "K2 ok mask != plain at the main path's shape")
    require(torch.equal(tbl, ptbl), "K2 table != plain at the main path's "
            "shape")
    err = max(max_abs_err(ok, pok), max_abs_err(tbl, ptbl))
    del tbl, ptbl
    # per key: decompress, 25 x 10 doublings for the window bases, each
    # base made affine (one batch inversion over the 26 x V bases and its
    # pack); per entry (1,023 of 1,024 per window; digit 0 is a constant):
    # one mixed add of the affine base onto entry j - 1, the batch
    # inversion, and the affine pack (x, y, x*y, *2d)
    entries = v * 26 * 1023
    ops = _macs((v, DECOMPRESS), (v * 250, DBL), (v * 26, BATCH_INV),
                (v * 26, (4, 0)), (entries, MIXED_ADD), (entries, BATCH_INV),
                (entries, (4, 0)), (2, INVERT))
    nbytes = v * 32 + v * 1 + 26 * 1024 * v * 96
    rows.append(("build_neg_comb", "build_neg_comb.cu",
                 "tendermint_tpu/ops/ed25519.py:60", "K2", ms, plain_ms,
                 err, nbytes, ops, f"{v} keys"))

    # K3 at one fixture signing call's shape (655 blocks x 100 lanes)
    nb = rp.SIGN_CHUNK_BLOCKS
    val_idx = np.tile(np.arange(N_VALS, dtype=np.int32), nb)
    tmpl_idx = np.repeat(np.arange(nb, dtype=np.int32), N_VALS)
    bids = [c.block_id for c in chain.commits[:nb]]
    templates = canonical.batch_sign_bytes(
        chain.genesis.chain_id,
        np.full(nb, canonical.TYPE_PRECOMMIT, np.int64),
        np.arange(1, nb + 1, dtype=np.int64), np.zeros(nb, np.int64),
        np.frombuffer(b"".join(b.hash for b in bids), np.uint8).reshape(nb, 32),
        np.frombuffer(b"".join(b.parts.hash for b in bids),
                      np.uint8).reshape(nb, 32),
        np.array([b.parts.total for b in bids], np.int64))
    sargs = be.sign_args(chain.seeds, val_idx, tmpl_idx, templates)
    n = sargs[3].shape[0]
    ms, got = cuda_ms(lambda: ed.sign_grouped_templated(*sargs), 10)
    plain_ms, want = cuda_ms(
        lambda: ed.sign_grouped_templated_plain(*sargs), 1)
    require(torch.equal(got, want), "K3 != plain at the main path's shape")
    err = max_abs_err(got, want)
    # sargs: a, prefixes, pubkeys, val_idx, tmpl_idx, templates, base
    h_pre, _, h_vi, h_ti, h_tm = (a.cpu().numpy() for a in sargs[1:6])
    rd = _mod_l_digits([hashlib.sha512(h_pre[h_vi[i]].tobytes()
                                       + h_tm[h_ti[i]].tobytes()).digest()
                        for i in range(n)], 12, 22)
    nbytes = n * (4 + 4 + 64) + h_tm.nbytes + 3 * N_VALS * 32 \
        + 96 * _distinct_rows(rd)
    # per lane: SHA-512 of prefix || M (160 B) and of R || A || M (192 B),
    # 2 blocks each; 21 mixed adds onto the first entry; encode
    ops = (n * 4 * SHA512_OPS_PER_BLOCK
           + _macs((n * 21, MIXED_ADD), (n, (1, 0)), (n, BATCH_INV),
                   (n * 2, (1, 0)), (1, INVERT)))
    rows.append(("sign_grouped_templated", "sign_grouped.cu",
                 "tendermint_tpu/ops/ed25519.py:117", "K3", ms, plain_ms,
                 err, nbytes, ops, f"{n} lanes, {h_tm.shape[0]} templates"))

    # K4 at the Merkle cell's part sets (2,048 full 64 KB parts); beside
    # it, at the trees' leaves (2,097,152 x 64 B), its rows before K7
    parts = torch.as_tensor(mk_ctx["blocks"], device=dev)
    ms, got = cuda_ms(lambda: s256.sha256_prefixed(parts, 0), 10)
    plain_ms, want = cuda_ms(lambda: s256.sha256_prefixed_plain(parts, 0), 0)
    require(torch.equal(got, want), "K4 != plain at the main path's shape")
    err = max_abs_err(got, want)
    n, width = parts.shape
    nblocks = (width + 1 + 9 + 63) // 64
    rows.append(("sha256_prefixed", "sha256_prefixed.cu",
                 "tendermint_tpu/ops/merkle.py:98", "K4", ms, plain_ms,
                 err, n * (width + 32), n * nblocks * SHA256_OPS_PER_BLOCK,
                 f"{n} messages x {width} B (the part sets)"))
    leaves = mk_ctx["data"].reshape(-1, LEAF_LEN)
    leaf_ms, _ = cuda_ms(lambda: s256.sha256_prefixed(leaves, 0), 10)
    b_ms, b_by = _bound(leaves.shape[0] * (LEAF_LEN + 32), leaves.shape[0]
                        * ((LEAF_LEN + 1 + 9 + 63) // 64)
                        * SHA256_OPS_PER_BLOCK)
    log(f"[kernels] K4 sha256_prefixed at {leaves.shape[0]} messages x "
        f"{LEAF_LEN} B (the trees' leaves): {leaf_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms by {b_by}")
    for what, x in (("part sets", parts), ("trees' leaves", leaves)):
        log(f"[kernels] K4 route at {x.shape[0]} x {x.shape[1]} B ({what}): "
            f"{s256._k4_route(x.shape[1], x.data_ptr())}")
    # the chain bound: one part's nblocks dependent steps of the staged
    # route's round warp (the 64 rounds from scheduled words; the schedule
    # runs on the other warp), at the cycles and SM clock the microkernel
    # measured with K4's build
    micro = fe_mul_cycles(kernels.CSRC, "sha256_prefixed")
    chain_ms = nblocks * micro["sha256_rounds_cycles"] / (
        micro["sm_clock_mhz"] * 1e3)
    extra = {"K4": {"chain_bound_ms": chain_ms}}
    log(f"[kernels] K4's build, one warp: "
        f"{micro['sha256_rounds_cycles']:.1f} cycles per dependent step of "
        f"the round warp, {micro['sha256_block_cycles']:.1f} per whole "
        f"SHA-256 compression, at {micro['sm_clock_mhz']:.0f} MHz (clock64 "
        f"over %globaltimer; nvidia-smi clocks.sm, clocks.max.sm: "
        f"{sm_clocks()}): chain bound {chain_ms:.4f} ms for {nblocks} "
        f"blocks")

    # K7 at the Merkle cell's trees (2,048 x 1,024 leaves x 64 B)
    data = mk_ctx["data"]
    ms, got = cuda_ms(lambda: merkle.roots(data), 10)
    plain_ms, want = cuda_ms(lambda: merkle.roots_plain(data), 0)
    require(torch.equal(got, want), "K7 != plain at the main path's shape")
    err = max_abs_err(got, want)
    rows.append(("roots", "merkle_roots.cu",
                 "tendermint_tpu/ops/merkle.py:124", "K7", ms, plain_ms, err,
                 *_roots_cost(TREES, LEAVES, LEAF_LEN),
                 f"{TREES} trees x {LEAVES} leaves x {LEAF_LEN} B"))

    out = []
    for (name, src, replaces, key, ms, plain_ms, err, nbytes, ops,
         shape) in rows:
        bound_ms, bound_by = _bound(nbytes, ops)
        log(f"[kernels] {key} {name} at {shape}: {ms:.3f} ms == plain "
            f"(max abs err {err}; plain {plain_ms:.1f} ms), bound "
            f"{bound_ms:.4f} ms by {bound_by}: {nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.2f} G int ops; {launches[key]} launches on the "
            f"main path")
        out.append({"name": name, "route": "cuda",
                    "source": f"tendermint_tpu_torch/csrc/{src}",
                    "replaces": replaces, "launches": launches[key],
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None, **extra.get(key, {})})
    return out


def light_kernel_row(lt: dict, light: dict) -> dict:
    """K1 at the light grid's shape, one chain's 1,048,576 lanes against
    its 131,072 templates (Vb 16), held against the plain version run in
    65,536-lane slices; its launches are the grid's on the light path."""
    import torch
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.types.validator import window_commit_lanes
    be, c0 = lt["backend"], lt["chains"][0]
    vals = c0.validators
    templates, tmpl_idx, sigs, idxs, *_ = window_commit_lanes(
        vals, c0.chain_id, c0.items)
    args = be.templated_args(vals.set_key(), vals.pubs_matrix(), idxs,
                             tmpl_idx, templates, sigs)
    n, step = args[3].shape[0], 65536
    ms, got = cuda_ms(lambda: ed.verify_grouped_templated(*args), 3)

    def plain():
        return torch.cat([ed.verify_grouped_templated_plain(
            *args[:3], args[3][lo:lo + step], args[4][lo:lo + step],
            args[5], args[6][lo:lo + step], args[7])
            for lo in range(0, n, step)])

    plain_ms, want = cuda_ms(plain, 0)
    require(torch.equal(got, want) and bool(got.all()),
            "K1 != plain (or a lane rejected) at the light grid's shape")
    log(f"[kernels] light path launches beside the grid's "
        f"{lt['grid_k1']} K1: {light}")
    return {**_entry("verify_grouped_templated",
                     "tendermint_tpu_torch/csrc/verify_grouped.cu",
                     "tendermint_tpu/ops/ed25519.py:153", lt["grid_k1"],
                     max_abs_err(got, want), ms, plain_ms,
                     *_templated_cost(args),
                     f"the light grid: {n} lanes, {args[5].shape[0]} "
                     f"templates, Vb {args[0].shape[2]}"),
            "shape": f"{n} lanes, {args[5].shape[0]} templates (light grid)"}


def _entry(name, src, replaces, launches, err, ms, plain_ms, nbytes, ops,
           what) -> dict:
    """One entry of the kernels line, logged with its bound."""
    bound_ms, bound_by = _bound(nbytes, ops)
    log(f"[kernels] {name} at {what}: {ms:.3f} ms == plain (max abs err "
        f"{err}; plain {plain_ms:.1f} ms), bound {bound_ms:.4f} ms by "
        f"{bound_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} G int ops; "
        f"{launches} launches on the main path")
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def _tally_cost(pubs, msgs, sigs, rows: int) -> tuple:
    """(bytes, operations) of K6: K5's lanes, plus each lane's int64 power
    read and each row's tally and block_ok written."""
    nbytes, ops = _raw_verify_cost(pubs, msgs, sigs)
    return nbytes + 8 * len(pubs) + 9 * rows + 8, ops


def phase_mesh_kernels(mesh_ctxs: list, mesh_in: dict, mk_ctx: dict,
                       launches: dict) -> list:
    """K6 at the flat batch's shape against its plain version, then per
    mesh the whole call of each mesh function (rows 8-11) against the same
    call with the kernels' plain versions swapped in."""
    import torch
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.ops import merkle
    sharding_py = "tendermint_tpu_torch/parallel/sharding.py"
    jax_sharding = "tendermint_tpu/parallel/sharding.py"
    base = ed.base_table(mesh_in["flat"][0].device)
    flat, grid = mesh_in["flat"], mesh_in["grid"]
    n = flat[0].shape[0]
    host_flat = [a.cpu().numpy() for a in flat[:3]]
    flat_cost = _tally_cost(*host_flat, 1)
    nb = grid[0].shape[0]
    host_grid = [a.cpu().numpy().reshape(n, -1) for a in grid[:3]]
    k6_grid = _tally_cost(*host_grid, nb)
    grid_cost = [a + b for a, b in zip(
        k6_grid, _roots_cost(nb, MESH_LEAVES, LEAF_LEN))]
    trees_cost = _roots_cost(TREES, LEAVES, LEAF_LEN)
    k6 = (ed, "verify_tally", ed.verify_tally_plain)
    k7 = (merkle, "roots", merkle.roots_plain)
    k1 = (ed, "verify_grouped", ed.verify_grouped_plain)
    k1t = (ed, "verify_grouped_templated", ed.verify_grouped_templated_plain)

    ms, got = cuda_ms(lambda: ed.verify_tally(*flat, 1, 0, base), 10)
    plain_ms, want = cuda_ms(lambda: ed.verify_tally_plain(*flat, 1, 0,
                                                           base), 0)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"K6 != plain at {n} lanes")
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    out = [_entry("verify_tally", "tendermint_tpu_torch/csrc/verify_tally.cu",
                  f"{jax_sharding}:84", launches["K6"], err, ms, plain_ms,
                  *flat_cost, f"{n} lanes x {flat[1].shape[1]} B, 1 row")]

    # the mesh rows' reference: one replay window through the
    # single-device path of `CudaBackend.verify_grouped_templated`
    args, mask = mesh_ctxs[0]["calls"][0]
    single = mesh_ctxs[0]["backend"]
    ms, got = cuda_ms(lambda: ed.verify_grouped_templated(
        *single.templated_args(*args)).cpu(), 3)
    require(got[:len(mask)].tolist() == mask.tolist(),
            "single-device window != the mesh's")
    log(f"[kernels] one replay window ({len(mask)} lanes) on one device, "
        f"single-device templated path, whole call: {ms:.3f} ms")

    for ctx in mesh_ctxs:
        label, lc = ctx["label"], ctx["launches"]
        rows = (
            ("sharded_verify_fn", 95, lambda: ctx["verify_fn"](*flat), (k6,),
             lc["verify"]["K6"], flat_cost, f"{n} lanes"),
            ("sharded_merkle_fn", 109, lambda: ctx["merkle_fn"](mk_ctx["data"]),
             (k7,), lc["merkle"]["K7"], trees_cost,
             f"{TREES} trees x {LEAVES} leaves"),
            ("training_step_fn", 119, lambda: ctx["step_fn"](
                *grid, mesh_in["leaves"], mesh_in["total"]), (k6, k7),
             lc["step"]["K6"] + lc["step"]["K7"], grid_cost,
             f"{nb} blocks x {N_VALS} lanes + {MESH_LEAVES} leaves"),
        )
        args, mask = ctx["calls"][0]
        be, gargs = ctx["backend"], ctx["grouped_args"]
        rows += (
            ("sharded_grouped_verify_fn", 146,
             lambda: be.verify_grouped(*gargs), (k1,),
             lc["grouped"]["K1"], _window_cost(gargs),
             f"one replay window via CudaBackend.verify_grouped, "
             f"{len(mask)} lanes, messages assembled on the host"),
            ("sharded_grouped_templated_verify_fn", 146,
             lambda: be.verify_grouped_templated(*args), (k1t,),
             lc["replay"]["K1"], _templated_cost(be.templated_args(*args)),
             f"one replay window via CudaBackend.verify_grouped_"
             f"templated, {len(mask)} lanes"),
        )
        for name, line, fn, swaps, n_launch, cost, what in rows:
            ms, got = cuda_ms(fn, 3)
            plain_ms, want = plain_cuda_ms(fn, swaps)
            got, want = _flat_tuple(got), _flat_tuple(want)
            require(all(_same(g, w) for g, w in zip(got, want)),
                    f"{name} on {label}: kernels != plain")
            err = max(max_abs_err(torch.as_tensor(g), torch.as_tensor(w))
                      for g, w in zip(got, want))
            out.append(_entry(f"{name} [{label}]", sharding_py,
                              f"{jax_sharding}:{line}", n_launch, err, ms,
                              plain_ms, *cost, what))
    return out


def _flat_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _same(a, b) -> bool:
    import torch
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _window_cost(args) -> tuple:
    """(bytes, operations) of K1 over one replay window with per-lane keys
    and host-assembled messages (`verify_grouped`'s arguments), lanes
    padded to the bucket by repeating lane 0."""
    import numpy as np
    from tendermint_tpu_torch.crypto.backend import _bucket, _pad_rows
    _, val_pubs, val_idx, msgs, sigs = args
    b = _bucket(len(val_idx))
    vi = _pad_rows(np.asarray(val_idx, np.int32), b)
    msgs = _pad_rows(msgs, b)
    return _grouped_verify_cost(_pad_rows(sigs, b), val_pubs[vi], msgs, vi,
                                4 + 32 + msgs.shape[1] + 64 + 1,
                                len(val_pubs))


KERNEL_KEYS = {"verify_grouped": "K1", "build_neg_comb": "K2",
               "sign_grouped": "K3", "sha256_prefixed": "K4",
               "merkle_roots": "K7",
               "verify_raw": "K5", "verify_tally": "K6"}


def read_launches(path: str, needed: tuple) -> dict:
    """The launch counts of one main path, read just after it; each of
    the path's kernels must have launched."""
    from tendermint_tpu_torch.ops import kernels
    got = {KERNEL_KEYS[k]: n for k, n in kernels.LAUNCHES.items()}
    for key in needed:
        require(got[key] > 0, f"{key} was not launched on the {path} path")
    log(f"[{path}] launches on the main path: {got}")
    return got


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import tendermint_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root "
              "(tendermint_tpu_torch not importable)", file=sys.stderr)
        return 2
    from tendermint_tpu_torch.crypto.backend import CudaBackend
    from tendermint_tpu_torch.ops import kernels
    from tendermint_tpu_torch.parallel import sharding
    card = card_line()
    log(card)
    phase_build()
    phase_check()
    kernels.reset_launches()                # the replay path starts here
    rp_ctx = phase_replay()
    mk_ctx = phase_merkle(rp_ctx["backend"])
    replay = read_launches("replay", ("K1", "K2", "K3", "K4", "K7"))
    kernels.reset_launches()                # the mempool path starts here
    mp_ctx = phase_mempool(CudaBackend())
    mempool = read_launches("mempool", ("K1", "K2", "K3", "K5"))
    mesh_in = mesh_inputs(rp_ctx)
    card0 = torch.device("cuda", 0)
    meshes = [sharding.make_mesh(), sharding.Mesh([card0] * 4)]
    if torch.cuda.device_count() > 1:       # every card against card 0
        meshes.insert(1, sharding.Mesh([card0]))
    kernels.reset_launches()                # the mesh path starts here
    mesh_ctxs = [phase_mesh(rp_ctx, mk_ctx, mesh_in, m) for m in meshes]
    mesh = read_launches("mesh", ("K1", "K2", "K6", "K7"))
    phase_tamper(rp_ctx)
    check_merkle(mk_ctx)     # profiles before the fast-sync path's profiles
    check_mempool(mp_ctx, mempool)
    for ctx in mesh_ctxs:
        check_mesh(rp_ctx, mk_ctx, mesh_in, ctx)
    kernels.reset_launches()                # the fast-sync path starts here
    fs_ctx = phase_fastsync()
    fastsync = read_launches("fastsync", ("K1", "K2", "K3"))
    kernels.reset_launches()                # the light path starts here
    lt_ctx = phase_light()
    light = read_launches("light", ("K1", "K2", "K3"))
    check_fastsync(fs_ctx)
    check_light(lt_ctx)
    t_cs = time.perf_counter()
    kernels.reset_launches()                # the consensus path starts here
    cs_ctx = phase_consensus()
    consensus = read_launches("consensus", ("K1", "K2"))
    check_consensus(cs_ctx, consensus)
    log(f"[consensus] phase and checks {time.perf_counter() - t_cs:.1f} s")
    # per kernel, its launches on the paths that run it at the shapes its
    # row is timed at: templated K1 on the replay path, K1 with per-lane
    # keys on the mempool path, K4 (part sets) and K7 (trees) on the
    # replay path's Merkle cell; K2 at the replay set's shape on all
    # three; K5's raw flushes padded to its row's 64 lanes (one launch per
    # flush, as check_mempool holds); K6 runs on the mesh path only.  The
    # mesh's launches of K1 and K7, at the shards' shapes, stand in the
    # mesh rows.
    # The fast-sync path runs K1, K2 and K3 at the replay's shapes (its
    # windows, its set, its signing calls); the light path's grid runs K1
    # at a row of its own, and its other launches (K2 at 8 keys, K3 at
    # 8,192 templates, K1 on the follower's few lanes) are logged above.
    # The consensus path's K1 stands in two rows of its own (1C, 6C),
    # each timed at the net's median call and counting the net's launches
    # at that call's shape; its other launches are logged there.
    launches = {k: replay[k] + mempool[k] + fastsync[k] for k in replay}
    launches["K1"] = replay["K1"] + fastsync["K1"]
    launches["K1p"] = mempool["K1"]
    launches["K5"] = mp_ctx["k5_by_size"].get(K5_ROW_LANES, 0)
    launches["K2"] += mesh["K2"]
    launches["K6"] = mesh["K6"]
    line = phase_kernels(launches, rp_ctx, mk_ctx, mp_ctx)
    line.append(light_kernel_row(lt_ctx, light))
    line += consensus_kernel_rows(cs_ctx, consensus)
    line += phase_mesh_kernels(mesh_ctxs, mesh_in, mk_ctx, launches)
    log(card)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
