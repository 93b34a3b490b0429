// K6: fused raw-lane ed25519 verification, voting-power tally and quorum
// over a grid of B rows x V lanes (row-major; a row is one block's commit,
// or the whole batch when B = 1).
//
// Replaces tendermint_tpu/parallel/sharding.py verify_tally (ed.verify and
// the power sum over valid lanes) and the verify / tally / sig_ok /
// block_ok body of training_step_fn.step:
//   ok[i]       = verify_raw_lane(...)   (tm_verify_raw.cuh, K5's body)
//   tallied[r]  = sum of powers[i] over the ok lanes of row r   (int64)
//   block_ok[r] = all(ok | powers == 0) && tallied*3 > total_power*2
// in int64 with two's-complement wrap, as torch computes it.  The JAX
// function tallies in int32 (x64 is off there) and wraps above 2^31 - 1;
// the port keeps Tendermint's int64 voting power.
// Launch shape: a 2-D grid, x over lane chunks of one row, y over rows, so
// every block lies in one row; a block of 128 threads runs
// `verify_raw_block` on 32 lanes, a quad of four threads per lane, and
// only a quad's thread 0 adds the lane's power and counts it bad, so each
// lane counts once.  Each block reduces its ok
// power and its count of bad lanes (not ok, power != 0) with warp
// shuffles and shared memory, then adds them into the row's accumulators with integer atomics
// (order-free, so the sums are exact and deterministic); the last block of
// a row to finish (threadfence + a per-row counter) writes block_ok.  The
// wrapper zeroes the accumulators and counters on the stream first.
// What bounds it: integer multiplies, as K5 (~1k dependent field products
// per lane on its quad); the tally adds 8 bytes read per lane and 9
// written per row.
#include <cuda_runtime.h>

// A vote-set batch fills the card: throughput is the time, so the quad's
// steps are inlined around out-of-line field products and the registers
// capped for 5 blocks per SM (96 a thread; measured on an H100: 5.70 ms
// at 100,000 lanes against 5.98 at 132 registers and 6.01 all inline).
#ifndef RAW_MIN_BLOCKS
#define RAW_MIN_BLOCKS 5
#endif
#include "tm_verify_raw.cuh"

constexpr int TALLY_THREADS = RAW_BLOCK;
constexpr int TALLY_LANES = RAW_LANES;                  // lanes per block

__global__ void __launch_bounds__(TALLY_THREADS, RAW_MIN_BLOCKS) verify_tally_kernel(
    const uint8_t* __restrict__ pubkeys, const uint8_t* __restrict__ msgs,
    int msg_len, const uint8_t* __restrict__ sigs,
    const int64_t* __restrict__ powers, const uint8_t* __restrict__ base,
    const int64_t* __restrict__ total_power, int lanes_per_row,
    uint8_t* __restrict__ ok_out, unsigned long long* tallied,
    unsigned int* bad, unsigned int* done, uint8_t* __restrict__ block_ok) {
  __shared__ int32_t sm[RAW_SMEM_WORDS];
  int row = blockIdx.y;
  int first = blockIdx.x * TALLY_LANES;
  int lane = first + threadIdx.x / RAW_QUAD;
  unsigned long long power_ok = 0;
  unsigned int n_bad = 0;
  if (lanes_per_row > 0) {      // the same for the whole block
    // lanes past the row's end run the row's lane 0 and count nothing
    size_t row0 = (size_t)row * lanes_per_row;
    int j = first + (int)(threadIdx.x & (TALLY_LANES - 1));
    size_t li = row0 + (j < lanes_per_row ? j : 0);
    bool live = lane < lanes_per_row;
    size_t i = row0 + (live ? lane : 0);
    bool ok = verify_raw_block(pubkeys + 32 * li, msgs + (size_t)msg_len * li,
                               sigs + 64 * li, msg_len, sigs + 64 * i, base,
                               sm);
    if (live && (threadIdx.x & (RAW_QUAD - 1)) == 0) {
      ok_out[i] = ok;
      long long p = powers[i];
      power_ok = ok ? (unsigned long long)p : 0ull;
      n_bad = (!ok && p != 0) ? 1u : 0u;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    power_ok += __shfl_down_sync(0xffffffffu, power_ok, off);
    n_bad += __shfl_down_sync(0xffffffffu, n_bad, off);
  }
  __shared__ unsigned long long warp_power[TALLY_THREADS / 32];
  __shared__ unsigned int warp_bad[TALLY_THREADS / 32];
  __shared__ bool last;
  int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    warp_power[warp] = power_ok;
    warp_bad[warp] = n_bad;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < TALLY_THREADS / 32; w++) {
      power_ok += warp_power[w];
      n_bad += warp_bad[w];
    }
    if (power_ok) atomicAdd(&tallied[row], power_ok);
    if (n_bad) atomicAdd(&bad[row], n_bad);
    __threadfence();
    last = atomicAdd(&done[row], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    // atomic reads see every block's adds to this row
    unsigned long long t = atomicAdd(&tallied[row], 0ull);
    unsigned int b = atomicAdd(&bad[row], 0u);
    unsigned long long total = (unsigned long long)*total_power;
    block_ok[row] = b == 0 && (long long)(t * 3ull) > (long long)(total * 2ull);
  }
}

extern "C" int tm_verify_tally(
    const uint8_t* pubkeys, const uint8_t* msgs, int msg_len,
    const uint8_t* sigs, const int64_t* powers, const uint8_t* base,
    const int64_t* total_power, int rows, int lanes_per_row, uint8_t* ok,
    int64_t* tallied, int32_t* bad, int32_t* done, uint8_t* block_ok,
    void* stream) {
  if (rows <= 0 || rows > 65535) return (int)cudaErrorInvalidConfiguration;
  // a row with no lanes still gets one block, which writes its block_ok
  int chunks = lanes_per_row > 0
                   ? (lanes_per_row + TALLY_LANES - 1) / TALLY_LANES
                   : 1;
  dim3 grid(chunks, rows);
  verify_tally_kernel<<<grid, TALLY_THREADS, 0, (cudaStream_t)stream>>>(
      pubkeys, msgs, msg_len, sigs, powers, base, total_power, lanes_per_row,
      ok, (unsigned long long*)tallied, (unsigned int*)bad,
      (unsigned int*)done, block_ok);
  return (int)cudaGetLastError();
}
