// int8 tensor-core rate probe with operands resident in shared memory, for
// Hopper (sm_90a): wgmma from swizzled shared memory.
//
// Replaces the TPU kernel tools/vmem_gemm_probe.py:33 (make_probe, inner
// kernel at :34), which keeps x and several weight buffers resident in VMEM
// and sums products that no compiler can fold together:
//
//   out (M, N) int32 = sum_{r < rolls} sum_{j < nbufs} roll(x, 128*r mod M) @ w[j]
//
// with roll along rows as numpy.roll (out row i reads x row i - shift).  The
// TPU kernel rolls an int32 view of 4 int8 rows by 32, hence 128 int8 rows.
//
// Bound on an H100: operations, 2*M*N*K*rolls*nbufs / 1979e12, by purpose;
// the bytes (x once, every w[j] once, the int32 output once) are smaller
// or of the same order at the tool's shapes.  What a launch really costs at
// those shapes (a few us) is filling 132 SMs and the L2 traffic of the
// weight tiles, which every 64-row tile reads again.
//
// Design.  "Resident in fast memory" becomes resident in shared memory, and
// the products are wgmmas that read it by descriptor, so the inner loop has
// no load instructions at all.
//  - A block owns a 64 x 64 output tile and a range of 128-byte K chunks.
//    A stage of its ring holds, for one chunk, the 64 x 128-byte tile of x
//    of every roll and the 64 x 128-byte tile of every weight buffer, all in
//    the 128-byte swizzle (wgmma_s8.cuh); the ring has as many stages (3 or
//    4) as fit beside rolls + nbufs tiles of 8 KB.
//  - One consumer warpgroup runs all rolls * nbufs * 4 wgmma m64n64k32 of
//    a chunk into one accumulator, one commit group per chunk, and hands a
//    stage back once the next group is queued and its own is done.
//  - One producer warpgroup fills the stages.  The weight tiles come by TMA
//    (w seen as one (nbufs * N, Kp) matrix; rows past N of a buffer only
//    feed columns the store masks).  A rolled tile of x is not a box: its 64
//    rows are x rows (m0 + i - shift) mod M, which may wrap around M at any
//    row, so the producer's 128 threads copy it with cp.async, 16 bytes
//    each, to the swizzled address swizzle128() gives.  A roll is therefore
//    free: just other source rows.  Rows past M and bytes past K are
//    zero-filled by cp.async (K % 16 == 0, so a chunk is wholly in or out).
//    Each producer thread waits for its copies, executes the proxy fence that
//    makes them visible to wgmma and arrives on the stage's full barrier,
//    one stage behind the one it is copying, so copies stay in flight.
//  - The ring needs 3 stages.  The producer fills chunk c only when the
//    consumer has released chunk c - stages, and signals chunk c - 1 as full
//    only after that; the consumer releases a chunk only once it has been
//    handed the next.  So filling chunk c waits for chunk c - stages + 1 to
//    be signalled, which the producer does while at chunk c - stages + 2:
//    an earlier chunk only if stages >= 3.  With 2 stages a block of 3 or
//    more chunks would wait on itself.
//  - Filling the card: at the tool's shapes M * N gives 32 to 128 tiles for
//    132 SMs.  Narrower tiles would halve the work per byte of w read, so
//    instead K is split over gridDim.z blocks (`split`, chosen by the
//    wrapper so that the grid stays within one wave, and only where that
//    saves a block enough chunks to pay for it) and each block adds its
//    partial sums with red.global.add into an output the wrapper zeroed.
//    Integer addition is exact in any order, so the result is bit-equal to
//    the plain version's.  With split == 1 the tile is stored, not added.
//    Measured on an H100 80GB HBM3 at 700 W (tools/mma_probe.py prints both
//    per shape): a launch moves about 40 KB/us from L2 into each SM it
//    occupies, so at (1024, 1728, 192) 96 blocks take 16.2 us where 48
//    take 24.8, and at (1024, 864, 128) 128 blocks take 8.3 us where 32
//    take 13.2.  Zeroing and adding cost 2 to 4 us a launch, about what a
//    block takes for 2 or 3 chunks: at 512^3 (4 chunks) a split in two took
//    9.0 us against 8.2 us unsplit, so the wrapper splits only where a block
//    is saved 3 chunks or more.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "wgmma_s8.cuh"

namespace {

using namespace dlmcq;

constexpr int BM = WGMMA_M;                  // 64 output rows a block
constexpr int BN = 64;                       // 64 output columns a block
constexpr int TILE_BYTES = BM * TILE_K;      // one 64-row operand tile (BN == BM)
constexpr int THREADS = 2 * WG_THREADS;      // consumer + producer warpgroup
constexpr int MAX_STAGES = 4;
constexpr int MIN_STAGES = 3;                // both sides signal one stage late
constexpr int BARRIER_BYTES = 2 * MAX_STAGES * 8;
constexpr int MAX_TILES = (MAX_SMEM - BARRIER_BYTES) / TILE_BYTES / MIN_STAGES;
constexpr int CHUNKS_16 = TILE_K / 16;       // 16-byte chunks in a tile row

__global__ void __launch_bounds__(THREADS)
int8_mma_probe_kernel(const __grid_constant__ CUtensorMap map_w,
                      const int8_t* __restrict__ x, int32_t* __restrict__ out,
                      int M, int N, int K, int nbufs, int rolls, int stages) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  if (base % ATOM_BYTES != 0) __trap();  // the swizzle needs the alignment
  const int stage_bytes = (rolls + nbufs) * TILE_BYTES;
  const uint32_t full = base + stages * stage_bytes;
  const uint32_t empty = full + MAX_STAGES * 8;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  // this block's K chunks: an even share of all, never empty (split <= chunks)
  const int chunks = (K + TILE_K - 1) / TILE_K;
  const int kc_begin = static_cast<int>(
      static_cast<long long>(blockIdx.z) * chunks / gridDim.z);
  const int kc_end = static_cast<int>(
      static_cast<long long>(blockIdx.z + 1) * chunks / gridDim.z);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1 + WG_THREADS);  // expect_tx + every producer
      mbar_init(empty + 8 * s, 4);              // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4) {
    // producer warpgroup
    const int p = threadIdx.x - WG_THREADS;
    if (p == 0) tma_prefetch_map(&map_w);
    int stage = 0, prev = -1;
    uint32_t parity = 1;
    for (int kc = kc_begin; kc < kc_end; ++kc) {
      mbar_wait(empty + 8 * stage, parity);
      const uint32_t a = base + stage * stage_bytes;
      if (p == 0) {
        mbar_arrive_expect_tx(full + 8 * stage, nbufs * TILE_BYTES);
        for (int j = 0; j < nbufs; ++j)
          tma_load_2d(a + (rolls + j) * TILE_BYTES, &map_w, full + 8 * stage,
                      kc * TILE_K, j * N + n0);
      }
      for (int r = 0; r < rolls; ++r) {
        const int shift = static_cast<int>((128LL * r) % M);
        for (int i = p; i < BM * CHUNKS_16; i += WG_THREADS) {
          const int row = i / CHUNKS_16;
          const int k = kc * TILE_K + 16 * (i % CHUNKS_16);
          const bool valid = m0 + row < M && k < K;
          int src = m0 + row - shift;
          if (src < 0) src += M;
          cp_async16(a + r * TILE_BYTES + swizzle128(row, 16 * (i % CHUNKS_16)),
                     valid ? x + static_cast<long long>(src) * K + k : x,
                     valid);
        }
      }
      cp_async_commit();
      if (prev >= 0) {
        cp_async_wait<1>();  // the stage before this one has landed
        fence_proxy_async();
        mbar_arrive(full + 8 * prev);
      }
      prev = stage;
      if (++stage == stages) {
        stage = 0;
        parity ^= 1;
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    mbar_arrive(full + 8 * prev);
    return;
  }

  // consumer warpgroup
  int acc[BN / 2];
  int stage = 0, prev = -1, scale_d = 0;
  uint32_t parity = 0;
  for (int kc = kc_begin; kc < kc_end; ++kc) {
    mbar_wait(full + 8 * stage, parity);
    const uint32_t a = base + stage * stage_bytes;
    wgmma_fence();
    for (int r = 0; r < rolls; ++r) {
      const uint64_t da = smem_desc(a + r * TILE_BYTES);
      for (int j = 0; j < nbufs; ++j) {
        const uint64_t db = smem_desc(a + (rolls + j) * TILE_BYTES);
#pragma unroll
        for (int kk = 0; kk < TILE_K / WGMMA_K; ++kk) {
          Wgmma<BN>::mma(acc, da + kk * DESC_K_STEP, db + kk * DESC_K_STEP,
                         scale_d);
          scale_d = 1;
        }
      }
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();  // the group before this one has read its stage
      if (lane == 0) mbar_arrive(empty + 8 * prev);
    }
    prev = stage;
    if (++stage == stages) {
      stage = 0;
      parity ^= 1;
    }
  }
  wgmma_wait<0>();
  acc_fence(acc);
  if (gridDim.z > 1)
    store_acc<BN, true>(out, acc, m0, n0, M, N);
  else
    store_acc<BN, false>(out, acc, m0, n0, M, N);
}

}  // namespace

extern "C" {

// Most operand tiles (rolls + nbufs) one launch can stage.
int dlmcq_int8_mma_probe_max_tiles() { return MAX_TILES; }

// out (m, n) int32 = sum over rolls and buffers (see above); x (m, k) int8,
// w packed as (nbufs, n, kp) int8.  K is split over `split` blocks
// (1 <= split <= ceil(k / 128)); with split > 1 the partial sums are added
// to `out`, which the caller has zeroed.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int dlmcq_int8_mma_probe(const void* x, const void* w, void* out, int m,
                         int n, int k, int kp, int nbufs, int rolls,
                         int split, void* stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      int8_mma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int chunks = (k + TILE_K - 1) / TILE_K;
  if (rolls < 1 || nbufs < 1 || rolls + nbufs > MAX_TILES || split < 1 ||
      split > chunks || static_cast<long long>(nbufs) * n > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const int fit = (MAX_SMEM - BARRIER_BYTES) / TILE_BYTES / (rolls + nbufs);
  const int stages = fit < MAX_STAGES ? fit : MAX_STAGES;  // >= MIN_STAGES
  const int smem = stages * (rolls + nbufs) * TILE_BYTES + BARRIER_BYTES;
  CUtensorMap map_w;
  const int err = encode_tile_map(
      &map_w, w, static_cast<uint64_t>(nbufs) * n, kp, kp, BN);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>((m + BM - 1) / BM),
                  static_cast<unsigned>((n + BN - 1) / BN),
                  static_cast<unsigned>(split));
  int8_mma_probe_kernel<<<grid, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      map_w, static_cast<const int8_t*>(x), static_cast<int32_t*>(out), m, n,
      k, nbufs, rolls, stages);
  return static_cast<int>(cudaGetLastError());
}

const char* dlmcq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
