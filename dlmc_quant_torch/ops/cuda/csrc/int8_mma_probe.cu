// int8 tensor-core rate probe with operands resident in shared memory, for
// Hopper (sm_90a).
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
// or of the same order at the tool's shapes.
//
// Design: "resident in fast memory" becomes resident in shared memory.  A
// block of 4 warps owns a 64 x 64 output tile (64 so that the tool's small
// shapes still spread over many SMs).  For each 64-byte K chunk it stages,
// with cp.async, the 64 A rows of every roll (each roll's rows are the
// rolled row indices, so the roll costs nothing in the inner loop) and the
// 64 B rows of every weight buffer, double-buffered; then it issues all
// rolls * nbufs MMA passes from shared memory before the next chunk, so the
// inner loop is shared loads and mma.sync only.  B is packed per buffer as
// (N, Kp) int8, K contiguous per output column, zero-padded to a multiple of
// 32.  Shared memory grows with rolls + nbufs and needs more than the
// default 48 KB, so the kernel opts in with cudaFuncSetAttribute once.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_s8.cuh"

namespace {

using namespace dlmcq;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int WM = 2;
constexpr int WN = 2;
constexpr int THREADS = WM * WN * 32;
constexpr int MI = BM / WM / 16;
constexpr int NI = BN / WN / 8;
constexpr int TILE_BYTES = BM * LDS;  // one staged 64-row operand tile (BN == BM)
constexpr int MAX_SMEM = 232448;      // what one block may use on an H100

__global__ void __launch_bounds__(THREADS)
int8_mma_probe_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ w, int32_t* __restrict__ out,
                      int M, int N, int K, int Kp, int nbufs, int rolls) {
  extern __shared__ __align__(16) int8_t smem[];
  const int stage_bytes = (rolls + nbufs) * TILE_BYTES;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const auto b_row = [&](int r) -> long long {
    return n0 + r < N ? n0 + r : -1;
  };
  const auto stage = [&](int kt) {
    int8_t* base = smem + (kt % STAGES) * stage_bytes;
    for (int r = 0; r < rolls; ++r) {
      const int shift = static_cast<int>((128LL * r) % M);
      stage_tile<BM, THREADS>(
          base + r * TILE_BYTES, x, K, kt * BK, K, [&](int i) -> long long {
            if (m0 + i >= M) return -1;
            const int src = m0 + i - shift;
            return src < 0 ? src + M : src;
          });
    }
    for (int j = 0; j < nbufs; ++j)
      stage_tile<BN, THREADS>(base + (rolls + j) * TILE_BYTES,
                              w + static_cast<long long>(j) * N * Kp, Kp,
                              kt * BK, K, b_row);
  };

  int acc[MI][NI][4] = {};
  k_loop((K + BK - 1) / BK, stage, [&](int kt) {
    const int8_t* base = smem + (kt % STAGES) * stage_bytes;
#pragma unroll
    for (int kk = 0; kk < BK; kk += MMA_K) {
      for (int r = 0; r < rolls; ++r) {
        uint32_t af[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
          load_a(af[i], base + r * TILE_BYTES, (wm * MI + i) * 16, kk, lane);
        for (int j = 0; j < nbufs; ++j) {
          const int8_t* bt = base + (rolls + j) * TILE_BYTES;
          uint32_t bf[NI][2];
#pragma unroll
          for (int q = 0; q < NI; ++q)
            load_b(bf[q], bt, (wn * NI + q) * 8, kk, lane);
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int q = 0; q < NI; ++q) mma_s8(acc[i][q], af[i], bf[q]);
        }
      }
    }
  });
  store_acc(out, acc, m0 + wm * MI * 16, n0 + wn * NI * 8, M, N, lane);
}

}  // namespace

extern "C" {

// Most operand tiles (rolls + nbufs) one launch can stage.
int dlmcq_int8_mma_probe_max_tiles() {
  return MAX_SMEM / (STAGES * TILE_BYTES);
}

// out (m, n) int32 = sum over rolls and buffers (see above); x (m, k) int8,
// w packed as (nbufs, n, kp) int8.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int dlmcq_int8_mma_probe(const void* x, const void* w, void* out, int m,
                         int n, int k, int kp, int nbufs, int rolls,
                         void* stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      int8_mma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int smem = STAGES * (rolls + nbufs) * TILE_BYTES;
  if (rolls < 1 || nbufs < 1 || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((m + BM - 1) / BM),
                  static_cast<unsigned>((n + BN - 1) / BN));
  int8_mma_probe_kernel<<<grid, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), m, n, k, kp, nbufs, rolls);
  return static_cast<int>(cudaGetLastError());
}

const char* dlmcq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
