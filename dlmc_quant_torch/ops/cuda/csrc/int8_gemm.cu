// Tiled int8 x int8 -> int32 GEMM on the tensor cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/pallas_gemm_sweep.py:37 (make_pallas_gemm,
// body gemm_kernel at :31): out (M, N) int32 = x (M, K) int8 @ w (K, N) int8.
// The TPU kernel kept K resident in VMEM and gridded over (M/bm, N/bn),
// writing nothing where bm or bn does not divide M or N; here every edge is
// masked, so any M, N >= 1 and any K % 16 == 0 are right.
//
// Bound on an H100: max(2*M*N*K / 1979e12 int8 OP/s,
// (M*K + K*N + 4*M*N) bytes / 3.35e12 B/s).  At 4096^3 that is operations;
// at RepVGG's conv-as-GEMM shapes (N = 48..192) it is the bytes of x and of
// the int32 output.
//
// Design (simple first; wgmma, TMA and a persistent grid come later): one
// BM x BN output tile per block of 8 warps, each warp a (BM/WM) x (BN/WN)
// sub-tile of mma.sync.m16n8k32 s8 products accumulated in registers.  K is
// not resident (a 1024 x 4096 int8 tile would not fit a block's 227 KB): it
// is walked in 64-byte chunks, double-buffered in shared memory by
// cp.async, so the next chunk's copy overlaps this chunk's MMAs.  B comes
// packed from the host as (N, Kp) int8, K contiguous per output column and
// zero-padded to Kp = roundup(K, 32), because the MMA wants B column-major
// and int8 has no ldmatrix.trans.  Rows past M or N and bytes past K are
// zero-filled by cp.async itself, so the inner loop has no masks.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_s8.cuh"

namespace {

using namespace dlmcq;

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 int32_t* __restrict__ out, int M, int N, int K, int Kp) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int MI = BM / WM / 16;  // m16 tiles per warp
  constexpr int NI = BN / WN / 8;   // n8 tiles per warp
  __shared__ __align__(16) int8_t as[STAGES][BM * LDS];
  __shared__ __align__(16) int8_t bs[STAGES][BN * LDS];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const auto a_row = [&](int r) -> long long {
    return m0 + r < M ? m0 + r : -1;
  };
  const auto b_row = [&](int r) -> long long {
    return n0 + r < N ? n0 + r : -1;
  };
  const auto stage = [&](int kt) {
    const int buf = kt % STAGES;
    stage_tile<BM, THREADS>(as[buf], x, K, kt * BK, K, a_row);
    stage_tile<BN, THREADS>(bs[buf], w, Kp, kt * BK, K, b_row);
  };

  int acc[MI][NI][4] = {};
  k_loop((K + BK - 1) / BK, stage, [&](int kt) {
    const int8_t* at = as[kt % STAGES];
    const int8_t* bt = bs[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += MMA_K) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        load_a(af[i], at, (wm * MI + i) * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < NI; ++j)
        load_b(bf[j], bt, (wn * NI + j) * 8, kk, lane);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  });
  store_acc(out, acc, m0 + wm * MI * 16, n0 + wn * NI * 8, M, N, lane);
}

template <int BM, int BN, int WM, int WN>
int launch(const int8_t* x, const int8_t* w, int32_t* out, int m, int n,
           int k, int kp, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((m + BM - 1) / BM),
                  static_cast<unsigned>((n + BN - 1) / BN));
  int8_gemm_kernel<BM, BN, WM, WN><<<grid, WM * WN * 32, 0, s>>>(
      x, w, out, m, n, k, kp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (m, n) int32 = x (m, k) int8 @ w, with w packed as (n, kp) int8.
// (bm, bn) is one of the compiled tiles: (128, 128), (128, 64), (64, 128).
// Launches on `stream`; returns cudaGetLastError() (0 on success).
int dlmcq_int8_gemm(const void* x, const void* w, void* out, int m, int n,
                    int k, int kp, int bm, int bn, void* stream) {
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  auto* op = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 128 && bn == 128)
    return launch<128, 128, 2, 4>(xp, wp, op, m, n, k, kp, s);
  if (bm == 128 && bn == 64)
    return launch<128, 64, 4, 2>(xp, wp, op, m, n, k, kp, s);
  if (bm == 64 && bn == 128)
    return launch<64, 128, 2, 4>(xp, wp, op, m, n, k, kp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* dlmcq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
