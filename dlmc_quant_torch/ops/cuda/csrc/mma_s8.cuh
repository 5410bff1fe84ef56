// int8 tensor-core building blocks shared by int8_gemm.cu and
// int8_mma_probe.cu: the warp-level mma.sync.m16n8k32 s8 x s8 -> s32
// instruction, its fragment loads from shared memory, the staging of a
// K-contiguous int8 tile from global into shared memory with cp.async, the
// double-buffered K loop and the store of the int32 accumulators.
//
// Shared-memory tiles hold ROWS x BK bytes, K contiguous within a row, with
// a row pitch of LDS = BK + 16 bytes.  For BK = 64 the pitch is 20 words,
// so the 8 rows and 4 word columns that one fragment load touches fall on
// 32 distinct banks.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dlmcq {

constexpr int MMA_K = 32;        // depth of one mma.sync m16n8k32 (bytes)
constexpr int BK = 64;           // K bytes staged per step
constexpr int LDS = BK + 16;     // shared row pitch in bytes

// c (16x8 s32) += a (16x32 s8, row-major) * b (32x8 s8, column-major).
// With lane = 4*g + t, the fragments are (PTX ISA, mma.m16n8k32 .s8):
//   a[0] = A[g][4t..4t+3]      a[1] = A[g+8][4t..4t+3]
//   a[2] = A[g][16+4t..]       a[3] = A[g+8][16+4t..]
//   b[0] = B[4t..4t+3][g]      b[1] = B[16+4t..16+4t+3][g]
//   c[0] = C[g][2t]  c[1] = C[g][2t+1]  c[2] = C[g+8][2t]  c[3] = C[g+8][2t+1]
// four consecutive bytes of one register in ascending K.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment of rows row0..row0+15, K bytes k..k+31 of a shared tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* tile,
                                       int row0, int k, int lane) {
  const int8_t* p = tile + (row0 + (lane >> 2)) * LDS + k + 4 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
}

// A B fragment of columns col0..col0+7 (tile rows, since B is stored with K
// contiguous per output column), K bytes k..k+31.
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const int8_t* tile,
                                       int col0, int k, int lane) {
  const int8_t* p = tile + (col0 + (lane >> 2)) * LDS + k + 4 * (lane & 3);
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 16);
}

// 16 bytes global -> shared without passing through registers; with
// full == false nothing is read and the 16 shared bytes are set to zero.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Starts the copy of K bytes k0..k0+BK-1 of ROWS rows into a shared tile,
// 16 bytes per thread per step.  Tile row r comes from global row
// row_of(r) of `base` (row pitch `ld` bytes); a negative row_of(r) gives a
// zero row, and bytes at K >= kend are zero.  Needs ld % 16 == 0,
// kend % 16 == 0 and a 16-byte aligned base, so that each 16-byte chunk
// lies wholly inside or outside.  The caller commits and waits.
template <int ROWS, int THREADS, class RowOf>
__device__ __forceinline__ void stage_tile(int8_t* tile,
                                           const int8_t* __restrict__ base,
                                           long long ld, int k0, int kend,
                                           RowOf row_of) {
  constexpr int CHUNKS = BK / 16;
  constexpr int STEPS = (ROWS * CHUNKS + THREADS - 1) / THREADS;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int i = threadIdx.x + s * THREADS;
    if (ROWS * CHUNKS % THREADS != 0 && i >= ROWS * CHUNKS) break;
    const int r = i / CHUNKS;
    const int k = k0 + 16 * (i % CHUNKS);
    const long long row = row_of(r);
    const bool full = row >= 0 && k < kend;
    cp_async16(tile + r * LDS + 16 * (i % CHUNKS),
               full ? base + row * ld + k : base, full);
  }
}

// Walks K in chunks of BK bytes, double-buffered: stage(kt) starts the
// copies of chunk kt into buffer kt % STAGES, compute(kt) reads that buffer
// once the chunk has landed, while the next chunk's copies are in flight.
constexpr int STAGES = 2;

template <class Stage, class Compute>
__device__ __forceinline__ void k_loop(int kt_end, Stage stage,
                                       Compute compute) {
  stage(0);
  cp_async_commit();
  for (int kt = 0; kt < kt_end; ++kt) {
    if (kt + 1 < kt_end) stage(kt + 1);
    cp_async_commit();     // an empty group on the last step keeps counts
    cp_async_wait<1>();    // chunk kt has landed
    __syncthreads();
    compute(kt);
    __syncthreads();       // the buffer is refilled next step
  }
}

// Writes a warp's MI x NI accumulator tiles (m16 x n8 each, top-left output
// element (row0, col0)) into out, M x N int32 row-major, skipping what lies
// past M or N.
template <int MI, int NI>
__device__ __forceinline__ void store_acc(int32_t* __restrict__ out,
                                          const int (&acc)[MI][NI][4],
                                          long long row0, int col0,
                                          long long M, int N, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + 16 * i + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = col0 + 8 * j + 2 * t;
        int32_t* o = out + row * N + col;
        const int v0 = acc[i][j][2 * h];
        const int v1 = acc[i][j][2 * h + 1];
        if (N % 2 == 0 && col + 1 < N) {
          *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
        } else {
          if (col < N) o[0] = v0;
          if (col + 1 < N) o[1] = v1;
        }
      }
    }
  }
}

}  // namespace dlmcq
