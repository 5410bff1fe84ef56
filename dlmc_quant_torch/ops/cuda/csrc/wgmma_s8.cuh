// Hopper (sm_90a) building blocks for int8 tensor-core kernels that feed
// wgmma from shared memory: the 128-byte swizzle, the shared-memory matrix
// descriptor, wgmma.mma_async s8 x s8 -> s32 at the widths this package
// uses, its fences, the accumulator's lane map with a masked store,
// mbarriers, the TMA tile load with its host-side tensor map and the bulk
// copy that needs none, and the cp.async and st.shared pieces a producer
// needs to write the same swizzled layout by hand (for a tile TMA cannot
// describe: rolled or gathered rows, a padded halo, a weight unpacked from
// nibbles).
//
// One tile layout serves everything here.  A tile is ROWS x 128 bytes, K
// contiguous within a row ("K-major"; for 8-bit types wgmma takes both
// operands only so), rows 128 bytes apart, the tile's base 1024-byte aligned
// in shared memory.  Within each group of 8 rows (1024 bytes, the swizzle
// atom) the 16-byte chunk c of row r lies at chunk position c ^ (r % 8).
// TMA writes that layout with CU_TENSOR_MAP_SWIZZLE_128B, swizzle128() below
// is its address function, and smem_desc() describes it to wgmma.  The three
// must agree: a mismatch gives wrong numbers, not an error.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace dlmcq {

constexpr int WG_THREADS = 128;   // a warpgroup: 4 warps, the first a multiple of 4
constexpr int WGMMA_M = 64;       // rows of one wgmma (16 per warp)
constexpr int WGMMA_K = 32;       // bytes of K one s8 wgmma consumes
constexpr int TILE_K = 128;       // bytes of K in a tile row: the swizzle width
constexpr int ATOM_BYTES = 1024;  // 8 rows x 128 bytes: the swizzle repeats
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may opt in to

// ---------------------------------------------------------------- swizzle

// Byte offset, from the tile's 1024-byte aligned base, of byte `byte`
// (0..127, along K) of row `row`.  The hardware XORs address bits [4:6]
// with bits [7:9]; with an aligned base that is chunk ^ (row % 8).
__host__ __device__ constexpr uint32_t swizzle128(uint32_t row,
                                                  uint32_t byte) {
  return row * TILE_K + ((((byte >> 4) ^ row) & 7u) << 4) + (byte & 15u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- descriptor

// The 64-bit shared-memory matrix descriptor of a K-major, 128-byte
// swizzled tile that starts at shared address `addr`:
//   bits  0-13  start address >> 4
//   bits 16-29  leading byte offset >> 4: not used by a swizzled K-major
//               tile whose row is one swizzle width; 1 by convention
//   bits 32-45  stride byte offset >> 4: from one 8-row group to the next,
//               1024 bytes
//   bits 49-51  base offset: 0, the tile is 1024-byte aligned
//   bits 62-63  layout: 1 = 128-byte swizzle
// The k-th 32-byte slice of the 128-byte row is the same descriptor with
// 32*k bytes added to the start address (+2*k in the low field): the
// hardware applies the XOR to the address it computes.  A wgmma reads 64
// rows of A from its descriptor and N rows of B.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(ATOM_BYTES >> 4) << 32) | (1ull << 62);
}

constexpr uint64_t DESC_K_STEP = WGMMA_K >> 4;  // added per 32-byte K slice

// ------------------------------------------------------------------ wgmma

// d (64 x N s32) = (scale_d ? d : 0) + A (64 x 32 s8) * B (32 x N s8), A and
// B read from shared memory through descriptors, d held in N/2 registers a
// thread (lane map below).  Asynchronous: between wgmma_fence() and the
// wgmma_wait that covers it, d must not be touched and the tiles must not
// be overwritten.  All 128 threads of a warpgroup execute it together.  N
// must be in the ISA's list for integer wgmma (8, 16, 24, 32, 48, 64, 80,
// 96, ..., 256 in steps of 16); ptxas refuses any other.
template <int N>
struct Wgmma;

#define DLMCQ_ACC8(d, i)                                              \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),         \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(int (&d)[24], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23}, "
        "%24, %25, p;\n}\n"
        : DLMCQ_ACC8(d, 0), DLMCQ_ACC8(d, 8), DLMCQ_ACC8(d, 16)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : DLMCQ_ACC8(d, 0), DLMCQ_ACC8(d, 8), DLMCQ_ACC8(d, 16), DLMCQ_ACC8(d, 24)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(int (&d)[48], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p;\n}\n"
        : DLMCQ_ACC8(d, 0), DLMCQ_ACC8(d, 8), DLMCQ_ACC8(d, 16), DLMCQ_ACC8(d, 24),
          DLMCQ_ACC8(d, 32), DLMCQ_ACC8(d, 40)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : DLMCQ_ACC8(d, 0), DLMCQ_ACC8(d, 8), DLMCQ_ACC8(d, 16), DLMCQ_ACC8(d, 24),
          DLMCQ_ACC8(d, 32), DLMCQ_ACC8(d, 40), DLMCQ_ACC8(d, 48), DLMCQ_ACC8(d, 56)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void mma(int (&d)[96], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63, "
        " %64, %65, %66, %67, %68, %69, %70, %71, "
        " %72, %73, %74, %75, %76, %77, %78, %79, "
        " %80, %81, %82, %83, %84, %85, %86, %87, "
        " %88, %89, %90, %91, %92, %93, %94, %95}, "
        "%96, %97, p;\n}\n"
        : DLMCQ_ACC8(d, 0), DLMCQ_ACC8(d, 8), DLMCQ_ACC8(d, 16), DLMCQ_ACC8(d, 24),
          DLMCQ_ACC8(d, 32), DLMCQ_ACC8(d, 40), DLMCQ_ACC8(d, 48), DLMCQ_ACC8(d, 56),
          DLMCQ_ACC8(d, 64), DLMCQ_ACC8(d, 72), DLMCQ_ACC8(d, 80), DLMCQ_ACC8(d, 88)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63, "
        " %64, %65, %66, %67, %68, %69, %70, %71, "
        " %72, %73, %74, %75, %76, %77, %78, %79, "
        " %80, %81, %82, %83, %84, %85, %86, %87, "
        " %88, %89, %90, %91, %92, %93, %94, %95, "
        " %96, %97, %98, %99, %100, %101, %102, %103, "
        " %104, %105, %106, %107, %108, %109, %110, %111, "
        " %112, %113, %114, %115, %116, %117, %118, %119, "
        " %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p;\n}\n"
        : DLMCQ_ACC8(d, 0), DLMCQ_ACC8(d, 8), DLMCQ_ACC8(d, 16), DLMCQ_ACC8(d, 24),
          DLMCQ_ACC8(d, 32), DLMCQ_ACC8(d, 40), DLMCQ_ACC8(d, 48), DLMCQ_ACC8(d, 56),
          DLMCQ_ACC8(d, 64), DLMCQ_ACC8(d, 72), DLMCQ_ACC8(d, 80), DLMCQ_ACC8(d, 88),
          DLMCQ_ACC8(d, 96), DLMCQ_ACC8(d, 104), DLMCQ_ACC8(d, 112), DLMCQ_ACC8(d, 120)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
#undef DLMCQ_ACC8

// Orders this thread's earlier register and shared-memory accesses before
// the wgmmas that follow; needed before the first wgmma and after the
// accumulator was read or written by ordinary instructions.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Closes the wgmmas started since the last commit into one group.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most PENDING of this warpgroup's committed groups are
// still running.  Only then may their accumulators be read and the
// shared-memory tiles they read be refilled.
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator across
// this point (the wgmmas that own it are invisible to it).
template <int R>
__device__ __forceinline__ void acc_fence(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ------------------------------------------------------ accumulator store

// The accumulator's lane map: thread t of the warpgroup (warp = t / 32,
// lane = t % 32) holds, in d[4*i + 2*h + e], the element of row
// 16*warp + lane/4 + 8*h and column 8*i + 2*(lane%4) + e.
//
// Writes a warpgroup's 64 x N accumulator, whose top-left element is output
// element (row0, col0), into out, rows x cols int32 row-major, skipping what
// lies past `rows` or `cols`.  The 4 lanes of a quad write the 8
// consecutive columns of one row: 32 bytes, one full sector per store
// instruction and row.  With ATOMIC the values are added (red.global.add)
// to what is there: integer addition is exact in any order, so partial sums
// of a split K may arrive in any order.
template <int N, bool ATOMIC>
__device__ __forceinline__ void store_acc(int32_t* __restrict__ out,
                                          const int (&d)[N / 2],
                                          long long row0, int col0,
                                          long long rows, int cols) {
  const int t = threadIdx.x % WG_THREADS;
  const long long r = row0 + 16 * (t / 32) + (t % 32) / 4;
  const int c = col0 + 2 * (t % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = r + 8 * h;
    if (row >= rows) continue;
    int32_t* o = out + row * cols;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const int col = c + 8 * i;
      const int v0 = d[4 * i + 2 * h];
      const int v1 = d[4 * i + 2 * h + 1];
      if (ATOMIC) {
        if (col < cols) atomicAdd(o + col, v0);
        if (col + 1 < cols) atomicAdd(o + col + 1, v1);
      } else if (cols % 2 == 0 && col + 1 < cols) {
        *reinterpret_cast<int2*>(o + col) = make_int2(v0, v1);
      } else {
        if (col < cols) o[col] = v0;
        if (col + 1 < cols) o[col + 1] = v1;
      }
    }
  }
}

// --------------------------------------------------------------- mbarrier

// A 64-bit barrier in shared memory (address from smem_u32) that counts
// thread arrivals and bytes a TMA load has delivered.  It completes a phase
// when `count` arrivals and all expected bytes are in, then starts the next.

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// After the inits, before any thread or the TMA unit uses the barriers;
// follow it with __syncthreads().
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0 and counts "phase 1" as completed, so a producer that waits
// for an empty slot starts with parity 1 and a consumer that waits for a
// full one with parity 0; each flips its parity when its ring wraps.  A
// wrong parity would wait for ever: after ~2 s of spinning the kernel traps,
// so a fault shows as a launch error, not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > 4000000000LL) __trap();
}

// -------------------------------------------------------------------- TMA

// Copies the box of `map` whose first element is (x = byte along K,
// y = row) into shared memory at `dst` (1024-byte aligned for a swizzled
// tile) and reports the bytes to `bar`.  Executed by one thread.  Whatever of
// the box lies outside the tensor is written as zero and still counted, so
// a ragged edge needs no masks and the expected bytes are always the box.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// Copies `bytes` consecutive bytes (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory and reports them to `bar`: the
// bulk copy that needs no tensor map.  Executed by one thread.
__device__ __forceinline__ void bulk_load_1d(uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Host side: the tensor map of a row-major int8 matrix of `rows` rows,
// `row_bytes` valid bytes a row and `pitch` bytes from row to row, cut into
// boxes of box_rows x 128 bytes written with the 128-byte swizzle.  TMA
// needs a 16-byte aligned base and a pitch that is a multiple of 16.  The
// map is passed to the kernel by value as a `const __grid_constant__`
// parameter.  cuTensorMapEncodeTiled is looked up through the runtime, so
// nothing links against libcuda.  L2 promotion to 128 bytes measured 3-8 %
// faster than 256 at RepVGG-A0's bytes-bound GEMM shapes, whose rows are
// not multiples of 128 bytes (H100 80GB HBM3).  Returns a cudaError_t value
// (0 = ok).
//
// With swizzle = false the box is box_rows x box_bytes bytes, written
// row after row with no swizzle (box_bytes a multiple of 16): a staging
// tile that threads read, such as a nibble-packed weight before it is
// unpacked.
inline int encode_tile_map(CUtensorMap* map, const void* base, uint64_t rows,
                           uint64_t row_bytes, uint64_t pitch,
                           uint32_t box_rows, uint32_t box_bytes = TILE_K,
                           bool swizzle = true) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {row_bytes, rows};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box_bytes, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// --------------------------------------------------- cp.async producer

// 16 bytes global -> shared (address from smem_u32) without passing through
// registers; with full == false nothing is read and the 16 bytes are set to
// zero.  A producer that fills a swizzled tile by hand writes chunk c of
// row r to base + swizzle128(r, 16 * c).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// 8 bytes from 8-byte aligned global memory, or 8 zeros where !full (the
// source is then not read).
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most PENDING of this thread's committed groups are in
// flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// cp.async and ordinary stores write shared memory through the generic
// proxy, wgmma reads it through the async proxy: after its copies have
// landed and before it signals the barrier, each writing thread executes this.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes from registers to shared memory (address from smem_u32): how a
// producer writes a chunk that no copy can fetch (a padded border, bytes
// gathered one by one).  It goes through the generic proxy like cp.async,
// so the same fence_proxy_async() before the barrier covers it.
__device__ __forceinline__ void st_shared16(uint32_t dst, uint32_t w0,
                                            uint32_t w1, uint32_t w2,
                                            uint32_t w3) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(w0), "r"(w1), "r"(w2), "r"(w3)
               : "memory");
}

// ------------------------------------------------------------ W4 weights

// A weight of 4 bits or fewer is kept two values a byte, value 2j in the
// low nibble of byte j (ops/cuda/nibbles.py).  wgmma has no s4 operand, so
// a kernel unpacks it to int8 where it writes its weight into shared
// memory.  unpack_nibbles16 turns 8 packed bytes (p0: values 0..7, p1:
// values 8..15) into the 16 int8 bytes of one chunk, w[i] holding values
// 4i..4i+3: the nibbles are masked bytewise, sign-extended (sext_nibbles)
// and interleaved by byte permutes.

// Each byte of v, a nibble 0..15, sign-extended to int8: (v ^ 8) - 8, done
// as v | 0xF0 where bit 3 is set.  The multiply puts 0xF0 in every byte
// whose bit 3 is set (8 * 0x1E = 0xF0: no byte carries into the next).
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {
  return v | ((v & 0x08080808u) * 0x1Eu);
}

__device__ __forceinline__ void unpack_nibbles16(uint32_t p0, uint32_t p1,
                                                 uint32_t (&w)[4]) {
  const uint32_t p[2] = {p0, p1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // lo: values 0, 2, 4, 6 of the word; hi: values 1, 3, 5, 7
    const uint32_t lo = sext_nibbles(p[h] & 0x0F0F0F0Fu);
    const uint32_t hi = sext_nibbles((p[h] >> 4) & 0x0F0F0F0Fu);
    w[2 * h] = __byte_perm(lo, hi, 0x5140);
    w[2 * h + 1] = __byte_perm(lo, hi, 0x7362);
  }
}

// 8 bytes from shared memory (address from smem_u32, 8-byte aligned).
__device__ __forceinline__ uint2 ld_shared8(uint32_t src) {
  uint2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(src)
               : "memory");
  return v;
}

}  // namespace dlmcq
