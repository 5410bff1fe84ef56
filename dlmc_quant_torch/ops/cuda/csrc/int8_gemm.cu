// Tiled int8 x int8 -> int32 GEMM on the tensor cores, for Hopper (sm_90a):
// wgmma from swizzled shared memory, fed by TMA.
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
// the int32 output, which is a third to a half of all bytes moved.
//
// Design.  Only wgmma reaches the card's int8 rate, and it reads both
// operands from shared memory by descriptor, so no thread loads a fragment.
//  - Operands: w comes packed from the host as (N, Kp) int8, K contiguous
//    per output column, zero past K: the K-major B that s8 wgmma wants.  x
//    is K-major as it is.  Both are described to TMA by tensor maps made on
//    the host at every launch and passed by value, so a captured launch
//    keeps its own maps.
//  - A ring of STAGES stages in dynamic shared memory, each a BM x 128-byte
//    tile of x and a BN x 128-byte tile of w in the 128-byte swizzle
//    (wgmma_s8.cuh).  One producer thread keeps TMA loads in flight, a full
//    and an empty mbarrier per stage hand the stages back and forth.  TMA
//    writes zeros for rows past M or N and bytes past K, so the inner loop
//    has no masks and K = 432 simply ends in a partly empty stage.
//  - BM / 64 consumer warpgroups, each 64 rows of the tile: per stage four
//    wgmma m64nBNk32 on the 32-byte slices of the 128-byte rows, one commit
//    group per stage, and a stage is handed back when the group after it has
//    been queued and wait_group<1> says its own is done, so the tensor cores
//    always have one group queued.
//  - A persistent grid: as many blocks as fit the card at once (occupancy x
//    SMs) walk the tiles, tile t + i * gridDim.x for block t, M fastest so
//    that neighbours share a w tile in L2.  The producer runs ahead into the
//    next tile while the consumers store this one, which hides the epilogue
//    and, for the short-K shapes (K = 432: 4 stages a tile), the load
//    latency.  Where M*N gives fewer tiles than SMs (M = 48 channel-major:
//    128 tiles of 64 x 128) the grid is just the tiles; the default tile
//    (int8_gemm.py) weighs waves against padding and operand re-reads.
//    Measured on an H100 80GB HBM3 at 700 W (tools/gemm_sweep.py): 4096^3
//    takes 103 us at 128 x 256 (512 tiles, 3.9 waves of 132 blocks) against
//    117 us at 128 x 128 (1024 tiles on 264 blocks); (192, 1728) x
//    (1728, 16384) takes 20.3 us as 128 tiles of 128 x 256, a quarter of
//    their rows padding, against 21.2 us as 384 exact tiles of 64 x 128.
//    What is not hidden: all blocks finish their tiles together, so at
//    4096^3 the stores of a wave still meet idle tensor cores.  On the
//    staged route (below) an epilogue mode takes a tile at most 128 wide by
//    default, so that two or more blocks share an SM and one block's
//    epilogue runs beside another's products and loads.
//  - Tiles are as wide as the repo's N: 48, 96, 192 exactly (wgmma has
//    those widths), 128 and 256 for wide outputs, 64-row tiles for M < 128.
//  - The accumulator goes to global memory straight from registers: a quad
//    of lanes writes 8 consecutive int32 of a row, one full 32-byte sector
//    (the register route; the staged route stores it through shared
//    memory by TMA, below).
//
// Epilogue modes (the int8 conv's, int8_conv3x3.cu, as the chained int8
// path of a 1x1 conv and of the im2col'd 7x7 stem needs them): besides
// the int32 accumulator ("int32", the tools' output), per output column o
//   codes: out = clamp(rint(f32(acc)*a[o] + b[o]), lo, hi)           -> int8
//   f32:   out = f32(acc)*a[o] + b[o], then max(., 0) if relu       -> f32
//   codes with a residual r (M, N) of int8, int32 or f32 (a Bottleneck's
//   conv3 closing its block, as chain.fold_sum_quantize orders the sum):
//          out = clamp(rint((((qb + f32(acc)*a[o]) + b[o]) + f32(r)*ar[o])
//                           + br[o]), lo, hi)                       -> int8
//   with a row term (S (M,) int32, c (N,) f32: a weight offset's term, S
//   the window sums of int8_window_sum.cu), in every epilogue mode the
//   product f32(acc)*a[o] becomes f32(acc)*a[o] + f32(S[m])*c[o] (the
//   product and the sum each rounded) before the rest
// written with __int2float_rn, __fmul_rn and __fadd_rn (no fma
// contraction) and round half to even, so the kernel equals the plain
// version (ops/cuda/epilogue.py) bit for bit.  Bound with an epilogue: the
// output is N bytes a row (4 N for f32) and the residual adds its own; at
// ResNet-50's shapes every epilogue launch is bound by its bytes.
//
// Two routes end a tile, chosen on the host before the launch from the
// shapes and dtypes (int8_gemm.py: route), each a build of this file:
//  - The register route (this build): the epilogue from registers; a and
//    b (and ar, br, r) come through the read-only path a column pair at a
//    time, a quad of lanes writes 8 consecutive codes (or f32) of a row,
//    codes by __float2int_rn.  It takes every launch; the host sends it
//    those whose output or r rows are not whole 16 bytes, which TMA cannot
//    describe (MobileNetV2's 24 channels), and the int32 tiles the staged
//    build lacks.  What bounds its residual mode: a thread's 2 * BN / 8
//    loads of r each wait for the one before, and the 128 x 256 tile has
//    no registers to load ahead (ptxas gives it 168, the accumulator takes
//    128): ResNet-50's 16 residual GEMMs took 12.1-12.3 ms at batch 256
//    against a 1.2957 ms bound.  Each mode is an instantiation of its own,
//    compiled for the tiles of EPILOGUE_TILES (int8_gemm.py), so the int32
//    kernels keep their registers.
//  - The staged route (int8_gemm_staged.cu: DLMCQ_GEMM_STAGED): the
//    residual is staged by TMA into shared memory and the output stored
//    through it.  A warpgroup ends its 64 x BN block chunk by chunk, a
//    chunk 128 bytes of a row of the wider of r and the output (128
//    columns of codes or int8 r, 32 of int32 or f32; Staged).  Each chunk
//    has a slot: r's box (64 rows, TMA's swizzle of the row's width, so
//    the 8 rows of a lane map column fall in distinct banks) and the
//    output's box (an int8 r is overwritten in place by its codes).  A
//    warp of its own (the r loader) walks the same tiles and chunks as the
//    consumers and loads each warpgroup's next r box by TMA as soon as its
//    slot is handed back, so r is in flight during the tile's products and
//    the chunk before's epilogue; the consumers wait on the slot's r full
//    barrier after wgmma_wait<0>, read r in the accumulator's lane map,
//    write the output there, fence.proxy.async, meet at the warpgroup's
//    named barrier, and thread 0 stores the box by TMA (rows past M and
//    columns past N clipped) and hands the slot back: a wider r's at once,
//    an int8 r's after cp.async.bulk.wait_group.read says the store has
//    read its codes; an output slot is rewritten only after the store that
//    used it has read it (three slots in int32 mode, two elsewhere).  The
//    tile's per-column parameters (a, b, ar, br, c) are staged in shared
//    memory once for the tiles of a column block, and a code is rounded as
//    the low byte of clamp(y) + 1.5 * 2^23 and an int8 r converted as the
//    magic number's float less the magic number (the parameters from the
//    read-only path and the conversions took 40 % of an int8 r's launch).
//    What bounds the route at ResNet-50's shapes: the epilogue's own
//    instructions, four warpgroups an SM at 128 x 128 with 96 registers
//    each (PERF.md §6: leaving out the residual loads, the products or the
//    stores saves under 10 % of stage 1's int8 r launch, the arithmetic 23
//    %), and in int32 mode the stores (0.74 ms at the 4 downsamples,
//    torch._int_mm 0.69).  Two co-resident blocks of 128 x 128 (2 stages
//    of the ring) took half the time of one block of 128 x 256; two
//    consumer warpgroups taking turns on tiles were not built.  The row
//    term is read where srow is set (no instantiation of its own); a mode
//    is an instantiation by r's width.
//
// W4 weights (a layer of 4 bits or fewer): w comes nibble-packed, (N, Kp/2)
// bytes with K index 2j in the low nibble of byte j (ops/cuda/nibbles.py),
// and stays so in device memory.  TMA cannot unpack and wgmma reads only
// int8 B, so the packed BN x 64-byte tile of a stage is TMA-loaded
// (unswizzled) into one of two staging slots beside the ring and reported
// to that slot's "packed landed" barrier; then two producer warps expand
// each 8 packed bytes into one 16-byte int8 chunk (unpack_nibbles16: masks,
// a multiply that sign-extends every byte, byte permutes) and store it with
// st.shared.v4 at its swizzle128 address in the stage's B tile.  Those are
// generic-proxy writes that wgmma reads through the async proxy: every lane
// executes fence_proxy_async before its warp's lane 0 arrives on the
// stage's full barrier (count 3: A's expect_tx and the two warps), or wgmma
// may read stale bytes without any error.  Warp 0 loads stage j and then
// both warps unpack stage j - 1, so a packed tile's latency overlaps a
// stage's unpack and wait; a named barrier between the two warps closes
// each step, so a staging slot is refilled only once both have read it.
// One warp alone took 1.4x the W8 time at K = 512 (the unpack, ~20
// instructions a chunk, outran the tensor cores' stage; PERF.md §6).
// W4 is an instantiation of its own (template W4), compiled at
// EPILOGUE_TILES in every mode with the W8 stage counts (the two staging
// slots still fit) and on the staged route with at least 3 stages beside
// the epilogue slots; the W8 kernels are unchanged.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "wgmma_s8.cuh"

// 1 in the staged build (int8_gemm_staged.cu), 0 in the register build
#ifndef DLMCQ_GEMM_STAGED
#define DLMCQ_GEMM_STAGED 0
#endif

namespace {

using namespace dlmcq;

// what a consumer does with its finished accumulator
enum Epi { EPI_INT32 = 0, EPI_CODES = 1, EPI_RESIDUAL = 2, EPI_F32 = 3 };
// flags on an epilogue mode: a row term (register route: instantiations of
// their own, so that the epilogues without one keep their registers); the
// staged route; its residual of 4-byte r (int32 or f32; without the flag
// int8)
constexpr int EPI_TERM = 4;
constexpr int EPI_STAGED = 8;
constexpr int EPI_WIDE_R = 16;

struct Epilogue {
  void* out;          // (M, N): int32, int8 codes or f32 by the mode
  const float* a;     // (N,) per output column
  const float* b;
  const void* r;      // residual (M, N), r_kind: 1 int8, 2 int32, 3 f32
  const float* ar;
  const float* br;
  float qb;
  int lo, hi, relu, r_kind;
  const int* srow;    // the row term (or null): S (M,) int32
  const float* crow;  // and c (N,) f32
};

// The residual term of row `row`, columns `col` and `col` + 1 (col even,
// row < M, col < N), through the read-only path, both columns in one load
// where N is even and r aligned for it.
__device__ __forceinline__ void load_residual(const Epilogue& e,
                                              long long row, int col, int N,
                                              float rv[2]) {
  const long long at = row * N + col;
  const bool two = col + 1 < N;
  if (e.r_kind == 1) {
    const int8_t* r = static_cast<const int8_t*>(e.r) + at;
    if (two && reinterpret_cast<uintptr_t>(r) % 2 == 0) {
      const char2 v = __ldg(reinterpret_cast<const char2*>(r));
      rv[0] = v.x;
      rv[1] = v.y;
    } else {
      rv[0] = __ldg(r);
      if (two) rv[1] = __ldg(r + 1);
    }
  } else if (e.r_kind == 2) {
    const int* r = static_cast<const int*>(e.r) + at;
    if (two && reinterpret_cast<uintptr_t>(r) % 8 == 0) {
      const int2 v = __ldg(reinterpret_cast<const int2*>(r));
      rv[0] = __int2float_rn(v.x);
      rv[1] = __int2float_rn(v.y);
    } else {
      rv[0] = __int2float_rn(__ldg(r));
      if (two) rv[1] = __int2float_rn(__ldg(r + 1));
    }
  } else {
    const float* r = static_cast<const float*>(e.r) + at;
    if (two && reinterpret_cast<uintptr_t>(r) % 8 == 0) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(r));
      rv[0] = v.x;
      rv[1] = v.y;
    } else {
      rv[0] = __ldg(r);
      if (two) rv[1] = __ldg(r + 1);
    }
  }
}

// One output value of an epilogue mode (codes, f32 or residual: the
// header's formulas), each step one rounded float32 op: the product, with
// a row term (term) its sum f32(S[m]) c[o], then the mode's sums.  Both
// routes end every value here.
template <int MODE>
__device__ __forceinline__ float epi_value(const Epilogue& e, int acc,
                                           float a, float b, bool term,
                                           float s, float c, float r,
                                           float ar, float br) {
  float prod = __fmul_rn(__int2float_rn(acc), a);
  if (term) prod = __fadd_rn(prod, __fmul_rn(s, c));
  if constexpr (MODE == EPI_RESIDUAL) {
    // the residual sum, term by term: ((qb + acc a) + b) + r ar + br
    const float y = __fadd_rn(__fadd_rn(e.qb, prod), b);
    return __fadd_rn(__fadd_rn(y, __fmul_rn(r, ar)), br);
  } else {
    return __fadd_rn(prod, b);
  }
}

// rintf and the conversion in one cvt (half to even, saturating), then the
// clamp on integers
__device__ __forceinline__ int epi_code(const Epilogue& e, float y) {
  return min(max(__float2int_rn(y), e.lo), e.hi);
}

// The register route: the epilogue of one warpgroup's 64 x BN accumulator
// d, whose first row is row0 and first column col0 (store_acc's lane map:
// d[4 i + 2 h + e] is row 16 (warp % 4) + lane / 4 + 8 h, column 8 i + 2
// (lane % 4) + e).
template <int BN, int EPI_FLAGS>
__device__ __forceinline__ void store_epilogue(const Epilogue& e,
                                               const int (&d)[BN / 2],
                                               long long row0, int col0,
                                               long long rows, int cols) {
  constexpr bool TERM = (EPI_FLAGS & EPI_TERM) != 0;
  constexpr int EPI = EPI_FLAGS & ~EPI_TERM;
  const int t = threadIdx.x % WG_THREADS;
  const long long r0 = row0 + 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = col0 + 2 * (t % 4) + 8 * i;
    if (col >= cols) continue;
    const bool two = col + 1 < cols;
    const float av[2] = {__ldg(e.a + col), two ? __ldg(e.a + col + 1) : 0.f};
    const float bv[2] = {__ldg(e.b + col), two ? __ldg(e.b + col + 1) : 0.f};
    float arv[2] = {0.f, 0.f}, brv[2] = {0.f, 0.f}, cv[2] = {0.f, 0.f};
    if constexpr (TERM) {
      cv[0] = __ldg(e.crow + col);
      if (two) cv[1] = __ldg(e.crow + col + 1);
    }
    if constexpr (EPI == EPI_RESIDUAL) {
      arv[0] = __ldg(e.ar + col);
      brv[0] = __ldg(e.br + col);
      if (two) {
        arv[1] = __ldg(e.ar + col + 1);
        brv[1] = __ldg(e.br + col + 1);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = r0 + 8 * h;
      if (row >= rows) continue;
      float rv[2] = {0.f, 0.f};
      if constexpr (EPI == EPI_RESIDUAL) load_residual(e, row, col, cols, rv);
      const float sv = TERM ? __int2float_rn(__ldg(e.srow + row)) : 0.f;
      float y[2];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        y[k] = epi_value<EPI>(e, d[4 * i + 2 * h + k], av[k], bv[k], TERM,
                              sv, cv[k], rv[k], arv[k], brv[k]);
      if constexpr (EPI == EPI_F32) {
        if (e.relu) {
          y[0] = fmaxf(y[0], 0.0f);
          y[1] = fmaxf(y[1], 0.0f);
        }
        float* o = static_cast<float*>(e.out) + row * cols + col;
        if (cols % 2 == 0 && two) {
          *reinterpret_cast<float2*>(o) = make_float2(y[0], y[1]);
        } else {
          o[0] = y[0];
          if (two) o[1] = y[1];
        }
      } else {
        const int c0 = epi_code(e, y[0]);
        const int c1 = epi_code(e, y[1]);
        int8_t* o = static_cast<int8_t*>(e.out) + row * cols + col;
        if (cols % 2 == 0 && two) {
          *reinterpret_cast<uint16_t*>(o) =
              static_cast<uint16_t>(__byte_perm(c0, c1, 0x0040));
        } else {
          o[0] = static_cast<int8_t>(c0);
          if (two) o[1] = static_cast<int8_t>(c1);
        }
      }
    }
  }
}

// The staged route's geometry of an epilogue mode at a tile BN wide.  A
// warpgroup ends its 64 x BN block chunk by chunk, CW columns a chunk: as
// many as make 128 bytes of a row of the widest of r and the output (a
// chunk of int32 or f32 is 32 columns, of int8 128, or BN where that is
// less).  A chunk's slot holds the r box (64 x R_ROW bytes, by TMA) and the
// output box (64 x O_ROW), each in the swizzle of its row width; an int8 r
// is overwritten in place by its codes.  Two slots a warpgroup (three in
// int32 mode) and the tile's per-column parameters.
template <int BN, int EPI>
struct Staged {
  static constexpr bool ON = (EPI & EPI_STAGED) != 0;
  static constexpr int MODE = EPI & 3;
  static constexpr int RB =
      MODE == EPI_RESIDUAL ? ((EPI & EPI_WIDE_R) ? 4 : 1) : 0;
  static constexpr int OB = MODE == EPI_INT32 || MODE == EPI_F32 ? 4 : 1;
  static constexpr int EB = RB > OB ? RB : OB;
  static constexpr int CW = BN < TILE_K / EB ? BN : TILE_K / EB;
  static constexpr int CHUNKS = BN / CW;
  static constexpr int R_ROW = CW * RB;
  static constexpr int O_ROW = CW * OB;
  static constexpr bool IN_PLACE = RB == OB;
  static constexpr int R_AREA = WGMMA_M * R_ROW;
  // int32: three slots, so that a store is in flight while the next box
  // is written (its chunks are a quarter as wide as an int8 output's)
  static constexpr int SLOTS = MODE == EPI_INT32 ? 3 : 2;
  static constexpr int SLOT =
      !ON ? 0 : IN_PLACE ? R_AREA : R_AREA + WGMMA_M * O_ROW;
  // the tile's per-column parameters: {a, b, ar, br} and the row term's c
  static constexpr int PARAMS =
      ON && MODE != EPI_INT32 ? (BN * 20 + ATOM_BYTES - 1) / ATOM_BYTES *
                                    ATOM_BYTES
                              : 0;
  // a warpgroup's slots and parameters
  static constexpr int AREA = SLOTS * SLOT + PARAMS;
  // a warp of its own loads r
  static constexpr int LOADER = ON && RB > 0 ? 1 : 0;
  static_assert(!ON || (CHUNKS * CW == BN && SLOT % ATOM_BYTES == 0),
                "chunk");
};

// STAGES_MAX stages of the ring, or as many as fit beside the W4 staging
// slots and the staged route's epilogue slots (at least 3 at W4).
template <int BM, int BN, int STAGES_MAX, bool W4 = false, int EPI = 0>
struct Cfg {
  using S = Staged<BN, EPI>;
  static constexpr int WGS = BM / WGMMA_M;            // consumer warpgroups
  // the producer warp, and at W4 a second warp that unpacks with it
  static constexpr int PRODUCERS = W4 ? 2 : 1;
  static constexpr int THREADS =
      WGS * WG_THREADS + 32 * (PRODUCERS + S::LOADER);
  static constexpr int A_BYTES = BM * TILE_K;
  static constexpr int B_BYTES = BN * TILE_K;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // W4: two staging slots of a packed B tile, BN rows of 64 bytes
  static constexpr int P_BYTES = B_BYTES / 2;
  static constexpr int P_SLOTS = W4 ? 2 : 0;
  static constexpr int EPI_BYTES = WGS * S::AREA;
  // r full and r empty, a slot of each warpgroup
  static constexpr int R_BARS = S::LOADER ? 2 * WGS * S::SLOTS : 0;
  // all but the ring: W4 staging, epilogue slots, barriers but the ring's
  static constexpr int FIXED =
      P_SLOTS * P_BYTES + EPI_BYTES + (P_SLOTS + R_BARS) * 8;
  static constexpr int WANT = W4 && STAGES_MAX < 3 ? 3 : STAGES_MAX;
  static constexpr int FIT = (MAX_SMEM - FIXED) / (STAGE_BYTES + 16);
  static constexpr int STAGES = WANT < FIT ? WANT : FIT;
  // the ring, then the rest; full and empty a stage, at W4 "packed landed"
  // a slot
  static constexpr int SMEM = STAGES * (STAGE_BYTES + 16) + FIXED;
  // two blocks share an SM where their shared memory allows it
  static constexpr int MIN_BLOCKS = 2 * (SMEM + 1024) <= MAX_SMEM + 1024 ? 2 : 1;
  static_assert(STAGE_BYTES % ATOM_BYTES == 0 && SMEM <= MAX_SMEM, "tile");
  // W4: loading stage j waits for a slot that the consumers hand back once
  // stage j - STAGES + 1 is full, which the warps unpacked at step
  // j - STAGES + 2 < j
  static_assert(!W4 || STAGES >= 3, "W4 needs a ring of 3 stages");
};

// 1.5 * 2^23: a float32 sum with it lands on the integers, rounded half to
// even, and its low mantissa bits are the integer's two's complement
constexpr float MAGIC = 12582912.0f;
constexpr int MAGIC_BITS = 0x4B400000;

// A column pair of r from a staged box (RB bytes a value; 4: int32 or f32
// by r_kind), as float32: an int8 code exactly, as the magic number's
// float less the magic number (no conversion instruction).
template <int RB>
__device__ __forceinline__ float2 staged_residual(const Epilogue& e,
                                                  const uint8_t* p) {
  if constexpr (RB == 1) {
    const char2 v = *reinterpret_cast<const char2*>(p);
    return make_float2(__fsub_rn(__int_as_float(MAGIC_BITS + v.x), MAGIC),
                       __fsub_rn(__int_as_float(MAGIC_BITS + v.y), MAGIC));
  } else {
    if (e.r_kind == 2) {
      const int2 v = *reinterpret_cast<const int2*>(p);
      return make_float2(__int2float_rn(v.x), __int2float_rn(v.y));
    }
    return *reinterpret_cast<const float2*>(p);
  }
}

// A code on the staged route: y clamped to [lo, hi] (integers, so the
// clamp and the rounding commute), then rounded half to even by the magic
// sum; the code is the low byte of the sum's bits.  Equal to epi_code's
// without its conversion.
__device__ __forceinline__ uint32_t staged_code(float y, float lo,
                                                float hi) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(y, lo), hi), MAGIC));
}

// The staged route: the epilogue of one warpgroup's 64 x BN accumulator d
// (first row row0 < rows, first column col0), chunk by chunk through the
// warpgroup's slots at `area` (shared address area_u32).  For each chunk:
// wait for its r box (r_full), read r (and the column's parameters, staged
// once for the tiles of a column block) and write the output in the lane
// map, fence; thread 0 waits until the store that last used the next
// chunk's slot has read it; the warpgroup meets at its named barrier;
// thread 0 stores the output box by TMA and hands the r box back
// (r_empty): a wider r's at once, an int8 r's once the store has read the
// codes that overwrote it.  `ch` counts the warpgroup's chunks, as the r
// loader counts them.
template <int BN, int EPI>
__device__ __forceinline__ void store_staged(
    const Epilogue& e, const int (&d)[BN / 2], int row0, int col0, int rows,
    int cols, uint8_t* area, uint32_t area_u32, uint32_t r_full,
    uint32_t r_empty, const CUtensorMap* map_out, int wg, uint32_t& ch,
    int& params_col0) {
  using S = Staged<BN, EPI>;
  constexpr int MODE = S::MODE;
  const int t = threadIdx.x % WG_THREADS;
  float4* params = reinterpret_cast<float4*>(area + S::SLOTS * S::SLOT);
  float* c_term = reinterpret_cast<float*>(params + BN);
  const int r0 = 16 * (t / 32) + (t % 32) / 4;   // rows r0 and r0 + 8
  const bool term = MODE != EPI_INT32 && e.srow != nullptr;
  const float lo = static_cast<float>(e.lo), hi = static_cast<float>(e.hi);
  if (MODE != EPI_INT32 && params_col0 != col0) {
    // the parameters of the tile's columns, once for the tiles of one
    // column block (M walks fastest); every thread read the last ones
    // before the warpgroup's last barrier
    for (int j = t; j < BN; j += WG_THREADS) {
      const int col = col0 + j;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      float c = 0.f;
      if (col < cols) {
        v.x = __ldg(e.a + col);
        v.y = __ldg(e.b + col);
        if (MODE == EPI_RESIDUAL) {
          v.z = __ldg(e.ar + col);
          v.w = __ldg(e.br + col);
        }
        if (term) c = __ldg(e.crow + col);
      }
      params[j] = v;
      c_term[j] = c;
    }
    named_bar_sync(2 + wg, WG_THREADS);
    params_col0 = col0;
  }
  float sv[2] = {0.f, 0.f};
  if (term) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row0 + r0 + 8 * h < rows)
        sv[h] = __int2float_rn(__ldg(e.srow + row0 + r0 + 8 * h));
  }
#pragma unroll
  for (int c = 0; c < S::CHUNKS; ++c) {
    const int chunk0 = col0 + c * S::CW;
    if (chunk0 >= cols) break;
    const uint32_t s = ch % S::SLOTS;
    uint8_t* slot = area + s * S::SLOT;
    uint8_t* o_box = slot + (S::IN_PLACE ? 0 : S::R_AREA);
    if constexpr (S::LOADER) mbar_wait(r_full + 8 * s, (ch / S::SLOTS) & 1);
#pragma unroll
    for (int j = 0; j < S::CW / 8; ++j) {
      const int i = c * (S::CW / 8) + j;
      const int cw = 8 * j + 2 * (t % 4);     // the pair's column in the chunk
      float4 p0 = make_float4(0.f, 0.f, 0.f, 0.f), p1 = p0;
      float2 cv = make_float2(0.f, 0.f);
      if constexpr (MODE != EPI_INT32) {
        p0 = params[c * S::CW + cw];
        p1 = params[c * S::CW + cw + 1];
        if (term)
          cv = *reinterpret_cast<const float2*>(c_term + c * S::CW + cw);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        const int v0 = d[4 * i + 2 * h], v1 = d[4 * i + 2 * h + 1];
        uint8_t* op = o_box + swizzle_box(row * S::O_ROW + S::OB * cw,
                                          S::O_ROW);
        if constexpr (MODE == EPI_INT32) {
          *reinterpret_cast<int2*>(op) = make_int2(v0, v1);
        } else {
          float2 rv = make_float2(0.f, 0.f);
          if constexpr (MODE == EPI_RESIDUAL)
            rv = staged_residual<S::RB>(
                e, slot + swizzle_box(row * S::R_ROW + S::RB * cw, S::R_ROW));
          float y0 = epi_value<MODE>(e, v0, p0.x, p0.y, term, sv[h], cv.x,
                                     rv.x, p0.z, p0.w);
          float y1 = epi_value<MODE>(e, v1, p1.x, p1.y, term, sv[h], cv.y,
                                     rv.y, p1.z, p1.w);
          if constexpr (MODE == EPI_F32) {
            if (e.relu) {
              y0 = fmaxf(y0, 0.0f);
              y1 = fmaxf(y1, 0.0f);
            }
            *reinterpret_cast<float2*>(op) = make_float2(y0, y1);
          } else {
            *reinterpret_cast<uint16_t*>(op) = static_cast<uint16_t>(
                __byte_perm(staged_code(y0, lo, hi), staged_code(y1, lo, hi),
                            0x0040));
          }
        }
      }
    }
    fence_proxy_async();   // the output box is read by the TMA store
    // the store of SLOTS - 1 chunks before has read its slot, which is
    // written again from the next chunk on, after the barrier (an int8 r's
    // is awaited at once)
    if (t == 0 && !S::IN_PLACE && ch > 0) bulk_wait_read<S::SLOTS - 2>();
    named_bar_sync(2 + wg, WG_THREADS);
    if (t == 0) {
      if (S::LOADER && !S::IN_PLACE) mbar_arrive(r_empty + 8 * s);
      tma_store_2d(map_out, area_u32 + s * S::SLOT +
                                (S::IN_PLACE ? 0 : S::R_AREA),
                   chunk0 * S::OB, row0);
      bulk_commit();
      if (S::IN_PLACE) {
        // the codes overwrote their r: the slot takes the r of two chunks
        // on once the store has read it
        bulk_wait_read<0>();
        if (S::LOADER) mbar_arrive(r_empty + 8 * s);
      }
    }
    ++ch;
  }
}

// map_w describes w: at W8 (N, Kp) in 128-byte swizzled boxes, at W4 the
// packed (N, Kp/2) in unswizzled boxes of BN x 64 bytes.  map_r and
// map_out (the staged route) describe r and the output in the boxes of a
// chunk (Staged); the register route does not read them.
template <int BM, int BN, int STAGES_MAX, int EPI, bool W4>
__global__ void __launch_bounds__(Cfg<BM, BN, STAGES_MAX, W4, EPI>::THREADS,
                                  Cfg<BM, BN, STAGES_MAX, W4, EPI>::MIN_BLOCKS)
int8_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_r,
                 const __grid_constant__ CUtensorMap map_out,
                 const Epilogue e, int M, int N, int K, int m_tiles,
                 int tiles) {
  using C = Cfg<BM, BN, STAGES_MAX, W4, EPI>;
  using S = typename C::S;
  constexpr int STAGES = C::STAGES;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  if (base % ATOM_BYTES != 0) __trap();  // the swizzle needs the alignment
  const uint32_t staging = base + STAGES * C::STAGE_BYTES;   // W4 only
  const uint32_t slots = staging + C::P_SLOTS * C::P_BYTES;  // staged only
  const uint32_t full = slots + C::EPI_BYTES;
  const uint32_t empty = full + STAGES * 8;
  const uint32_t packed = empty + STAGES * 8;   // W4 only
  // staged with a residual: r full and r empty of (warpgroup, slot)
  const uint32_t r_full = packed + C::P_SLOTS * 8;
  const uint32_t r_empty = r_full + C::R_BARS * 4;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k_chunks = (K + TILE_K - 1) / TILE_K;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the producer's expect_tx, and at W4 lane 0 of each unpacking warp
      mbar_init(full + 8 * s, 1 + (W4 ? C::PRODUCERS : 0));
      mbar_init(empty + 8 * s, 4 * C::WGS);   // lane 0 of each consumer warp
    }
    for (int p = 0; p < C::P_SLOTS; ++p) mbar_init(packed + 8 * p, 1);
    // the loader's expect_tx; thread 0 of the warpgroup
    for (int b = 0; b < C::R_BARS; ++b) mbar_init(r_full + 8 * b, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if constexpr (S::LOADER != 0) {
    if (warp == 4 * C::WGS + C::PRODUCERS) {
      // the r loader: one thread walks the same tiles and chunks as the
      // consumers and loads each warpgroup's r box into its next slot once
      // that slot is handed back
      if (lane != 0) return;
      tma_prefetch_map(&map_r);
      uint32_t ch[C::WGS] = {};
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * BM;
        const int n0 = (tile / m_tiles) * BN;
        for (int c = 0; c < S::CHUNKS && n0 + c * S::CW < N; ++c) {
#pragma unroll
          for (int g = 0; g < C::WGS; ++g) {
            if (m0 + g * WGMMA_M >= M) continue;
            const uint32_t s = ch[g] % S::SLOTS;
            const uint32_t bar = 8 * (g * S::SLOTS + s);
            mbar_wait(r_empty + bar, ((ch[g] / S::SLOTS) & 1) ^ 1);
            mbar_arrive_expect_tx(r_full + bar, S::R_AREA);
            tma_load_2d(slots + g * S::AREA + s * S::SLOT, &map_r,
                        r_full + bar, (n0 + c * S::CW) * S::RB,
                        m0 + g * WGMMA_M);
            ++ch[g];
          }
        }
      }
      return;
    }
  }

  if (W4 && warp >= 4 * C::WGS) {
    // the two producer warps at W4: at step j warp 0 loads stage j (A by
    // TMA into the ring, the packed B tile into staging slot j % 2), then
    // both unpack stage j - 1 from slot (j - 1) % 2 into its B tile
    const int pw = warp - 4 * C::WGS;
    if (pw == 0 && lane == 0) {
      tma_prefetch_map(&map_x);
      tma_prefetch_map(&map_w);
    }
    const int my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
    const int total = my_tiles * k_chunks;
    for (int j = 0; j <= total; ++j) {
      if (pw == 0 && j < total) {
        const int s = j % STAGES;
        mbar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
        if (lane == 0) {
          const int tile = blockIdx.x + (j / k_chunks) * gridDim.x;
          const int kc = j % k_chunks;
          const uint32_t a = base + s * C::STAGE_BYTES;
          mbar_arrive_expect_tx(full + 8 * s, C::A_BYTES);
          tma_load_2d(a, &map_x, full + 8 * s, kc * TILE_K,
                      (tile % m_tiles) * BM);
          mbar_arrive_expect_tx(packed + 8 * (j % 2), C::P_BYTES);
          tma_load_2d(staging + (j % 2) * C::P_BYTES, &map_w,
                      packed + 8 * (j % 2), kc * (TILE_K / 2),
                      (tile / m_tiles) * BN);
        }
      }
      if (j > 0) {
        const int u = j - 1;
        const int s = u % STAGES;
        mbar_wait(packed + 8 * (u % 2), (u / 2) & 1);
        const uint32_t b = base + s * C::STAGE_BYTES + C::A_BYTES;
        const uint32_t p = staging + (u % 2) * C::P_BYTES;
        // chunk i: row i / 8, 16-byte chunk i % 8 of the row, from packed
        // bytes 8 i .. 8 i + 7 (a warp reads 256 consecutive bytes)
#pragma unroll 4
        for (int i = 32 * pw + lane; i < BN * (TILE_K / 16);
             i += 32 * C::PRODUCERS) {
          const uint2 v = ld_shared8(p + 8 * i);
          uint32_t w[4];
          unpack_nibbles16(v.x, v.y, w);
          st_shared16(b + swizzle128(i / 8, 16 * (i % 8)), w[0], w[1], w[2],
                      w[3]);
        }
        fence_proxy_async();   // the B tile is read by wgmma
        __syncwarp();
        if (lane == 0) mbar_arrive(full + 8 * s);
      }
      // both warps have read slot (j - 1) % 2 before warp 0 refills it
      asm volatile("bar.sync 1, %0;\n" ::"n"(32 * C::PRODUCERS) : "memory");
    }
    return;
  }

  if (warp == 4 * C::WGS) {
    // producer: one thread walks the same tiles and K chunks as the
    // consumers and refills each stage as soon as it is handed back
    if (lane != 0) return;
    tma_prefetch_map(&map_x);
    tma_prefetch_map(&map_w);
    int stage = 0;
    uint32_t parity = 1;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * BM;
      const int n0 = (tile / m_tiles) * BN;
      for (int kc = 0; kc < k_chunks; ++kc) {
        mbar_wait(empty + 8 * stage, parity);
        mbar_arrive_expect_tx(full + 8 * stage, C::STAGE_BYTES);
        const uint32_t a = base + stage * C::STAGE_BYTES;
        tma_load_2d(a, &map_x, full + 8 * stage, kc * TILE_K, m0);
        tma_load_2d(a + C::A_BYTES, &map_w, full + 8 * stage, kc * TILE_K,
                    n0);
        if (++stage == STAGES) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 * wg .. 64 * wg + 63 of the tile
  const int wg = warp / 4;
  int acc[BN / 2];
  int stage = 0;
  uint32_t parity = 0;
  uint32_t ch = 0;   // the staged route's chunks of this warpgroup
  int params_col0 = -1;   // and the first column its parameters are of
  if (S::ON && threadIdx.x % WG_THREADS == 0) tma_prefetch_map(&map_out);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long m0 = static_cast<long long>(tile % m_tiles) * BM;
    const int n0 = (tile / m_tiles) * BN;
    int prev = -1;
    for (int kc = 0; kc < k_chunks; ++kc) {
      mbar_wait(full + 8 * stage, parity);
      const uint32_t a = base + stage * C::STAGE_BYTES;
      const uint64_t da = smem_desc(a + wg * WGMMA_M * TILE_K);
      const uint64_t db = smem_desc(a + C::A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE_K / WGMMA_K; ++kk)
        Wgmma<BN>::mma(acc, da + kk * DESC_K_STEP, db + kk * DESC_K_STEP,
                       (kc | kk) != 0);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();  // the group before this one has read its stage
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        parity ^= 1;
      }
    }
    wgmma_wait<0>();
    acc_fence(acc);
    if (lane == 0) mbar_arrive(empty + 8 * prev);
    if constexpr (S::ON) {
      const int row0 = static_cast<int>(m0) + wg * WGMMA_M;
      const uint32_t mine = wg * S::AREA;
      if (row0 < M)
        store_staged<BN, EPI>(e, acc, row0, n0, M, N,
                              smem + (slots - base) + mine, slots + mine,
                              r_full + 8 * wg * S::SLOTS,
                              r_empty + 8 * wg * S::SLOTS, &map_out, wg, ch,
                              params_col0);
    } else if constexpr (EPI == EPI_INT32) {
      store_acc<BN, false>(static_cast<int32_t*>(e.out), acc,
                           m0 + wg * WGMMA_M, n0, M, N);
    } else {
      store_epilogue<BN, EPI>(e, acc, m0 + wg * WGMMA_M, n0, M, N);
    }
  }
  // the last stores have written the output before the block ends
  if (S::ON && threadIdx.x % WG_THREADS == 0) bulk_wait<0>();
}

template <int BM, int BN, int STAGES, int EPI, bool W4 = false>
int launch(const CUtensorMap& map_x, const CUtensorMap& map_w,
           const CUtensorMap& map_r, const CUtensorMap& map_out,
           const Epilogue& e, int m, int n, int k, cudaStream_t s) {
  using C = Cfg<BM, BN, STAGES, W4, EPI>;
  const auto kernel = int8_gemm_kernel<BM, BN, STAGES, EPI, W4>;
  // once per tile: opt in to the shared memory, ask how many blocks fit an SM
  static const int per_sm = [&] {
    int blocks = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kernel, C::THREADS, C::SMEM) != cudaSuccess)
      return 0;
    return blocks;
  }();
  int device = 0, sms = 0;
  if (per_sm < 1 || cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err
                                               : cudaErrorLaunchOutOfResources);
  }
  const int m_tiles = (m + BM - 1) / BM;
  const long long tiles =
      static_cast<long long>(m_tiles) * ((n + BN - 1) / BN);
  if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const unsigned grid = static_cast<unsigned>(tiles < resident ? tiles
                                                               : resident);
  kernel<<<grid, C::THREADS, C::SMEM, s>>>(map_x, map_w, map_r, map_out, e, m,
                                           n, k, m_tiles,
                                           static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

#if DLMCQ_GEMM_STAGED

// A staged launch: the maps of the output and of r in the boxes of a chunk,
// made here at every launch like map_x and map_w.
template <int BM, int BN, int STAGES, int EPI, bool W4>
int launch_staged(const CUtensorMap& map_x, const CUtensorMap& map_w,
                  const Epilogue& e, int m, int n, int k, cudaStream_t s) {
  using S = Staged<BN, EPI | EPI_STAGED>;
  CUtensorMap map_r{}, map_out{};
  int err = encode_box_map(&map_out, e.out, m, 1ull * n * S::OB, WGMMA_M,
                           S::O_ROW);
  if (err == 0 && S::RB)
    err = encode_box_map(&map_r, e.r, m, 1ull * n * S::RB, WGMMA_M,
                         S::R_ROW);
  if (err != 0) return err;
  return launch<BM, BN, STAGES, EPI | EPI_STAGED, W4>(map_x, map_w, map_r,
                                                      map_out, e, m, n, k, s);
}

// An epilogue mode at one tile on the staged route: the row term is read
// where srow is set (one instantiation with and without it), r's width
// picks the instantiation.
template <int BM, int BN, int STAGES, bool W4 = false>
int launch_epilogue(const CUtensorMap& map_x, const CUtensorMap& map_w,
                    const Epilogue& e, int codes, int m, int n, int k,
                    cudaStream_t s) {
  if (!codes)
    return launch_staged<BM, BN, STAGES, EPI_F32, W4>(map_x, map_w, e, m, n,
                                                      k, s);
  if (e.r_kind == 1)
    return launch_staged<BM, BN, STAGES, EPI_RESIDUAL, W4>(map_x, map_w, e,
                                                           m, n, k, s);
  if (e.r_kind)
    return launch_staged<BM, BN, STAGES, EPI_RESIDUAL | EPI_WIDE_R, W4>(
        map_x, map_w, e, m, n, k, s);
  return launch_staged<BM, BN, STAGES, EPI_CODES, W4>(map_x, map_w, e, m, n,
                                                      k, s);
}

#else

const CUtensorMap NO_MAP{};

// An epilogue mode at one tile: an instantiation per mode, with and
// without a row term.
template <int BM, int BN, int STAGES, bool W4, int TERM>
int launch_mode(const CUtensorMap& map_x, const CUtensorMap& map_w,
                const Epilogue& e, int codes, int m, int n, int k,
                cudaStream_t s) {
  if (!codes)
    return launch<BM, BN, STAGES, EPI_F32 | TERM, W4>(map_x, map_w, NO_MAP,
                                                      NO_MAP, e, m, n, k, s);
  if (e.r_kind)
    return launch<BM, BN, STAGES, EPI_RESIDUAL | TERM, W4>(
        map_x, map_w, NO_MAP, NO_MAP, e, m, n, k, s);
  return launch<BM, BN, STAGES, EPI_CODES | TERM, W4>(map_x, map_w, NO_MAP,
                                                      NO_MAP, e, m, n, k, s);
}

template <int BM, int BN, int STAGES, bool W4 = false>
int launch_epilogue(const CUtensorMap& map_x, const CUtensorMap& map_w,
                    const Epilogue& e, int codes, int m, int n, int k,
                    cudaStream_t s) {
  return e.srow ? launch_mode<BM, BN, STAGES, W4, EPI_TERM>(
                      map_x, map_w, e, codes, m, n, k, s)
                : launch_mode<BM, BN, STAGES, W4, 0>(map_x, map_w, e, codes,
                                                     m, n, k, s);
}

#endif

// The register route's W4 instantiations: the epilogue tiles at their W8
// stage counts, the two staging slots beside the ring (int8_gemm.py:
// W4_TILE_STAGES).
#define DLMCQ_W4_TILES      \
  DLMCQ_W4_TILE(128, 256, 4) \
  DLMCQ_W4_TILE(128, 128, 3) \
  DLMCQ_W4_TILE(64, 128, 4)  \
  DLMCQ_W4_TILE(64, 64, 4)

// The staged route's tiles, W8 and W4, every mode: the epilogue tiles at
// most at these stage counts, fewer where the slots (and W4's staging)
// leave no room, at least 3 at W4 (int8_gemm.py: STAGED_TILE_STAGES,
// staged_stages).
#define DLMCQ_STAGED_TILES      \
  DLMCQ_STAGED_TILE(128, 256, 4) \
  DLMCQ_STAGED_TILE(128, 128, 2) \
  DLMCQ_STAGED_TILE(64, 128, 4)  \
  DLMCQ_STAGED_TILE(64, 64, 4)

// w is (n, kp) int8, or at W4 (n, kp / 2) nibble pairs
int encode_maps(CUtensorMap* map_x, CUtensorMap* map_w, const void* x,
                const void* w, int m, int n, int k, int kp, int w4, int bm,
                int bn) {
  if (bm != 64 && bm != 128) return static_cast<int>(cudaErrorInvalidValue);
  const int err = encode_tile_map(map_x, x, m, k, k, bm);
  if (err != 0) return err;
  return w4 ? encode_tile_map(map_w, w, n, kp / 2, kp / 2, bn, TILE_K / 2,
                              false)
            : encode_tile_map(map_w, w, n, kp, kp, bn);
}

}  // namespace

extern "C" {

// out (m, n) int32 = x (m, k) int8 @ w, with w packed as (n, kp) int8, or
// with w4 = 1 nibble-packed as (n, kp / 2) bytes.  (bm, bn) is one of the
// compiled tiles, listed below and in int8_gemm.py (at W4 the
// DLMCQ_W4_TILES; in the staged build 128 x 256, n % 4 == 0 and out
// 16-byte aligned).  Launches on `stream`; returns
// cudaGetLastError() (0 on success), or the error that refused the tensor
// maps or the tile.
int dlmcq_int8_gemm(const void* x, const void* w, void* out, int m, int n,
                    int k, int kp, int w4, int bm, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap map_x, map_w;
  const int err = encode_maps(&map_x, &map_w, x, w, m, n, k, kp, w4, bm, bn);
  if (err != 0) return err;
  Epilogue e = {};
  e.out = out;
#if DLMCQ_GEMM_STAGED
  // int32 at 128 x 256 only (int8_gemm.py: STAGED_INT32_TILES)
  if (bm == 128 && bn == 256)
    return w4 ? launch_staged<128, 256, 4, EPI_INT32, true>(map_x, map_w, e,
                                                           m, n, k, s)
              : launch_staged<128, 256, 4, EPI_INT32, false>(map_x, map_w,
                                                            e, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
#else
  if (w4) {
#define DLMCQ_W4_TILE(BM, BN, STAGES)                                       \
  if (bm == BM && bn == BN)                                                \
    return launch<BM, BN, STAGES, EPI_INT32, true>(map_x, map_w, NO_MAP,    \
                                                   NO_MAP, e, m, n, k, s);
    DLMCQ_W4_TILES
#undef DLMCQ_W4_TILE
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define DLMCQ_TILE(BM, BN, STAGES)                                       \
  if (bm == BM && bn == BN)                                              \
    return launch<BM, BN, STAGES, EPI_INT32>(map_x, map_w, NO_MAP, NO_MAP, \
                                             e, m, n, k, s);
  DLMCQ_TILE(128, 256, 4)   // 192 KB, one block an SM
  DLMCQ_TILE(128, 192, 5)   // 200 KB, one block an SM
  DLMCQ_TILE(128, 128, 3)   //  96 KB, two blocks an SM
  DLMCQ_TILE(128, 96, 4)    // 112 KB, two
  DLMCQ_TILE(128, 48, 5)    // 110 KB, two
  DLMCQ_TILE(64, 128, 4)    //  96 KB, two
  DLMCQ_TILE(64, 64, 4)     //  64 KB, three
#undef DLMCQ_TILE
  return static_cast<int>(cudaErrorInvalidValue);
#endif
}

// The same product with an epilogue (the header's codes and f32 modes):
// out (m, n) int8 codes (codes = 1) or f32 (codes = 0) from the
// accumulator, with a and b (n,) f32; lo/hi the codes' clamp, relu for
// f32; r_kind 1, 2 or 3 (codes only) adds the residual r (m, n) int8,
// int32 or f32 with ar, br (n,) f32 and the grid's bias qb; srow (m,)
// int32 and crow (n,) f32 are the row term, or both null.  (bm, bn) is
// one of the tiles listed below and in int8_gemm.py (EPILOGUE_TILES; in
// the staged build the DLMCQ_STAGED_TILES, with the rows of the output and
// of r whole 16 bytes and both 16-byte aligned: int8_gemm.py's route).
int dlmcq_int8_gemm_epilogue(const void* x, const void* w, void* out, int m,
                             int n, int k, int kp, int w4, int bm, int bn,
                             int codes,
                             const float* a, const float* b, const void* r,
                             const float* ar, const float* br, float qb,
                             int lo, int hi, int relu, int r_kind,
                             const int* srow, const float* crow,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r_kind < 0 || r_kind > 3 || (r_kind && !codes) || (relu && codes) ||
      (!srow != !crow))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  const int err = encode_maps(&map_x, &map_w, x, w, m, n, k, kp, w4, bm, bn);
  if (err != 0) return err;
  const Epilogue e = {out, a,  b,    r,      ar,     br,  qb,
                      lo,  hi, relu, r_kind, srow, crow};
#if DLMCQ_GEMM_STAGED
#define DLMCQ_STAGED_TILE(BM, BN, STAGES)                                   \
  if (bm == BM && bn == BN)                                                \
    return w4 ? launch_epilogue<BM, BN, STAGES, true>(map_x, map_w, e,      \
                                                      codes, m, n, k, s)   \
              : launch_epilogue<BM, BN, STAGES, false>(map_x, map_w, e,     \
                                                       codes, m, n, k, s);
  DLMCQ_STAGED_TILES
#undef DLMCQ_STAGED_TILE
  return static_cast<int>(cudaErrorInvalidValue);
#else
  if (w4) {
#define DLMCQ_W4_TILE(BM, BN, STAGES)                                       \
  if (bm == BM && bn == BN)                                                \
    return launch_epilogue<BM, BN, STAGES, true>(map_x, map_w, e, codes, m, \
                                                 n, k, s);
    DLMCQ_W4_TILES
#undef DLMCQ_W4_TILE
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define DLMCQ_EPILOGUE_TILE(BM, BN, STAGES)                                 \
  if (bm == BM && bn == BN)                                                 \
    return launch_epilogue<BM, BN, STAGES>(map_x, map_w, e, codes, m, n, k, \
                                           s);
  DLMCQ_EPILOGUE_TILE(128, 256, 4)
  DLMCQ_EPILOGUE_TILE(128, 128, 3)
  DLMCQ_EPILOGUE_TILE(64, 128, 4)
  DLMCQ_EPILOGUE_TILE(64, 64, 4)
#undef DLMCQ_EPILOGUE_TILE
  return static_cast<int>(cudaErrorInvalidValue);
#endif
}

const char* dlmcq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
