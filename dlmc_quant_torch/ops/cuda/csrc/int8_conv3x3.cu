// Fused int8 3x3 convolution with a requantize epilogue, for Hopper (sm_90a):
// an implicit GEMM on the tensor cores, wgmma from swizzled shared memory.
//
// Replaces the TPU kernel dlmc_quant_tpu/ops/pallas/rpconv.py:200
// (int8_conv3x3_rm, body _rp_kernel at :142).  Same function, generalised:
// stride 1 or 2, any H, W, C >= 1 and O >= 1, NHWC int8 codes in and out,
// borders padded with the input grid's code for real 0 (not with zero).
// The top and left pad is 1, or 0 for the SAME geometry of a stride-2 conv
// on an even map (the window of output p starts at row 2p, the bottom and
// right border supply the pad); Ho = ceil(H / s) either way.
//
//   acc[n,p,q,o] = sum_{dy,dx,c} xpad[n, p*s+dy, q*s+dx, c] * w[dy,dx,c,o]   (int32)
//   in G groups (C = G Cg, O = G Og): the sum runs over c < Cg and reads
//   channel g Cg + c, g = o / Og the group of output channel o
//   codes: out = clamp(rint(f32(acc)*a[o] + b[o]), lo, hi)              -> int8
//   f32:   out = f32(acc)*a[o] + b[o], then max(., 0) if relu          -> f32
//   codes with a residual r (N, Ho, Wo, O) of int8, int32 or f32 (a residual
//   block's output, folded as chain.fold_sum_quantize orders it):
//          out = clamp(rint((((qb + f32(acc)*a[o]) + b[o]) + f32(r)*ar[o])
//                           + br[o]), lo, hi)                          -> int8
//   with a row term (S (N, Ho, Wo) int32, c (O,) f32: a weight offset's
//   term, S the window sums of int8_window_sum.cu), in every mode the
//   product f32(acc)*a[o] becomes f32(acc)*a[o] + f32(S[n,p,q])*c[o]
//   (the product and the sum each rounded) before the rest; in G groups
//   S is (N, Ho, Wo, G), one sum a group, and column o reads S[n,p,q,g],
//   g = o / Og (a tile's columns lie in one group).
//
// The epilogue is written with __int2float_rn, __fmul_rn and __fadd_rn so
// nvcc cannot contract it into an fma, and rounds half to even as rintf,
// jnp.round and torch.round do (__float2int_rn: rintf and the conversion
// in one cvt).  The kernel then equals its plain PyTorch version
// bit for bit.
//
// As a GEMM: M = N*Ho*Wo output pixels, N = O, K = 3*Rp bytes ordered (dy,
// dx, channel): the 3*C bytes that one row dy of the 3x3 window covers are
// consecutive bytes of x (NHWC) and stay one run of K, padded to Rp =
// roundup(3*C, 16).  With C % 16 == 0 nothing is padded, K = 9*C ordered
// (tap, channel), and every 16-byte chunk of K lies inside one tap.
//
// Bound on an H100: max(2*MACs / 1979e12, bytes / 3.35e12) with the input
// and the output counted once.  RepVGG-A0's 112x112 and 56x56 layers and
// its stem are bound by bytes, the 28x28 and 14x14 layers by operations.
// What a block really pays for is neither.  Measured on an H100 80GB HBM3
// at 700 W (tools/conv_plans.py, and cycle counters put into the kernel
// while it was tuned), in the order in which they held a layer back:
//  - issue slots.  A 16-byte chunk of an im2col tile costs its producer
//    lane an address and a bounds test, an output code costs its consumer
//    lane several issue slots, and a block has 12 warps on 4 schedulers.
//    So a pixel's place in the image is worked out once per tile (two
//    divisions by multiply and shift) into a table of flags, a chunk then
//    takes one table read, one mask test, one 16-byte load and one store
//    with addresses that only advance, and the epilogue rounds and converts
//    in one cvt and packs two codes with one byte permute.
//  - L2 traffic.  The im2col tile has 9 bytes of K for every input byte.
//    Stride-1 layers with C % 16 == 0 fetch the run of input pixels a tile
//    needs (its 128 pixels and a row and a pixel to either side) once, by
//    one bulk copy, into a halo buffer, and build their tiles from shared
//    memory: stage3_k 53 -> 41 us, stage2_k 90 -> 60 us.  The weight stays
//    resident in shared memory where it fits (C = 3, 48, 96), what the TPU
//    kernel's VMEM-resident weight is on this card; for C = 192 a stage
//    holds a 128-byte K chunk of both operands, the weight's by TMA.
//  - the epilogue, during which a block's tensor cores idle: both consumer
//    warpgroups hold accumulators of the same tile.  This is what is left:
//    a 14x14 layer takes 39 us where its wgmmas need 17.
//
// Design.  A block is two consumer warpgroups and four producer warps:
//  - The producers fill a ring of >= 4 stages.  The A tile of a stage is
//    128 output pixels x 128 bytes of K in the 128-byte swizzle
//    (wgmma_s8.cuh).  Each producer warp owns every fourth stage of the
//    block's sequence of (tile, K chunk) stages and fills it alone, so up to
//    four stages are being filled at once (signalling a stage late, as the
//    probe does, bought nothing here: the proxy fence waits for every copy
//    its thread has in flight).  Lane l fills chunk l % 8 of rows l / 8 +
//    4 j: the 8 lanes of a row read up to 128 consecutive bytes of K, which
//    are consecutive bytes of x wherever the taps of one dy are.  A tap
//    inside the image is 16 bytes from the halo buffer (stride 1) or one
//    cp.async from x (stride 2); one outside is 16 copies of the pad code
//    stored from registers (a copy's zero fill would give code 0).  Chunks
//    past K and rows past M are left as they are: the weight is zero there,
//    the rows are never stored.  Where C % 16 != 0 (the stem) a chunk is 16
//    bytes of a window row's run, five aligned 32-bit loads funnel-shifted
//    into place, with the pad code patched in where the window hangs over
//    the left or right border.  A lane then waits for its copies, executes
//    the proxy fence, and lane 0 arrives on the stage's full barrier.
//  - The consumers each take 64 rows of the tile: per stage four wgmma
//    m64nBNk32, one commit group per stage, a stage handed back after
//    wait_group<1>.  All four 32-byte slices of a chunk are multiplied also
//    where K ends inside it.
//  - Epilogue from the accumulator's lane map, a[o] and b[o] staged in
//    shared memory once per block.  Codes go to a staging tile in shared
//    memory (row pitch padded against bank conflicts) and leave as 16-byte
//    stores: a tile as wide as the layer is one contiguous run of NHWC
//    bytes.  Each warp stages and stores its own 16 rows, so no barrier
//    joins the warpgroup.  f32 leaves as float2 per lane, 32 bytes a quad.
//  - A persistent grid: as many blocks as fit the card walk the tiles, M
//    fastest, so that blocks running together share a weight tile in L2;
//    the producers run ahead into the next tile during the epilogue.  The
//    48-wide kernel is compiled for two blocks an SM (80 registers), which
//    its layers' many small tiles want; the others for one.
// W4 weights (a layer of 4 bits or fewer) come nibble-packed, (O, Kp/2)
// bytes with K index 2j in the low nibble of byte j (ops/cuda/nibbles.py),
// and stay so in device memory.  TMA cannot unpack, and its pitch must be
// a multiple of 16 bytes, which Kp/2 is not wherever Rp / 16 is odd (C =
// 3, 16, 48, ...): so at W4 no TMA touches the weight.  The producers read
// 8 packed bytes a 16-byte chunk with plain loads through the read-only
// path (Kp/2 is a multiple of 8, so every such load is aligned), expand
// them to int8 (unpack_nibbles16) and store the chunk at its swizzle128
// address: a resident weight once a block, all four producer warps
// together, each arriving on the weight's barrier after its fence; a
// streamed weight's B tile by the warp that fills the stage, in the same
// pass as its A tile and before the same proxy fence.
// Grouped convs (RepVGG's g2/g4 variants; the TPU package lowers them
// through XLA, quant/layers.py:721-728, feature_group_count) are G GEMMs
// side by side, each of Og columns and K = 9 Tp bytes ordered (tap,
// channel): a window row's three taps are C bytes apart in x, so each
// tap's Cg channels are one run of K padded to Tp = roundup(Cg, 16), and a
// 16-byte chunk lies inside one tap.  The group is part of the tile index
// (n tile = group * tiles of a group + tile in the group, M fastest as
// before): a tile reads its group's channels from offset g Cg of each
// pixel, its B rows start at g Og, and its columns past the group's end
// are multiplied (B rows of the next group, or TMA's zero fill) and never
// stored.  Where Cg % 16 == 0 a chunk is an aligned 16-byte copy, from the
// halo (which holds whole pixels) or by cp.async; where Cg % 8 == 0
// (B2g4's Cg = 40) two 8-byte cp.async; elsewhere five aligned words
// funnel-shifted into place.  The bytes past a tap's run are x's next
// bytes (zero past its end), which meet zero weights.
// The weight never stays resident (each group has its own); a and b are
// staged tile by tile, zero past the group's end.  Measured on an H100
// 80GB HBM3 at 700 W (chip_smoke.py's repvgg_zoo phase): RepVGG-B2g4's 13
// grouped launches at batch 64 take 0.96 ms against a 0.167 ms bound; the
// two at 56x56 (Cg = 40, the 8-byte copies) 0.18 ms each, 9x their bytes'
// bound (0.48 with five words a chunk), those at 28x28 6x and at 14x14 4x
// their operations' bound: producers that gather a 48- or 96-wide tile's
// group are what bounds them, untuned.  This source is built twice:
// as itself, for groups = 1, and through int8_conv3x3_grouped.cu with
// DLMCQ_CONV_GROUPED set, for groups > 1 (the row term too, its S read
// at the tile's group).  The group code is a compile-time branch, so the
// ungrouped build has none of it, and the two builds compile side by
// side.
// The tile plan (width, stages, weight resident or not, halo buffers) is
// made in int8_conv.py; this file checks that it fits.

#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "wgmma_s8.cuh"

#ifndef DLMCQ_CONV_GROUPED
#define DLMCQ_CONV_GROUPED 0
#endif

namespace {

// whether this build takes grouped convs (groups > 1) or ungrouped ones
constexpr bool GROUPED = DLMCQ_CONV_GROUPED != 0;

using namespace dlmcq;

constexpr int CONSUMER_WGS = 2;
constexpr int CONSUMERS = CONSUMER_WGS * WG_THREADS;
constexpr int PRODUCER_WARPS = 4;
constexpr int THREADS = CONSUMERS + 32 * PRODUCER_WARPS;

constexpr int MIN_STAGES = PRODUCER_WARPS;  // see the producer
constexpr int MAX_STAGES = 8;
constexpr int CHUNKS_16 = TILE_K / 16;  // 16-byte chunks in a tile row
constexpr int ROW_LIVE = 1 << 6;        // table flag: an output pixel before M

// Division of a non-negative int below 2^31 by a divisor fixed at launch:
// n / d = (n * mul) >> shift with mul = floor(2^shift / d) + 1 and
// shift = 31 + ceil(log2 d), exact for every such n (the table of a tile
// costs two divisions a pixel, and the hardware has no integer divider).
struct FastDiv {
  uint32_t mul;
  int shift;
  __device__ __forceinline__ int div(int n) const {
    return static_cast<int>(
        (static_cast<uint64_t>(static_cast<uint32_t>(n)) * mul) >> shift);
  }
};

inline FastDiv make_fastdiv(int d) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  FastDiv f;
  f.shift = 31 + l;
  f.mul = static_cast<uint32_t>((1ULL << f.shift) /
                                    static_cast<uint64_t>(d) + 1);
  return f;
}

struct ConvArgs {
  const int8_t* x;
  const uint8_t* wp;  // the nibble-packed weight (O, Kp/2), if w4
  const float* a;
  const float* b;
  void* out;
  const void* r;      // residual, r_kind: 0 none, 1 int8, 2 int32, 3 f32
  const float* ar;
  const float* br;
  const int* srow;    // the row term (or null): S per output pixel (and
                      // group: G a pixel, grouped)
  const float* crow;  // and c per output channel
  float qb;
  long long x_bytes;
  int H, W, C, Rp, O, Ho, Wo, M, stride, Kp;
  // groups: Cg and Og channels a group in and out, Tp bytes of K a tap
  // (grouped; C where C % 16 == 0 ungrouped), ntg N tiles a group
  int Cg, Og, Tp, ntg, G;
  int pad, pad_lo, lo, hi, relu, r_kind;
  int m_tiles, n_tiles, tiles, k_chunks, stages, resident;
  int halo_bufs, halo_bytes, pixels;  // halo_bufs 0: gather from x
  int w4;
  FastDiv by_hw, by_wo, by_m_tiles;   // / (Ho Wo), / Wo, / m_tiles
  FastDiv by_ntg, by_og;              // / ntg, / Og
};

// where the row term's S of output pixel `row` lies: one a pixel, or in G
// groups one a (pixel, group), the tile's group `grp`
__device__ __forceinline__ long long srow_at(const ConvArgs& g, int row,
                                             int grp) {
  if constexpr (GROUPED)
    return static_cast<long long>(row) * g.G + grp;
  else
    return row;
}

template <int BN, bool CODES>
struct Cfg {
  static constexpr int BM = CONSUMER_WGS * WGMMA_M;  // rows of a tile
  static constexpr int A_BYTES = BM * TILE_K;
  static constexpr int B_BYTES = BN * TILE_K;
  // staging row pitch: 16-byte aligned, and 8 rows 2 words wide on 8
  // different bank pairs (BN = 48 is so as it is)
  static constexpr int PITCH = BN == 48 ? 48 : BN + 16;
  static constexpr int STAGING = CODES ? BM * PITCH : 0;
  // two blocks an SM where the accumulator is small enough for 80 registers
  static constexpr int MIN_BLOCKS = BN == 48 ? 2 : 1;
  // rows a producer lane addresses and reads before it stores any: as many
  // as the registers allow
  static constexpr int BATCH = MIN_BLOCKS == 2 ? 4 : 16;
  // chunks a lane gathers from x (any C) before it stores any
  static constexpr int GATHER = MIN_BLOCKS == 2 ? 2 : 4;
};

// Byte offsets of a block's dynamic shared memory, from its 1024-byte
// aligned base; int8_conv.py computes `total` the same way.
struct Layout {
  int stage_bytes, bres, staging, halo, ab, rows, bars, total;
};

template <class C>
__host__ __device__ Layout make_layout(int stages, int resident, int k_chunks,
                                       int n_tiles, int halo_total) {
  Layout l;
  l.stage_bytes = C::A_BYTES + (resident ? 0 : C::B_BYTES);
  l.bres = stages * l.stage_bytes;
  l.staging = l.bres + (resident ? k_chunks * C::B_BYTES : 0);
  l.halo = l.staging + C::STAGING;
  l.ab = l.halo + halo_total;
  l.rows = l.ab + 2 * n_tiles * (C::B_BYTES / TILE_K) * 4;
  l.bars = l.rows + PRODUCER_WARPS * C::BM * 8;
  l.total = l.bars + (2 * MAX_STAGES + 1 + 4) * 8;
  return l;
}

// v[col] and v[col + 1] of an (O,) vector through the read-only path,
// zero past O.
__device__ __forceinline__ void load_pair(const float* v, int col, int O,
                                          float out[2]) {
  if (col < O) out[0] = __ldg(v + col);
  if (col + 1 < O) out[1] = __ldg(v + col + 1);
}

// The residual term of output row `row`, columns `col` and `col` + 1 (col
// even), read straight from global memory by the read-only path (both
// columns in one load where O is even and r aligned for it); zeros where
// the row or a column lies outside the output.
__device__ __forceinline__ void load_residual(const ConvArgs& g, int row,
                                              int col, float rv[2],
                                              float arv[2], float brv[2]) {
  if (row >= g.M || col >= g.O) return;
  const long long at = static_cast<long long>(row) * g.O + col;
  const bool two = col + 1 < g.O;
  if (g.r_kind == 1) {
    const int8_t* r = static_cast<const int8_t*>(g.r) + at;
    if (two && reinterpret_cast<uintptr_t>(r) % 2 == 0) {
      const char2 v = __ldg(reinterpret_cast<const char2*>(r));
      rv[0] = v.x;
      rv[1] = v.y;
    } else {
      rv[0] = __ldg(r);
      if (two) rv[1] = __ldg(r + 1);
    }
  } else if (g.r_kind == 2) {
    const int* r = static_cast<const int*>(g.r) + at;
    if (two && reinterpret_cast<uintptr_t>(r) % 8 == 0) {
      const int2 v = __ldg(reinterpret_cast<const int2*>(r));
      rv[0] = __int2float_rn(v.x);
      rv[1] = __int2float_rn(v.y);
    } else {
      rv[0] = __int2float_rn(__ldg(r));
      if (two) rv[1] = __int2float_rn(__ldg(r + 1));
    }
  } else {
    const float* r = static_cast<const float*>(g.r) + at;
    if (two && reinterpret_cast<uintptr_t>(r) % 8 == 0) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(r));
      rv[0] = v.x;
      rv[1] = v.y;
    } else {
      rv[0] = __ldg(r);
      if (two) rv[1] = __ldg(r + 1);
    }
  }
  arv[0] = __ldg(g.ar + col);
  brv[0] = __ldg(g.br + col);
  if (two) {
    arv[1] = __ldg(g.ar + col + 1);
    brv[1] = __ldg(g.br + col + 1);
  }
}

// The first input channel of the group whose output channels start at n0
// (0 in the ungrouped build).
__device__ __forceinline__ int group_offset(const ConvArgs& g, int n0) {
  return GROUPED ? g.by_og.div(n0) * g.Cg : 0;
}

// W4: the int8 B tile of output channels n0 .. n0 + BN - 1 at K chunk kc,
// unpacked from g.wp into the swizzled tile at shared address dst; thread
// `first` of `step` threads takes every step-th 16-byte chunk.  Rows past
// O and bytes past Kp are zero.  The loads of BATCH chunks go out before
// any store, so their latencies overlap.  The caller fences the stores.

template <int BN>
__device__ __forceinline__ void unpack_b_tile(const ConvArgs& g, int kc,
                                              int n0, uint32_t dst, int first,
                                              int step) {
  constexpr int CHUNKS = BN * CHUNKS_16;
  constexpr int BATCH = 4;
  const int pitch = g.Kp / 2;
  for (int i0 = first; i0 < CHUNKS; i0 += BATCH * step) {
    uint2 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * step;
      const int o = n0 + i / CHUNKS_16;
      const int kbyte = kc * TILE_K + 16 * (i % CHUNKS_16);
      v[u] = make_uint2(0u, 0u);
      if (i < CHUNKS && o < g.O && kbyte < g.Kp)
        v[u] = __ldg(reinterpret_cast<const uint2*>(
            g.wp + static_cast<long long>(o) * pitch + kbyte / 2));
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * step;
      if (i >= CHUNKS) break;
      uint32_t w[4];
      unpack_nibbles16(v[u].x, v[u].y, w);
      st_shared16(dst + swizzle128(i / CHUNKS_16, 16 * (i % CHUNKS_16)), w[0],
                  w[1], w[2], w[3]);
    }
  }
}

// RESIDUAL (codes only) adds the residual term and TERM a weight offset's
// row term: instantiations of their own, so that the epilogue without
// them keeps its registers
template <int BN, bool CODES, bool RESIDUAL, bool TERM>
__global__ void __launch_bounds__(THREADS, Cfg<BN, CODES>::MIN_BLOCKS)
int8_conv3x3_kernel(const __grid_constant__ CUtensorMap map_w,
                    const ConvArgs g) {
  using C = Cfg<BN, CODES>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  if (base % ATOM_BYTES != 0) __trap();  // the swizzle needs the alignment
  const Layout L = make_layout<C>(g.stages, g.resident, g.k_chunks, g.n_tiles,
                                  g.halo_bufs * g.halo_bytes);
  const uint32_t full = base + L.bars;
  const uint32_t empty = full + 8 * MAX_STAGES;
  const uint32_t bfull = empty + 8 * MAX_STAGES;
  const uint32_t hfull = bfull + 8;    // 2: a halo buffer has landed
  const uint32_t hempty = hfull + 16;  // 2: every producer warp has left it
  float* sa = reinterpret_cast<float*>(smem + L.ab);
  float* sb = sa + g.n_tiles * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if constexpr (GROUPED) {
    // a and b tile by tile: entry BN t + j is output channel (group,
    // column j of tile t's share of it), zero past the group's end
    for (int i = threadIdx.x; i < g.n_tiles * BN; i += THREADS) {
      const int t = i / BN;
      const int grp = g.by_ntg.div(t);
      const int local = (t - grp * g.ntg) * BN + (i - t * BN);
      const bool live = local < g.Og;
      sa[i] = live ? g.a[grp * g.Og + local] : 0.0f;
      sb[i] = live ? g.b[grp * g.Og + local] : 0.0f;
    }
  } else {
    for (int i = threadIdx.x; i < g.n_tiles * BN; i += THREADS) {
      sa[i] = i < g.O ? g.a[i] : 0.0f;
      sb[i] = i < g.O ? g.b[i] : 0.0f;
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      // lane 0 of the warp that fills it, and its expect_tx if B streams
      // by TMA
      mbar_init(full + 8 * s, g.resident || g.w4 ? 1 : 2);
      mbar_init(empty + 8 * s, 4 * CONSUMER_WGS);  // lane 0 of each warp
    }
    // the resident weight: TMA's expect_tx, or at W4 lane 0 of every
    // producer warp once its share is unpacked
    mbar_init(bfull, g.w4 ? PRODUCER_WARPS : 1);
    for (int h = 0; h < 2; ++h) {
      mbar_init(hfull + 8 * h, 1);
      mbar_init(hempty + 8 * h, PRODUCER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * CONSUMER_WGS) {
    // --------------------------------------------------- producer warps
    // Warp pw owns every PRODUCER_WARPS-th stage of the block's sequence of
    // (tile, K chunk) stages and fills it alone, so as many stages are in
    // flight as there are warps and free slots in the ring.  A barrier wait
    // tells a phase only from the one before, so a warp must not come to
    // wait for a slot's release while the release before that is still
    // due: with stages >= PRODUCER_WARPS the slot's previous use is at or
    // before this warp's own previous stage, whose slot it saw released.
    const int pw = warp - 4 * CONSUMER_WGS;
    if (g.w4 && g.resident) {
      for (int kc = 0; kc < g.k_chunks; ++kc)
        unpack_b_tile<BN>(g, kc, 0, base + L.bres + kc * C::B_BYTES,
                          32 * pw + lane, 32 * PRODUCER_WARPS);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(bfull);
    }
    if (!g.w4 && pw == 0 && lane == 0) {
      tma_prefetch_map(&map_w);
      if (g.resident) {
        mbar_arrive_expect_tx(bfull, g.k_chunks * C::B_BYTES);
        for (int kc = 0; kc < g.k_chunks; ++kc)
          tma_load_2d(base + L.bres + kc * C::B_BYTES, &map_w, bfull,
                      kc * TILE_K, 0);
      }
    }
    int2* rows = reinterpret_cast<int2*>(smem + L.rows) + pw * C::BM;
    const int q = lane % CHUNKS_16;   // this lane's chunk of every row
    const int r0 = lane / CHUNKS_16;  // its rows: r0 + 4 j
    // where chunk q lies in its rows, by the swizzle: rows r0 + 4 j have
    // row % 8 = r0 for even j and r0 + 4 for odd j
    const uint32_t chunk_at[2] = {static_cast<uint32_t>(q ^ r0) << 4,
                                  static_cast<uint32_t>(q ^ (r0 + 4)) << 4};
    const uint32_t pad4 =
        static_cast<uint32_t>(static_cast<uint8_t>(g.pad)) * 0x01010101u;
    // a chunk is 16 aligned bytes of one tap (grouped: where Cg % 16 == 0)
    const bool vec = (GROUPED ? g.Cg : g.C) % 16 == 0;
    const bool words = reinterpret_cast<uintptr_t>(g.x) % 4 == 0;
    const int hw = g.Ho * g.Wo;
    int stage = 0, turn = 0, my_tile = -1, walked = 0;
    uint32_t parity = 1;
    for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x, ++walked) {
      const int n_tile = g.by_m_tiles.div(tile);   // M fastest
      const int m0 = (tile - n_tile * g.m_tiles) * C::BM;
      // the tile's first output channel: grouped, in its group
      const int grp = GROUPED ? g.by_ntg.div(n_tile) : 0;
      const int n0 = GROUPED ? grp * g.Og + (n_tile - grp * g.ntg) * BN
                             : n_tile * BN;
      if (g.halo_bufs) {
        // Stride 1: output pixel m reads input pixels m + (dy-1) W + (dx-1),
        // so the tile reads one run of BM + 2 W + 2 pixels of x.  It is
        // fetched once, by one bulk copy, into a halo buffer; the warps
        // expand it into the im2col tiles from shared memory.  With two
        // buffers the next tile's run is fetched a tile ahead.
        const int nb = g.halo_bufs;
        if (walked > 0) {   // this warp has left the halo of the tile before
          __syncwarp();
          if (lane == 0) mbar_arrive(hempty + 8 * ((walked - 1) % nb));
        }
        if (pw == 0 && lane == 0) {
          for (int u = walked == 0 ? 0 : walked + nb - 1; u < walked + nb;
               ++u) {
            const long long next =
                blockIdx.x + static_cast<long long>(u) * gridDim.x;
            if (next >= g.tiles) break;
            const int b = u % nb, use = u / nb;
            if (use > 0) mbar_wait(hempty + 8 * b, (use - 1) & 1);
            const int m_tile = static_cast<int>(next) -
                               g.by_m_tiles.div(static_cast<int>(next)) *
                                   g.m_tiles;
            const int first = m_tile * C::BM - g.W - 1;
            const int lo = first > 0 ? first : 0;
            const int end = first + C::BM + 2 * g.W + 2;
            const int hi = end < g.pixels ? end : g.pixels;
            const uint32_t bytes = static_cast<uint32_t>(hi - lo) * g.C;
            mbar_arrive_expect_tx(hfull + 8 * b, bytes);
            bulk_load_1d(base + L.halo + b * g.halo_bytes + (lo - first) * g.C,
                         g.x + static_cast<long long>(lo) * g.C, bytes,
                         hfull + 8 * b);
          }
        }
        mbar_wait(hfull + 8 * (walked % nb), (walked / nb) & 1);
      }
      const uint8_t* halo =
          smem + L.halo +
          (g.halo_bufs ? walked % g.halo_bufs : 0) * g.halo_bytes;
      for (int kc = 0; kc < g.k_chunks; ++kc) {
        const bool mine = turn == pw;
        const int slot = stage;
        const uint32_t slot_parity = parity;
        if (++turn == PRODUCER_WARPS) turn = 0;
        if (++stage == g.stages) {
          stage = 0;
          parity ^= 1;
        }
        if (!mine) continue;
        if (tile != my_tile) {
          // where each output pixel of the tile reads: once per tile and warp
          my_tile = tile;
          __syncwarp();   // every lane has read the table of the tile before
          for (int r = lane; r < C::BM; r += 32) {
            const int m = m0 + r;
            // .x: pixel index of tap (0, 0); .y: bit dy set where window
            // row dy lies inside the image, bit 3 + dx likewise for window
            // column dx, bit 6 for a row before M (0: nothing to fill)
            int2 e = make_int2(0, 0);
            if (m < g.M) {
              const int n = g.by_hw.div(m);
              const int rem = m - n * hw;
              const int oh = g.by_wo.div(rem);
              const int ow = rem - oh * g.Wo;
              const int ih0 = oh * g.stride - g.pad_lo;
              const int iw0 = ow * g.stride - g.pad_lo;
              e.x = (n * g.H + ih0) * g.W + iw0;
              e.y = ROW_LIVE;
#pragma unroll
              for (int d = 0; d < 3; ++d) {
                if (static_cast<unsigned>(ih0 + d) <
                    static_cast<unsigned>(g.H))
                  e.y |= 1 << d;
                if (static_cast<unsigned>(iw0 + d) <
                    static_cast<unsigned>(g.W))
                  e.y |= 8 << d;
              }
            }
            rows[r] = e;
          }
          __syncwarp();
        }
        mbar_wait(empty + 8 * slot, slot_parity);
        const uint32_t a_tile = base + slot * L.stage_bytes;
        const uint32_t a_row0 = a_tile + r0 * TILE_K;  // its rows: + 512 j
        if (!g.resident && g.w4) {
          unpack_b_tile<BN>(g, kc, n0, a_tile + C::A_BYTES, lane, 32);
        } else if (!g.resident && lane == 0) {
          mbar_arrive_expect_tx(full + 8 * slot, C::B_BYTES);
          tma_load_2d(a_tile + C::A_BYTES, &map_w, full + 8 * slot,
                      kc * TILE_K, n0);
        }
        if (g.halo_bufs) {
          // from the halo: pixel (row + dy W + dx) of the run, 16 bytes
          const int kbyte = kc * TILE_K + 16 * q;
          if (kbyte < g.Kp) {
            const int tp = GROUPED ? g.Tp : g.C;
            const int tap = kbyte / tp;
            const int coff = kbyte - tap * tp;
            const int dy = tap / 3;
            const int dx = tap - 3 * dy;
            const int need = (1 << dy) | (8 << dx);
            const uint8_t* from =
                halo + ((dy * g.W + dx + r0) * g.C + group_offset(g, n0) +
                        coff);
            const int step = 4 * g.C;   // from one of its rows to the next
            for (int j0 = 0; j0 < C::BM / 4; j0 += C::BATCH) {
              uint4 v[C::BATCH];
              uint32_t live = 0;
#pragma unroll
              for (int u = 0; u < C::BATCH; ++u) {
                const int flags = rows[r0 + 4 * (j0 + u)].y;
                live |= static_cast<uint32_t>(flags >> 6 & 1) << u;
                v[u] = make_uint4(pad4, pad4, pad4, pad4);
                if ((flags & need) == need)
                  v[u] = *reinterpret_cast<const uint4*>(from +
                                                         (j0 + u) * step);
              }
#pragma unroll
              for (int u = 0; u < C::BATCH; ++u)
                if (live >> u & 1)
                  st_shared16(a_row0 + 4 * TILE_K * (j0 + u) + chunk_at[u & 1],
                              v[u].x, v[u].y, v[u].z, v[u].w);
            }
          }
        } else if (vec) {
          // C % 16 == 0: a chunk lies inside one tap, K index = tap * Tp + c
          const int kbyte = kc * TILE_K + 16 * q;
          if (kbyte < g.Kp) {
            const int tp = GROUPED ? g.Tp : g.C;
            const int tap = kbyte / tp;
            const int coff = kbyte - tap * tp;
            const int dy = tap / 3;
            const int dx = tap - 3 * dy;
            const int doff = dy * g.W + dx;
            const int need = (1 << dy) | (8 << dx);
            // the chunk's bytes in pixel 0 (the group's channels in it)
            const int8_t* x0 = g.x + (group_offset(g, n0) + coff);
            // BATCH rows at a time: first where each reads (table entries
            // and address arithmetic, independent of one another), then the
            // copies back to back; a copy issued between two table reads
            // would put every row's latencies in a chain
            for (int j0 = 0; j0 < C::BM / 4; j0 += C::BATCH) {
              const int8_t* src[C::BATCH];
              uint32_t copy = 0, fill = 0;  // bit u: row u is copied / padded
#pragma unroll
              for (int u = 0; u < C::BATCH; ++u) {
                const int2 e = rows[r0 + 4 * (j0 + u)];
                src[u] = x0 + static_cast<long long>(e.x + doff) * g.C;
                if ((e.y & need) == need)
                  copy |= 1u << u;
                else
                  fill |= static_cast<uint32_t>(e.y >> 6 & 1) << u;
              }
#pragma unroll
              for (int u = 0; u < C::BATCH; ++u) {
                const uint32_t dst =
                    a_row0 + 4 * TILE_K * (j0 + u) + chunk_at[u & 1];
                if (copy >> u & 1)
                  cp_async16(dst, src[u], true);
                else if (fill >> u & 1)
                  st_shared16(dst, pad4, pad4, pad4, pad4);
              }
            }
          }
          cp_async_commit();
          cp_async_wait<0>();
        } else if (GROUPED && g.Cg % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(g.x) % 8 == 0) {
          // grouped, Cg % 8 == 0: as above, a chunk of one tap, K index
          // tap * Tp + c, but 8-byte aligned: two 8-byte cp.async (the
          // second zero-filled past the end of x; its bytes past the tap's
          // run are the next channels', which meet zero weights)
          const int kbyte = kc * TILE_K + 16 * q;
          if (kbyte < g.Kp) {
            const int tap = kbyte / g.Tp;
            const int coff = kbyte - tap * g.Tp;
            const int dy = tap / 3;
            const int dx = tap - 3 * dy;
            const int doff = dy * g.W + dx;
            const int need = (1 << dy) | (8 << dx);
            const int gc = group_offset(g, n0) + coff;
            for (int j = 0; j < C::BM / 4; ++j) {
              const int2 e = rows[r0 + 4 * j];
              const uint32_t dst = a_row0 + 4 * TILE_K * j + chunk_at[j & 1];
              if ((e.y & need) == need) {
                const long long off =
                    static_cast<long long>(e.x + doff) * g.C + gc;
                const bool second = off + 16 <= g.x_bytes;
                cp_async8(dst, g.x + off, true);
                cp_async8(dst + 8, second ? g.x + off + 8 : g.x, second);
              } else if (e.y & ROW_LIVE) {
                st_shared16(dst, pad4, pad4, pad4, pad4);
              }
            }
          }
          cp_async_commit();
          cp_async_wait<0>();
        } else if (GROUPED) {
          // grouped, Cg % 8 != 0: chunk qq of a row is 16 bytes of one
          // tap's run of Cg channels (K index tap * Tp + c) at an address
          // that need not be 8-byte aligned: five aligned words shifted
          // into place.  Bytes past the run are x's next ones (another
          // group's channels, or the next pixel's), which meet zero weights.
          // No registered RepVGG factory reaches it (their Cg are multiples
          // of 8); it serves any other grouping, e.g. the tests' toy widths
          // Cg = 10 and 20.
          const int left = (g.Kp - kc * TILE_K) / 16;
          const int valid = left < CHUNKS_16 ? left : CHUNKS_16;
          for (int first = lane; first < C::BM * valid;
               first += 32 * C::GATHER) {
            uint32_t w[C::GATHER][4];
            uint32_t dst[C::GATHER];
            uint32_t live = 0;   // bit u: chunk u is to be stored
#pragma unroll
            for (int u = 0; u < C::GATHER; ++u) {
              const int idx = first + 32 * u;
              if (idx >= C::BM * valid) continue;
              const int row = idx % C::BM;
              const int qq = idx / C::BM;
              const int2 e = rows[row];
              if (!(e.y & ROW_LIVE)) continue;
              dst[u] = a_tile + swizzle128(row, 16 * qq);
              live |= 1u << u;
              const int kbyte = kc * TILE_K + 16 * qq;
              const int tap = kbyte / g.Tp;
              const int coff = kbyte - tap * g.Tp;
              const int dy = tap / 3;
              const int dx = tap - 3 * dy;
              const int need = (1 << dy) | (8 << dx);
              if ((e.y & need) != need) {   // the tap is outside the image
#pragma unroll
                for (int i = 0; i < 4; ++i) w[u][i] = pad4;
                continue;
              }
              const long long off =
                  static_cast<long long>(e.x + dy * g.W + dx) * g.C +
                  group_offset(g, n0) + coff;
              const long long word0 = off & ~3LL;
              if (words && word0 + 20 <= g.x_bytes) {
                const uint32_t* src =
                    reinterpret_cast<const uint32_t*>(g.x + word0);
                const uint32_t shift = static_cast<uint32_t>(off & 3) * 8;
                uint32_t v[5];
#pragma unroll
                for (int i = 0; i < 5; ++i) v[i] = __ldg(src + i);
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  w[u][i] = __funnelshift_r(v[i], v[i + 1], shift);
              } else {
                // the last bytes of x, or x not word aligned: byte by byte,
                // zero past the end of x
#pragma unroll
                for (int i = 0; i < 4; ++i) w[u][i] = 0u;
#pragma unroll
                for (int i = 0; i < 16; ++i) {
                  if (off + i >= g.x_bytes) break;
                  w[u][i / 4] |= static_cast<uint32_t>(
                                     static_cast<uint8_t>(g.x[off + i]))
                                 << (8 * (i % 4));
                }
              }
            }
#pragma unroll
            for (int u = 0; u < C::GATHER; ++u)
              if (live >> u & 1)
                st_shared16(dst[u], w[u][0], w[u][1], w[u][2], w[u][3]);
          }
        } else {
          // any C: chunk qq of the stage holds bytes roff .. roff + 15 of the
          // 3 C bytes that row dy of the 3x3 window covers (contiguous in x);
          // GATHER chunks are read before any is stored
          const int left = (g.Kp - kc * TILE_K) / 16;
          const int valid = left < CHUNKS_16 ? left : CHUNKS_16;
          for (int first = lane; first < C::BM * valid;
               first += 32 * C::GATHER) {
            uint32_t w[C::GATHER][4];
            uint32_t dst[C::GATHER];
            uint32_t live = 0;   // bit u: chunk u is to be stored
#pragma unroll
            for (int u = 0; u < C::GATHER; ++u) {
              const int idx = first + 32 * u;
              if (idx >= C::BM * valid) continue;
              const int row = idx % C::BM;
              const int qq = idx / C::BM;
              const int2 e = rows[row];
              if (!(e.y & ROW_LIVE)) continue;
              dst[u] = a_tile + swizzle128(row, 16 * qq);
              live |= 1u << u;
              const int kbyte = kc * TILE_K + 16 * qq;
              const int dy = kbyte / g.Rp;
              const int roff = kbyte - dy * g.Rp;
              if (!(e.y >> dy & 1)) {   // window row dy is outside the image
#pragma unroll
                for (int i = 0; i < 4; ++i) w[u][i] = pad4;
                continue;
              }
              const int run = 3 * g.C - roff;  // bytes of the run from roff on
              const int nb = run < 16 ? run : 16;
              const long long off =
                  static_cast<long long>(e.x + dy * g.W) * g.C + roff;
              const long long word0 = off & ~3LL;
              const int last = roff + nb - 1;
              const int dx_first = (roff >= g.C) + (roff >= 2 * g.C);
              const int dx_last = (last >= g.C) + (last >= 2 * g.C);
              const int cols = e.y >> 3;  // bit dx: window column dx is inside
              if (words && word0 >= 0 && word0 + 20 <= g.x_bytes) {
                // 5 aligned words, shifted into place; they are x's own
                // bytes also where the window hangs over the left or right
                // border (the pixel before or after in memory)
                const uint32_t* src =
                    reinterpret_cast<const uint32_t*>(g.x + word0);
                const uint32_t shift = static_cast<uint32_t>(off & 3) * 8;
                uint32_t v[5];
#pragma unroll
                for (int i = 0; i < 5; ++i) v[i] = __ldg(src + i);
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  w[u][i] = __funnelshift_r(v[i], v[i + 1], shift);
                if (!((cols >> dx_first & 1) && (cols >> dx_last & 1))) {
                  // ... and there the border's bytes become the pad code
#pragma unroll
                  for (int i = 0; i < 16; ++i) {
                    const int r = roff + i;
                    const int dx = (r >= g.C) + (r >= 2 * g.C);
                    if (!(cols >> dx & 1))
                      w[u][i / 4] = (w[u][i / 4] & ~(0xFFu << (8 * (i % 4)))) |
                                    ((pad4 & 0xFFu) << (8 * (i % 4)));
                  }
                }
              } else {
                // the first or last bytes of x, or x not word aligned: byte
                // by byte, pad code outside the image
#pragma unroll
                for (int i = 0; i < 4; ++i) w[u][i] = 0u;
#pragma unroll
                for (int i = 0; i < 16; ++i) {
                  if (i >= nb) break;
                  const int r = roff + i;
                  const int dx = (r >= g.C) + (r >= 2 * g.C);
                  const uint32_t v = cols >> dx & 1
                                         ? static_cast<uint8_t>(g.x[off + i])
                                         : static_cast<uint8_t>(g.pad);
                  w[u][i / 4] |= v << (8 * (i % 4));
                }
              }
            }
#pragma unroll
            for (int u = 0; u < C::GATHER; ++u)
              if (live >> u & 1)
                st_shared16(dst[u], w[u][0], w[u][1], w[u][2], w[u][3]);
          }
        }
        // this warp's copies and stores have landed: make them visible to
        // wgmma and hand the stage over
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + 8 * slot);
      }
    }
    return;
  }

  // --------------------------------------------------- consumer warpgroups
  const int wg = warp / 4;
  const int t = threadIdx.x % WG_THREADS;
  int acc[BN / 2];
  int stage = 0;
  uint32_t parity = 0;
  if (g.resident) mbar_wait(bfull, 0);
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int n_tile = g.by_m_tiles.div(tile);
    const int m0 = (tile - n_tile * g.m_tiles) * C::BM + wg * WGMMA_M;
    const int n0 = n_tile * BN;   // the tile's a and b in sa and sb
    int prev = -1;
    for (int kc = 0; kc < g.k_chunks; ++kc) {
      mbar_wait(full + 8 * stage, parity);
      const uint32_t a_tile = base + stage * L.stage_bytes;
      const uint64_t da = smem_desc(a_tile + wg * WGMMA_M * TILE_K);
      const uint64_t db = smem_desc(
          g.resident ? base + L.bres + kc * C::B_BYTES : a_tile + C::A_BYTES);
      // all four 32-byte slices, also of a last chunk that K fills only
      // partly: the weight is zero there, whatever the A tile holds
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE_K / WGMMA_K; ++kk) {
        Wgmma<BN>::mma(acc, da + kk * DESC_K_STEP, db + kk * DESC_K_STEP,
                       (kc | kk) != 0);
      }
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();  // the group before this one has read its stage
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = stage;
      if (++stage == g.stages) {
        stage = 0;
        parity ^= 1;
      }
    }
    wgmma_wait<0>();
    acc_fence(acc);
    if (lane == 0) mbar_arrive(empty + 8 * prev);

    // the tile's first output channel c0 and the end of its columns
    // (grouped: its group's, past which nothing is stored); worked out
    // only now, out of the main loop where the accumulators hold the
    // registers
    const int grp = GROUPED ? g.by_ntg.div(n_tile) : 0;
    const int c0 = GROUPED ? grp * g.Og + (n_tile - grp * g.ntg) * BN : n0;
    const int c_end = GROUPED ? min(c0 + BN, (grp + 1) * g.Og) : g.O;

    // Epilogue.  Lane map: d[4 i + 2 h + e] is row 16 (warp % 4) + lane / 4
    // + 8 h, column 8 i + 2 (lane % 4) + e of a 64-row tile.
    const int row_in = 16 * (t / 32) + (t % 32) / 4;
    const int col_in = 2 * (t % 4);
    if (CODES) {
      uint8_t* stg = smem + L.staging + wg * WGMMA_M * C::PITCH;
      // A warp holds 16 rows of each 64-row tile, stages them and reads
      // them out itself: only its own lanes have to meet.
      __syncwarp();   // its read-out of the tile before is over
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint8_t* srow = stg + (row_in + 8 * h) * C::PITCH;
        const int orow = m0 + row_in + 8 * h;
        // the row term's S of this row (0 past M: not stored)
        const float sv = TERM && orow < g.M
                             ? __int2float_rn(__ldg(g.srow + srow_at(g, orow,
                                                                     grp)))
                             : 0.0f;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = 8 * i + col_in;
          const float2 av = *reinterpret_cast<const float2*>(sa + n0 + col);
          const float2 bv = *reinterpret_cast<const float2*>(sb + n0 + col);
          float cv[2] = {0.0f, 0.0f};
          if constexpr (TERM) load_pair(g.crow, c0 + col, g.O, cv);
          // the residual term of both columns: r, ar and br, zero outside
          // the output (those codes are not stored)
          float rv[2] = {0.0f, 0.0f}, arv[2] = {0.0f, 0.0f},
                brv[2] = {0.0f, 0.0f};
          if constexpr (RESIDUAL)
            load_residual(g, m0 + row_in + 8 * h, c0 + col, rv, arv, brv);
          int c[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float prod = __fmul_rn(__int2float_rn(acc[4 * i + 2 * h + e]),
                                   e ? av.y : av.x);
            if constexpr (TERM)
              prod = __fadd_rn(prod, __fmul_rn(sv, cv[e]));
            float y;
            if constexpr (!RESIDUAL) {
              y = __fadd_rn(prod, e ? bv.y : bv.x);
            } else {
              // the residual sum, term by term: ((qb + acc a) + b) + r ar + br
              y = __fadd_rn(__fadd_rn(g.qb, prod), e ? bv.y : bv.x);
              y = __fadd_rn(__fadd_rn(y, __fmul_rn(rv[e], arv[e])), brv[e]);
            }
            // rintf and the conversion in one cvt (cvt.rni rounds
            // half to even as rintf does, and saturates), then the clamp
            // on integers: the same code as clamp(rintf(y), lo, hi)
            c[e] = min(max(__float2int_rn(y), g.lo), g.hi);
          }
          // the low bytes of both codes, side by side
          *reinterpret_cast<uint16_t*>(srow + col) =
              static_cast<uint16_t>(__byte_perm(c[0], c[1], 0x0040));
        }
      }
      __syncwarp();
      int8_t* out = static_cast<int8_t*>(g.out);
      const int row0 = 16 * (t / 32);  // this warp's 16 rows
      if (g.O % 16 == 0 && (!GROUPED || g.Og % 16 == 0)) {
        constexpr int PER_ROW = BN / 16;
        for (int j = lane; j < 16 * PER_ROW; j += 32) {
          const int row = row0 + j / PER_ROW;
          const int col = c0 + 16 * (j % PER_ROW);
          if (m0 + row < g.M && col < c_end)
            *reinterpret_cast<uint4*>(
                out + static_cast<long long>(m0 + row) * g.O + col) =
                *reinterpret_cast<const uint4*>(stg + row * C::PITCH +
                                                16 * (j % PER_ROW));
        }
      } else {
        for (int j = lane; j < 16 * BN; j += 32) {
          const int row = row0 + j / BN;
          const int col = c0 + j % BN;
          if (m0 + row < g.M && col < c_end)
            out[static_cast<long long>(m0 + row) * g.O + col] =
                static_cast<int8_t>(stg[row * C::PITCH + j % BN]);
        }
      }
    } else {
      float* out = static_cast<float*>(g.out);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + row_in + 8 * h;
        if (row >= g.M) continue;
        float* orow = out + static_cast<long long>(row) * g.O;
        const float sv =
            TERM ? __int2float_rn(__ldg(g.srow + srow_at(g, row, grp)))
                 : 0.0f;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = c0 + 8 * i + col_in;
          const float2 av =
              *reinterpret_cast<const float2*>(sa + n0 + 8 * i + col_in);
          const float2 bv =
              *reinterpret_cast<const float2*>(sb + n0 + 8 * i + col_in);
          float cv[2] = {0.0f, 0.0f};
          if constexpr (TERM) load_pair(g.crow, col, g.O, cv);
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float prod = __fmul_rn(__int2float_rn(acc[4 * i + 2 * h + e]),
                                   e ? av.y : av.x);
            if constexpr (TERM)
              prod = __fadd_rn(prod, __fmul_rn(sv, cv[e]));
            y[e] = __fadd_rn(prod, e ? bv.y : bv.x);
            if (g.relu) y[e] = fmaxf(y[e], 0.0f);
          }
          if (g.O % 2 == 0 && (!GROUPED || c0 % 2 == 0) && col + 1 < c_end) {
            *reinterpret_cast<float2*>(orow + col) = make_float2(y[0], y[1]);
          } else {
            if (col < c_end) orow[col] = y[0];
            if (col + 1 < c_end) orow[col + 1] = y[1];
          }
        }
      }
    }
  }
}

template <int BN, bool CODES, bool RESIDUAL, bool TERM>
int launch(const CUtensorMap& map_w, const ConvArgs& g, cudaStream_t s) {
  using C = Cfg<BN, CODES>;
  const auto kernel = int8_conv3x3_kernel<BN, CODES, RESIDUAL, TERM>;
  const int smem =
      make_layout<C>(g.stages, g.resident, g.k_chunks, g.n_tiles,
                     g.halo_bufs * g.halo_bytes).total;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  int per_sm = 0, device = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    smem) != cudaSuccess ||
      per_sm < 1 || cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err
                                               : cudaErrorLaunchOutOfResources);
  }
  const int resident_blocks = per_sm * sms;
  const unsigned grid = static_cast<unsigned>(
      g.tiles < resident_blocks ? g.tiles : resident_blocks);
  kernel<<<grid, THREADS, smem, s>>>(map_w, g);
  return static_cast<int>(cudaGetLastError());
}

// The epilogue's instantiation at a tile width: f32, codes, or codes with a
// residual.
template <int BN, bool TERM>
int launch_mode(const CUtensorMap& map_w, const ConvArgs& g, int codes,
                cudaStream_t s) {
  return !codes    ? launch<BN, false, false, TERM>(map_w, g, s)
         : g.r_kind ? launch<BN, true, true, TERM>(map_w, g, s)
                    : launch<BN, true, false, TERM>(map_w, g, s);
}


// The compiled tile widths (a tile has 128 rows); listed in int8_conv.py too.
#define DLMCQ_CONV_TILES(X) X(48) X(96) X(192) X(256)

}  // namespace

extern "C" {

// Dynamic shared memory of a block at a plan, or -1 for a tile that is not
// compiled; int8_conv.py holds its own sum against it.
int dlmcq_int8_conv3x3_smem(int bn, int codes, int stages,
                            int resident, int k_chunks, int n_tiles,
                            int halo_total) {
#define DLMCQ_SMEM(BN)                                                      \
  if (bn == BN)                                                             \
    return codes ? make_layout<Cfg<BN, true>>(stages, resident,             \
                                                  k_chunks, n_tiles,         \
                                                  halo_total).total        \
                 : make_layout<Cfg<BN, false>>(stages, resident,            \
                                                   k_chunks, n_tiles,       \
                                                   halo_total).total;
  DLMCQ_CONV_TILES(DLMCQ_SMEM)
#undef DLMCQ_SMEM
  return -1;
}

// x (n, h, wd, c) int8, w packed as (o, kp) int8 with kp = 3 *
// roundup(3 c, 16) (in groups > 1 groups kp = 9 roundup(c / groups, 16)),
// or with w4 = 1 nibble-packed as (o, kp / 2) bytes, a
// and b (o,) float32, out (n, ho, wo, o) int8 (codes)
// or float32; pad_lo 1, or 0 at stride 2.  With r_kind 1, 2 or 3 (codes
// only) r is (n, ho, wo, o) int8, int32 or float32, ar and br (o,) float32
// and qb the grid's bias; with r_kind 0 they are not read.  srow (n, ho,
// wo) int32 (in groups > 1 groups (n, ho, wo, groups)) and crow (o,)
// float32 are the row term, or both null.  The
// plan (bn, stages, resident, halo_bufs) comes from int8_conv.py.  Launches on
// `stream`; returns cudaGetLastError() (0 on success), or the error that
// refused the tensor map or the plan.
int dlmcq_int8_conv3x3(const void* x, const void* w, const void* a,
                       const void* b, void* out, const void* r,
                       const void* ar, const void* br, const void* srow,
                       const void* crow, int n, int h, int wd,
                       int c, int o, int groups, int kp, int w4, int stride,
                       int pad,
                       int pad_lo,
                       int lo, int hi, int codes, int relu, int r_kind,
                       int bn, int stages, int resident, int halo_bufs,
                       float qb, void* stream) {
  ConvArgs g;
  g.x = static_cast<const int8_t*>(x);
  g.wp = static_cast<const uint8_t*>(w);
  g.w4 = w4 != 0;
  g.a = static_cast<const float*>(a);
  g.b = static_cast<const float*>(b);
  g.out = out;
  g.r = r;
  g.ar = static_cast<const float*>(ar);
  g.br = static_cast<const float*>(br);
  g.srow = static_cast<const int*>(srow);
  g.crow = static_cast<const float*>(crow);
  g.qb = qb;
  g.r_kind = r_kind;
  g.pad_lo = pad_lo;
  if (pad_lo < 0 || pad_lo > 1 || (pad_lo == 0 && stride != 2) ||
      r_kind < 0 || r_kind > 3 || (r_kind && !codes) || (!srow != !crow))
    return static_cast<int>(cudaErrorInvalidValue);
  if (groups < 1 || c % groups != 0 || o % groups != 0 ||
      (groups > 1) != GROUPED)
    return static_cast<int>(cudaErrorInvalidValue);
  g.H = h;
  g.W = wd;
  g.C = c;
  g.Rp = (3 * c + 15) / 16 * 16;
  g.Cg = c / groups;
  g.Og = o / groups;
  g.G = groups;
  g.Tp = groups > 1 ? (g.Cg + 15) / 16 * 16 : c;
  g.x_bytes = static_cast<long long>(n) * h * wd * c;
  g.O = o;
  g.Ho = (h - 1) / stride + 1;
  g.Wo = (wd - 1) / stride + 1;
  const long long m = static_cast<long long>(n) * g.Ho * g.Wo;
  const long long pixels = static_cast<long long>(n) * h * wd;
  if (m > INT_MAX - 1024 || pixels > INT_MAX - 1024 || h > 32766 ||
      wd > 32766 || kp != (groups > 1 ? 9 * g.Tp : 3 * g.Rp) ||
      stages < MIN_STAGES ||
      stages > MAX_STAGES || bn < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  g.M = static_cast<int>(m);
  g.stride = stride;
  g.Kp = kp;
  g.pad = pad;
  g.lo = lo;
  g.hi = hi;
  g.relu = relu;
  const int bm = CONSUMER_WGS * WGMMA_M;
  g.m_tiles = (g.M + bm - 1) / bm;
  g.ntg = (g.Og + bn - 1) / bn;
  g.n_tiles = groups * g.ntg;
  const long long tiles = static_cast<long long>(g.m_tiles) * g.n_tiles;
  if (tiles > INT_MAX || (resident && g.n_tiles != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  g.tiles = static_cast<int>(tiles);
  g.k_chunks = (kp + TILE_K - 1) / TILE_K;
  g.stages = stages;
  g.resident = resident;
  g.halo_bufs = halo_bufs;
  g.by_hw = make_fastdiv(g.Ho * g.Wo);
  g.by_wo = make_fastdiv(g.Wo);
  g.by_m_tiles = make_fastdiv(g.m_tiles);
  g.by_ntg = make_fastdiv(g.ntg);
  g.by_og = make_fastdiv(g.Og);
  g.halo_bytes = (bm + 2 * wd + 2) * c;
  g.pixels = static_cast<int>(pixels);
  if (halo_bufs < 0 || halo_bufs > 2 ||
      (halo_bufs && (stride != 1 || c % 16 != 0 || g.Cg % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_w = {};   // not read at W4
  if (!w4) {
    const int err = encode_tile_map(&map_w, w, o, kp, kp, bn);
    if (err != 0) return err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DLMCQ_LAUNCH(BN)                                        \
  if (bn == BN)                                                 \
    return srow ? launch_mode<BN, true>(map_w, g, codes, s)     \
                : launch_mode<BN, false>(map_w, g, codes, s);
  DLMCQ_CONV_TILES(DLMCQ_LAUNCH)
#undef DLMCQ_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* dlmcq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
