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
// jnp.round and torch.round do: a code is y clamped to [lo, hi] plus 1.5 *
// 2^23, whose low byte is the integer (code_of; the code that
// __float2int_rn and the clamp gave, in full-rate float ops where the cvt
// ran at a quarter of the rate).  The kernel equals its plain PyTorch
// version bit for bit.
//
// As a GEMM: M = N*Ho*Wo output pixels, N = O, K = 3*Rp bytes ordered (dy,
// dx, channel): the 3*C bytes that one row dy of the 3x3 window covers are
// consecutive bytes of x (NHWC) and stay one run of K, padded to Rp =
// roundup(3*C, 16).  With C % 16 == 0 nothing is padded, K = 9*C ordered
// (tap, channel), and every 16-byte chunk of K lies inside one tap.
//
// Bound on an H100: max(2*MACs / 1979e12, bytes / 3.35e12) with the input
// and the output counted once.  What a block really pays for is neither;
// by group of shapes, measured on an H100 80GB HBM3 at 700 W
// (tools/conv_plans.py, tools/conv_launches.py with --parts, which leaves
// one part of this file out; batch 256):
//  - RepVGG-A0's widths (48, 96, 192; the design below as PR 4 tuned it):
//    issue slots first.  An im2col chunk costs its producer lane an address
//    and a bounds test, an output code its consumer lane several slots, and
//    a block has 12 warps on 4 schedulers.  So a pixel's place in the image
//    is worked out once per tile into a table of flags, and a chunk takes
//    one table read, one mask test, one 16-byte load and one store.  Then
//    L2 traffic: the im2col tile has 9 bytes of K for every input byte, so
//    stride-1 layers fetch each tile's run of input pixels (its 128 pixels
//    and a row and a pixel to either side) once, by one bulk copy, into a
//    halo buffer and build their tiles from shared memory (stage3_k 53 ->
//    41 us, stage2_k 90 -> 60 us).  Then the epilogue, during which both
//    warpgroups, holding the same tile, leave the tensor cores idle: a
//    14x14 layer takes 39 us where its wgmmas need 17.
//  - The ResNets' 64 and 128 (ResNet-50 at 56^2 and 28^2, cifar_resnet18
//    at 32^2 and 16^2): 96- and 192-wide tiles wasted a third of their
//    columns, and at C = 64 the producers' im2col build from the halo (9
//    bytes written and read in shared memory for each input byte) bound the
//    layer: ResNet-50's stage 1 took 178 us, 128 without the tile build.
//    These widths take turns (each consumer warpgroup owns every other
//    tile, all 128 rows), and at C = 64 the consumers gather their A
//    fragments straight from a 64-byte-swizzled halo by ldmatrix (halo_a,
//    wgmma with A from registers): 100 us.  What is left there is the
//    epilogue's arithmetic (I2F at a quarter of the float rate).
//  - C % 128 == 0 at stride 1 (28^2 to 4^2): the chunk is 128 channels of
//    one tap and a tile's rows are 128 consecutive pixels of x, one TMA
//    box; the consumers pad the rows outside the image (tma_a).  ResNet-50
//    at 14^2: 128 us at 2 x 192 (no halo fitted, every A tile gathered by
//    cp.async, twice), 57 us at 256 with TMA rows; the products bound it.
//  - stride 2 (the first conv of a stage): the cp.async gather, 9 bytes of
//    L2 reads an input byte, which a row-aligned TMA box with an element
//    stride could replace: without it stage 2's 56^2 -> 28^2 takes 60 us
//    of its 104.
//  - the block closes (residual): r from registers, two columns a lane a
//    dependent load, took cifar_resnet18's 8 launches 2-2.9x their codes
//    twins; r staged by TMA takes them to 1.0-1.3x (1.55x at 8^2, where
//    r is staged at 128 wide and the codes twin runs 256 wide).
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
//    the proxy fence, and lane 0 arrives on the stage's full barrier.  With
//    tma_a lane 0 loads the A tile by TMA instead (the B tile with it).
//  - At 48, 96, 192 and 256 the consumers each take 64 rows of every tile:
//    per stage four wgmma m64nBNk32, one commit group per stage, a stage
//    handed back after wait_group<1>.  At 64 and 128 they take turns: each
//    owns every other tile and multiplies both 64-row halves, so that one
//    warpgroup's epilogue runs beside the other's products.  Each then
//    waits on full barriers of its own (a warpgroup never waits for the
//    other's stages, so one barrier a slot could be two phases behind,
//    which a parity wait cannot tell), and the ring has 4 or 8 stages, so
//    that each producer warp owns whole slots: the two warpgroups' releases
//    do not come in the ring's order.  All four 32-byte slices of a chunk
//    are multiplied also where K ends inside it (not with halo_a).
//  - Epilogue from the accumulator's lane map, a[o] and b[o] staged in
//    shared memory once per block.  Codes go to a staging tile in shared
//    memory (row pitch padded against bank conflicts; 128 columns a pass,
//    so that a 256-wide tile fits beside four stages) and leave as 16-byte
//    stores: a tile as wide as the layer is one contiguous run of NHWC
//    bytes.  Each warp stages and stores its own rows, so no barrier joins
//    the warpgroup.  f32 leaves as float2 per lane, 32 bytes a quad.  A
//    residual whose rows are whole 16 bytes (the host's choice, at the
//    turns widths) is staged by TMA: a warpgroup ends its tile in chunks of
//    128 bytes of a row of r, each in one of two slots (r's box in TMA's
//    swizzle of its row width, and the box of codes, over an int8 r); its
//    thread 0 loads the first two chunks' r at the tile's start, so they
//    land during the products, stores each box of codes by TMA and loads
//    the r two chunks on once the slot is free (int8_gemm.cu's staged
//    route, the warpgroup its own loader).
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
#include <type_traits>
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
constexpr int MAX_HALOS = 4;   // halo buffers
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
  // stride 1 with C % 128 == 0 (ungrouped, no halo): each A tile is one
  // TMA box of x, its rows outside the image padded by the consumers
  int tma_a, chunks_per_tap;
  // the widths that take turns with a resident weight and a halo: the
  // consumers gather their A fragments from the halo by ldmatrix (no
  // im2col tile); the producers only fetch the halos
  int halo_a, halo_rows, halo_boxes;   // halo_a: TMA boxes of a halo
  FastDiv by_hw, by_wo, by_m_tiles;   // / (Ho Wo), / Wo, / m_tiles
  FastDiv by_ntg, by_og;              // / ntg, / Og
  FastDiv by_c;                       // / C
};

// Where output pixel m reads, an entry of a tile's table: .x the pixel
// index of tap (0, 0); .y bit dy set where window row dy lies inside the
// image, bit 3 + dx likewise for window column dx, bit 6 for a row before
// M (0: nothing to fill).
__device__ __forceinline__ int2 row_entry(const ConvArgs& g, int m) {
  int2 e = make_int2(0, 0);
  if (m < g.M) {
    const int n = g.by_hw.div(m);
    const int rem = m - n * (g.Ho * g.Wo);
    const int oh = g.by_wo.div(rem);
    const int ow = rem - oh * g.Wo;
    const int ih0 = oh * g.stride - g.pad_lo;
    const int iw0 = ow * g.stride - g.pad_lo;
    e.x = (n * g.H + ih0) * g.W + iw0;
    e.y = ROW_LIVE;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      if (static_cast<unsigned>(ih0 + d) < static_cast<unsigned>(g.H))
        e.y |= 1 << d;
      if (static_cast<unsigned>(iw0 + d) < static_cast<unsigned>(g.W))
        e.y |= 8 << d;
    }
  }
  return e;
}

// Calls f(std::integral_constant<int, I>()) for I = 0 .. N - 1: a loop
// whose index is a compile-time constant, so that an accumulator indexed
// by it stays in registers (whether a #pragma unroll loop is unrolled is
// the compiler's choice, and where it is not the accumulator goes to
// local memory and every wgmma is serialized: ptxas' C7514).
template <int I, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>());
    static_for<I + 1, N>(f);
  }
}

// where the row term's S of output pixel `row` lies: one a pixel, or in G
// groups one a (pixel, group), the tile's group `grp`
__device__ __forceinline__ long long srow_at(const ConvArgs& g, int row,
                                             int grp) {
  if constexpr (GROUPED)
    return static_cast<long long>(row) * g.G + grp;
  else
    return row;
}

// What a consumer does with its finished accumulator: f32, codes, codes
// with a residual read from registers (the register route), or with a
// residual staged by TMA, int8 r or 4-byte r (int32 or f32).
enum Epi { EPI_F32 = 0, EPI_CODES = 1, EPI_RES = 2, EPI_RES8 = 3,
           EPI_RES32 = 4 };

template <int BN, int EPI>
struct Cfg {
  static constexpr int BM = CONSUMER_WGS * WGMMA_M;  // rows of a tile
  static constexpr int A_BYTES = BM * TILE_K;
  static constexpr int B_BYTES = BN * TILE_K;
  static constexpr bool CODES = EPI != EPI_F32;
  // The ResNets' widths take turns: each consumer warpgroup owns every
  // other tile of the block, all BM rows of it in two 64-row halves, so
  // that one warpgroup's epilogue runs beside the other's products.  The
  // other widths split every tile between the two warpgroups.
  static constexpr bool TURNS = BN == 64 || BN == 128;
  static constexpr int HALVES = TURNS ? 2 : 1;
  static constexpr int ROWS_WG = HALVES * WGMMA_M;   // a warpgroup's rows
  // staging of codes (without a staged residual): SW columns a pass (a
  // 256-wide tile in two passes, so that it fits beside four stages), row
  // pitch 16-byte aligned and 8 rows 2 words wide on 8 different bank
  // pairs (48 is so as it is)
  static constexpr bool STAGED_R = EPI == EPI_RES8 || EPI == EPI_RES32;
  static constexpr int SW = BN == 256 ? 128 : BN;
  static constexpr int PITCH = SW == 48 ? 48 : SW + 16;
  static constexpr int STAGING =
      CODES && !STAGED_R ? CONSUMER_WGS * ROWS_WG * PITCH : 0;
  // The staged residual: a warpgroup ends its tile chunk by chunk, CW
  // columns a chunk (128 bytes of a row of r, or the tile's width), in
  // SLOTS slots: r's box (ROWS_WG rows, TMA's swizzle of its row width),
  // and the box of codes (in place of an int8 r's)
  static constexpr int RB = EPI == EPI_RES8 ? 1 : 4;
  static constexpr int CW = BN < TILE_K / RB ? BN : TILE_K / RB;
  static constexpr int CHUNKS = BN / CW;
  static constexpr int R_ROW = CW * RB;
  static constexpr int O_ROW = CW;
  static constexpr bool IN_PLACE = RB == 1;
  static constexpr int R_AREA = ROWS_WG * R_ROW;
  static constexpr int SLOT = IN_PLACE ? R_AREA : R_AREA + ROWS_WG * O_ROW;
  static constexpr int SLOTS = 2;
  static constexpr int R_SLOTS = STAGED_R ? CONSUMER_WGS * SLOTS * SLOT : 0;
  // per-column parameters in shared memory: a and b, and ar and br
  static constexpr int PARAMS = STAGED_R ? 4 : 2;
  static constexpr int R_BARS = STAGED_R ? CONSUMER_WGS * SLOTS : 0;
  // two blocks an SM where the accumulator is small enough for 80 registers
  static constexpr int MIN_BLOCKS = BN == 48 ? 2 : 1;
  // rows a producer lane addresses and reads before it stores any: as many
  // as the registers allow
  static constexpr int BATCH = MIN_BLOCKS == 2 ? 4 : 16;
  // chunks a lane gathers from x (any C) before it stores any
  static constexpr int GATHER = MIN_BLOCKS == 2 ? 2 : 4;
  static_assert(!STAGED_R || (TURNS && SLOT % ATOM_BYTES == 0), "r slots");
};

// Byte offsets of a block's dynamic shared memory, from its 1024-byte
// aligned base; int8_conv.py computes `total` the same way.
struct Layout {
  int stage_bytes, bres, slots, staging, halo, ab, rows, bars, total;
};

template <class C>
__host__ __device__ Layout make_layout(int stages, int resident, int k_chunks,
                                       int n_tiles, int halo_total) {
  Layout l;
  l.stage_bytes = C::A_BYTES + (resident ? 0 : C::B_BYTES);
  l.bres = stages * l.stage_bytes;
  l.slots = l.bres + (resident ? k_chunks * C::B_BYTES : 0);
  l.staging = l.slots + C::R_SLOTS;
  // the halo buffers 1024-byte aligned: halo_a's are swizzled
  l.halo = (l.staging + C::STAGING + ATOM_BYTES - 1) / ATOM_BYTES * ATOM_BYTES;
  l.ab = l.halo + halo_total;
  l.rows = l.ab + C::PARAMS * n_tiles * (C::B_BYTES / TILE_K) * 4;
  l.bars = l.rows + PRODUCER_WARPS * C::BM * 8;
  l.total = l.bars + (3 * MAX_STAGES + 1 + 2 * MAX_HALOS + C::R_BARS) * 8;
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

// 1.5 * 2^23: a float32 sum with it lands on the integers, rounded half to
// even, and its low mantissa bits are the integer's two's complement
constexpr float MAGIC = 12582912.0f;
constexpr int MAGIC_BITS = 0x4B400000;

// A code: y clamped to [lo, hi] (integers, so the clamp and the rounding
// commute), then rounded half to even by the magic sum; the code is the low
// byte of the result.  The same code as clamp(rintf(y), lo, hi) in full-
// rate float ops, where a conversion (cvt.rni) runs at a quarter of the
// rate (int8_gemm.cu's staged_code).
__device__ __forceinline__ int code_of(float y, float lo, float hi) {
  return __float_as_int(__fadd_rn(fminf(fmaxf(y, lo), hi), MAGIC));
}

// A column pair of a staged r box (RB bytes a value; 4: int32 or f32 by
// r_kind) as float32; an int8 r exactly, as the magic number's float less
// the magic number (no conversion instruction).
template <int RB>
__device__ __forceinline__ float2 staged_r(const uint8_t* p, int r_kind) {
  if constexpr (RB == 1) {
    const char2 v = *reinterpret_cast<const char2*>(p);
    return make_float2(__fsub_rn(__int_as_float(MAGIC_BITS + v.x), MAGIC),
                       __fsub_rn(__int_as_float(MAGIC_BITS + v.y), MAGIC));
  } else {
    if (r_kind == 2) {
      const int2 v = *reinterpret_cast<const int2*>(p);
      return make_float2(__int2float_rn(v.x), __int2float_rn(v.y));
    }
    return *reinterpret_cast<const float2*>(p);
  }
}

// The staged residual: the r box of a warpgroup's chunk u (columns from
// col, rows from row) by TMA into its slot, reported to the slot's r full
// barrier.  Executed by thread 0 of the warpgroup, once the slot's last
// contents have been read.
template <class C>
__device__ __forceinline__ void load_r(const CUtensorMap* map, uint32_t slots,
                                       uint32_t bars, uint32_t u, int col,
                                       int row) {
  const uint32_t s = u % C::SLOTS;
  mbar_arrive_expect_tx(bars + 8 * s, C::R_AREA);
  tma_load_2d(slots + s * C::SLOT, map, bars + 8 * s, col * C::RB, row);
}

// halo_a's halo rows: one pixel of C = 64 channels, in TMA's 64-byte
// swizzle, so that the 8 rows of an ldmatrix phase meet no bank twice
constexpr int HALO_ROW = 64;

// halo_a, the widths that take turns with a resident weight and a halo:
// the products of a warpgroup's tile (all BM rows, two 64-row halves) with
// A gathered from the tile's halo buffer by ldmatrix, into registers (64-
// wide tiles at C = 64: K is 576 bytes, 18 steps of 32 in 5 chunks, every
// step's tap known at compile time).  At a step lane l of warp w gathers
// row 16 w + l % 16 of each half at byte 16 (l / 16): 16 bytes of the
// step's tap, pixel (row + dy W + dx) of the halo run at its swizzled
// place, or the 16-byte pad block where the tap lies outside the image or
// the row past M.  A chunk's gather goes into one of two register buffers
// while the wgmmas of the chunk before read the other (wgmma with A from
// registers, B the resident weight); the steps past K are skipped.  The
// warpgroup then hands the halo buffer back.  No producer builds an
// im2col tile: each A byte is read once from the halo, by the warp that
// multiplies it.
template <int BN>
__device__ __forceinline__ void halo_products(
    const ConvArgs& g, int (&acc)[2][BN / 2], uint32_t halos, uint32_t pad,
    uint32_t hfull, uint32_t hempty, int walked, int m0, uint32_t bres) {
  constexpr int STEPS = 9 * HALO_ROW / WGMMA_K;   // 18
  constexpr int KSTEPS = TILE_K / WGMMA_K;        // 4 a chunk
  constexpr int KC = (STEPS + KSTEPS - 1) / KSTEPS;   // 5 chunks
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  const int nb = g.halo_bufs;
  const int b = walked % nb;
  const uint32_t halo = halos + b * g.halo_bytes;
  int flags[2];
  int row[2];   // the halo row of the lane's row's tap (0, 0)
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    row[j] = 64 * j + 16 * warp + lane % 16;
    flags[j] = row_entry(g, m0 + row[j]).y;
  }
  const int half = 16 * (lane / 16);   // the lane's bytes of a K step
  uint32_t a[2][2][KSTEPS][4];         // [buffer][half of the rows][step]
  const auto gather = [&](auto chunk, uint32_t (&buf)[2][KSTEPS][4]) {
    constexpr int kc = decltype(chunk)::value;
    static_for<0, KSTEPS>([&](auto kstep) {
      constexpr int kk = decltype(kstep)::value;
      if constexpr (kc * KSTEPS + kk < STEPS) {
        constexpr int tap = (kc * TILE_K + kk * WGMMA_K) / HALO_ROW;
        constexpr int dy = tap / 3, dx = tap % 3;
        constexpr int need = (1 << dy) | (8 << dx);
        const int coff = (kk * WGMMA_K) % HALO_ROW + half;
        const int step = dy * g.W + dx;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          ldmatrix_x4(buf[j][kk],
                      (flags[j] & need) == need
                          ? halo + swizzle_box((row[j] + step) * HALO_ROW +
                                                   coff,
                                               HALO_ROW)
                          : pad);
      }
    });
  };
  mbar_wait(hfull + 8 * b, (walked / nb) & 1);
  gather(std::integral_constant<int, 0>(), a[0]);
  static_for<0, KC>([&](auto chunk) {
    constexpr int kc = decltype(chunk)::value;
    const uint64_t db = smem_desc(bres + kc * BN * TILE_K);
    wgmma_fence();
    static_for<0, KSTEPS>([&](auto kstep) {
      constexpr int kk = decltype(kstep)::value;
      if constexpr (kc * KSTEPS + kk < STEPS) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          WgmmaRS<BN>::mma(acc[j], a[kc & 1][j][kk], db + kk * DESC_K_STEP,
                           kc + kk != 0);
      }
    });
    wgmma_commit();
    // the chunk before has read its buffer, which the next chunk's gather
    // fills while this one's wgmmas run
    wgmma_wait<1>();
    if constexpr (kc + 1 < KC)
      gather(std::integral_constant<int, kc + 1>(), a[(kc + 1) & 1]);
  });
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 2; ++j) acc_fence(acc[j]);
  __syncwarp();
  if (lane == 0) mbar_arrive(hempty + 8 * b);
}

// EPI is the epilogue (Epi), TERM a weight offset's row term: an
// instantiation of its own, so that the epilogue without it keeps its
// registers and instructions.  map_x describes x as (pixels, C) in the A tile's
// boxes (read where tma_a is set); map_r and map_out describe r and the
// output in the boxes of a staged residual's chunk (Cfg); no other mode
// reads them.
template <int BN, int EPI, bool TERM>
__global__ void __launch_bounds__(THREADS, Cfg<BN, EPI>::MIN_BLOCKS)
int8_conv3x3_kernel(const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_r,
                    const __grid_constant__ CUtensorMap map_out,
                    const ConvArgs g) {
  using C = Cfg<BN, EPI>;
  constexpr bool CODES = C::CODES;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  if (base % ATOM_BYTES != 0) __trap();  // the swizzle needs the alignment
  const Layout L = make_layout<C>(g.stages, g.resident, g.k_chunks, g.n_tiles,
                                  g.halo_bufs * g.halo_bytes);
  // full: a stage has landed, [warpgroup][slot] at the widths that take
  // turns (each warpgroup's barriers count only its own stages, so that a
  // parity wait never meets a phase two behind, which it could not tell
  // from the one it waits for), else [0][slot]; empty: its readers are done
  const uint32_t full = base + L.bars;
  const uint32_t empty = full + 8 * 2 * MAX_STAGES;
  const uint32_t bfull = empty + 8 * MAX_STAGES;
  // a halo buffer has landed; every warp that reads it has left it (the 4
  // producer warps, or with halo_a the 4 warps of the tile's warpgroup)
  const uint32_t hfull = bfull + 8;
  const uint32_t hempty = hfull + 8 * MAX_HALOS;
  // staged residual: a slot's r box has landed, (warpgroup, slot)
  const uint32_t r_full = hempty + 8 * MAX_HALOS;
  float* sa = reinterpret_cast<float*>(smem + L.ab);
  float* sb = sa + g.n_tiles * BN;
  float* sar = sb + g.n_tiles * BN;   // staged residual: ar and br
  float* sbr = sar + g.n_tiles * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t pad4 =     // 4 pad codes in a word
      static_cast<uint32_t>(static_cast<uint8_t>(g.pad)) * 0x01010101u;

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
      if constexpr (C::STAGED_R) {
        sar[i] = i < g.O ? g.ar[i] : 0.0f;
        sbr[i] = i < g.O ? g.br[i] : 0.0f;
      }
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      // lane 0 of the warp that fills it, and its expect_tx if B or (tma_a)
      // A streams by TMA
      for (int w = 0; w < (C::TURNS ? CONSUMER_WGS : 1); ++w)
        mbar_init(full + 8 * (w * MAX_STAGES + s),
                  g.tma_a || !(g.resident || g.w4) ? 2 : 1);
      // lane 0 of each warp that reads it: of both warpgroups, or at the
      // widths that take turns of the tile's own
      mbar_init(empty + 8 * s, 4 * (C::TURNS ? 1 : CONSUMER_WGS));
    }
    // the resident weight: TMA's expect_tx, or at W4 lane 0 of every
    // producer warp once its share is unpacked
    mbar_init(bfull, g.w4 ? PRODUCER_WARPS : 1);
    for (int h = 0; h < MAX_HALOS; ++h) {
      mbar_init(hfull + 8 * h, 1);
      mbar_init(hempty + 8 * h, 4);
    }
    // halo_a: 16 bytes of the pad code where an A row outside the image
    // points (the rows' table, which halo_a does not build)
    if (g.halo_a)
      st_shared16(base + L.rows, pad4, pad4, pad4, pad4);
    for (int b = 0; b < C::R_BARS; ++b) mbar_init(r_full + 8 * b, 1);
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
      if (g.tma_a || g.halo_a) tma_prefetch_map(&map_x);
      if (g.resident) {
        mbar_arrive_expect_tx(bfull, g.k_chunks * C::B_BYTES);
        for (int kc = 0; kc < g.k_chunks; ++kc)
          tma_load_2d(base + L.bres + kc * C::B_BYTES, &map_w, bfull,
                      kc * TILE_K, 0);
      }
    }
    if (g.halo_a) {
      // only the halos: tile u's run of pixels into buffer u % nb by one
      // bulk copy, once its warpgroup has left the buffer's tile before
      if (pw == 0 && lane == 0) {
        const int nb = g.halo_bufs;
        int u = 0;
        for (int tile = blockIdx.x; tile < g.tiles;
             tile += gridDim.x, ++u) {
          const int b = u % nb;
          if (u >= nb) mbar_wait(hempty + 8 * b, (u / nb - 1) & 1);
          const int m_tile = tile - g.by_m_tiles.div(tile) * g.m_tiles;
          const int first = m_tile * C::BM - g.W - 1;
          // boxes of halo_rows pixels from pixel `first` (zeros before and
          // past x), in the 64-byte swizzle
          mbar_arrive_expect_tx(hfull + 8 * b,
                                g.halo_boxes * g.halo_rows * HALO_ROW);
          for (int k = 0; k < g.halo_boxes; ++k)
            tma_load_2d(base + L.halo + b * g.halo_bytes +
                            k * g.halo_rows * HALO_ROW,
                        &map_x, hfull + 8 * b, 0, first + k * g.halo_rows);
        }
      }
      return;
    }
    int2* rows = reinterpret_cast<int2*>(smem + L.rows) + pw * C::BM;
    const int q = lane % CHUNKS_16;   // this lane's chunk of every row
    const int r0 = lane / CHUNKS_16;  // its rows: r0 + 4 j
    // where chunk q lies in its rows, by the swizzle: rows r0 + 4 j have
    // row % 8 = r0 for even j and r0 + 4 for odd j
    const uint32_t chunk_at[2] = {static_cast<uint32_t>(q ^ r0) << 4,
                                  static_cast<uint32_t>(q ^ (r0 + 4)) << 4};
    // a chunk is 16 aligned bytes of one tap (grouped: where Cg % 16 == 0)
    const bool vec = (GROUPED ? g.Cg : g.C) % 16 == 0;
    const bool words = reinterpret_cast<uintptr_t>(g.x) % 4 == 0;
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
        if (tile != my_tile && !g.tma_a) {
          // where each output pixel of the tile reads: once per tile and warp
          my_tile = tile;
          __syncwarp();   // every lane has read the table of the tile before
          for (int r = lane; r < C::BM; r += 32) rows[r] = row_entry(g, m0 + r);
          __syncwarp();
        }
        mbar_wait(empty + 8 * slot, slot_parity);
        const uint32_t a_tile = base + slot * L.stage_bytes;
        // the stage's full barrier: its tile's warpgroup's, in turns
        const uint32_t fbar =
            full + 8 * ((C::TURNS ? (walked & 1) * MAX_STAGES : 0) + slot);
        const uint32_t a_row0 = a_tile + r0 * TILE_K;  // its rows: + 512 j
        if (g.tma_a && lane == 0) {
          // the A tile by TMA: chunk kc is 128 channels of one tap, and the
          // tile's rows are 128 consecutive pixels of x from pixel m0 + (dy
          // - 1) W + (dx - 1) (zeros before and past x); the consumers pad
          // the rows whose tap lies outside the image.  A streamed W8 B
          // tile comes with it, reported to the same barrier.
          const int tap = kc / g.chunks_per_tap;
          const int dy = tap / 3;
          const int dx = tap - 3 * dy;
          const bool b_tma = !g.resident && !g.w4;
          mbar_arrive_expect_tx(fbar, C::A_BYTES + (b_tma ? C::B_BYTES : 0));
          tma_load_2d(a_tile, &map_x, fbar,
                      (kc - tap * g.chunks_per_tap) * TILE_K,
                      m0 + (dy - 1) * g.W + dx - 1);
          if (b_tma)
            tma_load_2d(a_tile + C::A_BYTES, &map_w, fbar, kc * TILE_K, n0);
        }
        if (!g.resident && g.w4) {
          unpack_b_tile<BN>(g, kc, n0, a_tile + C::A_BYTES, lane, 32);
        } else if (!g.resident && !g.tma_a && lane == 0) {
          mbar_arrive_expect_tx(fbar, C::B_BYTES);
          tma_load_2d(a_tile + C::A_BYTES, &map_w, fbar,
                      kc * TILE_K, n0);
        }
        if (g.tma_a) {
          // nothing more: the box is in flight
        } else if (g.halo_bufs) {
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
        if (lane == 0) mbar_arrive(fbar);
      }
    }
    return;
  }

  // --------------------------------------------------- consumer warpgroups
  const int wg = warp / 4;
  const int t = threadIdx.x % WG_THREADS;
  // The accumulator's lane map, in each 64-row half: d[4 i + 2 h + e] is
  // row 16 (warp % 4) + lane / 4 + 8 h, column 8 i + 2 (lane % 4) + e.
  const int row_in = 16 * (t / 32) + (t % 32) / 4;
  const int col_in = 2 * (t % 4);
  constexpr bool term = TERM;
  const float flo = static_cast<float>(g.lo), fhi = static_cast<float>(g.hi);
  // staged residual: this warpgroup's slots and their r full barriers
  const uint32_t r_slots = base + L.slots + wg * C::SLOTS * C::SLOT;
  const uint32_t r_bars = r_full + 8 * wg * C::SLOTS;
  if (C::STAGED_R && t == 0) {
    tma_prefetch_map(&map_r);
    tma_prefetch_map(&map_out);
  }
  // tma_a: the warpgroup pads its rows of each A tile whose tap lies
  // outside the image; thread t takes row pad_row of the tile, chunks
  // pad_q0 .. pad_q0 + PAD_QS - 1 of it
  constexpr int TPR = WG_THREADS / C::ROWS_WG;   // threads a row
  constexpr int PAD_QS = CHUNKS_16 / TPR;
  const int pad_row = (C::TURNS ? 0 : wg * WGMMA_M) + t / TPR;
  const int pad_q0 = (t % TPR) * PAD_QS;
  int acc[C::HALVES][BN / 2];
  int stage = 0;
  uint32_t parity = 0;
  uint32_t own = 0;   // turns: bit s flips at each of its own uses of slot s
  uint32_t ch = 0;   // staged residual: the chunks this warpgroup began
  if (g.resident) mbar_wait(bfull, 0);
  int walked = 0;
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x, ++walked) {
    if (C::TURNS && (walked & 1) != wg) {
      // the other warpgroup's tile: its stages go by
      const int seq = stage + g.k_chunks;
      parity ^= static_cast<uint32_t>(seq / g.stages) & 1u;
      stage = seq % g.stages;
      continue;
    }
    const int n_tile = g.by_m_tiles.div(tile);
    // the warpgroup's first output row; the tile's a and b in sa and sb
    const int m0 = (tile - n_tile * g.m_tiles) * C::BM +
                   (C::TURNS ? 0 : wg * WGMMA_M);
    const int n0 = n_tile * BN;
    // staged residual: the tile's chunks inside O, and the r boxes of the
    // first ones, in flight during the products
    const int n_chunks =
        C::STAGED_R ? min(C::CHUNKS, (g.O - n0 + C::CW - 1) / C::CW) : 0;
    if (C::STAGED_R && t == 0)
      for (int c = 0; c < C::SLOTS && c < n_chunks; ++c)
        load_r<C>(&map_r, r_slots, r_bars, ch + c, n0 + c * C::CW, m0);
    const int pad_flags =
        g.tma_a ? row_entry(g, (tile - n_tile * g.m_tiles) * C::BM + pad_row).y
                : 0;
    bool gathered = false;   // halo_a: the products are done
    if constexpr (C::TURNS) {
      if (g.halo_a) {
        if constexpr (BN == 64) {
          halo_products<BN>(g, acc, base + L.halo, base + L.rows, hfull,
                            hempty, walked, m0, base + L.bres);
          gathered = true;
        }
      }
    }
    if (!gathered) {
    int prev = -1;
    for (int kc = 0; kc < g.k_chunks; ++kc) {
      if constexpr (C::TURNS) {
        mbar_wait(full + 8 * (wg * MAX_STAGES + stage), (own >> stage) & 1u);
        own ^= 1u << stage;
      } else {
        mbar_wait(full + 8 * stage, parity);
      }
      const uint32_t a_tile = base + stage * L.stage_bytes;
      if (g.tma_a) {
        // the box holds x's neighbouring pixels (or zeros) where the tap
        // lies outside the image: the pad code there, made visible to
        // wgmma before any warp of the warpgroup reads the tile
        const int tap = kc / g.chunks_per_tap;
        const int dy = tap / 3;
        const int need = (1 << dy) | (8 << (tap - 3 * dy));
        if ((pad_flags & ROW_LIVE) && (pad_flags & need) != need) {
#pragma unroll
          for (int q = 0; q < PAD_QS; ++q)
            st_shared16(a_tile + pad_row * TILE_K + 16 * (pad_q0 + q), pad4,
                        pad4, pad4, pad4);
        }
        fence_proxy_async();
        named_bar_sync(4 + wg, WG_THREADS);
      }
      const uint64_t db = smem_desc(
          g.resident ? base + L.bres + kc * C::B_BYTES : a_tile + C::A_BYTES);
      // all four 32-byte slices, also of a last chunk that K fills only
      // partly: the weight is zero there, whatever the A tile holds
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE_K / WGMMA_K; ++kk) {
#pragma unroll
        for (int j = 0; j < C::HALVES; ++j)
          Wgmma<BN>::mma(acc[j],
                         smem_desc(a_tile + (C::TURNS ? j : wg) * WGMMA_M *
                                                TILE_K) +
                             kk * DESC_K_STEP,
                         db + kk * DESC_K_STEP, (kc | kk) != 0);
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
#pragma unroll
    for (int j = 0; j < C::HALVES; ++j) acc_fence(acc[j]);
    if (lane == 0) mbar_arrive(empty + 8 * prev);
    }

    // the tile's first output channel c0 and the end of its columns
    // (grouped: its group's, past which nothing is stored); worked out
    // only now, out of the main loop where the accumulators hold the
    // registers
    const int grp = GROUPED ? g.by_ntg.div(n_tile) : 0;
    const int c0 = GROUPED ? grp * g.Og + (n_tile - grp * g.ntg) * BN : n0;
    const int c_end = GROUPED ? min(c0 + BN, (grp + 1) * g.Og) : g.O;

    if constexpr (C::STAGED_R) {
      // Chunk by chunk: wait for its r box, write the codes in the lane
      // map into the slot (over an int8 r), fence, meet at the
      // warpgroup's barrier; thread 0 stores the box by TMA (rows past M
      // and columns past O clipped) and loads the r box SLOTS chunks on
      // into the slot once it is free: an int8 r's once the store has
      // read the codes over it, a wider r's at once.  The box of codes of
      // a wider r is written again SLOTS chunks on, after the store that
      // read it is awaited (one chunk late).
      float sv[C::HALVES][2] = {};
      if (term) {
#pragma unroll
        for (int j = 0; j < C::HALVES; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + 64 * j + row_in + 8 * h;
            if (row < g.M) sv[j][h] = __int2float_rn(__ldg(g.srow + row));
          }
      }
      static_for<0, C::CHUNKS>([&](auto chunk) {
        constexpr int c = decltype(chunk)::value;
        if (c >= n_chunks) return;
        const uint32_t s = ch % C::SLOTS;
        uint8_t* slot = smem + L.slots + (wg * C::SLOTS + s) * C::SLOT;
        uint8_t* o_box = slot + (C::IN_PLACE ? 0 : C::R_AREA);
        mbar_wait(r_bars + 8 * s, (ch / C::SLOTS) & 1);
#pragma unroll
        for (int jj = 0; jj < C::CW / 8; ++jj) {
          const int i = c * (C::CW / 8) + jj;
          const int cw = 8 * jj + col_in;   // the pair's column in the chunk
          const int col = c * C::CW + cw;   // and in the tile
          const float2 av = *reinterpret_cast<const float2*>(sa + n0 + col);
          const float2 bv = *reinterpret_cast<const float2*>(sb + n0 + col);
          const float2 arv = *reinterpret_cast<const float2*>(sar + n0 + col);
          const float2 brv = *reinterpret_cast<const float2*>(sbr + n0 + col);
          float cv[2] = {0.0f, 0.0f};
          if (term) load_pair(g.crow, n0 + col, g.O, cv);
#pragma unroll
          for (int j = 0; j < C::HALVES; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 64 * j + row_in + 8 * h;   // in the box
              const float2 rv = staged_r<C::RB>(
                  slot + swizzle_box(r * C::R_ROW + C::RB * cw, C::R_ROW),
                  g.r_kind);
              int code[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float prod = __fmul_rn(
                    __int2float_rn(acc[j][4 * i + 2 * h + e]),
                    e ? av.y : av.x);
                if (term) prod = __fadd_rn(prod, __fmul_rn(sv[j][h], cv[e]));
                // the residual sum, term by term: ((qb + acc a) + b) + r ar
                // + br
                float y = __fadd_rn(__fadd_rn(g.qb, prod), e ? bv.y : bv.x);
                y = __fadd_rn(__fadd_rn(y, __fmul_rn(e ? rv.y : rv.x,
                                                     e ? arv.y : arv.x)),
                              e ? brv.y : brv.x);
                code[e] = code_of(y, flo, fhi);
              }
              *reinterpret_cast<uint16_t*>(
                  o_box + swizzle_box(r * C::O_ROW + cw, C::O_ROW)) =
                  static_cast<uint16_t>(__byte_perm(code[0], code[1], 0x0040));
            }
          }
        }
        fence_proxy_async();   // the box of codes is read by the TMA store
        if (t == 0 && !C::IN_PLACE && ch > 0) bulk_wait_read<C::SLOTS - 2>();
        named_bar_sync(2 + wg, WG_THREADS);
        if (t == 0) {
          tma_store_2d(&map_out, smem_u32(o_box), n0 + c * C::CW, m0);
          bulk_commit();
          if (C::IN_PLACE) bulk_wait_read<0>();
          if (c + C::SLOTS < n_chunks)
            load_r<C>(&map_r, r_slots, r_bars, ch + C::SLOTS,
                      n0 + (c + C::SLOTS) * C::CW, m0);
        }
        ++ch;
      });
    } else if constexpr (CODES) {
      uint8_t* stg = smem + L.staging + wg * C::ROWS_WG * C::PITCH;
      int8_t* out = static_cast<int8_t*>(g.out);
      const int row0 = 16 * (t / 32);  // this warp's 16 rows of each half
      // A warp holds 16 rows of each 64-row half, stages them and reads
      // them out itself, SW columns a pass: only its own lanes have to
      // meet.
      static_for<0, BN / C::SW>([&](auto pass) {
        constexpr int p = decltype(pass)::value;
        __syncwarp();   // its read-out of the pass before is over
#pragma unroll
        for (int j = 0; j < C::HALVES; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint8_t* srow = stg + (64 * j + row_in + 8 * h) * C::PITCH;
            const int orow = m0 + 64 * j + row_in + 8 * h;
            // the row term's S of this row (0 past M: not stored)
            const float sv =
                term && orow < g.M
                    ? __int2float_rn(__ldg(g.srow + srow_at(g, orow, grp)))
                    : 0.0f;
#pragma unroll
            for (int i = p * C::SW / 8; i < (p + 1) * C::SW / 8; ++i) {
              const int col = 8 * i + col_in;
              const float2 av =
                  *reinterpret_cast<const float2*>(sa + n0 + col);
              const float2 bv =
                  *reinterpret_cast<const float2*>(sb + n0 + col);
              float cv[2] = {0.0f, 0.0f};
              if (term) load_pair(g.crow, c0 + col, g.O, cv);
              // the residual term of both columns: r, ar and br, zero
              // outside the output (those codes are not stored)
              float rv[2] = {0.0f, 0.0f}, arv[2] = {0.0f, 0.0f},
                    brv[2] = {0.0f, 0.0f};
              if constexpr (EPI == EPI_RES)
                load_residual(g, orow, c0 + col, rv, arv, brv);
              int c[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float prod = __fmul_rn(
                    __int2float_rn(acc[j][4 * i + 2 * h + e]),
                    e ? av.y : av.x);
                if (term) prod = __fadd_rn(prod, __fmul_rn(sv, cv[e]));
                float y;
                if constexpr (EPI != EPI_RES) {
                  y = __fadd_rn(prod, e ? bv.y : bv.x);
                } else {
                  // the residual sum, term by term: ((qb + acc a) + b) +
                  // r ar + br
                  y = __fadd_rn(__fadd_rn(g.qb, prod), e ? bv.y : bv.x);
                  y = __fadd_rn(__fadd_rn(y, __fmul_rn(rv[e], arv[e])),
                                brv[e]);
                }
                c[e] = code_of(y, flo, fhi);
              }
              // the low bytes of both codes, side by side
              *reinterpret_cast<uint16_t*>(srow + col - p * C::SW) =
                  static_cast<uint16_t>(__byte_perm(c[0], c[1], 0x0040));
            }
          }
        }
        __syncwarp();
        // staged row rr of the warp's: row 64 (rr / 16) + row0 + rr % 16
        if (g.O % 16 == 0 && (!GROUPED || g.Og % 16 == 0)) {
          constexpr int PER_ROW = C::SW / 16;
          for (int q = lane; q < 16 * C::HALVES * PER_ROW; q += 32) {
            const int rr = q / PER_ROW;
            const int row = 64 * (rr / 16) + row0 + rr % 16;
            const int col = c0 + p * C::SW + 16 * (q % PER_ROW);
            if (m0 + row < g.M && col < c_end)
              *reinterpret_cast<uint4*>(
                  out + static_cast<long long>(m0 + row) * g.O + col) =
                  *reinterpret_cast<const uint4*>(stg + row * C::PITCH +
                                                  16 * (q % PER_ROW));
          }
        } else {
          for (int q = lane; q < 16 * C::HALVES * C::SW; q += 32) {
            const int rr = q / C::SW;
            const int row = 64 * (rr / 16) + row0 + rr % 16;
            const int col = c0 + p * C::SW + q % C::SW;
            if (m0 + row < g.M && col < c_end)
              out[static_cast<long long>(m0 + row) * g.O + col] =
                  static_cast<int8_t>(stg[row * C::PITCH + q % C::SW]);
          }
        }
      });
    } else {
      float* out = static_cast<float*>(g.out);
#pragma unroll
      for (int j = 0; j < C::HALVES; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + 64 * j + row_in + 8 * h;
          if (row >= g.M) continue;
          float* orow = out + static_cast<long long>(row) * g.O;
          const float sv =
              term ? __int2float_rn(__ldg(g.srow + srow_at(g, row, grp)))
                   : 0.0f;
#pragma unroll
          for (int i = 0; i < BN / 8; ++i) {
            const int col = c0 + 8 * i + col_in;
            const float2 av =
                *reinterpret_cast<const float2*>(sa + n0 + 8 * i + col_in);
            const float2 bv =
                *reinterpret_cast<const float2*>(sb + n0 + 8 * i + col_in);
            float cv[2] = {0.0f, 0.0f};
            if (term) load_pair(g.crow, col, g.O, cv);
            float y[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float prod = __fmul_rn(
                  __int2float_rn(acc[j][4 * i + 2 * h + e]), e ? av.y : av.x);
              if (term) prod = __fadd_rn(prod, __fmul_rn(sv, cv[e]));
              y[e] = __fadd_rn(prod, e ? bv.y : bv.x);
              if (g.relu) y[e] = fmaxf(y[e], 0.0f);
            }
            if (g.O % 2 == 0 && (!GROUPED || c0 % 2 == 0) &&
                col + 1 < c_end) {
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
  // the staged residual's last stores have written the output
  if (C::STAGED_R && t == 0) bulk_wait<0>();
}

template <int BN, int EPI, bool TERM>
int launch(const CUtensorMap& map_w, const CUtensorMap& map_x,
           const ConvArgs& g, cudaStream_t s) {
  using C = Cfg<BN, EPI>;
  const auto kernel = int8_conv3x3_kernel<BN, EPI, TERM>;
  CUtensorMap map_r = {}, map_out = {};   // read by a staged residual only
  if constexpr (C::STAGED_R) {
    // r and the output in the boxes of a chunk: rows of whole 16 bytes
    // (the host sends the rest to the register route)
    if (g.O % 16 != 0 || reinterpret_cast<uintptr_t>(g.r) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    int err = encode_box_map(&map_r, g.r, g.M,
                             static_cast<uint64_t>(g.O) * C::RB, C::ROWS_WG,
                             C::R_ROW);
    if (err == 0)
      err = encode_box_map(&map_out, g.out, g.M, g.O, C::ROWS_WG, C::O_ROW);
    if (err != 0) return err;
  }
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
  kernel<<<grid, THREADS, smem, s>>>(map_w, map_x, map_r, map_out, g);
  return static_cast<int>(cudaGetLastError());
}

// The epilogue's instantiation at a tile width: f32, codes, or codes with a
// residual (the register route at the widths that split a tile, staged by
// TMA at those that take turns; a 256-wide tile takes none: the plan never
// sends a residual there).
template <int BN, bool TERM>
int launch_mode(const CUtensorMap& map_w, const CUtensorMap& map_x,
                const ConvArgs& g, int codes, cudaStream_t s) {
  if (!codes) return launch<BN, EPI_F32, TERM>(map_w, map_x, g, s);
  if (!g.r_kind) return launch<BN, EPI_CODES, TERM>(map_w, map_x, g, s);
  if constexpr (Cfg<BN, EPI_F32>::TURNS)
    return g.r_kind == 1 ? launch<BN, EPI_RES8, TERM>(map_w, map_x, g, s)
                         : launch<BN, EPI_RES32, TERM>(map_w, map_x, g, s);
  else if constexpr (BN == 256)
    return static_cast<int>(cudaErrorInvalidValue);
  else
    return launch<BN, EPI_RES, TERM>(map_w, map_x, g, s);
}

// The compiled tile widths (a tile has 128 rows); listed in int8_conv.py
// too.  The grouped build has no ResNet widths (64, 128: turns).
#if DLMCQ_CONV_GROUPED
#define DLMCQ_CONV_TILES(X) X(48) X(96) X(192) X(256)
#else
#define DLMCQ_CONV_TILES(X) X(48) X(64) X(96) X(128) X(192) X(256)
#endif

// Dynamic shared memory at a width and epilogue (EPI; a register-route
// residual lays it out as codes), or -1 where the width has no such
// epilogue.
template <int BN>
int smem_of(int epi, int stages, int resident, int k_chunks, int n_tiles,
            int halo_total) {
  constexpr bool TURNS = Cfg<BN, EPI_F32>::TURNS;
  switch (epi) {
    case EPI_F32:
      return make_layout<Cfg<BN, EPI_F32>>(stages, resident, k_chunks,
                                            n_tiles, halo_total).total;
    case EPI_CODES:
    case EPI_RES:
      return make_layout<Cfg<BN, EPI_CODES>>(stages, resident, k_chunks,
                                              n_tiles, halo_total).total;
    case EPI_RES8:
    case EPI_RES32:
      if constexpr (TURNS)
        return epi == EPI_RES8
                   ? make_layout<Cfg<BN, EPI_RES8>>(stages, resident,
                                                    k_chunks, n_tiles,
                                                    halo_total).total
                   : make_layout<Cfg<BN, EPI_RES32>>(stages, resident,
                                                     k_chunks, n_tiles,
                                                     halo_total).total;
      return -1;
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block at a plan, or -1 for a tile or an
// epilogue that is not compiled (epi: 0 f32, 1 codes, 2 codes with a
// register-route residual, 3 and 4 with a staged int8 or 4-byte r);
// int8_conv.py holds its own sum against it.
int dlmcq_int8_conv3x3_smem(int bn, int epi, int stages,
                            int resident, int k_chunks, int n_tiles,
                            int halo_total) {
#define DLMCQ_SMEM(BN)                                                      \
  if (bn == BN)                                                             \
    return smem_of<BN>(epi, stages, resident, k_chunks, n_tiles, halo_total);
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
  // halo_a: 64-wide tiles at C = 64 with a resident weight and a halo: the
  // halo by TMA in boxes of at most 256 pixels, each buffer 1024-byte
  // aligned (int8_conv.py: halo_buffer)
  g.halo_a = bn == 64 && c == 64 && resident && halo_bufs > 0;
  g.halo_rows = bm + 2 * wd + 2 < 256 ? bm + 2 * wd + 2 : 256;
  g.halo_boxes = (bm + 2 * wd + 2 + g.halo_rows - 1) / g.halo_rows;
  if (g.halo_a)
    g.halo_bytes = (g.halo_boxes * g.halo_rows * c + ATOM_BYTES - 1) /
                   ATOM_BYTES * ATOM_BYTES;
  g.pixels = static_cast<int>(pixels);
  if (halo_bufs < 0 || halo_bufs > MAX_HALOS ||
      (halo_bufs && (stride != 1 || c % 16 != 0 || g.Cg % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  g.by_c = make_fastdiv(c);
  // halo_a: a warpgroup waits on the halos of its own tiles only, which
  // are unambiguous phases of their buffers where tiles of one buffer all
  // fall to one warpgroup: 2 or 4 buffers
  if (g.halo_a && halo_bufs != 2 && halo_bufs != 4)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_w = {};   // not read at W4
  if (!w4) {
    const int err = encode_tile_map(&map_w, w, o, kp, kp, bn);
    if (err != 0) return err;
  }
  // stride 1 with C % 128 == 0 and no halo: the A tiles by TMA, x as
  // (pixels, C) in boxes of 128 pixels x 128 bytes
  g.tma_a = !GROUPED && stride == 1 && c % TILE_K == 0 && halo_bufs == 0;
  g.chunks_per_tap = c / TILE_K;
  CUtensorMap map_x = {};
  if (g.tma_a || g.halo_a) {
    const int err =
        g.tma_a ? encode_tile_map(&map_x, x, g.pixels, c, c, bm)
                : encode_box_map(&map_x, x, g.pixels, c, g.halo_rows,
                                 HALO_ROW);
    if (err != 0) return err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DLMCQ_LAUNCH(BN)                                                \
  if (bn == BN)                                                         \
    return srow ? launch_mode<BN, true>(map_w, map_x, g, codes, s)      \
                : launch_mode<BN, false>(map_w, map_x, g, codes, s);
  DLMCQ_CONV_TILES(DLMCQ_LAUNCH)
#undef DLMCQ_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* dlmcq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
