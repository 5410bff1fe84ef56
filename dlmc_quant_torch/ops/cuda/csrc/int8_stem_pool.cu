// The ImageNet ResNet stem for Hopper (sm_90a): the int8 7x7/s2 conv, the
// 3x3/s2 max pool after it and the consumer's epilogue, in one launch, on
// wgmma s8.
//
// Replaces the XLA int8 conv of the JAX package's integer path at the stem
// (dlmc_quant_tpu/quant/layers.py:721-728, jax.lax.conv_general_dilated on
// the pad-code-padded codes) together with the pool that follows it on the
// chain (dlmc_quant_tpu/quant/chain.py:135-155, qmaxpool, which pools the
// int32 accumulator: the epilogue is monotone) and the next layer's folded
// quantize of the pooled accumulator (chain.fold_quantize, or materialize).
// No Pallas kernel did this on the TPU.  For input codes x (N, H, W, C)
// int8, C <= 4, a weight w (7, 7, C, O) int8 and top/left pads (top, left):
//
//   acc[n,r,c,o]    = sum_{dy,dx,ch} xpad[n, 2r+dy, 2c+dx, ch] * w[dy,dx,ch,o]
//   pooled[n,i,j,o] = max_{u,v in 0..2} acc[n, 2i-1+u, 2j-1+v, o]
//
// xpad is x with the int8 code `pad` (real 0 on the input's grid, not 0)
// outside the map; rows and columns of acc outside [0, Hc) x [0, Wc) lose
// the max, as flax's -inf and JAX's iinfo.min do.  Hp = (Hc - 1) / 2 + 1.
// out (N, Hp, Wp, O) is, by mode (ops/cuda/epilogue.py is the plain
// version of the last two):
//   int32: pooled
//   codes: clamp(rint(f32(pooled) * a[o] + b[o]), lo, hi)   int8
//   f32:   f32(pooled) * a[o] + b[o], then max(., 0) if relu
// each step one rounded float32 op (__fmul_rn, __fadd_rn, no fma; rint
// half to even), so that the kernel equals the plain version bit for bit.
// The conversions are exact integer and float adds (exact_float,
// code_byte), not the converting instructions.
// The pool runs before the epilogue, as on the chain: with a > 0 the
// epilogue is monotone, so it commutes with the max.
//
// Bound on an H100: at ResNet-50's batch 256 (224 -> 112 -> 56, O = 64)
// the conv's 60.4 G int8 operations take 0.0305 ms at 1979 TOP/s; x is
// 38.5 MB and the output 51.4 MB of codes (0.0268 ms at 3.35 TB/s) or
// 205.5 MB of int32 or f32 (0.0729 ms).  So codes mode is bound by its
// operations and the other two by their bytes.  The operations the tensor
// cores do are more: the 7x7x3 window is padded to K = 256 (4 x 4 cells of
// 16 bytes, below), each unit computes one conv row more than its pooled
// rows need, and 128 conv columns for ResNet-50's 113: about 129 G, 0.065
// ms at the peak, the floor of this layout.
//
// Design.  A block is one warpgroup, two blocks an SM; it walks units
// (image, band of `band` pooled rows, band of 63 pooled columns, tile of
// 64 output channels):
//  - The input band, staged.  A unit reads 4 band + 8 input rows of 262
//    pixels.  They land in shared memory as band rows by 16-byte cp.async
//    where x's rows are whole 16-byte pieces (W C % 16 == 0, 672 bytes at
//    the stem); each band row starts at the same address mod 16 as its
//    first pixel in x, so whole aligned pieces cover it (the bytes they
//    bring from beside the band are never read), and the pad code fills
//    what lies outside the map.  Other maps are staged byte by byte.  The
//    next unit's band is copied while this unit's products run: the band
//    buffer is free once the cells are built from it.
//  - Cells from the band.  Rows and columns of xpad are taken in pairs:
//    cell (R, Q) holds xpad[2R + py][2Q + px][ch] at byte (2 py + px) C +
//    ch of 16 bytes (the rest zero), two runs of 2 C bytes, one from each
//    of band rows 2R and 2R + 1: aligned 32-bit words from shared memory,
//    put together by __funnelshift_r, two cells a thread at a time, one
//    16-byte store a cell.  The 7x7/s2
//    window of conv pixel (r, c) is the 4x4 cells (r..r+3, c..c+3), with
//    the weight zero at the taps dy = 7 and dx = 7 that the 8x8 cell window
//    adds.  A unit's 2 band + 1 conv rows of 128 columns read 2 band + 4
//    rows of 131 cells.
//  - No im2col tile.  As a GEMM a conv row is D (64 channels x 128 pixels)
//    = W (64 x 256) * B (128 x 256)^T with K ordered (cell row a, cell
//    column b, byte).  Row p of B at K chunk (a, b) is cell (r + a, c0 + p +
//    b): in the unswizzled K-major layout (8-row core matrices, rows 16
//    bytes apart) the descriptor of a K slice of two chunks starts at cell
//    (a, b) of a cell row and steps 16 bytes (one cell) to its second
//    chunk and 128 bytes (8 cells) from one 8-row group to the next.  So
//    wgmma reads B straight from the cells, the overlapping windows
//    included; eight m64n128k32 wgmmas make a conv row.  The weight, packed
//    on the host as (chunk, O, 16), stays resident in shared memory in the
//    same layout (1024 bytes from one chunk to the next).  A weight of 4
//    bits or fewer comes nibble-packed, 8 bytes a cell (cell byte 2j in
//    the low nibble of byte j, ops/cuda/nibbles.py), and is unpacked to
//    int8 right where the block writes it into shared memory.
//  - A product in flight while pooling.  Two accumulators take the conv
//    rows in turns: conv row r + 1's wgmmas are issued, and the block pools
//    conv row r while they run; then it waits for them, and nothing is in
//    flight where its loop over rows turns round.
//  - Pool in registers.  A thread holds pixels 8i + 2(lane % 4) + {0, 1} of
//    two channels: the pooled column 4i + lane % 4 is the max of its two
//    and the next pixel, which one shuffle brings from the neighbouring
//    lane of the quad (or, for the quad's last lane, the first lane's next
//    register).  Only the image's first pooled column and the pixels past
//    the map's right edge need a border test.  Pooled row i is
//    max(h[2i-1], h[2i], h[2i+1]) over the column-pooled conv rows h: a
//    running max in registers, so each conv row is computed once, plus one
//    row at the top of each band.
//  - Epilogue and store by warp.  A warp holds 16 channels of every pooled
//    column: when the running max closes a pooled row it applies the mode's
//    epilogue in registers, stages the row in its own part of shared
//    memory (no block barrier) and writes it with 16-byte stores: a pooled
//    pixel's 16 channels are 16 bytes of codes, or 64 of int32 or f32.
//
// What holds it (tools/stem_parts.py on an NVIDIA H100 80GB HBM3 at 700 W,
// ResNet-50's stem at batch 256, codes mode): the whole takes 0.141 ms,
// 4.6x the bound; the products alone 0.078, the pool, epilogue and stores
// alone 0.068, the band and cells alone 0.039.  Two warpgroups an SM, at
// 220-245 registers a thread, overlap the three only in part.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma_s8.cuh"

namespace {

using namespace dlmcq;

constexpr int THREADS = WG_THREADS;       // one warpgroup a block
constexpr int PIX = 128;                  // conv columns a unit: the wgmma's N
constexpr int POOL_COLS = (PIX - 1) / 2;  // 63 pooled columns a unit
constexpr int TAPS = 4;                   // the window in cells: 4 x 4
constexpr int CELL = 16;                  // bytes of a cell: (py, px, ch)
constexpr int CHUNKS = TAPS * TAPS;       // 16-byte chunks of K = 256
constexpr int OT = WGMMA_M;               // channels a unit: the wgmma's M
constexpr int CELLS = PIX + TAPS - 1;     // cells of a unit's cell row
constexpr int ROW_BYTES = CELLS * CELL;
constexpr int BAND_PIX = 2 * CELLS;       // pixels of a band row
constexpr int W_TILE = CHUNKS * OT * CELL;  // a channel tile's weight
constexpr int MAX_BAND = 8;
constexpr int ACC = PIX / 2;              // accumulator registers a thread
constexpr int HP = PIX / 4;               // column-pooled values a thread
constexpr int STG_COLS = POOL_COLS + 1;   // staged pooled columns a warp
// bytes of a staged column: 16 channels of 4 bytes, 24 words apart so that
// a warp's staging stores fall on 32 banks; 16 bytes of codes
constexpr int STG_PITCH_WIDE = 96;
constexpr int STG_PITCH_CODES = 16;

enum Mode { INT32 = 0, CODES = 1, F32 = 2 };

struct StemArgs {
  const int8_t* x;
  const int8_t* w;   // (CHUNKS, O, CELL) int8, or (CHUNKS, O, CELL / 2) if w4
  void* out;
  const float* a;    // (O,) float32, codes and f32 modes
  const float* b;
  int H, W, O, top, left, Hc, Wc, Hp, Wp, pad, band, w4;
  int lo, hi, relu;
  int bands, col_bands, o_tiles, units;
  int pitch;         // bytes of a staged band row, a multiple of 16
  int vec;           // x's rows are whole aligned 16-byte pieces
};

__host__ __device__ constexpr int band_pitch(int c) {
  // the band row's span, its lead (< 16) and the aligned pieces' overhang
  return (BAND_PIX * c + 32 + 15) / 16 * 16;
}

__host__ __device__ constexpr int stg_pitch(int mode) {
  return mode == CODES ? STG_PITCH_CODES : STG_PITCH_WIDE;
}

__host__ __device__ constexpr int smem_bytes(int band, int o_tiles, int c,
                                             int mode) {
  return o_tiles * W_TILE + (2 * band + 4) * ROW_BYTES +
         (4 * band + 8) * band_pitch(c) +
         (THREADS / 32) * STG_COLS * stg_pitch(mode);
}

// The descriptor of an unswizzled K-major operand at shared address `addr`:
// 8-row core matrices whose rows lie 16 bytes apart, `lbo` bytes from the
// first 16-byte K chunk of a 32-byte slice to the second, `sbo` bytes from
// one 8-row group to the next; layout bits 0 (no swizzle).  See
// wgmma_s8.cuh's smem_desc() for the fields.
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Starts the products of one conv row into acc: D (64 channels x 128
// pixels) over eight K slices of two 16-byte chunks.  Slice s holds the
// cells (a, b) and (a, b + 1), a = s / 2, b = 2 (s % 2): A is the resident
// weight (1024 bytes from one chunk to the next), B the cells from cell
// row `row` (the conv row's first, at shared address `row`) on, one cell
// from one chunk to the next, 8 cells from one 8-pixel group to the next.
// Asynchronous until wgmma_wait.
__device__ __forceinline__ void issue_row(int (&acc)[ACC], uint32_t w_tile,
                                          uint32_t row) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < CHUNKS / 2; ++s) {
    const uint64_t da =
        plain_desc(w_tile + 2 * s * OT * CELL, OT * CELL, 8 * CELL);
    const uint64_t db =
        plain_desc(row + (s / 2) * ROW_BYTES + 2 * (s % 2) * CELL, CELL,
                   8 * CELL);
    Wgmma<PIX>::mma(acc, da, db, s);
  }
  wgmma_commit();
}

// The conversions of the epilogue as integer and float adds, which issue
// at a higher rate than the converting instructions.  MAGIC = 1.5 * 2^23:
// the floats from 2^23 to 2^24 are the integers, so for |v| < 2^22 the
// bits MAGIC_BITS + v are the float MAGIC + v, exactly.
constexpr float MAGIC = 12582912.0f;
constexpr int MAGIC_BITS = 0x4B400000;

// float(v), exact for |v| < 2^22 (a pooled accumulator is at most 49 C
// 128^2 <= 196 * 128^2 < 2^22 in magnitude): what __int2float_rn gives.
__device__ __forceinline__ float exact_float(int v) {
  return __fsub_rn(__int_as_float(MAGIC_BITS + v), MAGIC);
}

// The int8 code clamp(rint(y), lo, hi) as a byte: y clamped to [lo, hi]
// first (the same: rint is monotone and lo, hi are integers), then
// rounded half to even by the add of MAGIC, whose low byte is the code.
__device__ __forceinline__ uint8_t code_byte(float y, int lo, int hi) {
  const float c = fminf(fmaxf(y, static_cast<float>(lo)),
                        static_cast<float>(hi));
  return static_cast<uint8_t>(__float_as_int(__fadd_rn(c, MAGIC)));
}

// What a thread needs to pool and store a unit's rows.
struct Lane {
  int q, from, right_room;   // quad lane, its shuffle source, right border
  bool left_in;              // its pooled column q's first pixel is in the map
  uint8_t* stg;              // its warp's staging
  float a[2], b[2];          // the epilogue of its two channels
};

// Pools one conv row's accumulator over columns and folds it into the
// running max over rows.  acc[4 i + 2 h + e] is channel 16 warp + lane / 4
// + 8 h, pixel 8 i + 2 q + e (wgmma_s8.cuh's lane map); pooled column
// 4 i + q is the max of pixels 8 i + 2 q + {0, 1, 2} (one three-way max,
// __vimax3_s32), the third from lane q + 1's first (for q = 3, lane 0's at
// i + 1, by the same shuffle).  The first pixel lies left of the map only
// at the image's pooled column 0 (left_in false, i = 0).  The third lies
// right of it, among the pooled columns the unit stores, only at the
// image's last one where Wc is odd: RIGHT units test it (8 i >=
// right_room).  A conv row outside the map loses everywhere: only the
// unit's first and last conv rows can be, and only they test it (CHECK,
// `in`).  KIND 0: the unit's first conv row starts the running max; 1:
// conv row 2i joins it; 2: conv row 2i + 1 closes pooled row i, which goes
// through the epilogue into the warp's staging, and starts pooled row
// i + 1.
template <int KIND, int MODE, bool RIGHT, bool CHECK>
__device__ __forceinline__ void pool_row(const int (&acc)[ACC],
                                         int (&run)[HP], const Lane& L,
                                         bool in, int relu, int lo, int hi) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < PIX / 8; ++i) {
    const bool right_in = !RIGHT || 8 * i < L.right_room;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
      const int send = L.q != 0            ? v0
                       : i + 1 < PIX / 8 ? acc[4 * (i + 1) + 2 * h]
                                         : INT_MIN;
      const int next = __shfl_sync(0xFFFFFFFFu, send, L.from);
      int m = __vimax3_s32(i > 0 || L.left_in ? v0 : v1, v1,
                           right_in ? next : v1);
      if (CHECK) m = in ? m : INT_MIN;
      const int k = 2 * i + h;
      if (KIND == 0) {
        run[k] = m;
      } else if (KIND == 1) {
        run[k] = max(run[k], m);
      } else {
        const int v = max(run[k], m);
        run[k] = m;
        const int col = 4 * i + L.q, ch = lane / 4 + 8 * h;
        if (MODE == CODES || MODE == F32) {
          float y = __fadd_rn(__fmul_rn(exact_float(v), L.a[h]), L.b[h]);
          if (MODE == CODES) {
            L.stg[col * STG_PITCH_CODES + ch] = code_byte(y, lo, hi);
          } else {
            if (relu) y = fmaxf(y, 0.0f);
            reinterpret_cast<float*>(L.stg + col * STG_PITCH_WIDE)[ch] = y;
          }
        } else {
          reinterpret_cast<int*>(L.stg + col * STG_PITCH_WIDE)[ch] = v;
        }
      }
    }
  }
}

// Writes the warp's staged pooled row: `cols` pooled columns of its 16
// channels, from `dst` (the row's first column, the warp's first channel)
// on, a column `O` values apart, by 16-byte stores.
template <int MODE>
__device__ __forceinline__ void store_row(const uint8_t* stg, uint8_t* dst,
                                          int cols, int O) {
  const int lane = threadIdx.x % 32;
  if (MODE == CODES) {
#pragma unroll
    for (int it = 0; it < STG_COLS / 32; ++it) {
      const int col = lane + 32 * it;
      if (col < cols)
        *reinterpret_cast<uint4*>(dst + static_cast<long long>(col) * O) =
            *reinterpret_cast<const uint4*>(stg + col * STG_PITCH_CODES);
    }
  } else {
    // four 16-byte pieces a column
#pragma unroll
    for (int it = 0; it < 4 * STG_COLS / 32; ++it) {
      const int idx = lane + 32 * it;
      const int col = idx / 4, j = idx % 4;
      if (col < cols)
        *reinterpret_cast<uint4*>(dst + (static_cast<long long>(col) * O +
                                         4 * j) * 4) =
            *reinterpret_cast<const uint4*>(stg + col * STG_PITCH_WIDE +
                                            16 * j);
    }
  }
}

// Stages a unit's band: band row k (0 <= k < nr) is x's row y0 + k, its
// byte j (0 <= j < BAND_PIX C) pixel x0 + j / C, at band + k pitch + lead +
// j; the pad code outside the map.  Where x's rows are whole aligned
// 16-byte pieces (g.vec; lead is then x0 C mod 16) a band row is written
// in 16-byte pieces: the map's by cp.async, the pad code's by stores (the
// map's edges within a band row are the edges of x's row, so they fall on
// piece boundaries); else byte by byte (lead 0).  The caller commits the
// cp.async group.
template <int C>
__device__ __forceinline__ void stage_band(const StemArgs& g, uint8_t* band,
                                           int n, int y0, int x0, int nr,
                                           int lead) {
  constexpr int SPAN = BAND_PIX * C;
  const int t = threadIdx.x;
  const uint8_t pad = static_cast<uint8_t>(g.pad);
  // band pixels inside the map: [cx_lo, cx_hi); band rows: [r_lo, r_hi)
  const int cx_lo = min(max(0, -x0), BAND_PIX);
  const int cx_hi = max(cx_lo, min(BAND_PIX, g.W - x0));
  const int lo_b = cx_lo * C, hi_b = cx_hi * C;
  const int r_lo = min(max(0, -y0), nr);
  const int r_hi = max(r_lo, min(nr, g.H - y0));
  const long long x_row = static_cast<long long>(g.W) * C;
  // x's row y0 + k, pixel x0, is at src + k x_row
  const int8_t* src =
      g.x + ((static_cast<long long>(n) * g.H + y0) * g.W + x0) * C;
  if (g.vec) {
    // each band row's pieces: [0, p_lo) pad, [p_lo, p_hi) the map, then
    // pad to the piece holding its last byte; a row outside the map is
    // all pad
    const int p_lo = (lead + lo_b) / 16;
    const int p_hi = hi_b > lo_b ? (lead + hi_b + 15) / 16 : p_lo;
    const int pieces = (lead + SPAN + 15) / 16;
    const uint32_t pad4 = pad * 0x01010101u;
    const uint32_t base = smem_u32(band);
    // piece c of row k, stepping by THREADS without a division
    int k = t / pieces, c = t - k * pieces;
    const int dk = THREADS / pieces, dc = THREADS - dk * pieces;
    while (k < nr) {
      const uint32_t dst = base + k * g.pitch + 16 * c;
      if (k >= r_lo && k < r_hi && c >= p_lo && c < p_hi)
        cp_async16(dst, src + k * x_row + (16 * c - lead), true);
      else
        st_shared16(dst, pad4, pad4, pad4, pad4);
      c += dc;
      k += dk;
      if (c >= pieces) {
        c -= pieces;
        ++k;
      }
    }
    return;
  }
  for (int i = t; i < nr * SPAN; i += THREADS) {
    const int k = i / SPAN, j = i - k * SPAN;
    const bool in = k >= r_lo && k < r_hi && j >= lo_b && j < hi_b;
    band[k * g.pitch + j] =
        in ? static_cast<uint8_t>(__ldg(src + k * x_row + j)) : pad;
  }
}

// The unit's cells (R, Q), R < rows_c, Q < CELLS, from its staged band:
// bytes 0 .. 2C - 1 from band row 2R, 2C .. 4C - 1 from 2R + 1, the rest
// 0.  A thread builds two cells side by side, (R, 2m) and (R, 2m + 1):
// from each of the two band rows the 4C bytes at 4C m, from aligned 32-bit
// words put together by __funnelshift_r, split into the two cells' runs.
template <int C>
__device__ __forceinline__ void build_cells(const uint8_t* band, int pitch,
                                            int lead, uint32_t cells,
                                            int rows_c) {
  constexpr int BITS = 16 * C;   // bits of a run
  constexpr uint64_t MASK = BITS == 64 ? ~0ull : (1ull << (BITS % 64)) - 1;
  constexpr int WORDS = C + 1;   // the words that hold 4C bytes at any offset
  constexpr int PAIRS = (CELLS + 1) / 2;
  for (int i = threadIdx.x; i < rows_c * PAIRS; i += THREADS) {
    const int r = i / PAIRS, m = i - r * PAIRS;
    uint64_t run[2][2];   // [band row 2R + py][cell 2m + e]
#pragma unroll
    for (int py = 0; py < 2; ++py) {
      const int at = (2 * r + py) * pitch + lead + 4 * C * m;
      const uint32_t* w = reinterpret_cast<const uint32_t*>(band + (at & ~3));
      const int sh = 8 * (at & 3);
      uint32_t word[5], u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < WORDS; ++j) word[j] = w[j];
#pragma unroll
      for (int j = 0; j + 1 < WORDS; ++j)
        u[j] = __funnelshift_r(word[j], word[j + 1], sh);
      const uint64_t lo = u[0] | (static_cast<uint64_t>(u[1]) << 32);
      const uint64_t hi = u[2] | (static_cast<uint64_t>(u[3]) << 32);
      run[py][0] = lo & MASK;
      run[py][1] = BITS == 64 ? hi
                              : ((lo >> (BITS % 64)) |
                                 (BITS > 32 ? hi << ((64 - BITS) % 64) : 0ull)) &
                                    MASK;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = 2 * m + e;
      if (q >= CELLS) break;   // the odd cell count's last pair
      const uint64_t top = run[0][e], bot = run[1][e];
      const uint64_t lo = BITS == 64 ? top : top | (bot << (BITS % 64));
      const uint64_t hi = BITS == 64  ? bot
                          : BITS > 32 ? bot >> ((64 - BITS) % 64)
                                      : 0ull;
      st_shared16(cells + (r * CELLS + q) * CELL, static_cast<uint32_t>(lo),
                  static_cast<uint32_t>(lo >> 32), static_cast<uint32_t>(hi),
                  static_cast<uint32_t>(hi >> 32));
    }
  }
}

struct Unit {
  int n, i0, j0, ct, rows, cols, r0, c0, lead;
};

__device__ __forceinline__ Unit unit_of(const StemArgs& g, int u, int c) {
  Unit w;
  int rest = u;
  w.ct = rest % g.o_tiles;
  rest /= g.o_tiles;
  const int cb = rest % g.col_bands;
  rest /= g.col_bands;
  w.i0 = (rest % g.bands) * g.band;
  w.n = rest / g.bands;
  w.j0 = cb * POOL_COLS;
  w.rows = min(g.band, g.Hp - w.i0);
  w.cols = min(POOL_COLS, g.Wp - w.j0);
  w.r0 = 2 * w.i0 - 1;   // the unit's first conv row and column
  w.c0 = 2 * w.j0 - 1;
  w.lead = g.vec ? ((2 * w.c0 - g.left) * c) & 15 : 0;
  return w;
}

template <int C>
__device__ __forceinline__ void stage_unit(const StemArgs& g, uint8_t* band,
                                           const Unit& w) {
  stage_band<C>(g, band, w.n, 2 * w.r0 - g.top, 2 * w.c0 - g.left,
                4 * w.rows + 8, w.lead);
}

// The products, pool, epilogue and stores of one unit: conv rows r0 ..
// r0 + 2 rows, two accumulators in turns, conv row r + 1's products running
// while conv row r is pooled.  Each row's products are waited for before
// the next row's start, so that no product is in flight where the loop
// turns round (ptxas serializes the wgmmas of a pipeline that crosses it).
// Every conv row of the unit is multiplied, also one outside the map (its
// cells are staged all the same; it loses in the pool): one path for the
// wgmmas.  Pooled row k of the unit goes to dst + k dst_row.
template <int MODE, bool RIGHT>
__device__ __forceinline__ void unit_rows(const StemArgs& g, const Unit& w,
                                          const Lane& L, uint32_t w_tile,
                                          uint32_t c_base, uint8_t* dst,
                                          long long dst_row, int cols) {
  int acc0[ACC], acc1[ACC], run[HP];
  // only the first and the last conv row can lie outside the map
  const bool top_in = w.r0 >= 0, bottom_in = w.r0 + 2 * w.rows < g.Hc;
  issue_row(acc0, w_tile, c_base);
  wgmma_wait<0>();
  acc_fence(acc0);
  issue_row(acc1, w_tile, c_base + ROW_BYTES);
  pool_row<0, MODE, RIGHT, true>(acc0, run, L, top_in, g.relu, g.lo, g.hi);
  wgmma_wait<0>();
  acc_fence(acc1);
  issue_row(acc0, w_tile, c_base + 2 * ROW_BYTES);
  pool_row<1, MODE, RIGHT, false>(acc1, run, L, true, g.relu, g.lo, g.hi);
  wgmma_wait<0>();
  acc_fence(acc0);
  for (int k = 1; k < w.rows; ++k) {
    // conv row 2k closes pooled row k - 1 while 2k + 1 is multiplied
    issue_row(acc1, w_tile, c_base + (2 * k + 1) * ROW_BYTES);
    __syncwarp();   // the warp's read-out of its staging is over
    pool_row<2, MODE, RIGHT, false>(acc0, run, L, true, g.relu, g.lo, g.hi);
    __syncwarp();
    store_row<MODE>(L.stg, dst + (k - 1) * dst_row, cols, g.O);
    wgmma_wait<0>();
    acc_fence(acc1);
    issue_row(acc0, w_tile, c_base + (2 * k + 2) * ROW_BYTES);
    pool_row<1, MODE, RIGHT, false>(acc1, run, L, true, g.relu, g.lo, g.hi);
    wgmma_wait<0>();
    acc_fence(acc0);
  }
  __syncwarp();
  pool_row<2, MODE, RIGHT, true>(acc0, run, L, bottom_in, g.relu, g.lo,
                                 g.hi);
  __syncwarp();
  store_row<MODE>(L.stg, dst + (w.rows - 1) * dst_row, cols, g.O);
}

template <int C, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
int8_stem_pool_kernel(const StemArgs g) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* cells = smem + g.o_tiles * W_TILE;
  uint8_t* band = cells + (2 * g.band + 4) * ROW_BYTES;
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const uint32_t w_base = smem_u32(smem);
  const uint32_t c_base = smem_u32(cells);
  Lane L;
  L.q = lane % 4;
  // the lane whose pixel follows this lane's pair: the next of the quad
  L.from = (lane & ~3) | ((lane + 1) & 3);
  L.stg = band + (4 * g.band + 8) * g.pitch +
          warp * STG_COLS * stg_pitch(MODE);

  // the weight, resident: chunk k of row r of channel tile ct at
  // ((ct CHUNKS + k) OT + r) CELL; rows past O are zero
  for (int i = t; i < g.o_tiles * CHUNKS * OT; i += THREADS) {
    const int r = i % OT;
    const int k = (i / OT) % CHUNKS;
    const int o = (i / (OT * CHUNKS)) * OT + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    const long long cell = static_cast<long long>(k) * g.O + o;
    if (o < g.O && g.w4) {
      const uint2 p = __ldg(reinterpret_cast<const uint2*>(g.w) + cell);
      uint32_t u[4];
      unpack_nibbles16(p.x, p.y, u);
      v = make_uint4(u[0], u[1], u[2], u[3]);
    } else if (o < g.O) {
      v = __ldg(reinterpret_cast<const uint4*>(g.w) + cell);
    }
    *reinterpret_cast<uint4*>(smem + i * CELL) = v;
  }

  if (static_cast<int>(blockIdx.x) < g.units)
    stage_unit<C>(g, band, unit_of(g, blockIdx.x, C));
  cp_async_commit();

  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Unit w = unit_of(g, u, C);
    // the band has landed, its pad codes are written, and the unit before
    // is done with the cells
    cp_async_wait<0>();
    __syncthreads();
    build_cells<C>(band, g.pitch, w.lead, c_base, 2 * w.rows + 4);
    // the cells (and, the first time, the weight) are read by wgmma
    fence_proxy_async();
    __syncthreads();
    // the band is free: the next unit's is copied while this one's
    // products run
    if (u + static_cast<int>(gridDim.x) < g.units)
      stage_unit<C>(g, band, unit_of(g, u + gridDim.x, C));
    cp_async_commit();

    const uint32_t w_tile = w_base + w.ct * W_TILE;
    L.left_in = w.j0 + L.q > 0;
    L.right_room = g.Wc - w.c0 - 2 - 2 * L.q;
    // this warp's 16 channels, all inside O or all outside it
    const int ch0 = w.ct * OT + 16 * warp;
    const bool warp_in = ch0 < g.O;
    if (MODE != INT32) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = ch0 + lane / 4 + 8 * h;
        L.a[h] = warp_in ? __ldg(g.a + o) : 0.0f;
        L.b[h] = warp_in ? __ldg(g.b + o) : 0.0f;
      }
    }
    const int cols = warp_in ? w.cols : 0;
    constexpr int BYTES = MODE == CODES ? 1 : 4;
    uint8_t* dst = static_cast<uint8_t*>(g.out) +
                   ((static_cast<long long>(w.n) * g.Hp + w.i0) * g.Wp +
                    w.j0) * g.O * BYTES + ch0 * BYTES;
    const long long dst_row = static_cast<long long>(g.Wp) * g.O * BYTES;

    if ((g.Wc & 1) && w.j0 + w.cols == g.Wp)
      unit_rows<MODE, true>(g, w, L, w_tile, c_base, dst, dst_row, cols);
    else
      unit_rows<MODE, false>(g, w, L, w_tile, c_base, dst, dst_row, cols);
  }
}

template <int C, int MODE>
int launch(const StemArgs& g, cudaStream_t s) {
  const auto kernel = int8_stem_pool_kernel<C, MODE>;
  const int smem = smem_bytes(g.band, g.o_tiles, C, MODE);
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
  const int resident = per_sm * sms;
  const unsigned grid =
      static_cast<unsigned>(g.units < resident ? g.units : resident);
  kernel<<<grid, THREADS, smem, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_c(const StemArgs& g, int c, cudaStream_t s) {
  switch (c) {
    case 1: return launch<1, MODE>(g, s);
    case 2: return launch<2, MODE>(g, s);
    case 3: return launch<3, MODE>(g, s);
    default: return launch<4, MODE>(g, s);
  }
}

}  // namespace

extern "C" {

// out (n, hp, wp, o) from x (n, h, wd, c) int8 and w (16, o, 16) int8
// (int8_stem_pool.py: pack_weight), or with w4 = 1 (16, o, 8) nibble pairs
// (pack_weight_int4): the 7x7/s2 conv with top/left pads and hc x wc
// outputs, `pad` outside the map, max-pooled 3x3/s2 with pads 1, hp =
// (hc - 1) / 2 + 1, likewise wp; then by `mode` (0 int32, 1 codes: int8
// clamp(rint(p a + b), lo, hi), 2 f32: p a + b, ReLU if relu) with a and b
// (o,) float32 (unused in int32 mode).  1 <= c <= 4, o % 16 == 0, o <= 128,
// 1 <= band <= 8 pooled rows a unit.  Launches on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// geometry the kernel does not take.
int dlmcq_int8_stem_pool(const void* x, const void* w, void* out,
                         const void* a, const void* b, int n, int h, int wd,
                         int c, int o, int top, int left, int hc, int wc,
                         int pad, int band, int w4, int mode, int lo, int hi,
                         int relu, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 1 || c > 4 || o < 16 || o % 16 ||
      o > 2 * OT || hc < 1 || wc < 1 || band < 1 || band > MAX_BAND ||
      top < 0 || left < 0 || h > (INT_MAX - 64) / 2 ||
      wd > (INT_MAX - 2 * BAND_PIX - 64) / 2 || mode < INT32 || mode > F32 ||
      (mode != INT32 && (a == nullptr || b == nullptr)) ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  StemArgs g;
  g.x = static_cast<const int8_t*>(x);
  g.w = static_cast<const int8_t*>(w);
  g.out = out;
  g.a = static_cast<const float*>(a);
  g.b = static_cast<const float*>(b);
  g.H = h;
  g.W = wd;
  g.O = o;
  g.top = top;
  g.left = left;
  g.Hc = hc;
  g.Wc = wc;
  g.Hp = (hc - 1) / 2 + 1;
  g.Wp = (wc - 1) / 2 + 1;
  g.pad = pad;
  g.band = band;
  g.w4 = w4 != 0;
  g.lo = lo;
  g.hi = hi;
  g.relu = relu != 0;
  g.bands = (g.Hp + band - 1) / band;
  g.col_bands = (g.Wp + POOL_COLS - 1) / POOL_COLS;
  g.o_tiles = (o + OT - 1) / OT;
  g.pitch = band_pitch(c);
  g.vec = (static_cast<long long>(wd) * c) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long units =
      static_cast<long long>(n) * g.bands * g.col_bands * g.o_tiles;
  if (units > INT_MAX || static_cast<long long>(n) * g.Hp > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  g.units = static_cast<int>(units);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case INT32: return launch_c<INT32>(g, c, s);
    case CODES: return launch_c<CODES>(g, c, s);
    default: return launch_c<F32>(g, c, s);
  }
}

const char* dlmcq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
