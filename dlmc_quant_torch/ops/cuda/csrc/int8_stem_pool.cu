// The ImageNet ResNet stem for Hopper (sm_90a): the int8 7x7/s2 conv and
// the 3x3/s2 max pool after it, in one launch, on wgmma s8.
//
// Replaces the XLA int8 conv of the JAX package's integer path at the stem
// (dlmc_quant_tpu/quant/layers.py:721-728, jax.lax.conv_general_dilated on
// the pad-code-padded codes) together with the pool that follows it on the
// chain (dlmc_quant_tpu/quant/chain.py:135-155, qmaxpool, which pools the
// int32 accumulator: the epilogue is monotone).  No Pallas kernel did this
// on the TPU.  For input codes x (N, H, W, C) int8, C <= 4, a weight
// w (7, 7, C, O) int8 and top/left pads (top, left):
//
//   acc[n,r,c,o]    = sum_{dy,dx,ch} xpad[n, 2r+dy, 2c+dx, ch] * w[dy,dx,ch,o]
//   pooled[n,i,j,o] = max_{u,v in 0..2} acc[n, 2i-1+u, 2j-1+v, o]
//
// xpad is x with the int8 code `pad` (real 0 on the input's grid, not 0)
// outside the map; rows and columns of acc outside [0, Hc) x [0, Wc) lose
// the max, as flax's -inf and JAX's iinfo.min do.  out is pooled, (N, Hp,
// Wp, O) int32, Hp = (Hc - 1) / 2 + 1: what the chain's next two folded
// quantizes read.
//
// Bound on an H100: bytes.  The function reads x once and writes the
// pooled accumulator once: at ResNet-50's batch 256 (224 -> 112 -> 56,
// O = 64) 38.5 MB + 205.5 MB, 0.073 ms at 3.35 TB/s, against 60.4 G int8
// operations, 0.031 ms at 1979 TOP/s.  The im2col route it replaces wrote
// 0.5 GB of rows and read them back, wrote and pooled an 0.8 GB int32
// accumulator: this kernel keeps both in shared memory and registers.
//
// Design.  A block is one warpgroup; it walks units (image, band of `band`
// pooled rows, band of 63 pooled columns, tile of 64 output channels):
//  - The input once, as cells.  Rows and columns of xpad are taken in
//    pairs: cell (R, Q) holds xpad[2R + py][2Q + px][ch] at byte
//    (2 py + px) C + ch of 16 bytes (the rest zero), so the 7x7/s2 window of
//    conv pixel (r, c) is the 4x4 cells (r..r+3, c..c+3), with the weight
//    zero at the taps dy = 7 and dx = 7 that the 8x8 cell window adds.  A
//    unit's 2 band + 1 conv rows and 127 conv columns read 2 band + 4 rows
//    of 131 cells, which the block writes into shared memory once from x
//    (byte loads through the read-only path, four cells' loads in flight
//    a thread, the pad code outside the map).
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
//  - Pool in registers.  A thread holds pixels 8i + 2(lane % 4) + {0, 1} of
//    two channels: the pooled column 4i + lane % 4 is the max of its two
//    and the next pixel, which one shuffle brings from the neighbouring
//    lane of the quad (or, for the quad's last lane, the first lane's next
//    register).  Only the image's first pooled column and the pixels past
//    the map's right edge need a border test.  Pooled row i is
//    max(h[2i-1], h[2i], h[2i+1]) over the column-pooled conv rows h: a
//    running max in registers, so each conv row is computed once, plus one
//    row at the top of each band.
//  - Store wide.  A pooled row is staged in shared memory (row pitch 72
//    words: a warp's 32 stores fall on 32 banks) and leaves as 16-byte
//    stores, consecutive threads on consecutive addresses: with O <= 64 a
//    unit's pooled row is one contiguous run of NHWC int32.
//  - A block runs cells, products, pool and stores one after another;
//    three blocks an SM (about 150 registers a thread, 72 KB of shared
//    memory at 7 pooled rows a unit) hide one another's phases.

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
constexpr int W_TILE = CHUNKS * OT * CELL;  // a channel tile's weight
constexpr int PITCH = OT + 8;             // staging row, in words
constexpr int STAGING = (POOL_COLS + 1) * PITCH * 4;
constexpr int MAX_BAND = 8;
constexpr int ACC = PIX / 2;              // accumulator registers a thread
constexpr int HP = PIX / 4;               // column-pooled values a thread
constexpr int CELL_BATCH = 4;             // cells a thread loads at once

struct StemArgs {
  const int8_t* x;
  const int8_t* w;   // (CHUNKS, O, CELL) int8, or (CHUNKS, O, CELL / 2) if w4
  int32_t* out;
  int H, W, O, top, left, Hc, Wc, Hp, Wp, pad, band, w4;
  int bands, col_bands, o_tiles, units;
};

__host__ __device__ constexpr int smem_bytes(int band, int o_tiles) {
  return o_tiles * W_TILE + (2 * band + 4) * ROW_BYTES + STAGING;
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

// Pools one conv row's accumulator over columns and folds it into the
// running max over rows.  acc[4 i + 2 h + e] is channel 16 warp + lane / 4
// + 8 h, pixel 8 i + 2 q + e (wgmma_s8.cuh's lane map); pooled column
// 4 i + q is the max of pixels 8 i + 2 q + {0, 1, 2}, the third from lane
// q + 1's first (for q = 3, lane 0's at i + 1, by the same shuffle).  The
// first pixel lies left of the map only at the image's pooled column 0
// (left_in false, i = 0), the third right of it where 8 i >= right_room.
// MODE 0: the unit's first conv row starts the running max; 1: conv row 2i
// joins it; 2: conv row 2i + 1 closes pooled row i, staged at `slot`, and
// starts pooled row i + 1.
template <int MODE>
__device__ __forceinline__ void pool_row(const int (&acc)[ACC],
                                         int (&run)[HP], int32_t* slot,
                                         int q, int from, bool left_in,
                                         int right_room) {
#pragma unroll
  for (int i = 0; i < PIX / 8; ++i) {
    const bool right_in = 8 * i < right_room;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
      const int send = q != 0              ? v0
                       : i + 1 < PIX / 8 ? acc[4 * (i + 1) + 2 * h]
                                         : INT_MIN;
      const int next = __shfl_sync(0xFFFFFFFFu, send, from);
      const int m = max(max(v1, i > 0 || left_in ? v0 : v1),
                        right_in ? next : v1);
      const int k = 2 * i + h;
      if (MODE == 0) {
        run[k] = m;
      } else if (MODE == 1) {
        run[k] = max(run[k], m);
      } else {
        slot[4 * i * PITCH + 8 * h] = max(run[k], m);
        run[k] = m;
      }
    }
  }
}

// pool_row for a conv row outside the map: it loses everywhere
template <int MODE>
__device__ __forceinline__ void lose_row(int (&run)[HP], int32_t* slot) {
#pragma unroll
  for (int k = 0; k < HP; ++k) {
    if (MODE == 2) slot[4 * (k / 2) * PITCH + 8 * (k % 2)] = run[k];
    run[k] = INT_MIN;
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 3)
int8_stem_pool_kernel(const StemArgs g) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* cells = smem + g.o_tiles * W_TILE;
  int32_t* stg = reinterpret_cast<int32_t*>(cells +
                                            (2 * g.band + 4) * ROW_BYTES);
  const uint32_t w_base = smem_u32(smem);
  const uint32_t c_base = smem_u32(cells);
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32, q = lane % 4;
  // the lane whose pixel follows this lane's pair: the next of the quad
  const int from = (lane & ~3) | ((lane + 1) & 3);
  const uint32_t pad_byte = static_cast<uint8_t>(g.pad);

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

  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    int rest = u;
    const int ct = rest % g.o_tiles;
    rest /= g.o_tiles;
    const int cb = rest % g.col_bands;
    rest /= g.col_bands;
    const int i0 = (rest % g.bands) * g.band;
    const int n = rest / g.bands;
    const int j0 = cb * POOL_COLS;
    const int rows = min(g.band, g.Hp - i0);
    const int cols = min(POOL_COLS, g.Wp - j0);
    const int r0 = 2 * i0 - 1;   // the unit's first conv row and column
    const int c0 = 2 * j0 - 1;
    // 16-byte pieces of a pooled pixel's channels; jj = idx / per_col is
    // (idx per_col_inv) >> 16, exact for idx < 4096
    const int per_col = min(OT, g.O - ct * OT) / 4;
    const uint32_t per_col_inv = 65536u / per_col + 1u;
    __syncthreads();   // the unit before is done with the cells and staging

    // cells (r0 + sr, c0 + sc) for sr < 2 rows + 4, sc < CELLS; a thread
    // loads CELL_BATCH cells before it stores any, so that their loads are
    // in flight together
    const int8_t* xn = g.x + static_cast<long long>(n) * g.H * g.W * C;
    const int n_cells = (2 * rows + 4) * CELLS;
    for (int first = t; first < n_cells; first += CELL_BATCH * THREADS) {
      uint32_t word[CELL_BATCH][4];
#pragma unroll
      for (int b = 0; b < CELL_BATCH; ++b) {
        const int i = first + b * THREADS;
        const int sr = i / CELLS;
        const int sc = i - sr * CELLS;
        const int y0 = 2 * (r0 + sr) - g.top;
        const int x0 = 2 * (c0 + sc) - g.left;
#pragma unroll
        for (int k = 0; k < 4; ++k) word[b][k] = 0u;
#pragma unroll
        for (int py = 0; py < 2; ++py) {
#pragma unroll
          for (int px = 0; px < 2; ++px) {
            const int y = y0 + py, xx = x0 + px;
            const bool in = i < n_cells &&
                            static_cast<unsigned>(y) <
                                static_cast<unsigned>(g.H) &&
                            static_cast<unsigned>(xx) <
                                static_cast<unsigned>(g.W);
            const int8_t* src =
                xn + (static_cast<long long>(y) * g.W + xx) * C;
#pragma unroll
            for (int ch = 0; ch < C; ++ch) {
              const int byte = (2 * py + px) * C + ch;
              const uint32_t v =
                  in ? static_cast<uint8_t>(__ldg(src + ch)) : pad_byte;
              word[b][byte / 4] |= v << (8 * (byte % 4));
            }
          }
        }
      }
#pragma unroll
      for (int b = 0; b < CELL_BATCH; ++b) {
        const int i = first + b * THREADS;
        if (i < n_cells)
          st_shared16(c_base + i * CELL, word[b][0], word[b][1], word[b][2],
                      word[b][3]);
      }
    }
    // the cells (and, the first time, the weight) are read by wgmma
    fence_proxy_async();
    __syncthreads();

    const uint32_t w_tile = w_base + ct * W_TILE;
    const int last = 2 * rows;   // conv rows r0 .. r0 + last
    int acc[ACC];
    // this thread's staging slot: pooled column q, channel 16 warp + lane / 4
    int32_t* slot = stg + q * PITCH + 16 * warp + lane / 4;
    const bool left_in = j0 + q > 0;
    const int right_room = g.Wc - c0 - 2 - 2 * q;
    int run[HP];   // the running max over conv rows, column-pooled
    for (int rr = 0; rr <= last; ++rr) {
      // every conv row of the unit is multiplied, also one outside the map
      // (its cells are in shared memory all the same; it loses below): one
      // path for the wgmmas, which ptxas then leaves unserialized
      issue_row(acc, w_tile, c_base + rr * ROW_BYTES);
      wgmma_wait<0>();
      acc_fence(acc);
      if (r0 + rr >= 0 && r0 + rr < g.Hc) {
        if (rr == 0)
          pool_row<0>(acc, run, slot, q, from, left_in, right_room);
        else if (rr % 2)
          pool_row<1>(acc, run, slot, q, from, left_in, right_room);
        else
          pool_row<2>(acc, run, slot, q, from, left_in, right_room);
      } else if (rr == 0) {
        lose_row<0>(run, slot);
      } else if (rr % 2 == 0) {
        lose_row<2>(run, slot);
      }
      if (rr >= 2 && rr % 2 == 0) {
        // pooled row i0 + rr / 2 - 1, columns j0 .. j0 + cols - 1, channels
        // ct OT + [0, per_col 4): 16-byte stores
        __syncthreads();
        int32_t* orow =
            g.out +
            (static_cast<long long>(n * g.Hp + i0 + rr / 2 - 1) * g.Wp + j0) *
                g.O +
            ct * OT;
        for (int idx = t; idx < cols * per_col; idx += THREADS) {
          const int jj = static_cast<int>((static_cast<uint32_t>(idx) *
                                           per_col_inv) >> 16);
          const int o4 = idx - jj * per_col;
          *reinterpret_cast<int4*>(orow + static_cast<long long>(jj) * g.O +
                                   4 * o4) =
              *reinterpret_cast<const int4*>(stg + jj * PITCH + 4 * o4);
        }
        __syncthreads();
      }
    }
  }
}

template <int C>
int launch(const StemArgs& g, cudaStream_t s) {
  const auto kernel = int8_stem_pool_kernel<C>;
  const int smem = smem_bytes(g.band, g.o_tiles);
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

}  // namespace

extern "C" {

// out (n, hp, wp, o) int32 from x (n, h, wd, c) int8 and w (16, o, 16) int8
// (int8_stem_pool.py: pack_weight), or with w4 = 1 (16, o, 8) nibble pairs
// (pack_weight_int4): the 7x7/s2 conv with top/left pads and
// hc x wc outputs, `pad` outside the map, max-pooled 3x3/s2 with pads 1;
// hp = (hc - 1) / 2 + 1, likewise wp.  1 <= c <= 4, o % 16 == 0,
// o <= 128, 1 <= band <= 8 pooled rows a unit.  Launches on `stream`;
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// a geometry the kernel does not take.
int dlmcq_int8_stem_pool(const void* x, const void* w, void* out, int n,
                         int h, int wd, int c, int o, int top, int left,
                         int hc, int wc, int pad, int band, int w4,
                         void* stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 1 || c > 4 || o < 16 || o % 16 ||
      o > 2 * OT || hc < 1 || wc < 1 || band < 1 || band > MAX_BAND ||
      top < 0 || left < 0 || h > (INT_MAX - 64) / 2 ||
      wd > (INT_MAX - 2 * CELLS - 64) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  StemArgs g;
  g.x = static_cast<const int8_t*>(x);
  g.w = static_cast<const int8_t*>(w);
  g.out = static_cast<int32_t*>(out);
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
  g.bands = (g.Hp + band - 1) / band;
  g.col_bands = (g.Wp + POOL_COLS - 1) / POOL_COLS;
  g.o_tiles = (o + OT - 1) / OT;
  const long long units =
      static_cast<long long>(n) * g.bands * g.col_bands * g.o_tiles;
  if (units > INT_MAX || static_cast<long long>(n) * g.Hp > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  g.units = static_cast<int>(units);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return launch<1>(g, s);
    case 2: return launch<2>(g, s);
    case 3: return launch<3>(g, s);
    default: return launch<4>(g, s);
  }
}

const char* dlmcq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
