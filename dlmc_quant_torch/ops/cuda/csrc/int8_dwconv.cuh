// The int8 depthwise conv's shared pieces, for Hopper (sm_90a): the
// arguments, the halo staging, the byte transposes and __dp4a tap rows, the
// epilogue, the 3x3 kernel, the 1x1 kernel and the C entry point.  Two
// sources include it, each a library of its own with the same C interface:
//
//   int8_dwconv3x3.cu  the 3x3 window at C % 8 == 0 on 16-byte aligned
//                      codes (the aligned path: MobileNetV2, MobileOne, and
//                      GhostNet's and EfficientNet's 3x3 convs at C % 8 == 0)
//                      and the 1x1 window on that path
//   int8_dwconv5x5.cu  the wide build: the 5x5 window on either path and
//                      the 3x3 and 1x1 windows' ragged path (any C >= 1, or
//                      codes off 16-byte alignment)
//
// Replaces the XLA int8 conv of the JAX package's integer path at
// feature_group_count = C (dlmc_quant_tpu/quant/layers.py:722-728:
// jnp.pad of the codes with the pad code, then conv_general_dilated with
// preferred_element_type=int32); no Pallas kernel did this on the TPU, XLA
// lowered the grouped conv.  For input codes x (N, H, W, C) int8 and a
// weight w (K, K, 1, C), K = 1, 3 or 5, packed as (K*K, C) int8 (tap
// dy*K + dx, channels contiguous):
//
//   acc[n,p,q,c] = sum_{dy,dx} xpad[n, p*s - top + dy, q*s - left + dx, c]
//                              * w[dy*K + dx, c]                      (int32)
//   xpad = x, or the int8 code `pad` (real 0 on the input's grid, not 0)
//          outside the map; top = left = K/2, or K/2 - 1 for SAME at
//          stride 2 on an even map, and Ho = ceil(H / s), Wo = ceil(W / s)
//          (the wrapper's default), or any pads and output size the caller
//          gives (a conv whose padding is neither)
//   codes: out = clamp(rint(f32(acc)*a[c] + b[c]), lo, hi)    -> int8
//   f32:   out = f32(acc)*a[c] + b[c], then max(., 0) if relu -> f32
//   with a weight offset's term (an offset o_w on the weight grid, c the
//   per-channel oc[c] = s_x*o_w[c]) the product f32(acc)*a[c] becomes
//   f32(acc)*a[c] + f32(S)*oc[c], each rounded, before the rest, with
//   S[n,p,q,c] = sum_{dy,dx} xpad[...] - K*K*pad: the window's codes of the
//   channel less the pad code (a pad adds 0).  The kernel sums them next
//   to the products: one more signed __dp4a a tap row (two at 5x5),
//   against a word of ones where the weight word has its taps (TERM, an
//   instantiation of its own); at 1x1, S = x - pad.
//
// written with __fmul_rn, __fadd_rn (no fma contraction) and rounding half
// to even, as the int8 conv's and GEMM's epilogues (ops/cuda/epilogue.py is
// the plain version), so the kernel equals int8_dwconv3x3_plain bit for
// bit; the two conversions (acc to float, float to code) are exact float
// additions here (acc_to_float, store_row).  The ReLU of a boundary lives
// in lo and a ReLU6 in hi (quant/chain.py: fold_params).
//
// Bound on an H100: bytes.  A depthwise conv does 9 (25) multiply-adds an
// output value and has no reduction over channels, so wgmma does not
// apply: a block-diagonal product would do C times the work.  At batch 256
// MobileNetV2's 17 launches move 1.547 GB (x read once, codes written
// once), 0.46 ms at 3.35 TB/s, for 5.3 G multiply-adds; what serves here
// is shared memory, asynchronous copies and the CUDA cores' 4-way int8 dot
// product (dp4a), so that instructions stay under the bytes.
//
// Design.  A block owns one image, a tile of TH x TW outputs and a slice
// of CB channels: the whole pixel where it fits (a warp's stores then run
// on through the pixel: with C = 144, slices of 32 that straddle 32-byte
// sectors took twice as long), else 64, 48 or 32 (a tail slice masked in
// quads; C % 8 == 0).  It stages the tile's input halo, ((TH-1)s+K) x
// ((TW-1)s+K) pixels of CB bytes at a pitch of CB + 16 (a warp's words
// spread over the banks), in shared memory with cp.async in 16-byte
// granules (8 where C or CB % 16 != 0: a pixel may start on an 8-byte
// boundary); every cell outside the map, the bottom/right overhang
// included, gets the pad code.  The grid is what fits on the card at once,
// a multiple of the slice count, so a block keeps one slice and walks
// tiles (slice fastest, then column, row, image), staging the next tile's
// halo into the second buffer while it computes this one.  A thread owns
// 4 channels x R output columns of a row (R = 4 at stride 1, 2 at stride
// 2) and walks rpt rows down the tile.  From each halo row it reads
// (R-1)s+3 words (a word: the 4 channels of one pixel) and transposes them
// with __byte_perm into channel words (4 consecutive pixels of one
// channel); one signed __dp4a against the tap row's weight word
// (w0,w1,w2,0) or (0,w0,w1,w2) gives an output's three taps of that row.
// At stride 1 a channel word of pixels q-1..q+2 serves output q and q+1,
// and a halo row's words are kept for the three output rows that use it:
// ~6 LDS, 14 PRMT and 48 dp4a an output row of 16 values (144
// multiply-adds) against ~5 instructions a multiply-add for a byte
// extract and an IMAD.  The epilogue's two conversions are exact float
// additions on the full-rate pipes.  The weight words and a, b are loaded
// into registers once a block (load_weights), the index math once a tile.
// A weight of 4 bits or fewer comes nibble-packed, (9, C/2) bytes with
// channel 2j in the low nibble of byte j (ops/cuda/nibbles.py), and stays
// so in device memory; load_weights reads a 16-bit word for a thread's 4
// channels a tap, sign-extends the nibbles bytewise and interleaves them
// into the same tap words as an int8 weight gives, so nothing after it
// changes.
//
// The ragged path (RAGGED, the wide build) changes only the halo's layout
// and staging, the weight loads and the stores: int8_dwconv5x5.cu's header
// says how.  The tile plan (CB, column groups, row groups, rows a thread)
// comes from the wrapper (ops/cuda/int8_dwconv.py: plan, a model of the
// work and of the last tile's latency), which the CPU tests emulate word
// for word (tests/test_torch_dwconv_tiles.py).  On an H100 at batch 256 the
// 17 and 21 launches of MobileNetV2 and MobileOne-S1 run at 1.8-2.0x their
// bound: the stride-1 layers near 2x, the stride-2 ones 1.35-2.0x, 7x7
// maps 2.4x.
//
// The 1x1 window (int8_dwconv1x1_kernel: MobileOne's scale branch, a
// depthwise 1x1 at the block's stride, VALID) is a strided per-channel
// product, acc = x[n, p*s - top, q*s - left, c] * w[c], then the same
// epilogue.  It does one multiply-add an output value, so it is bound by
// its bytes far below the tensor cores' or dp4a's rate: no halo, no tiles
// and no transposes.  A thread owns a granule of G channels, loads their
// weights, a, b and oc into registers once, and walks output pixels: one
// G-byte load of the subsampled pixel's channels (only the pixels an
// output reads), G products and epilogues, and one store of G codes or of
// G/4 float4s (channel by channel at G = 1).  Codes take G = 16 where C %
// 16 == 0 on the aligned path, 8 elsewhere on it, and 4 or 1 on the
// ragged path; f32 takes G = 4 wherever C % 4 == 0 (the wrapper routes it
// so), so that a warp's float4 stores run on through memory, where at G =
// 16 each of a thread's four float4 stores would meet every other 16
// bytes of a warp's span.  The pixel's (image, row, column) by multiplies
// and shifts, not divisions.  On an H100 80GB HBM3 at 700 W MobileOne-S1's
// 21 scale branches at batch 256 (f32) take 1.37 ms against a 0.99 ms
// bound, 2.33 ms at granules of 16 with divisions.  A block
// is a slice of cb/G granules (the whole pixel up to 256 threads) times
// `lanes` pixels (cg in the plan), so that a warp's loads and stores run
// over whole pixels; the grid is what fits on the card, walking pixels.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma_s8.cuh"   // sext_nibbles: the W4 weights' sign extension

namespace {

constexpr int MAX_THREADS = 256;
constexpr int PITCH_PAD = 16;        // bytes after a pixel's slice in smem
constexpr int MAX_SMEM = 232448;     // dynamic shared memory a block may use
constexpr int MAX_DEVICES = 64;
constexpr int MAX_SHIFT = 12;        // a row run's offset in its 16 bytes
constexpr int STAGED_C = 64;         // runs' outputs staged below this C

struct DwArgs {
  const int8_t* x;
  const int8_t* w;       // (9, C) int8, or (9, C/2) nibble pairs if w4
  const float* a;
  const float* b;
  const float* oc;       // the offset term's (C,) coefficient, if TERM
  void* out;             // (N, Ho, Wo, C): int8 codes or f32
  int N, H, W, C, Ho, Wo, stride, pad_top, pad_left, relu, w4;
  float flo, fhi;        // the codes' clamp, lo and hi
  int pad;               // the pad code
  int pad_sum;           // K*K * the pad code: a window's pads, if TERM
  uint32_t pad4;         // the pad code in every byte
  // the plan: channel slice and its quads, column groups, rows a thread;
  // tile, halo and smem pitch; tiles of the walk
  int cb, cq, cg, rpt;
  int th, tw, hh, hw, pitch, granule, buf_bytes;
  int slices, tiles_x, tiles_y, tiles;
  // the ragged path's halo: row runs (whole pixels at granule 4, packed at
  // a pitch of C), the bytes between two halo rows, and the 16-byte chunks
  // a row touches; the outputs' staging (runs at C < STAGED_C): row
  // groups, the bytes of a row group's output row (0: no staging), where
  // the staging starts in shared memory
  int runs, row_pitch, chunks;
  int rg, stage_row, stage_at;
  // the 1x1 window's divisions by Wo and Ho: n / d = (n * mul) >> shift
  uint32_t wo_mul, ho_mul;
  int wo_shift, ho_shift;
};

// n / d for 0 <= n < 2^31 by a multiply and a shift (mul and shift from
// set_div): the 1x1 window's pixel index to (image, row, column)
__device__ __forceinline__ int div_by(int n, uint32_t mul, int shift) {
  return static_cast<int>(
      (static_cast<uint64_t>(static_cast<uint32_t>(n)) * mul) >> shift);
}

inline void set_div(int d, uint32_t& mul, int& shift) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  shift = 31 + l;
  mul = static_cast<uint32_t>((1ULL << shift) / static_cast<uint64_t>(d) +
                              1);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int granule) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (granule == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// the ragged path's staging of one cell: a 4-byte cp.async (C % 4 == 0 on
// 4-byte aligned codes) or a byte, the pad code where src is null
__device__ __forceinline__ void stage_ragged(unsigned char* dst,
                                             const int8_t* src,
                                             const DwArgs& g) {
  if (g.granule == 4) {
    if (src != nullptr)
      cp_async4(dst, src);
    else
      *reinterpret_cast<uint32_t*>(dst) = g.pad4;
  } else {
    *dst = src != nullptr ? static_cast<unsigned char>(*src)
                          : static_cast<unsigned char>(g.pad4);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// tile t -> (image, tile row, tile column); the slice is t % slices
struct Tile {
  int n, oy0, ox0;
};

__device__ __forceinline__ Tile tile_of(const DwArgs& g, int t) {
  int rest = t / g.slices;
  const int tx = rest % g.tiles_x;
  rest /= g.tiles_x;
  const int ty = rest % g.tiles_y;
  return Tile{rest / g.tiles_y, ty * g.th, tx * g.tw};
}

// Stage tile t's halo in buf: a thread takes a column of granules and
// every `ways`-th row of it (ways = the threads a column gets); cp.async
// inside the map, the pad code outside it and past C.  RAGGED stages
// granules of 4 bytes or 1 (stage_ragged).
template <int S, bool RAGGED = false>
__device__ void stage_halo(const DwArgs& g, int t, unsigned char* buf) {
  const Tile tl = tile_of(g, t);
  const int c0 = (t % g.slices) * g.cb;
  const int iy0 = tl.oy0 * S - g.pad_top;
  const int ix0 = tl.ox0 * S - g.pad_left;
  const int gpp = g.cb / g.granule;      // granules a pixel
  const int cols = g.hw * gpp;
  const long long row_bytes = static_cast<long long>(g.W) * g.C;
  const int8_t* image = g.x + static_cast<long long>(tl.n) * g.H * row_bytes;
  int ways = blockDim.x / cols, col = threadIdx.x, col_step = blockDim.x;
  int hr0 = 0;
  if (ways > 1) {
    hr0 = threadIdx.x / cols;
    col = hr0 < ways ? threadIdx.x - hr0 * cols : cols;
    col_step = cols;
  } else {
    ways = 1;
  }
  const int step = ways * g.hw * g.pitch;
  for (; col < cols; col += col_step) {
    const int hc = col / gpp;
    const int c = c0 + (col - hc * gpp) * g.granule;
    const int ix = ix0 + hc;
    // C % granule == 0, so a granule lies wholly inside or past C
    const bool col_in = ix >= 0 && ix < g.W && c < g.C;
    unsigned char* dst = buf + (hr0 * g.hw + hc) * g.pitch + (c - c0);
    for (int hr = hr0; hr < g.hh; hr += ways, dst += step) {
      const int iy = iy0 + hr;
      if constexpr (RAGGED) {
        stage_ragged(dst,
                     col_in && iy >= 0 && iy < g.H
                         ? image + iy * row_bytes +
                               static_cast<long long>(ix) * g.C + c
                         : nullptr,
                     g);
      } else if (col_in && iy >= 0 && iy < g.H) {
        cp_async(dst, image + iy * row_bytes + static_cast<long long>(ix) *
                                  g.C + c, g.granule);
      } else if (g.granule == 16) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(g.pad4, g.pad4, g.pad4, g.pad4);
      } else {
        *reinterpret_cast<uint2*>(dst) = make_uint2(g.pad4, g.pad4);
      }
    }
  }
}

// A row run's place in shared memory (the ragged path's runs layout):
// halo pixel (hr, hc) of tile t starts at byte shift + hr*row_pitch +
// hc*C of its buffer.  row_pitch = W*C (mod 16) and the shift is the
// address of the tile's pixel (iy0, ix0) mod 16, so every byte of a halo
// row lies in shared memory at its device address mod 16: a 16-byte
// cp.async copies each aligned 16 bytes of a run.  0 off the runs layout.
template <int S>
__device__ __forceinline__ int run_shift(const DwArgs& g, const Tile& tl) {
  if (!g.runs) return 0;
  // mod 2^32 throughout: only the low 4 bits count
  const unsigned pixel =
      (static_cast<unsigned>(tl.n) * g.H + tl.oy0 * S - g.pad_top) * g.W +
      tl.ox0 * S - g.pad_left;
  return static_cast<int>(
      (static_cast<unsigned>(reinterpret_cast<uintptr_t>(g.x)) +
       pixel * static_cast<unsigned>(g.C)) & 15u);
}

// Stage tile t's halo row by row on the runs layout (run_shift): a halo
// row's pixels inside the map are one run of bytes in device memory.  A
// thread takes one 16-byte chunk of shared memory of every `ways`-th row:
// a chunk wholly inside the run is one 16-byte cp.async; a chunk at an end
// goes word by word, a 4-byte cp.async for the run's head and tail words
// and the pad code for the cells left and right of the map (and every
// cell of a row outside it); words outside the row are another row's.
template <int S>
__device__ void stage_runs(const DwArgs& g, int t, unsigned char* buf) {
  const Tile tl = tile_of(g, t);
  const int iy0 = tl.oy0 * S - g.pad_top;
  const int ix0 = tl.ox0 * S - g.pad_left;
  const long long row_bytes = static_cast<long long>(g.W) * g.C;
  const int8_t* image = g.x + static_cast<long long>(tl.n) * g.H * row_bytes;
  const int span = g.hw * g.C;                       // a halo row's bytes
  const int run0 = max(0, -ix0) * g.C;               // the run: [run0,
  const int run1 = min(g.hw, g.W - ix0) * g.C;       //  run1) of the row
  const int shift = run_shift<S>(g, tl);
  int ways = blockDim.x / g.chunks, col = threadIdx.x, col_step = blockDim.x;
  int hr0 = 0;
  if (ways > 1) {
    hr0 = threadIdx.x / g.chunks;
    col = hr0 < ways ? threadIdx.x - hr0 * g.chunks : g.chunks;
    col_step = g.chunks;
  } else {
    ways = 1;
  }
  for (; col < g.chunks; col += col_step) {
    for (int hr = hr0; hr < g.hh; hr += ways) {
      const int row0 = shift + hr * g.row_pitch;     // pixel 0 of the row
      const int lo = ((row0 >> 4) + col) * 16 - row0;  // the chunk: [lo,
      if (lo >= span) continue;                         //  lo + 16)
      const int iy = iy0 + hr;
      const bool row_in = iy >= 0 && iy < g.H;
      // the row's byte o lies at image + from + o in device memory
      const long long from = iy * row_bytes + static_cast<long long>(ix0) *
                                                  g.C;
      unsigned char* dst = buf + row0 + lo;
      if (row_in && lo >= run0 && lo + 16 <= run1) {
        cp_async(dst, image + from + lo, 16);
        continue;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = lo + 4 * i;
        if (o < 0 || o >= span) continue;
        if (row_in && o >= run0 && o < run1)
          cp_async4(dst + 4 * i, image + from + o);
        else
          *reinterpret_cast<uint32_t*>(dst + 4 * i) = g.pad4;
      }
    }
  }
}

// The ragged path's halo: row runs where the plan gave them, else cells at
// the pitch CB + 16 in granules of 4 bytes or 1
template <int S>
__device__ __forceinline__ void stage_wide(const DwArgs& g, int t,
                                           unsigned char* buf) {
  if (g.runs)
    stage_runs<S>(g, t, buf);
  else
    stage_halo<S, true>(g, t, buf);
}

// 4 words of 4 bytes (p[i] byte j) -> t[j] byte i = p[i] byte j
__device__ __forceinline__ void transpose4(uint32_t p0, uint32_t p1,
                                           uint32_t p2, uint32_t p3,
                                           uint32_t (&t)[4]) {
  const uint32_t x0 = __byte_perm(p0, p1, 0x5140);   // p0.0 p1.0 p0.1 p1.1
  const uint32_t x1 = __byte_perm(p0, p1, 0x7362);   // p0.2 p1.2 p0.3 p1.3
  const uint32_t y0 = __byte_perm(p2, p3, 0x5140);
  const uint32_t y1 = __byte_perm(p2, p3, 0x7362);
  t[0] = __byte_perm(x0, y0, 0x5410);
  t[1] = __byte_perm(x0, y0, 0x7632);
  t[2] = __byte_perm(x1, y1, 0x5410);
  t[3] = __byte_perm(x1, y1, 0x7632);
}

// 4 channels' int8 weights from their 2 nibble-packed bytes (channel 2j
// in the low nibble of byte j): the word an int8 weight gives.
__device__ __forceinline__ uint32_t unpack_pair(uint32_t u) {
  const uint32_t lo = dlmcq::sext_nibbles(u & 0x0F0Fu);   // channels 0, 2
  const uint32_t hi = dlmcq::sext_nibbles((u >> 4) & 0x0F0Fu);  // 1, 3
  return __byte_perm(lo, hi, 0x5140);
}

// The word of channels c..c+3 at one tap (byte j: channel c + j).  The one
// place the kernel reads the weight: a 32-bit word, or at W4 a 16-bit word
// of nibbles (C % 8 == 0 keeps it aligned), unpacked.  RAGGED reads byte
// by byte, 0 past C; at W4 a tap's row is (C + 1) / 2 bytes.
template <bool RAGGED>
__device__ __forceinline__ uint32_t tap_word(const DwArgs& g, int tap,
                                             int c) {
  if constexpr (RAGGED) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = c + j;
      if (ch < g.C) {
        int v;
        if (g.w4) {
          const int u = __ldg(reinterpret_cast<const uint8_t*>(g.w) +
                              tap * ((g.C + 1) / 2) + ch / 2);
          v = (((u >> (4 * (ch & 1))) & 0xF) ^ 8) - 8;
        } else {
          v = __ldg(g.w + tap * g.C + ch);
        }
        word |= static_cast<uint32_t>(v & 0xFF) << (8 * j);
      }
    }
    return word;
  } else {
    const int at = tap * g.C + c;
    return g.w4 ? unpack_pair(__ldg(
                      reinterpret_cast<const uint16_t*>(g.w) + at / 4))
                : __ldg(reinterpret_cast<const uint32_t*>(g.w + at));
  }
}

// a, b (and the offset term's oc) of channels c..c+3, 0 past C
template <bool TERM, bool RAGGED>
__device__ __forceinline__ void load_affine(const DwArgs& g, int c,
                                            bool c_in, float (&ea)[4],
                                            float (&eb)[4], float (&ec)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = RAGGED ? c + j < g.C : c_in;
    ea[j] = in ? __ldg(g.a + c + j) : 0.0f;
    eb[j] = in ? __ldg(g.b + c + j) : 0.0f;
    ec[j] = TERM && in ? __ldg(g.oc + c + j) : 0.0f;
  }
}

// The weight words of channels c..c+3 for each tap row dy: byte i of
// wa[dy][j] is w[3 dy + i, c + j] for i < 3, byte 3 is 0; and a, b.
template <bool TERM, bool RAGGED>
__device__ __forceinline__ void load_weights(const DwArgs& g, int c,
                                             bool c_in,
                                             uint32_t (&wa)[3][4],
                                             float (&ea)[4], float (&eb)[4],
                                             float (&ec)[4]) {
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    uint32_t tap[3] = {0, 0, 0};
    if (c_in) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        tap[dx] = tap_word<RAGGED>(g, 3 * dy + dx, c);
    }
    transpose4(tap[0], tap[1], tap[2], 0u, wa[dy]);
  }
  load_affine<TERM, RAGGED>(g, c, c_in, ea, eb, ec);
}

// The channel words of one halo row for a thread's R outputs.  Stride 1
// (words p0..p5 = halo columns h..h+5): cw[j] = pixels h..h+3 of channel
// j, cw[4 + j] = pixels h+2..h+5.  Stride 2 (p0..p4 = columns h..h+4):
// cw[j] = pixels h..h+3, cw[4 + j] = pixels h+2, h+3, h+4 and a byte that
// meets a zero weight byte.
template <int S>
__device__ __forceinline__ void row_words(const unsigned char* q, int pitch,
                                          uint32_t (&cw)[8]) {
  constexpr int WORDS = S == 1 ? 6 : 5;
  uint32_t p[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k)
    p[k] = *reinterpret_cast<const uint32_t*>(q + k * pitch);
  uint32_t lo[4];
  transpose4(p[0], p[1], p[2], p[3], lo);
#pragma unroll
  for (int j = 0; j < 4; ++j) cw[j] = lo[j];
  if constexpr (S == 1) {
    const uint32_t y0 = __byte_perm(p[2], p[3], 0x5140);
    const uint32_t y1 = __byte_perm(p[2], p[3], 0x7362);
    const uint32_t z0 = __byte_perm(p[4], p[5], 0x5140);
    const uint32_t z1 = __byte_perm(p[4], p[5], 0x7362);
    cw[4] = __byte_perm(y0, z0, 0x5410);
    cw[5] = __byte_perm(y0, z0, 0x7632);
    cw[6] = __byte_perm(y1, z1, 0x5410);
    cw[7] = __byte_perm(y1, z1, 0x7632);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cw[4 + j] = __byte_perm(lo[j], p[4], 0x32 | (4 + j) << 8 |
                                               (4 + j) << 12);
  }
}

// acc[j][k] += the tap row's three products for output k of channel j
template <int S, int R>
__device__ __forceinline__ void mac_row(int (&acc)[4][R],
                                        const uint32_t (&cw)[8],
                                        const uint32_t (&wa)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int w0 = static_cast<int>(wa[j]);
    if constexpr (S == 1) {
      const int w1 = static_cast<int>(wa[j] << 8);
      acc[j][0] = __dp4a(static_cast<int>(cw[j]), w0, acc[j][0]);
      acc[j][1] = __dp4a(static_cast<int>(cw[j]), w1, acc[j][1]);
      acc[j][2] = __dp4a(static_cast<int>(cw[4 + j]), w0, acc[j][2]);
      acc[j][3] = __dp4a(static_cast<int>(cw[4 + j]), w1, acc[j][3]);
    } else {
      acc[j][0] = __dp4a(static_cast<int>(cw[j]), w0, acc[j][0]);
      acc[j][1] = __dp4a(static_cast<int>(cw[4 + j]), w0, acc[j][1]);
    }
  }
}

// sums[j][k] += the tap row's three codes for output k of channel j: the
// products of mac_row against a weight word of ones where its three taps
// are (bytes 0-2, or 1-3 for the second output at stride 1)
template <int S, int R>
__device__ __forceinline__ void sum_row(int (&sums)[4][R],
                                        const uint32_t (&cw)[8]) {
  constexpr int ONES0 = 0x00010101, ONES1 = 0x01010100;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (S == 1) {
      sums[j][0] = __dp4a(static_cast<int>(cw[j]), ONES0, sums[j][0]);
      sums[j][1] = __dp4a(static_cast<int>(cw[j]), ONES1, sums[j][1]);
      sums[j][2] = __dp4a(static_cast<int>(cw[4 + j]), ONES0, sums[j][2]);
      sums[j][3] = __dp4a(static_cast<int>(cw[4 + j]), ONES1, sums[j][3]);
    } else {
      sums[j][0] = __dp4a(static_cast<int>(cw[j]), ONES0, sums[j][0]);
      sums[j][1] = __dp4a(static_cast<int>(cw[4 + j]), ONES0, sums[j][1]);
    }
  }
}

// 1.5 * 2^23: in [2^23, 2^24) a float's last bit is worth 1, so an int
// below 2^22 in magnitude added to these bits is that float plus the int
constexpr float MAGIC = 12582912.0f;
constexpr int MAGIC_BITS = 0x4B400000;

// f32(acc), exact (|acc| <= 25 * 128 * 128 < 2^22) as __int2float_rn, on
// the integer and float pipes instead of the conversion pipe (16 a clock
// an SM)
__device__ __forceinline__ float acc_to_float(int acc) {
  return __fsub_rn(__int_as_float(MAGIC_BITS + acc), MAGIC);
}

// the epilogue's values of output k's 4 channels, before the codes' clamp
// or the ReLU
template <bool TERM, int R>
__device__ __forceinline__ void epilogue(const DwArgs& g,
                                         const int (&acc)[4][R],
                                         const int (&sums)[4][R],
                                         const float (&ea)[4],
                                         const float (&eb)[4],
                                         const float (&ec)[4], int k,
                                         float (&y)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float prod = __fmul_rn(acc_to_float(acc[j][k]), ea[j]);
    if constexpr (TERM)
      prod = __fadd_rn(
          prod, __fmul_rn(acc_to_float(sums[j][k] - g.pad_sum), ec[j]));
    y[j] = __fadd_rn(prod, eb[j]);
  }
}

// clamp(rint(y), lo, hi) as __float2int_rn and a clamp give it: the clamp
// to the integers lo, hi commutes with rint, and adding MAGIC rounds half
// to even to an integer whose low byte is the code
__device__ __forceinline__ uint32_t code_bits(const DwArgs& g, float y) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(y, g.flo), g.fhi), MAGIC));
}

// the epilogue of one output row's R x 4 values, stored where inside the
// map (and the thread's channels inside C).  A thread's 4 channels go out
// as one 4-byte word of codes or one float4, as on the aligned path; on
// the ragged path where C % 4 == 0 as well (each quad then lies wholly
// inside C and 16-byte aligned in f32, 4-byte in codes), else channel by
// channel, the first nc of the 4.
template <bool CODES, bool TERM, int R, bool RAGGED = false>
__device__ __forceinline__ void store_row(const DwArgs& g,
                                          const int (&acc)[4][R],
                                          const int (&sums)[4][R],
                                          const float (&ea)[4],
                                          const float (&eb)[4],
                                          const float (&ec)[4],
                                          long long at, int ox, int nc = 4) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (ox + k >= g.Wo) break;
    float y[4];
    epilogue<TERM, R>(g, acc, sums, ea, eb, ec, k, y);
    const long long o = at + static_cast<long long>(k) * g.C;
    if (RAGGED && (g.C & 3)) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nc) break;
        if constexpr (CODES)
          static_cast<int8_t*>(g.out)[o + j] =
              static_cast<int8_t>(code_bits(g, y[j]) & 0xFF);
        else
          static_cast<float*>(g.out)[o + j] =
              g.relu ? fmaxf(y[j], 0.0f) : y[j];
      }
    } else if constexpr (CODES) {
      uint32_t code[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) code[j] = code_bits(g, y[j]);
      const uint32_t lo = __byte_perm(code[0], code[1], 0x0040);
      const uint32_t hi = __byte_perm(code[2], code[3], 0x0040);
      *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(g.out) + o) =
          __byte_perm(lo, hi, 0x5410);
    } else {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = g.relu ? fmaxf(y[j], 0.0f) : y[j];
      *reinterpret_cast<float4*>(static_cast<float*>(g.out) + o) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The staged stores (the runs layout at C < STAGED_C): output row i of
// every row group of the block,
// staged in shared memory (stage: a buffer of rg rows of stage_row bytes,
// the tile's columns and the whole pixel, as in device memory) and copied
// out in units of 16 bytes (f32) or 4 (codes), consecutive lanes on
// consecutive units.  At C = 12 a thread's stores land 4 pixels (192 bytes
// of f32) apart, so that a warp's store of 512 bytes touched 8-16 lines of
// 128 bytes; the copy's touches 4-5.  One barrier an output row: the
// caller alternates two buffers.
template <bool CODES, bool TERM, int R>
__device__ __forceinline__ void store_row_staged(
    const DwArgs& g, const int (&acc)[4][R], const int (&sums)[4][R],
    const float (&ea)[4], const float (&eb)[4], const float (&ec)[4],
    unsigned char* stage, int col, int c, int grp, const Tile& tl, int i) {
  constexpr int SIZE = CODES ? 1 : 4;     // bytes of an output value
  constexpr int UNIT = CODES ? 4 : 16;    // bytes a lane copies
  unsigned char* row = stage + grp * g.stage_row;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    float y[4];
    epilogue<TERM, R>(g, acc, sums, ea, eb, ec, k, y);
    unsigned char* dst = row + ((col + k) * g.C + c) * SIZE;
    if constexpr (CODES) {
      const uint32_t lo = __byte_perm(code_bits(g, y[0]), code_bits(g, y[1]),
                                      0x0040);
      const uint32_t hi = __byte_perm(code_bits(g, y[2]), code_bits(g, y[3]),
                                      0x0040);
      *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo, hi, 0x5410);
    } else {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = g.relu ? fmaxf(y[u], 0.0f) : y[u];
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();
  // a row's units inside the map: C % 4 == 0, so whole units
  const int units = min(g.tw, g.Wo - tl.ox0) * g.C * SIZE / UNIT;
  for (int u = threadIdx.x; u < g.rg * units; u += blockDim.x) {
    const int r = u / units, v = u - r * units;
    const int oy = tl.oy0 + r * g.rpt + i;
    if (oy >= g.Ho) continue;
    unsigned char* out = static_cast<unsigned char*>(g.out) +
        ((static_cast<long long>(tl.n) * g.Ho + oy) * g.Wo + tl.ox0) *
            g.C * SIZE + v * UNIT;
    const unsigned char* src = stage + r * g.stage_row + v * UNIT;
    if constexpr (CODES)
      *reinterpret_cast<uint32_t*>(out) =
          *reinterpret_cast<const uint32_t*>(src);
    else
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
  }
}

// Output row i's stores: staged where the plan gave the staging (both
// buffers in turns; the ragged path's runs layout at C < STAGED_C), else
// store_row where the thread's outputs are inside the map (in)
template <bool CODES, bool TERM, int R, bool RAGGED>
__device__ __forceinline__ void put_row(
    const DwArgs& g, const int (&acc)[4][R], const int (&sums)[4][R],
    const float (&ea)[4], const float (&eb)[4], const float (&ec)[4],
    unsigned char* smem, int j, int c, int r0, const Tile& tl, int i,
    bool in, long long at, int ox) {
  if constexpr (RAGGED) {
    if (g.stage_row) {
      store_row_staged<CODES, TERM, R>(
          g, acc, sums, ea, eb, ec,
          smem + g.stage_at + (i & 1) * g.rg * g.stage_row, R * j, c,
          r0 / g.rpt, tl, i);
      return;
    }
  }
  if (in)
    store_row<CODES, TERM, R, RAGGED>(g, acc, sums, ea, eb, ec, at, ox,
                                      g.C - c);
}

// The 3x3 window.  RAGGED (the wide build) stages with stage_wide and reads
// its halo rows row_pitch apart from the tile's run_shift; the aligned path
// rows hw * pitch apart from the buffer's start.
template <int S, bool CODES, bool TERM, bool RAGGED>
__global__ void __launch_bounds__(MAX_THREADS)
int8_dwconv3x3_kernel(const DwArgs g) {
  constexpr int R = S == 1 ? 4 : 2;      // output columns of a thread
  extern __shared__ __align__(16) unsigned char smem[];
  // the thread: channel quad (fastest), column group, row group
  const int cq = threadIdx.x % g.cq;
  const int j = threadIdx.x / g.cq % g.cg;
  const int r0 = threadIdx.x / (g.cq * g.cg) * g.rpt;
  // gridDim.x is a multiple of the slice count: one slice a block
  const int c = blockIdx.x % g.slices * g.cb + 4 * cq;
  const bool c_in = c < g.C;
  uint32_t wa[3][4];
  float ea[4], eb[4], ec[4];
  load_weights<TERM, RAGGED>(g, c, c_in, wa, ea, eb, ec);

  const int row_step = RAGGED ? g.row_pitch : g.hw * g.pitch;  // halo rows
  const int col0 = R * S * j;                 // the thread's first column
  int buf = 0;
  if constexpr (RAGGED)
    stage_wide<S>(g, blockIdx.x, smem);
  else
    stage_halo<S>(g, blockIdx.x, smem);
  cp_async_commit();
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    if (t + gridDim.x < g.tiles) {
      if constexpr (RAGGED)
        stage_wide<S>(g, t + gridDim.x, smem + (buf ^ 1) * g.buf_bytes);
      else
        stage_halo<S>(g, t + gridDim.x, smem + (buf ^ 1) * g.buf_bytes);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const Tile tl = tile_of(g, t);
    const unsigned char* q =
        smem + buf * g.buf_bytes + col0 * g.pitch + 4 * cq;
    if constexpr (RAGGED) q += run_shift<S>(g, tl);
    const int ox = tl.ox0 + R * j;
    const bool col_in = c_in && ox < g.Wo;
    long long at = ((static_cast<long long>(tl.n) * g.Ho + tl.oy0 + r0) *
                        g.Wo + ox) * g.C + c;
    const long long out_row = static_cast<long long>(g.Wo) * g.C;
    int oy = tl.oy0 + r0;
    uint32_t cw[3][8];
    row_words<S>(q + r0 * S * row_step, g.pitch, cw[0]);
    if constexpr (S == 1)
      row_words<S>(q + (r0 + 1) * row_step, g.pitch, cw[1]);
    for (int i = 0; i < g.rpt; ++i, ++oy, at += out_row) {
      const unsigned char* hr = q + ((r0 + i) * S + 2) * row_step;
      int acc[4][R], sums[4][R];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < R; ++k) acc[u][k] = sums[u][k] = 0;
      if constexpr (S == 1) {
        row_words<S>(hr, g.pitch, cw[2]);
        mac_row<S, R>(acc, cw[0], wa[0]);
        mac_row<S, R>(acc, cw[1], wa[1]);
        mac_row<S, R>(acc, cw[2], wa[2]);
        if constexpr (TERM) {
          sum_row<S, R>(sums, cw[0]);
          sum_row<S, R>(sums, cw[1]);
          sum_row<S, R>(sums, cw[2]);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          cw[0][u] = cw[1][u];
          cw[1][u] = cw[2][u];
        }
      } else {
        mac_row<S, R>(acc, cw[0], wa[0]);
        if constexpr (TERM) sum_row<S, R>(sums, cw[0]);
        row_words<S>(hr - row_step, g.pitch, cw[1]);
        mac_row<S, R>(acc, cw[1], wa[1]);
        if constexpr (TERM) sum_row<S, R>(sums, cw[1]);
        row_words<S>(hr, g.pitch, cw[0]);
        mac_row<S, R>(acc, cw[0], wa[2]);
        if constexpr (TERM) sum_row<S, R>(sums, cw[0]);
      }
      put_row<CODES, TERM, R, RAGGED>(g, acc, sums, ea, eb, ec, smem, j,
                                      c, r0, tl, i, col_in && oy < g.Ho, at,
                                      ox);
    }
    __syncthreads();
    buf ^= 1;
  }
}

// The 1x1 window's weight of channel ch: int8, or its nibble at W4
__device__ __forceinline__ int weight_1x1(const DwArgs& g, int ch) {
  if (g.w4) {
    const int u = __ldg(reinterpret_cast<const uint8_t*>(g.w) + ch / 2);
    return (((u >> (4 * (ch & 1))) & 0xF) ^ 8) - 8;
  }
  return __ldg(g.w + ch);
}

// The 1x1 window (see the header): a thread owns the G channels from c
// and walks output pixels m = lane, lane + lanes * grid, ...; a block is
// cq granules (fastest) times cg pixel lanes, gridDim.y the slices of C.
template <int G, bool CODES, bool TERM>
__global__ void __launch_bounds__(MAX_THREADS)
int8_dwconv1x1_kernel(const DwArgs g) {
  constexpr int WORDS = (G + 3) / 4;
  const int lane = threadIdx.x / g.cq;
  const int c = (blockIdx.y * g.cq + threadIdx.x % g.cq) * G;
  if (lane >= g.cg || c >= g.C) return;   // no barrier below
  int wv[G];
  float ea[G], eb[G], ec[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    wv[j] = weight_1x1(g, c + j);
    ea[j] = __ldg(g.a + c + j);
    eb[j] = __ldg(g.b + c + j);
    ec[j] = TERM ? __ldg(g.oc + c + j) : 0.0f;
  }
  const int pixels = g.N * g.Ho * g.Wo;   // below 2^31 (the wrapper checks)
  for (int m = blockIdx.x * g.cg + lane; m < pixels;
       m += gridDim.x * g.cg) {
    const int rest = div_by(m, g.wo_mul, g.wo_shift);
    const int q = m - rest * g.Wo;
    const int n = div_by(rest, g.ho_mul, g.ho_shift);
    const int p = rest - n * g.Ho;
    const int iy = p * g.stride - g.pad_top;
    const int ix = q * g.stride - g.pad_left;
    uint32_t v[WORDS];
    if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
      const int8_t* src =
          g.x + (static_cast<long long>(n * g.H + iy) * g.W + ix) * g.C + c;
      if constexpr (G == 16) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
        v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
      } else if constexpr (G == 8) {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
        v[0] = u.x; v[1] = u.y;
      } else if constexpr (G == 4) {
        v[0] = __ldg(reinterpret_cast<const uint32_t*>(src));
      } else {
        v[0] = static_cast<uint8_t>(__ldg(src));
      }
    } else {
#pragma unroll
      for (int i = 0; i < WORDS; ++i) v[i] = g.pad4;
    }
    float y[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int xv = static_cast<int>(
          static_cast<int8_t>((v[j / 4] >> (8 * (j % 4))) & 0xFFu));
      float prod = __fmul_rn(acc_to_float(xv * wv[j]), ea[j]);
      if constexpr (TERM)
        prod = __fadd_rn(prod, __fmul_rn(acc_to_float(xv - g.pad), ec[j]));
      y[j] = __fadd_rn(prod, eb[j]);
    }
    const long long at = static_cast<long long>(m) * g.C + c;
    if constexpr (CODES) {
      uint32_t w[WORDS];
#pragma unroll
      for (int i = 0; i < WORDS; ++i) {
        if constexpr (G == 1) {
          w[i] = code_bits(g, y[0]) & 0xFFu;
        } else {
          const uint32_t lo = __byte_perm(code_bits(g, y[4 * i]),
                                          code_bits(g, y[4 * i + 1]), 0x0040);
          const uint32_t hi = __byte_perm(code_bits(g, y[4 * i + 2]),
                                          code_bits(g, y[4 * i + 3]), 0x0040);
          w[i] = __byte_perm(lo, hi, 0x5410);
        }
      }
      int8_t* dst = static_cast<int8_t*>(g.out) + at;
      if constexpr (G == 16)
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      else if constexpr (G == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
      else if constexpr (G == 4)
        *reinterpret_cast<uint32_t*>(dst) = w[0];
      else
        *dst = static_cast<int8_t>(w[0]);
    } else {
      float* dst = static_cast<float*>(g.out) + at;
#pragma unroll
      for (int j = 0; j < G; ++j) y[j] = g.relu ? fmaxf(y[j], 0.0f) : y[j];
      if constexpr (G == 1) {
        *dst = y[0];
      } else {
#pragma unroll
        for (int i = 0; i < G / 4; ++i)
          reinterpret_cast<float4*>(dst)[i] =
              make_float4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]);
      }
    }
  }
}

// The 5x5 window's kernel (int8_dwconv5x5.cu defines it; the aligned
// build instantiates none)
template <int S, bool CODES, bool TERM, bool RAGGED>
__global__ void __launch_bounds__(MAX_THREADS)
int8_dwconv5x5_kernel(const DwArgs g);

// launch one instantiation: the grid is what fits on the card at once,
// whole multiples of the slice count
template <int K, int S, bool CODES, bool TERM, bool RAGGED>
cudaError_t launch(const DwArgs& g, int threads, int smem,
                   cudaStream_t stream) {
  void (*kernel)(const DwArgs);
  if constexpr (K == 3)
    kernel = int8_dwconv3x3_kernel<S, CODES, TERM, RAGGED>;
  else
    kernel = int8_dwconv5x5_kernel<S, CODES, TERM, RAGGED>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  // above 48 KB a kernel needs the attribute, once per device
  static bool raised[MAX_DEVICES];
  if (smem > 48 * 1024 && device < MAX_DEVICES && !raised[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long grid = static_cast<long long>(per_sm) * sms;
  if (grid > g.tiles) grid = g.tiles;
  grid = grid / g.slices * g.slices;
  if (grid < g.slices) grid = g.slices;
  kernel<<<static_cast<unsigned>(grid), threads, smem, stream>>>(g);
  return cudaGetLastError();
}

// the instantiation of one window and path for the stride, mode and term
template <int K, bool RAGGED>
cudaError_t launch_window(const DwArgs& g, int stride, bool codes,
                          bool term, int threads, int smem,
                          cudaStream_t s) {
  if (!term) {
    if (stride == 1)
      return codes ? launch<K, 1, true, false, RAGGED>(g, threads, smem, s)
                   : launch<K, 1, false, false, RAGGED>(g, threads, smem, s);
    return codes ? launch<K, 2, true, false, RAGGED>(g, threads, smem, s)
                 : launch<K, 2, false, false, RAGGED>(g, threads, smem, s);
  }
  if (stride == 1)
    return codes ? launch<K, 1, true, true, RAGGED>(g, threads, smem, s)
                 : launch<K, 1, false, true, RAGGED>(g, threads, smem, s);
  return codes ? launch<K, 2, true, true, RAGGED>(g, threads, smem, s)
               : launch<K, 2, false, true, RAGGED>(g, threads, smem, s);
}

// launch the 1x1 window's instantiation at granule G: the grid is what
// fits on the card at once along the pixels, times the slices of C
template <int G, bool CODES, bool TERM>
cudaError_t launch_1x1(const DwArgs& g, int threads, cudaStream_t stream) {
  const auto kernel = int8_dwconv1x1_kernel<G, CODES, TERM>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long pixels = static_cast<long long>(g.N) * g.Ho * g.Wo;
  long long grid = (pixels + g.cg - 1) / g.cg;
  const long long fits = static_cast<long long>(per_sm) * sms /
                         (g.slices > 0 ? g.slices : 1);
  if (grid > fits) grid = fits > 0 ? fits : 1;
  kernel<<<dim3(static_cast<unsigned>(grid), g.slices), threads, 0,
           stream>>>(g);
  return cudaGetLastError();
}

// the 1x1 window's instantiation for the mode and term at granule G (16
// and 8: codes only, since f32 takes G = 4)
template <int G>
cudaError_t launch_window_1x1(const DwArgs& g, bool codes, bool term,
                              int threads, cudaStream_t s) {
  if constexpr (G >= 8) {
    if (!codes) return cudaErrorInvalidValue;
    return term ? launch_1x1<G, true, true>(g, threads, s)
                : launch_1x1<G, true, false>(g, threads, s);
  } else {
    if (!term)
      return codes ? launch_1x1<G, true, false>(g, threads, s)
                   : launch_1x1<G, false, false>(g, threads, s);
    return codes ? launch_1x1<G, true, true>(g, threads, s)
                 : launch_1x1<G, false, true>(g, threads, s);
  }
}

// what a library was built with (int8_dwconv3x3.cu: the aligned 3x3 and
// 1x1 paths; int8_dwconv5x5.cu: the 5x5 window and the ragged path of the
// 3x3 and 1x1 windows); cudaErrorInvalidValue for the rest
cudaError_t dispatch(const DwArgs& g, int k, int stride, bool codes,
                     bool term, bool ragged, int threads, int smem,
                     cudaStream_t s);

}  // namespace

extern "C" {

// out (n, ho, wo, c) from x (n, h, w, c) int8 and w (k*k, c) int8 (w4 = 0)
// or (k*k, (c + 1) / 2) nibble pairs (w4 = 1): the depthwise k x k conv
// (k = 1, 3 or 5) at `stride` with top and left pads pad_top and pad_left,
// `pad` outside the map, then the epilogue (codes: clamp to [lo, hi] ->
// int8; else f32, ReLU'd if relu).  ragged = 0: the aligned path (c % 8 ==
// 0, 16-byte aligned x and w); 4 or 1: the ragged path, staging the halo
// (or, at 1x1, loading a pixel's channels) in granules of that many bytes
// (4: c % 4 == 0 and 4-byte aligned x; with cb == c the halo rows as runs,
// ops/cuda/int8_dwconv.py: make_plan).  The plan (ops/cuda/int8_dwconv.py:
// plan): cb channels a block, cg column groups, rg row groups, rpt rows a
// thread (cb % 8 == 0, or % 4 on the ragged path; cb/4 * cg * rg <= 256
// threads); at 1x1 cb channels a block and cg pixel lanes (cb a multiple
// of the granule, cb/granule * cg <= 256 threads, rg = rpt = 1).  oc (c,)
// float32 adds the weight offset's term, or is null.  Stride 1 or 2, pads
// >= 0, 16-byte aligned out (the wrapper checks them).  A library takes
// what it was built for (dispatch) and returns cudaErrorInvalidValue for
// the rest.  Launches on `stream`; returns cudaGetLastError().
int dlmcq_int8_dwconv(const void* x, const void* w, const void* a,
                      const void* b, const void* oc, void* out, int n, int h,
                      int wd, int c, int k, int stride, int pad_top,
                      int pad_left, int ho, int wo, int pad, int lo, int hi,
                      int codes, int relu, int w4, int ragged, int cb, int cg,
                      int rg, int rpt, void* stream) {
  const int r = stride == 1 ? 4 : 2;
  const int granule =
      ragged ? ragged : c % 16 == 0 && cb % 16 == 0 ? 16 : 8;
  const long long threads =
      k == 1 ? static_cast<long long>(cb / granule) * cg
             : static_cast<long long>(cb / 4) * cg * rg;
  const int quantum = k == 1 ? granule : ragged ? 4 : 8;
  if (c <= 0 || (k != 1 && k != 3 && k != 5) ||
      (stride != 1 && stride != 2) || pad_top < 0 || pad_left < 0 ||
      n <= 0 || h <= 0 || wd <= 0 || ho <= 0 || wo <= 0 ||
      (ragged != 0 && ragged != 1 && ragged != 4) ||
      (ragged == 0 && c % 8) || (ragged == 4 && c % 4) ||
      cb % quantum || cb < quantum || cg < 1 || rg < 1 || rpt < 1 ||
      threads > MAX_THREADS || rpt > 1024 || (k != 1 && cg > 64) ||
      (k == 1 && (rg != 1 || rpt != 1)) ||
      static_cast<long long>(n) * ho * wo >= 0x7FF00000LL)
    return static_cast<int>(cudaErrorInvalidValue);
  DwArgs g;
  g.x = static_cast<const int8_t*>(x);
  g.w = static_cast<const int8_t*>(w);
  g.a = static_cast<const float*>(a);
  g.b = static_cast<const float*>(b);
  g.oc = static_cast<const float*>(oc);
  g.out = out;
  g.N = n;
  g.H = h;
  g.W = wd;
  g.C = c;
  g.Ho = ho;
  g.Wo = wo;
  g.stride = stride;
  g.pad_top = pad_top;
  g.pad_left = pad_left;
  g.flo = static_cast<float>(lo);
  g.fhi = static_cast<float>(hi);
  g.relu = relu;
  g.w4 = w4 != 0;
  g.pad = pad;
  g.pad4 = 0x01010101u * static_cast<uint32_t>(pad & 0xFF);
  g.pad_sum = k * k * pad;
  g.cb = cb;
  g.cg = cg;
  g.rpt = rpt;
  g.rg = rg;
  g.granule = granule;
  g.slices = (c + cb - 1) / cb;
  if (k == 1) {
    // no halo and no tiles: granules a slice, pixel lanes
    g.cq = cb / granule;
    g.tiles = g.slices;
    set_div(wo, g.wo_mul, g.wo_shift);
    set_div(ho, g.ho_mul, g.ho_shift);
    return static_cast<int>(dispatch(g, k, stride, codes != 0,
                                     oc != nullptr, ragged != 0,
                                     static_cast<int>(threads), 0,
                                     static_cast<cudaStream_t>(stream)));
  }
  g.cq = cb / 4;
  g.th = rg * rpt;
  g.tw = r * cg;
  g.hh = (g.th - 1) * stride + k;
  g.hw = (g.tw - 1) * stride + k;
  // the ragged path's row runs (granule 4, the slice the whole pixel):
  // pixels packed at a pitch of C, rows
  // row_pitch apart, the least from hw*C up with row_pitch = W*C (mod 16),
  // and 16 bytes more where the row groups' words would fall on the same
  // banks (rpt * stride * row_pitch / 4 = 0 mod 32)
  g.runs = ragged == 4 && cb == c;
  long long buf, stage = 0;
  if (g.runs) {
    const int span = g.hw * c;
    g.pitch = c;
    g.row_pitch = span + static_cast<int>(
        (static_cast<unsigned>(wd) * c - span) & 15u);
    if (rg > 1 && (rpt * stride * (g.row_pitch / 4)) % 32 == 0)
      g.row_pitch += 16;
    g.chunks = (span + MAX_SHIFT + 15) / 16;
    buf = (MAX_SHIFT + static_cast<long long>(g.hh - 1) * g.row_pitch +
           span + 15) / 16 * 16;
    // below STAGED_C two buffers of rg output rows of tw pixels, at f32's
    // size in either mode (the plan's shared memory does not depend on it)
    g.stage_row = c < STAGED_C ? (g.tw * c * 4 + 15) / 16 * 16 : 0;
    stage = 2LL * rg * g.stage_row;
  } else {
    g.pitch = cb + PITCH_PAD;
    g.row_pitch = g.hw * g.pitch;
    g.chunks = 0;
    g.stage_row = 0;
    buf = static_cast<long long>(g.hh) * g.row_pitch;
  }
  g.tiles_x = (g.Wo + g.tw - 1) / g.tw;
  g.tiles_y = (g.Ho + g.th - 1) / g.th;
  const long long tiles =
      static_cast<long long>(n) * g.tiles_y * g.tiles_x * g.slices;
  if (2 * buf + stage > MAX_SMEM || tiles >= 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  g.buf_bytes = static_cast<int>(buf);
  g.stage_at = static_cast<int>(2 * buf);
  g.tiles = static_cast<int>(tiles);
  return static_cast<int>(dispatch(g, k, stride, codes != 0, oc != nullptr,
                                   ragged != 0, static_cast<int>(threads),
                                   static_cast<int>(2 * buf + stage),
                                   static_cast<cudaStream_t>(stream)));
}

const char* dlmcq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
