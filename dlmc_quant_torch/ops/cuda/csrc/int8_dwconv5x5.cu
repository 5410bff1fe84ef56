// The int8 depthwise conv's wide build, for Hopper (sm_90a): the 5x5 window
// (any C) and the ragged path of either window (C % 8 != 0, or codes that
// are not 16-byte aligned): GhostNet's and EfficientNet's 5x5 convs and
// GhostNet's cheap 3x3 convs at C = 12, 20, 36, 60, 92, 100.  A library of
// its own beside int8_dwconv3x3.cu (the aligned 3x3 build), with the same C
// interface; it takes k = 5, and k = 3 and 1 on the ragged path only
// (the 1x1 window in granules of 4 channels or 1: a ragged C, and f32 at
// any C, MobileOne's scale branches).
// int8_dwconv.cuh holds what the two share: the depthwise conv's
// definition, the arguments, the cells' staging, the byte transposes, the
// epilogue, the 3x3 kernel and the C entry point.
//
// Bound on an H100: bytes, as the aligned path (int8_dwconv.cuh); the 5x5
// window does 25 multiply-adds an output value and stays under its bytes
// (50 int8 operations a byte of f32 out at most, against 1979 TOP/s over
// 3.35 TB/s = 591).  What the card makes scarce here is issue slots, the
// load-store pipe and latency: the staging, the products and the stores
// overlap only as far as the blocks on a multiprocessor do.
//
// The ragged path.  GhostNet's cheap convs write f32 for the concat at C
// from 12 to 100, where the whole pixel is the channel slice (C <= 128:
// ops/cuda/int8_dwconv.py: plan).  Timed with its parts left out
// (tools/dw_parts.py), the kernel before this design spent most of its
// time in its stores; what changes from the aligned path:
//
// - Staging by row runs (stage_runs, the runs layout, where the slice is
//   the whole pixel on 4-byte aligned codes at C % 4 == 0: every ragged
//   launch GhostNet-1.0 makes).  A halo row's pixels inside the map are one
//   run of bytes in device memory, (hw - overhang) * C of them.  Pixels are
//   packed in shared memory at a pitch of C bytes, so the run lies there as
//   one piece too, placed at its source's address mod 16 (run_shift): the
//   rows row_pitch apart, with row_pitch = W*C (mod 16), and the tile
//   shifted by its pixel (iy0, ix0)'s address mod 16.  Every aligned 16
//   bytes of a run is then one 16-byte cp.async.cg; its head and tail words
//   are 4-byte copies, and the cells left and right of the map (every cell
//   of a row above or below it) get the pad code.  At C = 12 a halo row of
//   30 pixels is at most 24 copies, 21-22 of them 16 bytes, against 90
//   4-byte copies of cells at the pitch CB + 16, and the tile's halo takes
//   12/28 of the shared memory.  TMA does not serve: its fill outside the
//   tensor is zero, not the pad code, and its row strides must be multiples
//   of 16 bytes, which W*C is not at (14, 14, 100) and (14, 14, 92) (1400
//   and 1288 bytes).
// - The banks.  A lane (cq, j, row group g) reads the word at
//   shift/4 + g*rpt*s*row_pitch/4 + C*j + cq + k*C/4 (its column group j
//   starts 4j pixels in, at either stride).  Within a row group the words
//   C*j + cq decide: at C = 12, 12j mod 32 = 0, 12, 24, 4, 16, 28, 8 for
//   j < 7, each with 3 lanes, 21 distinct banks; at C = 20, 36, 60, 92,
//   100 two or three lanes share a bank (four pixels are C words, and C/4
//   consecutive words a column group), whatever the row pitch.  The row
//   pitch only moves the next row group's lanes, by g*rpt*s*row_pitch/4
//   banks: it is the least from hw*C up with the residue above, 16 bytes
//   more where that move is 0 mod 32 (every lane of the next row group on
//   the bank of the same lane of this one).  The lanes of a warp that
//   straddle two row groups (at C = 12, 21 lanes a row group) cost nothing
//   else: they run the same instructions on other rows.
// - Staged stores (store_row_staged, the runs layout at C < STAGED_C =
//   64).  A thread's four outputs of a row are 4 pixels apart: at C = 12 a
//   warp's store of 512 bytes of f32 lands in 8-16 lines of 128 bytes.
//   Each output row of the block goes to shared memory first, a quad a
//   float4 (or a 4-byte word of codes), laid out as the tile's columns lie
//   in device memory; after one barrier the block copies the rows out in
//   16-byte units (4-byte in codes), consecutive lanes on consecutive
//   units: 4-5 lines a warp's store.  Two buffers of rg rows at f32's size
//   (tw*C*4 bytes a row) take turns, one barrier an output row.  From C =
//   64 up a pixel's f32 is 256 bytes or more, a warp's direct stores touch
//   few lines, and the barrier costs more than the copy saves (C = 92 and
//   100: 22.3 and 20.6 us staged against 18.7 and 18.0, H100 80GB HBM3
//   at 700 W, batch 256).
// - Whole-quad stores elsewhere: where C % 4 == 0 each quad of a thread
//   lies wholly inside C and 16-byte aligned in f32 (4-byte in codes), so
//   it goes out as one float4 or one 4-byte word, as on the aligned path;
//   channel by channel only where C % 4 != 0.
// - Otherwise as before: where the whole pixel does not fit (C / 4 *
//   column groups > 256 threads), masked 32-channel slices, cells at the
//   pitch CB + 16 staged by 4-byte cp.async; where C % 4 != 0 or the codes
//   are not 4-byte aligned (GhostNet x0.5's C = 18, a view), byte by byte
//   (stage_halo's RAGGED cells: correct, no speed aim).  The weights, a, b
//   and oc are read channel by channel (0 past C; W4 rows of (C + 1) / 2
//   bytes), once a block.  The products are the aligned path's.
//
// The 5x5 window (int8_dwconv5x5_kernel).  Five taps a row do not fit one
// dp4a word, so a tap row's weights are two words: lo = (w0,w1,w2,w3) and
// hi = (w4,0,0,0), the 64-bit (hi:lo) of the five taps.  From each halo
// row a thread reads (R-1)s+5 words (8 at stride 1, 7 at stride 2) and
// transposes them into two channel words of 4 pixels, A = pixels h..h+3
// and B = h+4..h+7, h its first column.  Output k starts d = k*s pixels
// in, and its five taps of the row are dp4a(A, lo << 8d) +
// dp4a(B, funnelshift_l(lo, hi, 8d)): (hi:lo) << 8d puts tap i at byte
// i + d of the pair (A, B).  Two dp4a an output a row, 10 an output (25
// multiply-adds); the window sum of TERM is the same against words of
// ones, less 25 * pad.  Row reuse: a thread keeps the channel words of its
// last five halo rows in registers (cw[5][8]) as it walks down the tile, so
// each halo row is loaded and transposed once a thread: an output row
// brings one new halo row at stride 1 and two at stride 2, where it read
// five.  That is 8 LDS and 12 PRMT a new row, against 5 x (7-8 LDS + 12
// PRMT) an output row before; the rows kept cost 32 (stride 1) or 24
// (stride 2) register moves an output row.  Registers: 40 weight words, 40
// row words, 16 sums (and 16 window sums with TERM) at stride 1: 152-164
// registers with TERM, 125-127 without, no spills (ptxas -v; the ragged
// 3x3 stride-2 codes instantiation spills 8 bytes).  Its aligned path
// keeps the cells of CB + 16 bytes: row runs and staged stores there took
// GhostNet's (56, 56, 72) stride-2 launch from 65 to 122 us (the runs'
// chunk loop costs more instructions a byte than the cells' 8-byte
// granules, at two blocks of 126 threads an SM).
//
// The plan (ops/cuda/int8_dwconv.py: plan) charges each window rpt*s + k -
// s halo rows a thread for the reuse, and the runs layout's 16-byte
// chunks for its staging.
//
// Measured on an NVIDIA H100 80GB HBM3 at its 700 W limit, batch 256
// (tools/dw_launches.py beside the parent tree's kernel in turns, seeded
// codes in each request's mode; tools/dw_parts.py for the parts):
// GhostNet-1.0's 10 ragged launches 0.308 ms against 0.850 before and a
// 0.166 bound (C = 12 at 28 us, 16 without its stores, 12 staging alone;
// C = 36 at 66 us against a 43 bound); GhostNet's 4 5x5 stride-2 launches
// 0.146 against 0.150 and a 0.064 bound, held back by their staging
// ((56, 56, 72) 30 of its 65 us without it, 42 alone);
// EfficientNet-B0's 9 5x5 launches 0.596 against 0.663 and a 0.362
// bound, the stride-1 ones held by their products (28, 28, 240): 83 of
// its 107 us without the staging, 30 with the staging alone).

#include "int8_dwconv.cuh"

namespace {

// The 5x5 window's tap-row weights of channels c..c+3: byte i of
// wlo[dy][j] is w[5 dy + i, c + j] (i < 4), byte 0 of whi[dy][j] is
// w[5 dy + 4, c + j], the rest 0; and a, b (the header's 5x5 paragraph).
template <bool TERM, bool RAGGED>
__device__ __forceinline__ void load_weights5(const DwArgs& g, int c,
                                              bool c_in,
                                              uint32_t (&wlo)[5][4],
                                              uint32_t (&whi)[5][4],
                                              float (&ea)[4], float (&eb)[4],
                                              float (&ec)[4]) {
#pragma unroll
  for (int dy = 0; dy < 5; ++dy) {
    uint32_t tap[5] = {0, 0, 0, 0, 0};
    if (c_in) {
#pragma unroll
      for (int dx = 0; dx < 5; ++dx)
        tap[dx] = tap_word<RAGGED>(g, 5 * dy + dx, c);
    }
    transpose4(tap[0], tap[1], tap[2], tap[3], wlo[dy]);
    transpose4(tap[4], 0u, 0u, 0u, whi[dy]);
  }
  load_affine<TERM, RAGGED>(g, c, c_in, ea, eb, ec);
}

// The channel words of one halo row for the 5x5 window: cw[j] = pixels
// h..h+3 of channel j, cw[4 + j] = h+4..h+7 (at stride 2 the last byte
// repeats h+6: it meets a zero weight byte).
template <int S>
__device__ __forceinline__ void row_words5(const unsigned char* q, int pitch,
                                           uint32_t (&cw)[8]) {
  constexpr int WORDS = S == 1 ? 8 : 7;
  uint32_t p[8];
#pragma unroll
  for (int k = 0; k < WORDS; ++k)
    p[k] = *reinterpret_cast<const uint32_t*>(q + k * pitch);
  if constexpr (S == 2) p[7] = p[6];
  uint32_t lo[4], hi[4];
  transpose4(p[0], p[1], p[2], p[3], lo);
  transpose4(p[4], p[5], p[6], p[7], hi);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cw[j] = lo[j];
    cw[4 + j] = hi[j];
  }
}

// acc[j][k] += the tap row's five products for output k of channel j,
// whose window starts d = k*S pixels into the row's words; with ONES the
// five codes (the window sum)
template <int S, int R, bool ONES = false>
__device__ __forceinline__ void mac_row5(int (&acc)[4][R],
                                         const uint32_t (&cw)[8],
                                         const uint32_t (&wlo)[4],
                                         const uint32_t (&whi)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo = ONES ? 0x01010101u : wlo[j];
    const uint32_t hi = ONES ? 0x00000001u : whi[j];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int d = 8 * S * k;
      acc[j][k] = __dp4a(static_cast<int>(cw[j]), static_cast<int>(lo << d),
                         acc[j][k]);
      acc[j][k] = __dp4a(static_cast<int>(cw[4 + j]),
                         static_cast<int>(__funnelshift_l(lo, hi, d)),
                         acc[j][k]);
    }
  }
}

template <int S, bool CODES, bool TERM, bool RAGGED>
__global__ void __launch_bounds__(MAX_THREADS)
int8_dwconv5x5_kernel(const DwArgs g) {
  constexpr int R = S == 1 ? 4 : 2;      // output columns of a thread
  constexpr int KEPT = 5 - S;            // halo rows an output row passes on
  extern __shared__ __align__(16) unsigned char smem[];
  const int cq = threadIdx.x % g.cq;
  const int j = threadIdx.x / g.cq % g.cg;
  const int r0 = threadIdx.x / (g.cq * g.cg) * g.rpt;
  const int c = blockIdx.x % g.slices * g.cb + 4 * cq;
  const bool c_in = c < g.C;
  uint32_t wlo[5][4], whi[5][4];
  float ea[4], eb[4], ec[4];
  load_weights5<TERM, RAGGED>(g, c, c_in, wlo, whi, ea, eb, ec);

  const int row_step = RAGGED ? g.row_pitch : g.hw * g.pitch;
  const int col0 = R * S * j;
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
    // the thread's halo rows from its first output row's first: output row
    // i reads rows i*S .. i*S + 4, the first KEPT of them kept in cw from
    // output row i - 1
    const unsigned char* hq = q + r0 * S * row_step;
    uint32_t cw[5][8];
#pragma unroll
    for (int u = 0; u < KEPT; ++u)
      row_words5<S>(hq + u * row_step, g.pitch, cw[u]);
    for (int i = 0; i < g.rpt; ++i, ++oy, at += out_row) {
#pragma unroll
      for (int u = KEPT; u < 5; ++u)
        row_words5<S>(hq + (i * S + u) * row_step, g.pitch, cw[u]);
      int acc[4][R], sums[4][R];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < R; ++k) acc[u][k] = sums[u][k] = 0;
#pragma unroll
      for (int dy = 0; dy < 5; ++dy) {
        mac_row5<S, R>(acc, cw[dy], wlo[dy], whi[dy]);
        if constexpr (TERM)
          mac_row5<S, R, true>(sums, cw[dy], wlo[dy], whi[dy]);
      }
      put_row<CODES, TERM, R, RAGGED>(g, acc, sums, ea, eb, ec, smem, j,
                                      c, r0, tl, i, col_in && oy < g.Ho, at,
                                      ox);
#pragma unroll
      for (int u = 0; u < KEPT; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) cw[u][v] = cw[u + S][v];
    }
    __syncthreads();
    buf ^= 1;
  }
}

cudaError_t dispatch(const DwArgs& g, int k, int stride, bool codes,
                     bool term, bool ragged, int threads, int smem,
                     cudaStream_t s) {
  if (k == 5)
    return ragged ? launch_window<5, true>(g, stride, codes, term, threads,
                                           smem, s)
                  : launch_window<5, false>(g, stride, codes, term, threads,
                                            smem, s);
  if (k == 1 && ragged)
    return g.granule == 4 ? launch_window_1x1<4>(g, codes, term, threads, s)
                          : launch_window_1x1<1>(g, codes, term, threads, s);
  if (k == 3 && ragged)
    return launch_window<3, true>(g, stride, codes, term, threads, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace
