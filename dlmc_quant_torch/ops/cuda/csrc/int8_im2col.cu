// int8 im2col for Hopper (sm_90a): the rows of a conv whose window the 3x3
// kernel does not take (the ImageNet 7x7/s2 stem), as the A operand of the
// int8 GEMM (int8_gemm.cu).
//
// Replaces, with int8_gemm.cu, the XLA int8 conv of the JAX package's
// integer path (dlmc_quant_tpu/quant/layers.py:721-728,
// jax.lax.conv_general_dilated on the padded codes); no Pallas kernel did
// this on the TPU.  For input codes x (N, H, W, C) int8 and a kh x kw
// window at stride s with top/left pads (top, left):
//
//   out[(n, p, q), k] = xpad[n, p*s - top + dy, q*s - left + dx, c]
//       k = (dy*kw + dx)*C + c < K = kh*kw*C          (the weight's order)
//   xpad = x, or the int8 code `pad` (real 0 on the input's grid, not 0)
//          outside the map;  out[., k] = 0 for K <= k < Kp
//
// out is (N*Ho*Wo, Kp) int8, Kp a multiple of 16: a row per output pixel,
// K contiguous, as int8_gemm's TMA map reads x.  The GEMM's packed weight
// is zero past K too, so the padding columns add nothing.
//
// Bound on an H100: bytes.  It reads x (N*H*W*C) and writes N*Ho*Wo*Kp
// bytes: at the stem (C = 3, K = 147, Kp = 160, 224 -> 112) 53 times what
// it reads, ~0.5 GB at batch 256, 0.16 ms at 3.35 TB/s.  So the work a
// written byte costs has to stay small.  Design:
// - A block takes a tile of th output rows by tw columns of one image (the
//   full width where it fits; ops/cuda/int8_im2col.py: plan picks them).
//   It stages the tile's padded band, (th - 1)*s + kh input rows of
//   (tw - 1)*s + kw pixels, in shared memory once: the map's bytes by
//   16-byte cp.async where x's rows are whole 16-byte pieces (W*C % 16 ==
//   0, as at the stem: 672 bytes a row), bytes otherwise; the pad code in
//   the cells outside the map.  A band row starts at the same address mod
//   16 as its first byte in x, so the pieces land aligned.
// - In NHWC, window row dy of output pixel (p, q) is kw*C contiguous bytes
//   of band row p*s + dy, from byte q*s*C: a GEMM row is kh runs of kw*C
//   bytes (seven of 21 at the stem).  A thread owns one 16-byte chunk
//   column j of the rows (Kp/16 threads a pixel, 256/(Kp/16) pixels a
//   pass), so the runs ("pieces") its chunk meets, where each lands and
//   which bytes of each word they fill are fixed once; for each pixel it
//   reads a piece's aligned 32-bit words from shared memory and aligns
//   them with __funnelshift_r, masks them into place and ORs them: no
//   per-byte border test and no per-byte lookup.
// - The chunk goes out in one aligned 16-byte store; a warp's 32 chunks
//   are 512 consecutive bytes of the rows, the write stream that bounds
//   the kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_KP = 2048;     // bytes of a row: Kp/16 <= THREADS chunks
constexpr int GUARD = 32;        // bytes before and after the band that a
                                 // piece's aligned loads may touch
constexpr int MAX_SMEM = 48 * 1024;

struct Im2colArgs {
  const int8_t* x;
  int8_t* out;
  int H, W, C, kh, kw, stride, top, left, Ho, Wo, K, Kp, pad;
  int th, tw;                // output rows and columns of a tile
  int tiles_y, tiles_x;
  int pitch;                 // bytes of a band row, a multiple of 16
  int vec;                   // W*C % 16 == 0: 16-byte cp.async pieces
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s =
      static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// bytes lo .. hi - 1 of a 32-bit word (0 <= lo <= hi <= 4) set
__device__ __forceinline__ uint32_t byte_mask(int lo, int hi) {
  if (lo >= hi) return 0u;
  const uint32_t m = hi - lo == 4 ? 0xFFFFFFFFu : (1u << (8 * (hi - lo))) - 1u;
  return m << (8 * lo);
}

// MAXP: the most runs a 16-byte chunk meets (3 where kw*C >= 8 or kh == 1)
template <int MAXP>
__global__ void __launch_bounds__(THREADS)
int8_im2col_kernel(const Im2colArgs g) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* band = smem + GUARD;
  unsigned t = blockIdx.x;
  const int tx = t % g.tiles_x;
  t /= g.tiles_x;
  const int ty = t % g.tiles_y;
  const int n = t / g.tiles_y;
  const int p0 = ty * g.th, q0 = tx * g.tw;
  const int th = min(g.th, g.Ho - p0), tw = min(g.tw, g.Wo - q0);
  const int rows = (th - 1) * g.stride + g.kh;
  const int cols = (tw - 1) * g.stride + g.kw;
  const int iy0 = p0 * g.stride - g.top, ix0 = q0 * g.stride - g.left;
  const int span = cols * g.C;                  // bytes of a band row
  // band columns inside the map: [cx_lo, cx_hi), band-row bytes
  // [lo_b, hi_b); the band row's byte j is at band + r*pitch + lead + j
  const int cx_lo = max(0, -ix0), cx_hi = max(cx_lo, min(cols, g.W - ix0));
  const int lo_b = cx_lo * g.C, hi_b = cx_hi * g.C;
  const uintptr_t origin = reinterpret_cast<uintptr_t>(g.x) +
                           static_cast<uintptr_t>(static_cast<long long>(ix0) * g.C);
  const int lead = g.vec ? static_cast<int>(origin & 15) : 0;
  const long long image = static_cast<long long>(n) * g.H;

  // 1. the pad code: whole rows outside the map, the columns outside it
  const uint8_t pad = static_cast<uint8_t>(g.pad);
  const int edge = lo_b + (span - hi_b);
  for (int r = 0; r < rows; ++r) {
    const int iy = iy0 + r;
    uint8_t* row = band + r * g.pitch + lead;
    if (iy < 0 || iy >= g.H) {
      for (int j = threadIdx.x; j < span; j += THREADS) row[j] = pad;
    } else {
      for (int j = threadIdx.x; j < edge; j += THREADS)
        row[j < lo_b ? j : hi_b + j - lo_b] = pad;
    }
  }
  // 2. the map's bytes: aligned 16-byte pieces by cp.async, the rest bytes
  const int r_lo = max(0, -iy0), r_hi = max(r_lo, min(rows, g.H - iy0));
  const int in_rows = r_hi - r_lo;
  if (hi_b > lo_b && in_rows > 0) {
    // the same split for every row: x's rows are whole 16-byte pieces
    const int head = g.vec ? min(hi_b - lo_b, (16 - (lead + lo_b) % 16) % 16)
                           : hi_b - lo_b;
    const int pieces = (hi_b - lo_b - head) / 16;
    const int tail_b = lo_b + head + 16 * pieces;        // bytes [tail_b, hi_b)
    const int loose = head + (hi_b - tail_b);             // bytes a row
    for (int i = threadIdx.x; i < in_rows * pieces; i += THREADS) {
      const int r = r_lo + i / pieces, j = lo_b + head + 16 * (i % pieces);
      const int8_t* src =
          g.x + ((image + iy0 + r) * g.W + ix0) * g.C + j;
      cp_async16(band + r * g.pitch + lead + j, src);
    }
    for (int i = threadIdx.x; i < in_rows * loose; i += THREADS) {
      const int r = r_lo + i / loose, e = i % loose;
      const int j = e < head ? lo_b + e : tail_b + e - head;
      band[r * g.pitch + lead + j] = static_cast<uint8_t>(
          __ldg(g.x + ((image + iy0 + r) * g.W + ix0) * g.C + j));
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. rows: thread = (chunk column j, pixel of the pass)
  const int per_row = g.Kp / 16;
  const int step = THREADS / per_row;
  const int j = threadIdx.x % per_row;
  int pix = threadIdx.x / per_row;
  if (pix >= step) return;
  const int run = g.kw * g.C;
  const int kend = min(16 * j + 16, g.K);
  int poff[MAXP];
  uint32_t mask[MAXP][4];
  {
    int k = 16 * j, dy = k / run, rem = k - dy * run;
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      const int lo = k - 16 * j;
      const int nb = k < kend ? min(run - rem, kend - k) : 0;
      // chunk byte b of this piece is band byte poff + (pixel) + b
      poff[i] = nb > 0 ? dy * g.pitch + lead + rem - lo : 0;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        mask[i][u] = nb > 0 ? byte_mask(max(lo, 4 * u) - 4 * u,
                                        min(lo + nb, 4 * u + 4) - 4 * u)
                            : 0u;
      k += nb;
      dy += 1;
      rem = 0;
    }
  }
  int pr = pix / tw, pq = pix - pr * tw;
  const int dr = step / tw, dq = step - dr * tw;
  int8_t* out = g.out +
                ((static_cast<long long>(n) * g.Ho + p0) * g.Wo + q0) * g.Kp +
                16 * j;
  const int row_step = g.stride * g.pitch, col_step = g.stride * g.C;
  while (pr < th) {
    const int base = pr * row_step + pq * col_step;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      const int a = base + poff[i];
      const uint32_t* w =
          reinterpret_cast<const uint32_t*>(band + (a & ~3));
      const int sh = 8 * (a & 3);
      uint32_t word[5];
#pragma unroll
      for (int e = 0; e < 5; ++e) {
        const bool need = (e < 4 && mask[i][e]) || (e > 0 && mask[i][e - 1]);
        word[e] = need ? w[e] : 0u;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] |= __funnelshift_r(word[u], word[u + 1], sh) & mask[i][u];
    }
    *reinterpret_cast<uint4*>(
        out + (static_cast<long long>(pr) * g.Wo + pq) * g.Kp) =
        make_uint4(v[0], v[1], v[2], v[3]);
    pq += dq;
    pr += dr;
    if (pq >= tw) {
      pq -= tw;
      ++pr;
    }
  }
}

}  // namespace

extern "C" {

// out (n*ho*wo, kp) int8 from x (n, h, w, c) int8: the kh x kw window at
// `stride` with top/left pads, `pad` outside the map, 0 past kh*kw*c.
// The tile plan (th, tw, pitch) comes from the wrapper (int8_im2col.py:
// plan).  kp % 16 == 0, kp <= 2048 and n*ho*wo*kp/16 < 2^31 (the wrapper
// checks them); the launch refuses a band beyond 48 KB of shared memory.
// Launches on `stream`; returns cudaGetLastError().
int dlmcq_int8_im2col(const void* x, void* out, int n, int h, int w, int c,
                      int kh, int kw, int stride, int top, int left, int ho,
                      int wo, int kp, int pad, int th, int tw, int pitch,
                      void* stream) {
  const long long rows = static_cast<long long>(n) * ho * wo;
  const long long chunks = rows * (kp / 16);
  if (kp % 16 || kp > MAX_KP || kh * kw * c > kp || chunks >= 0x7FFFFFFF ||
      chunks == 0 || th <= 0 || tw <= 0 || pitch % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Im2colArgs g;
  g.x = static_cast<const int8_t*>(x);
  g.out = static_cast<int8_t*>(out);
  g.H = h;
  g.W = w;
  g.C = c;
  g.kh = kh;
  g.kw = kw;
  g.stride = stride;
  g.top = top;
  g.left = left;
  g.Ho = ho;
  g.Wo = wo;
  g.K = kh * kw * c;
  g.Kp = kp;
  g.pad = pad;
  g.th = th < ho ? th : ho;
  g.tw = tw < wo ? tw : wo;
  g.tiles_y = (ho + g.th - 1) / g.th;
  g.tiles_x = (wo + g.tw - 1) / g.tw;
  g.pitch = pitch;
  g.vec = (static_cast<long long>(w) * c) % 16 == 0;
  const long long band_rows = static_cast<long long>(g.th - 1) * stride + kh;
  const long long span = (static_cast<long long>(g.tw - 1) * stride + kw) * c;
  const long long smem = band_rows * pitch + 2 * GUARD;
  const long long tiles = static_cast<long long>(n) * g.tiles_y * g.tiles_x;
  if (pitch < span + 15 || smem > MAX_SMEM || tiles >= 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kh == 1 || kw * c >= 8)
    int8_im2col_kernel<3><<<grid, THREADS, static_cast<int>(smem), s>>>(g);
  else
    int8_im2col_kernel<16><<<grid, THREADS, static_cast<int>(smem), s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

const char* dlmcq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
