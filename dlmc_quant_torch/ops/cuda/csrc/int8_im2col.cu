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
// it reads, ~0.5 GB at batch 256, 0.15 ms at 3.35 TB/s.  Design: a thread
// builds one 16-byte chunk of a row in registers and stores it in one
// aligned 16-byte store, so the writes, which are the bytes that count,
// are whole sectors of consecutive addresses; the reads are byte loads
// through the read-only path, which neighbouring threads share (chunks of
// one row read one window; pixels side by side read windows s*C bytes
// apart).  Where each byte of a chunk comes from is a table in shared
// memory, built once a block: its offset from the window's origin and its
// tap (dy, dx), which the border test needs.  A grid-stride loop over
// (row, chunk) with 32-bit indices (the wrapper bounds them).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_KP = 2048;   // bytes of a row the table covers
constexpr int THREADS = 256;
constexpr uint8_t PAST_K = 0xFF;   // tap of a padding column

struct Im2colArgs {
  const int8_t* x;
  int8_t* out;
  int H, W, C, kw, stride, top, left, Ho, Wo, K, Kp, pad;
  unsigned rows, chunks;   // N*Ho*Wo, and rows * (Kp / 16) < 2^31
};

__global__ void __launch_bounds__(THREADS)
int8_im2col_kernel(const Im2colArgs g) {
  __shared__ int delta[MAX_KP];            // x offset from the window origin
  __shared__ uint8_t tap_y[MAX_KP], tap_x[MAX_KP];
  for (int k = threadIdx.x; k < g.Kp; k += THREADS) {
    if (k < g.K) {
      const int dy = k / (g.kw * g.C);
      const int dx = (k / g.C) % g.kw;
      delta[k] = (dy * g.W + dx) * g.C + k % g.C;
      tap_y[k] = static_cast<uint8_t>(dy);
      tap_x[k] = static_cast<uint8_t>(dx);
    } else {
      delta[k] = 0;
      tap_y[k] = PAST_K;
      tap_x[k] = PAST_K;
    }
  }
  __syncthreads();
  const unsigned per_row = g.Kp / 16;
  for (unsigned q = blockIdx.x * THREADS + threadIdx.x; q < g.chunks;
       q += gridDim.x * THREADS) {
    const unsigned row = q / per_row;
    const int k0 = 16 * (q - row * per_row);
    const int ox = row % g.Wo;
    const unsigned nh = row / g.Wo;
    const int oy = nh % g.Ho;
    const int n = nh / g.Ho;
    const int iy0 = oy * g.stride - g.top;
    const int ix0 = ox * g.stride - g.left;
    // the window's origin; only offsets inside the map are read
    const long long origin =
        ((static_cast<long long>(n) * g.H + iy0) * g.W + ix0) * g.C;
    uint32_t word[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 4 * u + j;
        int code = 0;
        if (tap_y[k] != PAST_K) {
          const int iy = iy0 + tap_y[k];
          const int ix = ix0 + tap_x[k];
          code = (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
                     ? __ldg(g.x + origin + delta[k])
                     : g.pad;
        }
        v |= static_cast<uint32_t>(code & 0xFF) << (8 * j);
      }
      word[u] = v;
    }
    *reinterpret_cast<uint4*>(g.out + static_cast<long long>(row) * g.Kp +
                              k0) = make_uint4(word[0], word[1], word[2],
                                               word[3]);
  }
}

}  // namespace

extern "C" {

// out (n*ho*wo, kp) int8 from x (n, h, w, c) int8: the kh x kw window at
// `stride` with top/left pads, `pad` outside the map, 0 past kh*kw*c.
// kp % 16 == 0, kp <= 2048, kh, kw < 255 and n*ho*wo*kp/16 < 2^31 (the
// wrapper checks them).  Launches on `stream`; returns cudaGetLastError().
int dlmcq_int8_im2col(const void* x, void* out, int n, int h, int w, int c,
                      int kh, int kw, int stride, int top, int left, int ho,
                      int wo, int kp, int pad, void* stream) {
  const long long rows = static_cast<long long>(n) * ho * wo;
  const long long chunks = rows * (kp / 16);
  if (kp % 16 || kp > MAX_KP || kh * kw * c > kp || kh >= PAST_K ||
      kw >= PAST_K || chunks >= 0x7FFFFFFF || chunks == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Im2colArgs g;
  g.x = static_cast<const int8_t*>(x);
  g.out = static_cast<int8_t*>(out);
  g.H = h;
  g.W = w;
  g.C = c;
  g.kw = kw;
  g.stride = stride;
  g.top = top;
  g.left = left;
  g.Ho = ho;
  g.Wo = wo;
  g.K = kh * kw * c;
  g.Kp = kp;
  g.pad = pad;
  g.rows = static_cast<unsigned>(rows);
  g.chunks = static_cast<unsigned>(chunks);
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const long long blocks = (chunks + THREADS - 1) / THREADS;
  const long long most = 8LL * sms;   // 8 blocks of 256 threads an SM
  const unsigned grid =
      static_cast<unsigned>(blocks < most ? blocks : most);
  int8_im2col_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      g);
  return static_cast<int>(cudaGetLastError());
}

const char* dlmcq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
