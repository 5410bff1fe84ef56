// int8 depthwise 3x3 convolution with the folded requantize epilogue, for
// Hopper (sm_90a): MobileNetV2's and MobileOne's depthwise convs on the
// chained int8 path.
//
// Replaces the XLA int8 conv of the JAX package's integer path at
// feature_group_count = C (dlmc_quant_tpu/quant/layers.py:722-728:
// jnp.pad of the codes with the pad code, then conv_general_dilated with
// preferred_element_type=int32); no Pallas kernel did this on the TPU, XLA
// lowered the grouped conv.  For input codes x (N, H, W, C) int8 and a
// weight w (3, 3, 1, C), packed as (9, C) int8 (tap dy*3 + dx, channels
// contiguous):
//
//   acc[n,p,q,c] = sum_{dy,dx} xpad[n, p*s - pad_lo + dy, q*s - pad_lo + dx, c]
//                              * w[dy*3 + dx, c]                      (int32)
//   xpad = x, or the int8 code `pad` (real 0 on the input's grid, not 0)
//          outside the map; pad_lo = 1, or 0 for SAME at stride 2 on an
//          even map; Ho = ceil(H / s), Wo = ceil(W / s)
//   codes: out = clamp(rint(f32(acc)*a[c] + b[c]), lo, hi)    -> int8
//   f32:   out = f32(acc)*a[c] + b[c], then max(., 0) if relu -> f32
//
// written with __int2float_rn, __fmul_rn, __fadd_rn (no fma contraction)
// and __float2int_rn (round half to even), as the int8 conv's and GEMM's
// epilogues (ops/cuda/epilogue.py is the plain version), so the kernel
// equals int8_dwconv3x3_plain bit for bit.  The ReLU of a boundary lives
// in lo and a ReLU6 in hi (quant/chain.py: fold_params).
//
// Bound on an H100: bytes.  A depthwise conv does 9 multiply-adds an
// output value and has no reduction over channels, so tensor cores do not
// apply: at batch 256 MobileNetV2's 17 launches move ~1.5 GB (x read once,
// codes written once) for ~5.3 G multiply-adds, 0.46 ms at 3.35 TB/s
// against ~0.005 ms of int8 operations at the card's peak.  The
// multiply-adds run on the CUDA cores' int32 pipes, 64 lanes an SM a
// clock: ~0.6 ms for MobileNetV2's at 1.98 GHz, so the design has to keep
// instructions low as well as bytes.
//
// Design (simple first): one thread per output pixel and 16-channel
// group, channel groups fastest, so a warp reads and writes consecutive
// 16-byte chunks.  It makes nine 16-byte loads of codes through the
// read-only path (the pad code where a tap lies outside the map), 144
// int32 multiply-adds against the group's nine taps, which sit in shared
// memory with a and b for every channel (loaded once a block), runs the
// epilogue and stores one 16-byte chunk of codes (or four float4).  The
// nine loads of neighbouring pixels overlap: at stride 1 each input chunk
// is read by nine threads, from L1 or L2, and from device memory about
// once.  Not done yet: halo tiles in shared memory, packed byte
// arithmetic.  A grid-stride loop over (pixel, group) with 32-bit indices
// (the wrapper bounds them).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 16;           // channels of a thread
constexpr int MAX_C = 2880;         // 17 bytes a channel in 48 KB of smem

struct DwArgs {
  const int8_t* x;
  const int8_t* w;       // (9, C)
  const float* a;
  const float* b;
  void* out;             // (N, Ho, Wo, C): int8 codes or f32
  int H, W, C, Ho, Wo, stride, pad_lo, lo, hi, relu;
  uint32_t pad4;         // the pad code in every byte
  unsigned items;        // N * Ho * Wo * C / 16 < 2^31
};

// acc[4 u + j] += byte j of x.u * byte j of w.u, bytes as signed int8
__device__ __forceinline__ void mac16(int (&acc)[GROUP], const uint4 x,
                                      const uint4 w) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int xv = static_cast<int>(xs[u] << (24 - 8 * j)) >> 24;
      const int wv = static_cast<int>(ws[u] << (24 - 8 * j)) >> 24;
      acc[4 * u + j] += xv * wv;
    }
  }
}

template <bool CODES>
__global__ void __launch_bounds__(THREADS)
int8_dwconv3x3_kernel(const DwArgs g) {
  // a (C floats), b (C floats), then the weight (9 C bytes, 16-aligned:
  // 8 C is a multiple of 128)
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_a = reinterpret_cast<float*>(smem);
  float* s_b = s_a + g.C;
  uint4* s_w = reinterpret_cast<uint4*>(smem + 8 * g.C);
  for (int i = threadIdx.x; i < g.C; i += THREADS) {
    s_a[i] = __ldg(g.a + i);
    s_b[i] = __ldg(g.b + i);
  }
  const int groups = g.C / GROUP;
  const uint4* w4 = reinterpret_cast<const uint4*>(g.w);
  for (int i = threadIdx.x; i < 9 * groups; i += THREADS) s_w[i] = __ldg(w4 + i);
  __syncthreads();

  const uint4 padv = make_uint4(g.pad4, g.pad4, g.pad4, g.pad4);
  for (unsigned q = blockIdx.x * THREADS + threadIdx.x; q < g.items;
       q += gridDim.x * THREADS) {
    const unsigned pix = q / groups;
    const int grp = q - pix * groups;
    const int ox = pix % g.Wo;
    const unsigned nh = pix / g.Wo;
    const int oy = nh % g.Ho;
    const int n = nh / g.Ho;
    const int iy0 = oy * g.stride - g.pad_lo;
    const int ix0 = ox * g.stride - g.pad_lo;
    int acc[GROUP];
#pragma unroll
    for (int c = 0; c < GROUP; ++c) acc[c] = 0;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int iy = iy0 + dy;
      const bool row_in = iy >= 0 && iy < g.H;
      const long long row =
          (static_cast<long long>(n) * g.H + iy) * g.W;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int ix = ix0 + dx;
        uint4 xv = padv;
        if (row_in && ix >= 0 && ix < g.W)
          xv = __ldg(reinterpret_cast<const uint4*>(
              g.x + (row + ix) * g.C + GROUP * grp));
        mac16(acc, xv, s_w[(3 * dy + dx) * groups + grp]);
      }
    }
    const int c0 = GROUP * grp;
    float y[GROUP];
#pragma unroll
    for (int c = 0; c < GROUP; ++c)
      y[c] = __fadd_rn(__fmul_rn(__int2float_rn(acc[c]), s_a[c0 + c]),
                       s_b[c0 + c]);
    const long long at = static_cast<long long>(pix) * g.C + c0;
    if constexpr (CODES) {
      uint32_t word[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // rintf and the conversion in one cvt (half to even, saturating)
          const int code = min(max(__float2int_rn(y[4 * u + j]), g.lo), g.hi);
          v |= static_cast<uint32_t>(code & 0xFF) << (8 * j);
        }
        word[u] = v;
      }
      *reinterpret_cast<uint4*>(static_cast<int8_t*>(g.out) + at) =
          make_uint4(word[0], word[1], word[2], word[3]);
    } else {
      float4* o = reinterpret_cast<float4*>(static_cast<float*>(g.out) + at);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = g.relu ? fmaxf(y[4 * u + j], 0.0f) : y[4 * u + j];
        o[u] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

}  // namespace

extern "C" {

// out (n, ceil(h/stride), ceil(w/stride), c) from x (n, h, w, c) int8 and
// w (9, c) int8: the depthwise 3x3 conv with top/left pad pad_lo, `pad`
// outside the map, then the epilogue (codes: clamp to [lo, hi] -> int8;
// else f32, ReLU'd if relu).  c % 16 == 0, c <= 2880, stride 1 or 2,
// pad_lo 0 or 1, 16-byte aligned x, w and out, n*ho*wo*c/16 < 2^31 (the
// wrapper checks them).  Launches on `stream`; returns cudaGetLastError().
int dlmcq_int8_dwconv3x3(const void* x, const void* w, const void* a,
                         const void* b, void* out, int n, int h, int wd,
                         int c, int stride, int pad_lo, int pad, int lo,
                         int hi, int codes, int relu, void* stream) {
  if (c % GROUP || c <= 0 || c > MAX_C || (stride != 1 && stride != 2) ||
      (pad_lo != 0 && pad_lo != 1) || n <= 0 || h <= 0 || wd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ho = (h - 1) / stride + 1;
  const int wo = (wd - 1) / stride + 1;
  const long long items = static_cast<long long>(n) * ho * wo * (c / GROUP);
  if (items >= 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  DwArgs g;
  g.x = static_cast<const int8_t*>(x);
  g.w = static_cast<const int8_t*>(w);
  g.a = static_cast<const float*>(a);
  g.b = static_cast<const float*>(b);
  g.out = out;
  g.H = h;
  g.W = wd;
  g.C = c;
  g.Ho = ho;
  g.Wo = wo;
  g.stride = stride;
  g.pad_lo = pad_lo;
  g.lo = lo;
  g.hi = hi;
  g.relu = relu;
  g.pad4 = 0x01010101u * static_cast<uint32_t>(pad & 0xFF);
  g.items = static_cast<unsigned>(items);
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const long long blocks = (items + THREADS - 1) / THREADS;
  const long long most = 8LL * sms;   // 8 blocks of 256 threads an SM
  const unsigned grid = static_cast<unsigned>(blocks < most ? blocks : most);
  const size_t smem = 17 * static_cast<size_t>(c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (codes)
    int8_dwconv3x3_kernel<true><<<grid, THREADS, smem, s>>>(g);
  else
    int8_dwconv3x3_kernel<false><<<grid, THREADS, smem, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

const char* dlmcq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
