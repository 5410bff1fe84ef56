// Fused int8 3x3 convolution with a requantize epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel dlmc_quant_tpu/ops/pallas/rpconv.py:200
// (int8_conv3x3_rm, body _rp_kernel at :142).  Same function, generalised:
// stride 1 or 2, any H, W, C >= 1 and O >= 1, NHWC int8 codes in and out,
// borders padded with the input grid's code for real 0 (not with zero).
//
//   acc[n,p,q,o] = sum_{dy,dx,c} xpad[n, p*s+dy, q*s+dx, c] * w[dy,dx,c,o]   (int32)
//   codes: out = clamp(rint(f32(acc)*a[o] + b[o]), lo, hi)              -> int8
//   f32:   out = f32(acc)*a[o] + b[o], then max(., 0) if relu          -> f32
//
// The epilogue is written with __int2float_rn, __fmul_rn and __fadd_rn so
// nvcc cannot contract it into an fma, and rounds with rintf (half to
// even, as jnp.round and torch.round do).  The kernel then equals its
// plain PyTorch version bit for bit.
//
// Bound on an H100: at 224x224 most RepVGG-A0 layers do more int8
// operations per byte than the card's ratio, so the bound is
// max(2*MACs / 1979e12, bytes / 3.35e12); the stem (C = 3) and the
// narrow 112x112 layers sit nearest the byte bound.
//
// Design (simple first; mma/wgmma, TMA and a persistent grid come later):
// implicit GEMM over K = 9 taps x ceil(C/4) words of 4 channels.  A block
// of 256 threads owns 64 output pixels x 64 output channels; each thread
// accumulates 4 pixels x 4 channels with __dp4a.  K is walked in steps of
// 16 words: the input patch words (64 x 16) and the weight words
// (16 x 64) are staged in shared memory, then every thread reads its
// operands conflict-free (pixels broadcast across a half-warp, channels
// on consecutive banks).  The weight is packed once, on the host, to
// (Kp, Op) int32 words: Kp = roundup(9*ceil(C/4), 16), Op = roundup(O, 64),
// with zero rows and columns, so the channel tail of a word and the
// padded K and O need no masks in the inner loop.  Input words are read
// as int32 when C % 4 == 0 and byte by byte otherwise (the stem).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TP = 64;        // output pixels per block
constexpr int TO = 64;        // output channels per block
constexpr int KC = 16;        // K words staged per step
constexpr int THREADS = 256;  // 16 channel lanes x 16 pixel lanes

template <bool VEC, bool CODES>
__global__ void __launch_bounds__(THREADS)
int8_conv3x3_kernel(const int8_t* __restrict__ x,
                    const int32_t* __restrict__ w,
                    const float* __restrict__ a,
                    const float* __restrict__ b,
                    void* __restrict__ out,
                    int H, int W, int C, int O, int Op, int Ho, int Wo,
                    long long npix, int stride, int K, int C4,
                    int pad, int lo, int hi, int relu) {
  __shared__ int32_t xs[TP][KC];
  __shared__ int32_t ws[KC][TO];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channel lane; also the K word this thread stages
  const int ty = tid / 16;  // pixel lane
  const long long p0 = static_cast<long long>(blockIdx.x) * TP;
  const int o0 = blockIdx.y * TO;

  // Geometry of the 4 pixels this thread stages (p0 + ty + 16*m).
  long long img[4];
  int ih0[4], iw0[4];
  bool valid[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const long long p = p0 + ty + 16 * m;
    valid[m] = p < npix;
    const long long pp = valid[m] ? p : 0;
    const long long hw = static_cast<long long>(Ho) * Wo;
    const long long n = pp / hw;
    const int r = static_cast<int>(pp - n * hw);
    const int oh = r / Wo;
    const int ow = r - oh * Wo;
    img[m] = n * H * W;
    ih0[m] = oh * stride - 1;
    iw0[m] = ow * stride - 1;
  }
  const int32_t pad_word = static_cast<int32_t>(
      static_cast<uint32_t>(static_cast<uint8_t>(pad)) * 0x01010101u);

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += KC) {
    // Stage input words: word k = tap * C4 + c4 of each of 64 pixels.
    const int k = k0 + tx;
    const bool kin = k < K;
    int dy = 0, dx = 0, c4 = 0;
    if (kin) {
      const int tap = k / C4;
      c4 = k - tap * C4;
      dy = tap / 3;
      dx = tap - 3 * dy;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      int32_t v = 0;
      if (kin && valid[m]) {
        const int ih = ih0[m] + dy;
        const int iw = iw0[m] + dx;
        if (ih < 0 || ih >= H || iw < 0 || iw >= W) {
          v = pad_word;
        } else {
          const int8_t* px =
              x + (img[m] + static_cast<long long>(ih) * W + iw) * C;
          if (VEC) {
            v = *reinterpret_cast<const int32_t*>(px + 4 * c4);
          } else {
            uint32_t u = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = 4 * c4 + j;
              if (c < C)
                u |= static_cast<uint32_t>(static_cast<uint8_t>(px[c]))
                     << (8 * j);
            }
            v = static_cast<int32_t>(u);
          }
        }
      }
      xs[ty + 16 * m][tx] = v;
    }
    // Stage weight words: rows k0..k0+15 (all < Kp), columns o0..o0+63.
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int idx = tid + THREADS * m;
      const int kk = idx / TO;
      const int oo = idx - kk * TO;
      ws[kk][oo] = w[static_cast<long long>(k0 + kk) * Op + o0 + oo];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      int xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: per-channel affine, then round and clamp (codes) or ReLU (f32).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = p0 + ty + 16 * i;
    if (p >= npix) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx + 16 * j;
      if (o >= O) continue;
      float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), a[o]), b[o]);
      if (CODES) {
        const float q = fminf(fmaxf(rintf(y), static_cast<float>(lo)),
                              static_cast<float>(hi));
        static_cast<int8_t*>(out)[p * O + o] =
            static_cast<int8_t>(static_cast<int>(q));
      } else {
        if (relu) y = fmaxf(y, 0.0f);
        static_cast<float*>(out)[p * O + o] = y;
      }
    }
  }
}

template <bool VEC, bool CODES>
void launch(dim3 grid, cudaStream_t s, const int8_t* x, const int32_t* w,
            const float* a, const float* b, void* out, int H, int W, int C,
            int O, int Op, int Ho, int Wo, long long npix, int stride, int K,
            int C4, int pad, int lo, int hi, int relu) {
  int8_conv3x3_kernel<VEC, CODES><<<grid, THREADS, 0, s>>>(
      x, w, a, b, out, H, W, C, O, Op, Ho, Wo, npix, stride, K, C4, pad, lo,
      hi, relu);
}

}  // namespace

extern "C" {

// Shape constants the host packs the weight for.
int dlmcq_int8_conv3x3_kc() { return KC; }
int dlmcq_int8_conv3x3_to() { return TO; }

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int dlmcq_int8_conv3x3(const void* x, const void* w, const void* a,
                       const void* b, void* out, int n, int h, int wd, int c,
                       int o, int op, int stride, int pad, int lo, int hi,
                       int codes, int relu, void* stream) {
  const int ho = (h - 1) / stride + 1;
  const int wo = (wd - 1) / stride + 1;
  const int c4 = (c + 3) / 4;
  const int k = 9 * c4;
  const long long npix = static_cast<long long>(n) * ho * wo;
  const dim3 grid(static_cast<unsigned>((npix + TP - 1) / TP),
                  static_cast<unsigned>(op / TO));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int32_t* wp = static_cast<const int32_t*>(w);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  const bool vec = c % 4 == 0;
  if (vec && codes)
    launch<true, true>(grid, s, xp, wp, ap, bp, out, h, wd, c, o, op, ho, wo,
                       npix, stride, k, c4, pad, lo, hi, relu);
  else if (vec)
    launch<true, false>(grid, s, xp, wp, ap, bp, out, h, wd, c, o, op, ho, wo,
                        npix, stride, k, c4, pad, lo, hi, relu);
  else if (codes)
    launch<false, true>(grid, s, xp, wp, ap, bp, out, h, wd, c, o, op, ho, wo,
                        npix, stride, k, c4, pad, lo, hi, relu);
  else
    launch<false, false>(grid, s, xp, wp, ap, bp, out, h, wd, c, o, op, ho,
                         wo, npix, stride, k, c4, pad, lo, hi, relu);
  return static_cast<int>(cudaGetLastError());
}

const char* dlmcq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
