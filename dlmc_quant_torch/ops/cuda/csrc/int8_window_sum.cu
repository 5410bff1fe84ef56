// int8 window sums for Hopper (sm_90a): the row term of a layer whose
// weight grid has an offset (q*s_w + o_w, RootQ's and an offset LSQ
// weight's), one int32 per output pixel, which the conv's and the GEMM's
// epilogues scale per output channel (ops/cuda/epilogue.py).
//
// New in the port: the JAX package drops o_w in its integer plan (ROADMAP
// hazard C1) and has no such kernel.  For input codes x (N, H, W, C) int8,
// a k x k window at stride s with top/left pads (top, left) and the zero
// code z (the pad code: real 0 on the input's grid):
//
//   S[n, p, q] = sum_{dy, dx, c} (xpad[n, p*s - top + dy, q*s - left + dx, c] - z)
//   xpad = x inside the map, z outside it (so a pad adds 0)
//
// out is (N, Ho, Wo) int32.  A 1x1 window at stride s is a strided conv's
// subsampled codes, and the dense head is (M, 1, 1, K) at 1x1.  |S| <=
// k*k*C*255 stays far below 2^31 (and below 2^24, so its float32 value in
// the epilogue is exact) at every shape the port runs.
//
// Bound on an H100: bytes, x read once and 4 bytes an output written.  A
// window conv reads each input byte k*k/s^2 times (9 at 3x3/s1); the other
// reads come from L1 and L2.  Design: `group` lanes (a power of two up to
// 32, the host picks the least that covers a window's work, so a warp
// takes 32 / group outputs side by side) share one output: lane j of a
// group takes the window's (tap, 16-byte chunk) items j, j + group, ...;
// a chunk inside the map is one 16-byte load through the read-only path
// (C % 16 == 0) or byte loads (any other C, the stem's C = 3), its bytes
// summed by __dp4a against 0x01010101 (signed codes times +1).  Each lane
// counts the bytes it read, subtracts z for each, and the group adds its
// lanes' sums with shuffles.  Neighbouring groups read neighbouring pixels,
// so a warp's 16-byte loads are whole sectors at 1x1.  A grid-stride loop
// over whole warps keeps every lane of a warp in each shuffle.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct WindowArgs {
  const int8_t* x;
  int* out;
  int H, W, C, k, stride, top, left, Ho, Wo, z;
  int chunks;   // 16-byte chunks of a pixel, ceil(C / 16)
  int items;    // k * k * chunks: a window's work
  int group;    // lanes an output, a power of two <= 32
  int vec;      // 1: C % 16 == 0 and x 16-byte aligned, 16-byte loads
  unsigned outputs;   // N * Ho * Wo < 2^31
};

__global__ void __launch_bounds__(THREADS)
int8_window_sum_kernel(const WindowArgs g) {
  const int lane = threadIdx.x % 32;
  const int sub = lane % g.group;               // lane in its group
  const int per_warp = 32 / g.group;             // outputs a warp takes
  const unsigned warp =
      (blockIdx.x * THREADS + threadIdx.x) / 32;
  const unsigned warps = gridDim.x * (THREADS / 32);
  for (unsigned m0 = warp * per_warp; m0 < g.outputs;
       m0 += warps * per_warp) {
    const unsigned m = m0 + lane / g.group;
    int sum = 0, count = 0;
    if (m < g.outputs) {
      const int ox = m % g.Wo;
      const unsigned nh = m / g.Wo;
      const int oy = nh % g.Ho;
      const int n = nh / g.Ho;
      const int iy0 = oy * g.stride - g.top;
      const int ix0 = ox * g.stride - g.left;
      for (int i = sub; i < g.items; i += g.group) {
        const int tap = i / g.chunks;
        const int chunk = i - tap * g.chunks;
        const int iy = iy0 + tap / g.k;
        const int ix = ix0 + tap % g.k;
        if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) continue;
        const int8_t* p =
            g.x + ((static_cast<long long>(n) * g.H + iy) * g.W + ix) * g.C +
            16 * chunk;
        if (g.vec) {
          const int4 v = __ldg(reinterpret_cast<const int4*>(p));
          sum = __dp4a(v.x, 0x01010101, sum);
          sum = __dp4a(v.y, 0x01010101, sum);
          sum = __dp4a(v.z, 0x01010101, sum);
          sum = __dp4a(v.w, 0x01010101, sum);
          count += 16;
        } else {
          const int bytes = min(16, g.C - 16 * chunk);
          for (int j = 0; j < bytes; ++j) sum += __ldg(p + j);
          count += bytes;
        }
      }
    }
    sum -= g.z * count;
    for (int off = g.group / 2; off > 0; off /= 2)
      sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
    if (sub == 0 && m < g.outputs) g.out[m] = sum;
  }
}

}  // namespace

extern "C" {

// out (n, ho, wo) int32 from x (n, h, w, c) int8: the k x k window at
// `stride` with top/left pads, z outside the map, each code less z,
// summed.  n*ho*wo < 2^31 and k*k*ceil(c/16) < 2^31 (the wrapper checks
// them).  Launches on `stream`; returns cudaGetLastError().
int dlmcq_int8_window_sum(const void* x, void* out, int n, int h, int w,
                          int c, int k, int stride, int top, int left,
                          int ho, int wo, int z, void* stream) {
  const long long outputs = static_cast<long long>(n) * ho * wo;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || k <= 0 || stride <= 0 ||
      ho <= 0 || wo <= 0 || outputs >= 0x7FFFFFFF || top < 0 || left < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  WindowArgs g;
  g.x = static_cast<const int8_t*>(x);
  g.out = static_cast<int*>(out);
  g.H = h;
  g.W = w;
  g.C = c;
  g.k = k;
  g.stride = stride;
  g.top = top;
  g.left = left;
  g.Ho = ho;
  g.Wo = wo;
  g.z = z;
  g.chunks = (c + 15) / 16;
  const long long items = static_cast<long long>(k) * k * g.chunks;
  if (items >= 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  g.items = static_cast<int>(items);
  g.group = 1;
  while (g.group < 32 && g.group < g.items) g.group *= 2;
  g.vec = c % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.outputs = static_cast<unsigned>(outputs);
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const long long blocks = (outputs * g.group + THREADS - 1) / THREADS;
  const long long most = 8LL * sms;   // 8 blocks of 256 threads an SM
  const unsigned grid =
      static_cast<unsigned>(blocks < most ? blocks : most);
  int8_window_sum_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

const char* dlmcq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
