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
// out is (N, Ho, Wo) int32.  In G > 1 groups (a grouped conv's, C = G Cg)
// the sum runs over each group's Cg channels apart, out (N, Ho, Wo, G):
//
//   S[n, p, q, g] = sum_{dy, dx, c < Cg} (xpad[..., g Cg + c] - z)
//
// A 1x1 window at stride s is a strided conv's
// subsampled codes, and the dense head is (M, 1, 1, K) at 1x1.  |S| <=
// k*k*C*255 stays far below 2^31 (and below 2^24, so its float32 value in
// the epilogue is exact) at every shape the port runs.
//
// Bound on an H100: bytes, the pixels the windows touch read once (all of
// x, but a strided 1x1's subsample) and 4 bytes an output written.  A
// window reads each input pixel k*k/s^2 times, so the design reads each
// pixel once and sums windows of pixel sums:
// - A block takes a tile of outputs of one image, th rows by tw columns
//   (the full width where it fits; ops/cuda/int8_window_sum.py: plan picks
//   them per shape).  The tile touches a region of pixels, which the block
//   first reduces to one int32 each, sum_c x - C*z, into shared memory;
//   a cell outside the map is 0, so the pads need no test later.  Where
//   k < s only the touched pixels are kept, packed ("compact" rows and
//   columns: window p covers compact rows p*k .. p*k + k - 1), so a 1x1 at
//   stride 2 reads a quarter of x.
// - The pixel reduction: `lanes` lanes (a power of two up to 32) take one
//   pixel, lane j its 16-byte chunks j, j + lanes, ...; neighbouring groups
//   take neighbouring pixels, so a warp's loads cover runs of whole
//   sectors.  Each lane issues up to 4 of its chunks before it sums them
//   (__dp4a against 0x01010101: signed codes times +1), then each group
//   adds its lanes' sums by shuffles.  The group's pixel coordinates step
//   without a division.  The plan gives a lane about 4 to 8 chunks (one
//   lane a pixel below C = 128): on an H100 fewer lanes a pixel, with
//   fewer shuffles and index steps a byte, beat more loads in flight from
//   more pixels a group.  C % 16 != 0 (the stem's C = 3) reads bytes:
//   right, not fast.
// - The box sum from shared memory, separably: sums over dx of k columns
//   at the stride, then over dy of k of those rows, one int32 an output
//   written coalesced.  At k = 1 the pixel sums go straight out.  Only the
//   halo rows of a tile are read by two blocks (the second time from L2).
// - A 1x1 window at stride 1 without pads is a flat run of pixels: the
//   plan sees (N, H, W) as (1, 1, N*H*W), so its tiles need not follow rows.
// - In G > 1 groups (GROUPED, an instantiation of its own, so that the
//   ungrouped kernel keeps its code): the reduction's unit is a (pixel,
//   group), group fastest, a lane group summing that group's Cg channels
//   (16-byte chunks where Cg % 16 == 0, 8-byte ones where Cg % 8 == 0:
//   RepVGG-B2g4's Cg = 40; else bytes); shared memory holds G
//   sums a pixel, and the box sums run per group, G adjacent outputs of a
//   pixel written by adjacent threads.  RepVGG-B2g4's 13 grouped 3x3 sums
//   at batch 64 take 0.158 ms against a 0.056 ms bound on an H100 80GB
//   HBM3 at 700 W (a division a unit, 8-byte loads at Cg = 40).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SMEM = 48 * 1024;   // no opt-in attribute needed

struct WindowArgs {
  const int8_t* x;
  int* out;
  int H, W, C, k, stride, top, left, Ho, Wo, z;
  int th, tw;              // output rows and columns of a tile
  int tiles_y, tiles_x;
  int se;                  // the box sum's stride in shared memory, min(s, k)
  int lanes;               // lanes a pixel, a power of two <= 32
  int chunks;              // 16-byte chunks of a pixel, ceil(C / 16)
  int G, Cg;               // groups and channels a group (GROUPED)
};

// region coordinate of compact coordinate i (k < s: only the touched
// rows and columns are kept)
__device__ __forceinline__ int region(int i, int k, int s) {
  return k >= s ? i : k == 1 ? i * s : (i / k) * s + i % k;
}

// GROUPED: the (pixel, group) sums, the box sums per group (see the
// header); VEC the bytes a load: 16, 8 or 1
template <int VEC>
__device__ void grouped_sums(const WindowArgs& g, int* pix, int n, int p0,
                             int q0, int th, int tw, int rh, int rw,
                             int iy0, int ix0) {
  const int items = rh * rw * g.G;
  const int lane = threadIdx.x & (g.lanes - 1);
  const int group = threadIdx.x / g.lanes;
  const int groups = THREADS / g.lanes;
  const int8_t* image = g.x + static_cast<long long>(n) * g.H * g.W * g.C;
  for (int base = 0; base < items; base += groups) {
    const int i = base + group;
    const int pixel = i / g.G, gg = i - pixel * g.G;
    const int cr = pixel / rw, cc = pixel - cr * rw;
    const int iy = iy0 + region(cr, g.k, g.stride);
    const int ix = ix0 + region(cc, g.k, g.stride);
    const bool ok = i < items && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    const int8_t* src =
        image + (ok ? static_cast<long long>(iy * g.W + ix) * g.C +
                          gg * g.Cg
                    : 0);
    int acc = 0;
    if constexpr (VEC == 16) {
      for (int ch = lane; ch < g.chunks; ch += g.lanes) {
        const int4 v = ok ? __ldg(reinterpret_cast<const int4*>(src) + ch)
                          : make_int4(0, 0, 0, 0);
        acc = __dp4a(v.x, 0x01010101, acc);
        acc = __dp4a(v.y, 0x01010101, acc);
        acc = __dp4a(v.z, 0x01010101, acc);
        acc = __dp4a(v.w, 0x01010101, acc);
      }
    } else if constexpr (VEC == 8) {
      for (int ch = lane; ch < g.Cg / 8; ch += g.lanes) {
        const int2 v = ok ? __ldg(reinterpret_cast<const int2*>(src) + ch)
                          : make_int2(0, 0);
        acc = __dp4a(v.x, 0x01010101, acc);
        acc = __dp4a(v.y, 0x01010101, acc);
      }
    } else if (ok) {
      for (int ch = lane; ch < g.chunks; ch += g.lanes) {
        const int bytes = min(16, g.Cg - 16 * ch);
        for (int j = 0; j < bytes; ++j) acc += __ldg(src + 16 * ch + j);
      }
    }
    for (int off = g.lanes / 2; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
    if (lane == 0 && i < items) pix[i] = ok ? acc - g.Cg * g.z : 0;
  }
  __syncthreads();
  int* out = g.out + ((static_cast<long long>(n) * g.Ho + p0) * g.Wo + q0) *
                         g.G;
  if (g.k == 1) {
    for (int i = threadIdx.x; i < th * tw * g.G; i += THREADS) {
      const int pq = i / g.G, gg = i - pq * g.G;
      const int p = pq / tw, q = pq - p * tw;
      out[(static_cast<long long>(p) * g.Wo + q) * g.G + gg] =
          pix[(p * rw + q) * g.G + gg];
    }
    return;
  }
  int* rows = pix + rh * rw * g.G;
  for (int i = threadIdx.x; i < rh * tw * g.G; i += THREADS) {
    const int rq = i / g.G, gg = i - rq * g.G;
    const int r = rq / tw, q = rq - r * tw;
    const int* c = pix + (r * rw + q * g.se) * g.G + gg;
    int s = 0;
    for (int dx = 0; dx < g.k; ++dx) s += c[dx * g.G];
    rows[i] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < th * tw * g.G; i += THREADS) {
    const int pq = i / g.G, gg = i - pq * g.G;
    const int p = pq / tw, q = pq - p * tw;
    const int* c = rows + (p * g.se * tw + q) * g.G + gg;
    int s = 0;
    for (int dy = 0; dy < g.k; ++dy) s += c[dy * tw * g.G];
    out[(static_cast<long long>(p) * g.Wo + q) * g.G + gg] = s;
  }
}

// VEC: the bytes a load, 16 or 1 (and 8 in GROUPED)
template <int VEC, bool GROUPED>
__global__ void __launch_bounds__(THREADS)
int8_window_sum_kernel(const WindowArgs g) {
  extern __shared__ int pix[];
  unsigned t = blockIdx.x;
  const int tx = t % g.tiles_x;
  t /= g.tiles_x;
  const int ty = t % g.tiles_y;
  const int n = t / g.tiles_y;
  const int p0 = ty * g.th, q0 = tx * g.tw;
  const int th = min(g.th, g.Ho - p0), tw = min(g.tw, g.Wo - q0);
  const int rh = (th - 1) * g.se + g.k, rw = (tw - 1) * g.se + g.k;
  const int iy0 = p0 * g.stride - g.top, ix0 = q0 * g.stride - g.left;
  if constexpr (GROUPED) {
    grouped_sums<VEC>(g, pix, n, p0, q0, th, tw, rh, rw, iy0, ix0);
    return;
  }
  const int npix = rh * rw;
  const int lane = threadIdx.x & (g.lanes - 1);
  const int group = threadIdx.x / g.lanes;
  const int groups = THREADS / g.lanes;
  const int8_t* image = g.x + static_cast<long long>(n) * g.H * g.W * g.C;

  // 1. pixel sums of the region, a pixel a group at a time.  The loop
  // counts on `base`, which is uniform over the block (so every lane of a
  // warp reaches the shuffles, and the loop needs no reconvergence: a
  // per-thread counter cost 12 % on an H100).  (cr, cc): compact
  // coordinates of the group's pixel, stepped by `groups` pixels without
  // a division
  int cr = group / rw, cc = group - (group / rw) * rw;
  const int dr = groups / rw, dc = groups - (groups / rw) * rw;
  for (int base = 0; base < npix; base += groups) {
    const int i = base + group;
    const int iy = iy0 + region(cr, g.k, g.stride);
    const int ix = ix0 + region(cc, g.k, g.stride);
    const bool ok = i < npix && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    const int8_t* src =
        image + static_cast<long long>(ok ? iy * g.W + ix : 0) * g.C;
    cc += dc;
    cr += dr;
    if (cc >= rw) {
      cc -= rw;
      ++cr;
    }
    int acc = 0;
    if (VEC == 16) {
      for (int ch0 = lane; ch0 < g.chunks; ch0 += 4 * g.lanes) {
        int4 v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = ch0 + e * g.lanes;
          v[e] = ok && ch < g.chunks
                     ? __ldg(reinterpret_cast<const int4*>(src) + ch)
                     : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc = __dp4a(v[e].x, 0x01010101, acc);
          acc = __dp4a(v[e].y, 0x01010101, acc);
          acc = __dp4a(v[e].z, 0x01010101, acc);
          acc = __dp4a(v[e].w, 0x01010101, acc);
        }
      }
    } else if (ok) {
      for (int ch = lane; ch < g.chunks; ch += g.lanes) {
        const int bytes = min(16, g.C - 16 * ch);
        for (int j = 0; j < bytes; ++j) acc += __ldg(src + 16 * ch + j);
      }
    }
    for (int off = g.lanes / 2; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
    if (lane == 0 && i < npix) pix[i] = ok ? acc - g.C * g.z : 0;
  }
  __syncthreads();

  int* out = g.out + (static_cast<long long>(n) * g.Ho + p0) * g.Wo + q0;
  if (g.k == 1) {                       // se = 1: the sums are the outputs
    for (int i = threadIdx.x; i < th * tw; i += THREADS) {
      const int p = i / tw, q = i - p * tw;
      out[static_cast<long long>(p) * g.Wo + q] = pix[p * rw + q];
    }
    return;
  }
  // 2. sums over dx: rh rows of tw, after the region
  int* rows = pix + npix;
  for (int i = threadIdx.x; i < rh * tw; i += THREADS) {
    const int r = i / tw, q = i - r * tw;
    const int* c = pix + r * rw + q * g.se;
    int s = 0;
    for (int dx = 0; dx < g.k; ++dx) s += c[dx];
    rows[i] = s;
  }
  __syncthreads();
  // 3. sums over dy, one output each
  for (int i = threadIdx.x; i < th * tw; i += THREADS) {
    const int p = i / tw, q = i - p * tw;
    const int* c = rows + p * g.se * tw + q;
    int s = 0;
    for (int dy = 0; dy < g.k; ++dy) s += c[dy * tw];
    out[static_cast<long long>(p) * g.Wo + q] = s;
  }
}

}  // namespace

extern "C" {

// out (n, ho, wo) int32 from x (n, h, w, c) int8: the k x k window at
// `stride` with top/left pads, z outside the map, each code less z,
// summed; in groups > 1 groups out (n, ho, wo, groups), each group's
// c / groups channels apart.  The tile plan (th, tw, lanes) comes from
// the wrapper (int8_window_sum.py: plan); the launch refuses one whose
// shared memory exceeds 48 KB.  Launches on `stream`; returns
// cudaGetLastError().
int dlmcq_int8_window_sum(const void* x, void* out, int n, int h, int w,
                          int c, int k, int stride, int top, int left,
                          int ho, int wo, int z, int th, int tw, int lanes,
                          int groups, void* stream) {
  const long long outputs = static_cast<long long>(n) * ho * wo * groups;
  if (groups < 1 || c % groups != 0 ||
      n <= 0 || h <= 0 || w <= 0 || c <= 0 || k <= 0 || stride <= 0 ||
      ho <= 0 || wo <= 0 || outputs >= 0x7FFFFFFF || top < 0 || left < 0 ||
      th <= 0 || tw <= 0 || lanes <= 0 || lanes > 32 ||
      (lanes & (lanes - 1)) || static_cast<long long>(h) * w >= 0x7FFFFFFF)
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
  g.th = th < ho ? th : ho;
  g.tw = tw < wo ? tw : wo;
  g.tiles_y = (ho + g.th - 1) / g.th;
  g.tiles_x = (wo + g.tw - 1) / g.tw;
  g.se = stride < k ? stride : k;
  g.lanes = lanes;
  g.G = groups;
  g.Cg = c / groups;
  g.chunks = (g.Cg + 15) / 16;
  const long long rh = static_cast<long long>(g.th - 1) * g.se + k;
  const long long rw = static_cast<long long>(g.tw - 1) * g.se + k;
  const long long smem = 4 * groups * (rh * rw + (k > 1 ? rh * g.tw : 0));
  const long long tiles =
      static_cast<long long>(n) * g.tiles_y * g.tiles_x;
  if (smem > MAX_SMEM || tiles >= 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t at = reinterpret_cast<uintptr_t>(x);
  const bool vec = g.Cg % 16 == 0 && at % 16 == 0;
  const unsigned grid = static_cast<unsigned>(tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups > 1) {
    if (vec)
      int8_window_sum_kernel<16, true><<<grid, THREADS, smem, st>>>(g);
    else if (g.Cg % 8 == 0 && at % 8 == 0)
      int8_window_sum_kernel<8, true><<<grid, THREADS, smem, st>>>(g);
    else
      int8_window_sum_kernel<1, true><<<grid, THREADS, smem, st>>>(g);
  } else if (vec) {
    int8_window_sum_kernel<16, false><<<grid, THREADS, smem, st>>>(g);
  } else {
    int8_window_sum_kernel<1, false><<<grid, THREADS, smem, st>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dlmcq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
