// The int8 depthwise conv's aligned 3x3 build, for Hopper (sm_90a): the 3x3
// window at C % 8 == 0 on 16-byte aligned codes and weight, the launches of
// MobileNetV2 and MobileOne and the 3x3 convs of GhostNet and EfficientNet
// at C % 8 == 0, and the 1x1 window's codes on that path (granules of 16
// or 8 channels; f32 takes the wide build's granules of 4).  int8_dwconv.cuh holds the
// kernels, their design and bound and the C entry point;
// int8_dwconv5x5.cu is the wide build (the 5x5 window, the ragged path), a
// library of its own, so that this one keeps only the aligned
// instantiations.

#include "int8_dwconv.cuh"

namespace {

cudaError_t dispatch(const DwArgs& g, int k, int stride, bool codes,
                     bool term, bool ragged, int threads, int smem,
                     cudaStream_t s) {
  if (k == 3 && !ragged)
    return launch_window<3, false>(g, stride, codes, term, threads, smem, s);
  if (k == 1 && !ragged)
    return g.granule == 16
               ? launch_window_1x1<16>(g, codes, term, threads, s)
               : launch_window_1x1<8>(g, codes, term, threads, s);
  return cudaErrorInvalidValue;
}

}  // namespace
