// The int8 depthwise conv's aligned 3x3 build, for Hopper (sm_90a): the 3x3
// window at C % 8 == 0 on 16-byte aligned codes and weight, the launches of
// MobileNetV2 and MobileOne and the 3x3 convs of GhostNet and EfficientNet
// at C % 8 == 0.  int8_dwconv.cuh holds the kernel, its design and bound
// and the C entry point; int8_dwconv5x5.cu is the wide build (the 5x5
// window, the ragged path), a library of its own, so that this one keeps
// only the aligned 3x3 instantiations.

#include "int8_dwconv.cuh"

namespace {

cudaError_t dispatch(const DwArgs& g, int k, int stride, bool codes,
                     bool term, bool ragged, int threads, int smem,
                     cudaStream_t s) {
  if (k == 3 && !ragged)
    return launch_window<3, false>(g, stride, codes, term, threads, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace
