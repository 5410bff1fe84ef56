// The grouped int8 3x3 conv (1 < groups < C: RepVGG's g2/g4 variants):
// int8_conv3x3.cu built with its group code in, as a library of its own,
// so that the ungrouped build keeps none of it.  Same C interface; it
// takes groups > 1 only, with or without a row term (S one sum a group).
#define DLMCQ_CONV_GROUPED 1
#include "int8_conv3x3.cu"
