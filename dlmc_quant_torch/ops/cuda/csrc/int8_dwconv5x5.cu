// The depthwise conv's 5x5 window (any C) and the ragged path of the 3x3
// window (C % 8 != 0, or codes that are not 16-byte aligned):
// int8_dwconv3x3.cu built with DLMCQ_DW_WIDE set, as a library of its own,
// so that the 3x3 build keeps only the aligned 3x3 instantiations.  Same C
// interface; it takes k = 5, and k = 3 on the ragged path only.
#define DLMCQ_DW_WIDE 1
#include "int8_dwconv3x3.cu"
