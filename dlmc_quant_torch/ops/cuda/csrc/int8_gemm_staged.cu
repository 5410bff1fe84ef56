// The int8 GEMM's staged route (int8_gemm.cu's header: the residual staged
// by TMA into shared memory, the output stored through it): int8_gemm.cu
// built with DLMCQ_GEMM_STAGED set, as a library of its own, so that the
// register route's build keeps its instantiations as they were and the two
// compile side by side.  Same C interface, at the staged tiles; it takes
// the launches whose output and r rows TMA can describe (int8_gemm.py:
// route).
#define DLMCQ_GEMM_STAGED 1
#include "int8_gemm.cu"
