"""int8 window sums: the row term of a layer whose weight grid has an
offset.

A weight on the grid ``q·s_w + o_w`` (RootQ's after QAT, an offset LSQ
weight) adds ``s_x·o_w[o]·S[m]`` to the integer conv's output, ``S[m]``
the sum of the input codes less the zero code over the window of output
``m`` (``quant/layers.py``, ROADMAP item 13); the conv's and the GEMM's
epilogues add it per output channel (``ops/cuda/epilogue.py``).  The JAX
package drops ``o_w`` in its integer plan (ROADMAP hazard C1), so no TPU
kernel did this.  The CUDA source is ``csrc/int8_window_sum.cu``; its
header says what bounds it on an H100.  For input codes ``x`` (N, H, W, C)
int8, a k × k window at ``stride`` with pads ``((top, bottom), (left,
right))`` and the zero code ``zero`` (the pad code)::

    S[n, p, q] = Σ_{dy, dx, c} (xpad[n, p·s − top + dy, q·s − left + dx, c] − zero)
    xpad = x padded with ``zero``: a pad adds 0
    Ho = (H + top + bottom − k) // s + 1

``S`` is (N, Ho, Wo) int32.  The window is read from the NHWC codes, never
from a GEMM's rows: ``int8_gemm.pad_k`` fills their K tail with code 0,
not ``zero``.  A 1×1 window at stride s is a strided 1×1 conv's subsampled
input, and a dense layer's (M, K) input is (M, 1, 1, K) at 1×1.

:func:`int8_window_sum` launches the kernel for CUDA tensors and runs
:func:`int8_window_sum_plain` for CPU tensors; there is no fallback from
one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda.int8_im2col import out_hw

INT_LIMIT = 2 ** 31 - 1


def _check(x, zero, kernel, stride, pads):
    if x.dtype != torch.int8 or x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"x must be non-empty (N, H, W, C) int8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not isinstance(zero, int) or not -128 <= zero <= 127:
        raise ValueError(f"zero must be an int8 code, got {zero!r}")
    if not (isinstance(kernel, int) and kernel >= 1
            and isinstance(stride, int) and stride >= 1):
        raise ValueError(f"bad window: kernel {kernel!r}, stride {stride!r}")
    if any(p < 0 for pair in pads for p in pair):
        raise ValueError(f"pads must be >= 0, got {pads}")
    n, h, w, c = x.shape
    ho, wo = out_hw(h, w, kernel, stride, pads)
    if ho < 1 or wo < 1:
        raise ValueError(f"the window does not fit: {tuple(x.shape)}, "
                         f"kernel {kernel}, pads {pads}")
    if n * ho * wo >= INT_LIMIT:
        raise ValueError(f"x has too many outputs: {tuple(x.shape)}")
    return n, h, w, c, ho, wo


def int8_window_sum_plain(x: torch.Tensor, *, zero: int, kernel: int = 1,
                          stride: int = 1,
                          pads=((0, 0), (0, 0))) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result):
    the channel sums of ``x − zero`` in float64, padded with 0, then a
    float64 ``F.conv2d`` with a window of ones, exact (every partial sum is
    an integer below 2⁵³)."""
    _, _, _, _, ho, wo = _check(x, zero, kernel, stride, pads)
    (top, bottom), (left, right) = pads
    pixels = (x.to(torch.float64) - zero).sum(dim=-1)[:, None]
    pixels = F.pad(pixels, (left, right, top, bottom))
    ones = torch.ones((1, 1, kernel, kernel), dtype=torch.float64,
                      device=x.device)
    s = F.conv2d(pixels, ones, stride=stride)[:, 0, :ho, :wo]
    return s.to(torch.int32).contiguous()


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("int8_window_sum")
    lib.dlmcq_int8_window_sum.restype = ctypes.c_int
    lib.dlmcq_int8_window_sum.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    return lib


def int8_window_sum(x: torch.Tensor, *, zero: int, kernel: int = 1,
                    stride: int = 1, pads=((0, 0), (0, 0))) -> torch.Tensor:
    """(N, Ho, Wo) int32 window sums of ``x − zero`` (module docstring).

    CUDA tensors launch the kernel on the current stream and count the
    launch in ``int8_window_sum.launches``; CPU tensors run the plain
    version.
    """
    n, h, w, c, ho, wo = _check(x, zero, kernel, stride, pads)
    if x.device.type == "cpu":
        return int8_window_sum_plain(x, zero=zero, kernel=kernel,
                                     stride=stride, pads=pads)
    if x.device.type != "cuda":
        raise ValueError(f"int8_window_sum runs on cuda or cpu, not "
                         f"{x.device}")
    (top, _), (left, _) = pads
    lib = _library()
    out = torch.empty((n, ho, wo), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.dlmcq_int8_window_sum(
            x.data_ptr(), out.data_ptr(), n, h, w, c, kernel, stride, top,
            left, ho, wo, zero,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "int8_window_sum")
    int8_window_sum.launches += 1
    return out


int8_window_sum.launches = 0
