"""int8 im2col: a conv's windows as the rows of the int8 GEMM's A operand.

With :func:`~dlmc_quant_torch.ops.cuda.int8_gemm.int8_gemm` this runs the
integer conv that the 3×3 kernel does not take: the ImageNet ResNets'
7×7/s2 stem, which the JAX package left to XLA
(``dlmc_quant_tpu/quant/layers.py:721-728``).  The CUDA source is
``csrc/int8_im2col.cu``; its header says what bounds it on an H100.  For
input codes ``x`` (N, H, W, C) int8, a k × k window at ``stride`` and pads
``((top, bottom), (left, right))``::

    out[(n, p, q), (dy·k + dx)·C + c] = xpad[n, p·s − top + dy, q·s − left + dx, c]
    xpad = x padded with the int8 code ``pad`` (real 0 on the input grid)
    out[:, K:Kp] = 0,  K = k·k·C,  Kp = roundup(K, 32)

``out`` is (N·Ho·Wo, Kp) int8, Ho = (H + top + bottom − k) // s + 1: the A
operand of ``int8_gemm`` against a weight packed by :func:`pack_weight`
(K ordered (dy, dx, c), zero past K), so the GEMM gives the conv's int32
accumulator, or its epilogue.

:func:`int8_im2col` launches the kernel for CUDA tensors and runs
:func:`int8_im2col_plain` for CPU tensors; there is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda.int8_gemm import pack_b, packed_k
from dlmc_quant_torch.ops.cuda.nibbles import pack_nibbles

MAX_KP = 2048          # bytes of a row the kernel's table covers


def out_hw(h: int, w: int, kernel: int, stride: int, pads):
    """Output size of the padded conv."""
    (top, bottom), (left, right) = pads
    return ((h + top + bottom - kernel) // stride + 1,
            (w + left + right - kernel) // stride + 1)


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(k, k, C, O) int8 HWIO → the GEMM's packed (O, Kp) int8, K ordered
    (dy, dx, c) as :func:`int8_im2col` writes a row, zero past K."""
    if w.dtype != torch.int8 or w.dim() != 4 or w.shape[0] != w.shape[1]:
        raise ValueError(f"expected (k, k, C, O) int8 weights, got "
                         f"{tuple(w.shape)} {w.dtype}")
    k, _, c, o = w.shape
    kk = k * k * c
    wk = torch.zeros((packed_k(kk), o), dtype=torch.int8, device=w.device)
    wk[:kk] = w.reshape(kk, o)
    return pack_b(wk)


def pack_weight_int4(w: torch.Tensor) -> torch.Tensor:
    """(k, k, C, O) int8 HWIO in [-8, 7] → the GEMM's nibble-packed (O,
    Kp/2) uint8 (``int8_gemm.pack_b_int4`` of the same rows)."""
    return pack_nibbles(pack_weight(w))


def _check(x, kernel, stride, pads, pad):
    if x.dtype != torch.int8 or x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"x must be non-empty (N, H, W, C) int8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not isinstance(pad, int) or not -128 <= pad <= 127:
        raise ValueError(f"pad must be an int8 code, got {pad!r}")
    if not (isinstance(kernel, int) and 1 <= kernel < 255
            and isinstance(stride, int) and stride >= 1):
        raise ValueError(f"bad window: kernel {kernel!r}, stride {stride!r}")
    if any(p < 0 for pair in pads for p in pair):
        raise ValueError(f"pads must be >= 0, got {pads}")
    n, h, w, c = x.shape
    ho, wo = out_hw(h, w, kernel, stride, pads)
    kp = packed_k(kernel * kernel * c)
    if ho < 1 or wo < 1:
        raise ValueError(f"the window does not fit: {tuple(x.shape)}, "
                         f"kernel {kernel}, pads {pads}")
    if kp > MAX_KP or n * ho * wo * (kp // 16) >= 2 ** 31 - 1:
        raise ValueError(f"im2col of {tuple(x.shape)} at kernel {kernel} is "
                         "too large for the kernel's 32-bit indices or table")
    return n, h, w, c, ho, wo, kp


def int8_im2col_plain(x: torch.Tensor, *, kernel: int, stride: int, pads,
                      pad: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result)."""
    n, h, w, c, ho, wo, kp = _check(x, kernel, stride, pads, pad)
    (top, bottom), (left, right) = pads
    xp = x.new_full((n, h + top + bottom, w + left + right, c), pad)
    xp[:, top:top + h, left:left + w] = x
    # (N, Ho, Wo, C, dy, dx) windows → rows ordered (dy, dx, c)
    cols = xp.unfold(1, kernel, stride).unfold(2, kernel, stride)
    cols = cols[:, :ho, :wo].permute(0, 1, 2, 4, 5, 3).reshape(
        n * ho * wo, kernel * kernel * c)
    out = x.new_zeros((n * ho * wo, kp))
    out[:, :cols.shape[1]] = cols
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("int8_im2col")
    lib.dlmcq_int8_im2col.restype = ctypes.c_int
    lib.dlmcq_int8_im2col.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    return lib


def int8_im2col(x: torch.Tensor, *, kernel: int, stride: int, pads,
                pad: int) -> torch.Tensor:
    """(N·Ho·Wo, Kp) int8 rows of ``x``'s windows (module docstring).

    CUDA tensors launch the kernel on the current stream and count the
    launch in ``int8_im2col.launches``; CPU tensors run the plain version.
    """
    n, h, w, c, ho, wo, kp = _check(x, kernel, stride, pads, pad)
    if x.device.type == "cpu":
        return int8_im2col_plain(x, kernel=kernel, stride=stride, pads=pads,
                                 pad=pad)
    if x.device.type != "cuda":
        raise ValueError(f"int8_im2col runs on cuda or cpu, not {x.device}")
    (top, _), (left, _) = pads
    lib = _library()
    out = torch.empty((n * ho * wo, kp), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.dlmcq_int8_im2col(
            x.data_ptr(), out.data_ptr(), n, h, w, c, kernel, kernel, stride,
            top, left, ho, wo, kp, pad,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "int8_im2col")
    int8_im2col.launches += 1
    return out


int8_im2col.launches = 0
