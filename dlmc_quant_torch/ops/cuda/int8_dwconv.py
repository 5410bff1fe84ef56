"""int8 depthwise 3×3 convolution with the folded requantize epilogue.

MobileNetV2's and MobileOne's depthwise convs on the chained int8 path.
The JAX package runs them as an XLA int8 conv at ``feature_group_count =
C`` on the pad-code-padded codes (``dlmc_quant_tpu/quant/layers.py:722-728``);
no Pallas kernel did.  The CUDA source is ``csrc/int8_dwconv3x3.cu``; its
header says what bounds it on an H100.  For input codes ``x`` (N, H, W, C)
int8 and a weight ``w`` (3, 3, 1, C) int8 (packed once by
:func:`pack_weight` as (9, C), the tap ``dy·3 + dx`` a row)::

    acc[n,p,q,c] = Σ_{dy,dx} xpad[n, p·s + dy, q·s + dx, c] · w[dy, dx, 0, c]   (int32)
    xpad         = x padded with the int8 code ``pad``: ``pad_lo`` rows and
                   columns at the top and left (1, or 0 for the SAME
                   geometry of a stride-2 conv on an even map), as many at
                   the bottom and right as the window needs; Ho = ⌈H/s⌉
    "codes": out = clamp(rint(f32(acc)·a[c] + b[c]), lo, hi) → int8 (N, Ho, Wo, C)
    "f32":   out = f32(acc)·a[c] + b[c], then max(·, 0) if relu → f32

The epilogue is :mod:`.epilogue`'s (no residual).  C must be a multiple of
16 (a thread's 16-byte chunk of channels).

:func:`int8_dwconv3x3` launches the kernel for CUDA tensors and runs
:func:`int8_dwconv3x3_plain` for CPU tensors; there is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda.epilogue import check_epilogue, epilogue_plain
from dlmc_quant_torch.ops.cuda.int8_conv import out_hw

GROUP = 16            # channels of a thread: one 16-byte chunk
MAX_C = 2880          # a, b and the weight (17 bytes a channel) in 48 KB
INT_LIMIT = 2 ** 31 - 1


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 1, C) int8 HWIO → (9, C) int8, a tap a row."""
    if w.dtype != torch.int8 or w.dim() != 4 \
            or tuple(w.shape[:3]) != (3, 3, 1):
        raise ValueError(f"expected (3, 3, 1, C) int8 weights, got "
                         f"{tuple(w.shape)} {w.dtype}")
    return w.reshape(9, w.shape[3]).contiguous()


def unpack_weight(wp: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_weight` → (3, 3, 1, C) int8."""
    return wp.reshape(3, 3, 1, wp.shape[1])


def _check(x, w, a, b, stride, pad, pad_lo, lo, hi, mode, relu):
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if pad_lo not in (0, 1) or (pad_lo == 0 and stride != 2):
        raise ValueError(f"pad_lo must be 1, or 0 at stride 2 (the SAME "
                         f"geometry of an even map), got {pad_lo!r} at "
                         f"stride {stride}")
    if not isinstance(pad, int) or not -128 <= pad <= 127:
        raise ValueError(f"pad must be an int8 code, got {pad!r}")
    if x.dtype != torch.int8 or x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"x must be non-empty (N, H, W, C) int8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, h, wd, c = x.shape
    if c % GROUP or c > MAX_C:
        raise ValueError(f"C = {c} must be a multiple of {GROUP} up to "
                         f"{MAX_C}")
    ho, wo = out_hw(h, wd, stride)
    if n * ho * wo * (c // GROUP) >= INT_LIMIT or n * h * wd >= INT_LIMIT:
        raise ValueError(f"x has too many pixels: {tuple(x.shape)}")
    if w.dtype != torch.int8 or tuple(w.shape) != (9, c):
        raise ValueError(f"w must be pack_weight() output of shape (9, {c}) "
                         f"int8, got {tuple(w.shape)} {w.dtype}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")
    check_epilogue("int8_dwconv3x3", mode, a, b, lo, hi, relu, None, 0.0,
                   (n, ho, wo, c), x.device)
    return n, h, wd, c, ho, wo


def int8_dwconv3x3_plain(x, w, a, b, *, stride: int, pad: int,
                         pad_lo: int = 1, lo: int = -128, hi: int = 127,
                         mode: str = "codes",
                         relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result):
    a float64 ``F.conv2d(groups=C)`` over the pad-code-padded input, exact
    because |acc| ≤ 9·128² ≪ 2⁵³, then :func:`.epilogue.epilogue_plain`."""
    n, h, wd, c, ho, wo = _check(x, w, a, b, stride, pad, pad_lo, lo, hi,
                                 mode, relu)
    pad_h = (ho - 1) * stride + 3 - h - pad_lo
    pad_w = (wo - 1) * stride + 3 - wd - pad_lo
    xp = F.pad(x.permute(0, 3, 1, 2).to(torch.float64),
               (pad_lo, max(pad_w, 0), pad_lo, max(pad_h, 0)),
               value=float(pad))
    wk = unpack_weight(w).permute(3, 2, 0, 1).to(torch.float64)
    acc = F.conv2d(xp, wk, stride=stride, groups=c)
    return epilogue_plain(acc.permute(0, 2, 3, 1), a, b, mode=mode, lo=lo,
                          hi=hi, relu=relu)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("int8_dwconv3x3")
    lib.dlmcq_int8_dwconv3x3.restype = ctypes.c_int
    lib.dlmcq_int8_dwconv3x3.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    return lib


def int8_dwconv3x3(x, w, a, b, *, stride: int, pad: int, pad_lo: int = 1,
                   lo: int = -128, hi: int = 127, mode: str = "codes",
                   relu: bool = False) -> torch.Tensor:
    """Run the int8 depthwise 3×3 conv (see the module docstring).

    ``x`` (N, H, W, C) int8, ``w`` from :func:`pack_weight`, ``a``/``b``
    (C,) float32, all contiguous and on one device.  CUDA tensors launch
    the kernel on the current stream and count the launch in
    ``int8_dwconv3x3.launches``; CPU tensors run the plain version.
    """
    n, h, wd, c, ho, wo = _check(x, w, a, b, stride, pad, pad_lo, lo, hi,
                                 mode, relu)
    if x.device.type == "cpu":
        return int8_dwconv3x3_plain(x, w, a, b, stride=stride, pad=pad,
                                    pad_lo=pad_lo, lo=lo, hi=hi, mode=mode,
                                    relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"int8_dwconv3x3 runs on cuda or cpu, not "
                         f"{x.device}")
    lib = _library()
    out = torch.empty((n, ho, wo, c), device=x.device,
                      dtype=torch.int8 if mode == "codes" else torch.float32)
    with torch.cuda.device(x.device):
        err = lib.dlmcq_int8_dwconv3x3(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, h, wd, c, stride, pad_lo, pad, lo, hi,
            int(mode == "codes"), int(relu),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "int8_dwconv3x3")
    int8_dwconv3x3.launches += 1
    return out


int8_dwconv3x3.launches = 0
