"""Fused int8 3×3 convolution with a requantize epilogue.

The port of ``dlmc_quant_tpu/ops/pallas/rpconv.py:200`` (``int8_conv3x3_rm``,
body ``_rp_kernel`` at ``:142``), generalised to stride 2, any width and
channel count, and the folded-boundary epilogue of the chained int8 path.
The CUDA source is ``csrc/int8_conv3x3.cu`` (its header says what bounds
it on an H100 and how it is laid out).  :mod:`.build` compiles it with
``nvcc`` for ``sm_90a`` at first use, into ``_build/`` beside this file, as
a shared library with a plain C interface loaded through ``ctypes``.

For input codes ``x`` (N, H, W, C) int8 and weights ``w`` (3, 3, C, O) int8
(packed once by :func:`pack_weight`)::

    acc[n,p,q,o] = Σ_{dy,dx,c} xpad[n, p·s+dy, q·s+dx, c] · w[dy,dx,c,o]     (int32)
    xpad         = x padded by 1 on each side with the int8 code ``pad``
    "codes": out = clamp(rint(f32(acc)·a[o] + b[o]), lo, hi) → int8 (N, Ho, Wo, O)
    "f32":   out = f32(acc)·a[o] + b[o], then max(·, 0) if relu → f32

:func:`int8_conv3x3` launches the kernel for CUDA tensors and runs
:func:`int8_conv3x3_plain` for CPU tensors; there is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dlmc_quant_torch.ops.cuda import build

KC = 16   # K words (4 input channels each) per step; the kernel's KC
TO = 64   # output channels per block; the kernel's TO
MODES = ("codes", "f32")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def packed_shape(c: int, o: int):
    """(Kp, Op) of the packed weight for C input and O output channels."""
    return _cdiv(9 * _cdiv(c, 4), KC) * KC, _cdiv(o, TO) * TO


def out_hw(h: int, w: int, stride: int):
    """Output spatial size of the padded 3×3 conv."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, O) int8 HWIO → (Kp, Op) int32 words of 4 input channels.

    Row ``k = (3·dy + dx)·ceil(C/4) + c4`` holds channels ``4·c4 .. 4·c4+3``
    of tap (dy, dx), lowest channel in the lowest byte; the rows past
    ``9·ceil(C/4)``, the columns past O and the bytes past C are zero.
    """
    if w.dtype != torch.int8 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"expected (3, 3, C, O) int8 weights, got "
                         f"{tuple(w.shape)} {w.dtype}")
    _, _, c, o = w.shape
    c4 = _cdiv(c, 4)
    wp = torch.zeros((9, c4 * 4, o), dtype=torch.int8, device=w.device)
    wp[:, :c] = w.reshape(9, c, o)
    words = wp.reshape(9, c4, 4, o).permute(0, 1, 3, 2).contiguous()
    words = words.view(torch.int32).reshape(9 * c4, o)
    kp, op = packed_shape(c, o)
    return F.pad(words, (0, op - o, 0, kp - 9 * c4)).contiguous()


def unpack_weight(wp: torch.Tensor, c: int, o: int) -> torch.Tensor:
    """Inverse of :func:`pack_weight` → (3, 3, C, O) int8."""
    c4 = _cdiv(c, 4)
    words = wp[:9 * c4, :o].reshape(9, c4, o).permute(0, 2, 1).contiguous()
    codes = words.view(torch.int8).reshape(9, o, c4 * 4)[:, :, :c]
    return codes.permute(0, 2, 1).reshape(3, 3, c, o).contiguous()


def _check(x, w, a, b, stride, pad, lo, hi, mode, relu):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "codes" and relu:
        raise ValueError("codes mode folds the ReLU into lo; relu is for f32")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    for name, v in (("pad", pad), ("lo", lo), ("hi", hi)):
        if not isinstance(v, int) or not -128 <= v <= 127:
            raise ValueError(f"{name} must be an int8 code, got {v!r}")
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C) int8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, h, wd, c = x.shape
    if n * h * wd * c == 0:
        raise ValueError(f"x is empty: {tuple(x.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32 \
            or a.dim() != 1 or a.shape != b.shape:
        raise ValueError("a and b must be (O,) float32")
    o = a.shape[0]
    if w.dtype != torch.int32 or tuple(w.shape) != packed_shape(c, o):
        raise ValueError(f"w must be pack_weight() output of shape "
                         f"{packed_shape(c, o)} int32, got "
                         f"{tuple(w.shape)} {w.dtype}")
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if c % 4 == 0 and x.data_ptr() % 4:
        raise ValueError("x must be 4-byte aligned when C % 4 == 0")


def int8_conv3x3_plain(x, w, a, b, *, stride: int, pad: int, lo: int = -128,
                       hi: int = 127, mode: str = "codes",
                       relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result).

    ``acc`` is a float64 ``F.conv2d`` over the pad-code-padded input, exact
    because |acc| ≤ 9·C·128² ≪ 2⁵³; the epilogue runs in float32 as two
    separate ops, so nothing fuses them into an fma.
    """
    c, o = x.shape[-1], a.shape[0]
    wk = unpack_weight(w, c, o)
    xp = F.pad(x.permute(0, 3, 1, 2).to(torch.float64), (1, 1, 1, 1),
               value=float(pad))
    acc = F.conv2d(xp, wk.permute(3, 2, 0, 1).to(torch.float64),
                   stride=stride)
    y = acc.permute(0, 2, 3, 1).to(torch.float32) * a
    y = y + b
    if mode == "codes":
        return torch.round(y).clamp_(lo, hi).to(torch.int8).contiguous()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.contiguous()


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("int8_conv3x3")
    lib.dlmcq_int8_conv3x3.restype = ctypes.c_int
    lib.dlmcq_int8_conv3x3.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    for fn, want in ((lib.dlmcq_int8_conv3x3_kc, KC),
                     (lib.dlmcq_int8_conv3x3_to, TO)):
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"kernel tile {fn.__name__}={fn()} does not "
                               f"match the packing constant {want}")
    return lib


def int8_conv3x3(x, w, a, b, *, stride: int, pad: int, lo: int = -128,
                 hi: int = 127, mode: str = "codes",
                 relu: bool = False) -> torch.Tensor:
    """Run the fused int8 3×3 conv (see the module docstring).

    ``x`` (N, H, W, C) int8, ``w`` from :func:`pack_weight`, ``a``/``b`` (O,)
    float32, all contiguous and on one device.  CUDA tensors launch the
    kernel on the current stream (and count the launch in
    ``int8_conv3x3.launches``); CPU tensors run the plain version.
    """
    _check(x, w, a, b, stride, pad, lo, hi, mode, relu)
    if x.device.type == "cpu":
        return int8_conv3x3_plain(x, w, a, b, stride=stride, pad=pad, lo=lo,
                                  hi=hi, mode=mode, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv3x3 runs on cuda or cpu, not {x.device}")
    lib = _library()
    n, h, wd, c = x.shape
    o = a.shape[0]
    ho, wo = out_hw(h, wd, stride)
    out = torch.empty((n, ho, wo, o), device=x.device,
                      dtype=torch.int8 if mode == "codes" else torch.float32)
    with torch.cuda.device(x.device):
        err = lib.dlmcq_int8_conv3x3(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, h, wd, c, o, w.shape[1], stride, pad, lo, hi,
            int(mode == "codes"), int(relu),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "int8_conv3x3")
    int8_conv3x3.launches += 1
    return out


int8_conv3x3.launches = 0
