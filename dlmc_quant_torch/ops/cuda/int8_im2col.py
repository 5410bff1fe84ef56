"""int8 im2col: a conv's windows as the rows of the int8 GEMM's A operand.

With :func:`~dlmc_quant_torch.ops.cuda.int8_gemm.int8_gemm` this runs the
integer conv that the 3×3 kernel does not take: the ImageNet ResNets'
7×7/s2 stem, which the JAX package left to XLA
(``dlmc_quant_tpu/quant/layers.py:721-728``).  The CUDA source is
``csrc/int8_im2col.cu``; its header says what bounds it on an H100 and how
its tiles work; :func:`plan` picks the tiles per shape.  For
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

import collections
import ctypes
import functools

import torch

from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda.int8_gemm import pack_b, packed_k
from dlmc_quant_torch.ops.cuda.nibbles import pack_nibbles

MAX_KP = 2048          # bytes of a row: Kp/16 chunk threads of a pixel
THREADS = 256          # the kernel's block
GUARD = 32             # bytes of shared memory before and after the band
MAX_SMEM = 48 * 1024   # shared memory a block, below the opt-in limit
MAX_ROWS = 4           # output rows a tile (the best of 1-16 at the stem)
SMS = 132              # an H100 SXM's SMs, as the plan models the card
MIN_TILES = 4 * SMS    # tiles a launch aims at, where the map allows

Im2colPlan = collections.namedtuple(
    "Im2colPlan", "ho wo kp th tw rows cols pitch tiles_y tiles_x tiles smem "
                  "per_row step")


def out_hw(h: int, w: int, kernel: int, stride: int, pads):
    """Output size of the padded conv."""
    (top, bottom), (left, right) = pads
    return ((h + top + bottom - kernel) // stride + 1,
            (w + left + right - kernel) // stride + 1)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def channel_chunks(kernel: int, c: int):
    """``(chunks, per)``: a conv of ``c`` input channels (a group's) at a
    ``kernel`` × ``kernel`` window as ``chunks`` runs of ``per`` channels,
    each at most :data:`MAX_KP` bytes of K, the last padded with channels
    of zero weight; ``(1, c)`` where the whole row fits."""
    chunks = _cdiv(c, MAX_KP // (kernel * kernel))
    return chunks, _cdiv(c, chunks)


def make_plan(n: int, h: int, w: int, c: int, kernel: int, stride: int,
              pads, th: int, tw: int) -> Im2colPlan:
    """The kernel's geometry for tiles of ``th`` × ``tw`` output pixels
    (the C entry point derives the same): the band of ``rows`` input rows
    of ``cols`` pixels, each row ``pitch`` bytes of shared memory (room
    for the 0–15 bytes that align it with x, and an odd number of 16-byte
    units, so that band rows start on different banks)."""
    ho, wo = out_hw(h, w, kernel, stride, pads)
    kp = packed_k(kernel * kernel * c)
    th, tw = min(th, ho), min(tw, wo)
    rows = (th - 1) * stride + kernel
    cols = (tw - 1) * stride + kernel
    pitch = _cdiv(cols * c + 15, 16) * 16
    pitch += 16 if pitch // 16 % 2 == 0 else 0
    tiles_y, tiles_x = _cdiv(ho, th), _cdiv(wo, tw)
    per_row = kp // 16
    return Im2colPlan(ho, wo, kp, th, tw, rows, cols, pitch, tiles_y,
                      tiles_x, n * tiles_y * tiles_x,
                      rows * pitch + 2 * GUARD, per_row, THREADS // per_row)


@functools.lru_cache(maxsize=None)
def plan(n: int, h: int, w: int, c: int, kernel: int, stride: int,
         pads) -> Im2colPlan:
    """Tiles for one launch: the full output width where its band fits in
    shared memory with one output row (else the widest that does), and up
    to ``MAX_ROWS`` output rows, fewer where the band does not fit or the
    launch would have fewer than ``MIN_TILES`` tiles.  (A one-pixel band
    always fits: Kp ≤ ``MAX_KP`` bounds k·k·C.)"""
    pads = tuple(map(tuple, pads))

    def at(th, tw):
        return make_plan(n, h, w, c, kernel, stride, pads, th, tw)

    tw = at(1, 1 << 30).tw
    while at(1, tw).smem > MAX_SMEM:
        tw = _cdiv(tw, 2)
    th = MAX_ROWS
    while th > 1 and (at(th, tw).smem > MAX_SMEM
                      or at(th, tw).tiles < MIN_TILES):
        th -= 1
    return at(th, tw)


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
                         "too large for the kernel's 32-bit indices or rows")
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
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 16 + [ctypes.c_void_p])
    return lib


def launch(x: torch.Tensor, kernel: int, stride: int, pads, pad: int,
           p: Im2colPlan) -> torch.Tensor:
    """Launch the kernel on CUDA ``x`` with the tiles of ``p`` (any plan of
    :func:`make_plan` at x's shape); no launch count."""
    n, h, w, c = x.shape
    (top, _), (left, _) = pads
    lib = _library()
    out = torch.empty((n * p.ho * p.wo, p.kp), dtype=torch.int8,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = lib.dlmcq_int8_im2col(
            x.data_ptr(), out.data_ptr(), n, h, w, c, kernel, kernel, stride,
            top, left, p.ho, p.wo, p.kp, pad, p.th, p.tw, p.pitch,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "int8_im2col")
    return out


def int8_im2col(x: torch.Tensor, *, kernel: int, stride: int, pads,
                pad: int) -> torch.Tensor:
    """(N·Ho·Wo, Kp) int8 rows of ``x``'s windows (module docstring).

    CUDA tensors launch the kernel on the current stream and count the
    launch in ``int8_im2col.launches``; CPU tensors run the plain version.
    """
    n, h, w, c, _, _, _ = _check(x, kernel, stride, pads, pad)
    if x.device.type == "cpu":
        return int8_im2col_plain(x, kernel=kernel, stride=stride, pads=pads,
                                 pad=pad)
    if x.device.type != "cuda":
        raise ValueError(f"int8_im2col runs on cuda or cpu, not {x.device}")
    out = launch(x, kernel, stride, pads, pad,
                 plan(n, h, w, c, kernel, stride, tuple(map(tuple, pads))))
    int8_im2col.launches += 1
    return out


int8_im2col.launches = 0
