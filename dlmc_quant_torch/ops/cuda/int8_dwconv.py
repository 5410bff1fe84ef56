"""int8 depthwise 1×1, 3×3 and 5×5 convolutions with the folded requantize
epilogue.

The depthwise convs of MobileNetV2, MobileOne (its train form's 1×1 scale
branches too), GhostNet and EfficientNet on the integer paths.  The JAX
package runs them as an XLA int8 conv at ``feature_group_count = C`` on
the pad-code-padded codes (``dlmc_quant_tpu/quant/layers.py:722-728``);
no Pallas kernel did.  The CUDA kernel is ``csrc/int8_dwconv.cuh`` (with the wide build's in
``csrc/int8_dwconv5x5.cu``); their headers say what bounds it on an H100
and how its tiles work.  For input codes ``x`` (N, H, W, C) int8
and a weight ``w`` (k, k, 1, C) int8, k = 1, 3 or 5 (packed once by
:func:`pack_weight` as (k², C), the tap ``dy·k + dx`` a row)::

    acc[n,p,q,c] = Σ_{dy,dx} xpad[n, p·s + dy, q·s + dx, c] · w[dy, dx, 0, c]   (int32)
    xpad         = x padded with the int8 code ``pad``: ``pad_lo`` rows and
                   columns at the top and left (k // 2, or k // 2 − 1 for
                   the SAME geometry of a stride-2 conv on an even map; 0
                   at 1×1), as many at the bottom and right as the window
                   needs; Ho = ⌈H/s⌉.  Or, with ``pads = ((top, bottom),
                   (left, right))``, those pads (any conv's padding) and
                   Ho = (H + top + bottom − k) // s + 1
    "codes": out = clamp(rint(f32(acc)·a[c] + b[c]), lo, hi) → int8 (N, Ho, Wo, C)
    "f32":   out = f32(acc)·a[c] + b[c], then max(·, 0) if relu → f32

With an ``offset`` (C,) float32, a weight offset's term (a weight grid
``q·s_w + o_w``, ``offset = s_x·o_w``), the product ``f32(acc)·a[c]``
becomes ``f32(acc)·a[c] + f32(S)·offset[c]`` before the rest, ``S`` the
window's codes of channel ``c`` less the pad code::

    S[n,p,q,c] = Σ_{dy,dx} xpad[n, p·s + dy, q·s + dx, c] − k²·pad

which the kernel sums next to its products (no separate launch).

A weight of 4 bits or fewer comes nibble-packed (:func:`pack_weight_int4`:
(k², ⌈C/2⌉) uint8, two channels a byte along C), and the kernel unpacks it
where it reads the weight, once a block.

The epilogue is :mod:`.epilogue`'s (no residual).  The 1×1 window is a
kernel of its own in the same header, a strided per-channel product with
no halo (:func:`make_plan`'s 1×1 plan: granules of channels by pixel
lanes).  Two libraries hold the
kernel's instantiations: ``int8_dwconv3x3`` (``csrc/int8_dwconv3x3.cu``)
the 3×3 window and the 1×1's codes on the aligned path (C % 8 == 0,
16-byte aligned codes and weight: MobileNetV2's and MobileOne's widths,
``_make_divisible(·, 8)``), and ``int8_dwconv5x5``
(``csrc/int8_dwconv5x5.cu``, the wide build) the 5×5 window and the
ragged path of the 3×3 and 1×1 windows (the 1×1 in f32 too), which takes
any C ≥ 1:
GhostNet's cheap convs have C = 12, 20, 36, 60, 92, 100 at width 1.0, and
C = 18 at width 0.5; there, where the whole pixel is a slice, the halo
comes in row runs and, below :data:`STAGED_C`, the outputs go out through
shared memory.  :func:`route` picks one per launch, :func:`plan` the
tiles.

:func:`int8_dwconv3x3` launches the kernel for CUDA tensors and runs
:func:`int8_dwconv3x3_plain` for CPU tensors, at the window its weight
gives; there is no fallback from one to the other.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda.epilogue import check_epilogue, epilogue_plain
from dlmc_quant_torch.ops.cuda.int8_conv import out_hw
from dlmc_quant_torch.ops.cuda.nibbles import W4, pack_nibbles, unpack_nibbles

WINDOWS = (1, 3, 5)   # the kernel's windows, k × k
GRANULE = 8           # the aligned path's channel granule: C % 8 == 0
PITCH_PAD = 16        # bytes after a pixel's slice in shared memory
MAX_SHIFT = 12        # a row run's offset in its 16 bytes (runs layout)
STAGED_C = 64         # the runs layout stages its outputs below this C
MAX_THREADS = 256
MAX_COLUMN_GROUPS = 8
MAX_ROWS = 8          # output rows a thread walks down a tile
HALF_SMEM = 232448 // 2   # two blocks an SM at least
SMS = 132             # an H100 SXM's SMs, as the plan models the card
INT_LIMIT = 2 ** 31 - 1
# the plan's cost model, in instructions of a lane: an output value's
# multiply-adds and epilogue (3×3, 5×5); a halo row's loads and byte
# permutes; a tile's decode and barriers; a staged granule (or a 16-byte
# chunk of a row run)
COST_VALUE = {3: 10, 5: 24}
COST_ROW, COST_TILE, COST_GRANULE = 20, 50, 6
LANES = 128           # lanes an SM runs a clock

DwPlan = collections.namedtuple(
    "DwPlan", "cb cg rg rpt threads th tw hh hw pitch granule slices "
              "tiles_y tiles_x tiles smem runs row_pitch chunks stage_row")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def columns(stride: int) -> int:
    """Output columns a thread owns: 4 at stride 1, 2 at stride 2."""
    return 4 if stride == 1 else 2


def window(w: torch.Tensor) -> int:
    """The window k of a packed weight, from its k² rows."""
    k = math.isqrt(w.shape[0]) if w.dim() == 2 else 0
    if k not in WINDOWS or k * k != w.shape[0]:
        raise ValueError(f"w must be packed (k*k, C) for k in {WINDOWS}, "
                         f"got {tuple(w.shape)}")
    return k


def pad_los(k: int, stride: int) -> tuple:
    """The top/left pads the kernel takes with Ho = ⌈H/s⌉: ``k // 2``
    (explicit ``k // 2`` padding, and SAME at stride 1 or on an odd map),
    and ``k // 2 − 1`` at stride 2 (SAME on an even map); 0 at 1×1."""
    if k == 1 or stride == 1:
        return (k // 2,)
    return (k // 2 - 1, k // 2)


def geometry(h: int, w: int, k: int, stride: int, pad_lo=None, pads=None):
    """``(top, left, ho, wo)`` of a launch: ``pad_lo`` (default ``k //
    2``) at the top and left and ⌈H/s⌉ × ⌈W/s⌉ outputs, or with ``pads``
    ``((top, bottom), (left, right))`` those pads and the outputs they
    give."""
    if pads is None:
        lo = k // 2 if pad_lo is None else pad_lo
        return (lo, lo) + out_hw(h, w, stride)
    (top, bottom), (left, right) = pads
    return (top, left, (h + top + bottom - k) // stride + 1,
            (w + left + right - k) // stride + 1)


def make_plan_1x1(n: int, ho: int, wo: int, c: int, ragged: int = 0,
                  cb: int = None, lanes: int = None) -> DwPlan:
    """The 1×1 window's geometry (the C entry point derives the same): a
    thread owns a granule of channels (``ragged`` 4 or 1 on the ragged
    path, f32 too; 16 where C and ``cb`` % 16 == 0 on the aligned one,
    else 8), a block a slice of ``cb`` channels (the whole pixel where its
    granules fit in :data:`MAX_THREADS`, else slices of equal granules)
    times ``lanes`` pixels (as many as fit),
    and the grid walks the N·Ho·Wo pixels.  In the :class:`DwPlan`: ``cg``
    the lanes, ``tw`` too, ``tiles_x`` the blocks of lanes the pixels
    need and ``tiles`` those times the slices."""
    if cb is None:      # the whole pixel, else balanced slices
        g = ragged or (16 if c % 16 == 0 else 8)
        granules = _cdiv(c, g)
        cb = _cdiv(granules, _cdiv(granules, MAX_THREADS)) * g
    granule = ragged or (16 if c % 16 == 0 and cb % 16 == 0 else 8)
    if lanes is None:
        lanes = max(1, MAX_THREADS // (cb // granule))
    slices, blocks = _cdiv(c, cb), _cdiv(n * ho * wo, lanes)
    return DwPlan(cb, lanes, 1, 1, cb // granule * lanes, 1, lanes, 1, 1,
                  0, granule, slices, 1, blocks, blocks * slices, 0, False,
                  0, 0, 0)


def make_plan(n: int, h: int, w: int, c: int, stride: int, cb: int, cg: int,
              rg: int, rpt: int, k: int = 3, ragged: int = 0,
              out=None) -> DwPlan:
    """The kernel's geometry for ``cb`` channels a block, ``cg`` column
    groups, ``rg`` row groups and ``rpt`` rows a thread, at window ``k``,
    on the aligned path (``ragged`` 0) or the ragged one (its staging
    granule, 4 or 1); the C entry point derives the same.

    The halo's layout: cells of ``cb`` channels at a pitch of ``cb`` + 16
    bytes, ``hw`` cells a row; or, on the ragged path at granule 4 with the
    whole pixel a slice (``cb == c``), row runs (``runs``): pixels packed
    at a pitch of C, rows ``row_pitch`` apart (the least from hw·C up with
    row_pitch ≡ W·C mod 16, 16 more where the next row group's words would
    fall on this one's banks), each run shifted by its source address mod
    16 (at most :data:`MAX_SHIFT`), staged in ``chunks`` 16-byte chunks a
    row at most; and below :data:`STAGED_C` the outputs staged too, two
    buffers of ``rg`` rows of ``stage_row`` bytes (the tile's columns of
    f32, in either mode).  ``out`` is (Ho, Wo) where the pads are not
    the default (:func:`geometry`); at 1×1 :func:`make_plan_1x1` with
    ``cb`` and ``cg`` pixel lanes (``rg`` and ``rpt`` 1)."""
    ho, wo = out or out_hw(h, w, stride)
    if k == 1:
        return make_plan_1x1(n, ho, wo, c, ragged, cb, cg)
    th, tw = rg * rpt, columns(stride) * cg
    hh, hw = (th - 1) * stride + k, (tw - 1) * stride + k
    slices, tiles_y, tiles_x = _cdiv(c, cb), _cdiv(ho, th), _cdiv(wo, tw)
    granule = ragged or (16 if c % 16 == 0 and cb % 16 == 0 else 8)
    runs = ragged == 4 and cb == c
    if runs:
        span = hw * c
        pitch, row_pitch = c, span + (w * c - span) % 16
        if rg > 1 and rpt * stride * (row_pitch // 4) % 32 == 0:
            row_pitch += 16
        chunks = (span + MAX_SHIFT + 15) // 16
        buf = _cdiv(MAX_SHIFT + (hh - 1) * row_pitch + span, 16) * 16
        stage_row = _cdiv(tw * c * 4, 16) * 16 if c < STAGED_C else 0
    else:
        pitch = cb + PITCH_PAD
        row_pitch, chunks, stage_row = hw * pitch, 0, 0
        buf = hh * row_pitch
    return DwPlan(cb, cg, rg, rpt, cb // 4 * cg * rg, th, tw, hh, hw, pitch,
                  granule, slices, tiles_y, tiles_x,
                  n * tiles_y * tiles_x * slices,
                  2 * buf + 2 * rg * stage_row, runs, row_pitch, chunks,
                  stage_row)


def _best(n: int, h: int, w: int, c: int, stride: int, cb: int, k: int = 3,
          ragged: int = 0, out=None) -> DwPlan:
    """The row groups and rows a thread of least modelled time at ``cb``
    (ties to the more threads): a thread's instructions for a tile (its
    values' multiply-adds and epilogue, its halo rows, the tile's overhead,
    its share of the staged granules) times the lanes of all tiles over
    the card's lanes, plus one thread's for the last tile.  At batch 256
    the first term decides (long walks down a tile reuse the halo rows), at
    batch 8 the second (more, shorter tiles fill the card).  Either window
    keeps its rows: a thread reads rpt·s + k − s halo rows; the runs
    layout stages 16-byte chunks."""
    cg = column_groups(w, stride, out)
    best = None
    for rg in range(1, MAX_THREADS // (cb // 4 * cg) + 1):
        for rpt in range(1, MAX_ROWS + 1):
            p = make_plan(n, h, w, c, stride, cb, cg, rg, rpt, k, ragged,
                          out)
            if p.smem > HALF_SMEM:
                continue
            lanes = _cdiv(p.threads, 32) * 32
            staged = p.hh * (p.chunks if p.runs
                             else p.hw * cb // p.granule)
            granules = _cdiv(staged, p.threads)
            rows = rpt * stride + k - stride
            thread = (rpt * columns(stride) * 4 * COST_VALUE[k]
                      + rows * COST_ROW + COST_TILE
                      + granules * COST_GRANULE)
            # the card's share of all tiles' lane work, and the last tile
            cost = p.tiles * lanes * thread / (SMS * LANES) + thread
            if best is None or (cost, -p.threads) < best[0]:
                best = ((cost, -p.threads), p)
    return best[1]


def column_groups(w: int, stride: int, out=None) -> int:
    """Column groups of a tile: at most 8, balanced over a row's tiles."""
    wo = out[1] if out else out_hw(w, w, stride)[1]
    groups = _cdiv(wo, columns(stride))
    return _cdiv(groups, _cdiv(groups, MAX_COLUMN_GROUPS))


@functools.lru_cache(maxsize=None)
def plan(n: int, h: int, w: int, c: int, stride: int, k: int = 3,
         ragged: int = 0, out=None) -> DwPlan:
    """Tiles for one launch at window ``k``, on the aligned path
    (``ragged`` 0) or the ragged one (4 or 1, :func:`route`).

    The channel slice CB of the aligned path: the whole pixel where its
    quads fit in 256 threads and either C % 32 != 0 (slices of 32 would
    straddle 32-byte sectors; whole pixels let each warp's stores run on
    through the pixel) or the stride is 2 (a tall tile buys little there:
    each output row needs new halo rows anyway); else, where C % 32 != 0,
    the widest of 64, 48, 32, 16 and 8 that divides C; where C % 32 == 0,
    64 if it divides C and still gives two tiles an SM, else 32 (at stride
    1 the taller tile of a narrow slice wins).  On the ragged path: the
    whole pixel rounded up to a quad where it fits, else 32 (a masked tail
    slice); at C = 12 that is 3 lanes a pixel and 21 a row group, so that
    warps straddle row groups, which costs nothing the plans timed against
    one another show (``tools/dw_launches.py --sweep``).  Tile columns: at most 8 groups of :func:`columns`, balanced
    over the tiles of a row.  Row groups and rows a thread: the pair of
    least modelled time (:func:`_best`), within 256 threads and half the
    shared memory.  ``out`` (Ho, Wo) where the pads are not the default.
    The 1×1 window: :func:`make_plan_1x1`'s default.
    """
    if k == 1:
        return make_plan_1x1(n, *(out or out_hw(h, w, stride)), c, ragged)
    cg = column_groups(w, stride, out)
    if ragged:
        quads = _cdiv(c, 4)
        cb = 4 * quads if quads * cg <= MAX_THREADS else 32
        return _best(n, h, w, c, stride, cb, k, ragged, out)
    if (c % 32 or stride == 2) and c // 4 * cg <= MAX_THREADS:
        return _best(n, h, w, c, stride, c, k, out=out)
    if c % 32:
        cb = next(cb for cb in (64, 48, 32, 16, 8) if c % cb == 0)
        return _best(n, h, w, c, stride, cb, k, out=out)
    if c % 64 == 0:
        wide = _best(n, h, w, c, stride, 64, k, out=out)
        if wide.tiles >= 2 * SMS:
            return wide
    return _best(n, h, w, c, stride, 32, k, out=out)


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(k, k, 1, C) int8 HWIO, k = 1, 3 or 5 → (k², C) int8, a tap a
    row."""
    if w.dtype != torch.int8 or w.dim() != 4 or w.shape[0] not in WINDOWS \
            or tuple(w.shape[1:3]) != (w.shape[0], 1):
        raise ValueError(f"expected (k, k, 1, C) int8 weights, k in "
                         f"{WINDOWS}, got {tuple(w.shape)} {w.dtype}")
    return w.reshape(w.shape[0] ** 2, w.shape[3]).contiguous()


def pack_weight_int4(w: torch.Tensor) -> torch.Tensor:
    """(k, k, 1, C) int8 HWIO in [-8, 7] → (k², ⌈C/2⌉) uint8: the layout of
    :func:`pack_weight`, two channels a byte (channel 2j in the low nibble
    of byte j; an odd C's last byte has a zero high nibble)."""
    return pack_nibbles(pack_weight(w))


def int8_weight(wp: torch.Tensor, c: int) -> torch.Tensor:
    """The (k², C) int8 layout of a packed weight of either width."""
    return unpack_nibbles(wp, c) if wp.dtype == W4 else wp


def unpack_weight(wp: torch.Tensor, c: int = None) -> torch.Tensor:
    """Inverse of :func:`pack_weight` (or, given C, of
    :func:`pack_weight_int4`) → (k, k, 1, C) int8."""
    w = int8_weight(wp, c)
    k = window(w)
    return w.reshape(k, k, 1, w.shape[1])


def _check(x, w, a, b, stride, pad, pad_lo, lo, hi, mode, relu,
           offset=None, pads=None):
    """The arguments of either route: shapes, types, the geometry and the
    epilogue; returns the window, the shapes and the top and left pads."""
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if not isinstance(pad, int) or not -128 <= pad <= 127:
        raise ValueError(f"pad must be an int8 code, got {pad!r}")
    if x.dtype != torch.int8 or x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"x must be non-empty (N, H, W, C) int8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, h, wd, c = x.shape
    k = window(w)
    if pads is None and pad_lo not in pad_los(k, stride):
        raise ValueError(f"pad_lo must be one of {pad_los(k, stride)} (k // "
                         f"2, or k // 2 - 1 for SAME at stride 2 on an even "
                         f"map), got {pad_lo!r} at {k}x{k}, stride "
                         f"{stride}; other pads go in pads=")
    if pads is not None and not (
            len(pads) == 2 and all(len(pr) == 2 for pr in pads)
            and all(isinstance(v, int) and v >= 0 for pr in pads
                    for v in pr)):
        raise ValueError(f"pads must be ((top, bottom), (left, right)) of "
                         f"ints >= 0, got {pads!r}")
    top, left, ho, wo = geometry(h, wd, k, stride, pad_lo, pads)
    if ho < 1 or wo < 1 or n * ho * wo >= 0x7FF00000:
        raise ValueError(f"{k}x{k} at stride {stride} with pads {pads} "
                         f"gives {ho}x{wo} outputs of {tuple(x.shape)}")
    if (w.dtype, tuple(w.shape)) not in ((torch.int8, (k * k, c)),
                                         (W4, (k * k, -(-c // 2)))):
        raise ValueError(f"w must be pack_weight() output of shape ({k * k}, "
                         f"{c}) int8 or pack_weight_int4() output of shape "
                         f"({k * k}, {-(-c // 2)}) uint8, got "
                         f"{tuple(w.shape)} {w.dtype}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    check_epilogue("int8_dwconv3x3", mode, a, b, lo, hi, relu, None, 0.0,
                   (n, ho, wo, c), x.device)
    if offset is not None and (
            offset.dtype != torch.float32 or tuple(offset.shape) != (c,)
            or not offset.is_contiguous() or offset.device != x.device):
        raise ValueError(f"offset must be contiguous ({c},) float32 on "
                         f"{x.device}")
    return k, n, h, wd, c, ho, wo, top, left


def route(x, w, mode: str = "codes") -> int:
    """The kernel's path for ``x`` and its packed weight: 0, the aligned
    path (C % 8 == 0 and 16-byte aligned x and w: the halo in 16- or
    8-byte granules), else the ragged path's staging granule, 4 (C % 4 ==
    0 on 4-byte aligned x) or 1.  The 1×1 window in f32 takes granules of
    4 wherever C % 4 == 0 (a warp's float4 stores then run on through
    memory), so the aligned path does not take it."""
    c = x.shape[-1]
    quad = c % 4 == 0 and x.data_ptr() % 4 == 0
    if mode == "f32" and window(w) == 1:
        return 4 if quad else 1
    if c % GRANULE == 0 and x.data_ptr() % 16 == 0 \
            and w.data_ptr() % 16 == 0:
        return 0
    return 4 if quad else 1


def check_kernel(x, w, stride: int, out=None,
                 mode: str = "codes") -> DwPlan:
    """The kernel's own limits, checked on the CUDA route only: a window
    of :data:`WINDOWS` and a tile count in 32 bits.  Returns
    :func:`plan`'s tiles on the path :func:`route` picks for ``mode``
    (``out`` (Ho, Wo) where the pads are not the default)."""
    n, h, wd, c = x.shape
    p = plan(n, h, wd, c, stride, window(w), route(x, w, mode), out)
    if p.tiles >= INT_LIMIT:
        raise ValueError(f"x has too many tiles: {tuple(x.shape)}")
    return p


def int8_dwconv3x3_plain(x, w, a, b, *, stride: int, pad: int,
                         pad_lo: int = None, lo: int = -128, hi: int = 127,
                         mode: str = "codes", relu: bool = False,
                         offset=None, pads=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel at any window (same arguments,
    same result): a float64 ``F.conv2d(groups=C)`` over the
    pad-code-padded input, exact because |acc| ≤ 25·128² ≪ 2⁵³, and with
    an ``offset`` the window sums as a float64 ``F.conv2d(groups=C)`` of
    ones over it less ``pad``, then :func:`.epilogue.epilogue_plain`."""
    k = window(w)
    k, n, h, wd, c, ho, wo, top, left = _check(
        x, w, a, b, stride, pad, k // 2 if pad_lo is None else pad_lo, lo,
        hi, mode, relu, offset, pads)
    bottom = max((ho - 1) * stride + k - h - top, 0)
    right = max((wo - 1) * stride + k - wd - left, 0)
    xp = F.pad(x.permute(0, 3, 1, 2).to(torch.float64),
               (left, right, top, bottom), value=float(pad))
    wk = unpack_weight(w, c).permute(3, 2, 0, 1).to(torch.float64)
    acc = F.conv2d(xp, wk, stride=stride, groups=c)[:, :, :ho, :wo]
    row = None
    if offset is not None:
        sums = F.conv2d(xp - pad, torch.ones_like(wk), stride=stride,
                        groups=c)[:, :, :ho, :wo]
        row = (sums.permute(0, 2, 3, 1), offset)
    return epilogue_plain(acc.permute(0, 2, 3, 1), a, b, mode=mode, lo=lo,
                          hi=hi, relu=relu, row=row)


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    lib.dlmcq_int8_dwconv.restype = ctypes.c_int
    lib.dlmcq_int8_dwconv.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 21 + [ctypes.c_void_p])
    return lib


def library_name(k: int, ragged: int) -> str:
    """The library that holds a launch's instantiation: ``int8_dwconv3x3``
    for the aligned path of the 3×3 and 1×1 windows (:func:`route`),
    ``int8_dwconv5x5`` for the rest."""
    return ("int8_dwconv3x3" if k in (1, 3) and not ragged
            else "int8_dwconv5x5")


def int8_dwconv3x3(x, w, a, b, *, stride: int, pad: int, pad_lo: int = None,
                   lo: int = -128, hi: int = 127, mode: str = "codes",
                   relu: bool = False, offset=None, pads=None,
                   _plan=None) -> torch.Tensor:
    """Run the int8 depthwise conv at the window of ``w`` (see the module
    docstring; ``pad_lo`` defaults to k // 2; ``pads`` ((top, bottom),
    (left, right)) replaces it where a conv's padding is neither).

    ``x`` (N, H, W, C) int8, ``w`` from :func:`pack_weight` (or
    :func:`pack_weight_int4`: the kernel unpacks the nibbles), ``a``/``b``
    (and ``offset``, or None) (C,) float32, all contiguous and on one
    device.  CUDA tensors launch the kernel on the current stream, on the
    path :func:`route` picks and :func:`plan`'s tiles (``_plan = (cb, cg,
    rg, rpt)`` overrides them), and count the launch in
    ``int8_dwconv3x3.launches`` (a 5×5 one in ``.launches_5x5`` as well, a
    ragged 3×3 or 5×5 one in ``.launches_ragged``, a 1×1 one in
    ``.launches_1x1``); CPU tensors run the plain version.
    """
    k = window(w)
    pad_lo = k // 2 if pad_lo is None else pad_lo
    k, n, h, wd, c, ho, wo, top, left = _check(
        x, w, a, b, stride, pad, pad_lo, lo, hi, mode, relu, offset, pads)
    if x.device.type == "cpu":
        return int8_dwconv3x3_plain(x, w, a, b, stride=stride, pad=pad,
                                    pad_lo=pad_lo, lo=lo, hi=hi, mode=mode,
                                    relu=relu, offset=offset, pads=pads)
    if x.device.type != "cuda":
        raise ValueError(f"int8_dwconv3x3 runs on cuda or cpu, not "
                         f"{x.device}")
    out_size = None if pads is None else (ho, wo)
    p = check_kernel(x, w, stride, out_size, mode)
    ragged = route(x, w, mode)
    if _plan is not None:
        p = make_plan(n, h, wd, c, stride, *_plan, k, ragged, out_size)
    lib = _library(library_name(k, ragged))
    out = torch.empty((n, ho, wo, c), device=x.device,
                      dtype=torch.int8 if mode == "codes" else torch.float32)
    with torch.cuda.device(x.device):
        err = lib.dlmcq_int8_dwconv(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            offset.data_ptr() if offset is not None else None,
            out.data_ptr(), n, h, wd, c, k, stride, top, left, ho, wo, pad,
            lo, hi,
            int(mode == "codes"), int(relu), int(w.dtype == W4), ragged,
            p.cb, p.cg, p.rg, p.rpt,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "int8_dwconv3x3")
    int8_dwconv3x3.launches += 1
    int8_dwconv3x3.launches_5x5 += k == 5
    int8_dwconv3x3.launches_ragged += ragged != 0 and k != 1
    int8_dwconv3x3.launches_1x1 += k == 1
    return out


int8_dwconv3x3.launches = 0
int8_dwconv3x3.launches_5x5 = 0
int8_dwconv3x3.launches_ragged = 0
int8_dwconv3x3.launches_1x1 = 0
