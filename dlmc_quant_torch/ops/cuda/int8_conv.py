"""Fused int8 3×3 convolution with a requantize epilogue.

The port of ``dlmc_quant_tpu/ops/pallas/rpconv.py:200`` (``int8_conv3x3_rm``,
body ``_rp_kernel`` at ``:142``), generalised to stride 2, any width and
channel count, and the folded-boundary epilogue of the chained int8 path.
The CUDA source is ``csrc/int8_conv3x3.cu``: an implicit GEMM on the tensor
cores (``wgmma`` s8 from swizzled shared memory, on ``csrc/wgmma_s8.cuh``),
whose im2col tiles a producer warpgroup gathers with ``cp.async`` and whose
weight comes by TMA; its header says what bounds each layer class on an
H100 and what the design does about it.  :mod:`.build` compiles it with
``nvcc`` for ``sm_90a`` at first use, into ``_build/`` beside this file, as
a shared library with a plain C interface loaded through ``ctypes``.

For input codes ``x`` (N, H, W, C) int8 and weights ``w`` (3, 3, C/G, O)
int8 in G groups (packed once by :func:`pack_weight`)::

    acc[n,p,q,o] = Σ_{dy,dx,c<C/G} xpad[n, p·s+dy, q·s+dx, g·C/G + c] · w[dy,dx,c,o]
                   (int32; g = o // (O/G), the group of output channel o)
    xpad         = x padded with the int8 code ``pad``: ``pad_lo`` rows and
                   columns at the top and left (1, or 0 for the SAME
                   geometry of a stride-2 conv on an even map), as many at
                   the bottom and right as the window needs; Ho = ⌈H/s⌉
    "codes": out = clamp(rint(f32(acc)·a[o] + b[o]), lo, hi) → int8 (N, Ho, Wo, O)
    "f32":   out = f32(acc)·a[o] + b[o], then max(·, 0) if relu → f32

In ``"codes"`` mode a ``residual`` ``(r, ar, br)`` adds a residual block's
shortcut to the sum before it is rounded, term by term in the order of
``quant.chain.fold_sum_quantize``, with ``qb`` the output grid's bias::

    out = clamp(rint((((qb + f32(acc)·a[o]) + b[o]) + f32(r)·ar[o]) + br[o]), lo, hi)

``r`` is (N, Ho, Wo, O) int8 codes, int32 accumulators or float32 values;
``ar`` and ``br`` are (O,) float32.  A ``row`` term ``(S, c)``, ``S`` (N,
Ho, Wo) int32 and ``c`` (O,) float32, adds ``f32(S)·c[o]`` to the product
``f32(acc)·a[o]`` before the rest (a weight offset's term, ``S`` from
``int8_window_sum``), in every mode; in G groups ``S`` is (N, Ho, Wo, G)
and column ``o`` reads its group's, ``S[…, o // Og]``.  The epilogue is
:mod:`.epilogue`'s, which the int8 GEMM shares.

As a GEMM the conv has M = N·Ho·Wo rows, O columns and K = 3·Rp bytes,
ordered (dy, dx, channel): the 3·C bytes that row dy of the window covers
are consecutive in NHWC and stay one run of K, padded to
``Rp = roundup(3·C, 16)`` (nothing is padded where C % 16 == 0).  A
grouped conv (G > 1: RepVGG's g2/g4 variants) is G such GEMMs side by
side, one a group, each of O/G columns and K = 9·Tp bytes: the three taps
of a window row are C bytes apart in NHWC, so each tap's run of
``Cg = C/G`` channels is padded to ``Tp = roundup(Cg, 16)`` on its own,
and a 16-byte chunk of K lies inside one tap.  The group is part of the
tile index: a tile reads its group's channels only, and its columns stop
at the group's end (the tile's weight rows past it are multiplied and
never stored).  Grouped convs launch the same source's grouped build,
``csrc/int8_conv3x3_grouped.cu``, so that the ungrouped build keeps none
of the group code.
:func:`tile_plan` chooses the block's plan for a layer (output width of
the tile, ring stages, weight resident in shared memory or streamed, halo
buffers for stride 1); the kernel runs whatever plan it is given, so the
plan is checked on the CPU.  At the ResNets' widths (64 and 128, in turns;
256) the A tiles of a stride-1 layer at C % 128 == 0 come by TMA
(:func:`tma_rows`), a layer at C = 64 gathers them from the halo
(:func:`halo_gathered`), and a residual whose rows are whole 16 bytes is
staged by TMA (:func:`launch_plan` decides from ``r``).

A weight of 4 bits or fewer comes nibble-packed (:func:`pack_weight_int4`:
the packed weight, two bytes of K a byte) and stays so in device memory;
the kernel's producers unpack it where they write the B tile.

:func:`int8_conv3x3` launches the kernel for CUDA tensors and runs
:func:`int8_conv3x3_plain` for CPU tensors; there is no fallback from one
to the other.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda.epilogue import (RESIDUAL_KINDS,
                                                check_epilogue,
                                                epilogue_plain)
from dlmc_quant_torch.ops.cuda.nibbles import W4, pack_nibbles, unpack_nibbles

PRODUCER_WARPS = 4    # each fills every fourth stage of a block's sequence
CHUNK = 16            # bytes of K that always lie inside one tap
TILE_K = 128          # bytes of K in a shared-memory tile row
# output widths of a tile as compiled into csrc/int8_conv3x3.cu: RepVGG-A0's
# 48, 96 and 192 exactly, 256 for wide outputs; a tile has BM rows.  Both
# builds split a tile between the two consumer warpgroups at these widths.
WIDTHS = (48, 96, 192, 256)
# the ResNets' 64 and 128, in the ungrouped build only: each consumer
# warpgroup owns every other tile of its block (turns), and a residual r
# whose rows are whole 16 bytes is staged by TMA
TURN_WIDTHS = (64, 128)
BM = 128
WGMMA_M = 64          # rows of one wgmma: a consumer warpgroup's share
SMS = 132             # the H100's SMs: tile_plan counts waves of tiles
# a tile's im2col build, in columns of products: at W4 tile_plan's cost
# of a tile is (2 bn + A_COLS) a wave (the producers unpack its B tile);
# from tools/conv_launches.py --widths on an H100
A_COLS = 128
R_SLOTS = 2           # a warpgroup's slots of a staged residual
MIN_STAGES = PRODUCER_WARPS   # fewer and a warp could miss a slot's phase
MAX_STAGES = 8
# the ring depths of the widths that take turns: each producer warp then
# owns whole slots (stage j to warp j % 4 is slot j % stages to warp slot %
# 4), since releases of the two warpgroups' stages do not come in the
# ring's order (tests/test_torch_conv_plan.py: producers_run)
TURN_STAGES = (PRODUCER_WARPS, 2 * PRODUCER_WARPS)
MAX_HALOS = 4
# the halo buffers of the widths that take turns: where the weight is
# resident the consumers gather A from the halo themselves (the kernel's
# halo_a), each warpgroup waiting on its own tiles' buffers, which the
# warpgroups share out evenly with 2 or 4 of them
TURN_HALOS = (4, 2, 0)
MAX_SMEM = 232448     # dynamic shared memory a block may use
HALF_SMEM = (MAX_SMEM + 1024) // 2 - 1024   # two blocks share an SM
INT_LIMIT = 2 ** 31 - 1024   # output and input pixels are 32-bit in the kernel

ConvPlan = collections.namedtuple(
    "ConvPlan",
    "bn stages resident halo_bufs m_tiles n_tiles k_chunks smem")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def padded_run(c: int) -> int:
    """Bytes of K of one window row (3 taps × C channels), in whole chunks."""
    return _cdiv(3 * c, CHUNK) * CHUNK


def tap_run(cg: int) -> int:
    """Bytes of K of one tap of a grouped conv (Cg channels), in whole
    chunks."""
    return _cdiv(cg, CHUNK) * CHUNK


def _check_groups(c: int, o: int, groups: int) -> None:
    if groups < 1 or c % groups or o % groups:
        raise ValueError(f"{groups} groups do not divide C = {c} and "
                         f"O = {o}")


def packed_shape(c: int, o: int, groups: int = 1):
    """(O, Kp) of the packed weight for C input and O output channels in
    ``groups`` groups."""
    _check_groups(c, o, groups)
    if groups > 1:
        return o, 9 * tap_run(c // groups)
    return o, 3 * padded_run(c)


def out_hw(h: int, w: int, stride: int):
    """Output spatial size of the padded 3×3 conv (either top/left pad)."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def pack_weight(w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """(3, 3, C/G, O) int8 HWIO → (O, Kp) int8, K contiguous per output
    channel.

    Ungrouped, byte ``k = dy·Rp + dx·C + c`` of row ``o`` is ``w[dy, dx, c,
    o]``; the bytes past ``3·C`` of every window row are zero.  In G > 1
    groups byte ``k = (3·dy + dx)·Tp + c`` is, and the bytes past ``Cg`` of
    every tap are zero.  This is the K-major B that ``wgmma`` takes for
    8-bit types; ``Kp`` is the multiple of 16 that TMA's pitch needs, and
    where C % 16 == 0 (grouped: always) every 16-byte chunk of K lies
    inside one tap.
    """
    if w.dtype != torch.int8 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"expected (3, 3, C, O) int8 weights, got "
                         f"{tuple(w.shape)} {w.dtype}")
    _, _, cg, o = w.shape
    c = cg * groups
    if groups > 1:
        wp = torch.zeros((o, 9, tap_run(cg)), dtype=torch.int8,
                         device=w.device)
        wp[:, :, :cg] = w.reshape(9, cg, o).permute(2, 0, 1)
    else:
        wp = torch.zeros((o, 3, padded_run(c)), dtype=torch.int8,
                         device=w.device)
        wp[:, :, :3 * c] = w.reshape(3, 3 * c, o).permute(2, 0, 1)
    return wp.reshape(packed_shape(c, o, groups))


def packed_shape_int4(c: int, o: int, groups: int = 1):
    """(O, Kp/2) of the nibble-packed weight: Kp/2 is a multiple of 8 but
    not always of 16 (C = 3, 16, 48 …), so the kernel reads it with plain
    8-byte loads, not by TMA."""
    o, kp = packed_shape(c, o, groups)
    return o, kp // 2


def pack_weight_int4(w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """(3, 3, C/G, O) int8 HWIO in [-8, 7] → (O, Kp/2) uint8: the layout of
    :func:`pack_weight`, two bytes of K a byte (K index 2j in the low
    nibble of byte j)."""
    return pack_nibbles(pack_weight(w, groups))


def unpack_weight(wp: torch.Tensor, c: int, o: int,
                  groups: int = 1) -> torch.Tensor:
    """Inverse of :func:`pack_weight` and :func:`pack_weight_int4` →
    (3, 3, C/G, O) int8."""
    kp = packed_shape(c, o, groups)[1]
    if wp.dtype == W4:
        wp = unpack_nibbles(wp, kp)
    if groups > 1:
        cg = c // groups
        taps = wp.reshape(o, 9, tap_run(cg))[:, :, :cg]
        return taps.permute(1, 2, 0).reshape(3, 3, cg, o).contiguous()
    runs = wp.reshape(o, 3, padded_run(c))[:, :, :3 * c]
    return runs.permute(1, 2, 0).reshape(3, 3, c, o).contiguous()


def tma_rows(c: int, stride: int, groups: int = 1) -> bool:
    """Whether a conv's A tiles come by TMA (the kernel's ``tma_a``, where
    the plan has no halo): stride 1, C % 128 == 0, ungrouped.  A 128-byte
    chunk of K is then 128 channels of one tap, and a tile's rows are 128
    consecutive pixels of x, one box; the consumers pad the rows whose tap
    lies outside the image."""
    return groups == 1 and stride == 1 and c % TILE_K == 0


def halo_gathered(bn: int, c: int, resident: bool) -> bool:
    """Whether the consumers gather their A fragments from the halo by
    ``ldmatrix`` (the kernel's ``halo_a``): 64-wide tiles in turns at C =
    64 with the weight resident.  The halo then comes by TMA in the 64-byte
    swizzle, in boxes of at most 256 pixels."""
    return bn == 64 and c == 64 and resident


def halo_bytes(width: int, c: int, gathered: bool = False) -> int:
    """Bytes of the run of input pixels a tile of a stride-1 conv reads:
    its own BM pixels and a row and a pixel to either side; gathered
    (:func:`halo_gathered`), in whole TMA boxes of at most 256 pixels, the
    buffer 1024-byte aligned."""
    rows = BM + 2 * width + 2
    if not gathered:
        return rows * c
    box = min(rows, 256)
    return _cdiv(_cdiv(rows, box) * box * c, 1024) * 1024


def plan_smem(bn: int, codes: bool, stages: int, resident: bool,
              k_chunks: int, n_tiles: int, halo_total: int = 0,
              r_bytes: int = 0) -> int:
    """Dynamic shared memory of a block (``make_layout`` in the source):
    the ring (a BM-row A tile and, unless the weight is resident, a
    BN-row B tile a stage), the resident weight, a staged residual's slots
    (``r_bytes`` > 0 at a turns width: r of 1 or 4 bytes), the codes'
    staging tile (128 columns a pass, row pitch padded against bank
    conflicts), the halo buffers (from a 1024-byte boundary), the
    per-column parameters, a table per producer warp of where its tile's
    pixels read, and the barriers."""
    turns = bn in TURN_WIDTHS
    rows_wg = 2 * WGMMA_M if turns else WGMMA_M     # a warpgroup's rows
    staged = bool(r_bytes) and turns
    stage = (BM + (0 if resident else bn)) * TILE_K
    sw = 128 if bn == 256 else bn
    pitch = sw if sw == 48 else sw + 16
    slots = 0
    if staged:
        cw = min(bn, TILE_K // r_bytes)
        slot = rows_wg * cw * r_bytes + (rows_wg * cw if r_bytes > 1 else 0)
        slots = 2 * R_SLOTS * slot
    before_halo = (stages * stage
                   + (k_chunks * bn * TILE_K if resident else 0) + slots
                   + (2 * rows_wg * pitch if codes and not staged else 0))
    return (_cdiv(before_halo, 1024) * 1024    # the halos 1024-aligned
            + halo_total + (4 if staged else 2) * n_tiles * bn * 4
            + PRODUCER_WARPS * BM * 8
            + (3 * MAX_STAGES + 1 + 2 * MAX_HALOS
               + (2 * R_SLOTS if staged else 0)) * 8)


def _epi(codes: bool, r_bytes: int, bn: int) -> int:
    """The source's epilogue code of a plan (``smem_of``)."""
    if r_bytes and bn in TURN_WIDTHS:
        return 3 if r_bytes == 1 else 4
    return int(codes)


def _w4_cost(m_tiles: int, o: int, bn: int) -> int:
    """Waves of W4 tiles on the card's SMs times a tile's work, in columns
    of products: its products, its unpack and its im2col build."""
    return _cdiv(m_tiles * _cdiv(o, bn), SMS) * (2 * bn + A_COLS)


def widths_for(o: int, mode: str = "codes", r_bytes: int = 0,
               staged: bool = True, groups: int = 1):
    """The tile widths compiled for a conv's epilogue: every width for f32
    and codes; for a residual the register route's (48, 96, 192) and,
    where r can be staged, the turns widths; the grouped build's own."""
    widths = WIDTHS if groups > 1 else tuple(sorted(WIDTHS + TURN_WIDTHS))
    if not r_bytes:
        return widths
    return tuple(w for w in widths if w != 256
                 and (w not in TURN_WIDTHS or staged))


@functools.lru_cache(maxsize=None)
def tile_plan(m: int, c: int, o: int, mode: str = "codes", *, stride: int = 2,
              width: int = 0, groups: int = 1, stages=None, resident=None,
              halo_bufs=None, r_bytes: int = 0, staged: bool = True,
              w4: bool = False, bn=None) -> ConvPlan:
    """The block plan of a conv with M output pixels, C → O channels in
    ``groups`` groups; a residual of ``r_bytes`` bytes a value (0: none)
    that TMA can stage where ``staged`` (rows of whole 16 bytes).

    The ResNets' widths (ungrouped, C % 16 == 0, O = 64, 128 or a multiple
    of 64 from 256 on, unless a residual cannot be staged): tiles of 64 or
    128 that take turns; where O ≥ 256, 256-wide tiles side by side, 128
    with a residual (staged at the turns widths only), and at W4 whichever
    of 256 and 128 gives fewer waves of tiles on the card times a tile's
    work (``_w4_cost``); where no plan of that width fits (a and b of
    thousands of columns beside a 256-wide ring), A0's rule.  Every other
    conv keeps the rule of RepVGG-A0's widths: the tile is as wide as the layer where that is a compiled width
    (48, 96, 192), else the smallest compiled width that covers O, else
    256-wide tiles side by side (codes: 192-wide).  ``bn`` overrides the
    width.  At the turns widths the ring has 4 stages (8 where asked:
    ``TURN_STAGES``).  The weight stays resident in shared memory where
    one tile covers O and it fits beside a ring of at least ``MIN_STAGES``
    stages; the ring then holds only im2col tiles, up to 6 stages, or 4
    where that lets two blocks of 48-wide tiles share an SM (the 48-wide
    kernel is compiled for two).  A streamed weight gets up to 4 stages.
    A stride-1 conv of ``width`` input columns with C % 16 == 0 fetches each
    tile's input pixels once, into one or two halo buffers (two where they
    fit beside the ring; 2 or 4 at the turns widths, ``TURN_HALOS``), and
    builds its im2col tiles from those (or, ``halo_gathered``, the
    consumers gather from them), except where its A tiles come by TMA
    (``tma_rows``); every other conv gathers them from ``x``.  ``stages``,
    ``resident`` and ``halo_bufs`` override the choice (the kernel is right
    at every plan that fits).  Raises where nothing fits.  The rules come
    from ``tools/conv_plans.py``'s timings on an H100.  A grouped conv
    chooses the width by the group's O/G columns, has ``n_tiles`` = G ×
    the tiles of a group, never keeps its weight resident (each group has
    its own), and uses halo buffers only where C/G % 16 == 0 too.
    """
    allowed = widths_for(o, mode, r_bytes, staged, groups)
    if bn is not None and bn not in allowed:
        raise ValueError(f"no {bn}-wide tile for this conv (compiled: "
                         f"{allowed})")
    if bn is None and groups == 1 and c % CHUNK == 0 and (
            not r_bytes or staged) and (o in TURN_WIDTHS
                                        or (o >= 256 and o % 64 == 0)):
        if o in TURN_WIDTHS:
            bn = o
        elif r_bytes:
            bn = 128         # a residual is staged at the turns widths
        elif w4:
            # the producers unpack a W4 B tile: 128 where that gives fewer
            # waves of less work
            bn = min((256, 128), key=lambda w: _w4_cost(_cdiv(m, BM), o, w))
        else:
            bn = 256
        try:
            return _plan_at(m, c, o, mode, stride, width, groups, stages,
                            resident, halo_bufs, r_bytes, bn)
        except ValueError:
            if (stages, resident, halo_bufs) != (None,) * 3:
                raise
            bn = None    # nothing fits (a and b of thousands of columns
            # beside a 256-wide ring): A0's rule
    if bn is None:
        bn = next((w for w in WIDTHS if w >= o // groups), WIDTHS[-1])
        if bn == 256 and mode == "codes":
            bn = 192   # A0's rule: codes past 192 in 192-wide tiles
    return _plan_at(m, c, o, mode, stride, width, groups, stages, resident,
                    halo_bufs, r_bytes, bn)


def _plan_at(m, c, o, mode, stride, width, groups, stages, resident,
             halo_bufs, r_bytes, bn) -> ConvPlan:
    """:func:`tile_plan`'s plan at the tile width ``bn``."""
    codes = mode == "codes"
    k_chunks = _cdiv(packed_shape(c, o, groups)[1], TILE_K)
    og = o // groups
    n_tiles = groups * _cdiv(og, bn)
    r_bytes = r_bytes if bn in TURN_WIDTHS else 0

    can_halo = (stride == 1 and c % CHUNK == 0
                and (c // groups) % CHUNK == 0 and width > 0)
    all_halos = TURN_HALOS if bn in TURN_WIDTHS else (2, 1, 0)
    if halo_bufs is None:
        # the A tiles by TMA where they can be (tma_rows), else a halo
        halos = all_halos if can_halo and not tma_rows(c, stride, groups) \
            else (0,)
    elif halo_bufs in all_halos and (can_halo or not halo_bufs):
        halos = (halo_bufs,)
    else:
        raise ValueError(f"halo_bufs = {halo_bufs} does not fit this conv")
    if resident and n_tiles != 1:
        raise ValueError("a resident weight needs one tile to cover O")
    if resident is None:
        residents = (True, False) if n_tiles == 1 else (False,)
    else:
        residents = (bool(resident),)

    def plan(stages, resident, halo_bufs, limit=MAX_SMEM):
        """The plan, or None if it does not fit ``limit`` bytes."""
        smem = plan_smem(bn, codes, stages, resident, k_chunks, n_tiles,
                         halo_bufs * halo_bytes(width, c,
                                                halo_gathered(bn, c, resident)),
                         r_bytes)
        if smem > limit or not MIN_STAGES <= stages <= MAX_STAGES or (
                bn in TURN_WIDTHS and stages not in TURN_STAGES):
            return None
        return ConvPlan(bn, stages, resident, halo_bufs, _cdiv(m, BM),
                        n_tiles, k_chunks, smem)

    # in order of preference: more halo buffers, the weight resident, and
    # the deepest ring; but first, for 48-wide tiles, two blocks an SM
    options = [(h, r) for h in halos for r in residents]
    found = None
    if bn == WIDTHS[0] and stages is None:
        found = next(filter(None, (plan(MIN_STAGES, r, h, HALF_SMEM)
                                   for h, r in options if r)), None)
    for h, r in options:
        depths = (stages,) if stages is not None else \
            (MIN_STAGES,) if bn in TURN_WIDTHS else \
            range(6 if r else 4, MIN_STAGES - 1, -1)
        found = found or next(filter(None, (plan(s, r, h) for s in depths)),
                              None)
    if found is None:
        raise ValueError(f"no plan fits shared memory for C = {c}, O = {o} "
                         f"(stages {stages}, resident {resident})")
    return found


def _check(x, w, a, b, stride, pad, lo, hi, mode, relu, pad_lo=1,
           residual=None, qb=0.0, row=None, groups=1):
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if pad_lo not in (0, 1) or (pad_lo == 0 and stride != 2):
        raise ValueError(f"pad_lo must be 1, or 0 at stride 2 (the SAME "
                         f"geometry of an even map), got {pad_lo!r} at "
                         f"stride {stride}")
    if not isinstance(pad, int) or not -128 <= pad <= 127:
        raise ValueError(f"pad must be an int8 code, got {pad!r}")
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C) int8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, h, wd, c = x.shape
    if n * h * wd * c == 0:
        raise ValueError(f"x is empty: {tuple(x.shape)}")
    if n * h * wd >= INT_LIMIT or max(h, wd) > 32766:
        raise ValueError(f"x has too many pixels: {tuple(x.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32 \
            or a.dim() != 1 or a.shape != b.shape:
        raise ValueError("a and b must be (O,) float32")
    o = a.shape[0]
    if not isinstance(groups, int):
        raise ValueError(f"groups must be an int, got {groups!r}")
    _check_groups(c, o, groups)
    shapes = ((torch.int8, packed_shape(c, o, groups)),
              (W4, packed_shape_int4(c, o, groups)))
    if (w.dtype, tuple(w.shape)) not in shapes:
        raise ValueError(f"w must be pack_weight() output of shape "
                         f"{shapes[0][1]} int8 or pack_weight_int4() "
                         f"output of shape {shapes[1][1]} uint8 for "
                         f"{groups} groups, got {tuple(w.shape)} {w.dtype}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if w.data_ptr() % 16 or (c % CHUNK == 0 and x.data_ptr() % 16):
        raise ValueError("w, and x when C % 16 == 0, must be 16-byte aligned")
    ho, wo = out_hw(h, wd, stride)
    check_epilogue("int8_conv3x3", mode, a, b, lo, hi, relu, residual, qb,
                   (n, ho, wo, o), x.device, row, groups)


def int8_conv3x3_plain(x, w, a, b, *, stride: int, pad: int,
                       pad_lo: int = 1, lo: int = -128, hi: int = 127,
                       mode: str = "codes", relu: bool = False,
                       residual=None, qb: float = 0.0,
                       row=None, groups: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result).

    ``acc`` is a float64 ``F.conv2d`` (``groups`` groups) over the
    pad-code-padded input, exact because |acc| ≤ 9·C·128² ≪ 2⁵³; the
    epilogue runs in float32 as separate ops, so nothing fuses them into
    an fma.
    """
    n, h, wd, c = x.shape
    o = a.shape[0]
    ho, wo = out_hw(h, wd, stride)
    wk = unpack_weight(w, c, o, groups)
    # pad_lo at the top and left; at the bottom and right what the last
    # window reaches past the map
    pad_h = (ho - 1) * stride + 3 - h - pad_lo
    pad_w = (wo - 1) * stride + 3 - wd - pad_lo
    xp = F.pad(x.permute(0, 3, 1, 2).to(torch.float64),
               (pad_lo, max(pad_w, 0), pad_lo, max(pad_h, 0)),
               value=float(pad))
    acc = F.conv2d(xp, wk.permute(3, 2, 0, 1).to(torch.float64),
                   stride=stride, groups=groups)
    return epilogue_plain(acc.permute(0, 2, 3, 1), a, b, mode=mode, lo=lo,
                          hi=hi, relu=relu, residual=residual, qb=qb,
                          row=row)


@functools.cache
def _library(grouped: bool = False) -> ctypes.CDLL:
    """The ungrouped build of the kernel, or its grouped build (groups > 1:
    ``csrc/int8_conv3x3_grouped.cu``)."""
    return bind(build.load("int8_conv3x3_grouped" if grouped
                           else "int8_conv3x3"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s C interface typed, its shared memory held against
    :func:`plan_smem` (a build of the source, or a variant of it)."""
    lib.dlmcq_int8_conv3x3.restype = ctypes.c_int
    lib.dlmcq_int8_conv3x3.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 20
        + [ctypes.c_float, ctypes.c_void_p])
    lib.dlmcq_int8_conv3x3_smem.restype = ctypes.c_int
    lib.dlmcq_int8_conv3x3_smem.argtypes = [ctypes.c_int] * 7
    # the source lays shared memory out as plan_smem() counts it, at every
    # width and epilogue it compiles
    grouped = lib.dlmcq_int8_conv3x3_smem(TURN_WIDTHS[0], 0, 4, 0, 1, 1,
                                          0) < 0
    for bn in widths_for(64, groups=2 if grouped else 1):
        for r_bytes in (0, 1, 4) if bn in TURN_WIDTHS else (0,):
            for args in ((bn, 1, 5, 0, 7, 2, 0), (bn, 0, 4, 1, 4, 1, 4800)):
                codes = bool(args[1] or r_bytes)
                want = plan_smem(bn, codes, *args[2:], r_bytes)
                got = lib.dlmcq_int8_conv3x3_smem(
                    bn, _epi(codes, r_bytes, bn), *args[2:])
                if got != want:
                    raise RuntimeError(
                        f"kernel shared memory {got} at {args}, r of "
                        f"{r_bytes} bytes, does not match the plan's {want}")
    return lib


def launch_plan(x, o: int, mode: str, stride: int, groups: int = 1,
                residual=None, _plan=None, w=None) -> ConvPlan:
    """:func:`tile_plan`'s plan of a launch on ``x`` (N, H, W, C) with the
    packed weight ``w`` (W4 or not; None: W8): a residual is staged where
    its rows are whole 16 bytes, contiguous and aligned (``residual`` ``(r,
    ar, br)`` or None)."""
    n, h, wd, c = x.shape
    ho, wo = out_hw(h, wd, stride)
    r_bytes, staged = 0, True
    w4 = w is not None and w.dtype == W4
    if residual is not None:
        r = residual[0]
        r_bytes = r.element_size()
        staged = (groups == 1 and o % CHUNK == 0 and r.is_contiguous()
                  and r.data_ptr() % 16 == 0)
    return tile_plan(n * ho * wo, c, o, mode, stride=stride, width=wd,
                     groups=groups, r_bytes=r_bytes, staged=staged, w4=w4,
                     **(_plan or {}))   # cached: a conv costs about a launch


def int8_conv3x3(x, w, a, b, *, stride: int, pad: int, pad_lo: int = 1,
                 lo: int = -128, hi: int = 127, mode: str = "codes",
                 relu: bool = False, residual=None, qb: float = 0.0,
                 row=None, groups: int = 1, _plan=None,
                 _lib=None) -> torch.Tensor:
    """Run the fused int8 3×3 conv (see the module docstring).

    ``x`` (N, H, W, C) int8, ``w`` from :func:`pack_weight` (or
    :func:`pack_weight_int4`: the kernel unpacks it) at the same
    ``groups``, ``a``/``b`` (O,) float32, ``residual`` ``(r, ar, br)`` or
    None, ``row`` ``(S, c)`` or None (``S`` (N, Ho, Wo) int32, in G > 1
    groups (N, Ho, Wo, G)), all contiguous and on one device.
    CUDA tensors launch the kernel on the current stream at
    :func:`tile_plan`'s plan (``_plan``: a dict of its overrides, for the
    card tests and for timing plans against each other) and count the
    launch in ``int8_conv3x3.launches`` (a grouped one in
    ``int8_conv3x3.grouped_launches`` as well; ``_lib``, a variant build
    bound by :func:`bind` for timing, launches uncounted); CPU tensors run
    the plain version.  On the card O is bounded by shared memory (a and b
    of every output channel sit beside the ring: a few thousand channels);
    ``tile_plan`` raises where nothing fits.
    """
    _check(x, w, a, b, stride, pad, lo, hi, mode, relu, pad_lo, residual, qb,
           row, groups)
    if x.device.type == "cpu":
        return int8_conv3x3_plain(x, w, a, b, stride=stride, pad=pad,
                                  pad_lo=pad_lo, lo=lo, hi=hi, mode=mode,
                                  relu=relu, residual=residual, qb=qb,
                                  row=row, groups=groups)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv3x3 runs on cuda or cpu, not {x.device}")
    n, h, wd, c = x.shape
    o = a.shape[0]
    ho, wo = out_hw(h, wd, stride)
    plan = launch_plan(x, o, mode, stride, groups, residual, _plan, w)
    lib = _lib or _library(groups > 1)
    out = torch.empty((n, ho, wo, o), device=x.device,
                      dtype=torch.int8 if mode == "codes" else torch.float32)
    r, ar, br = residual if residual is not None else (None, None, None)
    sums, c_row = row if row is not None else (None, None)
    with torch.cuda.device(x.device):
        err = lib.dlmcq_int8_conv3x3(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), *(t.data_ptr() if t is not None else None
                              for t in (r, ar, br, sums, c_row)),
            n, h, wd, c, o, groups, packed_shape(c, o, groups)[1],
            int(w.dtype == W4),
            stride, pad, pad_lo, lo, hi,
            int(mode == "codes"), int(relu),
            RESIDUAL_KINDS[r.dtype] if r is not None else 0, plan.bn,
            plan.stages, int(plan.resident), plan.halo_bufs, qb,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "int8_conv3x3")
    if _lib is not None:
        return out
    int8_conv3x3.launches += 1
    if groups > 1:
        int8_conv3x3.grouped_launches += 1
    return out


int8_conv3x3.launches = 0
int8_conv3x3.grouped_launches = 0
