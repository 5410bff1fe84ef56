"""int8 window sums: the row term of a layer whose weight grid has an
offset.

A weight on the grid ``q·s_w + o_w`` (RootQ's after QAT, an offset LSQ
weight) adds ``s_x·o_w[o]·S[m]`` to the integer conv's output, ``S[m]``
the sum of the input codes less the zero code over the window of output
``m`` (``quant/layers.py``, ROADMAP item 13); the conv's and the GEMM's
epilogues add it per output channel (``ops/cuda/epilogue.py``).  The JAX
package drops ``o_w`` in its integer plan (ROADMAP hazard C1), so no TPU
kernel did this.  The CUDA source is ``csrc/int8_window_sum.cu``; its
header says what bounds it on an H100 and how its tiles work; :func:`plan`
picks the tiles per shape.  For input codes ``x`` (N, H, W, C) int8, a
k × k window at ``stride`` with pads ``((top, bottom), (left, right))``
and the zero code ``zero`` (the pad code)::

    S[n, p, q] = Σ_{dy, dx, c} (xpad[n, p·s − top + dy, q·s − left + dx, c] − zero)
    xpad = x padded with ``zero``: a pad adds 0
    Ho = (H + top + bottom − k) // s + 1

``S`` is (N, Ho, Wo) int32.  A grouped conv's (``groups`` G > 1, C = G·Cg:
RepVGG's g2/g4 variants with a weight offset) sums each group's Cg channels
apart, ``S[n, p, q, g]``, (N, Ho, Wo, G): the conv's output channel ``o``
reads its group ``o // (O/G)``.  The window is read from the NHWC codes, never
from a GEMM's rows: ``int8_gemm.pad_k`` fills their K tail with code 0,
not ``zero``.  A 1×1 window at stride s is a strided 1×1 conv's subsampled
input, and a dense layer's (M, K) input is (M, 1, 1, K) at 1×1.

:func:`int8_window_sum` launches the kernel for CUDA tensors and runs
:func:`int8_window_sum_plain` for CPU tensors; there is no fallback from
one to the other.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda.int8_im2col import out_hw

INT_LIMIT = 2 ** 31 - 1
THREADS = 256         # the kernel's block
MAX_SMEM = 48 * 1024  # shared memory a block, below the opt-in limit
MAX_REGION = 4096     # pixel sums a tile keeps in shared memory
MAX_COLUMNS = 512     # region columns of a tile
TILE_BYTES = 32768    # input bytes a tile aims at
SMS = 132             # an H100 SXM's SMs, as the plan models the card
MIN_TILES = 2 * SMS   # tiles a launch aims at, where the map allows

WindowPlan = collections.namedtuple(
    "WindowPlan", "n h w ho wo th tw se rh rw lanes tiles_y tiles_x tiles "
                  "smem groups")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def flat(kernel: int, stride: int, pads) -> bool:
    """A 1×1 window at stride 1 without pads: the kernel sees a run of
    pixels, (N, H, W) as (1, 1, N·H·W)."""
    return kernel == 1 and stride == 1 and not any(map(any, pads))


def make_plan(n: int, h: int, w: int, c: int, kernel: int, stride: int,
              pads, th: int, tw: int, lanes: int = None,
              groups: int = 1) -> WindowPlan:
    """The kernel's geometry for tiles of ``th`` × ``tw`` outputs (the C
    entry point derives the same from n, h, w, th, tw).  A pixel's
    16-byte chunks go to ``lanes`` lanes, each loading up to 4 at once; by
    default (the best of a sweep over config #5's 52 launches on an H100,
    ``tools/window_launches.py --sweep``) one lane a pixel below 8 chunks
    (C < 128), else a power of two near an eighth of the chunks, 4 to
    32.  In G ``groups`` the unit is a group's Cg channels of a pixel, and
    shared memory holds G sums a pixel."""
    ho, wo = out_hw(h, w, kernel, stride, pads)
    if flat(kernel, stride, pads):
        n, h, w, ho, wo = 1, 1, n * h * w, 1, n * h * w
    th, tw = min(th, ho), min(tw, wo)
    se = min(stride, kernel)
    rh, rw = (th - 1) * se + kernel, (tw - 1) * se + kernel
    chunks = _cdiv(c // groups, 16)
    if lanes is None:
        lanes = 1
        while chunks >= 8 and lanes < max(4, min(32, chunks // 8)):
            lanes *= 2
    smem = 4 * groups * (rh * rw + (rh * tw if kernel > 1 else 0))
    tiles_y, tiles_x = _cdiv(ho, th), _cdiv(wo, tw)
    return WindowPlan(n, h, w, ho, wo, th, tw, se, rh, rw, lanes, tiles_y,
                      tiles_x, n * tiles_y * tiles_x, smem, groups)


def _fits(p: WindowPlan) -> bool:
    return p.rh * p.rw * p.groups <= MAX_REGION and p.smem <= MAX_SMEM


@functools.lru_cache(maxsize=None)
def plan(n: int, h: int, w: int, c: int, kernel: int, stride: int,
         pads, groups: int = 1) -> WindowPlan:
    """Tiles for one launch.

    A flat run (:func:`flat`): ``TILE_BYTES`` of pixels a tile, at least
    one pass of the block's lanes, fewer until the launch has
    ``MIN_TILES`` tiles.  Otherwise columns:
    the full output width where its region is at most ``MAX_COLUMNS``
    pixels wide; rows: as many as keep the region's bytes within
    ``TILE_BYTES`` and its sums within shared memory, then fewer until the
    launch has ``MIN_TILES`` tiles (a small map's halo rows come from L2).
    Raises for a window whose 1×1 tile does not fit (k > 64).  In G
    ``groups`` the same, the region's sums G a pixel (an ungrouped plan
    is the plan of groups 1).
    """
    pads = tuple(map(tuple, pads))

    def at(th, tw):
        return make_plan(n, h, w, c, kernel, stride, pads, th, tw,
                         groups=groups)

    one = at(1, 1)
    if not _fits(one):
        raise ValueError(f"a {kernel}x{kernel} window does not fit the "
                         "window-sum kernel's shared memory")
    if flat(kernel, stride, pads):
        least = THREADS // one.lanes        # a pass of the block
        tw = max(least, TILE_BYTES // c)
        while tw > least and _cdiv(one.wo, tw) < MIN_TILES:
            tw = max(least, tw // 2)
        while not _fits(at(1, tw)):
            tw //= 2
        return at(1, tw)
    tw = min(one.wo, (MAX_COLUMNS - kernel) // one.se + 1)
    th = max(1, min(one.ho, TILE_BYTES
                    // (one.se * ((tw - 1) * one.se + kernel) * c)))
    while not _fits(at(th, tw)):
        if th > 1:
            th -= 1
        else:
            tw = _cdiv(tw, 2)
    while th > 1 and at(th, tw).tiles < MIN_TILES:
        th -= 1
    return at(th, tw)


def _check(x, zero, kernel, stride, pads, groups=1):
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
    if not isinstance(groups, int) or groups < 1 or c % groups:
        raise ValueError(f"{groups!r} groups do not divide C = {c}")
    ho, wo = out_hw(h, w, kernel, stride, pads)
    if ho < 1 or wo < 1:
        raise ValueError(f"the window does not fit: {tuple(x.shape)}, "
                         f"kernel {kernel}, pads {pads}")
    if n * ho * wo * groups >= INT_LIMIT:
        raise ValueError(f"x has too many outputs: {tuple(x.shape)}")
    return n, h, w, c, ho, wo


def int8_window_sum_plain(x: torch.Tensor, *, zero: int, kernel: int = 1,
                          stride: int = 1, pads=((0, 0), (0, 0)),
                          groups: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result):
    the channel sums of ``x − zero`` in float64 (over each group's channels
    as ``(…, G, Cg)``), padded with 0, then a float64 ``F.conv2d`` with a
    window of ones, exact (every partial sum is an integer below 2⁵³)."""
    n, h, w, c, ho, wo = _check(x, zero, kernel, stride, pads, groups)
    (top, bottom), (left, right) = pads
    pixels = (x.to(torch.float64) - zero).reshape(n, h, w, groups,
                                                  c // groups).sum(dim=-1)
    pixels = F.pad(pixels.permute(0, 3, 1, 2), (left, right, top, bottom))
    ones = torch.ones((groups, 1, kernel, kernel), dtype=torch.float64,
                      device=x.device)
    s = F.conv2d(pixels, ones, stride=stride, groups=groups)
    s = s[:, :, :ho, :wo].permute(0, 2, 3, 1)
    return (s if groups > 1 else s[..., 0]).to(torch.int32).contiguous()


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("int8_window_sum")
    lib.dlmcq_int8_window_sum.restype = ctypes.c_int
    lib.dlmcq_int8_window_sum.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 15 + [ctypes.c_void_p])
    return lib


def launch(x: torch.Tensor, zero: int, kernel: int, stride: int, pads,
           p: WindowPlan) -> torch.Tensor:
    """Launch the kernel on CUDA ``x`` with the tiles of ``p`` (any plan of
    :func:`make_plan` at x's shape and groups); no launch count."""
    (top, _), (left, _) = pads
    lib = _library()
    out = torch.empty((x.shape[0],) + out_hw(x.shape[1], x.shape[2], kernel,
                                             stride, pads)
                      + ((p.groups,) if p.groups > 1 else ()),
                      dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.dlmcq_int8_window_sum(
            x.data_ptr(), out.data_ptr(), p.n, p.h, p.w, x.shape[3], kernel,
            stride, top, left, p.ho, p.wo, zero, p.th, p.tw, p.lanes,
            p.groups, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "int8_window_sum")
    return out


def int8_window_sum(x: torch.Tensor, *, zero: int, kernel: int = 1,
                    stride: int = 1, pads=((0, 0), (0, 0)),
                    groups: int = 1) -> torch.Tensor:
    """(N, Ho, Wo) int32 window sums of ``x − zero``, or (N, Ho, Wo, G)
    in G > 1 ``groups`` (module docstring).

    CUDA tensors launch the kernel on the current stream and count the
    launch in ``int8_window_sum.launches`` (a grouped one in
    ``.launches_grouped`` as well); CPU tensors run the plain version.
    """
    n, h, w, c, _, _ = _check(x, zero, kernel, stride, pads, groups)
    if x.device.type == "cpu":
        return int8_window_sum_plain(x, zero=zero, kernel=kernel,
                                     stride=stride, pads=pads, groups=groups)
    if x.device.type != "cuda":
        raise ValueError(f"int8_window_sum runs on cuda or cpu, not "
                         f"{x.device}")
    out = launch(x, zero, kernel, stride, pads,
                 plan(n, h, w, c, kernel, stride, tuple(map(tuple, pads)),
                      groups))
    int8_window_sum.launches += 1
    int8_window_sum.launches_grouped += groups > 1
    return out


int8_window_sum.launches = 0
int8_window_sum.launches_grouped = 0
