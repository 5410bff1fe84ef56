"""The ImageNet ResNet stem: the int8 7×7/s2 conv, its 3×3/s2 max pool and
the consumer's epilogue.

One kernel computes what the JAX package's integer path does in three
steps at the stem: the XLA int8 conv on the pad-code-padded codes
(``dlmc_quant_tpu/quant/layers.py:721-728``), ``chain.qmaxpool`` on its
int32 accumulator (``dlmc_quant_tpu/quant/chain.py:135-155``) and the next
layer's ``chain.fold_quantize`` (or ``materialize``) of the pooled
accumulator.  The CUDA source is ``csrc/int8_stem_pool.cu``; its header
says what bounds it on an H100 and how its design keeps the conv's rows,
its unpooled accumulator and, in codes mode, its pooled one out of device
memory.  For input codes ``x`` (N, H, W, C) int8 and a weight ``w`` (7, 7,
C, O) int8 (packed once by :func:`pack_weight`)::

    acc[n,r,c,o]    = Σ_{dy,dx,ch} xpad[n, 2r+dy, 2c+dx, ch] · w[dy,dx,ch,o]   (int32)
    xpad            = x padded with the int8 code ``pad`` by ``pads``
    pooled[n,i,j,o] = max_{u,v ∈ 0..2} acc[n, 2i−1+u, 2j−1+v, o]
                      (rows and columns outside acc lose)

with Hc = (H + top + bottom − 7) // 2 + 1 and Hp = (Hc − 1) // 2 + 1
(likewise W).  The output (N, Hp, Wp, O) is, by ``mode``, ``pooled``
(``"int32"``) or :func:`.epilogue.epilogue_plain` of it with per-channel
``a``, ``b`` (``"codes"``: int8 ``clamp(rint(f32(pooled)·a + b), lo,
hi)``; ``"f32"``: ``f32(pooled)·a + b``, ReLU if ``relu``).  The pool runs
before the epilogue, as on the chain: with ``a > 0`` the epilogue is
monotone.  The kernel takes C ≤ 4 (every ImageNet ResNet has C = 3) and O
a multiple of 16 up to 128.  A weight of 4 bits or fewer comes
nibble-packed (:func:`pack_weight_int4`), and the kernel unpacks it where
it writes the resident weight into shared memory.

:func:`int8_stem_pool` launches the kernel for CUDA tensors and runs
:func:`int8_stem_pool_plain` for CPU tensors; there is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda.epilogue import check_epilogue, epilogue_plain
from dlmc_quant_torch.ops.cuda.nibbles import W4, pack_nibbles, unpack_nibbles

KERNEL, STRIDE = 7, 2     # the conv's window and stride
POOL = dict(kernel_size=3, stride=2, padding=1)
TAPS = 4                  # the 7×7/s2 window as 4×4 cells of 2×2 pixels
CELL = 16                 # bytes of a cell: (py, px, ch), so C ≤ 4
MAX_C, MAX_O = 4, 128
POOL_COLS = 63            # pooled columns of a unit: 127 conv columns
OT = 64                   # output channels of a unit
MAX_BAND = 8
MODES = ("int32", "codes", "f32")   # the kernel's mode codes 0, 1, 2
# units that keep an H100's 132 SMs busy: about 1.5 a multiprocessor
FILL_UNITS = 200
# the bands whose blocks fit two to a multiprocessor, and what a unit
# costs besides its conv rows (its cells, its weight tile, its first row's
# wait), in conv rows: fitted to tools/stem_bands.py's sweep on an H100
FIT_BANDS, UNIT_ROWS = range(1, 8), 1.3


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def geometry(h: int, w: int, pads):
    """(Hc, Wc, Hp, Wp): the conv's and the pool's output sizes."""
    (top, bottom), (left, right) = pads
    hc = (h + top + bottom - KERNEL) // STRIDE + 1
    wc = (w + left + right - KERNEL) // STRIDE + 1
    return hc, wc, (hc - 1) // 2 + 1, (wc - 1) // 2 + 1


def takes(c: int, o: int) -> bool:
    """Whether the kernel takes C input and O output channels."""
    return 1 <= c <= MAX_C and o % 16 == 0 and 16 <= o <= MAX_O


def units(n: int, hp: int, wp: int, o: int, band: int) -> int:
    """Work units of the kernel: (image, band of ``band`` pooled rows, band
    of 63 pooled columns, 64 output channels)."""
    return n * _cdiv(hp, band) * _cdiv(wp, POOL_COLS) * _cdiv(o, OT)


def band_rows(n: int, hp: int, wp: int, o: int) -> int:
    """Pooled rows a unit: of the bands that leave the card FILL_UNITS
    units (else 1), the one that computes the fewest conv rows, a unit
    of b pooled rows computing 2·b + 1 and costing UNIT_ROWS more; a
    band that divides Hp leaves no short unit.  ``python -m
    dlmc_quant_torch.tools.stem_bands`` times every band at ResNet-50's
    stem at batch 8 and 256, the instrument for this rule."""
    def cost(band):
        full, rest = divmod(hp, band)
        return full * (2 * band + 1 + UNIT_ROWS) + \
            (2 * rest + 1 + UNIT_ROWS if rest else 0)
    bands = [b for b in FIT_BANDS
             if units(n, hp, wp, o, b) >= FILL_UNITS] or [1]
    return min(bands, key=cost)


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(7, 7, C, O) int8 HWIO → (16, O, 16) int8, the kernel's layout.

    Chunk ``a·4 + b`` of output channel ``o`` holds the taps of cell (a, b)
    of the window: byte ``(2·py + px)·C + ch`` is ``w[2a+py, 2b+px, ch, o]``,
    zero at the taps 7 of the 8×8 cell window and past 4·C bytes.
    """
    if w.dtype != torch.int8 or w.dim() != 4 \
            or tuple(w.shape[:2]) != (KERNEL, KERNEL) \
            or not 1 <= w.shape[2] <= MAX_C:
        raise ValueError(f"expected (7, 7, C, O) int8 weights with C <= "
                         f"{MAX_C}, got {tuple(w.shape)} {w.dtype}")
    c, o = w.shape[2:]
    w8 = w.new_zeros((2 * TAPS, 2 * TAPS, c, o))
    w8[:KERNEL, :KERNEL] = w
    # (a, py, b, px, ch, o) → (a, b, o, py, px, ch)
    cells = w8.reshape(TAPS, 2, TAPS, 2, c, o).permute(0, 2, 5, 1, 3, 4)
    out = w.new_zeros((TAPS * TAPS, o, CELL))
    out[:, :, :4 * c] = cells.reshape(TAPS * TAPS, o, 4 * c)
    return out


def pack_weight_int4(w: torch.Tensor) -> torch.Tensor:
    """(7, 7, C, O) int8 HWIO in [-8, 7] → (16, O, 8) uint8: the layout of
    :func:`pack_weight`, each 16-byte cell in 8 bytes (cell byte 2j in the
    low nibble of byte j)."""
    return pack_nibbles(pack_weight(w))


def unpack_weight(wp: torch.Tensor, c: int) -> torch.Tensor:
    """Inverse of :func:`pack_weight` and :func:`pack_weight_int4` →
    (7, 7, C, O) int8."""
    if wp.dtype == W4:
        wp = unpack_nibbles(wp, CELL)
    o = wp.shape[1]
    cells = wp[:, :, :4 * c].reshape(TAPS, TAPS, o, 2, 2, c)
    w8 = cells.permute(0, 3, 1, 4, 5, 2).reshape(2 * TAPS, 2 * TAPS, c, o)
    return w8[:KERNEL, :KERNEL].contiguous()


def _check(x, wp, pads, pad):
    if x.dtype != torch.int8 or x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"x must be non-empty (N, H, W, C) int8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, h, w, c = x.shape
    if not isinstance(pad, int) or not -128 <= pad <= 127:
        raise ValueError(f"pad must be an int8 code, got {pad!r}")
    if any(p < 0 for pair in pads for p in pair):
        raise ValueError(f"pads must be >= 0, got {pads}")
    cell = CELL // 2 if wp.dtype == W4 else CELL
    if wp.dtype not in (torch.int8, W4) or wp.dim() != 3 \
            or (wp.shape[0], wp.shape[2]) != (TAPS * TAPS, cell):
        raise ValueError(f"w must be pack_weight() output (16, O, 16) int8 "
                         f"or pack_weight_int4() output (16, O, 8) uint8, "
                         f"got {tuple(wp.shape)} {wp.dtype}")
    o = wp.shape[1]
    if not takes(c, o):
        raise ValueError(f"the stem kernel takes C <= {MAX_C} and O a "
                         f"multiple of 16 up to {MAX_O}, got C = {c}, O = {o}")
    for name, t in (("x", x), ("w", wp)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if wp.data_ptr() % 16:
        raise ValueError("w must be 16-byte aligned")
    hc, wc, hp, wpool = geometry(h, w, pads)
    if hc < 1 or wc < 1:
        raise ValueError(f"the 7x7 window does not fit {tuple(x.shape)} at "
                         f"pads {pads}")
    if max(h, w) > 2 ** 29 or units(n, hp, wpool, o, 1) >= 2 ** 31:
        raise ValueError(f"x is too large for the kernel's indices: "
                         f"{tuple(x.shape)}")
    return n, h, w, c, o, hc, wc, hp, wpool


def _check_epilogue(mode, a, b, lo, hi, relu, out_shape, device):
    if mode not in MODES:
        raise ValueError(f"int8_stem_pool: mode must be one of {MODES}, got "
                         f"{mode!r}")
    if mode != "int32":
        check_epilogue("int8_stem_pool", mode, a, b, lo, hi, relu, None,
                       0.0, out_shape, device)
    elif a is not None or b is not None or relu:
        raise ValueError("int8_stem_pool: int32 mode takes no epilogue")


def int8_stem_pool_plain(x: torch.Tensor, wp: torch.Tensor, a=None, b=None,
                         *, pads, pad: int, mode: str = "int32",
                         lo: int = -128, hi: int = 127,
                         relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result).

    The conv is a float64 ``F.conv2d`` over the pad-code-padded codes, exact
    because |acc| ≤ 49·C·128² ≪ 2⁵³; the pool a float64 ``F.max_pool2d``,
    whose implicit −inf pads lose as JAX's ``iinfo.min`` does; then
    :func:`.epilogue.epilogue_plain` in codes and f32 modes.
    """
    n, _, _, c, o, _, _, hp, wpool = _check(x, wp, pads, pad)
    _check_epilogue(mode, a, b, lo, hi, relu, (n, hp, wpool, o), x.device)
    (top, bottom), (left, right) = pads
    xp = F.pad(x.permute(0, 3, 1, 2).to(torch.float64),
               (left, right, top, bottom), value=float(pad))
    wk = unpack_weight(wp, c).permute(3, 2, 0, 1).to(torch.float64)
    acc = F.conv2d(xp, wk, stride=STRIDE)
    pooled = F.max_pool2d(acc, **POOL).permute(0, 2, 3, 1)
    if mode == "int32":
        return pooled.to(torch.int32).contiguous()
    return epilogue_plain(pooled, a, b, mode=mode, lo=lo, hi=hi, relu=relu)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("int8_stem_pool")
    lib.dlmcq_int8_stem_pool.restype = ctypes.c_int
    lib.dlmcq_int8_stem_pool.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 + [ctypes.c_void_p])
    return lib


def int8_stem_pool(x: torch.Tensor, wp: torch.Tensor, a=None, b=None, *,
                   pads, pad: int, mode: str = "int32", lo: int = -128,
                   hi: int = 127, relu: bool = False,
                   _band=None) -> torch.Tensor:
    """(N, Hp, Wp, O): the stem conv's accumulator, max-pooled, as int32
    or through the epilogue (module docstring).

    ``x`` (N, H, W, C) int8 and ``wp`` from :func:`pack_weight` (or
    :func:`pack_weight_int4`: the kernel unpacks it), contiguous
    and on one device; ``pads`` ``((top, bottom), (left, right))``; ``pad``
    the int8 code of real 0; ``a``, ``b`` (O,) float32 in ``"codes"`` and
    ``"f32"`` modes, none in ``"int32"``.  CUDA tensors launch the kernel
    on the current stream with :func:`band_rows` pooled rows a unit
    (``_band`` overrides it, 1 to 8, for the card tests and for timing) and
    count the launch in ``int8_stem_pool.launches``; CPU tensors run the
    plain version.
    """
    n, h, w, c, o, hc, wc, hp, wpool = _check(x, wp, pads, pad)
    _check_epilogue(mode, a, b, lo, hi, relu, (n, hp, wpool, o), x.device)
    if x.device.type == "cpu":
        return int8_stem_pool_plain(x, wp, a, b, pads=pads, pad=pad,
                                    mode=mode, lo=lo, hi=hi, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"int8_stem_pool runs on cuda or cpu, not "
                         f"{x.device}")
    band = band_rows(n, hp, wpool, o) if _band is None else _band
    if not 1 <= band <= MAX_BAND:
        raise ValueError(f"band must be 1 to {MAX_BAND}, got {band}")
    (top, _), (left, _) = pads
    lib = _library()
    dtype = {"int32": torch.int32, "codes": torch.int8,
             "f32": torch.float32}[mode]
    out = torch.empty((n, hp, wpool, o), dtype=dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.dlmcq_int8_stem_pool(
            x.data_ptr(), wp.data_ptr(), out.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in (a, b)), n, h,
            w, c, o, top, left, hc, wc, pad, band, int(wp.dtype == W4),
            MODES.index(mode), lo, hi, int(relu),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "int8_stem_pool")
    int8_stem_pool.launches += 1
    return out


int8_stem_pool.launches = 0
