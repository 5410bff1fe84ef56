"""Tiled int8 × int8 → int32 GEMM on the tensor cores.

The port of ``tools/pallas_gemm_sweep.py:37`` (``make_pallas_gemm``, body
``gemm_kernel`` at ``:31``), the GEMM-sweep tool's kernel.  The CUDA source
is ``csrc/int8_gemm.cu`` (``wgmma`` from swizzled shared memory, fed by TMA;
its header says what bounds it on an H100 and how it is laid out);
:mod:`.build` compiles it with ``nvcc`` for ``sm_90a`` at first use.  For ``x`` (M, K) int8 and ``w`` (K, N) int8, packed once by
:func:`pack_b`::

    out[m, n] = Σ_k x[m, k] · w[k, n]      (int32, M × N)

That is ``mode="int32"``, the tools' output.  The chained int8 path of a
1×1 conv (and of the 7×7 stem, after ``int8_im2col``) ends the product
with the int8 conv's epilogue instead (:mod:`.epilogue`: ``"codes"``,
with an optional residual, or ``"f32"``, and in either a weight offset's
row term), so its int32 accumulator never reaches device memory.

Two routes end the product, chosen on the host from the shapes and dtypes
before the launch (:func:`route`), each a build of ``csrc/int8_gemm.cu``:

* ``"staged"`` (``csrc/int8_gemm_staged.cu``): a warp of its own loads the
  residual by TMA into shared memory while the tile's products run, the
  consumers read it there and write the output there, and one thread
  stores each box by TMA.  It takes a launch whose output rows (and r's)
  are whole 16 bytes, 16-byte aligned, at one of
  :data:`STAGED_TILE_STAGES` (an int32 launch at
  :data:`STAGED_INT32_TILES`): ResNet-50's GEMMs, every width that is a
  multiple of 16.
* ``"register"`` (``csrc/int8_gemm.cu``): the epilogue from registers,
  each lane loading r and storing its column pairs: every other launch,
  e.g. MobileNetV2's 24-channel blocks, whose rows TMA cannot describe,
  and the int32 tiles that the staged build does not have.

:func:`staged_emulated` walks the staged route's tiles, chunks, slots and
boxes on the CPU as the kernel does, for the tests.

A weight of 4 bits or fewer comes nibble-packed (:func:`pack_b_int4`: the
packed B, two bytes of K a byte) and stays so in device memory; the
kernel's W4 instantiations load it by TMA into one of two staging slots,
and two producer warps unpack it into the swizzled B tile that ``wgmma``
reads (:data:`W4_TILE_STAGES`).

:func:`int8_gemm` launches the kernel for CUDA tensors and runs
:func:`int8_gemm_plain` for CPU tensors; there is no fallback from one to
the other.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda.epilogue import (RESIDUAL_KINDS,
                                                check_epilogue,
                                                epilogue_plain)
from dlmc_quant_torch.ops.cuda.nibbles import W4, pack_nibbles, unpack_nibbles

MMA_K = 32                           # bytes of K one s8 wgmma consumes
TILE_K = 128                         # bytes of K in a shared-memory tile row
# (BM, BN) → stages of the shared-memory ring, as compiled into
# csrc/int8_gemm.cu: N = 48, 96, 192 exactly (RepVGG-A0's widths), 128 and
# 256 for wide outputs, 64-row tiles for M < 128.
TILE_STAGES = {(128, 256): 4, (128, 192): 5, (128, 128): 3, (128, 96): 4,
               (128, 48): 5, (64, 128): 4, (64, 64): 4}
TILES = tuple(TILE_STAGES)
# the tiles compiled with the epilogue modes (DLMCQ_EPILOGUE_TILE), for
# ResNet's widths 64 … 2048
EPILOGUE_TILES = ((128, 256), (128, 128), (64, 128), (64, 64))
# the W4 instantiations (every mode, int32 too) at the epilogue tiles, at
# their W8 stage counts: two staging slots of a packed B tile (BN x 64
# bytes) fit beside the ring
W4_TILE_STAGES = {t: TILE_STAGES[t] for t in EPILOGUE_TILES}
W4_STAGING_SLOTS = 2
MODES = ("int32", "codes", "f32")
# the staged route's tiles, at most these stages of the ring (fewer where
# its slots leave no room, at least 3 at W4: staged_stages), as compiled
# into csrc/int8_gemm.cu (DLMCQ_STAGED_TILE): 128 x 128 at 2 stages, so
# that two blocks share an SM
STAGED_TILE_STAGES = {(128, 256): 4, (128, 128): 2, (64, 128): 4,
                      (64, 64): 4}
# int32 takes the staged route at 128 x 256 only: there it matched the
# register route at 4096^3 and beat it at ResNet-50's downsamples, while the
# staged 128 x 128 keeps 2 stages for the epilogue modes, too few for a long
# K (PERF.md §6)
STAGED_INT32_TILES = ((128, 256),)
# the staged route's default tiles in an epilogue mode: those of at most 128
# columns, whose blocks two or more share an SM, so that one block's
# epilogue overlaps another's (PERF.md §6)
STAGED_EPILOGUE_TILES = tuple(t for t in STAGED_TILE_STAGES if t[1] <= 128)
OUT_BYTES = {"int32": 4, "codes": 1, "f32": 4}
WGMMA_M = 64                         # rows of a consumer warpgroup
MAX_SMEM = 232448                    # dynamic shared memory a block may use
SMS = 132                            # SMs of an H100 SXM: plans made off the card
INT32_SAFE_K = 2 ** 31 // 128 ** 2   # K·128² must stay < 2³¹


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sm_count(device) -> int:
    """SMs of a CUDA device; :data:`SMS` for any other (plans on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def packed_k(k: int) -> int:
    """K padded to the MMA depth: the row length of a packed B."""
    return _cdiv(k, MMA_K) * MMA_K


def pack_b(w: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 → (N, Kp) int8: K contiguous per output column, zero past K.

    This is the K-major B that ``wgmma`` takes for 8-bit types (it has no
    transposing form for them), so the transpose happens here, once.
    """
    if w.dtype != torch.int8 or w.dim() != 2:
        raise ValueError(f"expected (K, N) int8, got {tuple(w.shape)} "
                         f"{w.dtype}")
    k, n = w.shape
    out = torch.zeros((n, packed_k(k)), dtype=torch.int8, device=w.device)
    out[:, :k] = w.t()
    return out


def pack_b_int4(w: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 in [-8, 7] → (N, Kp/2) uint8: :func:`pack_b`'s layout
    with two bytes of K a byte (K index 2j in the low nibble of byte j).
    Kp is a multiple of 32, so the row pitch is whole 16 bytes, as TMA
    needs."""
    return pack_nibbles(pack_b(w))


def pad_k(x: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 → (M, roundup(K, 16)), zero past K: the depth the kernel
    takes (TMA's row pitch; MobileNetV2's 24-channel maps), exact against a
    weight packed by :func:`pack_b`, which is zero there too.  A copy where
    K % 16 != 0; ``x`` itself otherwise."""
    m, k = x.shape
    if k % 16 == 0:
        return x
    out = x.new_zeros((m, _cdiv(k, 16) * 16))
    out[:, :k] = x
    return out


def unpack_b(wp: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_b` (and of :func:`pack_b_int4`) → (…, K, N)
    int8, for (…, N, Kp) int8 or (…, N, Kp/2) uint8 input."""
    if wp.dtype == W4:
        wp = unpack_nibbles(wp, 2 * wp.shape[-1])
    return wp[..., :k].transpose(-1, -2).contiguous()


def check_operands(x: torch.Tensor, w: torch.Tensor, what: str,
                   int4: bool = False) -> None:
    """Raise unless ``x`` is (M, K) int8 and ``w`` a packed B of depth K.

    ``w`` is (…, N, roundup(K, 32)) int8 or, with ``int4``, also the
    nibble-packed (…, N, roundup(K, 32) / 2) uint8; both contiguous, on
    one device.
    K must be a multiple of 16: TMA needs row pitches of whole 16 bytes and
    ``cp.async`` copies 16-byte chunks.  A
    (K, N) weight that was never packed has the wrong shape unless N
    happens to equal roundup(K, 32).
    """
    if x.dtype != torch.int8 or x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"{what}: x must be non-empty (M, K) int8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    k = x.shape[1]
    if k % 16:
        raise ValueError(f"{what}: K = {k} must be a multiple of 16")
    nibbles = int4 and w.dtype == W4
    if w.dtype != (W4 if nibbles else torch.int8) or w.shape[-2] == 0 \
            or w.shape[-1] != packed_k(k) // (2 if nibbles else 1):
        raise ValueError(f"{what}: w must be pack_b() output (…, N, "
                         f"{packed_k(k)}) int8 for K = {k}"
                         + (f" or pack_b_int4() output (…, N, "
                            f"{packed_k(k) // 2}) uint8" if int4 else "")
                         + f", got {tuple(w.shape)} {w.dtype}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{what}: x and w must be 16-byte aligned")


def int8_gemm_plain(x: torch.Tensor, w: torch.Tensor, a=None, b=None, *,
                    mode: str = "int32", lo: int = -128, hi: int = 127,
                    relu: bool = False, residual=None,
                    qb: float = 0.0, row=None) -> torch.Tensor:
    """Plain PyTorch version (same arguments, same result): a float64
    matmul, exact (every product and partial sum is an integer below 2⁵³),
    cast to int32 or ended by :func:`.epilogue.epilogue_plain`."""
    acc = x.double() @ unpack_b(w, x.shape[1]).double()
    if mode == "int32":
        return acc.to(torch.int32)
    return epilogue_plain(acc, a, b, mode=mode, lo=lo, hi=hi, relu=relu,
                          residual=_flat(residual), qb=qb,
                          row=_flat_row(row))


def _flat(residual):
    """The residual with ``r`` as (M, N): callers may give it in the
    output's (…, N) shape."""
    if residual is None:
        return None
    r, ar, br = residual
    return r.reshape(-1, r.shape[-1]), ar, br


def _flat_row(row):
    """The row term with ``S`` as (M,): callers may give it in the
    output's (…) shape, as ``int8_window_sum`` makes it."""
    if row is None:
        return None
    sums, c = row
    return sums.reshape(-1), c


def tile_smem_bytes(tile, int4: bool = False) -> int:
    """Dynamic shared memory of a block at ``tile``: the ring's stages of a
    BM × 128 and a BN × 128 byte tile, and a full and an empty barrier each;
    at W4 (``int4``) also the staging slots of the packed BN × 64 byte tile,
    a barrier each."""
    bm, bn = tile
    stages = (W4_TILE_STAGES if int4 else TILE_STAGES)[tile]
    slots = W4_STAGING_SLOTS if int4 else 0
    return (stages * (bm + bn) * TILE_K + slots * bn * TILE_K // 2
            + (2 * stages + slots) * 8)


def staged_geometry(bn: int, mode: str, r_bytes: int = 0):
    """The staged route's chunk at a tile ``bn`` wide (``Staged`` in the
    source): (columns a chunk, chunks a tile, bytes of an r box row, of an
    output box row, whether the codes overwrite an int8 r in place, bytes
    of a slot).  A chunk is 128 bytes of a row of the widest of r
    (``r_bytes`` a value, 0 for none) and the output, or ``bn`` columns
    where that is less."""
    ob = OUT_BYTES[mode]
    cw = min(bn, TILE_K // max(r_bytes, ob))
    r_row, o_row = cw * r_bytes, cw * ob
    in_place = r_bytes == ob
    slot = WGMMA_M * r_row + (0 if in_place else WGMMA_M * o_row)
    return cw, bn // cw, r_row, o_row, in_place, slot


def staged_slots(mode: str) -> int:
    """A warpgroup's epilogue slots on the staged route: 3 in int32 mode
    (a store in flight while the next box is written), else 2."""
    return 3 if mode == "int32" else 2


def staged_params_bytes(bn: int, mode: str) -> int:
    """A warpgroup's staged per-column parameters ({a, b, ar, br} and c,
    20 bytes a column, in 1024-byte units; none in int32 mode)."""
    return 0 if mode == "int32" else _cdiv(bn * 20, 1024) * 1024


def staged_stages(tile, mode: str, r_bytes: int = 0,
                  int4: bool = False) -> int:
    """The ring's stages of a staged instantiation (``Cfg`` in the
    source): :data:`STAGED_TILE_STAGES` (at least 3 at W4), or as many as
    fit beside the W4 staging slots, the epilogue slots and the
    barriers."""
    bm, bn = tile
    want = max(STAGED_TILE_STAGES[tile], 3 if int4 else 0)
    return min(want, (MAX_SMEM - _staged_fixed(tile, mode, r_bytes, int4))
               // ((bm + bn) * TILE_K + 16))


def _staged_fixed(tile, mode, r_bytes, int4):
    bm, bn = tile
    wgs = bm // WGMMA_M
    slot = staged_geometry(bn, mode, r_bytes)[5]
    staging = W4_STAGING_SLOTS if int4 else 0
    slots = staged_slots(mode)
    bars = staging + (2 * wgs * slots if r_bytes else 0)
    return (staging * bn * TILE_K // 2
            + wgs * (slots * slot + staged_params_bytes(bn, mode))
            + 8 * bars)


def staged_smem_bytes(tile, mode: str, r_bytes: int = 0,
                      int4: bool = False) -> int:
    """Dynamic shared memory of a block of the staged route: the ring of
    :func:`staged_stages` stages with a full and an empty barrier each,
    and the rest (:func:`tile_smem_bytes`' parts, each warpgroup's
    :func:`staged_slots` slots and its staged parameters, with a residual
    an r full and an r empty barrier a slot)."""
    bm, bn = tile
    return (staged_stages(tile, mode, r_bytes, int4)
            * ((bm + bn) * TILE_K + 16)
            + _staged_fixed(tile, mode, r_bytes, int4))


def route(n: int, mode: str, tile, r=None) -> str:
    """The route of a launch, from the shapes and dtypes:
    ``"staged"`` where ``tile`` is one of :data:`STAGED_TILE_STAGES` (in
    int32 mode :data:`STAGED_INT32_TILES`) and TMA can describe the (M,
    ``n``) output and the residual ``r`` (rows of whole 16 bytes, r 16-byte
    aligned; the wrapper allocates the output aligned), ``"register"``
    otherwise."""
    if tuple(tile) not in (STAGED_INT32_TILES if mode == "int32"
                           else STAGED_TILE_STAGES):
        return "register"
    if n * OUT_BYTES[mode] % 16:
        return "register"
    if r is not None and (n * r.element_size() % 16 or r.data_ptr() % 16):
        return "register"
    return "staged"


def tile_count(tile, m: int, n: int) -> int:
    """Output tiles (M tiles × N tiles) of a (M, N) output at ``tile``."""
    return _cdiv(m, tile[0]) * _cdiv(n, tile[1])


def tile_cost(tile, m: int, n: int, sms: int = SMS) -> int:
    """What the busiest SM does at ``tile``, per byte of K: waves × (the
    tile's MACs + its operand bytes at 64 MACs a byte).

    The persistent grid walks ``tile_count`` tiles on ``sms`` SMs, so
    the busiest SM runs ceil(tiles / SMs) tiles, each BM·BN padded outputs
    from BM + BN operand rows.  64 MACs a byte is about where an SM's
    tensor cores outrun its share of the L2 bandwidth.  The measure charges
    the padding of a tile that overhangs M or N, the idle SMs of a grid
    with too few tiles, and the operand re-reads of a small tile.
    """
    bm, bn = tile
    return _cdiv(tile_count(tile, m, n), sms) * (bm * bn + 64 * (bm + bn))


def default_tile(m: int, n: int, sms: int = SMS, tiles=TILES):
    """The tile of ``tiles`` of least :func:`tile_cost` on ``sms`` SMs; ties
    go to the larger tile, which reads its operands fewer times.  Every tile
    is right at every shape; ``tools/gemm_sweep.py`` times them all."""
    return min(tiles, key=lambda t: (tile_cost(t, m, n, sms), -t[0] * t[1]))


def launch_tile(m: int, n: int, mode: str = "int32", int4: bool = False,
                r=None, sms: int = SMS):
    """The tile :func:`int8_gemm` takes by default: :func:`default_tile`
    among :data:`TILES` (int32 at W8), :data:`EPILOGUE_TILES`, or
    :data:`STAGED_EPILOGUE_TILES` for an epilogue on the staged route."""
    tiles = TILES if mode == "int32" and not int4 else EPILOGUE_TILES
    if mode != "int32" and route(n, mode, tiles[0], r) == "staged":
        tiles = STAGED_EPILOGUE_TILES
    return default_tile(m, n, sms, tiles)


@functools.cache
def _library(staged: bool = False) -> ctypes.CDLL:
    lib = build.load("int8_gemm_staged" if staged else "int8_gemm")
    lib.dlmcq_int8_gemm.restype = ctypes.c_int
    lib.dlmcq_int8_gemm.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.dlmcq_int8_gemm_epilogue.restype = ctypes.c_int
    lib.dlmcq_int8_gemm_epilogue.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 5
        + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    return lib


def int8_gemm(x: torch.Tensor, w: torch.Tensor, a=None, b=None, *,
              mode: str = "int32", lo: int = -128, hi: int = 127,
              relu: bool = False, residual=None, qb: float = 0.0,
              row=None, tile=None) -> torch.Tensor:
    """(M, K) int8 @ packed (N, Kp) int8 (or the nibble-packed (N, Kp/2)
    uint8 of :func:`pack_b_int4`) → (M, N) int32, or int8 codes or f32
    through the epilogue (module docstring).

    ``a``/``b`` (N,) float32, ``residual`` ``(r, ar, br)`` with ``r``
    (M, N) or of shape (…, N) over M rows, and ``row`` ``(S, c)`` with
    ``S`` int32 over the M rows in any shape, as :mod:`.epilogue` says.
    CUDA tensors launch the kernel on the current stream with ``tile`` (one
    of :data:`TILES`, of :data:`EPILOGUE_TILES` for an epilogue mode or a
    W4 weight; by default :func:`default_tile` for the device's SM count,
    among :data:`STAGED_EPILOGUE_TILES` for an epilogue on the staged
    route)
    and count the launch in ``int8_gemm.launches`` (a staged one in
    ``int8_gemm.launches_staged`` too) on the route :func:`route` names.
    CPU tensors run the plain version.
    Raises where K·128² ≥ 2³¹, where the kernel's int32 sum could wrap.
    """
    check_operands(x, w, "int8_gemm", int4=True)
    if w.dim() != 2:
        raise ValueError(f"int8_gemm: w must be (N, Kp), got {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[0]
    if k >= INT32_SAFE_K:
        raise ValueError(f"int8_gemm: K = {k} could overflow int32")
    if mode not in MODES:
        raise ValueError(f"int8_gemm: mode must be one of {MODES}, got "
                         f"{mode!r}")
    int4 = w.dtype == W4
    tiles = EPILOGUE_TILES if int4 else TILES
    if mode != "int32":
        residual, row = _flat(residual), _flat_row(row)
        check_epilogue("int8_gemm", mode, a, b, lo, hi, relu, residual, qb,
                       (m, n), x.device, row)
        tiles = EPILOGUE_TILES
    elif a is not None or residual is not None or row is not None:
        raise ValueError("int8_gemm: int32 mode takes no epilogue")
    r = residual[0] if residual is not None else None
    tile = tuple(tile) if tile is not None else launch_tile(
        m, n, mode, int4, r, sm_count(x.device))
    if tile not in tiles:
        raise ValueError(f"int8_gemm: tile {tile} is not one of {tiles}")
    if x.device.type == "cpu":
        return int8_gemm_plain(x, w, a, b, mode=mode, lo=lo, hi=hi,
                               relu=relu, residual=residual, qb=qb, row=row)
    if x.device.type != "cuda":
        raise ValueError(f"int8_gemm runs on cuda or cpu, not {x.device}")
    way = route(n, mode, tile, r)
    lib = _library(way == "staged")
    dtype = {"int32": torch.int32, "codes": torch.int8,
             "f32": torch.float32}[mode]
    out = torch.empty((m, n), dtype=dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if mode == "int32":
            err = lib.dlmcq_int8_gemm(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                packed_k(k), int(int4), *tile, stream)
        else:
            r, ar, br = residual if residual is not None else (None,) * 3
            sums, c = row if row is not None else (None,) * 2
            err = lib.dlmcq_int8_gemm_epilogue(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                packed_k(k), int(int4), *tile, int(mode == "codes"),
                a.data_ptr(),
                b.data_ptr(), *(t.data_ptr() if t is not None else None
                                for t in (r, ar, br)), qb, lo, hi, int(relu),
                RESIDUAL_KINDS[r.dtype] if r is not None else 0,
                *(t.data_ptr() if t is not None else None
                  for t in (sums, c)), stream)
    build.check_launch(lib, err, f"int8_gemm ({way} route)")
    int8_gemm.launches += 1
    int8_gemm.launches_staged += way == "staged"
    return out


int8_gemm.launches = 0
int8_gemm.launches_staged = 0


MAGIC, MAGIC_BITS = 12582912.0, 0x4B400000   # 1.5 * 2^23 and its bits


def swizzle_box(offset, row_bytes: int):
    """``swizzle_box`` of the source: byte ``offset`` of a box of rows
    ``row_bytes`` long (32, 64, 128) in the TMA swizzle of that width
    (ints or numpy arrays)."""
    return offset ^ (((offset >> 7) & (row_bytes // 16 - 1)) << 4)


def staged_emulated(x, w, a=None, b=None, *, mode: str = "int32",
                    lo: int = -128, hi: int = 127, relu: bool = False,
                    residual=None, qb: float = 0.0, row=None, tile,
                    sms: int = 3, seed: int = 0) -> torch.Tensor:
    """The staged route's walk on the CPU, step for step as the kernel
    takes it (:func:`int8_gemm`'s arguments; ``tile`` one of
    :data:`STAGED_TILE_STAGES`, ``sms`` blocks of the persistent grid).

    Each block walks its tiles, each warpgroup its 64 rows of a tile chunk
    by chunk (:func:`staged_geometry`), its chunk count picking the slot;
    the r box is loaded into the slot as TMA loads it (zeros past M and
    N, laid out by :func:`swizzle_box`), every thread of the warpgroup
    reads its column pairs from its accumulator registers (the lane map)
    and from the slot and writes its outputs into the slot's output box
    (in place over an int8 r), and the box is stored as TMA stores it
    (what lies past M or N not written).  Slots start as noise (``seed``).
    The float32 steps are the kernel's, one rounded op each."""
    m, k = x.shape
    n = w.shape[0]
    bm, bn = tile
    residual, row = _flat(residual), _flat_row(row)
    r = residual[0] if residual is not None else None
    rb = r.element_size() if r is not None else 0
    ob = OUT_BYTES[mode]
    cw, chunks, r_row, o_row, in_place, slot_bytes = staged_geometry(
        bn, mode, rb)
    acc_all = (x.double() @ unpack_b(w, k).double()).to(torch.int64)
    out = np.zeros((m, n * ob), np.uint8)
    r_bytes = (np.ascontiguousarray(r.numpy()).view(np.uint8)
               .reshape(m, n * rb) if r is not None else None)
    noise = np.random.default_rng(seed)
    wgs = bm // WGMMA_M
    n_slots = staged_slots(mode)
    slots = noise.integers(0, 256, (wgs, n_slots, slot_bytes),
                           dtype=np.uint8)
    # the lane map: thread t holds d[4 i + 2 h + e] = row 16 (t / 32) +
    # (t % 32) / 4 + 8 h, column 8 i + 2 (t % 4) + e of its warpgroup's block
    t = np.arange(128)[:, None, None]
    h = np.arange(2)[None, :, None]
    rows_in = 16 * (t // 32) + (t % 32) // 4 + 8 * h          # (128, 2, 1)
    m_tiles = _cdiv(m, bm)
    tiles = m_tiles * _cdiv(n, bn)
    grid = min(tiles, sms)
    box_y, box_x = np.meshgrid(np.arange(WGMMA_M), np.arange(max(r_row, 1)),
                               indexing="ij")
    for block in range(grid):
        ch = [0] * wgs
        for tile_i in range(block, tiles, grid):
            m0, n0 = (tile_i % m_tiles) * bm, (tile_i // m_tiles) * bn
            for wg in range(wgs):
                row0 = m0 + WGMMA_M * wg
                if row0 >= m:
                    continue
                # the accumulator registers of the warpgroup's threads
                blk = torch.zeros((WGMMA_M, bn), dtype=torch.int64)
                got = acc_all[row0:row0 + WGMMA_M, n0:n0 + bn]
                blk[:got.shape[0], :got.shape[1]] = got
                i = np.arange(bn // 8)[None, None, :]
                d = blk.numpy()[rows_in[..., None],
                                (8 * i + 2 * (t % 4))[..., None]
                                + np.arange(2)]     # (128, 2, BN/8, 2)
                for c in range(chunks):
                    chunk0 = n0 + c * cw
                    if chunk0 >= n:
                        break
                    slot = slots[wg, ch[wg] % n_slots]
                    if r is not None:       # the loader's TMA load
                        gy, gx = row0 + box_y, chunk0 * rb + box_x
                        inside = (gy < m) & (gx < n * rb)
                        slot[swizzle_box(box_y * r_row + box_x, r_row)] = \
                            np.where(inside, r_bytes[np.minimum(gy, m - 1),
                                                     np.minimum(gx, n * rb
                                                                - 1)], 0)
                    o_base = 0 if in_place else WGMMA_M * r_row
                    j = np.arange(cw // 8)[None, None, :]
                    cwp = 8 * j + 2 * (t % 4)                 # (128, 1, CW/8)
                    vals = d[:, :, c * (cw // 8):(c + 1) * (cw // 8), :]
                    cols = chunk0 + cwp[..., None] + np.arange(2)
                    rows_b = np.broadcast_to(rows_in[..., None],
                                             vals.shape)
                    y = _staged_values(mode, vals, rows_b, cols, row0, m, n,
                                       a, b, residual, qb, row, relu, lo, hi,
                                       slot, rb, r_row, cwp)
                    off = o_base + swizzle_box(
                        rows_b * o_row + ob * np.broadcast_to(
                            cwp[..., None], vals.shape), o_row) \
                        + ob * np.arange(2)
                    slot.view(y.dtype)[off // ob] = y
                    # the TMA store of the output box
                    oy, ox = np.meshgrid(np.arange(WGMMA_M),
                                         np.arange(o_row), indexing="ij")
                    gy, gx = row0 + oy, chunk0 * ob + ox
                    keep = (gy < m) & (gx < n * ob)
                    out[gy[keep], gx[keep]] = slot[
                        o_base + swizzle_box(oy * o_row + ox, o_row)][keep]
                    ch[wg] += 1
    dtype = {"int32": np.int32, "codes": np.int8, "f32": np.float32}[mode]
    return torch.from_numpy(out.view(dtype).reshape(m, n).copy())


def _staged_values(mode, vals, rows_b, cols, row0, m, n, a, b, residual, qb,
                   row, relu, lo, hi, slot, rb, r_row, cwp):
    """The values a warpgroup writes for one chunk: ``vals`` its
    accumulator pairs (thread, h, pair, e), ``rows_b`` their rows in the
    block, ``cols`` their columns; parameters read where the column is
    inside N (else 0), S where the row is inside M, r from the slot."""
    if mode == "int32":
        return vals.astype(np.int32)
    inside = cols < n
    at = np.minimum(cols, n - 1)

    def per_col(v):
        return torch.from_numpy(np.where(inside, v.numpy()[at], 0)
                                .astype(np.float32))

    acc = torch.from_numpy(vals.astype(np.int32)).to(torch.float32)
    prod = acc * per_col(a)
    if row is not None:
        sums, c = row
        grow = row0 + rows_b
        s = np.where(grow < m, sums.numpy()[np.minimum(grow, m - 1)], 0)
        prod = prod + torch.from_numpy(s.astype(np.int32)).to(
            torch.float32) * per_col(c)
    if residual is not None:
        r, ar, br = residual
        off = swizzle_box(rows_b * r_row + rb * np.broadcast_to(
            cwp[..., None], vals.shape), r_row) + rb * np.arange(2)
        rdt = {torch.int8: np.int8, torch.int32: np.int32,
               torch.float32: np.float32}[r.dtype]
        rv = slot.view(rdt)[off // rb].copy()
        if rdt == np.int8:      # the magic number's float less the magic
            rv = (rv.astype(np.int32) + MAGIC_BITS).view(np.float32) \
                - np.float32(MAGIC)
        rv = torch.from_numpy(rv).to(torch.float32)
        y = (torch.tensor(qb, dtype=torch.float32) + prod) + per_col(b)
        y = (y + rv * per_col(ar)) + per_col(br)
    else:
        y = prod + per_col(b)
    if mode == "f32":
        if relu:
            y = torch.clamp_min(y, 0.0)
        return y.numpy()
    # clamped, rounded by the magic sum; the code is its bits' low byte
    bits = (np.clip(y.numpy(), np.float32(lo), np.float32(hi))
            + np.float32(MAGIC)).view(np.int32)
    return (bits & 0xFF).astype(np.uint8).view(np.int8)
