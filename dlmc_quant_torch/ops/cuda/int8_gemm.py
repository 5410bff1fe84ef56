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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("int8_gemm")
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
    W4 weight; by default :func:`default_tile` for the device's SM count)
    and count the launch in ``int8_gemm.launches``; CPU tensors run the
    plain version.
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
    tile = tuple(tile) if tile is not None else default_tile(
        m, n, sm_count(x.device), tiles)
    if tile not in tiles:
        raise ValueError(f"int8_gemm: tile {tile} is not one of {tiles}")
    if x.device.type == "cpu":
        return int8_gemm_plain(x, w, a, b, mode=mode, lo=lo, hi=hi,
                               relu=relu, residual=residual, qb=qb, row=row)
    if x.device.type != "cuda":
        raise ValueError(f"int8_gemm runs on cuda or cpu, not {x.device}")
    lib = _library()
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
    build.check_launch(lib, err, "int8_gemm")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0
