"""int8 tensor-core rate probe with operands resident in shared memory.

The port of ``tools/vmem_gemm_probe.py:33`` (``make_probe``, inner
``kernel`` at ``:34``), the MMA-rate probe's kernel.  The CUDA source is
``csrc/int8_mma_probe.cu`` (``wgmma`` on tiles resident in swizzled shared
memory); :mod:`.build` compiles it with ``nvcc`` for ``sm_90a`` at first
use.  For ``x`` (M, K) int8 and ``nbufs`` weight
buffers ``w[j]`` (K, N) int8, each packed by
:func:`~dlmc_quant_torch.ops.cuda.int8_gemm.pack_b` and stacked as
(nbufs, N, Kp)::

    out = Σ_{r < rolls} Σ_{j < nbufs} roll(x, 128·r mod M, 0) @ w[j]   (int32)

with ``roll`` as ``torch.roll``/``numpy.roll`` along rows.  The TPU kernel
rolls an int32 view of 4 int8 rows by 32, hence 128 rows.

:func:`int8_mma_probe` launches the kernel for CUDA tensors and runs
:func:`int8_mma_probe_plain` for CPU tensors; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda.int8_gemm import (SMS, TILE_K, _cdiv,
                                                 check_operands, sm_count,
                                                 unpack_b)

ROLL_ROWS = 128     # rows per roll step
MAX_TILES = 9       # rolls + nbufs one launch can stage; the kernel's bound
BM = BN = 64        # the output tile of one block
SPLIT_SAVES = 3     # K chunks a split must save each block to pay for itself


def roll_shift(r: int, m: int) -> int:
    """Rows that roll ``r`` moves x by."""
    return ROLL_ROWS * r % m


def int8_mma_probe_plain(x: torch.Tensor, w: torch.Tensor,
                         rolls: int) -> torch.Tensor:
    """Plain PyTorch version: the same sum in float64, cast to int32."""
    m, k = x.shape
    wk = unpack_b(w, k).double()
    acc = torch.zeros((m, w.shape[1]), dtype=torch.float64, device=x.device)
    for r in range(rolls):
        xr = torch.roll(x, roll_shift(r, m), 0).double()
        for j in range(w.shape[0]):
            acc += xr @ wk[j]
    return acc.to(torch.int32)


def block_plan(m: int, n: int, k: int, sms: int = SMS):
    """(M tiles, N tiles, split) of one launch on ``sms`` SMs: the grid.

    A block owns a 64 × 64 output tile.  Where M·N gives fewer tiles than
    half the SMs, K's 128-byte chunks are split evenly over ``split``
    blocks, as many as keep the grid within one wave, and their partial
    sums are added into a zeroed output.  Zeroing and adding cost a launch
    about as long as a block takes for two or three chunks, so K is split
    only where that saves each block :data:`SPLIT_SAVES` chunks or more.
    """
    m_tiles, n_tiles = _cdiv(m, BM), _cdiv(n, BN)
    chunks = _cdiv(k, TILE_K)
    split = max(1, min(chunks, sms // (m_tiles * n_tiles)))
    if chunks - _cdiv(chunks, split) < SPLIT_SAVES:
        split = 1
    return m_tiles, n_tiles, split


def chunk_range(z: int, split: int, k: int):
    """The 128-byte K chunks [begin, end) of the ``z``-th of ``split``
    blocks: an even share, never empty for split ≤ chunks."""
    chunks = _cdiv(k, TILE_K)
    return z * chunks // split, (z + 1) * chunks // split


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("int8_mma_probe")
    lib.dlmcq_int8_mma_probe.restype = ctypes.c_int
    lib.dlmcq_int8_mma_probe.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.dlmcq_int8_mma_probe_max_tiles.restype = ctypes.c_int
    if lib.dlmcq_int8_mma_probe_max_tiles() != MAX_TILES:
        raise RuntimeError("the probe kernel stages "
                           f"{lib.dlmcq_int8_mma_probe_max_tiles()} tiles, "
                           f"the wrapper assumes {MAX_TILES}")
    return lib


def int8_mma_probe(x: torch.Tensor, w: torch.Tensor, rolls: int, *,
                   _split=None) -> torch.Tensor:
    """The probe's sum (module docstring) → (M, N) int32.

    ``x`` (M, K) int8, ``w`` (nbufs, N, Kp) int8 from ``pack_b`` per buffer.
    CUDA tensors launch the kernel on the current stream with
    :func:`block_plan`'s grid for the device's SM count and count the
    launch in ``int8_mma_probe.launches``; CPU tensors run the plain
    version.  Raises where rolls·nbufs·K·128² ≥ 2³¹ (the int32 sum could
    wrap) or rolls + nbufs > :data:`MAX_TILES`.  ``_split`` overrides the
    plan's split of K (1..ceil(K / 128)); it is for the tool, which times
    a launch with and without the split, and for the tests.
    """
    check_operands(x, w, "int8_mma_probe")
    if w.dim() != 3:
        raise ValueError(f"int8_mma_probe: w must be (nbufs, N, Kp), got "
                         f"{tuple(w.shape)}")
    m, k = x.shape
    nbufs, n, kp = w.shape
    if not isinstance(rolls, int) or rolls < 1:
        raise ValueError(f"int8_mma_probe: rolls must be an int >= 1, got "
                         f"{rolls!r}")
    if rolls * nbufs * k * 128 ** 2 >= 2 ** 31:
        raise ValueError(f"int8_mma_probe: {rolls} rolls x {nbufs} buffers "
                         f"x K = {k} could overflow int32")
    if rolls + nbufs > MAX_TILES:
        raise ValueError(f"int8_mma_probe: rolls + nbufs = {rolls + nbufs} "
                         f"exceeds the {MAX_TILES} tiles a block can stage")
    split = _split if _split is not None else block_plan(
        m, n, k, sm_count(x.device))[2]
    if not isinstance(split, int) or not 1 <= split <= _cdiv(k, TILE_K):
        raise ValueError(f"int8_mma_probe: _split must be an int in 1.."
                         f"{_cdiv(k, TILE_K)} for K = {k}, got {split!r}")
    if x.device.type == "cpu":
        return int8_mma_probe_plain(x, w, rolls)
    if x.device.type != "cuda":
        raise ValueError(f"int8_mma_probe runs on cuda or cpu, not {x.device}")
    lib = _library()
    # blocks that share a tile add their partial sums into zeros
    alloc = torch.zeros if split > 1 else torch.empty
    out = alloc((m, n), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.dlmcq_int8_mma_probe(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, kp, nbufs,
            rolls, split, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "int8_mma_probe")
    int8_mma_probe.launches += 1
    return out


int8_mma_probe.launches = 0
