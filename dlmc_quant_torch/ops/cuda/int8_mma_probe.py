"""int8 tensor-core rate probe with operands resident in shared memory.

The port of ``tools/vmem_gemm_probe.py:33`` (``make_probe``, inner
``kernel`` at ``:34``), the MMA-rate probe's kernel.  The CUDA source is
``csrc/int8_mma_probe.cu``; :mod:`.build` compiles it with ``nvcc`` for
``sm_90a`` at first use.  For ``x`` (M, K) int8 and ``nbufs`` weight
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
from dlmc_quant_torch.ops.cuda.int8_gemm import check_operands, unpack_b

ROLL_ROWS = 128     # rows per roll step
MAX_TILES = 22      # rolls + nbufs one launch can stage; the kernel's bound


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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("int8_mma_probe")
    lib.dlmcq_int8_mma_probe.restype = ctypes.c_int
    lib.dlmcq_int8_mma_probe.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.dlmcq_int8_mma_probe_max_tiles.restype = ctypes.c_int
    if lib.dlmcq_int8_mma_probe_max_tiles() != MAX_TILES:
        raise RuntimeError("the probe kernel stages "
                           f"{lib.dlmcq_int8_mma_probe_max_tiles()} tiles, "
                           f"the wrapper assumes {MAX_TILES}")
    return lib


def int8_mma_probe(x: torch.Tensor, w: torch.Tensor,
                   rolls: int) -> torch.Tensor:
    """The probe's sum (module docstring) → (M, N) int32.

    ``x`` (M, K) int8, ``w`` (nbufs, N, Kp) int8 from ``pack_b`` per buffer.
    CUDA tensors launch the kernel on the current stream and count the
    launch in ``int8_mma_probe.launches``; CPU tensors run the plain
    version.  Raises where rolls·nbufs·K·128² ≥ 2³¹ (the int32 sum could
    wrap) or rolls + nbufs > :data:`MAX_TILES`.
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
    if x.device.type == "cpu":
        return int8_mma_probe_plain(x, w, rolls)
    if x.device.type != "cuda":
        raise ValueError(f"int8_mma_probe runs on cuda or cpu, not {x.device}")
    lib = _library()
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.dlmcq_int8_mma_probe(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, kp, nbufs,
            rolls, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "int8_mma_probe")
    int8_mma_probe.launches += 1
    return out


int8_mma_probe.launches = 0
