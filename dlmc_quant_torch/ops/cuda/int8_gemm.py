"""Tiled int8 × int8 → int32 GEMM on the tensor cores.

The port of ``tools/pallas_gemm_sweep.py:37`` (``make_pallas_gemm``, body
``gemm_kernel`` at ``:31``), the GEMM-sweep tool's kernel.  The CUDA source
is ``csrc/int8_gemm.cu`` (its header says what bounds it on an H100 and how
it is laid out); :mod:`.build` compiles it with ``nvcc`` for ``sm_90a`` at
first use.  For ``x`` (M, K) int8 and ``w`` (K, N) int8, packed once by
:func:`pack_b`::

    out[m, n] = Σ_k x[m, k] · w[k, n]      (int32, M × N)

:func:`int8_gemm` launches the kernel for CUDA tensors and runs
:func:`int8_gemm_plain` for CPU tensors; there is no fallback from one to
the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dlmc_quant_torch.ops.cuda import build

MMA_K = 32                                     # depth of one mma.sync
TILES = ((128, 128), (128, 64), (64, 128))     # (BM, BN) compiled in
INT32_SAFE_K = 2 ** 31 // 128 ** 2             # K·128² must stay < 2³¹


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def packed_k(k: int) -> int:
    """K padded to the MMA depth: the row length of a packed B."""
    return _cdiv(k, MMA_K) * MMA_K


def pack_b(w: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 → (N, Kp) int8: K contiguous per output column, zero past K.

    This is the column-major B that ``mma.sync … .row.col`` reads; int8 has
    no ``ldmatrix.trans``, so the transpose happens here, once.
    """
    if w.dtype != torch.int8 or w.dim() != 2:
        raise ValueError(f"expected (K, N) int8, got {tuple(w.shape)} "
                         f"{w.dtype}")
    k, n = w.shape
    out = torch.zeros((n, packed_k(k)), dtype=torch.int8, device=w.device)
    out[:, :k] = w.t()
    return out


def unpack_b(wp: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_b` → (…, K, N) int8, for (…, N, Kp) input."""
    return wp[..., :k].transpose(-1, -2).contiguous()


def check_operands(x: torch.Tensor, w: torch.Tensor, what: str) -> None:
    """Raise unless ``x`` is (M, K) int8 and ``w`` a packed B of depth K.

    ``w`` is (…, N, roundup(K, 32)) int8; both contiguous, on one device.
    K must be a multiple of 16: the kernels copy A in 16-byte chunks.  A
    (K, N) weight that was never packed has the wrong shape unless N
    happens to equal roundup(K, 32).
    """
    if x.dtype != torch.int8 or x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"{what}: x must be non-empty (M, K) int8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    k = x.shape[1]
    if k % 16:
        raise ValueError(f"{what}: K = {k} must be a multiple of 16")
    if w.dtype != torch.int8 or w.shape[-1] != packed_k(k) \
            or w.shape[-2] == 0:
        raise ValueError(f"{what}: w must be pack_b() output (…, N, "
                         f"{packed_k(k)}) int8 for K = {k}, got "
                         f"{tuple(w.shape)} {w.dtype}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{what}: x and w must be 16-byte aligned")


def int8_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a float64 matmul cast to int32.

    Exact: every product and partial sum is an integer below 2⁵³.
    """
    return (x.double() @ unpack_b(w, x.shape[1]).double()).to(torch.int32)


def default_tile(m: int, n: int):
    """The compiled tile that wastes least of a (M, N) output."""
    if n <= 64:
        return 128, 64
    if m <= 64:
        return 64, 128
    return 128, 128


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("int8_gemm")
    lib.dlmcq_int8_gemm.restype = ctypes.c_int
    lib.dlmcq_int8_gemm.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return lib


def int8_gemm(x: torch.Tensor, w: torch.Tensor, *, tile=None) -> torch.Tensor:
    """(M, K) int8 @ packed (N, Kp) int8 → (M, N) int32 (module docstring).

    CUDA tensors launch the kernel on the current stream with ``tile``
    (one of :data:`TILES`; by default :func:`default_tile`) and count the
    launch in ``int8_gemm.launches``; CPU tensors run the plain version.
    Raises where K·128² ≥ 2³¹, where the kernel's int32 sum could wrap.
    """
    check_operands(x, w, "int8_gemm")
    if w.dim() != 2:
        raise ValueError(f"int8_gemm: w must be (N, Kp), got {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[0]
    if k >= INT32_SAFE_K:
        raise ValueError(f"int8_gemm: K = {k} could overflow int32")
    tile = tuple(tile) if tile is not None else default_tile(m, n)
    if tile not in TILES:
        raise ValueError(f"int8_gemm: tile {tile} is not one of {TILES}")
    if x.device.type == "cpu":
        return int8_gemm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"int8_gemm runs on cuda or cpu, not {x.device}")
    lib = _library()
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.dlmcq_int8_gemm(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, w.shape[1],
            *tile, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "int8_gemm")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0
