"""int8 GEMM rate against shape on the card, kernel beside torch._int_mm.

    python -m dlmc_quant_torch.tools.gemm_sweep

The port of ``tools/pallas_gemm_sweep.py``.  Shapes: the TPU tool's
(``:90-107``: 4096³; channel-major (O, 9C)×(9C, 16384) for C ∈ {48, 96,
192}; row-major (16384, 192)×(192, 192); row-major patch (16384, 9C)×(9C, C)
for C ∈ {96, 192}) and RepVGG-A0's 3×3 convs as GEMMs at the serving batch
256 (stage1_1, stage2_1, stage3_1: (N·H·W, 9C)×(9C, C)).  The TPU tool's
bm/bn were VMEM design points; here each shape runs at every tile the CUDA
kernel is compiled with (each is right at every shape), the default tile
marked ``*``.

Per shape and tile it prints the kernel's µs and TOP/s, the bound (the
larger of operations over 1979 TOP/s and bytes over 3.35 TB/s, H100 SXM
data sheet) and one ``torch._int_mm`` call's µs on the same operands.  The
kernel's result must equal ``torch._int_mm``'s exactly.  Times are
per-launch medians of CUDA-graph replays of back-to-back launches that
rotate among enough operand copies to exceed the 50 MB L2, so each launch
reads its operands from HBM as the bound assumes.  The header line also
gives the rate of a device-to-device copy, the practical memory rate to
read the bytes-bound rows against.  Operands come from a seeded
``torch.Generator`` on the card.
"""

from __future__ import annotations

import torch

from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.ops.cuda.int8_gemm import (TILES, default_tile,
                                                 int8_gemm, pack_b, sm_count,
                                                 tile_count)
from dlmc_quant_torch.utils.profiling import (bound_by, card_line, copy_rate,
                                              graph_ms, roof_ms)

SHAPES = (   # (name, M, K, N)
    ("square-4096", 4096, 4096, 4096),
    ("cm O=48 K=432 M=16384", 48, 432, 16384),
    ("cm O=96 K=864 M=16384", 96, 864, 16384),
    ("cm O=192 K=1728 M=16384", 192, 1728, 16384),
    ("rm M=16384 K=192 O=192", 16384, 192, 192),
    ("rm-patch M=16384 K=864 O=96", 16384, 864, 96),
    ("rm-patch M=16384 K=1728 O=192", 16384, 1728, 192),
    ("A0 stage1_1 b256", 256 * 56 * 56, 9 * 48, 48),
    ("A0 stage2_1 b256", 256 * 28 * 28, 9 * 96, 96),
    ("A0 stage3_1 b256", 256 * 14 * 14, 9 * 192, 192),
)
L2_BYTES = 50 * 10 ** 6
LAUNCHES, REPS, SEED = 32, 5, 0


def operands(m: int, k: int, n: int, gen: torch.Generator):
    """x (M, K), w (K, N) int8 on the generator's device, uniform codes."""
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8,
                      device=gen.device, generator=gen)
    w = torch.randint(-128, 128, (k, n), dtype=torch.int8,
                      device=gen.device, generator=gen)
    return x, w


def col_major(wp: torch.Tensor, k: int) -> torch.Tensor:
    """The (K, N) column-major view of a packed B, for ``torch._int_mm``."""
    return wp[:, :k].contiguous().t()


def cost(m: int, k: int, n: int):
    """(operations, bytes): each input read once, the output written once."""
    return 2 * m * k * n, m * k + k * n + 4 * m * n


def sweep_shape(name, m, k, n, gen):
    """Rows (dicts) of one shape at each compiled tile; raises if a result
    differs."""
    ops, nbytes = cost(m, k, n)
    copies = max(1, min(LAUNCHES, -(-2 * L2_BYTES // (m * k + k * n))))
    xs, wps, wcs = [], [], []
    for _ in range(copies):
        x, w = operands(m, k, n, gen)
        xs.append(x)
        wps.append(pack_b(w))
        wcs.append(col_major(wps[-1], k))
    ref = torch._int_mm(xs[0], wcs[0])
    lib_ms = graph_ms(lambda i: torch._int_mm(xs[i % copies], wcs[i % copies]),
                      LAUNCHES, REPS)
    ops_ms, bytes_ms = roof_ms(ops, nbytes)
    rows = []
    default = default_tile(m, n, sm_count(gen.device))
    for tile in TILES:
        if not torch.equal(int8_gemm(xs[0], wps[0], tile=tile), ref):
            raise RuntimeError(f"{name} tile {tile}: int8_gemm differs from "
                               "torch._int_mm")
        ms = graph_ms(lambda i: int8_gemm(xs[i % copies], wps[i % copies],
                                          tile=tile), LAUNCHES, REPS)
        row = dict(name=name, m=m, k=k, n=n, tile=tile,
                   default=tile == default, ms=ms,
                   library_ms=lib_ms, ops_ms=ops_ms, bytes_ms=bytes_ms)
        rows.append(row)
        print(f"{name:30s} ({m:6d},{k:5d})x({k:5d},{n:5d}) tile {tile[0]:3d}x"
              f"{tile[1]:<3d}{'*' if row['default'] else ' '} "
              f"{ms * 1e3:9.2f} us {ops / ms / 1e9:7.1f} TOP/s | bound "
              f"{max(ops_ms, bytes_ms) * 1e3:8.2f} us "
              f"({bound_by(ops_ms, bytes_ms)}) | _int_mm "
              f"{lib_ms * 1e3:9.2f} us {ops / lib_ms / 1e9:7.1f} TOP/s | "
              f"{tile_count(tile, m, n)} tiles, {copies} copies", flush=True)
    return rows


def main():
    """Sweep :data:`SHAPES` on the card; returns every row."""
    device = resolve_device(None)
    gen = torch.Generator(device=device).manual_seed(SEED)
    print(f"# gemm_sweep on {card_line()}; torch {torch.__version__}; "
          f"times: per launch, median of {REPS} replays of a CUDA graph of "
          f"{LAUNCHES} back-to-back launches; * = default tile")
    print(f"# a device-to-device copy of 256 MiB moves "
          f"{copy_rate() / 1e12:.3f} TB/s on this card (the byte bounds "
          f"assume the data sheet's 3.35)")
    rows = []
    for name, m, k, n in SHAPES:
        rows += sweep_shape(name, m, k, n, gen)
    return rows


if __name__ == "__main__":
    main()
