"""The stem conv + pool kernel at ResNet-50's stem, band size against band size.

    python -m dlmc_quant_torch.tools.stem_bands [batch ...]

At each batch (8 and 256 by default) it runs ``int8_stem_pool`` on seeded
random codes (224×224×3, SAME pads (2, 3), 64 output channels) at every
band size (pooled rows a unit, 1 to 8), checks each result against the
plain version bit for bit, and prints µs per launch beside the bound (the
larger of the conv's int8 operations over 1979 TOP/s and bytes over 3.35
TB/s, H100 SXM data sheet; input, weight and pooled output counted once).
Times are per-launch medians of CUDA-graph replays of back-to-back
launches on the same operands; ``*`` marks :func:`band_rows`' choice.
This is the instrument for that rule.
"""

from __future__ import annotations

import sys

import torch

from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.ops.cuda import int8_stem_pool as S
from dlmc_quant_torch.utils.profiling import (bound_by, card_line, graph_ms,
                                              roof_ms)

SIZE, C, O, PADS, PAD = 224, 3, 64, ((2, 3), (2, 3)), 3
LAUNCHES, REPS, SEED = 16, 5, 0


def cost(n: int):
    """(operations, bytes) of the stem at batch ``n``."""
    hc, wc, hp, wp = S.geometry(SIZE, SIZE, PADS)
    ops = 2 * n * hc * wc * O * S.KERNEL ** 2 * C
    return ops, n * SIZE * SIZE * C + S.TAPS ** 2 * O * S.CELL \
        + 4 * n * hp * wp * O


def batch_rows(n: int, gen):
    """Time one batch at every band; returns its rows."""
    dev = gen.device
    x = torch.randint(-128, 128, (n, SIZE, SIZE, C), dtype=torch.int8,
                      device=dev, generator=gen)
    wp = S.pack_weight(torch.randint(-128, 128, (S.KERNEL, S.KERNEL, C, O),
                                     dtype=torch.int8, device=dev,
                                     generator=gen))
    want = S.int8_stem_pool_plain(x, wp, pads=PADS, pad=PAD)
    _, _, hp, wpool = S.geometry(SIZE, SIZE, PADS)
    chosen = S.band_rows(n, hp, wpool, O)
    ops_ms, bytes_ms = roof_ms(*cost(n))
    b_ms = max(ops_ms, bytes_ms)
    rows = []
    for band in range(1, S.MAX_BAND + 1):
        got = S.int8_stem_pool(x, wp, pads=PADS, pad=PAD, _band=band)
        if not torch.equal(got, want):
            raise RuntimeError(f"batch {n} band {band}: kernel differs from "
                               "its plain version")
        ms = graph_ms(lambda i: S.int8_stem_pool(x, wp, pads=PADS, pad=PAD,
                                                 _band=band), LAUNCHES, REPS)
        print(f"batch {n:3d} band {band} "
              f"{S.units(n, hp, wpool, O, band):5d} units"
              f"{' *' if band == chosen else '  '} {ms * 1e3:8.2f} us | "
              f"bound {b_ms * 1e3:7.2f} us ({bound_by(ops_ms, bytes_ms)}) "
              f"x{ms / b_ms:5.2f}", flush=True)
        rows.append(dict(batch=n, band=band, ms=ms, bound_ms=b_ms,
                         chosen=band == chosen))
    return rows


def main(argv=()):
    """Time every band at each batch of ``argv`` (default 8 and 256)."""
    batches = [int(a) for a in argv] or [8, 256]
    device = resolve_device(None)
    gen = torch.Generator(device=device).manual_seed(SEED)
    print(f"# stem_bands on {card_line()}; torch {torch.__version__}; "
          f"times: per launch, median of {REPS} replays of a CUDA graph of "
          f"{LAUNCHES} back-to-back launches; * = band_rows' choice")
    return [r for n in batches for r in batch_rows(n, gen)]


if __name__ == "__main__":
    main(sys.argv[1:])
