"""int8 tensor-core rate with operands resident in shared memory, per shape.

    python -m dlmc_quant_torch.tools.mma_probe [m k n]

The port of ``tools/vmem_gemm_probe.py``: the same shapes (``:103-113``, or
one ``m k n`` from the command line) and the same plan (``:60-61``): nbufs
weight buffers = clamp(6 MiB / (k·n), 1, 8) and rolls = max(1, 8 // nbufs),
so a shape does the same work as there.  One launch of
``int8_mma_probe`` computes Σ_r Σ_j roll(x, 128·r) @ w[j].

Per shape it prints µs per (m, k)×(k, n) product and TOP/s, the bound —
by purpose the operations bound, rolls·nbufs·2·m·k·n over 1979 TOP/s (H100
SXM data sheet), with the bytes time beside it — and one ``torch._int_mm``
call on the concatenated operands (X_cat (m, rolls·nbufs·k) of rolled
copies of x, W_cat the matching stack of the w[j]): the same sum and the
same MACs in one call, built once outside the timing.  The kernel's result
must equal ``torch._int_mm``'s exactly.  ``grid`` is the kernel's block
plan: 64 × 64 output tiles × the split of K (a split launch's time includes
zeroing the output), with the time of the same launch without the split
beside it.  Times are per-launch medians of
CUDA-graph replays of back-to-back launches on the same operands, which
stay in L2, as they stay in fast memory on the TPU.  Operands come from a
seeded ``torch.Generator`` on the card.
"""

from __future__ import annotations

import sys

import torch

from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.ops.cuda.int8_gemm import pack_b, sm_count
from dlmc_quant_torch.ops.cuda.int8_mma_probe import (block_plan,
                                                      int8_mma_probe,
                                                      roll_shift)
from dlmc_quant_torch.utils.profiling import card_line, graph_ms, roof_ms

SHAPES = (
    (512, 512, 512),       # sanity square
    (1024, 1728, 512),     # big sanity
    (192, 1728, 1024),     # cm orientation (O rows)
    (256, 1728, 1024),     # cm, O padded to 256
    (1024, 1728, 192),     # rm orientation (O cols)
    (1024, 1728, 256),     # rm, O padded
    (1024, 864, 128),      # rm stage2 padded
    (192, 576, 1024),      # dy-decomposed cm
    (1024, 576, 192),      # dy-decomposed rm
)
W_BUDGET = 6 * 2 ** 20   # weight-buffer bytes, as the TPU tool's VMEM budget
TARGET_DOTS = 8          # products per launch
LAUNCHES, REPS, SEED = 32, 5, 0


def plan(m: int, k: int, n: int):
    """(nbufs, rolls) of a shape, by the TPU tool's rule."""
    nbufs = max(1, min(8, W_BUDGET // (k * n)))
    return nbufs, max(1, TARGET_DOTS // nbufs)


def operands(m: int, k: int, n: int, gen: torch.Generator):
    """x (m, k) int8 and the packed weight buffers (nbufs, n, Kp) int8."""
    nbufs, _ = plan(m, k, n)
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8,
                      device=gen.device, generator=gen)
    w = torch.randint(-128, 128, (nbufs, k, n), dtype=torch.int8,
                      device=gen.device, generator=gen)
    return x, torch.stack([pack_b(wj) for wj in w])


def concat_operands(x: torch.Tensor, wp: torch.Tensor, rolls: int):
    """(X_cat, W_cat) with X_cat @ W_cat = the probe's sum.

    X_cat (m, rolls·nbufs·k) holds roll(x, 128·r) once for every (r, j);
    W_cat (rolls·nbufs·k, n), column-major, stacks w[j] in the same order.
    """
    m, k = x.shape
    nbufs = wp.shape[0]
    xs = [torch.roll(x, roll_shift(r, m), 0) for r in range(rolls)
          for _ in range(nbufs)]
    ws = [wp[j, :, :k] for _ in range(rolls) for j in range(nbufs)]
    return torch.cat(xs, 1), torch.cat(ws, 1).contiguous().t()


def cost(m: int, k: int, n: int):
    """(operations, bytes) of one launch: x, every w[j] and out once."""
    nbufs, rolls = plan(m, k, n)
    return 2 * m * k * n * nbufs * rolls, m * k + nbufs * k * n + 4 * m * n


def probe_shape(m, k, n, gen):
    """One row (dict) for a shape; raises if the result differs."""
    nbufs, rolls = plan(m, k, n)
    x, wp = operands(m, k, n, gen)
    xc, wc = concat_operands(x, wp, rolls)
    if not torch.equal(int8_mma_probe(x, wp, rolls), torch._int_mm(xc, wc)):
        raise RuntimeError(f"({m},{k},{n}): int8_mma_probe differs from "
                           "torch._int_mm on the concatenated operands")
    ms = graph_ms(lambda i: int8_mma_probe(x, wp, rolls), LAUNCHES, REPS)
    m_tiles, n_tiles, split = block_plan(m, n, k, sm_count(x.device))
    unsplit_ms = ms if split == 1 else graph_ms(
        lambda i: int8_mma_probe(x, wp, rolls, _split=1), LAUNCHES, REPS)
    lib_ms = graph_ms(lambda i: torch._int_mm(xc, wc), LAUNCHES, REPS)
    ops, nbytes = cost(m, k, n)
    ops_ms, bytes_ms = roof_ms(ops, nbytes)
    dots = nbufs * rolls
    print(f"({m:5d},{k:5d})x({k:5d},{n:5d}) [{nbufs}w x {rolls}r] grid "
          f"{m_tiles}x{n_tiles}x{split} (unsplit "
          f"{unsplit_ms / dots * 1e3:.3f} us/dot) "
          f"{ms / dots * 1e3:8.3f} us/dot {ops / ms / 1e9:7.1f} TOP/s | "
          f"ops bound {ops_ms / dots * 1e3:7.3f} us/dot (bytes "
          f"{bytes_ms / dots * 1e3:.3f}) | _int_mm {lib_ms / dots * 1e3:8.3f} "
          f"us/dot {ops / lib_ms / 1e9:7.1f} TOP/s", flush=True)
    return dict(m=m, k=k, n=n, nbufs=nbufs, rolls=rolls, split=split, ms=ms,
                unsplit_ms=unsplit_ms,
                library_ms=lib_ms, ops_ms=ops_ms, bytes_ms=bytes_ms)


def main(argv=()):
    """Probe the TPU tool's shapes, or the one ``m k n`` in ``argv``."""
    shapes = [tuple(int(a) for a in argv[:3])] if argv else SHAPES
    device = resolve_device(None)
    gen = torch.Generator(device=device).manual_seed(SEED)
    print(f"# mma_probe on {card_line()}; torch {torch.__version__}; "
          f"times: per launch, median of {REPS} replays of a CUDA graph of "
          f"{LAUNCHES} back-to-back launches; bound: operations")
    return [probe_shape(m, k, n, gen) for m, k, n in shapes]


if __name__ == "__main__":
    main(sys.argv[1:])
