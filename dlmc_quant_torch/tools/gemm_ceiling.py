"""The card's GEMM ceiling through PyTorch's own calls: int8 against bf16.

    python -m dlmc_quant_torch.tools.gemm_ceiling

The port of ``tools/gemm_ceiling.py``, and the library yardstick for the
port's int8 kernels: ``torch._int_mm`` s8×s8 → s32 (B row-major and B
column-major) and bf16 ``torch.matmul`` at 4096³, three rounds, TOP/s =
2·M·N·K / time.  Times are per-launch medians of CUDA-graph replays of
back-to-back launches on the same operands.  The TPU tool's u8×s8 variant
has no PyTorch call (``torch._int_mm`` takes int8 only), so it is reported
as not measured.  Operands come from a seeded ``torch.Generator`` on the
card.
"""

from __future__ import annotations

import torch

from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.utils.profiling import card_line, graph_ms

M = N = K = 4096
ROUNDS, LAUNCHES, REPS, SEED = 3, 16, 5, 0


def main():
    """Time each variant ``ROUNDS`` times; returns the best TOP/s of each."""
    device = resolve_device(None)
    gen = torch.Generator(device=device).manual_seed(SEED)
    xi = torch.randint(-128, 128, (M, K), dtype=torch.int8, device=device,
                       generator=gen)
    wi = torch.randint(-128, 128, (K, N), dtype=torch.int8, device=device,
                       generator=gen)
    wi_col = wi.t().contiguous().t()
    xb = torch.randn((M, K), dtype=torch.bfloat16, device=device,
                     generator=gen)
    wb = torch.randn((K, N), dtype=torch.bfloat16, device=device,
                     generator=gen)
    variants = {
        "s8xs8 _int_mm (B row-major)": lambda i: torch._int_mm(xi, wi),
        "s8xs8 _int_mm (B col-major)": lambda i: torch._int_mm(xi, wi_col),
        "bf16 matmul": lambda i: torch.matmul(xb, wb),
    }
    print(f"# gemm_ceiling {M}x{K}x{N} on {card_line()}; torch "
          f"{torch.__version__}; times: per launch, median of {REPS} replays "
          f"of a CUDA graph of {LAUNCHES} back-to-back launches")
    best = {name: 0.0 for name in variants}
    for rnd in range(ROUNDS):
        for name, fn in variants.items():
            ms = graph_ms(fn, LAUNCHES, REPS)
            tops = 2.0 * M * N * K / ms / 1e9
            best[name] = max(best[name], tops)
            print(f"round{rnd} {name:28s} {ms * 1e3:9.2f} us {tops:7.1f} "
                  "TOP/s", flush=True)
    print("--- best ---")
    for name, tops in best.items():
        print(f"{name:28s} {tops:7.1f} TOP/s")
    print("u8xs8: not measured - no PyTorch call multiplies uint8 by int8 "
          "(torch._int_mm takes int8 x int8 only)")
    return best


if __name__ == "__main__":
    main()
