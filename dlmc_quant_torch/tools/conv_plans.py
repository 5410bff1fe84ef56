"""The int8 3×3 conv kernel at RepVGG-A0's layer shapes, plan against plan.

    python -m dlmc_quant_torch.tools.conv_plans [batch]

For each layer class of RepVGG-A0 at 224×224 (batch 256 by default) it runs
``int8_conv3x3`` on seeded random codes at :func:`tile_plan`'s default plan
and at every alternative in :data:`VARIANTS` that applies (no halo,
the weight streamed instead of resident, other ring depths), checks each
result against the default plan's bit for bit and the default's against the
plain version on the first image, and prints µs per launch beside the
layer's bound (the larger of int8 operations over 1979 TOP/s and bytes over
3.35 TB/s, H100 SXM data sheet; input, weight and output counted once).
Times are per-launch medians of CUDA-graph replays of back-to-back launches
on the same operands.  This is the instrument for the plan's rules: a rule
in ``tile_plan`` should name the line here that supports it.
"""

from __future__ import annotations

import sys

import torch

from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.ops.cuda.int8_conv import (int8_conv3x3,
                                                 int8_conv3x3_plain, out_hw,
                                                 pack_weight, tile_plan)
from dlmc_quant_torch.utils.profiling import (bound_by, card_line, graph_ms,
                                              roof_ms)

# (name, layers of that class in A0, H = W of the input, C, O, stride, mode)
LAYERS = (
    ("stem", 1, 224, 3, 48, 2, "codes"),
    ("stage1_0", 1, 112, 48, 48, 2, "codes"),
    ("stage1_1", 1, 56, 48, 48, 1, "codes"),
    ("stage2_0", 1, 56, 48, 96, 2, "codes"),
    ("stage2_k", 3, 28, 96, 96, 1, "codes"),
    ("stage3_0", 1, 28, 96, 192, 2, "codes"),
    ("stage3_k", 13, 14, 192, 192, 1, "codes"),
    ("stage4_0", 1, 14, 192, 1280, 2, "f32"),
)
VARIANTS = (dict(halo_bufs=0), dict(halo_bufs=1), dict(stages=4, halo_bufs=1),
            dict(stages=4, halo_bufs=0), dict(resident=False),
            dict(stages=4), dict(stages=5), dict(stages=6), dict(stages=8))
LAUNCHES, REPS, SEED = 16, 5, 0


def cost(n, h, c, o, stride, mode):
    """(operations, bytes) of one conv: input, weight, a, b, output once."""
    ho, wo = out_hw(h, h, stride)
    pixels = n * ho * wo
    out_bytes = pixels * o * (1 if mode == "codes" else 4)
    nbytes = n * h * h * c + 9 * c * o + 8 * o + out_bytes
    return 2 * pixels * o * 9 * c, nbytes


def layer_rows(name, count, n, h, c, o, stride, mode, gen):
    """Time one layer class at every plan that fits; returns its rows."""
    dev = gen.device
    x = torch.randint(-128, 128, (n, h, h, c), dtype=torch.int8, device=dev,
                      generator=gen)
    w = pack_weight(torch.randint(-128, 128, (3, 3, c, o), dtype=torch.int8,
                                  device=dev, generator=gen))
    a = torch.rand(o, device=dev, generator=gen) * 1e-4 + 1e-5
    b = torch.randn(o, device=dev, generator=gen)
    kw = dict(stride=stride, pad=-3, lo=-3, hi=127, mode=mode)
    if mode == "f32":
        kw = dict(stride=stride, pad=-3, mode=mode, relu=True)
    ho, wo = out_hw(h, h, stride)
    want = int8_conv3x3(x, w, a, b, **kw)
    if not torch.equal(want[:1], int8_conv3x3_plain(x[:1], w, a, b, **kw)):
        raise RuntimeError(f"{name}: kernel differs from its plain version")
    ops_ms, bytes_ms = roof_ms(*cost(n, h, c, o, stride, mode))
    b_ms = max(ops_ms, bytes_ms)
    default = tile_plan(n * ho * wo, c, o, mode, stride=stride, width=h)
    rows = []
    for variant in (None,) + VARIANTS:
        try:
            plan = tile_plan(n * ho * wo, c, o, mode, stride=stride, width=h,
                             **(variant or {}))
        except ValueError:
            continue
        if variant is not None and plan == default:
            continue
        got = int8_conv3x3(x, w, a, b, _plan=variant, **kw)
        if not torch.equal(got, want):
            raise RuntimeError(f"{name}: plan {plan} differs from the default")
        ms = graph_ms(lambda i: int8_conv3x3(x, w, a, b, _plan=variant, **kw),
                      LAUNCHES, REPS)
        print(f"{name:9s} x{count:2d} ({n},{h},{h},{c})->{o} s{stride} "
              f"{plan.bn}x128 stages {plan.stages} "
              f"{'resident' if plan.resident else 'streamed'} "
              f"halo {plan.halo_bufs} "
              f"{plan.smem:6d} B{' *' if variant is None else '  '} "
              f"{ms * 1e3:8.2f} us | bound {b_ms * 1e3:7.2f} us "
              f"({bound_by(ops_ms, bytes_ms)}) x{ms / b_ms:5.2f}", flush=True)
        rows.append(dict(name=name, count=count, plan=plan, ms=ms,
                         bound_ms=b_ms, default=variant is None))
    return rows


def main(argv=()):
    """Time every layer class at ``argv[0]`` images (default 256)."""
    n = int(argv[0]) if argv else 256
    device = resolve_device(None)
    gen = torch.Generator(device=device).manual_seed(SEED)
    print(f"# conv_plans on {card_line()}; torch {torch.__version__}; batch "
          f"{n}; times: per launch, median of {REPS} replays of a CUDA graph "
          f"of {LAUNCHES} back-to-back launches; * = tile_plan's default")
    rows = [r for layer in LAYERS
            for r in layer_rows(layer[0], layer[1], n, *layer[2:], gen)]
    total = sum(r["ms"] * r["count"] for r in rows if r["default"])
    bound = sum(r["bound_ms"] * r["count"] for r in rows if r["default"])
    print(f"# 22 convs at the default plans: {total:.4f} ms, bound "
          f"{bound:.4f} ms")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
