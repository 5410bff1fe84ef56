"""The depthwise kernel at every depthwise launch of the mobile nets'
requests, each timed beside its bound; on this tree or on another.

    python dlmc_quant_torch/tools/dw_launches.py [--root DIR] [--json PATH] [batch ...]

The launches are those of one chained request of MobileNetV2 at widths 1.0
and 0.75 and of MobileOne-S1, at 224×224 and in request order: the shape,
stride and top/left pad of every depthwise conv of the deploy forms,
read by a float forward of one image on the CPU.  At each batch (8 and
256 by default) every launch runs on seeded random codes (codes out,
clamped to [-20, 100]), is checked against the plain version bit for bit,
and is timed: per launch, the median of 5 replays of a CUDA graph of 16
back-to-back launches on the same operands.  Beside it: the bound (the
larger of the int8 operations over 1979 TOP/s and the bytes over 3.35
TB/s, H100 SXM data sheet; x, w, a and b read once, the codes written
once) and, where the tree's wrapper has one, the kernel's tile plan.

``--root DIR`` imports ``dlmc_quant_torch`` from DIR instead of this tree,
so that two trees' kernels can be timed on one card in one call, turn
about (run the file as a script for that, not with ``-m``).  A launch
that the tree's kernel refuses (a channel count off its granule) is
printed as refused.  ``--json PATH`` writes the rows.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

# (label, registry name, factory keywords)
MODELS = (("mobilenet_v2", "mobilenet_v2", {}),
          ("mobilenet_v2_w075", "mobilenet_v2", {"width_mult": 0.75}),
          ("MobileOne_S1", "MobileOne_S1", {}))
SIZE, LO, HI, PAD = 224, -20, 100, -7
LAUNCHES, REPS, SEED = 16, 5, 0


def depthwise_shapes(name: str, kwargs: dict):
    """(h, w, c, stride, pad_lo) of each depthwise conv of ``name``'s deploy
    form, in forward order."""
    import torch
    from dlmc_quant_torch.models import get_model
    from dlmc_quant_torch.quant.layers import QConv
    model = get_model(name, device="cpu", deploy=True, **kwargs)
    shapes, hooks = [], []

    def grab(mod, args, out):
        _, h, w, c = args[0].shape
        shapes.append((h, w, c, mod.stride, mod.spatial_pads(h, w)[0][0]))

    for m in model.modules():
        if isinstance(m, QConv) and m.depthwise:
            hooks.append(m.register_forward_hook(grab))
    with torch.no_grad():
        model(torch.zeros((1, SIZE, SIZE, 3)), qmode="fp")
    for h in hooks:
        h.remove()
    return shapes


def launch_row(D, label, index, n, shape, gen):
    """Check and time one launch; returns its row."""
    import torch
    from dlmc_quant_torch.utils.profiling import bound_by, graph_ms, roof_ms
    h, w, c, stride, pad_lo = shape
    dev = gen.device
    x = torch.randint(-128, 128, (n, h, w, c), dtype=torch.int8, device=dev,
                      generator=gen)
    wp = torch.randint(-128, 128, (9, c), dtype=torch.int8, device=dev,
                       generator=gen)
    a = torch.rand(c, device=dev, generator=gen) * 1e-3 + 1e-5
    b = torch.randn(c, device=dev, generator=gen) * 4
    kw = dict(stride=stride, pad=PAD, pad_lo=pad_lo, lo=LO, hi=HI,
              mode="codes")
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    ops_ms, bytes_ms = roof_ms(2 * 9 * n * ho * wo * c,
                               x.numel() + 17 * c + n * ho * wo * c)
    row = dict(model=label, batch=n, index=index, h=h, w=w, c=c,
               stride=stride, pad_lo=pad_lo, bound_ms=max(ops_ms, bytes_ms),
               bound_by=bound_by(ops_ms, bytes_ms), ms=None, plan=None)
    plan = getattr(D, "plan", None)
    if plan is not None:
        p = plan(n, h, w, c, stride)
        row["plan"] = (f"cb{p.cb} tile {p.th}x{p.tw} {p.threads}t rpt "
                       f"{p.rpt} tiles {p.tiles} smem {p.smem}")
    try:
        got = D.int8_dwconv3x3(x, wp, a, b, **kw)
    except ValueError as err:           # the kernel refuses this C
        row["refused"] = str(err)
        return row
    if not torch.equal(got, D.int8_dwconv3x3_plain(x, wp, a, b, **kw)):
        raise RuntimeError(f"{label} launch {index} at batch {n}: kernel "
                           "differs from its plain version")
    row["ms"] = graph_ms(lambda i: D.int8_dwconv3x3(x, wp, a, b, **kw),
                         LAUNCHES, REPS)
    return row


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--root", default=None,
                      help="the tree whose dlmc_quant_torch is timed")
    args.add_argument("--json", default=None, help="write the rows here")
    args.add_argument("batch", nargs="*", type=int, default=[8, 256])
    opts = args.parse_args(argv)
    root = pathlib.Path(opts.root or pathlib.Path(__file__).parents[2])
    sys.path.insert(0, str(root.resolve()))
    import torch
    from dlmc_quant_torch.ops.cuda import int8_dwconv as D
    from dlmc_quant_torch.utils.profiling import card_line
    if not torch.cuda.is_available():
        raise SystemExit("dw_launches: no CUDA device")
    print(f"# dw_launches on {card_line()}; tree {root.resolve()} "
          f"({D.__file__}); per launch: median of {REPS} replays of a CUDA "
          f"graph of {LAUNCHES} back-to-back launches", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for label, name, kwargs in MODELS:
        shapes = depthwise_shapes(name, kwargs)
        for n in opts.batch:
            total = bound = 0.0
            for i, shape in enumerate(shapes):
                row = launch_row(D, label, i, n, shape, gen)
                rows.append(row)
                what = (f"{label} b{n} {i:2d} {shape[:3]} s{shape[3]} "
                        f"pad_lo {shape[4]}")
                if row["ms"] is None:
                    print(f"{what}: refused ({row['refused']})", flush=True)
                    continue
                total += row["ms"]
                bound += row["bound_ms"]
                print(f"{what} | {row['ms'] * 1e3:8.2f} us bound "
                      f"{row['bound_ms'] * 1e3:7.2f} us ({row['bound_by']}) "
                      f"x{row['ms'] / row['bound_ms']:5.2f}"
                      + (f" | {row['plan']}" if row["plan"] else ""),
                      flush=True)
            print(f"# {label} batch {n}: {len(shapes)} launches, kernel "
                  f"{total:.4f} ms (launches run), bound {bound:.4f} ms",
                  flush=True)
    if opts.json:
        pathlib.Path(opts.json).write_text(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
