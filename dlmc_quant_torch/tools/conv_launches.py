"""The 3×3 conv kernel at every conv launch of a RepVGG-A0 request (the
ungrouped build) and of a RepVGG-B2g4 request (the grouped build, with and
without a weight offset's row term), each timed beside its bound; on this
tree or on another.

    python dlmc_quant_torch/tools/conv_launches.py [--root DIR] [--json PATH]
        [--batch 256] [--grouped-batch 64]

The launches are those of one chained request of each deploy form at
224×224, in request order: the shape, output channels, stride, top/left
pad and groups of every 3×3 conv, read by a float forward of one image on
the CPU, run in codes mode (clamped to [-20, 100]) on seeded random codes
and weights; B2g4's grouped convs once more with a row term (S one sum a
group, as a RootQ layer's).  Every launch is checked against the plain
version bit for bit and timed: the median of 5 replays of a CUDA graph of
16 back-to-back launches on the same operands.  Beside it: the bound (the
larger of the int8 operations over 1979 TOP/s and the bytes over 3.35
TB/s, H100 SXM data sheet; x, the weight, a, b and S read once, the codes
written once).  The sums by group: ungrouped, grouped, grouped with the
term.

``--root DIR`` imports ``dlmc_quant_torch`` from DIR instead of this tree,
so that two trees' kernels can be timed on one card in one call, turn
about (run the file as a script for that, not with ``-m``).  A launch that
the tree's kernel refuses (a grouped row term) is printed as refused.
``--json PATH`` writes the rows.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

SIZE, PAD, LO, HI, ZERO = 224, -7, -20, 100, -5
LAUNCHES, REPS, SEED = 16, 5, 0
# (label, registry name, batch option)
MODELS = (("RepVGG_A0", "RepVGG_A0", "batch"),
          ("RepVGG_B2g4", "RepVGG_B2g4", "grouped_batch"))


def conv_shapes(name: str):
    """(h, w, c, o, stride, pad_lo, groups) of each 3×3 conv of ``name``'s
    deploy form, in forward order."""
    import torch
    from dlmc_quant_torch.models import get_model
    from dlmc_quant_torch.quant.layers import QConv
    model = get_model(name, device="cpu", deploy=True)
    shapes, hooks = [], []

    def grab(mod, args, _):
        _, h, w, c = args[0].shape
        shapes.append((h, w, c, mod.weight.shape[0], mod.stride,
                       mod.spatial_pads(h, w)[0][0], mod.groups))

    for m in model.modules():
        if isinstance(m, QConv) and m.kernel_size == 3:
            hooks.append(m.register_forward_hook(grab))
    with torch.no_grad():
        model.eval()(torch.zeros((1, SIZE, SIZE, 3)), qmode="fp")
    for h in hooks:
        h.remove()
    return shapes


def group(groups: int, term: bool) -> str:
    if groups == 1:
        return "ungrouped"
    return "grouped +row" if term else "grouped"


def launch_row(K, label, index, n, shape, term, gen):
    """Check and time one launch; returns its row."""
    import torch
    import torch.nn.functional as F
    from dlmc_quant_torch.utils.profiling import bound_by, graph_ms, roof_ms
    h, w, c, o, stride, pad_lo, groups = shape
    dev = gen.device
    x = torch.randint(-128, 128, (n, h, w, c), dtype=torch.int8, device=dev,
                      generator=gen)
    wk = torch.randint(-128, 128, (3, 3, c // groups, o), dtype=torch.int8,
                       device=dev, generator=gen)
    a = torch.rand(o, device=dev, generator=gen) * 1e-4 + 1e-6
    b = torch.randn(o, device=dev, generator=gen) * 4
    kw = dict(stride=stride, pad=PAD, pad_lo=pad_lo, lo=LO, hi=HI,
              mode="codes", groups=groups)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    row_bytes = 0
    if term:
        # S per group, computed here: another tree's window sums may not
        # take groups (a pad adds 0)
        xp = F.pad(x.permute(0, 3, 1, 2).double() - ZERO,
                   (pad_lo, 3 - pad_lo, pad_lo, 3 - pad_lo))
        ones = torch.ones((groups, c // groups, 3, 3), dtype=torch.float64,
                          device=dev)
        sums = F.conv2d(xp, ones, stride=stride, groups=groups)
        sums = sums[:, :, :ho, :wo].permute(0, 2, 3, 1).to(torch.int32) \
            .contiguous()
        kw["row"] = (sums, torch.randn(o, device=dev, generator=gen) * 1e-3)
        row_bytes = 4 * (sums.numel() + o)
    ops_ms, bytes_ms = roof_ms(2 * n * ho * wo * o * 9 * (c // groups),
                               x.numel() + wk.numel() + 8 * o + row_bytes
                               + n * ho * wo * o)
    row = dict(model=label, batch=n, index=index,
               key=(f"{label} b{n} {index:2d} conv {(n, h, w, c)}->{o} "
                    f"g{groups} s{stride} pad_lo {pad_lo}"
                    + (" +row" if term else "")),
               group=group(groups, term), bound_ms=max(ops_ms, bytes_ms),
               bound_by=bound_by(ops_ms, bytes_ms), ms=None)
    try:
        wp = K.pack_weight(wk, groups)
        got = K.int8_conv3x3(x, wp, a, b, **kw)
    except ValueError as err:           # a grouped row term refused
        row["refused"] = repr(err)
        return row
    if not torch.equal(got, K.int8_conv3x3_plain(x, wp, a, b, **kw)):
        raise RuntimeError(f"{row['key']}: kernel differs from its plain "
                           "version")
    row["ms"] = graph_ms(lambda i: K.int8_conv3x3(x, wp, a, b, **kw),
                         LAUNCHES, REPS)
    return row


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--root", default=None,
                      help="the tree whose dlmc_quant_torch is timed")
    args.add_argument("--json", default=None, help="write the rows here")
    args.add_argument("--batch", type=int, default=256,
                      help="RepVGG-A0's request batch")
    args.add_argument("--grouped-batch", type=int, default=64,
                      help="RepVGG-B2g4's request batch (0: none)")
    opts = args.parse_args(argv)
    root = pathlib.Path(opts.root or pathlib.Path(__file__).parents[2])
    sys.path.insert(0, str(root.resolve()))
    import torch
    from dlmc_quant_torch.ops.cuda import int8_conv as K
    from dlmc_quant_torch.utils.profiling import card_line
    if not torch.cuda.is_available():
        raise SystemExit("conv_launches: no CUDA device")
    print(f"# conv_launches on {card_line()}; tree {root.resolve()} "
          f"({K.__file__}); per launch: median of {REPS} replays of a CUDA "
          f"graph of {LAUNCHES} back-to-back launches", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for label, name, batch in MODELS:
        n = getattr(opts, batch)
        if not n:
            continue
        sums = {}
        for i, shape in enumerate(conv_shapes(name)):
            for term in (False, True) if shape[-1] > 1 else (False,):
                row = launch_row(K, label, i, n, shape, term, gen)
                rows.append(row)
                if row["ms"] is None:
                    print(f"{row['key']}: refused ({row['refused']})",
                          flush=True)
                    continue
                tot = sums.setdefault(row["group"], [0, 0.0, 0.0])
                tot[0] += 1
                tot[1] += row["ms"]
                tot[2] += row["bound_ms"]
                print(f"{row['key']} | {row['ms'] * 1e3:8.2f} us bound "
                      f"{row['bound_ms'] * 1e3:7.2f} us ({row['bound_by']}) "
                      f"x{row['ms'] / row['bound_ms']:5.2f}", flush=True)
        for grp, (count, ms, bound) in sorted(sums.items()):
            print(f"# {label} batch {n}: {count} {grp} launches, kernel "
                  f"{ms:.4f} ms, bound {bound:.4f} ms", flush=True)
    if opts.json:
        pathlib.Path(opts.json).write_text(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
