"""The depthwise kernel at every depthwise launch of the mobile nets',
GhostNet-1.0's and EfficientNet-B0's requests, each timed beside its bound;
on this tree or on another.

    python dlmc_quant_torch/tools/dw_launches.py [--root DIR] [--json PATH]
        [--sweep] [batch ...]

The launches are those of one chained request of MobileNetV2 at widths 1.0
and 0.75, of MobileOne-S1, of GhostNet-1.0 and of EfficientNet-B0, and of
one ``int`` request of MobileOne-S1's train form (its depthwise 3×3s and
their 1×1 scale branches), at 224×224 and in request order: the window,
shape, stride and top/left pad of every depthwise conv (groups = C in = C
out) of the deploy forms (the train form's), read by a float forward of
one image on the CPU, and the mode its request runs it in: codes out
(clamped to [-20, 100]) where the request chains codes, f32 where it does
not (GhostNet's cheap convs, whose outputs meet in a concat, with the
ghost module's ReLU, and its stride-2 convs that an SE block follows;
every conv of EfficientNet-B0's ``int`` request and of the train
form's).  At each batch (8 and 256 by default) every launch runs on
seeded random codes, is
checked against the plain version bit for bit, and is timed: per launch,
the median of 5 replays of a CUDA graph of 16 back-to-back launches on the
same operands.  Beside it: the bound (the larger of the int8 operations
over 1979 TOP/s and the bytes over 3.35 TB/s, H100 SXM data sheet; x, w, a
and b read once, the output written once; a 1×1 window's x only at the
pixels it reads) and the kernel's tile plan.  The sums by group: each
model's aligned 3×3 launches, its ragged ones (C % 8 != 0: the wide
build's ragged path), its 5×5 ones and its 1×1 ones.

``--root DIR`` imports ``dlmc_quant_torch`` from DIR instead of this tree,
so that two trees' kernels can be timed on one card in one call, turn
about (run the file as a script for that, not with ``-m``).  A launch
that the tree's kernel refuses (a channel count off its granule, a window
it does not have) is printed as refused.  ``--sweep`` times this tree's
kernel at other plans too at each launch of the wide build
(``int8_dwconv5x5.cu``: the 5×5 window and the ragged path; row groups
and rows a thread), one line a plan, ``*`` on the plan the wrapper
picks.  ``--json PATH`` writes the
rows.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

# (label, registry name, factory keywords, the mode of a launch from its
# module's name: codes where the request chains codes; "train": the train
# form's 'int' request, f32)
MODELS = (("mobilenet_v2", "mobilenet_v2", {}, "codes"),
          ("mobilenet_v2_w075", "mobilenet_v2", {"width_mult": 0.75},
           "codes"),
          ("MobileOne_S1", "MobileOne_S1", {}, "codes"),
          ("GhostNet_1.0", "ghostnet", {}, "ghost"),
          ("EfficientNet_B0", "efficientnetb0", {}, "f32"),
          ("MobileOne_S1_train", "MobileOne_S1", {}, "train"))
SIZE, LO, HI, PAD = 224, -20, 100, -7
LAUNCHES, REPS, SEED = 16, 5, 0
# the sweep's rows a thread (with every row-group count that fits)
SWEEP_RPT = (1, 2, 3, 4, 5, 7, 8)


def depthwise_shapes(name: str, kwargs: dict, rule: str):
    """(h, w, c, k, stride, pad_lo, mode, relu) of each depthwise conv of
    ``name``'s deploy form (train form for "train"), in forward order;
    ``rule`` gives the mode: "codes", "f32" or "train" (f32), or "ghost"
    (f32 for a ghost module's cheap conv, with the module's ReLU, and for a
    bottleneck's ``dw`` that its SE block follows; codes for the rest)."""
    import torch
    from dlmc_quant_torch.models import get_model
    from dlmc_quant_torch.quant.layers import QConv
    model = get_model(name, device="cpu", deploy=rule != "train", **kwargs)
    shapes, hooks = [], []
    relu = {f"{n}.cheap": m.relu for n, m in model.named_modules()
            if isinstance(getattr(m, "relu", None), bool)}
    se_after = {f"{n}.dw" for n, m in model.named_modules()
                if hasattr(m, "dw") and hasattr(m, "se")}

    def grab(name):
        def hook(mod, args, out):
            _, h, w, c = args[0].shape
            ghost = rule == "ghost" and (name in relu or name in se_after)
            mode = "f32" if rule in ("f32", "train") or ghost else "codes"
            shapes.append((h, w, c, mod.kernel_size, mod.stride,
                           mod.spatial_pads(h, w)[0][0], mode,
                           relu.get(name, False) if ghost else False))
        return hook

    for n, m in model.named_modules():
        # by geometry: another tree's QConv.depthwise may leave a 1x1 out
        if isinstance(m, QConv) and m.groups > 1 \
                and m.weight.shape[:2] == (m.groups, 1):
            hooks.append(m.register_forward_hook(grab(n)))
    with torch.no_grad():
        model(torch.zeros((1, SIZE, SIZE, 3)), qmode="fp")
    for h in hooks:
        h.remove()
    return shapes


def operands(n, shape, gen):
    import torch
    h, w, c, k = shape[:4]
    dev = gen.device
    x = torch.randint(-128, 128, (n, h, w, c), dtype=torch.int8, device=dev,
                      generator=gen)
    wp = torch.randint(-128, 128, (k * k, c), dtype=torch.int8, device=dev,
                       generator=gen)
    a = torch.rand(c, device=dev, generator=gen) * 1e-3 + 1e-5
    b = torch.randn(c, device=dev, generator=gen) * 4
    return x, wp, a, b


def keywords(shape):
    h, w, c, k, stride, pad_lo, mode, relu = shape
    if mode == "codes":
        return dict(stride=stride, pad=PAD, pad_lo=pad_lo, lo=LO, hi=HI,
                    mode="codes")
    return dict(stride=stride, pad=PAD, pad_lo=pad_lo, mode="f32", relu=relu)


def group(shape) -> str:
    """A launch's group: 5x5, 1x1, ragged (the wide build's 3x3: C % 8 !=
    0 on fresh, aligned tensors) or aligned."""
    c, k = shape[2:4]
    if k in (1, 5):
        return f"{k}x{k}"
    return "ragged" if c % 8 else "aligned"


def launch_row(D, label, index, n, shape, gen, sweep=False):
    """Check and time one launch; returns its row."""
    import torch
    from dlmc_quant_torch.utils.profiling import bound_by, graph_ms, roof_ms
    h, w, c, k, stride, pad_lo, mode, _ = shape
    x, wp, a, b = operands(n, shape, gen)
    kw = keywords(shape)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    out_bytes = n * ho * wo * c * (1 if mode == "codes" else 4)
    read = x.numel() if k > 1 else n * ho * wo * c   # a 1x1: its pixels
    ops_ms, bytes_ms = roof_ms(2 * k * k * n * ho * wo * c,
                               read + (k * k + 8) * c + out_bytes)
    row = dict(model=label, batch=n, index=index, h=h, w=w, c=c, k=k,
               stride=stride, pad_lo=pad_lo, mode=mode,
               group=group(shape), bound_ms=max(ops_ms, bytes_ms),
               bound_by=bound_by(ops_ms, bytes_ms), ms=None, plan=None)
    try:
        path = D.route(x, wp, mode) if k == 1 else D.route(x, wp)
        p = D.plan(n, h, w, c, stride, k, path)
        row["plan"] = (f"cb{p.cb} tile {p.th}x{p.tw} {p.threads}t rpt "
                       f"{p.rpt} tiles {p.tiles} smem {p.smem}")
        row["rg_rpt"] = [p.rg, p.rpt]
        got = D.int8_dwconv3x3(x, wp, a, b, **kw)
    except (ValueError, KeyError, TypeError) as err:   # C or window refused
        row["refused"] = repr(err)
        return row
    if not torch.equal(got, D.int8_dwconv3x3_plain(x, wp, a, b, **kw)):
        raise RuntimeError(f"{label} launch {index} at batch {n}: kernel "
                           "differs from its plain version")
    row["ms"] = graph_ms(lambda i: D.int8_dwconv3x3(x, wp, a, b, **kw),
                         LAUNCHES, REPS)
    if sweep:
        row["sweep"] = sweep_plans(D, x, wp, a, b, kw, p)
    return row


def sweep_plans(D, x, wp, a, b, kw, chosen):
    """This tree's kernel at the plan's slice and columns with every row
    group count and rows a thread of SWEEP_RPT that fit: [(rg, rpt, ms)],
    each checked against the plain version."""
    import torch
    from dlmc_quant_torch.utils.profiling import graph_ms
    n, h, w, c = x.shape
    k, ragged = D.window(wp), D.route(x, wp)
    want = D.int8_dwconv3x3_plain(x, wp, a, b, **kw)
    out = []
    for rpt in SWEEP_RPT:
        for rg in range(1, D.MAX_THREADS // (chosen.cb // 4 * chosen.cg) + 1):
            p = D.make_plan(n, h, w, c, kw["stride"], chosen.cb, chosen.cg,
                            rg, rpt, k, ragged)
            # within half the shared memory, no row group below the map
            if p.smem > D.HALF_SMEM or (rg - 1) * rpt >= \
                    (h - 1) // kw["stride"] + 1:
                continue
            over = (p.cb, p.cg, p.rg, p.rpt)
            got = D.int8_dwconv3x3(x, wp, a, b, _plan=over, **kw)
            if not torch.equal(got, want):
                raise RuntimeError(f"plan {over} differs from plain")
            out.append((rg, rpt, graph_ms(
                lambda i, o=over: D.int8_dwconv3x3(x, wp, a, b, _plan=o,
                                                   **kw), LAUNCHES, REPS)))
    return out


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--root", default=None,
                      help="the tree whose dlmc_quant_torch is timed")
    args.add_argument("--json", default=None, help="write the rows here")
    args.add_argument("--sweep", action="store_true",
                      help="time the wide build's launches at other plans")
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
    for label, name, kwargs, rule in MODELS:
        shapes = depthwise_shapes(name, kwargs, rule)
        for n in opts.batch:
            sums = {}
            for i, shape in enumerate(shapes):
                row = launch_row(
                    D, label, i, n, shape, gen,
                    opts.sweep and group(shape) not in ("aligned", "1x1"))
                rows.append(row)
                what = (f"{label} b{n} {i:2d} {shape[3]}x{shape[3]} "
                        f"{shape[:3]} s{shape[4]} pad_lo {shape[5]} "
                        f"{shape[6]}")
                if row["ms"] is None:
                    print(f"{what}: refused ({row['refused']})", flush=True)
                    continue
                tot = sums.setdefault(row["group"], [0, 0.0, 0.0])
                tot[0] += 1
                tot[1] += row["ms"]
                tot[2] += row["bound_ms"]
                print(f"{what} {row['group']} | {row['ms'] * 1e3:8.2f} us "
                      f"bound {row['bound_ms'] * 1e3:7.2f} us "
                      f"({row['bound_by']}) "
                      f"x{row['ms'] / row['bound_ms']:5.2f}"
                      + f" | {row['plan']}", flush=True)
                for rg, rpt, ms in row.get("sweep", ()):
                    mark = "*" if [rg, rpt] == row["rg_rpt"] else " "
                    print(f"    {mark} rg {rg:2d} rpt {rpt}: "
                          f"{ms * 1e3:8.2f} us", flush=True)
            for grp, (count, ms, bound) in sorted(sums.items()):
                print(f"# {label} batch {n}: {count} {grp} launches, kernel "
                      f"{ms:.4f} ms, bound {bound:.4f} ms", flush=True)
    if opts.json:
        pathlib.Path(opts.json).write_text(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
