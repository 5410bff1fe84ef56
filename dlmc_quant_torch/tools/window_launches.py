"""The window-sum kernel at every window-sum launch of BASELINE config #5's
ResNet-50 step, and the im2col kernel at ResNet-50's stem, each timed
beside its bound; on this tree or on another.

    python dlmc_quant_torch/tools/window_launches.py [--root DIR] [--json PATH]
        [--batch 128] [--stem-batch 256] [--grouped-batch 64] [--sweep]

The window sums are the 52 of one config #5 step (RootQ W4A4 ResNet-50 at
224², one a quantized layer, the stem and the head excluded), in request
order: per bottleneck the 1×1 conv1's input, the 3×3 conv2's (stride 2 and
SAME pads (0, 1) in the first block of stages 2–4), the 1×1 conv3's, then
the downsample's (1×1, stride 1 in stage 1, else 2).  The im2col is the
7×7/s2 stem with pads (2, 3) at (N, 224, 224, 3), 147 → 160 bytes a row.
The grouped sums are those of a RepVGG-B2g4 with a weight offset (RootQ)
at 224², one a grouped conv, four groups: its deploy form's 13 grouped
3×3s and its train form's 13 grouped 1×1s, (N, Ho, Wo, 4) each; a tree
whose kernel has no groups prints them as refused.
Every launch runs on seeded random codes, is checked against the plain
version bit for bit, and is timed: the median of 5 replays of a CUDA graph
of 16 back-to-back launches on the same operands (x stays in L2 where it
fits, as after the producer that wrote it).  Beside it: the bound (bytes
over 3.35 TB/s, H100 SXM data sheet: the pixels the windows touch read
once and S written; x read and the rows written) and, where the tree's
wrapper has one, the kernel's tile plan.  The sums by group: the 3×3
windows at stride 1, the 1×1 ones at stride 1, the strided ones, and the
grouped ones by window.

``--root DIR`` imports ``dlmc_quant_torch`` from DIR instead of this tree,
so that two trees' kernels can be timed on one card in one call, turn
about (run the file as a script for that, not with ``-m``).  ``--json
PATH`` writes the rows.  ``--sweep`` times this tree's kernels at other
plans too (rows and columns a tile; the window sums' lanes a pixel), one
line a plan, ``*`` on the plan the wrapper picks.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

SIZE, ZERO, PAD = 224, -8, -7
STEM = dict(kernel=7, stride=2, pads=((2, 3), (2, 3)))
LAUNCHES, REPS, SEED = 16, 5, 0
SAME = ((0, 1), (0, 1))
NONE = ((0, 0), (0, 0))
ONE = ((1, 1), (1, 1))


def config5_windows(batch: int):
    """(shape, kernel, stride, pads) of each window-sum launch of a config
    #5 step, in request order."""
    out, c, hw = [], 64, SIZE // 4
    for stage, (blocks, width) in enumerate(((3, 64), (4, 128), (6, 256),
                                             (3, 512))):
        for b in range(blocks):
            s = 2 if stage > 0 and b == 0 else 1
            out.append(((batch, hw, hw, c), 1, 1, NONE))
            out.append(((batch, hw, hw, width), 3, s, SAME if s == 2 else ONE))
            ho = hw // s
            out.append(((batch, ho, ho, width), 1, 1, NONE))
            if b == 0:
                out.append(((batch, hw, hw, c), 1, s, NONE))
            c, hw = 4 * width, ho
    return out


def b2g4_windows(batch: int):
    """(shape, kernel, stride, pads, groups) of each grouped conv of
    RepVGG-B2g4 (train form: its rbr_dense 3×3s and rbr_1x1s), read by a
    float forward of one image on the CPU, in forward order."""
    import torch
    from dlmc_quant_torch.models import get_model
    from dlmc_quant_torch.quant.layers import QConv
    model = get_model("RepVGG_B2g4", device="cpu")
    out, hooks = [], []

    def grab(mod, args, _):
        _, h, w, c = args[0].shape
        out.append(((batch, h, w, c), mod.kernel_size, mod.stride,
                    mod.spatial_pads(h, w), mod.groups))

    for m in model.modules():
        if isinstance(m, QConv) and m.groups > 1:
            hooks.append(m.register_forward_hook(grab))
    with torch.no_grad():
        model.eval()(torch.zeros((1, SIZE, SIZE, 3)), qmode="fp")
    for h in hooks:
        h.remove()
    return out


def group(kernel: int, stride: int, groups: int = 1) -> str:
    if groups > 1:
        return f"grouped {kernel}x{kernel}"
    if stride > 1:
        return "strided"
    return f"{kernel}x{kernel}/s1"


def key(kind: str, shape, kernel: int, stride: int, pads,
        groups: int = 1) -> str:
    """The label a launch is matched by across trees and in chip_smoke."""
    return (f"{kind} {tuple(shape)} {kernel}x{kernel} s{stride} pads "
            f"{tuple(map(tuple, pads))}"
            + (f" g{groups}" if groups > 1 else ""))


def _time(fn):
    from dlmc_quant_torch.utils.profiling import graph_ms
    return graph_ms(lambda i: fn(), LAUNCHES, REPS)


def window_row(WS, shape, kernel, stride, pads, gen, sweep=False,
               groups: int = 1):
    import torch
    from dlmc_quant_torch.utils.profiling import roof_ms
    x = torch.randint(-128, 128, shape, dtype=torch.int8, device=gen.device,
                      generator=gen)
    kw = dict(zero=ZERO, kernel=kernel, stride=stride, pads=pads)
    if groups > 1:
        kw["groups"] = groups
    label = key("window_sum", shape, kernel, stride, pads, groups)
    try:
        got = WS.int8_window_sum(x, **kw)
    except TypeError as err:            # a tree without grouped sums
        return dict(kind="window_sum", key=label, ms=None,
                    group=group(kernel, stride, groups), refused=repr(err))
    if not torch.equal(got, WS.int8_window_sum_plain(x, **kw)):
        raise RuntimeError(f"{label}: kernel differs from its plain version")
    touched = x.numel() if kernel >= stride else \
        got.numel() // groups * kernel * kernel * shape[-1]
    _, bytes_ms = roof_ms(0, touched + 4 * got.numel())
    row = dict(kind="window_sum", key=label,
               group=group(kernel, stride, groups), bound_ms=bytes_ms,
               plan=None, ms=_time(lambda: WS.int8_window_sum(x, **kw)))
    plan = getattr(WS, "plan", None)
    if plan is not None:
        p = plan(*shape, kernel, stride, pads, *([groups] if groups > 1
                                                  else []))
        row["plan"] = (f"{p.th}x{p.tw} lanes {p.lanes} tiles {p.tiles} "
                       f"smem {p.smem}")
        if sweep:
            row["sweep"] = sweep_windows(WS, x, kw, p)
    return row


def sweep_windows(WS, x, kw, chosen):
    """ms at each tile of a small grid around the chosen plan, and at
    other lanes a pixel at the chosen tile."""
    import torch
    n, h, w, c = x.shape
    want = WS.int8_window_sum_plain(x, **kw)
    if chosen.ho > 1:
        tiles = [(th, chosen.tw) for th in sorted({1, 2, 4, 8, 16,
                                                   chosen.th})]
    else:
        tiles = [(1, tw) for tw in sorted({chosen.tw, max(1, chosen.tw // 2),
                                           2 * chosen.tw, 4 * chosen.tw})]
    variants = [(th, tw, chosen.lanes) for th, tw in tiles]
    variants += [(chosen.th, chosen.tw, lanes)
                 for lanes in {max(1, chosen.lanes // 2),
                               min(32, 2 * chosen.lanes)} - {chosen.lanes}]
    out = []
    for th, tw, lanes in variants:
        p = WS.make_plan(n, h, w, c, kw["kernel"], kw["stride"], kw["pads"],
                         th, tw, lanes)
        if not WS._fits(p) or p.tiles >= 2 ** 31:
            continue
        args = (x, kw["zero"], kw["kernel"], kw["stride"], kw["pads"], p)
        if not torch.equal(WS.launch(*args), want):
            raise RuntimeError(f"plan {p} differs from plain")
        out.append(dict(th=p.th, tw=p.tw, lanes=p.lanes, tiles=p.tiles,
                        ms=_time(lambda: WS.launch(*args)),
                        chosen=p == chosen))
    return out


def im2col_row(I, batch, gen, sweep=False):
    import torch
    from dlmc_quant_torch.utils.profiling import roof_ms
    shape = (batch, SIZE, SIZE, 3)
    x = torch.randint(-128, 128, shape, dtype=torch.int8, device=gen.device,
                      generator=gen)
    kw = dict(STEM, pad=PAD)
    got = I.int8_im2col(x, **kw)
    if not torch.equal(got, I.int8_im2col_plain(x, **kw)):
        raise RuntimeError("the stem im2col differs from its plain version")
    _, bytes_ms = roof_ms(0, x.numel() + got.numel())
    row = dict(kind="im2col", key=key("im2col", shape, 7, 2, STEM["pads"]),
               group="stem im2col", bound_ms=bytes_ms, plan=None,
               ms=_time(lambda: I.int8_im2col(x, **kw)))
    plan = getattr(I, "plan", None)
    if plan is not None:
        p = plan(*shape, 7, 2, STEM["pads"])
        row["plan"] = (f"{p.th}x{p.tw} band {p.rows}x{p.cols} pitch "
                       f"{p.pitch} tiles {p.tiles} smem {p.smem}")
        if sweep:
            row["sweep"] = []
            for th in (1, 2, 4, 6, 8, 12, 16):
                q = I.make_plan(*shape, 7, 2, STEM["pads"], th, p.tw)
                if q.smem > I.MAX_SMEM:
                    continue
                args = (x, 7, 2, STEM["pads"], PAD, q)
                if not torch.equal(I.launch(*args), got):
                    raise RuntimeError(f"plan {q} differs from plain")
                row["sweep"].append(dict(th=q.th, tw=q.tw, tiles=q.tiles,
                                         ms=_time(lambda: I.launch(*args)),
                                         chosen=q.th == p.th))
    return row


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--root", default=None,
                      help="the tree whose dlmc_quant_torch is timed")
    args.add_argument("--json", default=None, help="write the rows here")
    args.add_argument("--batch", type=int, default=128,
                      help="config #5's step batch (the serving engine's)")
    args.add_argument("--stem-batch", type=int, default=256)
    args.add_argument("--grouped-batch", type=int, default=64,
                      help="RepVGG-B2g4's grouped sums' batch (0: none)")
    args.add_argument("--sweep", action="store_true",
                      help="time other tile plans too (this tree)")
    opts = args.parse_args(argv)
    root = pathlib.Path(opts.root or pathlib.Path(__file__).parents[2])
    sys.path.insert(0, str(root.resolve()))
    import torch
    from dlmc_quant_torch.ops.cuda import int8_im2col as I
    from dlmc_quant_torch.ops.cuda import int8_window_sum as WS
    from dlmc_quant_torch.utils.profiling import card_line
    if not torch.cuda.is_available():
        raise SystemExit("window_launches: no CUDA device")
    print(f"# window_launches on {card_line()}; tree {root.resolve()} "
          f"({WS.__file__}); per launch: median of {REPS} replays of a CUDA "
          f"graph of {LAUNCHES} back-to-back launches", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, groups = [], {}
    launches = [w + (1,) for w in config5_windows(opts.batch)]
    if opts.grouped_batch:
        launches += b2g4_windows(opts.grouped_batch)
    for i, (shape, k, s, pads, g) in enumerate(launches):
        row = window_row(WS, shape, k, s, pads, gen, opts.sweep and g == 1,
                         g)
        rows.append(row)
        if row["ms"] is None:
            print(f"{i:2d} {row['key']:60s} | refused ({row['refused']})",
                  flush=True)
            continue
        g = groups.setdefault(row["group"], [0, 0.0, 0.0])
        g[0] += 1
        g[1] += row["ms"]
        g[2] += row["bound_ms"]
        print(f"{i:2d} {row['key']:60s} | {row['ms'] * 1e3:8.2f} us bound "
              f"{row['bound_ms'] * 1e3:7.2f} x{row['ms'] / row['bound_ms']:5.2f}"
              + (f" | {row['plan']}" if row["plan"] else ""), flush=True)
        for q in row.get("sweep", ()):
            print(f"     {'*' if q['chosen'] else ' '} {q['th']}x{q['tw']} "
                  f"lanes {q['lanes']} tiles {q['tiles']}: "
                  f"{q['ms'] * 1e3:8.2f} us", flush=True)
    total = sum(g[1] for g in groups.values())
    bound = sum(g[2] for g in groups.values())
    print(f"# window sums at batch {opts.batch} (grouped at "
          f"{opts.grouped_batch}): {sum(g[0] for g in groups.values())} "
          f"launches, kernel {total:.4f} ms, bound {bound:.4f} ms; by group "
          "(launches, ms, "
          "bound ms): " + "; ".join(f"{name} {n}, {ms:.4f}, {b:.4f}"
                                    for name, (n, ms, b) in groups.items()),
          flush=True)
    row = im2col_row(I, opts.stem_batch, gen, opts.sweep)
    rows.append(row)
    print(f"# {row['key']}: {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} "
          f"ms, x{row['ms'] / row['bound_ms']:.2f}"
          + (f" | {row['plan']}" if row["plan"] else ""), flush=True)
    for q in row.get("sweep", ()):
        print(f"     {'*' if q['chosen'] else ' '} {q['th']}x{q['tw']} tiles "
              f"{q['tiles']}: {q['ms']:.4f} ms", flush=True)
    if opts.json:
        pathlib.Path(opts.json).write_text(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
