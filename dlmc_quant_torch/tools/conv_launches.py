"""The 3×3 conv kernel at every conv launch of a RepVGG-A0 request (the
ungrouped build), of a RepVGG-B2g4 request (the grouped build, with and
without a weight offset's row term), of a ResNet-50 and a cifar_resnet18
request and of BASELINE config #5's ResNet-50 (f32, W4, the row term),
each checked against its plain version and timed beside its bound; on
this tree or on another.

    python dlmc_quant_torch/tools/conv_launches.py [--root DIR] [--json PATH]
        [--batch 256] [--grouped-batch 64] [--resnet-batch 256]
        [--config5-batch 128] [--models a0,b2g4,resnet50,resnet18,config5]
        [--parts] [--widths]

The launches are those of one chained request of each model, in request
order.  RepVGG-A0's and B2g4's (deploy forms at 224×224): the shape,
output channels, stride, top/left pad and groups of every 3×3 conv, read
by a float forward of one image on the CPU, run in codes mode; B2g4's
grouped convs once more with a row term (S one sum a group, as a RootQ
layer's).  ResNet-50's 16 (224×224, codes: each Bottleneck's conv2, SAME
stride 2 in the first block of stages 2–4) and cifar_resnet18's 18
(32×32: the stem in codes and in f32 with ReLU, each BasicBlock's conv1
in codes and its conv2 closing the block with the shortcut: f32 r after
the stem, int32 r after a 1×1 downsample, int8 codes otherwise), as
``chip_smoke.py`` records them.  Config #5's 16 (RootQ W4A4 ResNet-50's
train form at 128 images): ResNet-50's shapes in f32 mode with
nibble-packed weights and a row term.  Operands are seeded random codes
and weights (codes clamped to [-20, 100]).  Every launch is checked against
the plain version bit for bit (a launch that differs raises) and timed:
the median of 5 replays of a CUDA graph of 16 back-to-back launches on the
same operands.  Beside it: the bound (``utils.launches.launch_bound``: the
int8 operations over 1979 TOP/s or the bytes over 3.35 TB/s, H100 SXM
data sheet; x, the weight, a, b, r and S read once, the output written
once).  Sums by model and group (the epilogue mode: codes, f32, the
residual's dtype, grouped, the row term).

``--root DIR`` imports ``dlmc_quant_torch`` from DIR instead of this tree,
so that two trees' kernels can be timed on one card in one call, turn
about (run the file as a script for that, not with ``-m``).  A launch that
the tree's kernel refuses (a grouped row term) is printed as refused.
``--json PATH`` writes the rows.

``--parts`` (this tree) times every ResNet and A0 launch again in variants
of ``csrc/int8_conv3x3.cu`` built under ``_build/parts/``, each with one
part of the kernel left out: the producers' build of the im2col tiles,
the products, the epilogue's arithmetic, the residual's loads, the output
stores.  Their outputs are wrong and only timed; the parts overlap (a
part left out may let the compiler drop another's work), so a part's cost
is not the difference of two rows.

``--widths`` (this tree) times every launch at each tile width the tree
compiles for it too (``tile_plan``'s ``bn``), each checked.  ``--plans``
(this tree) times every stride-1 launch at 64 or 128 channels at the
other plans of its width (ring stages, halo buffers, a resident weight),
each checked.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

SIZE, PAD, LO, HI, ZERO = 224, -7, -20, 100, -5
LAUNCHES, REPS, SEED = 16, 5, 0
MODELS = ("a0", "b2g4", "resnet50", "resnet18", "config5")
# ResNet-50's 3x3 convs (each Bottleneck's conv2) at 224x224: (blocks,
# width, side of the stage's output); the first block of stages 2-4 takes
# the side before and strides 2, SAME (pad_lo 0 on an even map)
R50_STAGES = ((3, 64, 56), (4, 128, 28), (6, 256, 14), (3, 512, 7))
# cifar_resnet18 at 32x32 in request order: (side, C, O, stride, mode, r):
# the stem twice (codes for its consumer, f32 with ReLU for the shortcut
# of the first block), then per BasicBlock conv1 (codes) and conv2 (codes
# closing the block with its shortcut r)
R18_LAUNCHES = (
    (32, 3, 64, 1, "codes", None), (32, 64, 64, 1, "codes", None),
    (32, 3, 64, 1, "f32", None), (32, 64, 64, 1, "codes", "float32"),
    (32, 64, 64, 1, "codes", None), (32, 64, 64, 1, "codes", "int8"),
    (32, 64, 128, 2, "codes", None), (16, 128, 128, 1, "codes", "int32"),
    (16, 128, 128, 1, "codes", None), (16, 128, 128, 1, "codes", "int8"),
    (16, 128, 256, 2, "codes", None), (8, 256, 256, 1, "codes", "int32"),
    (8, 256, 256, 1, "codes", None), (8, 256, 256, 1, "codes", "int8"),
    (8, 256, 512, 2, "codes", None), (4, 512, 512, 1, "codes", "int32"),
    (4, 512, 512, 1, "codes", None), (4, 512, 512, 1, "codes", "int8"))


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


def spec(model, batch, index, h, w, c, o, stride, pad_lo, groups=1,
         mode="codes", relu=False, r=None, term=False, w4=False):
    """One launch: its operands' shapes and its epilogue."""
    if groups > 1:
        grp = "grouped +row" if term else "grouped"
    elif model.startswith("RepVGG"):
        grp = "ungrouped"
    else:
        grp = (mode + (" relu" if relu else "") + (f" +r {r}" if r else "")
               + (" +row" if term else "") + (" w4" if w4 else ""))
    return dict(model=model, batch=batch, index=index, shape=(h, w, c, o),
                stride=stride, pad_lo=pad_lo, groups=groups, mode=mode,
                relu=relu, r=r, term=term, w4=w4, group=grp)


def resnet50_specs(model, batch, **kw):
    """ResNet-50's 16 3x3 convs, in request order."""
    specs, side_in = [], 56
    for blocks, width, side in R50_STAGES:
        for i in range(blocks):
            stride = 2 if side_in != side else 1
            specs.append(spec(model, batch, len(specs), side_in, side_in,
                              width, width, stride, 1 - (stride == 2),
                              **kw))
            side_in = side
    return specs


def launch_specs(opts):
    """The launches of the models ``opts.models`` names."""
    models = opts.models.split(",")
    specs = []
    for label, name, batch in (("a0", "RepVGG_A0", opts.batch),
                               ("b2g4", "RepVGG_B2g4", opts.grouped_batch)):
        if label not in models or not batch:
            continue
        for i, (h, w, c, o, stride, pad_lo, groups) in enumerate(
                conv_shapes(name)):
            for term in (False, True) if groups > 1 else (False,):
                specs.append(spec(name, batch, i, h, w, c, o, stride, pad_lo,
                                  groups, term=term))
    if "resnet50" in models and opts.resnet_batch:
        specs += resnet50_specs("resnet50", opts.resnet_batch)
    if "resnet18" in models and opts.resnet_batch:
        for i, (side, c, o, stride, mode, r) in enumerate(R18_LAUNCHES):
            specs.append(spec("cifar_resnet18", opts.resnet_batch, i, side,
                              side, c, o, stride, 1 - (stride == 2),
                              mode=mode, relu=mode == "f32", r=r))
    if "config5" in models and opts.config5_batch:
        specs += resnet50_specs("config5", opts.config5_batch, mode="f32",
                                term=True, w4=True)
    return specs


def operands(K, s, gen):
    """Seeded operands and keywords of one launch on the card."""
    import torch
    import torch.nn.functional as F
    h, w, c, o = s["shape"]
    n, stride, pad_lo, groups = s["batch"], s["stride"], s["pad_lo"], \
        s["groups"]
    dev = gen.device
    x = torch.randint(-128, 128, (n, h, w, c), dtype=torch.int8, device=dev,
                      generator=gen)
    lim = 8 if s["w4"] else 128
    wk = torch.randint(-lim, lim, (3, 3, c // groups, o), dtype=torch.int8,
                       device=dev, generator=gen)
    a = torch.rand(o, device=dev, generator=gen) * 1e-4 + 1e-6
    b = torch.randn(o, device=dev, generator=gen) * 4
    kw = dict(stride=stride, pad=PAD, pad_lo=pad_lo, mode=s["mode"],
              groups=groups)
    if s["mode"] == "codes":
        kw.update(lo=LO, hi=HI)
    else:
        kw.update(relu=s["relu"])
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    if s["r"]:
        dtype = getattr(torch, s["r"])
        r = (torch.randn((n, ho, wo, o), device=dev, generator=gen) * 30
             if dtype == torch.float32 else
             torch.randint(-128, 128, (n, ho, wo, o), device=dev,
                           generator=gen).to(dtype))
        kw.update(residual=(r, torch.rand(o, device=dev, generator=gen)
                            * 0.05, torch.randn(o, device=dev,
                                                generator=gen)), qb=-3.5)
    if s["term"]:
        # S per group, computed here: another tree's window sums may not
        # take groups (a pad adds 0)
        xp = F.pad(x.permute(0, 3, 1, 2).double() - ZERO,
                   (pad_lo, 3 - pad_lo, pad_lo, 3 - pad_lo))
        ones = torch.ones((groups, c // groups, 3, 3), dtype=torch.float64,
                          device=dev)
        sums = F.conv2d(xp, ones, stride=stride, groups=groups)
        sums = sums[:, :, :ho, :wo].permute(0, 2, 3, 1).to(torch.int32)
        if groups == 1:
            sums = sums[..., 0]
        kw["row"] = (sums.contiguous(),
                     torch.randn(o, device=dev, generator=gen) * 1e-3)
    wp = K.pack_weight_int4(wk, groups) if s["w4"] else \
        K.pack_weight(wk, groups)
    return x, wp, a, b, kw


def key(s):
    h, w, c, o = s["shape"]
    return (f"{s['model']} b{s['batch']} {s['index']:2d} conv "
            f"{(s['batch'], h, w, c)}->{o} g{s['groups']} s{s['stride']} "
            f"pad_lo {s['pad_lo']} {s['group']}")


def other_plans(K, x, wp, s, kw):
    """The plan overrides ``--plans`` times: every ring depth, halo count
    and weight placement that fits the launch's width."""
    import itertools
    over = []
    for stages, halo, resident in itertools.product(
            range(K.MIN_STAGES, K.MAX_STAGES + 1), (0, 1, 2), (False, True)):
        o = dict(stages=stages, halo_bufs=halo, resident=resident)
        try:
            K.launch_plan(x, wp.shape[0], s["mode"], s["stride"], 1,
                          kw.get("residual"), o, wp)
        except ValueError:
            continue
        over.append(o)
    return over


def launch_row(K, s, gen, widths=False, plans=False):
    """Check and time one launch (at each compiled width with ``widths``,
    at the other plans of its width with ``plans``); returns its row."""
    import torch
    from dlmc_quant_torch.utils.launches import launch_bound
    from dlmc_quant_torch.utils.profiling import bound_by, graph_ms
    row = dict(s, key=key(s), ms=None)
    try:
        x, wp, a, b, kw = operands(K, s, gen)
        want = K.int8_conv3x3_plain(x, wp, a, b, **kw)
        got = K.int8_conv3x3(x, wp, a, b, **kw)
    except ValueError as err:           # a grouped row term refused
        row["refused"] = repr(err)
        return row
    bound, ops_ms, bytes_ms = launch_bound("conv", (x, wp, a, b), kw, want)
    row.update(bound_ms=bound, bound_by=bound_by(ops_ms, bytes_ms))
    if not torch.equal(got, want):
        raise RuntimeError(f"{row['key']}: kernel differs from its plain "
                           "version")
    row["ms"] = graph_ms(lambda i: K.int8_conv3x3(x, wp, a, b, **kw),
                         LAUNCHES, REPS)
    if hasattr(K, "launch_plan"):
        plan = K.launch_plan(x, wp.shape[0], s["mode"], s["stride"],
                             s["groups"], kw.get("residual"), None, wp)
        row["plan"] = dict(plan._asdict())

        def checked_ms(over):
            """The launch at the plan overrides ``over``: == plain, timed."""
            got = K.int8_conv3x3(x, wp, a, b, _plan=over, **kw)
            if not torch.equal(got, want):
                raise RuntimeError(f"{row['key']}: kernel at {over} differs "
                                   "from its plain version")
            return graph_ms(lambda i: K.int8_conv3x3(x, wp, a, b, _plan=over,
                                                     **kw), LAUNCHES, REPS)

        h, w, c, o = s["shape"]
        r = kw.get("residual")
        if widths and s["groups"] == 1:
            row["widths"] = {}
            for bn in K.widths_for(o, s["mode"],
                                   r[0].element_size() if r else 0):
                try:
                    K.launch_plan(x, o, s["mode"], s["stride"], 1, r,
                                  dict(bn=bn), wp)
                except ValueError:      # that width's plan does not fit
                    continue
                row["widths"][bn] = checked_ms(dict(bn=bn))
        if plans and s["groups"] == 1 and s["stride"] == 1 and c in (64, 128):
            row["plans"] = [dict(over, ms=checked_ms(over))
                            for over in other_plans(K, x, wp, s, kw)]
    return row


# --parts: the kernel with one part left out.  A test the compiler cannot
# decide (false at every launch here) keeps the rest of the kernel.  Each
# part lists (old, new) edits; at least one must apply, each at most once.
NEVER = "(g.M > (1 << 30))"
_PARTS = {
    "whole": [],
    "no tile build": [
        ("        if (g.tma_a) {\n          // nothing more: the box is in "
         "flight\n        } else if (g.halo_bufs) {",
         f"        if (!{NEVER}) {{\n        }} else if (g.halo_bufs) {{"),
        ("          mbar_arrive_expect_tx(fbar, C::A_BYTES + (b_tma ? "
         "C::B_BYTES : 0));\n          tma_load_2d(a_tile, &map_x,",
         "          mbar_arrive_expect_tx(fbar, b_tma ? C::B_BYTES : 0);\n"
         f"          if {NEVER} tma_load_2d(a_tile, &map_x,"),
        ("          ldmatrix_x4(buf[j][kk],",
         f"          if {NEVER} ldmatrix_x4(buf[j][kk],")],
    "no products": [
        ("          Wgmma<BN>::mma(acc[j],",
         f"          if {NEVER} Wgmma<BN>::mma(acc[j],"),
        ("          WgmmaRS<BN>::mma(acc[j],",
         f"          if {NEVER} WgmmaRS<BN>::mma(acc[j],")],
    "no epilogue math": [
        ("                c[e] = code_of(y, flo, fhi);",
         "                c[e] = acc[j][4 * i + 2 * h + e];"),
        ("                code[e] = code_of(y, flo, fhi);",
         "                code[e] = acc[j][4 * i + 2 * h + e];"),
        ("              y[e] = __fadd_rn(prod, e ? bv.y : bv.x);",
         "              y[e] = __int_as_float(acc[j][4 * i + 2 * h + e]);")],
    "no residual loads": [
        ("                load_residual(g, orow, c0 + col, rv, arv, brv);",
         f"                if {NEVER} load_residual(g, orow, c0 + col, rv, "
         "arv, brv);"),
        ("  mbar_arrive_expect_tx(bars + 8 * s, C::R_AREA);\n"
         "  tma_load_2d(slots + s * C::SLOT, map, bars + 8 * s, col * C::RB, "
         "row);",
         "  mbar_arrive(bars + 8 * s);")],
    "no stores": [
        ("            if (m0 + row < g.M && col < c_end)\n"
         "              *reinterpret_cast<uint4*>(",
         f"            if ({NEVER} && m0 + row < g.M && col < c_end)\n"
         "              *reinterpret_cast<uint4*>("),
        ("              *reinterpret_cast<float2*>(orow + col) = ",
         f"              if {NEVER} *reinterpret_cast<float2*>(orow + col) = "),
        ("          tma_store_2d(&map_out,",
         f"          if {NEVER} tma_store_2d(&map_out,")],
}


def part_libraries():
    """{variant: its build's library}, one nvcc each, all at once."""
    from dlmc_quant_torch.ops.cuda import build
    text = (build.CSRC / "int8_conv3x3.cu").read_text()
    out = build.BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    procs = {}
    for i, (name, edits) in enumerate(_PARTS.items()):
        src, applied = text, 0
        for old, new in edits:
            count = src.count(old)
            if count > 1:
                raise RuntimeError(f"conv_launches: {old.strip()!r} occurs "
                                   f"{count} times")
            src = src.replace(old, new)
            applied += count
        if edits and not applied:
            raise RuntimeError(f"conv_launches: no edit of {name!r} applies "
                               "to the source")
        path = out / f"conv_part{i}.cu"
        path.write_text(src)
        procs[name] = (path, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name!r} variant:\n{err}")
        libs[name] = ctypes.CDLL(str(path.with_suffix(".so")))
    return libs


def parts_rows(K, specs, gen):
    """Each ungrouped launch of ``specs`` timed in every variant."""
    from dlmc_quant_torch.utils.profiling import graph_ms
    libs = part_libraries()
    rows = []
    for s in specs:
        if s["groups"] != 1:
            continue
        x, wp, a, b, kw = operands(K, s, gen)
        times = {}
        for name, lib in libs.items():
            lib = K.bind(lib)
            times[name] = graph_ms(
                lambda i, lib=lib: K.int8_conv3x3(x, wp, a, b, _lib=lib,
                                                  **kw), LAUNCHES, REPS)
        rows.append(dict(s, key=key(s), parts=times))
        del x, wp, a, b, kw
    return rows


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--root", default=None,
                      help="the tree whose dlmc_quant_torch is timed")
    args.add_argument("--json", default=None, help="write the rows here")
    args.add_argument("--batch", type=int, default=256,
                      help="RepVGG-A0's request batch")
    args.add_argument("--grouped-batch", type=int, default=64,
                      help="RepVGG-B2g4's request batch (0: none)")
    args.add_argument("--resnet-batch", type=int, default=256,
                      help="ResNet-50's and cifar_resnet18's batch (0: none)")
    args.add_argument("--config5-batch", type=int, default=128,
                      help="config #5's batch (0: none)")
    args.add_argument("--models", default=",".join(MODELS),
                      help="which models' launches, comma-separated")
    args.add_argument("--parts", action="store_true")
    args.add_argument("--widths", action="store_true")
    args.add_argument("--plans", action="store_true")
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
    specs = launch_specs(opts)
    rows, sums = [], {}
    for s in specs:
        row = launch_row(K, s, gen, opts.widths, opts.plans)
        rows.append(row)
        if row["ms"] is None:
            print(f"{row['key']}: refused ({row['refused']})", flush=True)
            continue
        tot = sums.setdefault((s["model"], s["batch"], s["group"]),
                              [0, 0.0, 0.0])
        tot[0] += 1
        tot[1] += row["ms"]
        tot[2] += row["bound_ms"]
        plan = row.get("plan")
        extra = "" if plan is None else (
            f" [bn {plan['bn']} x{plan['n_tiles']} stages {plan['stages']} "
            f"res {int(plan['resident'])} halo {plan['halo_bufs']}]")
        extra += "".join(f" {bn}:{ms * 1e3:.2f}"
                         for bn, ms in row.get("widths", {}).items())
        extra += "".join(
            f" s{p['stages']}h{p['halo_bufs']}r{int(p['resident'])}:"
            f"{p['ms'] * 1e3:.2f}" for p in row.get("plans", []))
        print(f"{row['key']} | {row['ms'] * 1e3:8.2f} us bound "
              f"{row['bound_ms'] * 1e3:7.2f} us ({row['bound_by']}) "
              f"x{row['ms'] / row['bound_ms']:5.2f}{extra}", flush=True)
    for (model, n, grp), (count, ms, bound) in sums.items():
        print(f"# {model} batch {n}: {count} {grp} launches, kernel "
              f"{ms:.4f} ms, bound {bound:.4f} ms", flush=True)
    by_model = {}
    for (model, n, _), (count, ms, bound) in sums.items():
        t = by_model.setdefault((model, n), [0, 0.0, 0.0])
        for i, v in enumerate((count, ms, bound)):
            t[i] += v
    for (model, n), (count, ms, bound) in by_model.items():
        print(f"# {model} batch {n}: all {count} launches, kernel "
              f"{ms:.4f} ms, bound {bound:.4f} ms", flush=True)
    if opts.parts:
        for row in parts_rows(K, [s for s in specs
                                  if s["model"] != "RepVGG_B2g4"], gen):
            print(f"parts {row['key']} | " + "; ".join(
                f"{k} {v * 1e3:.2f}" for k, v in row["parts"].items())
                + " us", flush=True)
            rows.append(row)
    if opts.json:
        pathlib.Path(opts.json).write_text(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
