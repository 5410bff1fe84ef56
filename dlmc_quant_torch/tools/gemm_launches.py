"""The int8 GEMM at every GEMM launch of ResNet-50's request (or of the
launches a file lists), each checked against its plain version and timed
beside its bound; on this tree or on another.

    python dlmc_quant_torch/tools/gemm_launches.py [--root DIR]
        [--specs PATH] [--json PATH] [--tiles] [--int-mm] [--models]
        [--parts] [batch]

The launches are ResNet-50's 36 (W8A8, ``'intc'``, 224×224, at ``batch``,
256 by default), in request order: each Bottleneck's conv1 (codes), its
downsample (int32, the first block of a stage) and its conv3 (codes with
the shortcut: int32 r after a downsample, int8 codes after that), as
``chip_smoke.py`` records them; or, with ``--specs PATH``, the JSON list
of launches ``chip_smoke.py`` writes (model, group, M, K, N, mode, r's
dtype, row term, W4, ReLU).  Every launch runs on seeded random operands,
is checked against ``int8_gemm_plain`` bit for bit (a launch that
differs raises), and is timed: the median of 5 replays of a CUDA graph of
16 back-to-back launches.  Beside it: its route and tile (this tree's
wrapper chooses them), its bound (``utils.launches.launch_bound``: each
input read and the output written once; int8 operations at 1,979 TOP/s,
bytes at 3.35 TB/s) and with ``--int-mm`` ``torch._int_mm``'s product
alone at the launch's (M, K, N) (int32 out).  Sums by model and group.

``--models`` adds the GEMM launches of MobileNetV2, MobileOne-S1 (W8A8,
all-W4) at ``batch`` and of BASELINE config #5 (RootQ W4A4 ResNet-50, the
row term, f32) at 128, built as ``chip_smoke.py`` builds them;
``--save-specs PATH`` writes the launches for ``--specs``.

``--root DIR`` imports ``dlmc_quant_torch`` from DIR instead of this
tree (run the file as a script for that, not with ``-m``), so that two
trees' kernels can be timed on one card in one call, turn about.
``--tiles`` times each launch that the staged route takes at every staged
tile too (this tree).
``--parts`` times the staged route with its residual loads, products,
epilogue arithmetic or stores left out (variants of
``csrc/int8_gemm_staged.cu`` built under ``_build/parts/``; their outputs
are wrong and only timed; the parts overlap, so a part's cost is not the
difference of two rows).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

LAUNCHES, REPS, SEED, LO, HI = 16, 5, 0, -20, 100
ROOTQ_BATCH = 128          # config #5's served batch (chip_smoke.py's)
# ResNet-50's stages: (blocks, input channels, bottleneck width, output
# channels, output side at 224x224), the first block's conv2 strided from
# stage 2 on (its conv1 at the input's side)
R50_STAGES = ((3, 64, 64, 256, 56), (4, 256, 128, 512, 28),
              (6, 512, 256, 1024, 14), (3, 1024, 512, 2048, 7))


def resnet50_specs(batch: int):
    """ResNet-50's GEMM launches of one ``'intc'`` request, in order."""
    specs = []

    def add(group, m, k, n, mode, r=None):
        specs.append(dict(model="resnet50", group=group, m=m, k=k, n=n,
                          mode=mode, r=r, term=False, w4=False, relu=False))

    side_in = 56
    for blocks, c_in, mid, c_out, side in R50_STAGES:
        m_in, m = batch * side_in ** 2, batch * side ** 2
        add("codes", m_in, c_in, mid, "codes")
        add("int32", m, c_in, c_out, "int32")
        add("residual", m, mid, c_out, "codes", "int32")
        for _ in range(blocks - 1):
            add("codes", m, c_out, mid, "codes")
            add("residual", m, mid, c_out, "codes", "int8")
        side_in = side
    return specs


def spec_of(model: str, args, kw, batch_scale: float = 1.0):
    """The spec of a recorded ``int8_gemm`` call (``LaunchRecorder``), its
    M scaled by ``batch_scale``."""
    x, wp = args[:2]
    r = kw.get("residual")
    mode = kw.get("mode", "int32")
    return dict(model=model, group="residual" if r is not None else mode,
                m=round(x.shape[0] * batch_scale), k=x.shape[1],
                n=wp.shape[0], mode=mode,
                r=str(r[0].dtype).split(".")[-1] if r is not None else None,
                term=kw.get("row") is not None, w4=wp.dtype != x.dtype,
                relu=bool(kw.get("relu", False)))


def model_specs(batch: int, rootq_batch: int, device: str = "cuda"):
    """The GEMM launches of one request of MobileNetV2, MobileOne-S1 (W8A8
    and all-W4), as ``chip_smoke.py``'s mobile and w4 phases build them
    (train form, fuser, bench's scheme, calibrate, prepare_deploy), at
    ``batch``, and of BASELINE config #5 (RootQ W4A4 ResNet-50, train form,
    the row term: ``tools/row_bounds.py``'s model) at ``rootq_batch``:
    each recorded at batch 2 on ``device``, M scaled."""
    import torch
    root = pathlib.Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import chip_smoke as smoke
    from dlmc_quant_torch.tools import row_bounds
    from dlmc_quant_torch.utils.config import read_yaml
    from dlmc_quant_torch.utils.launches import LaunchRecorder
    dev = torch.device(device)

    def record(label, model, x, scale):
        with torch.inference_mode(), LaunchRecorder() as rec:
            model(x, qmode="intc")
        return [spec_of(label, a, kw, scale) for kind, a, kw, _ in rec.calls
                if kind == "gemm"]

    specs = []
    for label, scheme in (("mobilenet_v2", smoke.BENCH_SCHEME),
                          ("MobileOne_S1", smoke.BENCH_SCHEME),
                          ("MobileOne_S1_w4", smoke.W4_SCHEME)):
        name, kwargs, fuser = smoke.MOBILE[label.replace("_w4", "")][:3]
        model = smoke.mobile_deployed(name, kwargs, fuser, dev, scheme)
        specs += record(label, model, smoke.images(2, smoke.SEED + 1, dev),
                        batch / 2)
        del model
    rootq = smoke.scheme_from_dict(read_yaml(
        row_bounds.CONFIGS / "RootQ_resnet50_imagenet_w4a4.yaml")[
            "quantization"])
    model = row_bounds._prepared(smoke.get_model(
        "resnet50", device=dev, num_classes=1000, scheme=rootq,
        generator=torch.Generator().manual_seed(SEED)), 224, dev,
        spread=True)
    specs += record("config5", model, row_bounds._images(2, 224, dev),
                    rootq_batch / 2)
    return specs


def operands(spec, gen):
    """Seeded operands and keywords of one launch on the card."""
    import torch
    from dlmc_quant_torch.ops.cuda import int8_gemm as G
    dev = gen.device
    m, k, n = spec["m"], spec["k"], spec["n"]
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev,
                      generator=gen)
    lim = 8 if spec["w4"] else 128
    w = torch.randint(-lim, lim, (k, n), dtype=torch.int8, device=dev,
                      generator=gen)
    wp = G.pack_b_int4(w) if spec["w4"] else G.pack_b(w)
    if spec["mode"] == "int32":
        return x, wp, None, None, {}
    a = torch.rand(n, device=dev, generator=gen) * 1e-3 + 1e-5
    b = torch.randn(n, device=dev, generator=gen) * 4
    kw = (dict(mode="codes", lo=LO, hi=HI) if spec["mode"] == "codes"
          else dict(mode="f32", relu=spec["relu"]))
    if spec["r"]:
        dtype = getattr(torch, spec["r"])
        r = (torch.rand((m, n), device=dev, generator=gen) * 3
             if dtype == torch.float32 else
             torch.randint(-128, 128, (m, n), device=dev,
                           generator=gen).to(dtype))
        kw.update(residual=(r, torch.rand(n, device=dev, generator=gen)
                            * 0.05, torch.randn(n, device=dev,
                                                generator=gen)), qb=-3.5)
    if spec["term"]:
        kw["row"] = (torch.randint(-2000, 2000, (m,), dtype=torch.int32,
                                   device=dev, generator=gen),
                     torch.randn(n, device=dev, generator=gen) * 1e-3)
    return x, wp, a, b, kw


def checked_ms(G, x, wp, a, b, kw, want, what):
    """The launch == want, then its ms (CUDA graph)."""
    import torch
    from dlmc_quant_torch.utils.profiling import graph_ms
    got = G.int8_gemm(x, wp, a, b, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError(f"gemm_launches: {what} differs from its plain "
                           "version")
    return graph_ms(lambda _: G.int8_gemm(x, wp, a, b, **kw), LAUNCHES,
                    REPS)


def launch_tile(G, spec, device, r):
    """The tile the tree's wrapper takes by default."""
    if hasattr(G, "launch_tile"):
        return G.launch_tile(spec["m"], spec["n"], spec["mode"], spec["w4"],
                             r, G.sm_count(device))
    tiles = G.EPILOGUE_TILES if spec["mode"] != "int32" or spec["w4"] \
        else G.TILES
    return G.default_tile(spec["m"], spec["n"], G.sm_count(device), tiles)


def launch_row(G, spec, gen, opts):
    import torch
    from dlmc_quant_torch.utils.launches import launch_bound
    from dlmc_quant_torch.utils.profiling import bound_by, graph_ms
    x, wp, a, b, kw = operands(spec, gen)
    want = G.int8_gemm_plain(x, wp, a, b, **kw)
    what = (f"({spec['m']},{spec['k']})x({spec['k']},{spec['n']}) "
            f"{spec['mode']}" + (f" +r {spec['r']}" if spec["r"] else "")
            + (" +o_w" if spec["term"] else "") + (" w4" if spec["w4"]
                                                   else ""))
    ms = checked_ms(G, x, wp, a, b, kw, want, what)
    b_ms, t_ops, t_bytes = launch_bound("gemm", (x, wp), kw, want)
    row = dict(spec, ms=ms, bound_ms=b_ms, bound_by=bound_by(t_ops, t_bytes),
               what=what)
    r = kw.get("residual", (None,))[0]
    row["tile"] = list(launch_tile(G, spec, x.device, r))
    if hasattr(G, "route"):
        row["route"] = G.route(spec["n"], spec["mode"], row["tile"], r)
        if opts.tiles and row["route"] == "staged":
            row["tiles"] = {f"{t[0]}x{t[1]}": checked_ms(
                G, x, wp, a, b, dict(kw, tile=t), want, what)
                for t in G.STAGED_TILE_STAGES}
    if opts.int_mm:
        wc = G.unpack_b(wp, spec["k"]).t().contiguous().t()
        if not torch.equal(torch._int_mm(x, wc),
                           G.int8_gemm_plain(x, wp)):
            raise RuntimeError(f"gemm_launches: torch._int_mm differs at "
                               f"{what}")
        row["int_mm_ms"] = graph_ms(lambda _: torch._int_mm(x, wc),
                                    LAUNCHES, REPS)
    del x, wp, a, b, kw, want
    return row


# --parts: the staged build with one part left out.  A test the compiler
# cannot decide (false at every launch here) keeps the rest of the kernel.
NEVER = "(M > (1 << 30))"
_PARTS = {
    "whole": [],
    "no residual loads": [
        ("            mbar_arrive_expect_tx(r_full + bar, S::R_AREA);\n"
         "            tma_load_2d(",
         "            mbar_arrive(r_full + bar);\n"
         f"            if {NEVER} tma_load_2d(")],
    "no products": [
        ("        Wgmma<BN>::mma(acc,",
         f"        if {NEVER} Wgmma<BN>::mma(acc,")],
    "no epilogue math": [
        ("                __byte_perm(staged_code(y0, lo, hi), "
         "staged_code(y1, lo, hi),",
         "                __byte_perm(v0, v1,")],
    "no stores": [
        ("      tma_store_2d(map_out,",
         f"      if {NEVER.replace('M', 'rows')} tma_store_2d(map_out,")],
}


def part_libraries():
    """{variant: its build's library}, one nvcc each, all at once."""
    from dlmc_quant_torch.ops.cuda import build
    text = (build.CSRC / "int8_gemm.cu").read_text()
    out = build.BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    procs = {}
    for i, (name, edits) in enumerate(_PARTS.items()):
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"gemm_launches: the source no longer has "
                                   f"{old.strip()!r} once")
            src = src.replace(old, new)
        path = out / f"gemm_part{i}.cu"
        path.write_text("#define DLMCQ_GEMM_STAGED 1\n" + src)
        procs[name] = (path, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name!r} variant:\n{err}")
        lib = ctypes.CDLL(str(path.with_suffix(".so")))
        lib.dlmcq_int8_gemm_epilogue.restype = ctypes.c_int
        lib.dlmcq_int8_gemm_epilogue.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
            + [ctypes.c_void_p] * 5 + [ctypes.c_float] + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 3)
        lib.dlmcq_int8_gemm.restype = ctypes.c_int
        lib.dlmcq_int8_gemm.argtypes = ([ctypes.c_void_p] * 3
                                        + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def parts_rows(G, specs, gen):
    """Each staged epilogue launch of ``specs`` timed in every variant."""
    import torch
    from dlmc_quant_torch.ops.cuda.epilogue import RESIDUAL_KINDS
    from dlmc_quant_torch.utils.profiling import graph_ms
    libs = part_libraries()
    rows = []
    for spec in specs:
        x, wp, a, b, kw = operands(spec, gen)
        r, ar, br = kw.get("residual", (None,) * 3)
        tile = launch_tile(G, spec, x.device, r)
        if G.route(spec["n"], spec["mode"], tile, r) != "staged":
            continue
        out = torch.empty((spec["m"], spec["n"]), device=x.device,
                          dtype={"codes": torch.int8, "f32": torch.float32,
                                 "int32": torch.int32}[spec["mode"]])
        sums, c = kw.get("row", (None, None))

        def launch(lib):
            def go(_):
                if spec["mode"] == "int32":
                    err = lib.dlmcq_int8_gemm(
                        x.data_ptr(), wp.data_ptr(), out.data_ptr(),
                        spec["m"], spec["n"], spec["k"],
                        G.packed_k(spec["k"]), int(spec["w4"]), *tile,
                        torch.cuda.current_stream().cuda_stream)
                else:
                    err = lib.dlmcq_int8_gemm_epilogue(
                        x.data_ptr(), wp.data_ptr(), out.data_ptr(),
                        spec["m"], spec["n"], spec["k"],
                        G.packed_k(spec["k"]), int(spec["w4"]), *tile,
                        int(spec["mode"] == "codes"), a.data_ptr(),
                        b.data_ptr(),
                        *(t.data_ptr() if t is not None else None
                          for t in (r, ar, br)), kw.get("qb", 0.0),
                        kw.get("lo", -128), kw.get("hi", 127),
                        int(kw.get("relu", False)),
                        RESIDUAL_KINDS[r.dtype] if r is not None else 0,
                        *(t.data_ptr() if t is not None else None
                          for t in (sums, c)),
                        torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"gemm_launches: a part variant's "
                                       f"launch failed ({err})")
            return go
        rows.append(dict(spec, parts={name: graph_ms(launch(lib), LAUNCHES,
                                                     REPS)
                                      for name, lib in libs.items()}))
        del x, wp, a, b, kw, out
    return rows


def main(argv=None):
    cli = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    cli.add_argument("--root", default=None,
                     help="the tree whose dlmc_quant_torch is timed")
    cli.add_argument("--specs", default=None,
                     help="a JSON list of launches (chip_smoke.py's)")
    cli.add_argument("--json", default=None, help="write the rows here")
    cli.add_argument("--tiles", action="store_true")
    cli.add_argument("--int-mm", action="store_true")
    cli.add_argument("--parts", action="store_true")
    cli.add_argument("--models", action="store_true",
                     help="also MobileNetV2's, MobileOne-S1's (W8, W4) and "
                          "config #5's launches (this tree's models)")
    cli.add_argument("batch", nargs="?", type=int, default=256)
    opts = cli.parse_args(argv)
    root = pathlib.Path(opts.root or pathlib.Path(__file__).parents[2])
    sys.path.insert(0, str(root.resolve()))
    import torch
    from dlmc_quant_torch.ops.cuda import int8_gemm as G
    from dlmc_quant_torch.utils.profiling import card_line
    if not torch.cuda.is_available():
        raise SystemExit("gemm_launches: no CUDA device")
    specs = (json.loads(pathlib.Path(opts.specs).read_text()) if opts.specs
             else resnet50_specs(opts.batch))
    if opts.models:
        specs += model_specs(opts.batch, ROOTQ_BATCH)
    print(f"# gemm_launches on {card_line()}; tree {root.resolve()} "
          f"({G.__file__}); {len(specs)} launches; per launch: median of "
          f"{REPS} replays of a CUDA graph of {LAUNCHES} back-to-back "
          "launches (us): kernel, bound (by), kernel/bound, route tile"
          + (", {_int_mm}" if opts.int_mm else ""), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, sums = [], {}
    for i, spec in enumerate(specs):
        row = launch_row(G, spec, gen, opts)
        row["index"] = i
        rows.append(row)
        extra = ""
        if "int_mm_ms" in row:
            extra += f" {{{row['int_mm_ms'] * 1e3:8.2f}}}"
        for t, ms in row.get("tiles", {}).items():
            extra += f" {t} {ms * 1e3:.2f}"
        print(f"{spec['model']} {i:2d} {row['what']:48s} | "
              f"{row['ms'] * 1e3:8.2f} {row['bound_ms'] * 1e3:8.2f} "
              f"({row['bound_by']}) {row['ms'] / row['bound_ms']:5.2f} "
              f"{row.get('route', '-')} {row['tile'][0]}x{row['tile'][1]}"
              f"{extra}", flush=True)
        s = sums.setdefault((spec["model"], spec["group"]),
                            dict(n=0, ms=0.0, bound_ms=0.0, int_mm_ms=0.0))
        s["n"] += 1
        for key in ("ms", "bound_ms", "int_mm_ms"):
            s[key] += row.get(key, 0.0)
    for (model, group), s in sums.items():
        print(f"# {model} {group}: {s['n']} launches, kernel "
              f"{s['ms']:.4f} ms, bound {s['bound_ms']:.4f} ms"
              + (f", torch._int_mm {s['int_mm_ms']:.4f} ms" if opts.int_mm
                 else ""), flush=True)
    if opts.parts:
        for row in parts_rows(G, specs, gen):
            print(f"parts {row['model']} ({row['m']},{row['k']})x"
                  f"({row['k']},{row['n']}) {row['mode']}"
                  f"{' +r ' + row['r'] if row['r'] else ''} | " + "; ".join(
                      f"{k} {v * 1e3:.2f}" for k, v in row["parts"].items())
                  + " us", flush=True)
            rows.append(row)
    if opts.json:
        pathlib.Path(opts.json).write_text(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
