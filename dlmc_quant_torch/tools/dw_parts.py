"""Where the depthwise kernel's wide build spends its time: the kernel with
its parts switched off, timed at GhostNet-1.0's ragged launches and the 5×5
launches of GhostNet-1.0 and EfficientNet-B0.

    python -m dlmc_quant_torch.tools.dw_parts [batch]

Builds variants of ``csrc/int8_dwconv5x5.cu`` (with its header
``int8_dwconv.cuh`` inlined) into ``_build/parts/``, each with some of its
three parts left out (their results are then wrong and only timed): the
halo's staging (``stage_wide`` and ``stage_halo``), the products of the
output rows (the row loop, and with it the stores) and the stores (the
epilogue's writes: ``store_row``, or the output rows' staging and copy,
``store_row_staged``).  Each
variant runs on seeded random codes at batch 256 by default, at each
launch's shape and mode (``tools/dw_launches.py``'s), on the plan the
wrapper picks, timed as that tool times the kernel (median of 5 replays of
a CUDA graph of 16 back-to-back launches).  A part's cost is not the
difference of two rows: the parts overlap one another, within a block and
across the blocks of a multiprocessor.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda import int8_dwconv as D
from dlmc_quant_torch.tools import dw_launches as tool
from dlmc_quant_torch.utils.profiling import card_line, graph_ms

LAUNCHES, REPS, SEED = 16, 5, 0
MODELS = ("GhostNet_1.0", "EfficientNet_B0")
# a test the compiler cannot decide (always true at these shapes), so that
# the rest of the kernel stays
NEVER = "if (g.H < (1 << 30)) return;"
_STAGING = [("__device__ void stage_halo(const DwArgs& g, int t, "
             "unsigned char* buf) {\n",
             "__device__ void stage_halo(const DwArgs& g, int t, "
             f"unsigned char* buf) {{\n  {NEVER}\n"),
            ("                                           unsigned char* "
             "buf) {\n",
             f"                                           unsigned char* "
             f"buf) {{\n  {NEVER}\n")]
_PRODUCTS = [("    for (int i = 0; i < g.rpt; ++i, ++oy, at += out_row) {",
              "    for (int i = 0; i < (g.H < (1 << 30) ? 0 : g.rpt); ++i, "
              "++oy, at += out_row) {", 2)]
_STORES = [("                                          long long at, int ox, "
            "int nc = 4) {\n",
            "                                          long long at, int ox, "
            f"int nc = 4) {{\n  {NEVER}\n"),
           ("    unsigned char* stage, int col, int c, int grp, const Tile& tl, "
            "int i) {\n",
            "    unsigned char* stage, int col, int c, int grp, const Tile& tl, "
            f"int i) {{\n  {NEVER}\n")]
VARIANTS = {
    "whole": [],
    "no stores": _STORES,
    "no staging": _STAGING,
    "staging only": _PRODUCTS,
}


def variant_sources():
    """{variant: its .cu path}, written under _build/parts/: the wide
    build's source with its header inlined and edited."""
    header = (build.CSRC / "int8_dwconv.cuh").read_text()
    text = (build.CSRC / "int8_dwconv5x5.cu").read_text().replace(
        '#include "int8_dwconv.cuh"', header)
    out = build.BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        src = text
        for edit in edits:
            old, new, count = (edit + (1,))[:3]
            if src.count(old) != count:
                raise RuntimeError(f"dw_parts: the source no longer has "
                                   f"the line {old.strip()!r} {count} "
                                   "time(s)")
            src = src.replace(old, new)
        paths[name] = out / f"dw_part{i}.cu"
        paths[name].write_text(src)
    return paths


def compile_all(paths):
    """{variant: its C entry point}, one nvcc each, all at once."""
    nvcc = build.nvcc_path()
    procs = {name: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(p.with_suffix(".so")), str(p)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, p in paths.items()}
    fns = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name!r} variant:\n{err}")
        fn = ctypes.CDLL(str(paths[name].with_suffix(".so"))).dlmcq_int8_dwconv
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 21
                       + [ctypes.c_void_p])
        fns[name] = fn
    return fns


def launcher(fn, name, x, wp, a, b, out, kw, p):
    """A launch of one variant with the wrapper's arguments."""
    n, h, w, c = x.shape
    k = D.window(wp)
    codes = kw["mode"] == "codes"
    top, left, ho, wo = D.geometry(h, w, k, kw["stride"], kw["pad_lo"])

    def launch(_):
        err = fn(x.data_ptr(), wp.data_ptr(), a.data_ptr(), b.data_ptr(),
                 None, out.data_ptr(), n, h, w, c, k, kw["stride"], top,
                 left, ho, wo, kw["pad"], kw.get("lo", -128),
                 kw.get("hi", 127), int(codes), int(kw.get("relu", False)),
                 0, D.route(x, wp), p.cb, p.cg, p.rg, p.rpt,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the {name!r} variant's launch failed: {err}")
    return launch


def main(argv=None):
    cli = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    cli.add_argument("batch", nargs="?", type=int, default=256)
    opts = cli.parse_args(argv)
    device = resolve_device(None)
    gen = torch.Generator(device=device).manual_seed(SEED)
    n = opts.batch
    fns = compile_all(variant_sources())
    print(f"# dw_parts on {card_line()}; batch {n}; per launch: median of "
          f"{REPS} replays of a CUDA graph of {LAUNCHES} back-to-back "
          f"launches; variants: {', '.join(fns)} (us)")
    rows, seen = [], set()
    for label, name, kwargs, rule in tool.MODELS:
        if label not in MODELS:
            continue
        for shape in tool.depthwise_shapes(name, kwargs, rule):
            if tool.group(shape) == "aligned" or shape in seen:
                continue
            seen.add(shape)
            x, wp, a, b = tool.operands(n, shape, gen)
            kw = tool.keywords(shape)
            h, w, c, k, stride = shape[:5]
            p = D.plan(n, h, w, c, stride, k, D.route(x, wp))
            ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
            out = torch.empty((n, ho, wo, c), device=device,
                              dtype=torch.int8 if kw["mode"] == "codes"
                              else torch.float32)
            times = {v: graph_ms(launcher(fn, v, x, wp, a, b, out, kw, p),
                                 LAUNCHES, REPS)
                     for v, fn in fns.items()}
            rows.append(dict(model=label, shape=shape, times=times))
            print(f"{label} {k}x{k} {shape[:3]} s{stride} {kw['mode']} "
                  f"{tool.group(shape)} [rg {p.rg} rpt {p.rpt}] | "
                  + " ".join(f"{t * 1e3:8.2f}" for t in times.values()),
                  flush=True)
    return rows


if __name__ == "__main__":
    main()
