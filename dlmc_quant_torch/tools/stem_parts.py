"""Where the stem conv + pool kernel's time goes: the kernel with its parts
switched off, timed at ResNet-50's stem.

    python -m dlmc_quant_torch.tools.stem_parts [--band 7] [batch]

Builds variants of ``csrc/int8_stem_pool.cu`` into ``_build/parts/``, each
with some of its three parts left out (their results are then wrong and
only timed): the products (the wgmmas of each conv row), the pool (the
column and row max, the epilogue, the staging and the stores) and the band
(the input band's staging and the cells built from it).  ``products x2``
issues each row's eight wgmmas twice: the difference to the whole kernel
is what eight more wgmmas a row cost where everything else stays.  Each
variant runs on seeded random codes (batch 256 by default, 224×224×3,
SAME pads (2, 3), 64 channels) in codes and int32 modes at one band size,
timed as ``tools/stem_bands.py`` times the kernel (median of 5 replays of
a CUDA graph of 16 back-to-back launches).  A part's cost is not the
difference of two rows: the parts overlap one another, within a block and
across the two blocks of a multiprocessor.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda import int8_stem_pool as S
from dlmc_quant_torch.utils.profiling import card_line, graph_ms

SIZE, C, O, PADS, PAD = 224, 3, 64, ((2, 3), (2, 3)), 3
LAUNCHES, REPS, SEED = 16, 5, 0
# the source's lines that each part's removal replaces, and with what: a
# test the compiler cannot decide, so that the rest of the kernel stays
_PRODUCTS = ("    Wgmma<PIX>::mma(acc, da, db, s);",
             "    if (s < 0) Wgmma<PIX>::mma(acc, da, db, s);")
_TWICE = ("    Wgmma<PIX>::mma(acc, da, db, s);",
          "    Wgmma<PIX>::mma(acc, da, db, s);\n"
          "    Wgmma<PIX>::mma(acc, da, db, 1);")
_POOL = [("                                         bool in, int relu, "
          "int lo, int hi) {\n",
          "                                         bool in, int relu, "
          "int lo, int hi) {\n  if (hi < 1000) return;\n"),
         ("                                          int cols, int O) {\n",
          "                                          int cols, int O) {\n"
          "  if (O < 100000) return;\n")]
_BAND = [("    build_cells<C>(band, g.pitch, w.lead, c_base, 2 * w.rows + 4);",
          ""),
         ("      stage_unit<C>(g, band, unit_of(g, u + gridDim.x, C));", "")]
VARIANTS = {
    "whole": [],
    "products x2": [_TWICE],
    "no products": [_PRODUCTS],
    "no pool": _POOL,
    "no band": _BAND,
    "products only": _POOL + _BAND,
    "pool only": [_PRODUCTS] + _BAND,
    "band only": [_PRODUCTS] + _POOL,
}


def variant_sources():
    """{variant: its .cu path}, written under _build/parts/."""
    text = (build.CSRC / "int8_stem_pool.cu").read_text()
    out = build.BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"stem_parts: the source no longer has "
                                   f"the line {old.strip()!r} once")
            src = src.replace(old, new)
        paths[name] = out / f"stem_part{i}.cu"
        paths[name].write_text(src)
    return paths


def compile_all(paths):
    """{variant: loaded library}, one nvcc each, all at once."""
    nvcc = build.nvcc_path()
    procs = {name: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(p.with_suffix(".so")), str(p)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, p in paths.items()}
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name!r} variant:\n{err}")
        lib = ctypes.CDLL(str(paths[name].with_suffix(".so")))
        fn = lib.dlmcq_int8_stem_pool
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 16
                       + [ctypes.c_void_p])
        libs[name] = fn
    return libs


def main(argv=None):
    cli = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    cli.add_argument("--band", type=int, default=7)
    cli.add_argument("batch", nargs="?", type=int, default=256)
    opts = cli.parse_args(argv)
    device = resolve_device(None)
    gen = torch.Generator(device=device).manual_seed(SEED)
    n = opts.batch
    x = torch.randint(-128, 128, (n, SIZE, SIZE, C), dtype=torch.int8,
                      device=device, generator=gen)
    wp = S.pack_weight(torch.randint(-128, 128, (S.KERNEL, S.KERNEL, C, O),
                                     dtype=torch.int8, device=device,
                                     generator=gen))
    a = torch.full((O,), 1e-3, device=device)
    b = torch.zeros(O, device=device)
    hc, wc, hp, wpool = S.geometry(SIZE, SIZE, PADS)
    fns = compile_all(variant_sources())
    print(f"# stem_parts on {card_line()}; batch {n}, band {opts.band}; "
          f"times: per launch, median of {REPS} replays of a CUDA graph of "
          f"{LAUNCHES} back-to-back launches")
    rows = []
    for mode in ("codes", "int32"):
        out = torch.empty((n, hp, wpool, O), device=device,
                          dtype=torch.int8 if mode == "codes" else
                          torch.int32)
        for name, fn in fns.items():
            def launch(_):
                err = fn(x.data_ptr(), wp.data_ptr(), out.data_ptr(),
                         a.data_ptr(), b.data_ptr(), n, SIZE, SIZE, C, O,
                         PADS[0][0], PADS[1][0], hc, wc, PAD, opts.band, 0,
                         S.MODES.index(mode), -128, 127, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"the {name!r} variant's launch "
                                       f"failed: {err}")
            ms = graph_ms(launch, LAUNCHES, REPS)
            print(f"{mode:5s} {name:14s} {ms * 1e3:8.2f} us", flush=True)
            rows.append(dict(mode=mode, variant=name, ms=ms))
    return rows


if __name__ == "__main__":
    main()
