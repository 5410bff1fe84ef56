"""The stem conv + pool kernel at ResNet-50's stem, band size against band
size in each mode, and the stem's part of a request; on this tree or on
another.

    python dlmc_quant_torch/tools/stem_bands.py [--root DIR] [--json PATH]
        [--split] [batch ...]

At each batch (8 and 256 by default) it runs ``int8_stem_pool`` on seeded
random codes (224×224×3, SAME pads (2, 3), 64 output channels) in each
mode at every band size (pooled rows a unit, 1 to 8), checks each result
against the plain version bit for bit, and prints µs per launch beside the
bound: the larger of the conv's int8 operations over 1979 TOP/s and bytes
over 3.35 TB/s (H100 SXM data sheet; input, weight, the epilogue's a and b
and the pooled output counted once: 1 byte a value in codes mode, 4 in
int32 and f32).  Times are per-launch medians of CUDA-graph replays of
back-to-back launches on the same operands; ``*`` marks
:func:`band_rows`' choice.  This is the instrument for that rule.

``--split`` instead times the stem's part of a ResNet-50 ``intc``
request at each batch, as the chain runs it: the pending stem conv,
ReLU-flagged and pooled by ``qmaxpool``, then the first block's two
consumers' folded quantizes (``fold_quantize``, two folds).  On a tree
whose ``qmaxpool`` gives the pooled int32 accumulator that is one int32
launch and two folds in torch ops; on one whose stem stays pending, two
launches in codes mode.  ``--root DIR`` imports ``dlmc_quant_torch`` from
DIR instead of this tree, so that two trees can be timed on one card in
one call, turn about (run the file as a script for that, not with
``-m``); a tree whose wrapper has no modes is swept in int32 only.
``--json PATH`` writes the rows.
"""

from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import sys

SIZE, C, O, PADS, PAD = 224, 3, 64, ((2, 3), (2, 3)), 3
LAUNCHES, REPS, SEED = 16, 5, 0
# the two consumers' folds of the split: (inverse scale, shifted zero,
# code range) of the first block's conv1 and its downsample
FOLDS = ((1.7, -3.0, -128, 127), (0.9, 2.0, -128, 127))


def cost(n: int, mode: str):
    """(operations, bytes) of the stem at batch ``n`` in ``mode``."""
    from dlmc_quant_torch.ops.cuda import int8_stem_pool as S
    hc, wc, hp, wp = S.geometry(SIZE, SIZE, PADS)
    ops = 2 * n * hc * wc * O * S.KERNEL ** 2 * C
    out = n * hp * wp * O * (1 if mode == "codes" else 4)
    epi = 0 if mode == "int32" else 8 * O
    return ops, n * SIZE * SIZE * C + S.TAPS ** 2 * O * S.CELL + epi + out


def operands(n: int, gen):
    """Seeded codes and packed weight at ResNet-50's stem, and a fold."""
    import torch
    from dlmc_quant_torch.ops.cuda import int8_stem_pool as S
    dev = gen.device
    x = torch.randint(-128, 128, (n, SIZE, SIZE, C), dtype=torch.int8,
                      device=dev, generator=gen)
    wk = torch.randint(-128, 128, (S.KERNEL, S.KERNEL, C, O),
                       dtype=torch.int8, device=dev, generator=gen)
    scale = 2e-4 + 6e-4 * torch.rand(O, device=dev, generator=gen)
    bias = 20.0 * torch.randn(O, device=dev, generator=gen)
    return x, wk, scale, bias


def _time(fn):
    from dlmc_quant_torch.utils.profiling import graph_ms
    return graph_ms(lambda i: fn(), LAUNCHES, REPS)


def batch_rows(n: int, gen, modes):
    """Time one batch at every band in each mode; returns its rows."""
    import torch
    from dlmc_quant_torch.ops.cuda import int8_stem_pool as S
    from dlmc_quant_torch.utils.profiling import bound_by, roof_ms
    x, wk, scale, bias = operands(n, gen)
    wp = S.pack_weight(wk)
    _, _, hp, wpool = S.geometry(SIZE, SIZE, PADS)
    chosen = S.band_rows(n, hp, wpool, O)
    rows = []
    for mode in modes:
        args, kw = (x, wp), dict(pads=PADS, pad=PAD)
        if mode != "int32":
            args += (scale * 0.5, bias)
            kw.update(dict(mode=mode, lo=-20, hi=100) if mode == "codes"
                      else dict(mode=mode, relu=True))
        want = S.int8_stem_pool_plain(*args, **kw)
        ops_ms, bytes_ms = roof_ms(*cost(n, mode))
        b_ms = max(ops_ms, bytes_ms)
        for band in range(1, S.MAX_BAND + 1):
            got = S.int8_stem_pool(*args, **kw, _band=band)
            if not torch.equal(got, want):
                raise RuntimeError(f"batch {n} {mode} band {band}: kernel "
                                   "differs from its plain version")
            ms = _time(lambda: S.int8_stem_pool(*args, **kw, _band=band))
            print(f"batch {n:3d} {mode:5s} band {band} "
                  f"{S.units(n, hp, wpool, O, band):5d} units"
                  f"{' *' if band == chosen else '  '} {ms * 1e3:8.2f} us | "
                  f"bound {b_ms * 1e3:7.2f} us ({bound_by(ops_ms, bytes_ms)})"
                  f" x{ms / b_ms:5.2f}", flush=True)
            rows.append(dict(batch=n, mode=mode, band=band, ms=ms,
                             bound_ms=b_ms, chosen=band == chosen))
    return rows


def split_ms(n: int, gen):
    """The stem's part of a request at batch ``n`` as the tree's chain runs
    it: qmaxpool of the pending stem, then two consumers' fold_quantize."""
    import torch
    from dlmc_quant_torch.ops.cuda import int8_im2col as I
    from dlmc_quant_torch.ops.cuda import int8_stem_pool as S
    from dlmc_quant_torch.quant import chain
    x, wk, scale, bias = operands(n, gen)
    pending = chain.PendingWideConv(x, I.pack_weight(wk), S.pack_weight(wk),
                                    S.KERNEL, S.STRIDE, PADS, PAD)
    de = chain.qrelu(chain.DeferredEpilogue(pending, scale, bias))

    def stem():
        pooled = chain.qmaxpool(de, (3, 3), (2, 2), ((1, 1), (1, 1)))
        return [chain.fold_quantize(pooled, *fold) for fold in FOLDS]

    S.int8_stem_pool.launches = 0
    with torch.inference_mode():
        codes = stem()
    launches = S.int8_stem_pool.launches
    with torch.inference_mode():
        ms = _time(stem)
    print(f"batch {n:3d} stem + pool + {len(FOLDS)} consumers' codes: "
          f"{ms * 1e3:8.2f} us, {launches} int8_stem_pool launches, codes "
          f"{[tuple(c.shape) for c in codes]}", flush=True)
    return dict(batch=n, split=True, ms=ms, launches=launches)


def main(argv=None):
    """Time every band in each mode (or the split) at each batch."""
    cli = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    cli.add_argument("--root", default=None,
                     help="import dlmc_quant_torch from this tree")
    cli.add_argument("--json", default=None, help="write the rows here")
    cli.add_argument("--split", action="store_true",
                     help="time the stem's part of a request instead")
    cli.add_argument("batches", nargs="*", type=int)
    opts = cli.parse_args(argv)
    root = pathlib.Path(opts.root or pathlib.Path(__file__).parents[2])
    sys.path.insert(0, str(root.resolve()))
    import torch
    from dlmc_quant_torch.device import resolve_device
    from dlmc_quant_torch.ops.cuda import int8_stem_pool as S
    from dlmc_quant_torch.utils.profiling import card_line
    modes = S.MODES if "mode" in inspect.signature(
        S.int8_stem_pool).parameters else ("int32",)
    batches = opts.batches or [8, 256]
    device = resolve_device(None)
    gen = torch.Generator(device=device).manual_seed(SEED)
    print(f"# stem_bands on {card_line()}; tree {root.resolve()}; torch "
          f"{torch.__version__}; times: per launch, median of {REPS} "
          f"replays of a CUDA graph of {LAUNCHES} back-to-back launches; * "
          "= band_rows' choice")
    rows = []
    for n in batches:
        rows += [split_ms(n, gen)] if opts.split else \
            batch_rows(n, gen, modes)
    if opts.json:
        pathlib.Path(opts.json).write_text(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
