"""Record the kernel launches of a chained int8 forward and hold each
against its plain version.

:class:`LaunchRecorder` wraps the kernel wrappers where the chain calls
them (the 3×3 conv, the GEMM, the im2col, the stem conv + pool and the
depthwise conv, 3×3 or 5×5, in ``quant/chain.py``, the window sums of a
weight offset's row term in ``quant/layers.py``), so one forward gives every
launch with its arguments and output; :func:`max_diff_to_plain` runs a
recorded launch's plain version on the same arguments.  ``chip_smoke.py`` and
``bench_torch.py`` check and time the launches of a request with these,
:func:`launch_bound` gives a recorded launch's bound and
:func:`launch_route` the route and tile a GEMM took.
"""

from __future__ import annotations

import torch

from dlmc_quant_torch.ops.cuda import int8_conv as _conv
from dlmc_quant_torch.ops.cuda import int8_dwconv as _dwconv
from dlmc_quant_torch.ops.cuda import int8_gemm as _gemm
from dlmc_quant_torch.ops.cuda import int8_im2col as _im2col
from dlmc_quant_torch.ops.cuda import int8_stem_pool as _stem
from dlmc_quant_torch.ops.cuda import int8_window_sum as _window
from dlmc_quant_torch.quant import chain as _chain
from dlmc_quant_torch.ops.cuda.nibbles import W4
from dlmc_quant_torch.quant import layers as _layers
from dlmc_quant_torch.utils.profiling import PEAK_BYTES, PEAK_INT8_OPS

# kind → (kernel wrapper, plain version)
KERNELS = {"conv": (_conv.int8_conv3x3, _conv.int8_conv3x3_plain),
           "gemm": (_gemm.int8_gemm, _gemm.int8_gemm_plain),
           "im2col": (_im2col.int8_im2col, _im2col.int8_im2col_plain),
           "stem_pool": (_stem.int8_stem_pool, _stem.int8_stem_pool_plain),
           "dwconv": (_dwconv.int8_dwconv3x3, _dwconv.int8_dwconv3x3_plain),
           "window_sum": (_window.int8_window_sum,
                          _window.int8_window_sum_plain)}
# where the port calls each wrapper: (module, attribute, kind)
_SITES = ((_chain, "int8_conv3x3", "conv"), (_chain, "int8_gemm", "gemm"),
          (_chain, "int8_im2col", "im2col"),
          (_chain, "int8_stem_pool", "stem_pool"),
          (_chain, "int8_dwconv3x3", "dwconv"),
          (_layers, "int8_window_sum", "window_sum"))


class LaunchRecorder:
    """``with LaunchRecorder() as rec: model(x, qmode="intc")`` records
    every kernel wrapper's call in ``rec.calls`` as (kind, args,
    keywords, output); each wrapper still counts its own launches.  With
    ``check=True`` it holds each call against its plain version as it runs
    and keeps only (kind, :func:`max_diff_to_plain`), so that a long run
    holds no tensors."""

    def __init__(self, check: bool = False):
        self.check = check

    def __enter__(self):
        self.calls = []
        self._saved = [getattr(mod, name) for mod, name, _ in _SITES]

        def record(kind, fn):
            def wrapped(*args, **kw):
                out = fn(*args, **kw)
                self.calls.append(
                    (kind, max_diff_to_plain(kind, args, kw, out))
                    if self.check else (kind, args, kw, out))
                return out
            return wrapped

        for (mod, name, kind), fn in zip(_SITES, self._saved):
            setattr(mod, name, record(kind, fn))
        return self

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(_SITES, self._saved):
            setattr(mod, name, fn)

    def counts(self):
        """Calls by kind."""
        kinds = [c[0] for c in self.calls]
        return {kind: kinds.count(kind) for kind in KERNELS}


def max_diff_to_plain(kind, args, kw, out) -> float:
    """Largest |difference| between a recorded output and the plain
    version's on the same arguments (integers compared exactly)."""
    plain = KERNELS[kind][1](*args, **kw)
    if out.is_floating_point():
        return float((out - plain).abs().max())
    return float((out.long() - plain.long()).abs().max())


def check_request(model, x, expect=None):
    """One chained forward of ``x``; every launch against its plain version.
    Returns the recorded calls; raises where a launch differs or, with
    ``expect`` ({kind: calls}), where the counts differ."""
    with torch.inference_mode():
        with LaunchRecorder() as rec:
            model(x, qmode="intc")
        if expect is not None and rec.counts() != expect:
            raise RuntimeError(f"a request made {rec.counts()} launches, "
                               f"expected {expect}")
        for i, (kind, args, kw, out) in enumerate(rec.calls):
            err = max_diff_to_plain(kind, args, kw, out)
            if err != 0:
                raise RuntimeError(f"launch {i} ({kind}) differs from its "
                                   f"plain version by {err}")
    return rec.calls


def launch_route(kind, args, kw) -> str:
    """The route and tile a recorded GEMM call took (``int8_gemm.route``,
    chosen on the host from the shapes and dtypes): "staged 128x128",
    "register 64x64"; "" for the other kinds."""
    if kind != "gemm":
        return ""
    x, w = args[:2]
    n, mode = w.shape[0], kw.get("mode", "int32")
    r = kw["residual"][0] if kw.get("residual") is not None else None
    tile = kw.get("tile") or _gemm.launch_tile(
        x.shape[0], n, mode, w.dtype == W4, r, _gemm.sm_count(x.device))
    way = _gemm.route(n, mode, tile, r)
    return f"{way} {tile[0]}x{tile[1]}"


def launch_bound(kind, args, kw, out):
    """(bound ms, ops ms, bytes ms) of one recorded launch: inputs read and
    the output written once (a residual, a row term's S and c and the
    epilogue's per-column affines read once too)."""
    nbytes = out.numel() * out.element_size()
    r = kw.get("residual")
    if r is not None:
        nbytes += r[0].numel() * r[0].element_size() + 8 * out.shape[-1]
    if kw.get("row") is not None:
        nbytes += 4 * (kw["row"][0].numel() + out.shape[-1])
    if kw.get("offset") is not None:
        nbytes += 4 * out.shape[-1]
    if kind == "im2col":
        return bound_of(0, args[0].numel() + nbytes)
    if kind == "window_sum":
        # adds, no int8 multiply-adds: bytes bound; the pixels the windows
        # touch read once (all of x, but a strided 1x1's subsample)
        x = args[0]
        k, st = kw.get("kernel", 1), kw.get("stride", 1)
        touched = x.numel() if k >= st else out.numel() * k * k * x.shape[-1]
        return bound_of(0, touched + nbytes)
    if kind == "dwconv":
        # k² multiply-adds an output value; x (a 1x1 window's: the pixels
        # it reads), the (k², C) weight (half the bytes at W4), a and b
        x, w = args[:2]
        read = x.numel() if w.shape[0] > 1 else out.numel()
        return bound_of(2 * w.shape[0] * out.numel(), read + w.numel()
                        + 8 * x.shape[-1] + nbytes)
    if kind == "stem_pool":
        # the conv's int8 operations (the pool's compares are not counted);
        # x, the packed weight, a and b of an epilogue mode, the output
        x, wp = args[:2]
        n, h, wd, c = x.shape
        hc, wc, _, _ = _stem.geometry(h, wd, kw["pads"])
        ops = 2 * n * hc * wc * wp.shape[1] * _stem.KERNEL ** 2 * c
        epi = 8 * wp.shape[1] if kw.get("mode", "int32") != "int32" else 0
        return bound_of(ops, x.numel() + wp.numel() + epi + nbytes)
    if kind == "gemm":
        x, w = args[:2]
        m, k = x.shape
        n = w.shape[0]
        epi = 8 * n if kw.get("mode", "int32") != "int32" else 0
        return bound_of(2 * m * n * k, m * k + weight_bytes(n * k, w) + epi
                        + nbytes)
    x, w, a, _ = args
    n, h, wd, c = x.shape
    o = a.shape[0]
    m = out.numel() // o
    cg = c // kw.get("groups", 1)      # the inputs of one output channel
    return bound_of(2 * m * o * 9 * cg, x.numel()
                    + weight_bytes(9 * cg * o, w) + 8 * o + nbytes)


def weight_bytes(values: int, w) -> int:
    """Bytes of a weight of ``values`` values: one a byte, two at W4."""
    return -(-values // 2) if w.dtype == W4 else values


def bound_of(ops: int, nbytes: int):
    t_ops = ops / PEAK_INT8_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes
