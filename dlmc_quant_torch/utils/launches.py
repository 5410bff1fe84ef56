"""Record the kernel launches of a chained int8 forward and hold each
against its plain version.

:class:`LaunchRecorder` wraps the kernel wrappers where the chain calls
them (the 3×3 conv, the GEMM, the im2col, the stem conv + pool and the
depthwise conv, 3×3 or 5×5, in ``quant/chain.py``, the window sums of a
weight offset's row term in ``quant/layers.py``), so one forward gives every
launch with its arguments and output; :func:`max_diff_to_plain` runs a
recorded launch's plain version on the same arguments.  ``chip_smoke.py`` and
``bench_torch.py`` check and time the launches of a request with these.
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
from dlmc_quant_torch.quant import layers as _layers

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
