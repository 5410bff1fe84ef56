"""The requantize epilogue that the int8 conv and the int8 GEMM share.

Both kernels end an int32 accumulator ``acc`` the same way, per output
row ``m`` (an output pixel) and column ``o`` (an output channel).  First
the product, and with a row term ``(S, c)`` the weight offset's term
(a layer whose weight grid is ``q·s_w + o_w``: ``S[m]`` the sum of the
input codes over the window of ``m`` less the zero code, ``c[o] =
s_x·o_w[o]``, ``int8_window_sum``)::

    t = f32(acc)·a[o]                      then, with a row term,
    t = t + f32(S[m])·c[o]

and then by mode::

    "codes": out = clamp(rint(t + b[o]), lo, hi)                        → int8
    "f32":   out = t + b[o], then max(·, 0) if relu                     → f32
    "codes" with a residual (r, ar, br), a residual block's shortcut added
    term by term in the order of ``quant.chain.fold_sum_quantize``:
             out = clamp(rint((((qb + t) + b[o]) + f32(r)·ar[o]) + br[o]),
                             lo, hi)                                    → int8

``r`` is int8 codes, int32 accumulators or float32 values of the output's
shape; ``ar``, ``br`` and ``c`` are per column, ``S`` int32 per row, or
per row and group for a conv in G groups (column ``o`` reads group ``o //
Og``, ``Og = O/G``; the depthwise conv's kernel sums its own window per
row and channel).  The
kernels write each step as one rounded float32 op (no fused multiply-add:
the row term is a product rounded, then a sum rounded) and round half to
even, so :func:`epilogue_plain`, their plain version, equals them bit for
bit.
"""

from __future__ import annotations

import torch

MODES = ("codes", "f32")
# residual dtypes, by the kernels' r_kind (0: no residual)
RESIDUAL_KINDS = {torch.int8: 1, torch.int32: 2, torch.float32: 3}


def check_epilogue(what: str, mode: str, a, b, lo, hi, relu, residual, qb,
                   out_shape, device, row=None, groups: int = 1) -> None:
    """Raise unless the epilogue's arguments fit an output of
    ``out_shape`` (last axis: the columns) on ``device``; ``row`` is
    ``(S, c)`` with ``S`` int32 of ``out_shape[:-1]`` (in ``groups`` > 1
    groups ``out_shape[:-1] + (groups,)``) or None."""
    if mode not in MODES:
        raise ValueError(f"{what}: mode must be one of {MODES}, got {mode!r}")
    if mode == "codes" and relu:
        raise ValueError(f"{what}: codes mode folds the ReLU into lo; relu "
                         "is for f32")
    for name, v in (("lo", lo), ("hi", hi)):
        if not isinstance(v, int) or not -128 <= v <= 127:
            raise ValueError(f"{what}: {name} must be an int8 code, got "
                             f"{v!r}")
    o = out_shape[-1]
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
                or tuple(t.shape) != (o,):
            raise ValueError(f"{what}: {name} must be ({o},) float32")
    if residual is None:
        tensors = (("a", a), ("b", b))
    else:
        if mode != "codes":
            raise ValueError(f"{what}: a residual is added in codes mode "
                             "only")
        if not isinstance(qb, float):
            raise ValueError(f"{what}: qb must be a float, got {qb!r}")
        r, ar, br = residual
        if r.dtype not in RESIDUAL_KINDS or tuple(r.shape) != tuple(
                out_shape):
            raise ValueError(f"{what}: the residual must be "
                             f"{tuple(out_shape)} int8, int32 or float32, "
                             f"got {tuple(r.shape)} {r.dtype}")
        for name, t in (("ar", ar), ("br", br)):
            if t.dtype != torch.float32 or tuple(t.shape) != (o,):
                raise ValueError(f"{what}: {name} must be ({o},) float32")
        tensors = (("a", a), ("b", b), ("r", r), ("ar", ar), ("br", br))
    if row is not None:
        sums, c = row
        want = tuple(out_shape[:-1]) + ((groups,) if groups > 1 else ())
        if not isinstance(sums, torch.Tensor) or sums.dtype != torch.int32 \
                or tuple(sums.shape) != want:
            raise ValueError(f"{what}: the row term's S must be {want} "
                             "int32")
        if not isinstance(c, torch.Tensor) or c.dtype != torch.float32 \
                or tuple(c.shape) != (o,):
            raise ValueError(f"{what}: the row term's c must be ({o},) "
                             "float32")
        tensors += (("S", sums), ("c", c))
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on "
                             f"{device}")


def expand_groups(s: torch.Tensor, o: int) -> torch.Tensor:
    """Row sums ``s`` (…, G) as (…, O): column ``o`` reads group ``o //
    (O/G)``; (…, 1) and (…, O) as they are."""
    g = s.shape[-1]
    return s if g in (1, o) else s.repeat_interleave(o // g, dim=-1)


def epilogue_plain(acc: torch.Tensor, a, b, *, mode: str, lo: int = -128,
                   hi: int = 127, relu: bool = False, residual=None,
                   qb: float = 0.0, row=None) -> torch.Tensor:
    """Plain PyTorch version of the kernels' epilogue (module docstring).

    ``acc`` holds exact integers (int32, or float64 from an exact float64
    sum); its float32 value rounds to nearest even as ``__int2float_rn``
    does.  ``row`` is ``(S, c)``: ``S`` exact integers of ``acc``'s shape
    less the last axis (one a row), with a last axis of G (one a row and
    group, column ``o`` reading group ``o // (O/G)``), or of ``acc``'s
    shape (the depthwise conv's, one a value).  Every step is a separate
    float32 op, so nothing fuses them into an fma.
    """
    y = acc.to(torch.float32) * a
    if row is not None:
        sums, c = row
        s = sums.to(torch.float32)
        if s.dim() < y.dim():
            s = s.unsqueeze(-1)
        y = y + expand_groups(s, y.shape[-1]) * c
    if residual is not None:
        r, ar, br = residual
        y = y + qb
        y = y + b
        y = y + r.to(torch.float32) * ar
        y = y + br
    else:
        y = y + b
    if mode == "codes":
        return torch.round(y).clamp_(lo, hi).to(torch.int8).contiguous()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.contiguous()
