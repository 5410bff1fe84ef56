"""Chained int8-resident deploy execution (``qmode='intc'``).

Counterpart of ``dlmc_quant_tpu/quant/chain.py``.
Every layer boundary of the plain ``'int'`` path runs

    y = acc·ps + pb                        (producer f32 epilogue, per-channel)
    y = max(y, 0)                          (model-level ReLU)
    q = clip(round(y·inv + qb), lo, hi)    (consumer act quantize)

and the chained path folds it into one affine and one clamp:

    q = clip(round(acc·A + B), L, hi)
    A = ps·inv        B = pb·inv + qb
    L = clip(round(qb), lo, hi)   if the boundary has a ReLU, else lo

A quantized layer in ``'intc'`` returns a :class:`DeferredEpilogue`;
:func:`qrelu` marks the pending ReLU; the consumer, the only layer that
knows its input grid, turns it into int8 codes with :func:`fold_quantize`.
:func:`materialize` closes the chain before non-quantized ops.

Residual blocks chain through :class:`QuantizedTensor`: the block's output
quantizer (``quant.layers.QBlockOutput``) folds trunk epilogue + shortcut +
ReLU + quantize into one clamp with :func:`fold_sum_quantize`, and emits
int8 codes on the block's own grid, which both consumers (the next block's
first conv and its shortcut) read as they are.

Unlike the JAX package, the accumulator of a 3×3 conv is never written to
memory: a conv's :class:`DeferredEpilogue` holds a :class:`PendingConv`,
and the consumer runs that conv with the folded epilogue fused into it
(``ops.cuda.int8_conv.int8_conv3x3`` in ``"codes"`` mode, with the
residual term where it closes a block), or, for :func:`materialize`, in
``"f32"`` mode.  ``qrelu6`` and ``qmaxpool`` are not ported yet (ROADMAP
Queue A, residual int8 chain (item 5)).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from dlmc_quant_torch.ops.cuda.int8_conv import int8_conv3x3


@dataclasses.dataclass(frozen=True)
class PendingConv:
    """A padded int8 3×3 conv that has not run yet."""
    x: torch.Tensor          # (N, H, W, C) int8 codes
    weight: torch.Tensor     # packed int8 (ops.cuda.int8_conv.pack_weight)
    stride: int
    pad: int                 # int8 code of real 0 on the input grid
    pad_lo: int = 1          # top/left pad: 0 for SAME at stride 2, even map

    def run(self, a, b, *, lo: int = -128, hi: int = 127,
            mode: str = "codes", relu: bool = False, residual=None,
            qb: float = 0.0) -> torch.Tensor:
        return int8_conv3x3(self.x, self.weight, a, b, stride=self.stride,
                            pad=self.pad, pad_lo=self.pad_lo, lo=lo, hi=hi,
                            mode=mode, relu=relu, residual=residual, qb=qb)


@dataclasses.dataclass(frozen=True)
class DeferredEpilogue:
    """Lazy layer output: real value = ``relu?(acc·scale + bias)``.

    ``acc`` is an int32 tensor (dense layers, 1×1 convs) or a :class:`PendingConv`
    whose accumulator the consumer computes with its epilogue fused.
    """
    acc: Union[torch.Tensor, PendingConv]
    scale: torch.Tensor      # (O,) f32
    bias: torch.Tensor       # (O,) f32
    relu: bool = False


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """int8 codes on a per-tensor affine grid: real ≈ ``q·scale + bias``.

    Produced at residual-block boundaries by ``QBlockOutput`` in
    ``qmode='intc'``; consumed as they are by quantized convs (an epilogue
    adapted to the grid) and by the residual epilogue.  ``scale`` and
    ``bias`` are Python floats holding float32 values, so that the pad
    code and the adapted epilogues need nothing from the card.
    """
    q: torch.Tensor          # int8 codes
    scale: float
    bias: float

    def zero_code(self) -> int:
        """int8 code whose real value is (closest to) 0: the pad code,
        computed in float32 as the JAX package does."""
        code = np.rint(-np.float32(self.bias) / np.float32(self.scale))
        return int(np.clip(code, -128, 127))


def qrelu(x):
    """ReLU that stays lazy on a :class:`DeferredEpilogue`; on block-output
    codes (already post-ReLU) it clamps at the zero code again."""
    if isinstance(x, DeferredEpilogue):
        return dataclasses.replace(x, relu=True)
    if isinstance(x, QuantizedTensor):
        return dataclasses.replace(x, q=torch.clamp_min(x.q, x.zero_code()))
    return torch.relu(x)


def materialize(x):
    """Close a chain: f32 value of a deferred output or of codes (no-op on
    tensors)."""
    if isinstance(x, QuantizedTensor):
        y = x.q.to(torch.float32) * x.scale
        return y + x.bias
    if not isinstance(x, DeferredEpilogue):
        return x
    if isinstance(x.acc, PendingConv):
        return x.acc.run(x.scale, x.bias, mode="f32", relu=x.relu)
    y = x.acc.to(torch.float32) * x.scale
    y = y + x.bias
    return torch.clamp_min(y, 0.0) if x.relu else y


def fold_params(x: DeferredEpilogue, inv_s: float, qbias: float,
                qmin_s: int, qmax_s: int):
    """``(A, B, L, hi)`` of the folded boundary (see the module docstring).

    ``inv_s``/``qbias`` are the consumer plan's ``in_inv_scale`` /
    ``in_qbias`` as Python floats holding float32 values, so ``A`` and
    ``B`` are computed in float32 as in the JAX package, and ``L`` on the
    host (Python's ``round`` rounds half to even, as ``jnp.round`` does).
    """
    a = x.scale * inv_s
    b = x.bias * inv_s + qbias
    lo = qmin_s
    if x.relu:
        lo = min(max(round(qbias), qmin_s), qmax_s)
    return a, b, lo, qmax_s


def fold_quantize(x: DeferredEpilogue, inv_s: float, qbias: float,
                  qmin_s: int, qmax_s: int) -> torch.Tensor:
    """Folded boundary: int8 codes of ``x`` on the consumer's grid."""
    a, b, lo, hi = fold_params(x, inv_s, qbias, qmin_s, qmax_s)
    if isinstance(x.acc, PendingConv):
        return x.acc.run(a, b, lo=lo, hi=hi, mode="codes")
    y = x.acc.to(torch.float32) * a
    y = y + b
    return torch.round(y).clamp_(lo, hi).to(torch.int8)


def _residual_operand(r, inv_s: float, o: int, device):
    """``(r, ar, br)`` of the residual epilogue for the shortcut term ``r``
    (fold_sum_quantize's rules per term kind)."""
    def full(v):
        return torch.full((o,), v, dtype=torch.float32, device=device)
    if isinstance(r, QuantizedTensor):
        inv = np.float32(inv_s)       # the products in float32, as JAX's
        return (r.q.contiguous(), full(float(np.float32(r.scale) * inv)),
                full(float(np.float32(r.bias) * inv)))
    if isinstance(r, DeferredEpilogue) and not r.relu \
            and not isinstance(r.acc, PendingConv):
        return (r.acc.contiguous(), (r.scale * inv_s).contiguous(),
                (r.bias * inv_s).contiguous())
    # a relu-flagged term is nonlinear inside the sum: materialized first
    return materialize(r).contiguous(), full(inv_s), full(0.0)


def fold_sum_quantize(terms, inv_s: float, qbias: float, lo: int,
                      qmax_s: int) -> torch.Tensor:
    """Residual boundary: int8 codes of ``relu(y + r)`` on a grid.

    ``terms`` is ``[y, r]``: ``y`` the trunk, a conv's pending
    :class:`DeferredEpilogue`; ``r`` the shortcut, a
    :class:`QuantizedTensor`, a :class:`DeferredEpilogue` or an f32 tensor.
    ``inv_s``/``qbias`` are the block-output plan's ``1/s`` and
    ``-o/s - shift``.  As in the JAX package the sum is taken term by
    term, each scaled onto the grid by its own affine,

        q = clip(round(((qbias + acc·A) + B) + r·Ar + Br), lo, qmax_s)

    (``A = scale·inv``, ``B = bias·inv`` per term; an int8 term's affine is
    its grid, an f32 term has ``Ar = inv`` and ``Br = 0``, and a
    relu-flagged term is materialized first).  The ReLU lives in ``lo``.
    The whole sum runs in the epilogue of ``y``'s conv.
    """
    y, r = terms
    if not (isinstance(y, DeferredEpilogue) and isinstance(y.acc, PendingConv)
            and not y.relu):
        raise ValueError("the residual sum is folded into the epilogue of "
                         "the trunk's 3x3 conv: y must be its pending, "
                         "ReLU-free output")
    o = y.acc.weight.shape[0]
    residual = _residual_operand(r, inv_s, o, y.scale.device)
    return y.acc.run(y.scale * inv_s, y.bias * inv_s, lo=lo, hi=qmax_s,
                     mode="codes", residual=residual, qb=qbias)
