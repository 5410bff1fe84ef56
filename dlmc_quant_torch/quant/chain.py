"""Chained int8-resident deploy execution (``qmode='intc'``).

Counterpart of ``dlmc_quant_tpu/quant/chain.py`` for sequential stacks.
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

Unlike the JAX package, the accumulator of a 3×3 conv is never written to
memory: a conv's :class:`DeferredEpilogue` holds a :class:`PendingConv`,
and the consumer runs that conv with the folded epilogue fused into it
(``ops.cuda.int8_conv.int8_conv3x3`` in ``"codes"`` mode), or, for
:func:`materialize`, in ``"f32"`` mode.  ``QuantizedTensor``,
``fold_sum_quantize``, ``qrelu6`` and ``qmaxpool`` come with the residual
slice (ROADMAP Queue A item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from dlmc_quant_torch.ops.cuda.int8_conv import int8_conv3x3


@dataclasses.dataclass(frozen=True)
class PendingConv:
    """A padded int8 3×3 conv that has not run yet."""
    x: torch.Tensor          # (N, H, W, C) int8 codes
    weight: torch.Tensor     # packed int8 (ops.cuda.int8_conv.pack_weight)
    stride: int
    pad: int                 # int8 code of real 0 on the input grid

    def run(self, a, b, *, lo: int = -128, hi: int = 127,
            mode: str = "codes", relu: bool = False) -> torch.Tensor:
        return int8_conv3x3(self.x, self.weight, a, b, stride=self.stride,
                            pad=self.pad, lo=lo, hi=hi, mode=mode, relu=relu)


@dataclasses.dataclass(frozen=True)
class DeferredEpilogue:
    """Lazy layer output: real value = ``relu?(acc·scale + bias)``.

    ``acc`` is an int32 tensor (dense layers) or a :class:`PendingConv`
    whose accumulator the consumer computes with its epilogue fused.
    """
    acc: Union[torch.Tensor, PendingConv]
    scale: torch.Tensor      # (O,) f32
    bias: torch.Tensor       # (O,) f32
    relu: bool = False


def qrelu(x):
    """ReLU that stays lazy on a :class:`DeferredEpilogue`."""
    if isinstance(x, DeferredEpilogue):
        return dataclasses.replace(x, relu=True)
    return torch.relu(x)


def materialize(x):
    """Close a chain: f32 value of a deferred output (no-op on tensors)."""
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
