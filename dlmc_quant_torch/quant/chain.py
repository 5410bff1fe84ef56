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
    H = clip(round(6·inv + qb), lo, hi)   if it has a ReLU6, else hi

A quantized layer in ``'intc'`` returns a :class:`DeferredEpilogue`;
:func:`qrelu` marks the pending ReLU and :func:`qrelu6` the ReLU6 (the
upper clamp at 6 folds into ``H``: rounding is monotone); the consumer,
the only layer that knows its input grid, turns it into int8 codes with
:func:`fold_quantize`.
:func:`materialize` closes the chain before non-quantized ops.

Residual blocks chain through :class:`QuantizedTensor`: the block's output
quantizer (``quant.layers.QBlockOutput``) folds trunk epilogue + shortcut +
ReLU + quantize into one clamp with :func:`fold_sum_quantize`, and emits
int8 codes on the block's own grid, which both consumers (the next block's
first conv and its shortcut) read as they are.

Unlike the JAX package, a conv's accumulator is not written to memory
where a consumer can take its epilogue: a 3×3 conv's (grouped or not)
:class:`DeferredEpilogue` holds a :class:`PendingConv`, a 1×1 conv's a
:class:`PendingGemm`, a wider window's (the ImageNet 7×7/s2 stem) a
:class:`PendingWideConv`, a depthwise 3×3 conv's (MobileNetV2, MobileOne)
a :class:`PendingDwConv`, and the consumer runs that conv with the folded
epilogue fused into it (``"codes"`` mode, with the residual term where it
closes a block), or, for :func:`materialize`, in ``"f32"`` mode.  A
pending GEMM used as a shortcut term runs in ``"int32"`` mode: the JAX
package's int32 accumulator.  The stem that :func:`qmaxpool` pools stays
pending too, as a :class:`PendingStemPool`: each consumer runs conv, pool
and its own epilogue in one kernel (``ops.cuda.int8_stem_pool``), so the
pooled int32 accumulator does not reach device memory either (unless a
ReLU-free shortcut term asks for it).  A linear-bottleneck block
(MobileNetV2) closes its sum without a ReLU: the lower clamp is then the
grid's minimum.

A layer whose weight grid has an offset (``q·s_w + o_w``: RootQ's, an
offset LSQ weight's) adds a row term to its real value,
``off_scale[o]·S[m]`` with ``off_scale = s_x·o_w`` and ``S`` the sum of
the input codes less the zero code over the window of output ``m``
(``ops.cuda.int8_window_sum``, one launch a layer; a depthwise conv's
kernel sums its own window).  :class:`DeferredEpilogue` carries it
as ``row = (S, off_scale)``, and every boundary folds it like the scale:
``C = off_scale·inv`` beside ``A`` and ``B``, added to the product in the
kernels' epilogue (``ops/cuda/epilogue.py``).  The ReLU's ``L`` and the
ReLU6's ``H`` stay valid: the term is part of the real value before them.
Two routes change: a shortcut GEMM with a row term runs in ``"f32"`` mode
and enters the residual sum as a float32 term (an int32 accumulator cannot
carry the term), and :func:`qmaxpool` on a stem with a row term pools the
float32 values of its ``int8_im2col`` rows through the GEMM (the term
varies by position, so pooling the accumulator is no longer monotone).

Each pending conv carries its kernel's weight layout as the layer's plan
packed it: int8, or at W4 (4-bit weights) the same layout nibble-packed,
two values a byte (``ops/cuda/nibbles.py``), whose ``uint8`` dtype says so
(:attr:`PendingConv.int4` and the like).  The kernel unpacks it in its
weight load; the plain version unpacks it with torch ops and runs its
float64 route.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from dlmc_quant_torch.ops.cuda.int8_conv import int8_conv3x3
from dlmc_quant_torch.ops.cuda.int8_dwconv import int8_dwconv3x3
from dlmc_quant_torch.ops.cuda.int8_gemm import int8_gemm
from dlmc_quant_torch.ops.cuda.int8_im2col import int8_im2col, out_hw
from dlmc_quant_torch.ops.cuda.int8_stem_pool import int8_stem_pool
from dlmc_quant_torch.ops.cuda.nibbles import W4


@dataclasses.dataclass(frozen=True)
class PendingConv:
    """A padded int8 3×3 conv that has not run yet."""
    x: torch.Tensor          # (N, H, W, C) int8 codes
    weight: torch.Tensor     # packed int8 (ops.cuda.int8_conv.pack_weight)
    #                          or uint8 nibbles (pack_weight_int4)
    stride: int
    pad: int                 # int8 code of real 0 on the input grid
    pad_lo: int = 1          # top/left pad: 0 for SAME at stride 2, even map
    groups: int = 1          # a grouped conv's (RepVGG's g2/g4), the weight
    #                          packed group by group

    @property
    def int4(self) -> bool:
        """Whether the weight is nibble-packed (W4)."""
        return self.weight.dtype == W4

    def run(self, a, b, *, lo: int = -128, hi: int = 127,
            mode: str = "codes", relu: bool = False, residual=None,
            qb: float = 0.0, row=None) -> torch.Tensor:
        return int8_conv3x3(self.x, self.weight, a, b, stride=self.stride,
                            pad=self.pad, pad_lo=self.pad_lo, lo=lo, hi=hi,
                            mode=mode, relu=relu, residual=residual, qb=qb,
                            row=row, groups=self.groups)


@dataclasses.dataclass(frozen=True)
class PendingGemm:
    """An int8 GEMM that has not run yet: a 1×1 conv on its (subsampled)
    codes, or a conv on its im2col rows; the output is (N, Ho, Wo, O)."""
    x: torch.Tensor          # (M, K) int8, M = N·Ho·Wo
    weight: torch.Tensor     # packed (O, Kp) int8 (ops.cuda.int8_gemm.pack_b)
    #                          or (O, Kp/2) uint8 nibbles (pack_b_int4)
    shape: tuple             # (N, Ho, Wo)

    int4 = PendingConv.int4

    def run(self, a=None, b=None, *, lo: int = -128, hi: int = 127,
            mode: str = "codes", relu: bool = False, residual=None,
            qb: float = 0.0, row=None) -> torch.Tensor:
        out = int8_gemm(self.x, self.weight, a, b, mode=mode, lo=lo, hi=hi,
                        relu=relu, residual=residual, qb=qb, row=row)
        return out.reshape(tuple(self.shape) + (-1,))


@dataclasses.dataclass(frozen=True)
class PendingWideConv:
    """A padded int8 conv with a window other than 1×1 and 3×3 (the
    ImageNet 7×7/s2 stem) that has not run yet.  :func:`qmaxpool` runs it
    with the 3×3/s2 pool after it in ``int8_stem_pool``; every other
    consumer runs it as ``int8_im2col`` rows through the int8 GEMM."""
    x: torch.Tensor          # (N, H, W, C) int8 codes
    weight: torch.Tensor     # packed (O, Kp) int8 (ops.cuda.int8_im2col)
    #                          or (O, Kp/2) uint8 nibbles
    pool_weight: Optional[torch.Tensor]  # ops.cuda.int8_stem_pool's layout
    #                          (nibble-packed with weight), None where that
    #                          kernel does not take the conv
    kernel: int
    stride: int
    pads: tuple              # ((top, bottom), (left, right))
    pad: int                 # int8 code of real 0 on the input grid

    int4 = PendingConv.int4

    def run(self, a=None, b=None, **epilogue) -> torch.Tensor:
        rows = int8_im2col(self.x, kernel=self.kernel, stride=self.stride,
                           pads=self.pads, pad=self.pad)
        n, h, w, _ = self.x.shape
        shape = (n,) + out_hw(h, w, self.kernel, self.stride, self.pads)
        return PendingGemm(rows, self.weight, shape).run(a, b, **epilogue)

    def pool(self) -> "PendingStemPool":
        """The conv with the 3×3/s2 max pool (pads 1) after it, pending."""
        if self.pool_weight is None:
            raise NotImplementedError(
                f"a {self.kernel}x{self.kernel}/s{self.stride} conv of "
                f"{tuple(self.x.shape)} codes is not pooled on the chain: "
                "int8_stem_pool takes the 7x7/s2 stem, C <= 4, O a "
                "multiple of 16 up to 128")
        return PendingStemPool(self.x, self.pool_weight, self.pads, self.pad)


@dataclasses.dataclass(frozen=True)
class PendingStemPool:
    """The ImageNet stem's 7×7/s2 conv and the 3×3/s2 max pool after it,
    not run yet: each consumer runs it in ``int8_stem_pool`` with its own
    epilogue (``"codes"``, ``"f32"``, or ``"int32"`` for the pooled
    accumulator), as many times as it has consumers."""
    x: torch.Tensor          # (N, H, W, C) int8 codes
    weight: torch.Tensor     # ops.cuda.int8_stem_pool's layout (pack_weight)
    #                          or its nibbles (pack_weight_int4)
    pads: tuple              # ((top, bottom), (left, right))
    pad: int                 # int8 code of real 0 on the input grid

    int4 = PendingConv.int4

    def run(self, a=None, b=None, *, lo: int = -128, hi: int = 127,
            mode: str = "codes", relu: bool = False, residual=None,
            qb: float = 0.0, row=None) -> torch.Tensor:
        if residual is not None or row is not None:
            raise ValueError("the pooled stem's epilogue takes no residual "
                             "and no row term")
        return int8_stem_pool(self.x, self.weight, a, b, pads=self.pads,
                              pad=self.pad, mode=mode, lo=lo, hi=hi,
                              relu=relu)


@dataclasses.dataclass(frozen=True)
class PendingDwConv:
    """A padded int8 depthwise 3×3 conv that has not run yet (no residual
    and no int32 mode: the kernel ends in the epilogue)."""
    x: torch.Tensor          # (N, H, W, C) int8 codes
    weight: torch.Tensor     # packed (9, C) int8 (ops.cuda.int8_dwconv)
    #                          or (9, C/2) uint8 nibbles (pack_weight_int4)
    stride: int
    pad: int                 # int8 code of real 0 on the input grid
    pad_lo: int = 1          # top/left pad: 0 for SAME at stride 2, even map

    int4 = PendingConv.int4

    def run(self, a, b, *, lo: int = -128, hi: int = 127,
            mode: str = "codes", relu: bool = False,
            row=None) -> torch.Tensor:
        """``row`` is ``(None, c)``: the kernel sums each channel's window
        itself."""
        offset = None
        if row is not None:
            if row[0] is not None:
                raise ValueError("a depthwise conv sums its own windows: "
                                 "its row term is (None, c) (ROADMAP item "
                                 "13)")
            offset = row[1]
        return int8_dwconv3x3(self.x, self.weight, a, b, stride=self.stride,
                              pad=self.pad, pad_lo=self.pad_lo, lo=lo, hi=hi,
                              mode=mode, relu=relu, offset=offset)


PENDING = (PendingConv, PendingGemm, PendingWideConv, PendingStemPool,
           PendingDwConv)
# the pool that follows the ImageNet stem: window, strides, padding
STEM_POOL = ((3, 3), (2, 2), ((1, 1), (1, 1)))


@dataclasses.dataclass(frozen=True)
class DeferredEpilogue:
    """Lazy layer output: real value = ``relu?(acc·scale + S·c + bias)``,
    then ``min(·, clamp_hi)`` where set (ReLU6).

    ``acc`` is an int32 tensor (dense layers) or a pending conv
    (:data:`PENDING`, the pooled stem too) whose accumulator the consumer
    computes with its epilogue fused.  ``row`` is a weight offset's row
    term ``(S, c)`` or None: ``S`` int32 over the output's rows ((N, Ho,
    Wo), or (M,) for an (M, O) ``acc``; None for a depthwise conv, whose
    kernel sums its own windows), ``c`` (O,) f32.
    """
    acc: Union[torch.Tensor, PendingConv, PendingGemm, PendingWideConv,
               PendingStemPool, PendingDwConv]
    scale: torch.Tensor      # (O,) f32
    bias: torch.Tensor       # (O,) f32
    relu: bool = False
    clamp_hi: Optional[float] = None
    row: Optional[tuple] = None


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


def qrelu6(x):
    """ReLU6 (``min(max(x, 0), 6)``) that stays lazy on the chain.

    On a :class:`DeferredEpilogue` the upper clamp folds into the
    consumer's quantize (:func:`fold_params`); on block-output codes it
    clamps at the zero code and at the grid code of 6, computed in float32
    as the JAX package does.
    """
    if isinstance(x, DeferredEpilogue):
        return dataclasses.replace(x, relu=True, clamp_hi=6.0)
    if isinstance(x, QuantizedTensor):
        hi = np.rint((np.float32(6.0) - np.float32(x.bias))
                     / np.float32(x.scale))
        hi = int(np.clip(hi, -128, 127))
        return dataclasses.replace(
            x, q=torch.clamp(x.q, x.zero_code(), hi))
    return torch.clamp(x, 0.0, 6.0)


def _max_pool(x: torch.Tensor, window, strides, padding) -> torch.Tensor:
    """NHWC max pool of a float32 tensor, pads losing to every element (as
    flax's -inf); ``padding`` is ``((p, p), (p, p))`` with p at most half
    the window (the ImageNet stem's pool: 3×3, p = 1)."""
    (top, bottom), (left, right) = padding
    if not (top == bottom == left == right and top <= min(window) // 2):
        raise NotImplementedError(f"max pool padding {padding}: only equal "
                                  "pads of at most half the window")
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, strides, padding=top)
    return y.permute(0, 2, 3, 1).contiguous()


def qmaxpool(x, window, strides, padding):
    """``nn.max_pool`` that stays lazy on the chain (JAX: ``chain.qmaxpool``).

    The epilogue is monotone per channel (scale > 0, ReLU and clamp
    monotone too), so pooling the int32 accumulator (or the int8 codes)
    and keeping the boundary foldable equals pooling the values; pads lose
    to every window element, as JAX's ``iinfo.min`` and -128 do.  A pending
    stem conv (:class:`PendingWideConv`) and the ImageNet pool after it
    (:data:`STEM_POOL`) stay pending as a :class:`PendingStemPool`: nothing
    runs here, and each consumer runs conv, pool and its epilogue in one
    ``int8_stem_pool`` launch.  A stem with a row term (a weight offset's)
    is not monotone in its accumulator: it runs as ``int8_im2col`` rows
    into the GEMM in ``"f32"`` mode, and its float32 values are pooled.
    Codes are pooled as an exact float32 view, as CUDA's max pool takes no
    integer type.
    """
    if isinstance(x, DeferredEpilogue):
        if not (isinstance(x.acc, PendingWideConv) and
                (tuple(window), tuple(strides),
                 tuple(map(tuple, padding))) == STEM_POOL):
            raise NotImplementedError(
                "qmaxpool pools a pending wide-window conv (the ImageNet "
                f"stem) with the {STEM_POOL} pool, got "
                f"{type(x.acc).__name__} and {(window, strides, padding)}")
        if x.row is not None:
            return _max_pool(materialize(x), window, strides, padding)
        return dataclasses.replace(x, acc=x.acc.pool())
    if isinstance(x, QuantizedTensor):
        q = _max_pool(x.q.to(torch.float32), window, strides, padding)
        return dataclasses.replace(x, q=q.to(torch.int8))
    return _max_pool(x, window, strides, padding)


def materialize(x):
    """Close a chain: f32 value of a deferred output or of codes (no-op on
    tensors)."""
    if isinstance(x, QuantizedTensor):
        y = x.q.to(torch.float32) * x.scale
        return y + x.bias
    if not isinstance(x, DeferredEpilogue):
        return x
    if isinstance(x.acc, PENDING):
        y = x.acc.run(x.scale, x.bias, mode="f32", relu=x.relu, row=x.row)
    else:
        y = _row_product(x.acc, x.scale, x.row)
        y = y + x.bias
        if x.relu:
            y = torch.clamp_min(y, 0.0)
    # min(., 6) is exact: it runs after the f32 epilogue
    return y if x.clamp_hi is None else torch.clamp_max(y, x.clamp_hi)


def _row_product(acc: torch.Tensor, scale, row) -> torch.Tensor:
    """``f32(acc)·scale``, and with a row term ``(S, c)`` ``+ f32(S)·c``,
    each step rounded: the kernels' epilogue on an int32 ``acc`` (M, O)."""
    y = acc.to(torch.float32) * scale
    if row is not None:
        sums, c = row
        y = y + sums.reshape(-1, 1).to(torch.float32) * c
    return y


def _folded_row(x: DeferredEpilogue, inv_s: float):
    """The row term on the consumer's grid, ``(S, c·inv)`` (``C`` of the
    module docstring, in float32 as ``A``), or None."""
    if x.row is None:
        return None
    sums, c = x.row
    return sums, c * inv_s


def fold_params(x: DeferredEpilogue, inv_s: float, qbias: float,
                qmin_s: int, qmax_s: int):
    """``(A, B, L, hi)`` of the folded boundary (see the module docstring).

    ``inv_s``/``qbias`` are the consumer plan's ``in_inv_scale`` /
    ``in_qbias`` as Python floats holding float32 values, so ``A`` and
    ``B`` are computed in float32 as in the JAX package, and ``L`` on the
    host (Python's ``round`` rounds half to even, as ``jnp.round`` does),
    and ``hi`` of a ReLU6 as ``round(6·inv + qbias)``, its product and sum
    in float32 as in the JAX package.
    """
    a = x.scale * inv_s
    b = x.bias * inv_s + qbias
    lo, hi = qmin_s, qmax_s
    if x.relu:
        lo = min(max(round(qbias), qmin_s), qmax_s)
    if x.clamp_hi is not None:
        top = np.float32(x.clamp_hi) * np.float32(inv_s) + np.float32(qbias)
        hi = int(np.clip(np.rint(top), qmin_s, qmax_s))
    return a, b, lo, hi


def fold_quantize(x: DeferredEpilogue, inv_s: float, qbias: float,
                  qmin_s: int, qmax_s: int) -> torch.Tensor:
    """Folded boundary: int8 codes of ``x`` on the consumer's grid."""
    a, b, lo, hi = fold_params(x, inv_s, qbias, qmin_s, qmax_s)
    row = _folded_row(x, inv_s)
    if isinstance(x.acc, PENDING):
        return x.acc.run(a, b, lo=lo, hi=hi, mode="codes", row=row)
    y = _row_product(x.acc, a, row)
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
            and r.clamp_hi is None and r.row is None \
            and not isinstance(r.acc, (PendingConv, PendingDwConv)):
        # the int32 accumulator (a pending shortcut GEMM runs for it)
        acc = r.acc.run(mode="int32") if isinstance(r.acc, PENDING) \
            else r.acc
        return (acc.contiguous(), (r.scale * inv_s).contiguous(),
                (r.bias * inv_s).contiguous())
    # a relu- or ReLU6-flagged term is nonlinear inside the sum, and a row
    # term has no int32 form: materialized first
    return materialize(r).contiguous(), full(inv_s), full(0.0)


def fold_sum_quantize(terms, inv_s: float, qbias: float, lo: int,
                      qmax_s: int) -> torch.Tensor:
    """Residual boundary: int8 codes of ``relu(y + r)`` on a grid.

    ``terms`` is ``[y, r]``: ``y`` the trunk, a conv's pending
    :class:`DeferredEpilogue` (a BasicBlock's 3×3 ``conv2``, a Bottleneck's
    1×1 ``conv3``); ``r`` the shortcut, a
    :class:`QuantizedTensor`, a :class:`DeferredEpilogue` or an f32 tensor.
    ``inv_s``/``qbias`` are the block-output plan's ``1/s`` and
    ``-o/s - shift``.  As in the JAX package the sum is taken term by
    term, each scaled onto the grid by its own affine,

        q = clip(round(((qbias + acc·A) + B) + r·Ar + Br), lo, qmax_s)

    (``A = scale·inv``, ``B = bias·inv`` per term; an int8 term's affine is
    its grid, an f32 term has ``Ar = inv`` and ``Br = 0``, and a
    relu-flagged term and one with a row term are materialized first; the
    trunk's own row term is added to its product, ``(qbias + (acc·A +
    S·C)) + B``).  The block's ReLU lives in
    ``lo``; a linear bottleneck (no ReLU) passes the grid's minimum.
    The whole sum runs in the epilogue of ``y``'s conv.
    """
    y, r = terms
    if not (isinstance(y, DeferredEpilogue) and isinstance(y.acc, PENDING)
            and not isinstance(y.acc, (PendingDwConv, PendingStemPool))
            and not y.relu
            and y.clamp_hi is None):
        raise ValueError("the residual sum is folded into the epilogue of "
                         "the trunk's last conv: y must be its pending, "
                         "ReLU-free output (a 3x3, 1x1 or wide conv)")
    o = y.acc.weight.shape[0]
    residual = _residual_operand(r, inv_s, o, y.scale.device)
    return y.acc.run(y.scale * inv_s, y.bias * inv_s, lo=lo, hi=qmax_s,
                     mode="codes", residual=residual, qb=qbias,
                     row=_folded_row(y, inv_s))
