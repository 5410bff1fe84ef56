"""Quantized layers: QConv, QDense and QBlockOutput; FSPTQ, LSQ and RootQ
families.

Counterpart of ``dlmc_quant_tpu/quant/layers.py``.  Activations are NHWC
at the public interface, as in the JAX package; weights are held in
PyTorch's own layouts (OIHW for convs, (out, in) for dense), so the
per-channel weight axis is 0.

* A layer is quantized when the model's :class:`QuantScheme` resolves a
  config for its ``named_modules()`` path; :func:`attach_scheme` does that
  once the model is built and creates the quantizer parameters.
* Estimator families (``scheme.quantization_type``): ``'FSPTQ'``,
  ``'RootQ'`` and the plain/LSQ family (``None``, ``'LSQ'`` or any other).
* FSPTQ quantizer state: ``in_scale`` (parameter), ``in_offset`` (buffer,
  the integer zero-point) and the streaming min/max ``in_stream_*``
  (buffers) for the input; ``wt_scale`` (per output channel) and, with
  AdaRound, ``alpha`` for the weight.
* Plain/LSQ quantizer state: the same names, but ``in_offset`` is a float
  offset (the grid is ``q·in_scale + in_offset``), and the weight has a
  ``wt_offset`` buffer.  Observers: ``minmax_*`` and ``'LSQ'``
  (``2·mean|x|/√qmax``).  ``'train'`` learns ``in_scale`` and ``wt_scale``
  through :func:`~dlmc_quant_torch.ops.numerics.lsq_fake_quant`.
* RootQ quantizer state (``ops/rootq_math.py``): the learned activation
  scale ``in_scale`` and clip bounds ``wt_upper``/``wt_lower`` with the
  root exponent ``wt_alpha`` (parameters, all scalars), and their running
  values ``in_run_scale``, ``wt_run_upper``, ``wt_run_lower`` (buffers).
  ``'calibrate'`` sets both from one batch; ``'train'`` blends
  ``(1 − momentum)·running + momentum·parameter``, scales its gradient by
  ``1/√(numel·qmax)`` and writes the blend, detached, back into the
  buffer; ``'eval'`` reads the buffers only; ``'observe'`` is the
  identity.  Activations use the unsigned grid ``[0, qmax − qmin]``
  whatever ``signed`` says (ROADMAP hazard C4).
* :func:`calibrate` is the explicit calibration pass: optional ``'observe'``
  passes fold every batch's input min/max into the stream, then one
  ``'calibrate'`` pass on the first batch makes each layer observe its
  input (the stream where it has one) and weight, write the results into
  its own parameters (the JAX package's ``merge_calibration``) and
  quantize as it goes, so downstream layers calibrate against upstream
  quantization noise.
* ``qmode``: ``'fp'`` (no quantization), ``'eval'`` (fake quant with the
  calibrated parameters), ``'calibrate'``, ``'observe'`` (FP forward that
  feeds the stream), ``'train'`` (fake quant with AdaRound's soft rounding
  and straight-through gradients, for reconstruction), ``'int'`` and
  ``'intc'`` (real integer execution after ``quant.deploy.prepare_deploy``).
* A layer whose input quantizer is off runs weight-only in ``'int'`` and
  ``'intc'``: its int8 weights dequantized to bf16, a conv or matmul of
  bf16 operands with an f32 accumulator (a library call), f32 out; the next
  layer quantizes that output.
* Integer convs: 3×3 (``ops.cuda.int8_conv``, SAME or pad-1 geometry),
  1×1 (``ops.cuda.int8_gemm`` on the subsampled codes) and any other
  ungrouped square window, such as the ImageNet 7×7/s2 stem
  (``ops.cuda.int8_im2col`` rows into ``int8_gemm``, any pads); all take
  int8 codes on the layer's own grid or a :class:`QuantizedTensor` on a
  producer's, whose epilogue is re-derived from the stored column sums.
  Each leaves its conv pending for the consumer (``quant/chain.py``).
* :class:`QBlockOutput` closes a residual block: ``relu(y + r)`` in every
  qmode but ``'intc'``, where the sum, the ReLU and the quantize run in the
  epilogue of the block's last conv and give int8 codes.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from dlmc_quant_torch.ops.cuda.int8_conv import pack_weight
from dlmc_quant_torch.ops.cuda.int8_gemm import pack_b
from dlmc_quant_torch.ops.cuda.int8_im2col import int8_im2col, out_hw
from dlmc_quant_torch.ops.cuda.int8_im2col import \
    pack_weight as pack_rows_weight
from dlmc_quant_torch.ops import rootq_math as rq
from dlmc_quant_torch.ops.numerics import (clip, grad_scale, lsq_fake_quant,
                                           lsq_grad_factor, lsq_init_scale,
                                           round_pass)
from dlmc_quant_torch.ops.observers import (StreamingState, get_qparams_tensor,
                                            minmax_tensor, streaming_finalize,
                                            streaming_init, streaming_update)
from dlmc_quant_torch.quant import deploy as dp
from dlmc_quant_torch.quant.chain import (DeferredEpilogue, PendingConv,
                                          PendingGemm, QuantizedTensor,
                                          fold_quantize, fold_sum_quantize,
                                          materialize)

QMODES = ("fp", "eval", "calibrate", "observe", "train", "int", "intc")

# AdaRound rectified-sigmoid constants (ref: FSPTQuant/base.py:62-63)
ADAROUND_GAMMA, ADAROUND_ZETA = -0.1, 1.1

OBSERVERS_ITEM = "ROADMAP Queue A, observers left (item 9)"


def _bshape(stat, ndim: int):
    """Per-output-channel stat → broadcast shape against an O-first kernel."""
    return stat.reshape((-1,) + (1,) * (ndim - 1)) if stat.dim() else stat


def _bf16_values(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 and held in f32: a conv or matmul on such
    operands is XLA's bf16 op with ``preferred_element_type=f32`` (the
    products are exact in f32, and in the card's TF32 as well)."""
    return x.to(torch.bfloat16).float()


class QLayer(nn.Module):
    """Quantizer state and integer plan shared by :class:`QConv` and
    :class:`QDense`.  Subclasses own ``weight`` and ``bias``."""

    def __init__(self):
        super().__init__()
        self.path = ""
        self.cfg = None
        self.plan_scalars = None     # host floats of the integer plan

    def configure(self, path: str, scheme) -> None:
        """Resolve this layer's config and create its quantizer state."""
        self.path = path
        self.cfg = scheme.resolve(path) if scheme is not None else None
        if self.cfg is None:
            return
        family = (scheme.quantization_type or "LSQ").lower()
        self.family = family if family in ("fsptq", "rootq") else "lsq"
        dev = self.weight.device
        aq, wq = self.cfg.input, self.cfg.weight
        if self.family == "rootq":
            # scalar quantizers whatever the observer says (ref: RootQ/base.py)
            if aq.enable:
                self.in_scale = nn.Parameter(torch.ones((), device=dev))
                self.register_buffer("in_run_scale",
                                     torch.zeros((), device=dev))
            if wq.enable:
                self.wt_upper = nn.Parameter(torch.ones((), device=dev))
                self.wt_lower = nn.Parameter(-torch.ones((), device=dev))
                self.wt_alpha = nn.Parameter(torch.full((), 0.25,
                                                        device=dev))
                self.register_buffer("wt_run_upper",
                                     torch.ones((), device=dev))
                self.register_buffer("wt_run_lower",
                                     -torch.ones((), device=dev))
            return
        if self.family == "lsq":
            for role, q in (("input", aq), ("weight", wq)):
                if q.enable and not (q.type == "LSQ"
                                     or q.type.startswith("minmax")):
                    raise NotImplementedError(
                        f"{path}: the {role} observer {q.type!r} of the "
                        f"plain/LSQ family is not ported yet "
                        f"({OBSERVERS_ITEM})")
            if aq.enable and aq.per_channel:
                raise NotImplementedError(
                    f"{path}: per-channel activation scales are not ported "
                    f"yet ({OBSERVERS_ITEM})")
        if aq.enable:
            self.in_scale = nn.Parameter(torch.ones((), device=dev))
            self.register_buffer("in_offset", torch.zeros((), device=dev))
            for field, t in zip(StreamingState._fields,
                                streaming_init(device=dev)):
                self.register_buffer(f"in_stream_{field}", t)
        if wq.enable:
            if wq.per_pixel:
                raise NotImplementedError(
                    f"{path}: per-pixel weight scales are not ported yet "
                    f"({OBSERVERS_ITEM})")
            shape = (self.weight.shape[0],) if wq.per_channel else ()
            self.wt_scale = nn.Parameter(torch.ones(shape, device=dev))
            if self.family == "lsq":
                self.register_buffer("wt_offset",
                                     torch.zeros(shape, device=dev))
            elif wq.recon_type == "adaround":
                self.alpha = nn.Parameter(torch.ones_like(self.weight))

    # --- input observers -----------------------------------------------

    def _observe_stream(self, x) -> None:
        """``'observe'``: fold ``x``'s min/max into the input stream."""
        stream = StreamingState(*(getattr(self, f"in_stream_{field}")
                                  for field in StreamingState._fields))
        for field, t in zip(StreamingState._fields,
                            streaming_update(stream, x.detach())):
            setattr(self, f"in_stream_{field}", t)

    def _observe_input(self, xd, aq):
        """``(scale, offset)`` of a per-tensor input observer: from the
        stream where observe passes filled it, else from this batch."""
        stream = StreamingState(*(getattr(self, f"in_stream_{field}")
                                  for field in StreamingState._fields))
        if aq.type.startswith(("minmax", "percentile")) \
                and int(stream.count) > 0:
            return streaming_finalize(stream, aq.type, aq.n_bits, aq.signed)
        if aq.type.startswith("percentile"):
            raise NotImplementedError(
                f"percentile observers are not ported yet ({OBSERVERS_ITEM})")
        if aq.type.startswith("minmax"):
            return minmax_tensor(xd, **aq.observer_kwargs)
        s, off = get_qparams_tensor(xd, aq.type, **aq.observer_kwargs)
        return s.reshape(()), off.reshape(())

    # --- plain/LSQ fake quantization (ref: modules/base.py) --------------

    def _lsq_input(self, x, aq, qmode: str):
        qmin, qmax = aq.qrange
        if qmode == "observe":
            self._observe_stream(x)
            return x
        if qmode == "calibrate":
            xd = x.detach()
            if aq.type == "LSQ":
                s, off = lsq_init_scale(xd, qmax), torch.zeros_like(
                    self.in_offset)
            else:
                s, off = self._observe_input(xd, aq)
            self.in_scale.data.copy_(s)
            self.in_offset.copy_(off)
        return lsq_fake_quant(x, self.in_scale, self.in_offset, qmin, qmax,
                              lsq_grad_factor(x.numel(), qmax))

    def _lsq_weight(self, kernel, wq, qmode: str):
        qmin, qmax = wq.qrange
        if qmode == "calibrate":
            kd = kernel.detach()
            if wq.type == "LSQ":
                dims = tuple(range(1, kd.dim())) if wq.per_channel else None
                s, off = lsq_init_scale(kd, qmax, dims), None
            else:
                kw = wq.observer_kwargs
                if wq.per_channel:
                    kw["ch_axis"] = 0
                s, off = get_qparams_tensor(kd, wq.type, **kw)
            self.wt_scale.data.copy_(s.reshape(self.wt_scale.shape))
            if off is None:
                self.wt_offset.zero_()
            else:
                self.wt_offset.copy_(off.reshape(self.wt_offset.shape))
        return lsq_fake_quant(
            kernel, _bshape(self.wt_scale, kernel.dim()),
            _bshape(self.wt_offset, kernel.dim()), qmin, qmax,
            lsq_grad_factor(kernel.numel(), qmax))

    # --- RootQ fake quantization (ref: RootQ/base.py) ---------------------

    def _rootq_input(self, x, aq, qmode: str):
        qmin, qmax = aq.qrange
        if qmode == "observe":
            return x                 # RootQ initialises from one batch
        if qmode == "calibrate":
            xd = x.detach()
            running = (xd.max() - xd.min()) / float(qmax - qmin)
            self.in_scale.data.copy_(running)
            self.in_run_scale.copy_(running)
        elif qmode == "train":
            m = self.cfg.momentum
            running = grad_scale(
                (1.0 - m) * self.in_run_scale + m * self.in_scale,
                lsq_grad_factor(x.numel(), qmax))
            with torch.no_grad():
                self.in_run_scale.copy_(running)
        else:
            running = self.in_run_scale
        return rq.rootq_act_fake_quant(x, running, qmax, qmin)

    def _rootq_weight(self, kernel, wq, qmode: str):
        qmin, qmax = wq.qrange
        if qmode == "calibrate":
            wmax = 2.0 * kernel.detach().abs().mean() \
                * math.sqrt(float(max(qmax, 1)))
            upper, lower = wmax, -wmax
            for param, buf, v in ((self.wt_upper, self.wt_run_upper, upper),
                                  (self.wt_lower, self.wt_run_lower, lower)):
                param.data.copy_(v)
                buf.copy_(v)
        elif qmode == "train":
            m, g = self.cfg.momentum, lsq_grad_factor(kernel.numel(), qmax)
            upper = grad_scale((1.0 - m) * self.wt_run_upper
                               + m * self.wt_upper, g)
            lower = grad_scale((1.0 - m) * self.wt_run_lower
                               + m * self.wt_lower, g)
            with torch.no_grad():
                self.wt_run_upper.copy_(upper)
                self.wt_run_lower.copy_(lower)
        else:
            upper, lower = self.wt_run_upper, self.wt_run_lower
        return rq.rootq_weight_fake_quant(kernel, upper, lower, self.wt_alpha,
                                          qmin, qmax)

    # --- FSPTQ fake quantization ------------------------------------------

    def _fsptq_input(self, x, aq, qmode: str):
        qmin, qmax = aq.qrange
        if qmode == "observe":
            self._observe_stream(x)
            return x
        if qmode == "calibrate":
            s, off_f = self._observe_input(x.detach(), aq)
            # integer zero-point convention (dlmc_quant_tpu layers.py:316-319)
            zp = torch.clamp(torch.round(-off_f / s), qmin, qmax)
            self.in_scale.data.copy_(s)
            self.in_offset.copy_(zp)
        s, zp = self.in_scale, self.in_offset
        q = clip(round_pass(x / s) + zp, qmin, qmax)
        return (q - zp) * s

    def _fsptq_weight(self, kernel, wq, qmode: str):
        qmin, qmax = wq.qrange
        adaround = wq.recon_type == "adaround"
        if qmode == "calibrate":
            kw = wq.observer_kwargs
            if wq.per_channel:
                kw["ch_axis"] = 0
            s_b, _ = get_qparams_tensor(kernel.detach(), wq.type, **kw)
            s = s_b.reshape(self.wt_scale.shape) + 1e-6
            self.wt_scale.data.copy_(s)
            if adaround:
                # alpha so that the sigmoid recovers the fractional
                # remainder (ref: FSPTQuant/base.py:69-76)
                t = kernel.detach() / _bshape(s, kernel.dim())
                rest = t - torch.floor(t)
                a0 = -torch.log(
                    (ADAROUND_ZETA - ADAROUND_GAMMA)
                    / torch.clamp_min(rest - ADAROUND_GAMMA, 1e-6) - 1.0)
                self.alpha.data.copy_(a0)
        s_bc = _bshape(self.wt_scale, kernel.dim())
        if adaround:
            if qmode == "train":
                # AdaRound's soft target (ref: FSPTQuant/base.py:78-79)
                rounding = clip(torch.sigmoid(self.alpha)
                                * (ADAROUND_ZETA - ADAROUND_GAMMA)
                                + ADAROUND_GAMMA, 0.0, 1.0)
            else:
                rounding = (self.alpha >= 0).to(kernel.dtype)
            q = torch.floor(kernel / s_bc) + rounding
        else:
            q = round_pass(kernel / s_bc)
        return clip(q, qmin, qmax) * s_bc

    def _quantize(self, x, qmode: str):
        """(input, weight) after the resolved quantizers."""
        if self.cfg is None or qmode == "fp":
            return x, self.weight
        quant_input, quant_weight = {
            "lsq": (self._lsq_input, self._lsq_weight),
            "fsptq": (self._fsptq_input, self._fsptq_weight),
            "rootq": (self._rootq_input, self._rootq_weight)}[self.family]
        if self.cfg.input.enable:
            x = quant_input(x, self.cfg.input, qmode)
        if qmode == "observe" or not self.cfg.weight.enable:
            return x, self.weight    # FP weight while the stream fills
        return x, quant_weight(self.weight, self.cfg.weight, qmode)

    # --- integer execution -------------------------------------------------

    def _act_qrange(self):
        """Integer grid of the input quantizer: RootQ's is unsigned whatever
        ``signed`` says (ROADMAP hazard C4)."""
        aq = self.cfg.input
        if self.family == "rootq":
            return 0, aq.qmax - aq.qmin
        return aq.qrange

    def _build_int_plan(self):
        """Integer plan: (tensors, host scalars).  See quant/deploy.py.
        A weight-only layer's plan is its int8 weights and their scales,
        with no host scalars."""
        cfg = self.cfg
        wq, aq = cfg.weight, cfg.input
        if not wq.enable:
            raise ValueError(f"{self.path}: weight quantization disabled — "
                             "nothing to deploy")
        if wq.n_bits <= 4:
            raise NotImplementedError(
                f"{self.path}: int4 weights are not ported yet "
                "(ROADMAP Queue A, W4 execution (item 8))")
        if aq.enable and (aq.per_channel or aq.per_pixel):
            raise ValueError(f"{self.path}: integer path needs per-tensor "
                             "activation quantization")
        params = {name: getattr(self, name).detach()
                  for name in ("wt_scale", "in_scale") if hasattr(self, name)}
        qstate = {name: getattr(self, name)
                  for name in ("in_offset", "wt_offset", "in_run_scale",
                               "wt_run_upper", "wt_run_lower")
                  if hasattr(self, name)}
        s_w, o_w = dp.affine_from_quantizer(self.family, wq, params, qstate,
                                            "weight")
        if bool((o_w != 0).any()):
            # RootQ's grid after QAT, for one: the JAX package drops o_w
            raise NotImplementedError(
                f"{self.path}: a nonzero weight offset has no integer plan: "
                "it needs an o_w·Σx correction (ROADMAP hazard C1)")
        kernel = self.weight.detach()
        if wq.recon_type == "adaround" and hasattr(self, "alpha"):
            # learned rounding: floor + hard alpha decision
            # (ref: FSPTQuant/base.py:136-141 eval branch)
            q = torch.floor(kernel / _bshape(s_w, kernel.dim())) \
                + (self.alpha.detach() >= 0)
            w_int = torch.clamp(q, wq.qmin, wq.qmax).to(torch.int8)
        else:
            w_int = dp.quantize_weight_int(kernel, s_w, wq.qmin, wq.qmax)
        # one scale per output channel, per-tensor scales too: the kernels'
        # epilogues take (O,) vectors
        w_scale = s_w.to(torch.float32).expand(kernel.shape[0]).contiguous()
        if not aq.enable:
            return {"w_int": w_int, "w_scale": w_scale}, {}

        s_x, o_x = dp.affine_from_quantizer(self.family, aq, params, qstate,
                                            "input")
        aqmin, aqmax = self._act_qrange()
        shift = dp.act_shift(aqmax)
        colsum = w_int.to(torch.int32).sum(
            dim=tuple(range(1, w_int.dim()))).to(torch.float32)
        bias_eff = (shift * s_x + o_x) * w_scale * colsum
        bias0 = (self.bias.detach().to(torch.float32) if self.bias is not None
                 else torch.zeros_like(colsum))
        if self.bias is not None:
            bias_eff = bias_eff + self.bias.detach()
        # colsum and bias0 let a consumer re-derive its epilogue for codes on
        # a producer's grid (a QuantizedTensor input)
        tensors = {"w_int": w_int, "w_scale": w_scale,
                   "epi_scale": (s_x * w_scale).to(torch.float32),
                   "bias_eff": bias_eff.to(torch.float32),
                   "colsum": colsum, "bias0": bias0}
        scalars = {
            "in_scale": float(s_x),
            "in_inv_scale": float((1.0 / s_x).to(torch.float32)),
            "in_qbias": float((-o_x / s_x - shift).to(torch.float32)),
            "in_offset": float(o_x),
            "pad_val": int(dp.int8_pad_value(s_x, o_x, aqmin, aqmax)),
        }
        return tensors, scalars

    def prepare_deploy(self) -> None:
        """Build and store the integer plan (buffers + host scalars)."""
        tensors, self.plan_scalars = self._build_int_plan()
        for name, t in tensors.items():
            self.register_buffer(name, t)

    def _require_plan(self) -> None:
        if self.plan_scalars is None:
            raise RuntimeError(f"{self.path}: run prepare_deploy() before "
                               "an integer qmode")

    @property
    def weight_only(self) -> bool:
        return not self.cfg.input.enable

    def _dequantized_weight(self) -> torch.Tensor:
        """A weight-only layer's int8 weights as bf16 values."""
        self._require_plan()
        return self.w_int.to(torch.bfloat16) \
            * _bshape(self.w_scale, self.w_int.dim()).to(torch.bfloat16)

    def _int_input(self, x):
        """``(codes, epi_scale, bias_eff, pad)`` of an integer forward: a
        :class:`QuantizedTensor` goes in as it is, on its own grid (the
        epilogue re-derived from ``colsum`` and ``bias0``); anything else is
        quantized onto this layer's grid."""
        if isinstance(x, QuantizedTensor):
            bias_eff = x.bias * self.w_scale * self.colsum + self.bias0
            return x.q, x.scale * self.w_scale, bias_eff, x.zero_code()
        self._require_plan()
        return (self._input_codes(x), self.epi_scale, self.bias_eff,
                self.plan_scalars["pad_val"])

    def _input_codes(self, x) -> torch.Tensor:
        """int8 codes of the input on this layer's grid: a folded boundary
        for a chained input, the single-FMA act quantize otherwise."""
        self._require_plan()
        h = self.plan_scalars
        aqmin, aqmax = self._act_qrange()
        shift = dp.act_shift(aqmax)
        if isinstance(x, DeferredEpilogue):
            return fold_quantize(x, h["in_inv_scale"], h["in_qbias"],
                                 aqmin - shift, aqmax - shift)
        x_i8, _ = dp.act_to_int8(x, h["in_scale"], h["in_offset"], aqmin,
                                 aqmax, inv_s_x=h["in_inv_scale"],
                                 qbias=h["in_qbias"])
        return x_i8

    def _check_qmode(self, qmode: str) -> None:
        if qmode not in QMODES:
            raise NotImplementedError(
                f"qmode {qmode!r} is not ported (ported: {QMODES})")


def _init_weight(w, generator, fan_in: int, gain: float) -> None:
    """Truncated normal with variance gain/fan_in (flax's he_normal for
    gain 2, lecun_normal for gain 1)."""
    std = math.sqrt(gain / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class QConv(QLayer):
    """Quantization-aware 2D convolution, NHWC activations, OIHW weight.

    ``padding`` is a number of pixels on every side, or ``"SAME"``: flax's
    SAME, whose pads depend on the input size (a stride-2 3×3 conv on an
    even map pads 0 at the top and left and 1 at the bottom and right).
    """

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding=1, groups: int = 1,
                 use_bias: bool = True, generator=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.groups = padding, groups
        self.weight = nn.Parameter(torch.empty(
            features, in_features // groups, kernel_size, kernel_size))
        _init_weight(self.weight.data, generator,
                     kernel_size * kernel_size * in_features // groups, 2.0)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def spatial_pads(self, h: int, w: int):
        """``((top, bottom), (left, right))`` pads of an ``h``×``w`` input
        (dlmc_quant_tpu/quant/layers.py:639-651 for SAME)."""
        if self.padding != "SAME":
            return ((self.padding,) * 2,) * 2
        pads = []
        for size in (h, w):
            total = max((-(-size // self.stride) - 1) * self.stride
                        + self.kernel_size - size, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)

    def _conv(self, x, w, bias=True):
        (top, bottom), (left, right) = self.spatial_pads(x.shape[1],
                                                         x.shape[2])
        xc = x.permute(0, 3, 1, 2)
        pad = top
        if not top == bottom == left == right:
            xc, pad = F.pad(xc, (left, right, top, bottom)), 0
        y = F.conv2d(xc, w, self.bias if bias else None, self.stride, pad,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)

    def forward(self, x, qmode: str = "eval"):
        self._check_qmode(qmode)
        if qmode in ("int", "intc"):
            if self.cfg is None or not self.cfg.weight.enable:
                return self._conv(materialize(x), self.weight)
            if self.weight_only:
                # dlmc_quant_tpu/quant/layers.py:666-672: bf16 operands, an
                # f32 accumulator and output (bf16 products are exact in f32)
                y = self._conv(_bf16_values(materialize(x)),
                               self._dequantized_weight().float(), bias=False)
                return y if self.bias is None else y + self.bias
            de = self.deferred(*self._int_input(x))
            return de if qmode == "intc" else materialize(de)
        x_q, w_q = self._quantize(x, qmode)
        return self._conv(x_q, w_q)

    def deferred(self, x_i8: torch.Tensor, epi_scale=None, bias_eff=None,
                 pad=None) -> DeferredEpilogue:
        """This layer's output on input codes ``x_i8`` (on this layer's
        grid unless an epilogue and pad code are given), with the conv and
        its epilogue left to the consumer (see quant/chain.py): a 3×3 conv
        pending for the conv kernel, a 1×1 conv for the int8 GEMM on the
        subsampled codes, any other window for the GEMM on its im2col rows
        (built here, with the pad code at the borders)."""
        if epi_scale is None:
            epi_scale, bias_eff = self.epi_scale, self.bias_eff
            pad = self.plan_scalars["pad_val"]
        if self.groups != 1:
            raise NotImplementedError(
                f"{self.path}: grouped convs have no integer path yet "
                "(ROADMAP Queue A, rest of the zoo (item 7))")
        n, h, w, _ = x_i8.shape
        pads = self.spatial_pads(h, w)
        (top, bottom), (left, right) = pads
        s, k = self.stride, self.kernel_size
        if k == 1:
            if top or bottom or left or right:
                raise NotImplementedError(
                    f"{self.path}: a padded 1x1 conv has no integer path")
            codes = x_i8[:, ::s, ::s, :].contiguous()
            pending = PendingGemm(codes.reshape(-1, codes.shape[-1]),
                                  self.w_gemm, tuple(codes.shape[:3]))
            return DeferredEpilogue(pending, epi_scale, bias_eff)
        if k != 3:
            rows = int8_im2col(x_i8.contiguous(), kernel=k, stride=s,
                               pads=pads, pad=pad)
            pending = PendingGemm(rows, self.w_gemm,
                                  (n,) + out_hw(h, w, k, s, pads))
            return DeferredEpilogue(pending, epi_scale, bias_eff)
        # the kernel pads `top` rows above (0 or 1) and what the window
        # needs below, and gives ceil(h / s) rows: that must be this conv
        if not (top == left and top in (0, 1) and (s == 2 or top == 1)
                and (h + top + bottom - 3) // s + 1 == -(-h // s)
                and (w + left + right - 3) // s + 1 == -(-w // s)):
            raise NotImplementedError(
                f"{self.path}: pads {pads} at stride {s} have no integer "
                "path")
        pending = PendingConv(x_i8.contiguous(), self.w_packed, s, pad, top)
        return DeferredEpilogue(pending, epi_scale, bias_eff)

    def prepare_deploy(self) -> None:
        super().prepare_deploy()
        if self.weight_only:
            return
        # the kernels' own weight layouts, packed once
        w_hwio = self.w_int.permute(2, 3, 1, 0)
        if self.kernel_size == 3:
            self.register_buffer("w_packed", pack_weight(w_hwio))
        elif self.kernel_size == 1:
            self.register_buffer("w_gemm", pack_b(w_hwio[0, 0]))
        else:
            self.register_buffer("w_gemm", pack_rows_weight(w_hwio))


def _int8_matmul(x_i8: torch.Tensor, w_int: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 · (N, K)ᵀ int8 → (M, N) int32 with ``torch._int_mm``.

    On CUDA ``_int_mm`` wants M > 16 and M and N multiples of 8: small or
    ragged batches are padded with zero rows, and a head whose N is not a
    multiple of 8 (CIFAR's 10 classes) with zero weight rows (K must be a
    multiple of 8 there).
    """
    m, k = x_i8.shape
    n = w_int.shape[0]
    if x_i8.is_cuda and (m <= 16 or m % 8 or n % 8):
        padded = x_i8.new_zeros((max(32, -(-m // 8) * 8), k))
        padded[:m] = x_i8
        w_pad = w_int.new_zeros((-(-n // 8) * 8, k))
        w_pad[:n] = w_int
        return torch._int_mm(padded, w_pad.t())[:m, :n]
    return torch._int_mm(x_i8, w_int.t())


class QDense(QLayer):
    """Quantization-aware dense layer, weight (out, in)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        _init_weight(self.weight.data, generator, in_features, 1.0)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x, qmode: str = "eval"):
        self._check_qmode(qmode)
        if qmode in ("int", "intc"):
            if self.cfg is None or not self.cfg.weight.enable:
                return F.linear(materialize(x), self.weight, self.bias)
            if self.weight_only:
                # dlmc_quant_tpu/quant/layers.py:787-791, as the conv's
                y = F.linear(_bf16_values(materialize(x)),
                             self._dequantized_weight().float())
                return y if self.bias is None else y + self.bias
            x_i8, epi_scale, bias_eff, _ = self._int_input(x)
            acc = _int8_matmul(x_i8, self.w_int)
            de = DeferredEpilogue(acc, epi_scale, bias_eff)
            return de if qmode == "intc" else materialize(de)
        x_q, w_q = self._quantize(x, qmode)
        return F.linear(x_q, w_q, self.bias)


class QBlockOutput(nn.Module):
    """Residual-block output quantizer: ``relu(trunk + shortcut)`` → int8.

    Counterpart of ``dlmc_quant_tpu/quant/layers.py:819-906`` (the
    ReLU-closed blocks; ``relu=False``, for MobileNetV2's linear
    bottlenecks, comes with it: ROADMAP Queue A, rest of the zoo (item 7)).
    In every qmode but ``'intc'`` this is ``relu(y + r)``.  ``'calibrate'`` observes the f32 block output with the
    scheme's input observer (one batch, minmax) into ``out_scale``
    (parameter) and ``out_offset`` (buffer, a float offset: the grid is
    ``q·out_scale + out_offset``).  :meth:`prepare_deploy` freezes the grid
    into host scalars, and ``'intc'`` then folds trunk epilogue + shortcut
    + ReLU + quantize into the epilogue of the trunk's last conv
    (:func:`~dlmc_quant_torch.quant.chain.fold_sum_quantize`) and returns a
    :class:`~dlmc_quant_torch.quant.chain.QuantizedTensor`.
    """

    def __init__(self):
        super().__init__()
        self.path = ""
        self.cfg = None
        self.plan_scalars = None

    def configure(self, path: str, scheme, device=None) -> None:
        self.path = path
        cfg = scheme.resolve(path) if scheme is not None else None
        aq = cfg.input if cfg is not None else None
        if aq is None or not aq.enable or aq.per_channel or aq.per_pixel:
            self.cfg = None
            return
        if aq.type.startswith("percentile"):
            raise NotImplementedError(
                f"{path}: percentile observers are not ported yet "
                f"({OBSERVERS_ITEM})")
        self.cfg = cfg
        self.out_scale = nn.Parameter(torch.ones((), device=device))
        self.register_buffer("out_offset", torch.zeros((), device=device))

    def _sum(self, y, r):
        return torch.relu(materialize(y) + materialize(r))

    def forward(self, y, r, qmode: str = "eval"):
        if self.cfg is None:
            return self._sum(y, r)
        if qmode == "calibrate":
            v = self._sum(y, r)
            s, off = minmax_tensor(v.detach(),
                                   **self.cfg.input.observer_kwargs)
            self.out_scale.data.copy_(s)
            self.out_offset.copy_(off)
            return v
        if qmode == "intc" and self.plan_scalars is not None:
            h = self.plan_scalars
            q = fold_sum_quantize([y, r], h["bq_inv"], h["bq_qbias"],
                                  h["bq_lo"], h["bq_hi"])
            return QuantizedTensor(q, h["bq_scale"], h["bq_bias"])
        return self._sum(y, r)

    def prepare_deploy(self) -> None:
        """The block's grid as host scalars (float32 values)."""
        s_x, o_x = self.out_scale.detach(), self.out_offset
        qmin, qmax = self.cfg.input.qrange
        shift = dp.act_shift(qmax)
        # the ReLU as the lower bound: the code of real 0
        lo = int(torch.clamp(torch.round(-o_x / s_x), qmin, qmax)) - shift
        self.plan_scalars = {
            "bq_inv": float(1.0 / s_x), "bq_qbias": float(-o_x / s_x - shift),
            "bq_lo": lo, "bq_hi": qmax - shift, "bq_scale": float(s_x),
            "bq_bias": float(shift * s_x + o_x)}


def attach_scheme(model: nn.Module, scheme) -> nn.Module:
    """Configure every quantized layer and block output from its
    ``named_modules()`` path."""
    model.scheme = scheme
    device = next(model.parameters()).device
    for name, m in model.named_modules():
        if isinstance(m, QLayer):
            m.configure(name, scheme)
        elif isinstance(m, QBlockOutput):
            m.configure(name, scheme, device)
    return model


@contextlib.contextmanager
def full_f32():
    """Run f32 convs and matmuls in full f32, reproducibly.  On the card
    cuDNN runs f32 convs in TF32 by default, which would move the
    calibrated scales, and may pick algorithms whose sums (the convs'
    weight gradients) change from run to run: two runs of the flagship
    entry reconstructed different blocks (ROADMAP C12)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


def calibrate(model: nn.Module, batches, observe_passes: int = 0):
    """Explicit calibration: ``'observe'`` passes over the first
    ``observe_passes`` batches, then one ``'calibrate'`` pass on the first.

    Every quantized layer writes its observed scales (from the streamed
    min/max where there is one), zero-points, AdaRound ``alpha`` and RootQ
    running values into its own parameters and buffers.  The passes run in
    eval mode (BatchNorm on its running statistics, as the JAX package's
    ``train=False``); each module's mode is restored after.  Returns
    ``model``.
    """
    batches = list(batches)
    modes = {m: m.training for m in model.modules()}
    model.eval()
    try:
        with torch.no_grad(), full_f32():
            for b in batches[:observe_passes]:
                model(b, qmode="observe")
            model(batches[0], qmode="calibrate")
    finally:
        for m, mode in modes.items():
            m.training = mode
    return model
