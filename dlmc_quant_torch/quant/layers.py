"""Quantized layers: QConv and QDense, FSPTQ family.

Counterpart of ``dlmc_quant_tpu/quant/layers.py``.  Activations are NHWC
at the public interface, as in the JAX package; weights are held in
PyTorch's own layouts (OIHW for convs, (out, in) for dense), so the
per-channel weight axis is 0.

* A layer is quantized when the model's :class:`QuantScheme` resolves a
  config for its ``named_modules()`` path; :func:`attach_scheme` does that
  once the model is built and creates the quantizer parameters.
* FSPTQ quantizer state: ``in_scale`` (parameter), ``in_offset`` (buffer,
  the integer zero-point) and the streaming min/max ``in_stream_*``
  (buffers) for the input; ``wt_scale`` (per output channel) and, with
  AdaRound, ``alpha`` for the weight.
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

Not in this slice: the LSQ and RootQ families and ``QBlockOutput``
(ROADMAP Queue A items 10-11).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from dlmc_quant_torch.ops.cuda.int8_conv import pack_weight
from dlmc_quant_torch.ops.numerics import clip, round_pass
from dlmc_quant_torch.ops.observers import (StreamingState, get_qparams_tensor,
                                            minmax_tensor, streaming_finalize,
                                            streaming_init, streaming_update)
from dlmc_quant_torch.quant import deploy as dp
from dlmc_quant_torch.quant.chain import (DeferredEpilogue, PendingConv,
                                          fold_quantize, materialize)

QMODES = ("fp", "eval", "calibrate", "observe", "train", "int", "intc")

# AdaRound rectified-sigmoid constants (ref: FSPTQuant/base.py:62-63)
ADAROUND_GAMMA, ADAROUND_ZETA = -0.1, 1.1


def _bshape(stat, ndim: int):
    """Per-output-channel stat → broadcast shape against an O-first kernel."""
    return stat.reshape((-1,) + (1,) * (ndim - 1)) if stat.dim() else stat


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
        if family != "fsptq":
            raise NotImplementedError(
                f"{path}: the {family!r} estimator family is not ported yet "
                "(LSQ and RootQ: ROADMAP Queue A item 11)")
        dev = self.weight.device
        if self.cfg.input.enable:
            self.in_scale = nn.Parameter(torch.ones((), device=dev))
            self.register_buffer("in_offset", torch.zeros((), device=dev))
            for field, t in zip(StreamingState._fields,
                                streaming_init(device=dev)):
                self.register_buffer(f"in_stream_{field}", t)
        wq = self.cfg.weight
        if wq.enable:
            if wq.per_pixel:
                raise NotImplementedError(
                    f"{path}: per-pixel weight scales are not ported yet "
                    "(ROADMAP Queue A item 4)")
            shape = (self.weight.shape[0],) if wq.per_channel else ()
            self.wt_scale = nn.Parameter(torch.ones(shape, device=dev))
            if wq.recon_type == "adaround":
                self.alpha = nn.Parameter(torch.ones_like(self.weight))

    # --- FSPTQ fake quantization ------------------------------------------

    def _fsptq_input(self, x, aq, qmode: str):
        qmin, qmax = aq.qrange
        stream = StreamingState(*(getattr(self, f"in_stream_{field}")
                                  for field in StreamingState._fields))
        if qmode == "observe":
            for field, t in zip(StreamingState._fields,
                                streaming_update(stream, x.detach())):
                setattr(self, f"in_stream_{field}", t)
            return x
        if qmode == "calibrate":
            xd = x.detach()
            streamed = aq.type.startswith(("minmax", "percentile")) \
                and int(stream.count) > 0
            if streamed:
                s, off_f = streaming_finalize(stream, aq.type, aq.n_bits,
                                              aq.signed)
            elif aq.type.startswith("percentile"):
                raise NotImplementedError(
                    "percentile observers are not ported yet "
                    "(ROADMAP Queue A item 4)")
            elif aq.type.startswith("minmax"):
                s, off_f = minmax_tensor(xd, **aq.observer_kwargs)
            else:
                s, off_f = get_qparams_tensor(xd, aq.type,
                                              **aq.observer_kwargs)
                s, off_f = s.reshape(()), off_f.reshape(())
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
        x_q = (self._fsptq_input(x, self.cfg.input, qmode)
               if self.cfg.input.enable else x)
        if qmode == "observe":
            return x_q, self.weight    # FP forward while the stream fills
        w_q = (self._fsptq_weight(self.weight, self.cfg.weight, qmode)
               if self.cfg.weight.enable else self.weight)
        return x_q, w_q

    # --- integer execution -------------------------------------------------

    def _build_int_plan(self):
        """Integer plan: (tensors, host scalars).  See quant/deploy.py."""
        cfg = self.cfg
        wq, aq = cfg.weight, cfg.input
        if not wq.enable:
            raise ValueError(f"{self.path}: weight quantization disabled — "
                             "nothing to deploy")
        if wq.n_bits <= 4:
            raise NotImplementedError(
                f"{self.path}: int4 weights are not ported yet "
                "(ROADMAP Queue A item 13)")
        if not aq.enable:
            raise NotImplementedError(
                f"{self.path}: weight-only integer execution is not ported "
                "yet (ROADMAP Queue A item 7)")
        if aq.per_channel or aq.per_pixel:
            raise ValueError(f"{self.path}: integer path needs per-tensor "
                             "activation quantization")
        params = {"wt_scale": self.wt_scale.detach(),
                  "in_scale": self.in_scale.detach()}
        qstate = {"in_offset": self.in_offset}
        s_w, _ = dp.affine_from_quantizer("fsptq", wq, params, qstate,
                                          "weight")
        kernel = self.weight.detach()
        if wq.recon_type == "adaround" and hasattr(self, "alpha"):
            # learned rounding: floor + hard alpha decision
            # (ref: FSPTQuant/base.py:136-141 eval branch)
            q = torch.floor(kernel / _bshape(s_w, kernel.dim())) \
                + (self.alpha.detach() >= 0)
            w_int = torch.clamp(q, wq.qmin, wq.qmax).to(torch.int8)
        else:
            w_int = dp.quantize_weight_int(kernel, s_w, wq.qmin, wq.qmax)
        w_scale = s_w.to(torch.float32)

        s_x, o_x = dp.affine_from_quantizer("fsptq", aq, params, qstate,
                                            "input")
        aqmin, aqmax = aq.qrange
        shift = dp.act_shift(aqmax)
        colsum = w_int.to(torch.int32).sum(
            dim=tuple(range(1, w_int.dim()))).to(torch.float32)
        bias_eff = (shift * s_x + o_x) * w_scale * colsum
        if self.bias is not None:
            bias_eff = bias_eff + self.bias.detach()
        tensors = {"w_int": w_int, "w_scale": w_scale,
                   "epi_scale": (s_x * w_scale).to(torch.float32),
                   "bias_eff": bias_eff.to(torch.float32)}
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

    def _input_codes(self, x) -> torch.Tensor:
        """int8 codes of the input on this layer's grid: a folded boundary
        for a chained input, the single-FMA act quantize otherwise."""
        if self.plan_scalars is None:
            raise RuntimeError(f"{self.path}: run prepare_deploy() before "
                               "an integer qmode")
        h = self.plan_scalars
        aqmin, aqmax = self.cfg.input.qrange
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
    """Quantization-aware 2D convolution, NHWC activations, OIHW weight."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, groups: int = 1,
                 use_bias: bool = True, generator=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.groups = padding, groups
        self.weight = nn.Parameter(torch.empty(
            features, in_features // groups, kernel_size, kernel_size))
        _init_weight(self.weight.data, generator,
                     kernel_size * kernel_size * in_features // groups, 2.0)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def _conv(self, x, w):
        y = F.conv2d(x.permute(0, 3, 1, 2), w, self.bias, self.stride,
                     self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 1)

    def forward(self, x, qmode: str = "eval"):
        self._check_qmode(qmode)
        if qmode in ("int", "intc"):
            if self.cfg is None or not self.cfg.weight.enable:
                return self._conv(materialize(x), self.weight)
            de = self.deferred(self._input_codes(x))
            return de if qmode == "intc" else materialize(de)
        x_q, w_q = self._quantize(x, qmode)
        return self._conv(x_q, w_q)

    def deferred(self, x_i8: torch.Tensor) -> DeferredEpilogue:
        """This layer's output on input codes ``x_i8``, with the conv and
        its epilogue left to the consumer (see quant/chain.py)."""
        if (self.kernel_size, self.padding, self.groups) != (3, 1, 1):
            raise NotImplementedError(
                f"{self.path}: the integer path runs ungrouped 3x3 pad-1 "
                "convs only (grouped: ROADMAP Queue A item 12)")
        pending = PendingConv(x_i8.contiguous(), self.w_packed, self.stride,
                              self.plan_scalars["pad_val"])
        return DeferredEpilogue(pending, self.epi_scale, self.bias_eff)

    def prepare_deploy(self) -> None:
        super().prepare_deploy()
        # the kernel's own weight layout, packed once
        self.register_buffer(
            "w_packed", pack_weight(self.w_int.permute(2, 3, 1, 0)))


def _int8_matmul(x_i8: torch.Tensor, w_int: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 · (N, K)ᵀ int8 → (M, N) int32 with ``torch._int_mm``.

    On CUDA ``_int_mm`` wants M > 16, so small batches are padded with
    zero rows (K and N must be multiples of 8 there).
    """
    m, k = x_i8.shape
    if x_i8.is_cuda and (m <= 16 or m % 8):
        padded = x_i8.new_zeros((max(32, -(-m // 8) * 8), k))
        padded[:m] = x_i8
        return torch._int_mm(padded, w_int.t())[:m]
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
            acc = _int8_matmul(self._input_codes(x), self.w_int)
            de = DeferredEpilogue(acc, self.epi_scale, self.bias_eff)
            return de if qmode == "intc" else materialize(de)
        x_q, w_q = self._quantize(x, qmode)
        return F.linear(x_q, w_q, self.bias)


def attach_scheme(model: nn.Module, scheme) -> nn.Module:
    """Configure every quantized layer from its ``named_modules()`` path."""
    model.scheme = scheme
    for name, m in model.named_modules():
        if isinstance(m, QLayer):
            m.configure(name, scheme)
    return model


@contextlib.contextmanager
def full_f32():
    """Run f32 convs and matmuls in full f32.  On the card cuDNN runs f32
    convs in TF32 by default, which would move the calibrated scales."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def calibrate(model: nn.Module, batches, observe_passes: int = 0):
    """Explicit calibration: ``'observe'`` passes over the first
    ``observe_passes`` batches, then one ``'calibrate'`` pass on the first.

    Every quantized layer writes its observed scales (from the streamed
    min/max where there is one), zero-points and AdaRound ``alpha`` into its
    own parameters.  Returns ``model``.
    """
    batches = list(batches)
    with torch.no_grad(), full_f32():
        for b in batches[:observe_passes]:
            model(b, qmode="observe")
        model(batches[0], qmode="calibrate")
    return model
