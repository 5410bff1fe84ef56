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
  the integer zero-point) and the streaming statistics ``in_stream_*``
  (buffers: min, max, the sum of per-batch percentiles, the count) for
  the input; ``wt_scale`` and, with AdaRound, ``alpha`` for the weight.
* Plain/LSQ quantizer state: the same names, but ``in_offset`` is a float
  offset (the grid is ``q·in_scale + in_offset``), and the weight has a
  ``wt_offset`` buffer.  ``'train'`` learns ``in_scale`` and ``wt_scale``
  through :func:`~dlmc_quant_torch.ops.numerics.lsq_fake_quant`.  A
  per-channel input observer gives ``in_scale``/``in_offset`` and the
  stream one value per channel of the NHWC last axis.
* Observers (``ops/observers.py``): every name of the JAX package, on
  input and weight, in both families, and ``'LSQ'`` (``2·mean|x|/√qmax``)
  in the plain one.  Weight scales are per tensor, per output channel
  (``(O,)``) or per pixel (``(H, W)``, broadcast as ``(1, 1, H, W)``
  against the OIHW kernel); an output observer (``*output*``) drives the
  layer's own op, :meth:`QConv.forward_oi` / :meth:`QDense.forward_oi`,
  on the quantized input.  ``minmax*`` and ``percentile*`` inputs read the
  stream where observe passes filled it, else one batch.
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
* The gradient scales of the input quantizers (LSQ's and RootQ's
  ``1/√(numel·qmax)``) count the global batch's elements inside
  ``parallel.mesh.data_parallel``, as JAX does on the sharded batch.
* :func:`calibrate` is the explicit calibration pass: optional ``'observe'``
  passes fold every batch's input statistics into the stream, then one
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
* A weight of 4 bits or fewer (W4) stays nibble-packed and no int8 copy of
  it stays in the plan: a conv keeps only its kernel's layout, packed two
  values a byte along K, which the kernel unpacks in its weight load; a
  dense layer and a weight-only layer keep ``w_int4``
  (``quant.deploy.pack_int4``, the JAX package's layout), unpacked at
  forward time, the dense layer's product then ``torch._int_mm``.
* A layer whose input quantizer is off runs weight-only in ``'int'`` and
  ``'intc'``: its int8 weights dequantized to bf16, a conv or matmul of
  bf16 operands with an f32 accumulator (a library call), f32 out; the next
  layer quantizes that output.
* Integer convs: 3×3 (``ops.cuda.int8_conv``, SAME or pad-1 geometry,
  grouped too: RepVGG's g2/g4 variants), 1×1 (``ops.cuda.int8_gemm`` on
  the subsampled codes, K padded to a multiple of 16; grouped, one int32
  GEMM a group on its channels, the epilogue in torch), depthwise 3×3
  (``groups`` = C in = C out;
  ``ops.cuda.int8_dwconv``, the 3×3 geometry) and any other ungrouped
  square window, such as the ImageNet 7×7/s2 stem
  (``ops.cuda.int8_stem_pool`` with the max pool after it, else
  ``ops.cuda.int8_im2col`` rows into ``int8_gemm``, any pads); all take
  int8 codes on the layer's own grid or a :class:`QuantizedTensor` on a
  producer's, whose epilogue is re-derived from the stored column sums.
  Each leaves its conv pending for the consumer (``quant/chain.py``),
  but for the grouped 1×1.  Other groupings (a depthwise 1×1: MobileOne's
  scale branch) have no integer path, and a grouped conv has none for a
  weight offset's row term (ROADMAP item 7b: its window sums are per
  group).
* A weight grid with an offset, ``q·s_w + o_w`` (RootQ's: ``o_w = l −
  qmin·s_w``; an LSQ ``wt_offset``, per channel), runs every integer
  route: the plan takes the codes from the quantizer's own ``'eval'``
  output, ``rint((w_fq − o_w)/s_w)`` (a RootQ weight's always, its
  offset zero or not), and keeps ``off_scale = s_x·o_w``
  (O,), and each integer forward adds the row term ``off_scale[o]·S[m]``,
  ``S`` the input codes less the zero code summed over the window of
  output ``m`` (one ``ops.cuda.int8_window_sum`` launch a layer; the
  depthwise kernel sums its own), in its kernel's
  epilogue (the dense head's in torch, after ``torch._int_mm``).  Where
  the zero code's real value is not exactly 0 (an LSQ input offset) its
  share over the whole window, ``o_w·K·real(z)``, goes into ``bias_eff``.
  RootQ's signed weight grid is symmetric (``[−(2^{b−1}−1), 2^{b−1}−1]``),
  so at calibration (``l = −u``) ``o_w`` is 0 up to float rounding; QAT
  moves ``u`` and ``l`` apart.  A RootQ weight exactly on a bin midpoint
  dequantizes to the midpoint, off the integer grid (ROADMAP hazard C20):
  the plan gives it the even one of the two neighbouring codes (round
  half to even) and ``prepare_deploy`` counts such weights
  (``midpoints``).  A weight-only layer dequantizes ``w_int·s_w + o_w``.
* :class:`QBlockOutput` closes a residual block: ``relu(y + r)`` (or
  ``y + r`` for a linear bottleneck) in every qmode but ``'intc'``, where
  the sum, the ReLU and the quantize run in the epilogue of the block's
  last conv and give int8 codes.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dlmc_quant_torch.ops.cuda import int8_conv as conv3x3
from dlmc_quant_torch.ops.cuda import int8_dwconv as dwconv
from dlmc_quant_torch.ops.cuda import int8_gemm as gemm
from dlmc_quant_torch.ops.cuda import int8_im2col as im2col
from dlmc_quant_torch.ops.cuda import int8_stem_pool as stem_pool
from dlmc_quant_torch.ops.cuda.int8_gemm import pad_k
from dlmc_quant_torch.ops.cuda.int8_window_sum import int8_window_sum
from dlmc_quant_torch.ops import rootq_math as rq
from dlmc_quant_torch.ops.numerics import (clip, grad_scale, lsq_fake_quant,
                                           lsq_grad_factor, lsq_init_scale,
                                           round_pass)
from dlmc_quant_torch.ops.observers import (DEFAULT_PCT, StreamingState,
                                            get_qparams_output,
                                            get_qparams_tensor,
                                            is_output_observer, minmax_tensor,
                                            percentile_tensor,
                                            streaming_finalize,
                                            streaming_init, streaming_update)
from dlmc_quant_torch.parallel.mesh import batch_numel
from dlmc_quant_torch.quant import deploy as dp
from dlmc_quant_torch.quant.chain import (DeferredEpilogue, PendingConv,
                                          PendingDwConv, PendingGemm,
                                          PendingWideConv,
                                          QuantizedTensor, fold_quantize,
                                          fold_sum_quantize, materialize)

QMODES = ("fp", "eval", "calibrate", "observe", "train", "int", "intc")

# AdaRound rectified-sigmoid constants (ref: FSPTQuant/base.py:62-63)
ADAROUND_GAMMA, ADAROUND_ZETA = -0.1, 1.1


def _bshape(stat, ndim: int):
    """A weight stat → its broadcast shape against an O-first kernel: a
    scalar as it is, a per-output-channel (O,) as (O, 1, ...), a per-pixel
    (H, W) as (1, 1, H, W)."""
    if stat.dim() == 2:
        return stat.reshape((1, 1) + tuple(stat.shape))
    return stat.reshape((-1,) + (1,) * (ndim - 1)) if stat.dim() else stat


def _batch_observe(x, aq, ch_axis):
    """``(scale, offset)`` of a ``minmax*`` or ``percentile*`` input
    observer from one batch: per channel along ``ch_axis`` where the
    observer is per-channel and an axis is given, else per tensor."""
    kw = aq.observer_kwargs
    if aq.per_channel and ch_axis is not None:
        return get_qparams_tensor(x, aq.type, ch_axis=ch_axis, **kw)
    if aq.type.startswith("percentile"):
        return percentile_tensor(x, **kw)
    return minmax_tensor(x, **kw)


def _bf16_values(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 and held in f32: a conv or matmul on such
    operands is XLA's bf16 op with ``preferred_element_type=f32`` (the
    products are exact in f32, and in the card's TF32 as well)."""
    return x.to(torch.bfloat16).float()


class QLayer(nn.Module):
    """Quantizer state and integer plan shared by :class:`QConv` and
    :class:`QDense`.  Subclasses own ``weight``, ``bias`` and
    ``forward_oi``."""

    groups = 1

    def __init__(self):
        super().__init__()
        self.path = ""
        self.cfg = None
        self.plan_scalars = None     # host floats of the integer plan
        self.midpoints = 0           # C20 weights (_fake_quant_codes)

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
        if aq.enable:
            # per channel of the NHWC last axis in the plain family only
            shape = (self.weight.shape[1] * self.groups,) \
                if self.family == "lsq" and aq.per_channel else ()
            self.in_scale = nn.Parameter(torch.ones(shape, device=dev))
            self.register_buffer("in_offset", torch.zeros(shape, device=dev))
            for field, t in zip(StreamingState._fields,
                                streaming_init(shape, device=dev)):
                self.register_buffer(f"in_stream_{field}", t)
        if wq.enable:
            if wq.per_channel:
                shape = (self.weight.shape[0],)
            elif wq.per_pixel:
                if self.weight.dim() != 4:
                    raise ValueError(f"{path}: per-pixel weight quantization "
                                     "needs a conv kernel")
                shape = tuple(self.weight.shape[2:])
            else:
                shape = ()
            self.wt_scale = nn.Parameter(torch.ones(shape, device=dev))
            if self.family == "lsq":
                self.register_buffer("wt_offset",
                                     torch.zeros(shape, device=dev))
            elif wq.recon_type == "adaround":
                self.alpha = nn.Parameter(torch.ones_like(self.weight))

    # --- observers ------------------------------------------------------

    def _stream(self) -> StreamingState:
        return StreamingState(*(getattr(self, f"in_stream_{field}")
                                for field in StreamingState._fields))

    def _observe_stream(self, x, aq, ch_axis) -> None:
        """``'observe'``: fold ``x`` into the input stream (per channel
        along ``ch_axis`` unless it is None), with the configured
        percentile for a ``percentile*`` observer (ROADMAP hazard C16: the
        JAX package's layers always stream 99.99)."""
        pct = aq.observer_kwargs.get("pct", DEFAULT_PCT) \
            if aq.type.startswith("percentile") else None
        for field, t in zip(StreamingState._fields, streaming_update(
                self._stream(), x.detach(), ch_axis, pct)):
            setattr(self, f"in_stream_{field}", t)

    def _observe_input(self, xd, aq, ch_axis=None):
        """``(scale, offset)`` of the input observer: a ``minmax*`` or
        ``percentile*`` one from the stream where observe passes filled
        it, else from this batch (per channel along ``ch_axis`` unless it
        is None); any other from this batch."""
        if aq.type.startswith(("minmax", "percentile")):
            stream = self._stream()
            if int(stream.count) > 0:
                return streaming_finalize(stream, aq.type, aq.n_bits,
                                          aq.signed)
            return _batch_observe(xd, aq, ch_axis)
        kw = aq.observer_kwargs
        if ch_axis is not None:
            kw["ch_axis"] = ch_axis
        return get_qparams_tensor(xd, aq.type, **kw)

    def _observe_weight(self, wq, x_q):
        """``(scale, offset)`` of the weight observer, broadcast-shaped
        against the O-first kernel; an output observer drives
        :meth:`forward_oi` on the quantized input ``x_q``."""
        kw = wq.observer_kwargs
        if wq.per_channel:
            kw["ch_axis"] = 0
        kd = self.weight.detach()
        if is_output_observer(wq.type):
            return get_qparams_output(x_q.detach(), kd, self.forward_oi,
                                      wq.type, **kw)
        return get_qparams_tensor(kd, wq.type, **kw)

    # --- plain/LSQ fake quantization (ref: modules/base.py) --------------

    def _lsq_input(self, x, aq, qmode: str):
        qmin, qmax = aq.qrange
        ch_axis = x.dim() - 1 if aq.per_channel else None
        if qmode == "observe":
            self._observe_stream(x, aq, ch_axis)
            return x
        if qmode == "calibrate":
            xd = x.detach()
            if aq.type == "LSQ":
                s, off = lsq_init_scale(xd, qmax), torch.zeros_like(
                    self.in_offset)
            else:
                s, off = self._observe_input(xd, aq, ch_axis)
            self.in_scale.data.copy_(s.reshape(self.in_scale.shape))
            self.in_offset.copy_(off.reshape(self.in_offset.shape))
        return lsq_fake_quant(x, self.in_scale, self.in_offset, qmin, qmax,
                              lsq_grad_factor(batch_numel(x), qmax))

    def _lsq_weight(self, kernel, wq, qmode: str, x_q):
        qmin, qmax = wq.qrange
        if qmode == "calibrate":
            kd = kernel.detach()
            if wq.type == "LSQ":
                dims = tuple(range(1, kd.dim())) if wq.per_channel else None
                s, off = lsq_init_scale(kd, qmax, dims), None
            else:
                s, off = self._observe_weight(wq, x_q)
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
                lsq_grad_factor(batch_numel(x), qmax))
            with torch.no_grad():
                self.in_run_scale.copy_(running)
        else:
            running = self.in_run_scale
        return rq.rootq_act_fake_quant(x, running, qmax, qmin)

    def _rootq_weight(self, kernel, wq, qmode: str, x_q=None):
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
            self._observe_stream(x, aq, None)
            return x
        if qmode == "calibrate":
            s, off_f = self._observe_input(x.detach(), aq)
            s, off_f = s.reshape(()), off_f.reshape(())
            # integer zero-point convention (dlmc_quant_tpu layers.py:316-319)
            zp = torch.clamp(torch.round(-off_f / s), qmin, qmax)
            self.in_scale.data.copy_(s)
            self.in_offset.copy_(zp)
        s, zp = self.in_scale, self.in_offset
        q = clip(round_pass(x / s) + zp, qmin, qmax)
        return (q - zp) * s

    def _fsptq_weight(self, kernel, wq, qmode: str, x_q):
        qmin, qmax = wq.qrange
        adaround = wq.recon_type == "adaround"
        if qmode == "calibrate":
            s_b, _ = self._observe_weight(wq, x_q)
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
        return x, quant_weight(self.weight, self.cfg.weight, qmode, x)

    # --- integer execution -------------------------------------------------

    def _act_qrange(self):
        """Integer grid of the input quantizer: RootQ's is unsigned whatever
        ``signed`` says (ROADMAP hazard C4)."""
        aq = self.cfg.input
        if self.family == "rootq":
            return 0, aq.qmax - aq.qmin
        return aq.qrange

    @property
    def int4(self) -> bool:
        """Whether the weight has 4 bits or fewer (W4: kept nibble-packed)."""
        return self.cfg.weight.n_bits <= 4

    def _weight_buffers(self, w_int) -> dict:
        """The plan's weight buffers: ``w_int`` (OI) at W8; at W4 only
        ``w_int4``, :func:`~dlmc_quant_torch.quant.deploy.pack_int4` of the
        JAX package's IO layout, as its bytes."""
        if self.int4:
            return {"w_int4": dp.pack_int4(w_int.t())}
        return {"w_int": w_int}

    def _int_weight(self) -> torch.Tensor:
        """The int8 weight (OI) of the plan, unpacked at W4."""
        if self.int4:
            return dp.unpack_int4(self.w_int4, self.weight.shape[1]).t()
        return self.w_int

    def _fake_quant_codes(self, wq, s_w, o_w):
        """``(codes, midpoints)`` of a weight on the grid ``q·s_w + o_w``:
        ``rint((w_fq − o_w)/s_w)`` of the quantizer's own ``'eval'`` output
        ``w_fq``, clamped to ``[qmin, qmax]`` (not ``quantize_weight_int``,
        which has no offset).  A RootQ weight exactly on its bin's
        midpoint (ROADMAP C20: ``sgn(0) = 0`` dequantizes to the midpoint,
        off the grid) takes the even one of its two neighbouring codes,
        whatever float noise ``w_fq`` carries; ``midpoints`` counts
        them."""
        kernel = self.weight.detach()
        w_fq = {"lsq": self._lsq_weight, "rootq": self._rootq_weight}[
            self.family](kernel, wq, "eval", None)
        q = torch.round((w_fq - _bshape(o_w, kernel.dim()))
                        / _bshape(s_w, kernel.dim()))
        midpoints = 0
        if self.family == "rootq":
            interval, mid = rq.weight_bins(kernel, self.wt_run_upper,
                                           self.wt_run_lower, wq.qmin,
                                           wq.qmax)
            q = torch.where(mid, torch.round(interval + (wq.qmin + 0.5)), q)
            midpoints = int(mid.sum())
        return torch.clamp(q, wq.qmin, wq.qmax).to(torch.int8), midpoints

    def _build_int_plan(self):
        """Integer plan: (tensors, host scalars).  See quant/deploy.py.
        A weight-only layer's plan is its weights and their scales, with
        no host scalars; the weights are :meth:`_weight_buffers`, and the
        int8 weight itself is only a local here at W4.  A weight offset
        adds ``w_offset`` (O,) and, with an input quantizer,
        ``off_scale`` (module docstring)."""
        cfg = self.cfg
        wq, aq = cfg.weight, cfg.input
        if not wq.enable:
            raise ValueError(f"{self.path}: weight quantization disabled — "
                             "nothing to deploy")
        if wq.per_pixel:
            raise ValueError(f"{self.path}: per-pixel weights have no "
                             "integer execution plan (use fake-quant eval)")
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
        # RootQ's grid, for one: the JAX package drops o_w (hazard C1)
        offset = bool((o_w != 0).any())
        kernel = self.weight.detach()
        self.midpoints = 0
        if offset or self.family == "rootq":
            w_int, self.midpoints = self._fake_quant_codes(wq, s_w, o_w)
        elif wq.recon_type == "adaround" and hasattr(self, "alpha"):
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
        weights = self._weight_buffers(w_int)
        if offset:
            weights["w_offset"] = o_w.to(torch.float32).expand(
                kernel.shape[0]).contiguous()
        if not aq.enable:
            return {**weights, "w_scale": w_scale}, {}

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
        pad_val = int(dp.int8_pad_value(s_x, o_x, aqmin, aqmax))
        if offset:
            bias_eff = bias_eff + self._zero_residue(
                weights["w_offset"], (pad_val + shift) * s_x + o_x)
            weights["off_scale"] = (s_x * weights["w_offset"]).to(
                torch.float32)
        # colsum and bias0 let a consumer re-derive its epilogue for codes on
        # a producer's grid (a QuantizedTensor input)
        tensors = {**weights, "w_scale": w_scale,
                   "epi_scale": (s_x * w_scale).to(torch.float32),
                   "bias_eff": bias_eff.to(torch.float32),
                   "colsum": colsum, "bias0": bias0}
        scalars = {
            "in_scale": float(s_x),
            "in_inv_scale": float((1.0 / s_x).to(torch.float32)),
            "in_qbias": float((-o_x / s_x - shift).to(torch.float32)),
            "in_offset": float(o_x),
            "pad_val": pad_val,
        }
        return tensors, scalars

    def _zero_residue(self, w_offset, zero_value):
        """``o_w·K·real(z)``: the row term's share that ``S`` (codes less
        the zero code ``z``) leaves out where ``z``'s real value is not
        exactly 0, over the K inputs of a window (0 for RootQ's grid)."""
        return w_offset * (self.weight[0].numel() * zero_value)

    def prepare_deploy(self) -> None:
        """Build and store the integer plan (buffers + host scalars)."""
        tensors, self.plan_scalars = self._build_int_plan()
        for name in ("w_offset", "off_scale", "w_mm"):
            self._buffers.pop(name, None)     # a plan before may have had one
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
        """A weight-only layer's int8 weights (unpacked at W4, as the JAX
        package's ``_plan_weights``) as bf16 values, ``+ o_w`` with a weight
        offset."""
        self._require_plan()
        w_int = self._int_weight()
        w = w_int.to(torch.bfloat16) \
            * _bshape(self.w_scale, w_int.dim()).to(torch.bfloat16)
        offset = getattr(self, "w_offset", None)
        if offset is not None:
            w = w + _bshape(offset, w_int.dim()).to(torch.bfloat16)
        return w

    def _int_input(self, x):
        """``(codes, epi_scale, bias_eff, pad)`` of an integer forward: a
        :class:`QuantizedTensor` goes in as it is, on its own grid (the
        epilogue re-derived from ``colsum`` and ``bias0``); anything else is
        quantized onto this layer's grid."""
        if isinstance(x, QuantizedTensor):
            z = x.zero_code()
            bias_eff = x.bias * self.w_scale * self.colsum + self.bias0
            offset = getattr(self, "w_offset", None)
            if offset is not None:
                bias_eff = bias_eff + self._zero_residue(
                    offset, float(np.float32(z) * np.float32(x.scale)
                                  + np.float32(x.bias)))
            return x.q, x.scale * self.w_scale, bias_eff, z
        self._require_plan()
        return (self._input_codes(x), self.epi_scale, self.bias_eff,
                self.plan_scalars["pad_val"])

    def _int_offset(self, x):
        """The row term's coefficient for an integer forward of ``x``:
        ``s_x·o_w`` (O,) on this layer's grid, ``x.scale·o_w`` for a
        :class:`QuantizedTensor`; None without a weight offset."""
        offset = getattr(self, "w_offset", None)
        if offset is None:
            return None
        if isinstance(x, QuantizedTensor):
            return x.scale * offset
        return self.off_scale

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

    @property
    def depthwise(self) -> bool:
        """A depthwise 3×3 conv: one input channel a group, as many
        groups as channels in and out (MobileNetV2, MobileOne)."""
        return (self.groups > 1 and self.kernel_size == 3
                and self.weight.shape[0] == self.groups
                and self.weight.shape[1] == 1)

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

    def forward_oi(self, x, w):
        """This conv (bias, stride, padding, groups) with the OIHW weight
        ``w``, in full f32: the output observers' forward."""
        with full_f32():
            return self._conv(x, w)

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
            de = self.deferred(*self._int_input(x),
                               off_scale=self._int_offset(x))
            return de if qmode == "intc" else materialize(de)
        x_q, w_q = self._quantize(x, qmode)
        return self._conv(x_q, w_q)

    def deferred(self, x_i8: torch.Tensor, epi_scale=None, bias_eff=None,
                 pad=None, off_scale=None) -> DeferredEpilogue:
        """This layer's output on input codes ``x_i8`` (on this layer's
        grid unless an epilogue and pad code are given), with the conv and
        its epilogue left to the consumer (see quant/chain.py): a 3×3 conv
        pending for the conv kernel, a depthwise 3×3 for the depthwise
        kernel, a 1×1 conv for the int8 GEMM on the subsampled codes (zero
        columns pad K to a multiple of 16: the packed weight is zero
        there), any other window as a :class:`PendingWideConv` (the stem
        kernel where a max pool follows, else im2col rows with the pad
        code at the borders into the GEMM).  With a weight offset the
        output carries the row term ``(S, off_scale)``, ``S`` the window
        sums of ``x_i8`` (``int8_window_sum`` at this conv's window, stride
        and pads; ``None`` for a depthwise conv, whose kernel sums its
        own); ``off_scale`` must come with a given epilogue
        (:meth:`_int_offset`)."""
        if epi_scale is None:
            epi_scale, bias_eff = self.epi_scale, self.bias_eff
            pad = self.plan_scalars["pad_val"]
            off_scale = getattr(self, "off_scale", None)
        elif off_scale is None and hasattr(self, "w_offset"):
            raise ValueError(f"{self.path}: a weight offset's row term needs "
                             "off_scale on the input's grid (_int_offset; "
                             "ROADMAP item 13)")
        grouped = self.groups != 1 and not self.depthwise
        if grouped and (self.kernel_size not in (1, 3)
                        or self.weight.shape[1] == 1):
            raise NotImplementedError(
                f"{self.path}: grouped convs other than a depthwise 3x3 have "
                "an integer path at 3x3 and at 1x1 with more than one input "
                "channel a group; not a depthwise 1x1 such as MobileOne's "
                "scale branch (ROADMAP Queue A, rest of the zoo (item 7))")
        if grouped and (off_scale is not None or hasattr(self, "w_offset")):
            raise NotImplementedError(
                f"{self.path}: a grouped conv's weight offset needs window "
                "sums per group (ROADMAP item 7b)")
        _, h, w, _ = x_i8.shape
        pads = self.spatial_pads(h, w)
        (top, bottom), (left, right) = pads
        s, k = self.stride, self.kernel_size
        row = None
        if off_scale is not None:
            # from the NHWC codes, never from the GEMM's rows: pad_k fills
            # their K tail with code 0, not the zero code
            sums = None if self.depthwise else int8_window_sum(
                x_i8.contiguous(), zero=pad, kernel=k, stride=s, pads=pads)
            row = (sums, off_scale)
        if k == 1:
            if top or bottom or left or right:
                raise NotImplementedError(
                    f"{self.path}: a padded 1x1 conv has no integer path")
            codes = x_i8[:, ::s, ::s, :].contiguous()
            if grouped:
                return DeferredEpilogue(self._grouped_gemm(codes), epi_scale,
                                        bias_eff)
            pending = PendingGemm(pad_k(codes.reshape(-1, codes.shape[-1])),
                                  self.w_gemm, tuple(codes.shape[:3]))
            return DeferredEpilogue(pending, epi_scale, bias_eff, row=row)
        if k != 3:
            pending = PendingWideConv(x_i8.contiguous(), self.w_gemm,
                                      self.w_stem, k, s, pads, pad)
            return DeferredEpilogue(pending, epi_scale, bias_eff, row=row)
        # the kernel pads `top` rows above (0 or 1) and what the window
        # needs below, and gives ceil(h / s) rows: that must be this conv
        if not (top == left and top in (0, 1) and (s == 2 or top == 1)
                and (h + top + bottom - 3) // s + 1 == -(-h // s)
                and (w + left + right - 3) // s + 1 == -(-w // s)):
            raise NotImplementedError(
                f"{self.path}: pads {pads} at stride {s} have no integer "
                "path")
        if self.depthwise:
            pending = PendingDwConv(x_i8.contiguous(), self.w_dw, s, pad, top)
        else:
            pending = PendingConv(x_i8.contiguous(), self.w_packed, s, pad,
                                  top, self.groups)
        return DeferredEpilogue(pending, epi_scale, bias_eff, row=row)

    def _grouped_gemm(self, codes: torch.Tensor) -> torch.Tensor:
        """A grouped 1×1 conv's int32 accumulator (N, Ho, Wo, O) from its
        subsampled codes: one int8 GEMM launch a group, on that group's
        channels (the train form of RepVGG's g2/g4 blocks runs it)."""
        cg = codes.shape[-1] // self.groups
        accs = [PendingGemm(pad_k(codes[..., g * cg:(g + 1) * cg]
                                  .reshape(-1, cg).contiguous()),
                            self.w_gemm[g], tuple(codes.shape[:3]))
                .run(mode="int32") for g in range(self.groups)]
        return torch.cat(accs, dim=-1)

    def _weight_buffers(self, w_int) -> dict:
        """The plan's weight buffers: a weight-only conv's ``w_int`` (OIHW;
        at W4 ``w_int4``, ``pack_int4`` of the JAX package's HWIO); any
        other conv's kernel layouts, packed once (at W8 beside ``w_int``,
        at W4 nibble-packed and alone): ``w_dw`` (depthwise), ``w_packed``
        (3×3, grouped too), ``w_gemm`` (1×1 and wider windows; a grouped
        1×1's is (G, O/G, Kp), one packed B a group) and ``w_stem`` (the
        stem kernel's, where it takes the conv, else None).  Other
        groupings have none: :meth:`deferred` raises for them."""
        w_hwio = w_int.permute(2, 3, 1, 0)
        if self.weight_only:
            return ({"w_int4": dp.pack_int4(w_hwio)} if self.int4
                    else {"w_int": w_int})
        out = {} if self.int4 else {"w_int": w_int}
        if self.depthwise:
            out["w_dw"] = (dwconv.pack_weight_int4 if self.int4
                           else dwconv.pack_weight)(w_hwio)
        elif self.kernel_size == 3:
            out["w_packed"] = (conv3x3.pack_weight_int4 if self.int4
                               else conv3x3.pack_weight)(w_hwio, self.groups)
        elif self.kernel_size == 1 and self.groups == 1:
            out["w_gemm"] = (gemm.pack_b_int4 if self.int4
                             else gemm.pack_b)(w_hwio[0, 0])
        elif self.kernel_size == 1 and w_hwio.shape[2] > 1:
            og = w_hwio.shape[3] // self.groups
            pack = gemm.pack_b_int4 if self.int4 else gemm.pack_b
            out["w_gemm"] = torch.stack([
                pack(w_hwio[0, 0, :, g * og:(g + 1) * og])
                for g in range(self.groups)])
        elif self.groups == 1:
            out["w_gemm"] = (im2col.pack_weight_int4 if self.int4
                             else im2col.pack_weight)(w_hwio)
            c, o = w_hwio.shape[2:]
            stem = (self.kernel_size, self.stride) == \
                (stem_pool.KERNEL, stem_pool.STRIDE) and stem_pool.takes(c, o)
            out["w_stem"] = ((stem_pool.pack_weight_int4 if self.int4
                              else stem_pool.pack_weight)(w_hwio)
                             if stem else None)
        return out

    def _int_weight(self) -> torch.Tensor:
        """A weight-only conv's int8 weight (OIHW), unpacked at W4."""
        if self.int4:
            return dp.unpack_int4(self.w_int4, self.kernel_size) \
                .permute(3, 2, 0, 1)
        return self.w_int


def pad_mm_weight(w_int: torch.Tensor) -> torch.Tensor:
    """The (N, K) int8 weight with N and K zero-padded to multiples of 8,
    as ``torch._int_mm`` wants them on CUDA (CIFAR's 10-class heads: N =
    10; the SE blocks' ``up`` layers of RepVGG-D2se: K = C/16 = 4, 10,
    20); zero weights add nothing to a product."""
    n, k = w_int.shape
    np_, kp = -(-n // 8) * 8, -(-k // 8) * 8
    if (np_, kp) == (n, k):
        return w_int.contiguous()
    out = w_int.new_zeros((np_, kp))
    out[:n, :k] = w_int
    return out


def _int8_matmul(x_i8: torch.Tensor, w_int: torch.Tensor,
                 n: Optional[int] = None) -> torch.Tensor:
    """(M, K) int8 · (N, K)ᵀ int8 → (M, n) int32 with ``torch._int_mm``.

    ``w_int`` may be :func:`pad_mm_weight` of the (n, K) weight already
    (``QDense``'s ``w_mm``, padded once by ``prepare_deploy``); on CUDA it
    is padded here otherwise.  The codes get zero columns up to the
    weight's K and, on CUDA, where ``_int_mm`` wants M > 16 and a multiple
    of 8, zero rows.
    """
    m, k = x_i8.shape
    n = w_int.shape[0] if n is None else n
    if x_i8.is_cuda:
        w_int = pad_mm_weight(w_int)
    kp = w_int.shape[1]
    if kp != k or (x_i8.is_cuda and (m <= 16 or m % 8)):
        rows = max(32, -(-m // 8) * 8) if x_i8.is_cuda else m
        padded = x_i8.new_zeros((rows, kp))
        padded[:m, :k] = x_i8
        x_i8 = padded
    return torch._int_mm(x_i8, w_int.t())[:m, :n]


class QDense(QLayer):
    """Quantization-aware dense layer, weight (out, in)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        _init_weight(self.weight.data, generator, in_features, 1.0)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def _weight_buffers(self, w_int) -> dict:
        """:meth:`QLayer._weight_buffers` and, at W8 with an input grid,
        ``w_mm``: :func:`pad_mm_weight` of ``w_int``, so that a request
        pads only its codes."""
        out = super()._weight_buffers(w_int)
        if not self.int4 and not self.weight_only:
            out["w_mm"] = pad_mm_weight(w_int)
        return out

    def forward_oi(self, x, w):
        """This layer with the (out, in) weight ``w``, in full f32: the
        output observers' forward."""
        with full_f32():
            return F.linear(x, w, self.bias)

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
            x_i8, epi_scale, bias_eff, pad = self._int_input(x)
            w_mm = (self._int_weight().contiguous() if self.int4
                    else self.w_mm)
            acc = _int8_matmul(x_i8, w_mm, self.weight.shape[0])
            off_scale, row = self._int_offset(x), None
            if off_scale is not None:
                # a (M, K) row as a 1x1 window: S at the head's K inputs
                sums = int8_window_sum(x_i8.reshape(
                    -1, 1, 1, x_i8.shape[-1]).contiguous(), zero=pad)
                row = (sums.reshape(-1), off_scale)
            de = DeferredEpilogue(acc, epi_scale, bias_eff, row=row)
            return de if qmode == "intc" else materialize(de)
        x_q, w_q = self._quantize(x, qmode)
        return F.linear(x_q, w_q, self.bias)


class QBlockOutput(nn.Module):
    """Residual-block output quantizer: ``relu(trunk + shortcut)`` → int8.

    Counterpart of ``dlmc_quant_tpu/quant/layers.py:819-906``.
    ``relu=False`` closes a linear bottleneck (MobileNetV2): the sum has no
    ReLU, and the folded clamp's lower bound is the grid's minimum, not
    the code of 0.  In every qmode but ``'intc'`` this is ``relu(y + r)``
    (``y + r``).  ``'calibrate'`` observes the f32 block output with the
    scheme's input observer from one batch (``percentile_tensor`` for a
    ``percentile*`` observer, else ``minmax_tensor``) into ``out_scale``
    (parameter) and ``out_offset`` (buffer, a float offset: the grid is
    ``q·out_scale + out_offset``).  :meth:`prepare_deploy` freezes the grid
    into host scalars, and ``'intc'`` then folds trunk epilogue + shortcut
    + ReLU + quantize into the epilogue of the trunk's last conv
    (:func:`~dlmc_quant_torch.quant.chain.fold_sum_quantize`) and returns a
    :class:`~dlmc_quant_torch.quant.chain.QuantizedTensor`.
    """

    def __init__(self, relu: bool = True):
        super().__init__()
        self.relu = relu
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
        self.cfg = cfg
        self.out_scale = nn.Parameter(torch.ones((), device=device))
        self.register_buffer("out_offset", torch.zeros((), device=device))

    def _sum(self, y, r):
        v = materialize(y) + materialize(r)
        return torch.relu(v) if self.relu else v

    def forward(self, y, r, qmode: str = "eval"):
        if self.cfg is None:
            return self._sum(y, r)
        if qmode == "calibrate":
            v = self._sum(y, r)
            s, off = _batch_observe(v.detach(), self.cfg.input, None)
            self.out_scale.data.copy_(s.reshape(()))
            self.out_offset.copy_(off.reshape(()))
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
        # the ReLU as the lower bound: the code of real 0; without one the
        # grid's minimum
        lo = (int(torch.clamp(torch.round(-o_x / s_x), qmin, qmax))
              if self.relu else qmin) - shift
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

    Every quantized layer writes its observed scales (from the stream
    where there is one), zero-points, AdaRound ``alpha`` and RootQ
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
