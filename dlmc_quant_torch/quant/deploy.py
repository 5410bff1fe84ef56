"""Real integer execution: deploy-form quantized inference.

Counterpart of ``dlmc_quant_tpu/quant/deploy.py``.  ``prepare_deploy``
turns every quantized layer's calibrated affine quantizers into an
integer execution plan (int8 weights, per-channel weight scales, the
activation scale and zero-point, the pad code, and a bias with every
zero-point correction folded in).  ``qmode='int'`` then runs quantize →
int8 conv/matmul → f32 epilogue, and ``qmode='intc'`` chains the layers
int8-resident (``quant/chain.py``).

Math (activation affine x ≈ (x_i8 + 128)·s_x + o_x, symmetric
per-channel weights w ≈ w_i8·s_w):

    Σ x·w = s_x·s_w·(x_i8 ⋆ w_i8) + (128·s_x + o_x)·s_w·colsum

so ``bias_eff = bias + (128·s_x + o_x)·s_w·colsum``, and borders are
padded with the int8 code of real 0, which keeps the correction exact.

A layer whose input quantizer is off keeps only its int8 weights and
their scales, and runs a conv or matmul of the dequantized bf16 weights on
bf16 inputs with an f32 accumulator (``QLayer.weight_only``).  A nonzero
weight offset (RootQ after QAT) has no integer plan: ``prepare_deploy``
raises (ROADMAP hazard C1).

Not ported yet: int4 weights (``pack_int4``; ROADMAP Queue A, W4 execution
(item 8)) and the space-to-depth stem.
"""

from __future__ import annotations

from typing import Dict

import torch

from dlmc_quant_torch.device import DeviceLike, resolve_device


def affine_from_quantizer(family: str, cfg, params: Dict, qstate: Dict,
                          role: str):
    """Reduce a calibrated quantizer to a float affine ``(scale, offset)``
    such that the fake-quant grid is ``q*scale + offset``.

    role ∈ {'weight', 'input'}.  FSPTQ stores an integer zero-point, the
    plain/LSQ family a float offset; RootQ's grids come from its running
    values, the weight's offset ``l − qmin·s`` nonzero in general.
    """
    if family == "rootq":
        if role == "input":
            s = qstate["in_run_scale"]
            return s, torch.zeros_like(s)
        u, l = qstate["wt_run_upper"], qstate["wt_run_lower"]
        qmin, qmax = cfg.qrange
        s = (u - l) / float(qmax - qmin)
        return s, l - qmin * s
    if family == "fsptq":
        if role == "input":
            s = params["in_scale"]
            zp = qstate.get("in_offset", torch.zeros_like(s))
            return s, -zp * s
        return params["wt_scale"], torch.zeros_like(params["wt_scale"])
    if role == "input":
        s = params["in_scale"]
        return s, qstate.get("in_offset", torch.zeros_like(s))
    s = params["wt_scale"]
    return s, qstate.get("wt_offset", torch.zeros_like(s))


def quantize_weight_int(kernel, scale, qmin: int, qmax: int,
                        ch_axis: int = 0):
    """Kernel (OIHW/OI f32) → int8 on the symmetric per-channel grid."""
    if scale.dim() == 0:
        s = scale
    else:
        bshape = [1] * kernel.dim()
        bshape[ch_axis] = -1
        s = scale.reshape(bshape)
    return torch.clamp(torch.round(kernel / s), qmin, qmax).to(torch.int8)


def act_shift(qmax: int) -> int:
    """int8 recentering shift: unsigned 8-bit grids ([0, 255]) shift by
    128 so codes fit int8; everything else fits directly."""
    return 128 if qmax > 127 else 0


def act_to_int8(x, s_x, o_x, qmin: int, qmax: int, inv_s_x=None,
                qbias=None):
    """Quantize activations to int8 codes, x ≈ (x_i8 + shift)·s_x + o_x.

    With ``inv_s_x`` and ``qbias`` from the deploy plan this is the
    single-FMA form ``clip(round(x·inv_s_x + qbias))`` of the JAX package
    (two separate float32 ops here, rounding half to even).  It may differ
    from the naive ``round((x - o)/s) - shift`` by one code at ties.
    """
    shift = act_shift(qmax)
    if inv_s_x is not None and qbias is not None:
        q = torch.round(x * inv_s_x + qbias)
        return q.clamp_(qmin - shift, qmax - shift).to(torch.int8), shift
    scaled = (x - o_x) * inv_s_x if inv_s_x is not None else (x - o_x) / s_x
    q = torch.clamp(torch.round(scaled), qmin, qmax) - shift
    return q.to(torch.int8), shift


def int8_pad_value(s_x, o_x, qmin: int, qmax: int):
    """int8 code representing real value 0 (used as conv padding)."""
    return (torch.clamp(torch.round(-o_x / s_x), qmin, qmax)
            - act_shift(qmax)).to(torch.int8)


def prepare_deploy(model: torch.nn.Module) -> torch.nn.Module:
    """Build the integer plan of every quantized layer and block output (in
    place).

    The plan depends only on the calibrated parameters, so unlike the JAX
    package no sample input is needed.
    """
    from dlmc_quant_torch.quant.layers import QBlockOutput, QLayer

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (QLayer, QBlockOutput)) and m.cfg is not None:
                m.prepare_deploy()
    return model


def make_serving_fn(model: torch.nn.Module, qmode: str = "intc",
                    device: DeviceLike = None):
    """Weight-resident forward ``fn(x) -> logits`` on ``device``.

    The deploy-form module and its plans are moved to the device once;
    each call moves only the activations (NHWC float32) and runs under
    ``torch.inference_mode``.
    """
    device = resolve_device(device)
    model = model.to(device).eval()

    def serve(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(x.to(device), qmode=qmode)

    return serve
