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

A weight of 4 bits or fewer stays nibble-packed, two values a byte, and
no int8 copy of it stays in the plan: a conv keeps only its kernel's own
layout, packed along K (``ops/cuda/nibbles.py``), which the kernel
unpacks in its weight load; a dense layer and a weight-only layer keep
``w_int4`` (:func:`pack_int4`, the JAX package's layout and bytes).

A layer whose input quantizer is off keeps only its int8 (or packed int4)
weights and their scales, and runs a conv or matmul of the dequantized bf16 weights on
bf16 inputs with an f32 accumulator (``QLayer.weight_only``).

A weight grid with an offset, ``w ≈ q·s_w + o_w`` (RootQ's, an offset LSQ
weight's; the JAX package drops ``o_w``, ROADMAP hazard C1), adds

    o_w·Σ x = s_x·o_w·S + o_w·K·real(z),   S = Σ_window (x_i8 − z)

to each output: ``S`` per output pixel (``ops.cuda.int8_window_sum``),
scaled per output channel by the plan's ``off_scale = s_x·o_w`` in the
kernels' epilogue; the second part, 0 where the zero code ``z`` is real 0
exactly (RootQ), goes into ``bias_eff``.  The codes come from the
quantizer's own fake-quant weight; ``prepare_deploy`` logs how many RootQ
weights lie exactly on a bin midpoint, off the grid (ROADMAP hazard C20).

Not ported yet: the space-to-depth stem.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import torch

from dlmc_quant_torch.device import DeviceLike, resolve_device
from dlmc_quant_torch.ops.cuda.nibbles import pack_nibbles, unpack_nibbles

log = logging.getLogger(__name__)


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


def pack_int4(w_int: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8, 7] two a byte along axis 0 (uint8).

    The JAX package's ``pack_int4`` byte for byte: axis 0 is the first
    kernel axis (H of a conv's HWIO, K of a dense layer's IO), an odd size
    is padded with zeros, the even index goes in the low nibble.  The JAX
    package's other int4 route, a native S4 dtype that XLA contracts
    directly, has no counterpart: torch has no 4-bit integer dtype that a
    product takes, and Hopper's ``wgmma`` has no s4 operand, so every
    kernel here unpacks nibbles to int8 in its weight load.
    """
    return pack_nibbles(w_int.movedim(0, -1)).movedim(-1, 0).contiguous()


def unpack_int4(packed: torch.Tensor, orig_dim0: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4` → int8 values (each nibble
    sign-extended as ``(v ^ 8) - 8``), axis 0 cut to ``orig_dim0``."""
    return unpack_nibbles(packed.movedim(0, -1), orig_dim0) \
        .movedim(-1, 0).contiguous()


def prepare_deploy(model: torch.nn.Module) -> torch.nn.Module:
    """Build the integer plan of every quantized layer and block output (in
    place).

    The plan depends only on the calibrated parameters, so unlike the JAX
    package no sample input is needed.  Logs the count of RootQ weights on
    a bin midpoint (:func:`midpoint_count`, ROADMAP hazard C20) where
    there are any.
    """
    from dlmc_quant_torch.quant.layers import QBlockOutput, QLayer

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (QLayer, QBlockOutput)) and m.cfg is not None:
                m.prepare_deploy()
    n = midpoint_count(model)
    if n:
        log.info("prepare_deploy: %d RootQ weights lie exactly on a bin "
                 "midpoint, off the integer grid; each takes the even of "
                 "its two codes (ROADMAP hazard C20)", n)
    return model


def midpoint_count(model: torch.nn.Module) -> int:
    """RootQ weights of the model's integer plans that lie exactly on a
    bin midpoint, which their codes miss by half a step (ROADMAP C20)."""
    return sum(getattr(m, "midpoints", 0) for m in model.modules())


def make_serving_fn(model: torch.nn.Module, qmode: str = "intc",
                    device: DeviceLike = None, graph: Optional[bool] = None):
    """Weight-resident forward ``fn(x) -> logits`` on ``device``.

    The deploy-form module and its plans are moved to the device once.  On
    a CUDA device the function is graphed by default (``graph=None``): a
    :class:`~dlmc_quant_torch.quant.graphed.GraphedForward`, which captures
    the forward once a (shape, dtype) of ``x`` in a CUDA graph, as
    ``jax.jit`` compiles once a shape, and replays it; its ``launches``
    hold each capture's launches by kind.  The weights are constants of
    the graph, as JAX freezes the variables into its program: a layer
    re-planned after a capture (new tensors) needs a new serving function.
    A capture that fails raises; it never serves eagerly instead.

    ``graph=False``, and ``device="cpu"`` (where ``graph=True`` raises),
    give the eager forward: each call moves only the activations (NHWC
    float32) and runs the module under ``torch.inference_mode``.
    """
    device = resolve_device(device)
    model = model.to(device).eval()
    if graph is None:
        graph = device.type == "cuda"
    if graph:
        from dlmc_quant_torch.quant.graphed import GraphedForward
        return GraphedForward(model, qmode, device)

    def serve(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(x.to(device), qmode=qmode)

    return serve
