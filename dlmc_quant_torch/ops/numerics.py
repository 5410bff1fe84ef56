"""Affine quantization numerics, the FSPTQ family's gradients and the
plain/LSQ family's fake quantization.

Counterpart of ``dlmc_quant_tpu/ops/numerics.py``.  ``round_pass`` and
``floor_pass`` are straight-through estimators (rounded forward, identity
gradient) and :func:`clip` has ``jnp.clip``'s gradient, which FSPTQ
reconstruction needs.  :func:`lsq_fake_quant` is the LSQ layers' forward
with its STE.  :func:`uniform_q` and :func:`lsq_q` pin down the
reference's explicit backward rules (``torch.autograd.Function`` here,
``jax.custom_vjp`` there).  The RootQ forms are in ``ops/rootq_math.py``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def get_qrange(signed: bool, n_bits: int) -> Tuple[int, int]:
    """Integer grid of an ``n_bits`` quantizer.

    Signed grids are symmetric, ``[-(2^{b-1}-1), 2^{b-1}-1]``; unsigned
    grids are ``[0, 2^b - 1]``.
    """
    if signed:
        qmax = 2 ** (n_bits - 1) - 1
        return -qmax, qmax
    return 0, 2 ** n_bits - 1


def quantize(x, scale, offset, qmin, qmax):
    """``q = clamp(round((x - offset)/scale), qmin, qmax)`` (float-valued)."""
    return torch.clamp(torch.round((x - offset) / scale), qmin, qmax)


def dequantize(q, scale, offset):
    """``x = q * scale + offset``."""
    return q * scale + offset


def emulate_quantize(x, scale, offset, qmin, qmax):
    """Quantize-dequantize round trip (fake quantization)."""
    return dequantize(quantize(x, scale, offset, qmin, qmax), scale, offset)


def clip(x, lo, hi):
    """``clamp(x, lo, hi)`` with ``jnp.clip``'s gradient.

    ``jnp.clip`` is ``minimum(maximum(x, lo), hi)``, whose gradient is split
    0.5/0.5 where ``x`` equals a bound; ``torch.clamp`` passes it whole.
    Quantized values sit exactly on ``qmin``/``qmax`` often, so the
    difference shows in every reconstruction gradient.  Forward values are
    those of ``torch.clamp``.  The bounds are filled on ``x``'s device: a
    tensor copied from the host would wait for the card at every call.
    """
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def round_pass(x):
    """Round half to even forward, identity gradient (STE)."""
    return x + (torch.round(x) - x).detach()


def floor_pass(x):
    """Floor forward, identity gradient (STE)."""
    return x + (torch.floor(x) - x).detach()


def grad_scale(x, g: float):
    """Identity forward; gradient scaled by ``g`` (the LSQ trick)."""
    return x * g + (x - x * g).detach()


def lsq_fake_quant(x, scale, offset, qmin: int, qmax: int, g: float):
    """LSQ fake quantization, ``round_pass(clip((x - offset)/s))·s + offset``
    with ``s = grad_scale(scale, g)`` (clamped before the STE round, as in
    the reference; ref: scalar/modules/base.py:96-102,131-133)."""
    s = grad_scale(scale, g)
    q = round_pass(clip((x - offset) / s, qmin, qmax))
    return q * s + offset


def lsq_grad_factor(numel: int, qmax: int) -> float:
    """LSQ gradient scale ``1/sqrt(numel·qmax)``, in float32 as the JAX
    package computes it (the forward of :func:`grad_scale` rounds with
    it)."""
    return float(np.float32(1.0) / np.sqrt(
        np.float32(float(numel) * float(max(qmax, 1)))))


def lsq_init_scale(x, qmax: int, dim=None):
    """LSQ scale initialization ``2·mean|x|/sqrt(qmax)``, per tensor
    (``dim=None``) or averaged over ``dim`` (per channel)."""
    m = x.abs().mean() if dim is None else x.abs().mean(dim=dim)
    return 2.0 * m / math.sqrt(float(max(qmax, 1)))


# ---------------------------------------------------------------------------
# Explicit custom-gradient estimators (ref: scalar/modules/function.py:9-46)
# ---------------------------------------------------------------------------

class _UniformQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, offset, qmin, qmax):
        t = (x - offset) / scale
        ctx.save_for_backward((t >= qmin) & (t <= qmax))
        return emulate_quantize(x, scale, offset, qmin, qmax)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return torch.where(mask, g, torch.zeros_like(g)), None, None, None, \
            None


def uniform_q(x, scale, offset, qmin: int, qmax: int):
    """Clip-aware STE fake quant: ``emulate_quantize`` forward; the
    gradient passes to ``x`` only where ``qmin <= (x-offset)/scale <= qmax``,
    and ``scale`` and ``offset`` get none."""
    return _UniformQ.apply(x, scale, offset, qmin, qmax)


class _LsqQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, qmin, qmax, g):
        ctx.save_for_backward(x, scale)
        ctx.qrange, ctx.g = (qmin, qmax), g
        return torch.clamp(torch.round(x / scale), qmin, qmax) * scale

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        qmin, qmax = ctx.qrange
        t = x / scale
        inside = (t >= qmin) & (t <= qmax)
        r = torch.where(t < qmin, torch.full_like(t, float(qmin)),
                        torch.where(t > qmax, torch.full_like(t, float(qmax)),
                                    torch.round(t) - t))
        dx = torch.where(inside, dy, torch.zeros_like(dy))
        ds = (torch.sum(dy * r) * ctx.g).reshape(scale.shape)
        return dx, ds, None, None, None


def lsq_q(x, scale, qmin: int, qmax: int, g: float):
    """Per-tensor LSQ with the reference's explicit backward: forward
    ``clamp(round(x/s))·s``; ``dx = dy`` inside the clip range, 0 outside;
    ``ds = Σ dy·r · g`` with ``r = round(t) − t`` inside and ``qmin``/``qmax``
    at the clipped ends."""
    return _LsqQ.apply(x, scale, qmin, qmax, g)
