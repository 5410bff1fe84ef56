"""Affine quantization numerics and the FSPTQ family's gradients.

Counterpart of ``dlmc_quant_tpu/ops/numerics.py``.  ``round_pass`` and
``floor_pass`` are straight-through estimators (rounded forward, identity
gradient) and :func:`clip` has ``jnp.clip``'s gradient, which FSPTQ
reconstruction needs.  The LSQ and RootQ gradient forms (``uniform_q``,
``lsq_q``, ``grad_scale``) are not ported yet (ROADMAP Queue A item 2).
"""

from __future__ import annotations

from typing import Tuple

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
