"""Affine quantization numerics (forward only).

Counterpart of ``dlmc_quant_tpu/ops/numerics.py``.  This slice of the port
serves and calibrates; it has no backward pass yet, so the straight-through
estimators are their forward values (``round_pass`` is ``torch.round``).
The gradient forms (``uniform_q``, ``lsq_q``, ``grad_scale``) come with the
training slice (ROADMAP Queue A item 2).
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


def round_pass(x):
    """Round half to even, like ``jnp.round`` (forward of the STE)."""
    return torch.round(x)
