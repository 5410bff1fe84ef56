"""RootQ root-base estimator math.

Counterpart of ``dlmc_quant_tpu/ops/rootq_math.py``.  RootQ replaces the
STE with a power-function surrogate
``phi(x) = (2/delta·|x − mi| + eps)^alpha · sgn(x − mi)`` whose gradient is
sharp near a quantization bin's midpoint and flat near its edges, with a
learnable root exponent ``alpha``; a hard sign with identity gradient then
picks the bin's lower or upper edge.  Plain autograd of these compositions
gives the reference's surrogate gradients, op for op the JAX package's.

* :func:`clipping` and :func:`clamp_alpha` are two ReLUs, not
  ``torch.clamp``: at a bound ``x`` gets no gradient and the bound gets it
  (a PACT-style learned clip).
* :func:`sgn` keeps ``sign(0) = 0``, which lands on the bin's midpoint, as
  in the JAX package.
"""

from __future__ import annotations

import torch

from dlmc_quant_torch.ops.numerics import floor_pass, round_pass


def clipping(x, upper, lower):
    """Clip to ``[lower, upper]`` with two ReLUs; the gradient reaches
    ``upper`` and ``lower`` wherever a bound is active."""
    x = x + torch.relu(lower - x)
    return x - torch.relu(x - upper)


def clamp_alpha(alpha):
    """The root exponent clamped to ``[1e-4, 1]`` with two ReLUs."""
    alpha = alpha + torch.relu(1e-4 - alpha)
    return alpha - torch.relu(alpha - 1.0)


def phi(x, mi, alpha, delta, eps: float = 1e-5):
    """Root-base surrogate ``(2/delta·|x−mi| + eps)^alpha · (x−mi)/(|x−mi|
    + eps)``; ``mi`` (the bin's midpoint) comes detached from the caller,
    ``alpha`` learns through the power."""
    alpha = clamp_alpha(alpha)
    d = x - mi
    smooth_sgn = d / (torch.abs(d) + eps)
    k = 2.0 / delta
    return torch.pow(k * torch.abs(d) + eps, alpha) * smooth_sgn


def sgn(x):
    """Hard sign forward (``sign(0) = 0``), identity gradient."""
    return x + (torch.sign(x) - x).detach()


def bin_dequantize(s, lower, delta, interval):
    """``((s+1)/2 + interval)·delta + lower``: ``s = −1`` is the bin's lower
    edge, ``s = +1`` its upper edge."""
    return ((s + 1.0) / 2.0 + interval) * delta + lower


def rootq_weight_fake_quant(w, upper, lower, alpha, qmin: int, qmax: int):
    """RootQ weight path: clip → bin index (floor STE) → bin midpoint → phi
    → hard sign → dequantize; ``upper`` and ``lower`` learn through the
    clip and through ``delta``."""
    w_c = clipping(w, upper, lower)
    delta = (upper - lower) / float(qmax - qmin)
    interval = floor_pass((w_c - lower) / delta)
    mi = (interval + 0.5) * delta + lower
    s = sgn(phi(w_c, mi.detach(), alpha, delta))
    return bin_dequantize(s, lower, delta, interval)


def weight_bins(w, upper, lower, qmin: int, qmax: int):
    """``(interval, on_midpoint)`` of :func:`rootq_weight_fake_quant`'s
    forward, op for op: each clipped weight's bin index, and whether it
    lies exactly on its bin's midpoint, where ``sgn`` sees 0 and the
    weight dequantizes to the midpoint, off the integer grid (ROADMAP
    hazard C20)."""
    w_c = clipping(w, upper, lower)
    delta = (upper - lower) / float(qmax - qmin)
    interval = torch.floor((w_c - lower) / delta)
    mi = (interval + 0.5) * delta + lower
    return interval, (w_c - mi) == 0


def rootq_act_fake_quant(x, scale, qmax: int, qmin: int = 0):
    """RootQ activation path: clip to ``[0, scale·(qmax−qmin)]`` with
    :func:`clipping`, then round (STE) on the integer grid."""
    upper = scale * float(qmax - qmin)
    x_c = clipping(x, upper, 0.0)
    return round_pass(x_c / scale) * scale
