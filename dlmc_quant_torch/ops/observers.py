"""PTQ calibration observers: tensor → ``(scale, offset)``.

Counterpart of ``dlmc_quant_tpu/ops/observers.py``.  This slice ports the
two observers of the flagship scheme (per-channel weights, per-tensor
activations) and the streaming min/max state that multi-batch calibration
folds activations into.  Every other observer name of the JAX package
raises ``NotImplementedError`` until ROADMAP Queue A, observers left
(item 9), ports it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

_EPS = 1e-9

# observers of the JAX package that this slice does not port yet
_NOT_PORTED = ("l2loss_tensor", "l2norm_tensor", "percentile_tensor",
               "l2loss_channel", "l2norm_channel", "minmax_pixel",
               "l2norm_pixel", "l2norm_output", "l2norm_output_channel")


def minmax_tensor(tensor, n_bits: int, signed: bool,
                  allow_offset: bool = True):
    """Abs-max (signed, symmetric) or min..max affine (unsigned) scale."""
    zero = torch.zeros((), dtype=tensor.dtype, device=tensor.device)
    if signed:
        qmax = 2 ** (n_bits - 1) - 1
        scale = tensor.abs().max() / qmax
        offset = zero
    else:
        qmax = 2 ** n_bits - 1
        min_val = tensor.min() if allow_offset else zero
        scale = (tensor.max() - min_val) / qmax
        offset = min_val
    return torch.clamp_min(scale, _EPS), offset


def _channel_view(tensor, ch_axis: int):
    """Move ``ch_axis`` to the front and flatten the rest: (C, -1)."""
    t = torch.movedim(tensor, ch_axis, 0)
    return t.reshape(t.shape[0], -1)


def _channel_bcast(stat, tensor_ndim: int, ch_axis: int):
    shape = [1] * tensor_ndim
    shape[ch_axis] = -1
    return stat.reshape(shape)


def minmax_channel(tensor, n_bits: int, signed: bool, ch_axis: int = 0,
                   allow_offset: bool = True):
    """Per-channel min/max; returns broadcast-shaped ``(scale, offset)``."""
    t = _channel_view(tensor, ch_axis)
    if signed:
        qmax = 2 ** (n_bits - 1) - 1
        scale = t.abs().amax(dim=1) / qmax
        offset = torch.zeros_like(scale)
    else:
        qmax = 2 ** n_bits - 1
        mn = t.amin(dim=1) if allow_offset else torch.zeros_like(t[:, 0])
        scale = (t.amax(dim=1) - mn) / qmax
        offset = mn
    return (_channel_bcast(torch.clamp_min(scale, _EPS), tensor.ndim, ch_axis),
            _channel_bcast(offset, tensor.ndim, ch_axis))


TENSOR_OBSERVERS = {
    "minmax_tensor": minmax_tensor,
    "minmax_channel": minmax_channel,
}


def get_qparams_tensor(tensor, qtype: str, **kwargs) -> Tuple:
    """String-dispatched tensor observer."""
    if qtype in _NOT_PORTED:
        raise NotImplementedError(
            f"observer {qtype!r} is not ported yet (ROADMAP Queue A, "
            "observers left (item 9))")
    try:
        fn = TENSOR_OBSERVERS[qtype]
    except KeyError:
        raise ValueError(
            f"unknown observer {qtype!r}; known: "
            f"{sorted(TENSOR_OBSERVERS)}") from None
    return fn(tensor, **kwargs)


# ---------------------------------------------------------------------------
# Streaming state: min/max over many batches, for the 'observe' pass
# ---------------------------------------------------------------------------

class StreamingState(NamedTuple):
    """Running activation min and max, and the number of batches folded."""
    min: torch.Tensor
    max: torch.Tensor
    count: torch.Tensor


def streaming_init(stat_shape=(), device=None) -> StreamingState:
    return StreamingState(
        min=torch.full(stat_shape, float("inf"), device=device),
        max=torch.full(stat_shape, float("-inf"), device=device),
        count=torch.zeros((), dtype=torch.int32, device=device))


def streaming_update(state: StreamingState, x) -> StreamingState:
    """Fold one batch into the running per-tensor min/max.

    The JAX package also sums a per-batch percentile here, which only its
    ``percentile*`` finalize reads; that is not ported.
    """
    return StreamingState(min=torch.minimum(state.min, x.min()),
                          max=torch.maximum(state.max, x.max()),
                          count=state.count + 1)


def streaming_finalize(state: StreamingState, qtype: str, n_bits: int,
                       signed: bool):
    """``(scale, offset)`` from the accumulated min/max (``minmax*``)."""
    if qtype.startswith("percentile"):
        raise NotImplementedError(
            "streaming percentile observers are not ported yet "
            "(ROADMAP Queue A, observers left (item 9))")
    if signed:
        qmax = 2 ** (n_bits - 1) - 1
        amax = torch.maximum(state.min.abs(), state.max.abs())
        return torch.clamp_min(amax / qmax, _EPS), torch.zeros_like(amax)
    qmax = 2 ** n_bits - 1
    scale = (state.max - state.min) / qmax
    return torch.clamp_min(scale, _EPS), state.min
