"""PTQ calibration observers: tensor → ``(scale, offset)``.

Counterpart of ``dlmc_quant_tpu/ops/observers.py``, with the same names,
constants and granularities:

* ``*_tensor``  — one ``(scale, offset)`` per tensor;
* ``*_channel`` — one per channel along ``ch_axis``, broadcast-shaped;
* ``*_pixel``   — one per spatial position of an OIHW conv weight,
  shaped ``(1, 1, H, W)``;
* ``*_output``  — the weight scale that minimizes the error of the
  layer's output, driving ``forward_fn(inputs, weight)`` in the loop.

The JAX package's ``lax.scan`` grid searches are Python loops over the 80
candidates, one candidate at a time (stacking them would hold 80 copies of
the tensor), and its ``lax.while_loop`` fixed points are Python ``while``
loops on the same condition (a host sync an iteration, in calibration
only).  Percentiles come from order statistics (:func:`percentile`), not
``torch.quantile``, which refuses tensors of more than 2²⁴ elements.

:class:`StreamingState` folds many batches into running statistics for
the ``'observe'`` passes: min/max (per tensor or per channel) and, for the
``percentile*`` observers, the sum of the per-batch percentiles of |x|.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from dlmc_quant_torch.ops.numerics import get_qrange, quantize

_EPS = 1e-9

# number of 1%-shrink steps in the clip grid search
GRID_STEPS = 80
# cap for fixed-point iterations
MAX_FP_ITERS = 100
FP_TOL = 1e-5
# the percentile observers' default
DEFAULT_PCT = 99.99


def _div(a, d: int):
    """``a / d`` rounded once, on every device: PyTorch's CUDA kernels
    multiply by the reciprocal of a Python scalar divisor, one ulp off the
    CPU's (and the JAX package's) quotient, but divide by a tensor."""
    return a / torch.tensor(float(d), dtype=a.dtype, device=a.device)


def _sse(a, b):
    """Sum of squared errors, the observers' ranking metric."""
    return torch.sum((a - b) ** 2)


def _shrink(i: int) -> float:
    """The grid search's i-th clip factor ``1 − 0.01·i``, in float32 as
    the JAX package's scan computes it."""
    one, step = torch.tensor(1.0), torch.tensor(0.01)
    return float(one - step * float(i))


# ---------------------------------------------------------------------------
# Percentiles from order statistics
# ---------------------------------------------------------------------------

def _ranks(t, lo: int, hi: int):
    """The values of ascending rank ``lo`` and ``hi`` (lo ≤ hi) along the
    last axis, by ``topk`` of the smaller tail."""
    n = t.shape[-1]
    if n - lo <= hi + 1:
        top = torch.topk(t, n - lo, dim=-1, largest=True, sorted=True).values
        return top[..., n - 1 - lo], top[..., n - 1 - hi]
    bottom = torch.topk(t, hi + 1, dim=-1, largest=False,
                        sorted=True).values
    return bottom[..., lo], bottom[..., hi]


def percentile(t, pct: float):
    """The ``pct`` percentile of ``t`` along its last axis, linearly
    interpolated between order statistics as ``jnp.percentile`` does.

    The fractional index ``pct/100·(n − 1)`` is formed in float64, where
    the JAX package forms it in float32 (ROADMAP hazard C15: at 77 M
    elements its index lands only on multiples of 8 elements)."""
    n = t.shape[-1]
    idx = pct / 100.0 * (n - 1)
    lo = min(max(math.floor(idx), 0), n - 1)
    hi = min(max(math.ceil(idx), 0), n - 1)
    w = idx - math.floor(idx)
    v_lo, v_hi = _ranks(t, lo, hi)
    return v_lo * (1.0 - w) + v_hi * w


# ---------------------------------------------------------------------------
# Per-tensor observers
# ---------------------------------------------------------------------------

def minmax_tensor(tensor, n_bits: int, signed: bool,
                  allow_offset: bool = True):
    """Abs-max (signed, symmetric) or min..max affine (unsigned) scale."""
    zero = torch.zeros((), dtype=tensor.dtype, device=tensor.device)
    if signed:
        qmax = 2 ** (n_bits - 1) - 1
        scale = _div(tensor.abs().max(), qmax)
        offset = zero
    else:
        qmax = 2 ** n_bits - 1
        min_val = tensor.min() if allow_offset else zero
        scale = _div(tensor.max() - min_val, qmax)
        offset = min_val
    return torch.clamp_min(scale, _EPS), offset


def _clip_search(t, base_min, base_max, n_bits: int, signed: bool, dim):
    """80-step clip grid search: shrink [base_min, base_max] by 1 % a step
    and keep the ``(scale, offset)`` of least L2 reconstruction error
    (reduced over ``dim``; the first of equal losses wins)."""
    qmin, qmax = get_qrange(signed, n_bits)
    levels = qmax - qmin
    best_loss = torch.full_like(base_max, float("inf"))
    best_scale = torch.clamp_min(_div(base_max - base_min, levels), _EPS)
    best_offset = torch.zeros_like(base_min) if signed else base_min
    for i in range(GRID_STEPS):
        f = _shrink(i)
        mn, mx = f * base_min, f * base_max
        scale = torch.clamp_min(_div(mx - mn, levels), _EPS)
        offset = torch.zeros_like(mn) if signed else mn
        s, o = (scale, offset) if dim is None \
            else (scale[:, None], offset[:, None])
        q = quantize(t, s, o, qmin, qmax)
        loss = torch.sum((q * s + o - t) ** 2, dim=dim)
        better = loss < best_loss
        best_loss = torch.where(better, loss, best_loss)
        best_scale = torch.where(better, scale, best_scale)
        best_offset = torch.where(better, offset, best_offset)
    return best_scale, best_offset


def l2loss_tensor(tensor, n_bits: int, signed: bool,
                  allow_offset: bool = True):
    """Clip-range grid search: shrink the min/max range by 1 % a step for
    80 steps, keep the ``(scale, offset)`` of least L2 error."""
    if signed:
        base_max = tensor.abs().max()
        base_min = -base_max
    else:
        base_min = tensor.min() if allow_offset else tensor.new_zeros(())
        base_max = tensor.max()
    return _clip_search(tensor, base_min, base_max, n_bits, signed, None)


def _fixed_point(scale, step):
    """Iterate ``scale ← step(scale)`` while the relative change (the
    ``diff`` that ``step`` returns) exceeds FP_TOL, at most MAX_FP_ITERS
    times; returns the last scale."""
    diff, it = None, 0
    while it < MAX_FP_ITERS and (diff is None or bool(diff > FP_TOL)):
        scale, diff = step(scale)
        it += 1
    return scale


def _rel_change(new, old):
    return (torch.linalg.vector_norm(new - old)
            / torch.clamp_min(torch.linalg.vector_norm(old), _EPS))


def l2norm_tensor(tensor, n_bits: int, signed: bool):
    """Lloyd-Max-style fixed point ``scale ← Σ(x·x_q)/Σ(x_q²)`` until the
    relative change drops below 1e-5."""
    scale, offset = minmax_tensor(tensor, n_bits, signed, allow_offset=True)
    qmin, qmax = get_qrange(signed, n_bits)

    def step(scale):
        q = quantize(tensor, scale, offset, qmin, qmax)
        new = torch.sum(tensor * q) / torch.sum(q * q + 1e-7)
        return new, (new - scale).abs() / torch.clamp_min(scale.abs(), _EPS)

    return _fixed_point(scale, step), offset


def percentile_tensor(tensor, n_bits: int, signed: bool,
                      pct: float = DEFAULT_PCT,
                      allow_offset: bool = True):
    """Percentile-clipped range.  Signed: symmetric at the ``pct``
    percentile of |x|.  Unsigned: affine between the (100 − pct) and pct
    percentiles."""
    t = tensor.reshape(-1)
    if signed:
        qmax = 2 ** (n_bits - 1) - 1
        hi = percentile(t.abs(), pct)
        return torch.clamp_min(_div(hi, qmax), _EPS), torch.zeros_like(hi)
    qmax = 2 ** n_bits - 1
    hi = percentile(t, pct)
    lo = percentile(t, 100.0 - pct) if allow_offset else torch.zeros_like(hi)
    return torch.clamp_min(_div(hi - lo, qmax), _EPS), lo


# ---------------------------------------------------------------------------
# Per-channel observers
# ---------------------------------------------------------------------------

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
        scale = _div(t.abs().amax(dim=1), qmax)
        offset = torch.zeros_like(scale)
    else:
        qmax = 2 ** n_bits - 1
        mn = t.amin(dim=1) if allow_offset else torch.zeros_like(t[:, 0])
        scale = _div(t.amax(dim=1) - mn, qmax)
        offset = mn
    return (_channel_bcast(torch.clamp_min(scale, _EPS), tensor.ndim, ch_axis),
            _channel_bcast(offset, tensor.ndim, ch_axis))


def l2loss_channel(tensor, n_bits: int, signed: bool, ch_axis: int = 0,
                   allow_offset: bool = True):
    """Per-channel 80-step clip grid search, all channels at once."""
    t = _channel_view(tensor, ch_axis)
    if signed:
        base_max = t.abs().amax(dim=1)
        base_min = -base_max
    else:
        base_min = t.amin(dim=1) if allow_offset \
            else torch.zeros_like(t[:, 0])
        base_max = t.amax(dim=1)
    scale, offset = _clip_search(t, base_min, base_max, n_bits, signed, 1)
    return (_channel_bcast(scale, tensor.ndim, ch_axis),
            _channel_bcast(offset, tensor.ndim, ch_axis))


def l2norm_channel(tensor, n_bits: int, signed: bool, ch_axis: int = 0):
    """Per-channel fixed-point L2-optimal scale."""
    qmin, qmax = get_qrange(signed, n_bits)
    t = _channel_view(tensor, ch_axis)
    scale_b, offset_b = minmax_channel(tensor, n_bits, signed, ch_axis)
    offset = offset_b.reshape(-1, 1)

    def step(scale):
        q = quantize(t, scale[:, None], offset, qmin, qmax)
        new = torch.sum(t * q, dim=1) / torch.sum(q * q + 1e-7, dim=1)
        return new, _rel_change(new, scale)

    scale = _fixed_point(scale_b.reshape(-1), step)
    return _channel_bcast(scale, tensor.ndim, ch_axis), offset_b


# ---------------------------------------------------------------------------
# Per-pixel observers (spatial positions of an OIHW conv weight)
# ---------------------------------------------------------------------------

def _pixel_view(tensor):
    """(O, I, *spatial) → (O, I, S) plus the spatial shape."""
    spatial = tuple(tensor.shape[2:]) if tensor.ndim > 2 else (1,)
    return tensor.reshape(tensor.shape[0], tensor.shape[1], -1), spatial


def minmax_pixel(tensor, n_bits: int, signed: bool, allow_offset: bool = True):
    """Per-spatial-position min/max, reduced over out and in channels."""
    t, spatial = _pixel_view(tensor)
    if signed:
        qmax = 2 ** (n_bits - 1) - 1
        scale = _div(t.abs().amax(dim=(0, 1)), qmax)
        offset = torch.zeros_like(scale)
    else:
        qmax = 2 ** n_bits - 1
        mn = t.amin(dim=(0, 1)) if allow_offset \
            else torch.zeros_like(t[0, 0])
        scale = _div(t.amax(dim=(0, 1)) - mn, qmax)
        offset = mn
    shape = (1, 1) + spatial
    return torch.clamp_min(scale, _EPS).reshape(shape), offset.reshape(shape)


def _best_tracking(scale, step, patience: int):
    """:func:`_fixed_point` with ``patience`` iterations at most, returning
    the scale of least error among the iterates it evaluated:
    ``step(scale)`` gives ``(new, diff, err)``, where ``err`` is the error
    at ``scale``; the first of equal errors wins."""
    best_err = torch.full((), float("inf"), device=scale.device)
    best, diff, it = scale, None, 0
    while it < patience and (diff is None or bool(diff > FP_TOL)):
        new, diff, err = step(scale)
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        best = torch.where(better, scale, best)
        scale, it = new, it + 1
    return best


def l2norm_pixel(tensor, n_bits: int, signed: bool,
                 patience: int = MAX_FP_ITERS):
    """Per-pixel fixed-point L2 scale, keeping the iterate of least
    reconstruction error."""
    qmin, qmax = get_qrange(signed, n_bits)
    t, spatial = _pixel_view(tensor)
    scale_b, offset_b = minmax_pixel(tensor, n_bits, signed)
    offset = offset_b.reshape(-1)

    def step(scale):
        q = quantize(t, scale, offset, qmin, qmax)
        err = _sse(q * scale + offset, t)
        new = (torch.sum(t * q, dim=(0, 1))
               / torch.sum(q * q + 1e-7, dim=(0, 1)))
        return new, _rel_change(new, scale), err

    best = _best_tracking(scale_b.reshape(-1), step, patience)
    return best.reshape((1, 1) + spatial), offset_b


# ---------------------------------------------------------------------------
# Output-reconstruction observers: the weight scale of least error in the
# layer's OUTPUT.  ``forward_fn(inputs, weight)`` is the layer's own op
# (conv or linear, bias included) on an OIHW / OI weight; its output has
# the channels on its last axis (NHWC convs, dense layers).
# ---------------------------------------------------------------------------

def l2norm_output(inputs, weight, forward_fn: Callable, n_bits: int,
                  signed: bool, patience: int = 1000):
    """Per-tensor output-reconstruction fixed point:
    ``scale ← <out, out_q>/<out_q, out_q>`` with
    ``out_q = forward_fn(x, quantize(w, scale))``, keeping the scale whose
    output error ``Σ(out − out_q·scale)²`` is least."""
    output = forward_fn(inputs, weight)
    scale, offset = minmax_tensor(weight, n_bits, signed, allow_offset=True)
    qmin, qmax = get_qrange(signed, n_bits)

    def step(scale):
        out_q = forward_fn(inputs, quantize(weight, scale, offset, qmin,
                                            qmax))
        err = _sse(output, out_q * scale)
        new = (torch.mean(out_q * output, dim=0).sum()
               / torch.mean(out_q * out_q + 1e-7, dim=0).sum())
        return (new, (new - scale).abs()
                / torch.clamp_min(scale.abs(), _EPS), err)

    return _best_tracking(scale, step, patience), offset


def l2norm_output_channel(inputs, weight, forward_fn: Callable, n_bits: int,
                          signed: bool, ch_axis: int = 0,
                          patience: int = 1000):
    """Per-output-channel output-reconstruction fixed point.

    The output's channels are its last axis.  The JAX package takes axis
    1 when ``output.shape[1]`` equals the channel count, which for an NHWC
    conv output is H wherever H = C (ROADMAP hazard C17)."""
    output = forward_fn(inputs, weight)
    n_ch = weight.shape[ch_axis]
    o = torch.movedim(output, -1, 1).reshape(output.shape[0], n_ch, -1)
    scale_b, offset_b = minmax_channel(weight, n_bits, signed, ch_axis)
    pshape = scale_b.shape
    qmin, qmax = get_qrange(signed, n_bits)

    def step(scale):
        out_q = forward_fn(inputs, quantize(weight, scale.reshape(pshape),
                                            offset_b, qmin, qmax))
        oq = torch.movedim(out_q, -1, 1).reshape(output.shape[0], n_ch, -1)
        err = _sse(o, oq * scale[None, :, None])
        new = (torch.sum(o * oq, dim=(0, 2))
               / torch.sum(oq * oq + 1e-7, dim=(0, 2)))
        return new, _rel_change(new, scale), err

    best = _best_tracking(scale_b.reshape(-1), step, patience)
    return best.reshape(pshape), offset_b


# ---------------------------------------------------------------------------
# Dispatch by the YAML ``type`` string
# ---------------------------------------------------------------------------

TENSOR_OBSERVERS: Dict[str, Callable] = {
    "minmax_tensor": minmax_tensor,
    "l2loss_tensor": l2loss_tensor,
    "l2norm_tensor": l2norm_tensor,
    "percentile_tensor": percentile_tensor,
    "minmax_channel": minmax_channel,
    "l2loss_channel": l2loss_channel,
    "l2norm_channel": l2norm_channel,
    "minmax_pixel": minmax_pixel,
    "l2norm_pixel": l2norm_pixel,
}

OUTPUT_OBSERVERS: Dict[str, Callable] = {
    "l2norm_output": l2norm_output,
    "l2norm_output_channel": l2norm_output_channel,
}


def get_qparams_tensor(tensor, qtype: str, **kwargs) -> Tuple:
    """String-dispatched tensor observer."""
    try:
        fn = TENSOR_OBSERVERS[qtype]
    except KeyError:
        raise ValueError(
            f"unknown observer {qtype!r}; known: "
            f"{sorted(TENSOR_OBSERVERS)}") from None
    return fn(tensor, **kwargs)


def get_qparams_output(inputs, weight, forward_fn, qtype: str,
                       **kwargs) -> Tuple:
    """String-dispatched output-reconstruction observer."""
    try:
        fn = OUTPUT_OBSERVERS[qtype]
    except KeyError:
        raise ValueError(
            f"unknown output observer {qtype!r}; known: "
            f"{sorted(OUTPUT_OBSERVERS)}") from None
    return fn(inputs, weight, forward_fn, **kwargs)


def is_output_observer(qtype: str) -> bool:
    """Whether ``qtype`` names an output observer ('*output*')."""
    return "output" in qtype


# ---------------------------------------------------------------------------
# Streaming state: statistics over many batches, for the 'observe' passes
# ---------------------------------------------------------------------------

class StreamingState(NamedTuple):
    """Running activation min and max, the sum of the per-batch
    percentiles of |x|, and the number of batches folded."""
    min: torch.Tensor
    max: torch.Tensor
    pct_sum: torch.Tensor
    count: torch.Tensor


def streaming_init(stat_shape=(), device=None) -> StreamingState:
    return StreamingState(
        min=torch.full(stat_shape, float("inf"), device=device),
        max=torch.full(stat_shape, float("-inf"), device=device),
        pct_sum=torch.zeros(stat_shape, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device))


def streaming_update(state: StreamingState, x, ch_axis: Optional[int] = None,
                     pct: Optional[float] = None) -> StreamingState:
    """Fold one batch into the running stats, per tensor or per channel
    along ``ch_axis``.  With ``pct``, add the batch's ``pct`` percentile of
    |x| to ``pct_sum``; without, leave it (the JAX package adds it on
    every update, though only its ``percentile*`` finalize reads it)."""
    if ch_axis is None:
        mn, mx = x.min(), x.max()
    else:
        axes = tuple(d for d in range(x.ndim) if d != ch_axis % x.ndim)
        mn, mx = x.amin(dim=axes), x.amax(dim=axes)
    pct_sum = state.pct_sum
    if pct is not None:
        t = x.abs()
        t = t.reshape(-1) if ch_axis is None else _channel_view(t, ch_axis)
        pct_sum = pct_sum + percentile(t, pct)
    return StreamingState(min=torch.minimum(state.min, mn),
                          max=torch.maximum(state.max, mx),
                          pct_sum=pct_sum, count=state.count + 1)


def streaming_finalize(state: StreamingState, qtype: str, n_bits: int,
                       signed: bool):
    """``(scale, offset)`` from the accumulated stats: ``percentile*`` from
    the mean of the per-batch percentiles of |x| (offset 0, unsigned
    too), anything else from the running min/max."""
    if qtype.startswith("percentile"):
        hi = state.pct_sum / torch.clamp_min(state.count, 1)
        qmax = 2 ** (n_bits - 1) - 1 if signed else 2 ** n_bits - 1
        return torch.clamp_min(_div(hi, qmax), _EPS), torch.zeros_like(hi)
    if signed:
        qmax = 2 ** (n_bits - 1) - 1
        amax = torch.maximum(state.min.abs(), state.max.abs())
        return torch.clamp_min(_div(amax, qmax), _EPS), torch.zeros_like(amax)
    qmax = 2 ** n_bits - 1
    scale = _div(state.max - state.min, qmax)
    return torch.clamp_min(scale, _EPS), state.min
