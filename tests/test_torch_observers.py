"""The port's PTQ observers against the JAX package's, on the same numpy
inputs made from a seed (the cases of tests/test_observers.py: outliers,
unsigned with and without an offset, weights, channel axis 1, pixels,
output quality).

Tolerances:
* minmax (tensor, channel, pixel): exact;
* percentile: rtol 1e-6 against the JAX function run with 64-bit types on
  (its interpolation index then in float64, as the port forms it), and
  against the JAX function as it runs by default rtol 1e-4, plus the gap
  between the neighbouring order statistics times the float32 index's
  error (ROADMAP hazard C15: an outlier next to the percentile magnifies
  that error);
* l2loss: the same candidate scale (rtol 1e-6) wherever the best candidate
  wins by more than 1e-4 of relative SSE, else the achieved SSE within
  rtol 1e-5 (two candidates that close may swap on the sums' rounding);
* l2norm (tensor, channel, pixel): the scale and the achieved SSE within
  rtol 1e-4: the fixed point settles on the scale that its codes give, and
  one code flipped by the sums' rounding (C2) moves that scale by 1e-5 and
  more, and a channel's SSE of 128 values by 1.3e-5 (measured on the CPU);
* output observers: rtol 1e-4 (the conv's or matmul's own sums differ).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from dlmc_quant_tpu.ops import observers as J
from dlmc_quant_torch.ops import observers as T

torch.set_num_threads(1)


def _case(name):
    """(tensor, observer kwargs, channel axis); the first three are (rows,
    columns) so that the channel observers see 32 or 16 channels."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "outliers":
        x = rng.standard_normal((32, 128)).astype(np.float32)
        x[0, 0] = 50.0
        return x, dict(n_bits=4, signed=True), 0
    if name == "unsigned":
        x = (rng.random((16, 128)) * 4).astype(np.float32)
        x[0, 0] = 100.0
        return x, dict(n_bits=8, signed=False), 0
    if name == "no_offset":
        x = (rng.random((16, 128)) * 4 + 0.5).astype(np.float32)
        return x, dict(n_bits=8, signed=False, allow_offset=False), 0
    if name == "weights":
        return (rng.standard_normal((16, 8, 3, 3)).astype(np.float32),
                dict(n_bits=4, signed=True), 0)
    # channel axis 1 of an activation-like tensor, unsigned with an offset
    return (rng.standard_normal((4, 8, 5, 5)).astype(np.float32) + 0.3,
            dict(n_bits=8, signed=False), 1)


def _takes(name, kw):
    """Whether observer ``name`` takes every keyword of ``kw``."""
    return "allow_offset" not in kw or not name.startswith("l2norm")


TENSOR_CASES = [(name, case) for name in sorted(J.TENSOR_OBSERVERS)
                for case in ("outliers", "unsigned", "no_offset", "weights",
                             "channel_axis1")
                if _takes(name, _case(case)[1])]


def _reduce_axes(ndim, ch_axis):
    return tuple(d for d in range(ndim) if d != ch_axis)


def _sse64(x, s, o, kw, ch_axis):
    """The reconstruction SSE of (s, o) in float64, per channel or whole."""
    qmax = 2 ** (kw["n_bits"] - 1) - 1 if kw["signed"] \
        else 2 ** kw["n_bits"] - 1
    qmin = -qmax if kw["signed"] else 0
    x, s, o = (np.asarray(a, np.float64) for a in (x, s, o))
    # a pixel observer's (1, 1, 1) stats against a 2-D tensor
    s, o = (a.reshape(a.shape[a.ndim - x.ndim:]) if a.ndim > x.ndim else a
            for a in (s, o))
    q = np.clip(np.round((x - o) / s), qmin, qmax)
    return ((q * s + o - x) ** 2).sum(axis=_reduce_axes(x.ndim, ch_axis))


def _l2loss_margin(x, kw, ch_axis):
    """How far the best of the 80 candidates beats the runner-up, as
    relative SSE (per channel, or of the whole tensor)."""
    axes = _reduce_axes(x.ndim, ch_axis)
    levels = (2 ** kw["n_bits"] - 2) if kw["signed"] \
        else 2 ** kw["n_bits"] - 1
    if kw["signed"]:
        hi = np.abs(x).max(axis=axes, keepdims=True)
        lo = -hi
    else:
        hi = x.max(axis=axes, keepdims=True)
        lo = x.min(axis=axes, keepdims=True) \
            if kw.get("allow_offset", True) else np.zeros_like(hi)
    losses = []
    for i in range(J.GRID_STEPS):
        f = np.float32(1) - np.float32(0.01) * np.float32(i)
        s = np.maximum((f * hi - f * lo) / np.float32(levels), 1e-9)
        losses.append(_sse64(x, s, 0 if kw["signed"] else f * lo, kw,
                             ch_axis))
    losses = np.sort(np.stack(losses), axis=0)
    return (losses[1] - losses[0]) / losses[0]


@pytest.mark.parametrize("name,case", TENSOR_CASES)
def test_tensor_observer_matches_jax(name, case):
    x, kw, ch_axis = _case(case)
    if "channel" in name:
        kw = dict(kw, ch_axis=ch_axis)
    js, jo = (np.asarray(a) for a in J.get_qparams_tensor(jnp.asarray(x),
                                                           name, **kw))
    ts, to = (a.numpy() for a in T.get_qparams_tensor(torch.from_numpy(x),
                                                      name, **kw))
    assert ts.shape == js.shape and to.shape == jo.shape
    if name.startswith("minmax"):
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(to, jo)
    elif name.startswith("percentile"):
        with jax.enable_x64(True):
            xs, xo = J.percentile_tensor(jnp.asarray(x), **kw)
        np.testing.assert_allclose(ts, np.asarray(xs), rtol=1e-6)
        np.testing.assert_allclose(to, np.asarray(xo), rtol=1e-6)
        slack = _c15_slack(x, kw)
        np.testing.assert_allclose(ts, js, rtol=1e-4, atol=slack)
        np.testing.assert_allclose(to, jo, rtol=1e-4, atol=slack)
    elif name.startswith("l2norm"):
        axis = ch_axis if "channel" in name else None
        np.testing.assert_allclose(_sse64(x, ts, to, kw, axis),
                                   _sse64(x, js, jo, kw, axis), rtol=1e-4)
        np.testing.assert_allclose(ts, js, rtol=1e-4)
        np.testing.assert_array_equal(to, jo)
    else:
        axis = ch_axis if "channel" in name else None
        clear = np.reshape(_l2loss_margin(x, kw, axis) > 1e-4, -1)
        got = np.reshape(_sse64(x, ts, to, kw, axis), -1)
        want = np.reshape(_sse64(x, js, jo, kw, axis), -1)
        np.testing.assert_allclose(got[~clear], want[~clear], rtol=1e-5)
        for a, b in ((ts, js), (to, jo)):
            shape = np.broadcast_shapes(a.shape, b.shape, (len(clear),)
                                        if axis is None else a.shape)
            a, b = (np.broadcast_to(v, shape).reshape(-1) for v in (a, b))
            np.testing.assert_allclose(a[clear], b[clear], rtol=1e-6)


def _c15_slack(x, kw):
    """How far a float32 interpolation index can move the percentile: the
    gap between the order statistics around the index, times the index's
    relative error (a float32 product of n − 1 and pct/100), times n."""
    pct = kw.get("pct", 99.99)
    a = np.sort((np.abs(x) if kw["signed"] else x).reshape(-1)
                .astype(np.float64))
    n, slack = len(a), 0.0
    for p in (pct, 100 - pct):
        idx = int(p / 100 * (n - 1))
        gap = a[min(idx + 2, n - 1)] - a[max(idx - 1, 0)]
        slack += gap * n * 2.0 ** -22
    qmax = 2 ** (kw["n_bits"] - 1) - 1 if kw["signed"] \
        else 2 ** kw["n_bits"] - 1
    return slack / qmax + slack


def test_search_observers_beat_minmax():
    """tests/test_observers.py's quality contracts hold in the port."""
    x, kw, _ = _case("outliers")
    t = torch.from_numpy(x)
    mm = T.minmax_tensor(t, **kw)
    for fn in (T.l2loss_tensor, T.l2norm_tensor):
        assert _sse64(x, *fn(t, **kw), kw, None) \
            < _sse64(x, *mm, kw, None)
    w, kw, _ = _case("weights")
    w[0, 0, 0, 0] = 30.0
    tw = torch.from_numpy(w)
    mm = T.minmax_channel(tw, **kw)
    for fn in (T.l2loss_channel, T.l2norm_channel):
        assert (_sse64(w, *fn(tw, **kw), kw, 0)
                <= _sse64(w, *mm, kw, 0) + 1e-6).all()
    s, _ = T.percentile_tensor(t, 8, True, pct=99.9)
    assert float(s) < float(T.minmax_tensor(t, 8, True)[0]) / 10


def _dense(lib):
    return lambda x, w: x @ w.T


def _conv(lib, bias):
    """An NHWC 3×3 SAME conv with bias on an OIHW weight, in each
    framework, as the layers' ``forward_oi``."""
    if lib is torch:
        b = torch.from_numpy(bias)
        return lambda x, w: torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), w, b, padding=1).permute(0, 2, 3, 1)
    return lambda x, w: lax.conv_general_dilated(
        x, jnp.transpose(w, (2, 3, 1, 0)), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias


def _output_case(kind, h=6):
    rng = np.random.default_rng(11)
    if kind == "dense":
        x = rng.standard_normal((32, 64)).astype(np.float32)
        w = rng.standard_normal((16, 64)).astype(np.float32)
        return x, w, _dense(torch), _dense(jnp)
    x = rng.standard_normal((2, h, 7, 5)).astype(np.float32)
    w = rng.standard_normal((8, 5, 3, 3)).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    return x, w, _conv(torch, bias), _conv(jnp, bias)


@pytest.mark.parametrize("name", sorted(J.OUTPUT_OBSERVERS))
@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_output_observer_matches_jax(name, kind):
    """Output channels on the last axis (H = 6 ≠ C = 8 for the conv)."""
    x, w, tfwd, jfwd = _output_case(kind)
    js, jo = J.get_qparams_output(jnp.asarray(x), jnp.asarray(w), jfwd, name,
                                  n_bits=4, signed=True)
    ts, to = T.get_qparams_output(torch.from_numpy(x), torch.from_numpy(w),
                                  tfwd, name, n_bits=4, signed=True)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    if kind == "conv":
        return
    # the quality contract of tests/test_observers.py (dense, no bias)
    qs = T.minmax_tensor(torch.from_numpy(w), 4, True)[0] \
        if name == "l2norm_output" \
        else T.minmax_channel(torch.from_numpy(w), 4, True)[0]
    tw, out = torch.from_numpy(w), tfwd(torch.from_numpy(x),
                                        torch.from_numpy(w))

    def err(s):
        return float(((tfwd(torch.from_numpy(x),
                            torch.clamp(torch.round(tw / s), -7, 7) * s)
                       - out) ** 2).sum())

    assert err(ts) <= err(qs) * 1.05


def test_output_channel_axis_is_last():
    """At H = C the JAX package reduces over H of an NHWC output (ROADMAP
    hazard C17); the port reduces over the channels, as the JAX function
    does on the same output flattened to (N·H·W, C)."""
    x, w, tfwd, jfwd = _output_case("conv", h=8)
    ts, _ = T.l2norm_output_channel(torch.from_numpy(x), torch.from_numpy(w),
                                    tfwd, 4, True)
    flat, _ = J.l2norm_output_channel(
        jnp.asarray(x), jnp.asarray(w),
        lambda a, b: jfwd(a, b).reshape(-1, 8), 4, True)
    np.testing.assert_allclose(ts.numpy(), np.asarray(flat), rtol=1e-4)
    on_h, _ = J.l2norm_output_channel(jnp.asarray(x), jnp.asarray(w), jfwd,
                                      4, True)
    assert not np.allclose(np.asarray(on_h), ts.numpy(), rtol=1e-2)


def test_percentile_past_torch_quantile_limit(monkeypatch):
    """2²⁴ + 1 elements: torch.quantile refuses them, the port's percentile
    (order statistics, a float64 index) equals numpy's on the sorted
    values."""
    n = 2 ** 24 + 1
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(n)
                         .astype(np.float32))
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(x, 0.5)
    monkeypatch.setattr(torch, "quantile", None)   # never called
    s, o = T.percentile_tensor(x, 8, False, pct=99.99)
    xs = np.sort(x.numpy()).astype(np.float64)

    def ref(p):
        idx = p / 100 * (n - 1)
        lo = int(np.floor(idx))
        return xs[lo] + (xs[min(lo + 1, n - 1)] - xs[lo]) * (idx - lo)

    np.testing.assert_allclose(float(o), ref(100 - 99.99), rtol=1e-6)
    np.testing.assert_allclose(float(s) * 255, ref(99.99) - ref(100 - 99.99),
                               rtol=1e-6)


STREAMS = [("minmax_tensor", None), ("minmax_channel", 1),
           ("minmax_channel", 3), ("percentile_tensor", None),
           ("percentile_tensor", 1), ("percentile_tensor", 3)]


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("qtype,ch_axis", STREAMS)
def test_stream_matches_jax(qtype, ch_axis, signed):
    """Three batches folded into a stream, per tensor or per channel (axis
    1, or the NHWC last axis), finalized as min/max or as the mean of the
    per-batch 99.99 percentiles of |x|."""
    batches = np.random.default_rng(16).standard_normal(
        (3, 4, 6, 5, 5)).astype(np.float32) + 0.2
    shape = () if ch_axis is None else (batches.shape[1 + ch_axis],)
    pct = 99.99 if qtype.startswith("percentile") else None
    jst, tst = J.streaming_init(shape), T.streaming_init(shape)
    for b in batches:
        jst = J.streaming_update(jst, jnp.asarray(b), ch_axis=ch_axis)
        tst = T.streaming_update(tst, torch.from_numpy(b), ch_axis, pct)
    assert int(tst.count) == 3
    js, jo = J.streaming_finalize(jst, qtype, 8, signed)
    ts, to = T.streaming_finalize(tst, qtype, 8, signed)
    assert ts.shape == shape
    if pct is None:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert not tst.pct_sum.any()           # no percentile without pct
    else:
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_stream_takes_the_configured_percentile():
    """The port streams the percentile it is given (the JAX package's layers
    always stream 99.99, ROADMAP hazard C16): 99.9 clips lower."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (8, 16, 16, 4)).astype(np.float32))
    scales = []
    for pct in (99.99, 99.9):
        st = T.streaming_update(T.streaming_init(), x, pct=pct)
        scales.append(float(T.streaming_finalize(st, "percentile_tensor", 8,
                                                 False)[0]))
    assert scales[1] < scales[0] * 0.95


def test_registries_match_jax():
    assert set(T.TENSOR_OBSERVERS) == set(J.TENSOR_OBSERVERS)
    assert set(T.OUTPUT_OBSERVERS) == set(J.OUTPUT_OBSERVERS)
    assert (T.GRID_STEPS, T.MAX_FP_ITERS, T.FP_TOL) == \
        (J.GRID_STEPS, J.MAX_FP_ITERS, J.FP_TOL)
    for name in list(T.TENSOR_OBSERVERS) + list(T.OUTPUT_OBSERVERS):
        assert T.is_output_observer(name) == J.is_output_observer(name)
    with pytest.raises(ValueError, match="unknown output observer"):
        T.get_qparams_output(None, None, None, "minmax_tensor")
