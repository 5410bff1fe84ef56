"""The port's RootQ math and custom-gradient estimators against the JAX
package: every function of ``ops/rootq_math.py``, ``uniform_q`` and
``lsq_q``, forward and gradients (``jax.grad`` against autograd) on the
same seeded float32 inputs, within 1e-6 relative (of the largest
magnitude of the JAX value).  A scalar operand (a bound, a scale, alpha)
is given as an array of the input's shape, so that each element's
gradient is compared before any sum: a sum over the elements differs
between the packages by its order alone (2e-6 relative at 96 terms).
``lsq_q``'s scale gradient is a sum by definition; it is held to 1e-6 of
the sum of its terms' magnitudes.

The inputs hold the points where the estimators have corners: values on
the clip bounds and just outside them, bin midpoints (where ``sgn`` sees 0
and lands on the midpoint, as in both packages), bin edges, and ``alpha``
below, at and above its clamps ``[1e-4, 1]``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlmc_quant_tpu.ops import numerics as jnum
from dlmc_quant_tpu.ops import rootq_math as jrq
from dlmc_quant_torch.ops import numerics as tnum
from dlmc_quant_torch.ops import rootq_math as trq

QMIN, QMAX = -7, 7
UPPER, LOWER = 0.9, -0.7
ALPHAS = [-0.5, 1e-4, 0.25, 1.0, 1.7]


def _close(got, want, rtol=1e-6):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _points(seed=0, n=64):
    """Random values plus the corners of the weight grid."""
    delta = (UPPER - LOWER) / (QMAX - QMIN)
    k = np.arange(QMAX - QMIN)
    corners = np.concatenate([
        [UPPER, LOWER, UPPER + 1e-3, LOWER - 1e-3, 0.0],
        LOWER + (k + 0.5) * delta,          # bin midpoints
        LOWER + k[1:] * delta])             # bin edges
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-1.2, 1.2, n), corners]) \
        .astype(np.float32)


def _cot(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port_grads(fn, *arrays):
    """(output, gradients) of sum(fn(*arrays)·cotangent) by autograd."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    (out * torch.from_numpy(_cot(out.shape))).sum().backward()
    return out, [t.grad for t in ts]


def _jax_grads(fn, *arrays):
    js = [jnp.asarray(a) for a in arrays]
    out = fn(*js)
    cot = jnp.asarray(_cot(out.shape))
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * cot),
                     argnums=tuple(range(len(js))))(*js)
    return out, grads


def _check(tfn, jfn, *arrays):
    out, grads = _port_grads(tfn, *arrays)
    jout, jgrads = _jax_grads(jfn, *arrays)
    _close(out, jout)
    for g, jg in zip(grads, jgrads):
        if g is None:       # detached in the port, stop_gradient in JAX
            assert not np.asarray(jg).any()
        else:
            _close(g, jg)


def _full(x, value):
    return np.full(x.shape, value, np.float32)


def test_clipping_matches_jax():
    x = _points()
    _check(trq.clipping, jrq.clipping, x, _full(x, UPPER), _full(x, LOWER))


@pytest.mark.parametrize("alpha", ALPHAS)
def test_clamp_alpha_matches_jax(alpha):
    _check(trq.clamp_alpha, jrq.clamp_alpha, np.float32(alpha))


@pytest.mark.parametrize("alpha", ALPHAS)
def test_phi_matches_jax(alpha):
    """``mi`` a detached midpoint array, as the weight path passes it."""
    x = _points()
    delta = np.float32((UPPER - LOWER) / (QMAX - QMIN))
    mi = (np.floor((x - LOWER) / delta) + 0.5) * delta + LOWER
    mi = mi.astype(np.float32)
    mi[:8] = x[:8]                      # d = 0 exactly
    _check(lambda a, m, al, d: trq.phi(a, m.detach(), al, d),
           lambda a, m, al, d: jrq.phi(a, jax.lax.stop_gradient(m), al, d),
           x, mi, _full(x, alpha), _full(x, delta))


def test_sgn_matches_jax():
    x = _points()
    x[:4] = 0.0
    _check(trq.sgn, jrq.sgn, x)


def test_bin_dequantize_matches_jax():
    rng = np.random.default_rng(3)
    s = rng.choice([-1.0, 0.0, 1.0], 40).astype(np.float32)
    interval = rng.integers(0, QMAX - QMIN, 40).astype(np.float32)
    delta = np.float32((UPPER - LOWER) / (QMAX - QMIN))
    _check(trq.bin_dequantize, jrq.bin_dequantize, s, _full(s, LOWER),
           _full(s, delta), interval)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_rootq_weight_fake_quant_matches_jax(alpha):
    w = _points()

    def port(w_, u, lo, a):
        return trq.rootq_weight_fake_quant(w_, u, lo, a, QMIN, QMAX)

    def ref(w_, u, lo, a):
        return jrq.rootq_weight_fake_quant(w_, u, lo, a, QMIN, QMAX)

    _check(port, ref, w, _full(w, UPPER), _full(w, LOWER), _full(w, alpha))


def test_rootq_act_fake_quant_matches_jax():
    """On the unsigned grid of 15 levels whatever the sign (C4)."""
    scale = np.float32(0.11)
    x = np.concatenate([_points(5), [0.0, -1e-3, scale * 14, scale * 14.5,
                                     scale * 3.5, scale * 2]]) \
        .astype(np.float32)
    _check(lambda a, s: trq.rootq_act_fake_quant(a, s, QMAX, QMIN),
           lambda a, s: jrq.rootq_act_fake_quant(a, s, QMAX, QMIN),
           x, _full(x, scale))


@pytest.mark.parametrize("offset", [0.0, 0.05])
def test_uniform_q_matches_jax(offset):
    """Gradient to x only inside the clip range, none to scale or offset."""
    scale = np.float32(0.1)
    x = np.concatenate([_points(7), [QMAX * 0.1 + offset,
                                     QMIN * 0.1 + offset]]).astype(np.float32)
    out, grads = _port_grads(
        lambda a, s, o: tnum.uniform_q(a, s, o, QMIN, QMAX), x, scale,
        np.float32(offset))
    jout, jgrads = _jax_grads(
        lambda a, s, o: jnum.uniform_q(a, s, o, QMIN, QMAX), x, scale,
        np.float32(offset))
    _close(out, jout)
    _close(grads[0], jgrads[0])
    assert grads[1] is None and grads[2] is None
    assert float(jgrads[1]) == 0.0 and float(jgrads[2]) == 0.0


@pytest.mark.parametrize("g", [1.0, 0.0625])
def test_lsq_q_matches_jax(g):
    scale = np.float32(0.1)
    x = np.concatenate([_points(9), [0.7, -0.7, 0.05, 0.15]]) \
        .astype(np.float32)
    out, (dx, ds) = _port_grads(lambda a, s: tnum.lsq_q(a, s, QMIN, QMAX, g),
                                x, scale)
    jout, (jdx, jds) = _jax_grads(
        lambda a, s: jnum.lsq_q(a, s, QMIN, QMAX, g), x, scale)
    _close(out, jout)
    _close(dx, jdx)
    t = x / scale
    r = np.where(t < QMIN, QMIN, np.where(t > QMAX, QMAX, np.round(t) - t))
    terms = np.abs(_cot(x.shape) * r).sum() * g
    assert abs(float(ds) - float(jds)) <= 1e-6 * terms
