"""The port's int8 3×3 conv (dlmc_quant_torch/ops/cuda/int8_conv.py) against
the JAX package on the same numpy-seeded inputs.

On the CPU the wrapper runs its plain version; it must give exactly the
codes of the TPU kernel (``rpconv.int8_conv3x3_rm`` in interpret mode, on
the ``tests/test_rpconv.py`` shapes) and of ``jax.lax.conv_general_dilated``
with the pad code and the same epilogue (stride 2, C = 3, odd sizes,
"f32" mode).  Tolerance: exact equality of codes and of f32 outputs, since
both sides compute an exact int32 accumulator and the same two f32 ops.
The kernel itself runs only on the card: the tests marked ``cuda`` hold it
against the plain version there (ragged shapes, every compiled tile, both
modes, tolerance 0) and skip here.  JAX is imported inside
the helpers that use it, so that test also runs where JAX is absent:
``python -m pytest tests/test_torch_int8_conv.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from dlmc_quant_torch.ops.cuda.int8_conv import (int8_conv3x3,
                                                 int8_conv3x3_plain,
                                                 pack_weight, unpack_weight)

torch.set_num_threads(1)


def _inputs(seed, n, h, w, c, o):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)
    wk = rng.integers(-128, 128, (3, 3, c, o), dtype=np.int8)
    a = (np.abs(rng.standard_normal(o)) * 1e-3 + 1e-4).astype(np.float32)
    b = (rng.standard_normal(o) * 2.0).astype(np.float32)
    return x, wk, a, b


def _port(x, wk, a, b, **kw):
    out = int8_conv3x3(torch.from_numpy(x), pack_weight(torch.from_numpy(wk)),
                       torch.from_numpy(a), torch.from_numpy(b), **kw)
    return out.numpy()


def _jax_ref(x, wk, a, b, stride, pad, lo, hi, mode, relu=False):
    import jax
    import jax.numpy as jnp
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)),
                 constant_values=jnp.int8(pad))
    acc = jax.lax.conv_general_dilated(
        xp, jnp.asarray(wk), (stride, stride), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * jnp.asarray(a) + jnp.asarray(b)
    if mode == "codes":
        return np.asarray(jnp.clip(jnp.round(y), lo, hi).astype(jnp.int8))
    return np.asarray(jnp.maximum(y, 0.0) if relu else y)


def _rpconv(x, wk, a, b, relu, zp, bm=128):
    import jax.numpy as jnp
    from dlmc_quant_tpu.ops.pallas.rpconv import (
        from_rm, hwio_to_dxg, int8_conv3x3_rm, rm_mask, to_rm)
    n, h, w, c = x.shape
    o = wk.shape[-1]
    out = int8_conv3x3_rm(
        to_rm(jnp.asarray(x), zp, bm), hwio_to_dxg(jnp.asarray(wk)),
        jnp.asarray(a), jnp.asarray(b), rm_mask(n, h, w, bm), zp,
        c=c, o=o, wp=w + 1, bm=bm, relu=relu, interpret=True)
    return np.asarray(from_rm(out, n, h, w, o, bm))


class TestAgainstRpconv:
    @pytest.mark.parametrize("shape,relu", [
        ((2, 14, 14, 8, 16), True),
        ((1, 7, 7, 16, 8), True),
        ((3, 10, 6, 8, 8), True),
        ((2, 8, 8, 8, 8), False),
    ])
    def test_codes_equal(self, shape, relu):
        x, wk, a, b = _inputs(0, *shape)
        zp = -7 if relu else 3
        want = _rpconv(x, wk, a, b, relu, zp)
        got = _port(x, wk, a, b, stride=1, pad=zp, lo=0 if relu else -128,
                    hi=127, mode="codes")
        np.testing.assert_array_equal(got, want)

    def test_chains_two_layers(self):
        """Two chained layers: the first layer's codes feed the second."""
        n, h, w, c = 2, 8, 8, 8
        rng = np.random.default_rng(5)
        x = rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)
        w1 = rng.integers(-128, 128, (3, 3, c, c), dtype=np.int8)
        w2 = rng.integers(-128, 128, (3, 3, c, c), dtype=np.int8)
        a1, b1 = np.full(c, 2e-3, np.float32), np.zeros(c, np.float32)
        a2, b2 = np.full(c, 1e-3, np.float32), np.ones(c, np.float32)
        zp = -7
        want = _rpconv(_rpconv(x, w1, a1, b1, True, zp), w2, a2, b2, True, zp)
        y1 = _port(x, w1, a1, b1, stride=1, pad=zp, lo=0, hi=127)
        got = _port(y1, w2, a2, b2, stride=1, pad=zp, lo=0, hi=127)
        np.testing.assert_array_equal(got, want)


class TestAgainstXlaConv:
    @pytest.mark.parametrize("n,h,w,c,o,stride,lo", [
        (2, 7, 7, 3, 16, 2, -5),     # stem-like: C = 3, odd 7x7 -> 4x4
        (1, 9, 6, 12, 8, 2, -128),   # stride 2, non-square, no ReLU
        (2, 5, 5, 20, 70, 1, -20),   # O over one 64-channel tile
    ])
    def test_codes_equal(self, n, h, w, c, o, stride, lo):
        x, wk, a, b = _inputs(1, n, h, w, c, o)
        want = _jax_ref(x, wk, a, b, stride, lo, lo, 127, "codes")
        got = _port(x, wk, a, b, stride=stride, pad=lo, lo=lo, hi=127,
                    mode="codes")
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("relu", [True, False])
    def test_f32_mode_equal(self, relu):
        x, wk, a, b = _inputs(2, 2, 7, 7, 3, 48)
        want = _jax_ref(x, wk, a, b, 2, 4, 0, 0, "f32", relu)
        got = _port(x, wk, a, b, stride=2, pad=4, mode="f32", relu=relu)
        assert got.dtype == np.float32 and got.shape == (2, 4, 4, 48)
        np.testing.assert_array_equal(got, want)


class TestWrapper:
    def _args(self):
        x, wk, a, b = _inputs(3, 1, 5, 5, 8, 8)
        return (torch.from_numpy(x), pack_weight(torch.from_numpy(wk)),
                torch.from_numpy(a), torch.from_numpy(b))

    def test_pack_roundtrip(self):
        for c, o in ((3, 48), (8, 16), (13, 70)):
            wk = torch.from_numpy(_inputs(4, 1, 1, 1, c, o)[1])
            assert torch.equal(unpack_weight(pack_weight(wk), c, o), wk)

    @pytest.mark.parametrize("bad", [
        "x_dtype", "w_shape", "x_noncontig", "a_dtype", "stride", "mode",
        "pad_range", "relu_codes"])
    def test_raises(self, bad):
        x, w, a, b = self._args()
        kw = dict(stride=1, pad=0, lo=-128, hi=127, mode="codes")
        if bad == "x_dtype":
            x = x.to(torch.int32)
        elif bad == "w_shape":
            w = w[:-1]
        elif bad == "x_noncontig":
            x = x.transpose(1, 2)
        elif bad == "a_dtype":
            a = a.double()
        elif bad == "stride":
            kw["stride"] = 3
        elif bad == "mode":
            kw["mode"] = "int32"
        elif bad == "pad_range":
            kw["pad"] = 200
        elif bad == "relu_codes":
            kw["relu"] = True
        with pytest.raises(ValueError):
            int8_conv3x3(x, w, a, b, **kw)

    def test_cpu_counts_no_launch(self):
        before = int8_conv3x3.launches
        int8_conv3x3(*self._args(), stride=1, pad=0)
        assert int8_conv3x3.launches == before


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for shape, stride in (((2, 15, 9, 3, 48), 2), ((2, 14, 14, 64, 96), 1)):
        x, wk, a, b = (torch.from_numpy(t).cuda()
                       for t in _inputs(6, *shape))
        w = pack_weight(wk)
        for mode in ("codes", "f32"):
            kw = dict(stride=stride, pad=-3, lo=-3, hi=127, mode=mode)
            got = int8_conv3x3(x, w, a, b, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, int8_conv3x3_plain(x, w, a, b, **kw))


# (n, h, w, c, o, stride, pad, lo, plan overrides): C in {3, 5, 16, 48, 96,
# 192}, O in {8, 48, 70, 96, 192, 300, 1280}, 7x7, 15x9, 14x14 and 56x56, M a
# multiple of 128 and not, pad codes -128, -3, 0, 5, lo folded (= pad) and
# not; C = 192 is 14 K chunks, three and a half turns of a 4-stage ring.
CARD_CASES = [
    (2, 7, 7, 3, 8, 1, -128, -128, None),
    (3, 15, 9, 3, 48, 2, -3, -3, None),
    (2, 15, 9, 5, 70, 1, 5, -128, None),
    (2, 14, 14, 16, 96, 1, 0, 0, None),
    (8, 56, 56, 48, 48, 1, -3, -3, None),            # M = 196 * 128
    (8, 56, 56, 48, 48, 1, -3, -3, dict(resident=False, stages=5)),
    (3, 56, 56, 48, 96, 2, -128, -128, None),
    (2, 14, 14, 96, 192, 1, 5, 5, None),
    (2, 14, 14, 96, 96, 1, 5, -128, dict(stages=6)),
    (4, 14, 14, 192, 192, 1, -3, -3, None),
    (4, 14, 14, 96, 96, 1, -3, -3, dict(resident=False)),
    (4, 14, 14, 96, 96, 1, -3, -3, dict(halo_bufs=0)),
    (8, 56, 56, 48, 48, 1, 5, -128, dict(halo_bufs=1)),
    (40, 14, 14, 96, 192, 1, 0, 0, dict(halo_bufs=2, resident=False)),
    (32, 14, 14, 192, 192, 1, 0, -128, dict(stages=4)),  # M = 49 * 128
    (32, 14, 14, 48, 48, 1, 0, -128, dict(stages=6, halo_bufs=2)),
    (2, 14, 14, 192, 1280, 2, 0, 0, None),
    (1, 7, 7, 192, 300, 1, -128, -128, None),
    (2, 15, 9, 96, 300, 2, -3, -128, None),
    (2, 9, 9, 16, 7, 1, 5, -128, None),              # odd O
    # several tiles a block: the halo buffers and the ring turn over
    (64, 56, 56, 48, 48, 1, -3, -3, None),           # 1568 tiles, 1 halo
    (96, 28, 28, 96, 96, 1, 0, -128, None),          # 588 tiles, 2 halos
    (300, 14, 14, 192, 192, 1, 5, 5, None),          # 460 tiles, last ragged
    (300, 14, 14, 192, 192, 2, 5, 5, None),          # the same, gathered
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["codes", "f32"])
@pytest.mark.parametrize(
    "case", CARD_CASES,
    ids=[f"{c[0]}x{c[1]}x{c[2]}x{c[3]}-{c[4]}-s{c[5]}-p{c[6]}"
         + ("" if c[8] is None else "-" + "-".join(
             f"{k}{int(v)}" for k, v in c[8].items())) for c in CARD_CASES])
def test_kernel_matches_plain_at_ragged_shapes(case, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n, h, w, c, o, stride, pad, lo, plan = case
    x, wk, a, b = (torch.from_numpy(t).cuda()
                   for t in _inputs(7, n, h, w, c, o))
    wp = pack_weight(wk)
    kw = dict(stride=stride, pad=pad, mode=mode)
    if mode == "codes":
        kw.update(lo=lo, hi=127)
    else:
        kw.update(relu=lo == pad)
    got = int8_conv3x3(x, wp, a, b, _plan=plan, **kw)
    torch.cuda.synchronize()
    want = int8_conv3x3_plain(x, wp, a, b, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)
