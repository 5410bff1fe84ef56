"""MobileNetV2 at width 0.75 in the port against the JAX package, and the
depthwise path at channel counts that are not multiples of 16.

``cifar_mobilenet_v2(width_mult=0.75)`` has a 24-channel stem, so its first
depthwise conv has C = 24 (``_make_divisible(·, 8)`` gives multiples of 8).
On JAX's calibrated and deployed variables (``load_jax_variables``), 32×32,
batch 2, bench.py's W8A8 scheme, BN statistics and affine perturbed, as
``tests/test_torch_mobile.py`` builds its width-1.0 case:

* every deploy conv fed JAX's input: its accumulator exact, its epilogue
  exact on codes inputs and within 1e-6 elsewhere;
* every ``intc`` block output fed JAX's input at most one code from JAX's
  (C2) on at most 0.1 % of the codes; the deploy form's ``int`` logits
  within relative L2 2e-2 of JAX's and its ``intc`` logits within 5e-2,
  the bound ``tests/test_torch_mobile.py`` gives this chaotic net at random
  weights (its docstring says why);
* one ``intc`` request makes 1 conv, 39 GEMM and 17 depthwise launches, the
  first depthwise one at C = 24.

The plain depthwise version at C = 20 and C = 3 equals JAX's grouped int32
conv and its folded quantize exactly (``tests/test_torch_dwconv.py``'s
``test_raises`` holds the kernel's own check, off the CPU route, to C %
8 == 0).
"""

import numpy as np
import pytest
import torch

from dlmc_quant_torch.ops.cuda import int8_dwconv as D
from dlmc_quant_torch.quant import chain
from dlmc_quant_torch.quant.chain import DeferredEpilogue, PendingDwConv
from dlmc_quant_torch.quant.layers import QConv
from dlmc_quant_torch.utils.launches import LaunchRecorder

from test_torch_dwconv import (INV_S, PAD, QBIAS, QMAX_S, QMIN_S, _jax_acc,
                               _operands, _pads)
from test_torch_mobile import _images, make_case
from test_torch_mobile import \
    test_intc_blocks_and_logits_match_jax as _blocks_and_logits_match_jax
from test_torch_mobile import \
    test_intc_convs_match_jax_on_its_inputs as _convs_match_jax

torch.set_num_threads(1)

WIDTH = 0.75


@pytest.fixture(scope="module")
def case():
    return make_case("mobilenet", WIDTH)


def test_width_has_a_24_channel_depthwise_conv(case):
    convs = [m for m in case["port"].modules()
             if isinstance(m, QConv) and m.depthwise]
    assert len(convs) == 17 and convs[0].weight.shape[0] == 24
    assert all(m.weight.shape[0] % 8 == 0 for m in convs)


def test_intc_convs_match_jax_on_their_inputs(case):
    _convs_match_jax(case)


def test_intc_blocks_and_logits_match_jax(case):
    _blocks_and_logits_match_jax(case)


def test_request_launches(case):
    with torch.no_grad(), LaunchRecorder() as rec:
        case["port"](torch.from_numpy(_images(4, case["size"])),
                     qmode="intc")
    assert rec.counts() == case["launches"]
    first = next(args[0] for kind, args, _, _ in rec.calls
                 if kind == "dwconv")
    assert first.shape[-1] == 24


@pytest.mark.parametrize("c", [20, 3])
@pytest.mark.parametrize("stride,padding", [(1, 1), (2, "SAME")])
def test_plain_takes_any_channels(c, stride, padding):
    """The plain version on the chain at C % 8 != 0: JAX's grouped int32
    conv and its folded quantize, exactly (identical int8 and float32
    inputs)."""
    import jax.numpy as jnp
    from dlmc_quant_tpu.quant import chain as jchain
    n, h, w = 2, 8, 6             # SAME at stride 2 pads (0, 1) both ways
    x, wk, scale, bias = _operands(c * 7 + stride, n, h, w, c)
    pads = _pads(h, w, stride, padding)
    jde = jchain.DeferredEpilogue(_jax_acc(x, wk, stride, pads),
                                  jnp.asarray(scale), jnp.asarray(bias),
                                  relu=True)
    de = DeferredEpilogue(PendingDwConv(torch.from_numpy(x),
                                        D.pack_weight(torch.from_numpy(wk)),
                                        stride, PAD, pads[0][0]),
                          torch.from_numpy(scale), torch.from_numpy(bias),
                          relu=True)
    want = np.asarray(jchain.fold_quantize(
        jde, jnp.float32(INV_S), jnp.float32(QBIAS), QMIN_S, QMAX_S))
    got = chain.fold_quantize(de, float(np.float32(INV_S)),
                              float(np.float32(QBIAS)), QMIN_S, QMAX_S)
    assert got.shape == want.shape == (n, -(-h // stride), -(-w // stride), c)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(chain.materialize(de).numpy(),
                          np.asarray(jchain.materialize(jde)))
