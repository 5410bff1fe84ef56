"""W4 execution in the port against the JAX package, one layer at a time.

Each layer is built in both packages under a W4A8 FSPTQ scheme
(per-channel 4-bit signed weights, minmax or AdaRound; per-tensor
unsigned 8-bit inputs), initialised and calibrated by JAX on seeded numpy
inputs, carried into the port (``load_jax_variables``, hazard C7) and
prepared for integer execution by both.  JAX runs each of its two int4
routes: nibble packing (``DLMCQ_NATIVE_INT4=0``, plan ``w_int4``) and its
default native S4 dtype (plan ``w_i4``), which this CPU backend supports.

* ``pack_int4`` equals JAX's byte for byte (odd and even axis 0, every
  value in -8..7) and ``unpack_int4`` inverts it; a dense layer's and a
  weight-only layer's ``w_int4`` equal JAX's ``qint/w_int4``, and a conv's
  kernel layout unpacks to JAX's int4 weight (its ``pack_int4`` to JAX's
  bytes);
* the plan of a W4 layer holds no int8 copy of its weight: no ``w_int``,
  every weight buffer nibble-packed ``uint8``;
* 3×3 (stride 1 and 2), 1×1, depthwise 3×3, the 7×7/s2 stem and a dense
  layer: the port's input codes at most one code from JAX's (C2), its
  int32 accumulator on JAX's codes equal to JAX's, and the ``int`` output
  on those codes within 1e-6 of JAX's (JAX's jitted plan contracts its bias
  into an fma: an ulp apart); the ``intc`` epilogue scale equal;
* AdaRound at 4 bits (the hard decisions of the 4-bit grid) and a
  weight-only W4 layer (bf16 products, relative L2 1e-5).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlmc_quant_tpu.quant import deploy as jdp
from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
from dlmc_quant_tpu.quant.layers import QConv as JQConv
from dlmc_quant_tpu.quant.layers import QDense as JQDense
from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
from dlmc_quant_torch.ops.cuda.nibbles import W4
from dlmc_quant_torch.quant import chain
from dlmc_quant_torch.quant import deploy as dp
from dlmc_quant_torch.quant.config import scheme_from_dict as port_scheme
from dlmc_quant_torch.quant.layers import (QConv, QDense, _int8_matmul,
                                           attach_scheme)
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables

torch.set_num_threads(1)


def _scheme(adaround=False, act=True):
    w = {"enable": True, "type": "minmax_channel",
         "args": {"n_bits": 4, "signed": True}}
    if adaround:
        w["recon_type"] = "adaround"
    return {"quantization_type": "FSPTQ", "weight": w,
            "input": {"enable": act, "type": "minmax_tensor",
                      "args": {"n_bits": 8, "signed": False}}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.fixture(params=["nibbles", "native"])
def route(request, monkeypatch):
    """JAX's int4 route: nibble packing, or its native S4 dtype."""
    if request.param == "nibbles":
        monkeypatch.setenv("DLMCQ_NATIVE_INT4", "0")
    jdp.reset_int4_probe()
    if request.param == "native" and not jdp.int4_native_supported():
        pytest.skip("this JAX backend has no native int4 dot")
    yield request.param
    monkeypatch.delenv("DLMCQ_NATIVE_INT4", raising=False)
    jdp.reset_int4_probe()


# name → (JAX layer, port layer, input shape)
LAYERS = {
    "conv3x3_s1": (lambda s: JQConv(16, (3, 3), (1, 1),
                                    padding=((1, 1), (1, 1)), scheme=s),
                   lambda: QConv(8, 16, 3, 1, 1), (2, 9, 9, 8)),
    "conv3x3_s2": (lambda s: JQConv(24, (3, 3), (2, 2),
                                    padding=((1, 1), (1, 1)), scheme=s),
                   lambda: QConv(16, 24, 3, 2, 1), (2, 9, 10, 16)),
    "conv1x1": (lambda s: JQConv(24, (1, 1), (1, 1), padding="VALID",
                                 scheme=s),
                lambda: QConv(20, 24, 1, 1, 0), (2, 6, 7, 20)),
    "depthwise": (lambda s: JQConv(24, (3, 3), (2, 2),
                                   padding=((1, 1), (1, 1)),
                                   feature_group_count=24, scheme=s),
                  lambda: QConv(24, 24, 3, 2, 1, groups=24), (2, 9, 8, 24)),
    "stem7x7": (lambda s: JQConv(16, (7, 7), (2, 2),
                                 padding=((3, 3), (3, 3)), scheme=s),
                lambda: QConv(3, 16, 7, 2, 3), (2, 21, 19, 3)),
    "dense": (lambda s: JQDense(10, scheme=s), lambda: QDense(33, 10),
              (5, 33)),
}


def _pair(name, adaround=False, act=True, seed=0):
    """The layer in both packages on JAX's calibrated variables, each
    prepared for integer execution; JAX's deploy variables."""
    make_jax, make_port, shape = LAYERS[name]
    rng = np.random.default_rng(seed)
    x = (rng.random(shape, dtype=np.float32) * 3.0 - 0.5)
    jl = make_jax(jax_scheme(_scheme(adaround, act)))
    v = jax.jit(jl.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    v = jax_calibrate(jl, v, [jnp.asarray(x)])
    vd = jdp.prepare_deploy(jl, v, sample_input=jnp.asarray(x))
    pl = attach_scheme(make_port(), port_scheme(_scheme(adaround, act)))
    load_jax_variables(pl, _np({k: t for k, t in vd.items() if k != "qint"}))
    pl.prepare_deploy()
    return jl, vd, _np(vd["qint"]), pl, x


def _jax_w_int(plan, shape0):
    """JAX's int8 weight (HWIO or IO) from either int4 route."""
    if "w_i4" in plan:
        return np.asarray(jnp.asarray(plan["w_i4"]).astype(jnp.int8))
    return np.asarray(jdp.unpack_int4(jnp.asarray(plan["w_int4"]), shape0))


def _port_hwio(pl):
    """The port's int8 weight in JAX's layout, from its kernel layout or
    its ``w_int4``."""
    from dlmc_quant_torch.ops.cuda import int8_conv as K
    from dlmc_quant_torch.ops.cuda import int8_dwconv as D
    from dlmc_quant_torch.ops.cuda import int8_gemm as G
    if isinstance(pl, QDense) or pl.weight_only:
        return pl._int_weight().numpy().T if isinstance(pl, QDense) \
            else pl._int_weight().permute(2, 3, 1, 0).numpy()
    o, i, kh, _ = pl.weight.shape
    if pl.depthwise:
        return D.unpack_weight(pl.w_dw, o).numpy()
    if kh == 3:
        return K.unpack_weight(pl.w_packed, i, o).numpy()
    rows = G.unpack_b(pl.w_gemm, kh * kh * i)
    return rows.reshape(kh, kh, i, o).numpy()


def _no_int8_copy(pl):
    bufs = dict(pl.named_buffers(recurse=False))
    assert "w_int" not in bufs
    weights = {k: t for k, t in bufs.items()
               if k.startswith("w_") and k != "w_scale" and t is not None}
    assert weights and all(t.dtype == W4 for t in weights.values()), \
        {k: t.dtype for k, t in weights.items()}
    return weights


@pytest.mark.parametrize("n", [7, 8])
def test_pack_int4_bytes_equal_jax(n):
    v = np.resize(np.arange(-8, 8, dtype=np.int8), (n, 3, 5))
    np.random.default_rng(n).shuffle(v.reshape(-1))
    want = np.asarray(jdp.pack_int4(jnp.asarray(v)))
    got = dp.pack_int4(torch.from_numpy(v))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert np.array_equal(dp.unpack_int4(got, n).numpy(), v)
    assert np.array_equal(np.asarray(jdp.unpack_int4(jnp.asarray(want), n)),
                          dp.unpack_int4(got, n).numpy())


@pytest.mark.parametrize("name", list(LAYERS))
def test_w4_layer_matches_jax(name, route):
    jl, vd, plan, pl, x = _pair(name, seed=len(name))
    assert ("w_int4" in plan) == (route == "nibbles")
    # the weight: no int8 copy in the port's plan, the values JAX's, and
    # pack_int4 of them JAX's bytes
    weights = _no_int8_copy(pl)
    w_j = _jax_w_int(plan, pl.weight.shape[2] if name != "dense"
                     else pl.weight.shape[1])
    assert np.array_equal(_port_hwio(pl), w_j)
    packed = dp.pack_int4(torch.from_numpy(np.array(w_j)))
    if route == "nibbles":
        assert np.array_equal(packed.numpy(), plan["w_int4"])
    if name == "dense":
        assert np.array_equal(weights["w_int4"].numpy(), packed.numpy())
    # codes, then the accumulator and the output on JAX's codes
    xt = torch.from_numpy(x)
    codes_j, _ = jdp.act_to_int8(jnp.asarray(x), plan["in_scale"],
                                 plan["in_offset"], 0, 255,
                                 inv_s_x=plan["in_inv_scale"],
                                 qbias=plan["in_qbias"])
    codes_j = np.asarray(codes_j)
    with torch.no_grad():
        codes = pl._input_codes(xt).numpy()
    assert np.abs(codes.astype(int) - codes_j.astype(int)).max() <= 1
    jde = jl.apply(vd, jnp.asarray(x), qmode="intc")
    want = np.asarray(jl.apply(vd, jnp.asarray(x), qmode="int"))
    cj = torch.from_numpy(codes_j)
    with torch.no_grad():
        if name == "dense":
            acc = _int8_matmul(cj, pl._int_weight().contiguous()).numpy()
            got = chain.materialize(chain.DeferredEpilogue(
                torch.from_numpy(acc), pl.epi_scale, pl.bias_eff)).numpy()
            scale = pl.epi_scale
        else:
            de = pl.deferred(cj)
            assert de.acc.int4
            if isinstance(de.acc, (chain.PendingGemm, chain.PendingWideConv)):
                acc = de.acc.run(mode="int32").numpy()
            else:
                ones = torch.ones_like(de.scale)
                acc = de.acc.run(ones, torch.zeros_like(ones),
                                 mode="f32").numpy()
            got = chain.materialize(de).numpy()
            scale = de.scale
    assert np.array_equal(acc, np.asarray(jde.acc).astype(acc.dtype))
    assert np.array_equal(scale.numpy(), np.asarray(jde.scale).reshape(-1))
    np.testing.assert_allclose(got, np.asarray(jchain_materialize(jde)),
                               rtol=1e-6, atol=1e-6 * np.abs(want).max())
    with torch.no_grad():
        assert pl(xt, qmode="int").shape == want.shape


def jchain_materialize(de):
    from dlmc_quant_tpu.quant import chain as jchain
    return jchain.materialize(de)


@pytest.mark.parametrize("name", ["conv3x3_s1", "dense"])
def test_adaround_w4_matches_jax(name, route):
    """AdaRound's hard decisions on the 4-bit grid: floor(w / s) + (alpha
    >= 0), clamped to [-8, 7]."""
    _, _, plan, pl, _ = _pair(name, adaround=True, seed=11)
    _no_int8_copy(pl)
    w_j = _jax_w_int(plan, pl.weight.shape[2] if name != "dense"
                     else pl.weight.shape[1])
    assert w_j.min() >= -8 and w_j.max() <= 7
    assert np.array_equal(_port_hwio(pl), w_j)


@pytest.mark.parametrize("name", ["conv3x3_s2", "dense"])
def test_weight_only_w4_matches_jax(name, route):
    jl, vd, plan, pl, x = _pair(name, act=False, seed=5)
    assert pl.weight_only and "in_scale" not in plan
    weights = _no_int8_copy(pl)
    assert set(weights) == {"w_int4"}
    if route == "nibbles":
        assert np.array_equal(weights["w_int4"].numpy(), plan["w_int4"])
    want = np.asarray(jl.apply(vd, jnp.asarray(x), qmode="int"))
    with torch.no_grad():
        got = pl(torch.from_numpy(x), qmode="int").numpy()
    assert _rel(got, want) <= 1e-5
