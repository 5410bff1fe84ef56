"""The port's scheme grammar, observers, quantized layers and deploy
numerics against the JAX package on the same numpy-seeded inputs.

Tolerances: observers rtol 1e-6 (the same f32 reductions); one layer's
calibrated scales rtol 1e-5 and its eval fake-quant output atol 1e-5
(the conv sums run in another order); ``act_to_int8`` and
``fold_quantize`` exact (the same two f32 ops, rounding half to even).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dlmc_quant_tpu.models import get_model as jax_get_model
from dlmc_quant_tpu.ops import observers as jobs
from dlmc_quant_tpu.quant import chain as jchain
from dlmc_quant_tpu.quant import deploy as jdeploy
from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
from dlmc_quant_tpu.quant.layers import QConv as JQConv
from dlmc_quant_tpu.quant.layers import QDense as JQDense
from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.ops import observers as tobs
from dlmc_quant_torch.quant import chain as tchain
from dlmc_quant_torch.quant import deploy as tdeploy
from dlmc_quant_torch.quant.config import scheme_from_dict as port_scheme
from dlmc_quant_torch.quant.layers import (QConv, QDense, QLayer,
                                           attach_scheme, calibrate)
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables

torch.set_num_threads(1)

_YAML = Path(__file__).resolve().parent.parent / "examples" / "configs" \
    / "FSPTQ_repvgg_a0_w8a8.yaml"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fsptq(adaround: bool):
    w = {"enable": True, "type": "minmax_channel",
         "args": {"n_bits": 8, "signed": True}}
    if adaround:
        w["recon_type"] = "adaround"
    return {"quantization_type": "FSPTQ", "weight": w,
            "input": {"enable": True, "type": "minmax_tensor",
                      "args": {"n_bits": 8, "signed": False}}}


class TestScheme:
    @pytest.mark.parametrize("deploy", [True, False])
    def test_yaml_resolves_like_jax(self, deploy):
        """Every A0 layer path resolves to the same config in both
        packages, and the port's paths are the JAX module paths."""
        block = yaml.safe_load(_YAML.read_text())["quantization"]
        js, ps = jax_scheme(block), port_scheme(block)
        model = get_model("RepVGG_A0", device="cpu", num_classes=10,
                          deploy=deploy, scheme=ps)
        paths = [n for n, m in model.named_modules() if isinstance(m, QLayer)]
        jmodel = jax_get_model("RepVGG_A0", num_classes=10, deploy=deploy)
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 32, 3)))["params"]
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        jpaths = {".".join(k.key for k in kp[:-1]) for kp, _ in flat
                  if kp[-1].key == "kernel"}
        assert set(paths) == jpaths and len(paths) == (23 if deploy else 45)
        for p in paths:
            assert ps.resolve(p).to_dict() == js.resolve(p).to_dict(), p
            assert model.get_submodule(p).cfg == ps.resolve(p)

    def test_excludes_and_overrides(self):
        d = dict(_fsptq(False), exclude_layers=["stage0.*"],
                 override_options=[{"layers": [".*linear.*"], "options": {
                     "weight": {"args": {"n_bits": 4}}}}])
        js, ps = jax_scheme(d), port_scheme(d)
        for p in ("stage0.reparam", "stage1_0.reparam", "linear"):
            jr, pr = js.resolve(p), ps.resolve(p)
            assert (jr is None and pr is None) or \
                jr.to_dict() == pr.to_dict()
        assert ps.resolve("stage0.reparam") is None
        assert ps.resolve("linear").weight.n_bits == 4


class TestObservers:
    @pytest.mark.parametrize("signed,allow_offset", [
        (True, True), (False, True), (False, False)])
    def test_minmax(self, signed, allow_offset):
        t = np.random.default_rng(0).standard_normal((16, 8, 3, 3)) \
            .astype(np.float32) + 0.3
        kw = dict(n_bits=8, signed=signed, allow_offset=allow_offset)
        for name, extra in (("minmax_tensor", {}),
                            ("minmax_channel", {"ch_axis": 0}),
                            ("minmax_channel", {"ch_axis": 1})):
            js, jo = jobs.get_qparams_tensor(jnp.asarray(t), name, **kw,
                                             **extra)
            ts, to = tobs.get_qparams_tensor(torch.from_numpy(t), name,
                                             **kw, **extra)
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6)

    def test_unported_observer_raises(self):
        with pytest.raises(NotImplementedError,
                           match=r"observers left \(item 9\)"):
            tobs.get_qparams_tensor(torch.zeros(4), "l2loss_tensor",
                                    n_bits=8, signed=True)


def _layer_pair(kind, adaround, seed):
    rng = np.random.default_rng(seed)
    jsch, psch = jax_scheme(_fsptq(adaround)), port_scheme(_fsptq(adaround))
    if kind == "conv":
        x = rng.random((2, 9, 9, 8), dtype=np.float32) * 3.0 - 0.5
        jl = JQConv(16, (3, 3), (2, 2), padding=((1, 1), (1, 1)),
                    scheme=jsch)
        pl = QConv(8, 16, 3, 2, 1)
    else:
        x = rng.random((5, 24), dtype=np.float32) * 2.0 - 0.2
        jl = JQDense(12, scheme=jsch)
        pl = QDense(24, 12)
    attach_scheme(pl, psch)
    v = jax.jit(jl.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    load_jax_variables(pl, _np(v))
    return jl, v, pl, x


class TestLayers:
    @pytest.mark.parametrize("kind,adaround", [
        ("conv", False), ("conv", True), ("dense", False), ("dense", True)])
    def test_calibrate_then_eval(self, kind, adaround):
        jl, v, pl, x = _layer_pair(kind, adaround, 3)
        v = _np(jax_calibrate(jl, v, [jnp.asarray(x)]))
        calibrate(pl, [torch.from_numpy(x)])
        p, q = v["params"], v["qstate"]
        np.testing.assert_allclose(pl.in_scale.detach().numpy(),
                                   p["in_scale"], rtol=1e-5)
        np.testing.assert_allclose(pl.wt_scale.detach().numpy(),
                                   p["wt_scale"], rtol=1e-5)
        np.testing.assert_array_equal(pl.in_offset.numpy(), q["in_offset"])
        if adaround:
            alpha = pl.alpha.detach().numpy()
            jalpha = p["alpha"]
            jalpha = (np.transpose(jalpha, (3, 2, 0, 1)) if kind == "conv"
                      else jalpha.T)
            # the rounding decisions agree exactly; the values only to
            # 1e-3, because XLA's jitted scale may differ from the port's
            # by one ulp and w/s (|w/s| ≤ 127) amplifies that ulp in alpha
            np.testing.assert_array_equal(alpha >= 0, jalpha >= 0)
            np.testing.assert_allclose(alpha, jalpha, rtol=0, atol=1e-3)
        # eval fake quant with the JAX-calibrated variables in both
        load_jax_variables(pl, v)
        want = np.asarray(jl.apply(v, jnp.asarray(x), qmode="eval"))
        with torch.no_grad():
            got = pl(torch.from_numpy(x), qmode="eval").numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


class TestDeployNumerics:
    def test_act_to_int8_exact(self):
        rng = np.random.default_rng(7)
        x = (rng.standard_normal((4, 6, 6, 5)) * 2).astype(np.float32)
        s_x, zp = np.float32(0.0173), np.float32(37.0)
        o_x = np.float32(-zp * s_x)
        inv = np.float32(1.0) / s_x
        qb = np.float32(-o_x / s_x - np.float32(128))
        want, _ = jdeploy.act_to_int8(jnp.asarray(x), s_x, o_x, 0, 255,
                                      inv_s_x=inv, qbias=qb)
        got, shift = tdeploy.act_to_int8(torch.from_numpy(x), float(s_x),
                                         float(o_x), 0, 255,
                                         inv_s_x=float(inv), qbias=float(qb))
        assert shift == 128 and got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        wn, _ = jdeploy.act_to_int8(jnp.asarray(x), s_x, o_x, 0, 255)
        gn, _ = tdeploy.act_to_int8(torch.from_numpy(x), torch.tensor(s_x),
                                    torch.tensor(o_x), 0, 255)
        np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
        pad = tdeploy.int8_pad_value(torch.tensor(s_x), torch.tensor(o_x),
                                     0, 255)
        assert int(pad) == int(jdeploy.int8_pad_value(s_x, o_x, 0, 255))

    @pytest.mark.parametrize("relu", [True, False])
    def test_fold_quantize_exact(self, relu):
        rng = np.random.default_rng(8)
        acc = rng.integers(-2 ** 22, 2 ** 22, (64, 32), dtype=np.int32)
        ps = (np.abs(rng.standard_normal(32)) * 1e-5).astype(np.float32)
        pb = rng.standard_normal(32).astype(np.float32)
        inv, qb = np.float32(13.7), np.float32(-101.3)
        jd = jchain.DeferredEpilogue(jnp.asarray(acc), jnp.asarray(ps),
                                     jnp.asarray(pb), relu=relu)
        want = jchain.fold_quantize(jd, inv, qb, -128, 127)
        td = tchain.DeferredEpilogue(torch.from_numpy(acc),
                                     torch.from_numpy(ps),
                                     torch.from_numpy(pb), relu=relu)
        got = tchain.fold_quantize(td, float(inv), float(qb), -128, 127)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(tchain.materialize(td).numpy(),
                                   np.asarray(jchain.materialize(jd)),
                                   rtol=0, atol=0)
