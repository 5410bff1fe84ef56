"""The port's whole serving slice against the JAX package: RepVGG-A0 at
its full widths, 32×32 input, 10 classes, batch 4.

(a) train form with perturbed BN → ``repvgg_fuse`` (kernels and biases
    rtol 1e-5, atol 1e-6 for entries near 0) and the fp forward
    (rtol 2e-4, atol 2e-5, as tests/test_chain.py);
(b) whole-model ``calibrate`` (scales and zero-points rtol 1e-4);
(c) ``prepare_deploy`` on JAX's calibrated variables: bit-equal int8
    weights and pad codes, ``bias_eff`` rtol 1e-5;
(d) chained int8 serving (``qmode='intc'``): the int8 codes of every
    layer, each layer fed JAX's own input codes, are equal; a code may
    differ by one on at most 0.1 % of values, where a one-ulp difference
    of a plan value (XLA's jitted ``prepare_deploy`` may contract
    ``128·s + o`` into an fma) moves a tie.  Then the logits: relative
    L2 < 2e-2, the bound of tests/test_chain.py.
(c) and (d) run with and without AdaRound.
"""

import subprocess
import sys
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlmc_quant_tpu.models import get_model as jax_get_model
from dlmc_quant_tpu.models.fuse import repvgg_fuse as jax_repvgg_fuse
from dlmc_quant_tpu.quant import chain as jchain
from dlmc_quant_tpu.quant import deploy as jdeploy
from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.models.fuse import repvgg_fuse
from dlmc_quant_torch.quant.chain import qrelu
from dlmc_quant_torch.quant.config import scheme_from_dict as port_scheme
from dlmc_quant_torch.quant.deploy import act_to_int8, prepare_deploy
from dlmc_quant_torch.quant.layers import calibrate
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BATCH, SIZE, CLASSES = 4, 32, 10


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _scheme(adaround: bool):
    w = {"enable": True, "type": "minmax_channel",
         "args": {"n_bits": 8, "signed": True}}
    if adaround:
        w["recon_type"] = "adaround"
    return {"quantization_type": "FSPTQ", "weight": w,
            "input": {"enable": True, "type": "minmax_tensor",
                      "args": {"n_bits": 8, "signed": False}}}


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((BATCH, SIZE, SIZE, 3), dtype=np.float32)


def _port_model(adaround, deploy=True):
    return get_model("RepVGG_A0", device="cpu", num_classes=CLASSES,
                     deploy=deploy, scheme=port_scheme(_scheme(adaround)))


def _convs(model):
    return [getattr(model, n).reparam for n in model.block_names]


@pytest.fixture(scope="module", params=[False, True],
                ids=["minmax", "adaround"])
def jax_slice(request):
    """JAX deploy-form A0: init, calibrate, prepare_deploy and the chained
    int8 forward with every block's deferred output captured."""
    adaround = request.param
    model = jax_get_model("RepVGG_A0", num_classes=CLASSES, deploy=True,
                          scheme=jax_scheme(_scheme(adaround)))
    x = jnp.asarray(_images())
    v0 = _np(jax.jit(model.init)(jax.random.PRNGKey(1), x))
    # seeded non-zero biases, as a fused model has: with zero biases the
    # 2x2 and 1x1 stage-3/4 maps of a 32x32 input (mostly padding) shrink
    # the signal to a few quantization steps and calibration turns chaotic
    rng = np.random.default_rng(4)
    for name in v0["params"]:
        if "reparam" in v0["params"][name]:
            shape = v0["params"][name]["reparam"]["bias"].shape
            v0["params"][name]["reparam"]["bias"] = (
                0.1 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    v1 = jax_calibrate(model, jax.tree_util.tree_map(jnp.asarray, v0), [x])
    v2 = jdeploy.prepare_deploy(model, v1, sample_input=x)
    y, state = model.apply(v2, x, qmode="intc", capture_intermediates=True,
                           mutable=["intermediates"])
    names = ["stage0"] + [f"stage{s}_{b}" for s, n in
                          zip((1, 2, 3, 4), (2, 4, 14, 1)) for b in range(n)]
    qint = v2["qint"]
    # input codes of every conv, as the JAX model computes them
    p0 = qint["stage0"]["reparam"]
    codes = [jdeploy.act_to_int8(x, p0["in_scale"], p0["in_offset"], 0, 255,
                                 inv_s_x=p0["in_inv_scale"],
                                 qbias=p0["in_qbias"])[0]]
    for prev, name in zip(names, names[1:]):
        de = state["intermediates"][prev]["__call__"][0]
        p = qint[name]["reparam"]
        codes.append(jchain.fold_quantize(de, p["in_inv_scale"],
                                          p["in_qbias"], -128, 127))
    return {"adaround": adaround, "x": np.array(x), "init": v0,
            "calibrated": _np(v1), "qint": _np(qint), "names": names,
            "codes": [np.asarray(c) for c in codes], "logits": np.asarray(y)}


def test_fuse_matches_jax():
    """(a) Train form with perturbed BN statistics → deploy form."""
    model = jax_get_model("RepVGG_A0", num_classes=CLASSES, deploy=False)
    x = jnp.asarray(_images(1))
    v = _np(jax.jit(model.init)(jax.random.PRNGKey(2), x))
    rng = np.random.default_rng(3)
    perturb = lambda a: (a + 0.3 * rng.random(a.shape)).astype(np.float32)
    v["batch_stats"] = jax.tree_util.tree_map(perturb, v["batch_stats"])
    for blk in v["params"].values():
        for name, bn in blk.items():
            if "scale" in bn:
                bn["scale"], bn["bias"] = perturb(bn["scale"]), \
                    perturb(bn["bias"])
    dmodel, dv = jax_repvgg_fuse(model, v, x)
    want = np.asarray(model.apply(v, x, qmode="fp"))

    port = load_jax_variables(
        get_model("RepVGG_A0", device="cpu", num_classes=CLASSES), v)
    fused = repvgg_fuse(port)
    for name in port.block_names:
        conv, ref = getattr(fused, name).reparam, dv["params"][name]["reparam"]
        np.testing.assert_allclose(
            conv.weight.detach().numpy(),
            np.transpose(np.asarray(ref["kernel"]), (3, 2, 0, 1)),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(conv.bias.detach().numpy(),
                                   np.asarray(ref["bias"]),
                                   rtol=1e-5, atol=1e-6)
    xt = torch.from_numpy(np.array(x))
    with torch.no_grad():
        for m in (port, fused):
            np.testing.assert_allclose(m(xt, qmode="fp").numpy(), want,
                                       rtol=2e-4, atol=2e-5)


def test_calibrate_matches_jax(jax_slice):
    """(b) Whole-model calibration from the same initial weights."""
    port = load_jax_variables(_port_model(jax_slice["adaround"]),
                              jax_slice["init"])
    calibrate(port, [torch.from_numpy(jax_slice["x"])])
    p, q = jax_slice["calibrated"]["params"], \
        jax_slice["calibrated"]["qstate"]
    for name in jax_slice["names"] + ["linear"]:
        layer = port.linear if name == "linear" \
            else getattr(port, name).reparam
        jp = p["linear"] if name == "linear" else p[name]["reparam"]
        jq = q["linear"] if name == "linear" else q[name]["reparam"]
        for got, want in ((layer.in_scale, jp["in_scale"]),
                          (layer.wt_scale, jp["wt_scale"]),
                          (layer.in_offset, jq["in_offset"])):
            np.testing.assert_allclose(got.detach().numpy(), want,
                                       rtol=1e-4, err_msg=name)


def _deployed(jax_slice):
    port = load_jax_variables(_port_model(jax_slice["adaround"]),
                              jax_slice["calibrated"])
    return prepare_deploy(port)


def test_prepare_deploy_matches_jax(jax_slice):
    """(c) Integer plans from JAX's calibrated variables."""
    port = _deployed(jax_slice)
    for name in jax_slice["names"] + ["linear"]:
        layer = port.linear if name == "linear" \
            else getattr(port, name).reparam
        ref = jax_slice["qint"]["linear" if name == "linear" else name]
        ref = ref if name == "linear" else ref["reparam"]
        w_int = ref["w_int"]
        w_int = w_int.T if name == "linear" \
            else np.transpose(w_int, (3, 2, 0, 1))
        np.testing.assert_array_equal(layer.w_int.numpy(), w_int,
                                      err_msg=name)
        assert layer.plan_scalars["pad_val"] == int(ref["pad_val"]), name
        np.testing.assert_allclose(layer.bias_eff.numpy(), ref["bias_eff"],
                                   rtol=1e-5, err_msg=name)


def test_intc_matches_jax(jax_slice):
    """(d) Chained int8 serving: per-layer codes, then the logits."""
    port = _deployed(jax_slice)
    convs = _convs(port)
    codes = [torch.from_numpy(c) for c in jax_slice["codes"]]
    h0 = convs[0].plan_scalars
    stem, _ = act_to_int8(torch.from_numpy(jax_slice["x"]), h0["in_scale"],
                          h0["in_offset"], 0, 255,
                          inv_s_x=h0["in_inv_scale"], qbias=h0["in_qbias"])
    assert torch.equal(stem, codes[0])
    n_off = n_all = 0
    for i in range(len(convs) - 1):
        got = convs[i + 1]._input_codes(qrelu(convs[i].deferred(codes[i])))
        diff = (got.to(torch.int32) - codes[i + 1].to(torch.int32)).abs()
        assert got.shape == codes[i + 1].shape
        assert int(diff.max()) <= 1, jax_slice["names"][i]
        n_off, n_all = n_off + int((diff > 0).sum()), n_all + diff.numel()
    assert n_off <= 1e-3 * n_all, (n_off, n_all)

    with torch.no_grad():
        y = port(torch.from_numpy(jax_slice["x"]), qmode="intc").numpy()
    want = jax_slice["logits"]
    assert y.shape == (BATCH, CLASSES) and np.isfinite(y).all()
    rel = np.linalg.norm(y - want) / (np.linalg.norm(want) + 1e-9)
    assert rel < 2e-2, rel
    # the plain int path agrees with the chained one
    with torch.no_grad():
        y_int = port(torch.from_numpy(jax_slice["x"]), qmode="int").numpy()
    assert np.linalg.norm(y - y_int) / (np.linalg.norm(y_int) + 1e-9) < 2e-2


TRAINING_MODULES = (
    "dlmc_quant_torch.ops.rootq_math", "dlmc_quant_torch.training.trainer",
    "dlmc_quant_torch.training.qat", "dlmc_quant_torch.training.optimizers",
    "dlmc_quant_torch.utils.metric_tracker",
    "dlmc_quant_torch.examples.classification",
    "dlmc_quant_torch.examples.quantization_aware_training",
    "dlmc_quant_torch.parallel.mesh", "dlmc_quant_torch.parallel.serving",
    "dlmc_quant_torch.tools.lockstep_2proc",
    "dlmc_quant_torch.examples.serve_benchmark",
    "dlmc_quant_torch.examples.benchmark",
    "dlmc_quant_torch.examples.distributed_training",
    "dlmc_quant_torch.ops.cuda.int8_window_sum",
    "dlmc_quant_torch.tools.stem_parts",
    "dlmc_quant_torch.utils.count_ops", "dlmc_quant_torch.utils.bidict",
    "dlmc_quant_torch.utils.torch_import",
    "dlmc_quant_torch.tools.d2se_enqueue",
    "dlmc_quant_torch.examples.FSPTQuant")


def test_import_leaves_out_jax():
    code = ("import importlib, sys, dlmc_quant_torch, "
            "dlmc_quant_torch.models.fuse, dlmc_quant_torch.utils.jax_bridge\n"
            f"for m in {TRAINING_MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'flax', 'optax', 'dlmc_quant_tpu'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_entry_points_need_a_card_or_cpu(monkeypatch, tmp_path):
    from dlmc_quant_torch.examples import classification
    from dlmc_quant_torch.examples import quantization_aware_training as qat
    from dlmc_quant_torch.quant.deploy import make_serving_fn
    from dlmc_quant_torch.utils.config import read_yaml, write_yaml
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("RepVGG_A0", num_classes=CLASSES, deploy=True)
    model = _port_model(False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_serving_fn(model)
    for entry, name in ((qat, "RootQ_resnet20_cifar10_w4a4"),
                        (qat, "QAT_lsq_resnet20_cifar10_w4a4"),
                        (classification, "baseline_resnet20_cifar10")):
        cfg = read_yaml(REPO / "examples" / "configs" / f"{name}.yaml")
        cfg["save_dir"] = str(tmp_path / "saved")
        path = tmp_path / f"{name}.yaml"
        write_yaml(cfg, path)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.main(["-c", str(path)])
