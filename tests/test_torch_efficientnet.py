"""EfficientNet in the port against the JAX package, on the same weights
and images (numpy seeds), with bench.py's W8A8 scheme: ``cifar_efficientnetb0``
at 32×32 and ``efficientnetb0`` at 64×64, batch 2, 10 classes.  The
variables come from ``jax.eval_shape`` with numpy-seeded leaves
(``tests/test_torch_ghostnet.py: variables``), JAX's ``fp`` and ``eval``
forwards are jitted and its integer forward, whose layers are compared,
runs eagerly.

* All 16 factories registered, each building JAX's configuration (width,
  depth, dropout, the CIFAR stem, its blocks); the parameter counts of B0
  (in (4.5e6, 6e6)) and B3 equal JAX's.
* Train form: ``fp`` logits and, after JAX's calibration, ``eval`` logits
  within rtol 1e-4, atol 1e-5 of the largest logit (or, where a tie
  flips, the layers one by one: ``tests/test_torch_ghostnet.py:
  hold_eval``).
* ``cifar_efficientnetb0``'s deploy form: ``efficientnet_deploy`` (BN ε
  1e-3) gives JAX's kernels and biases within 1e-6 and the train form's
  ``fp`` logits within rtol 2e-3, atol 3e-5 of the largest logit; after
  JAX's calibration and ``prepare_deploy``: every conv and dense layer
  fed JAX's ``int`` input gives JAX's input codes within one code (the
  count one apart printed, 0 expected) and, on JAX's codes, JAX's f32
  output within 1e-6 relative; ``int`` and ``intc`` (which the model
  runs as ``int``) logits within relative L2 2e-2 of JAX's; JAX's
  criterion ``rel_intc < max(1.5·rel_int, 0.02)`` against ``fp``; one
  request's launches (1 conv, 32 GEMM, 16 depthwise, 9 of them 5×5).
* Drop-connect and the head's dropout draw from ``drop_generator`` in
  training only.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlmc_quant_tpu.models import get_model as jax_get_model
from dlmc_quant_tpu.models.fuse import (efficientnet_deploy as
                                        jax_efficientnet_deploy)
from dlmc_quant_tpu.quant import deploy as jdeploy
from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
from dlmc_quant_tpu.quant.layers import QConv as JQConv
from dlmc_quant_tpu.quant.layers import QDense as JQDense
from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
from dlmc_quant_torch.models.efficientnet import _COEFFS, EfficientNet
from dlmc_quant_torch.models.fuse import efficientnet_deploy
from dlmc_quant_torch.models.registry import _REGISTRY
from dlmc_quant_torch.models.resnet_cifar import BatchNorm
from dlmc_quant_torch.quant import chain
from dlmc_quant_torch.quant.chain import PendingDwConv
from dlmc_quant_torch.quant.config import scheme_from_dict as port_scheme
from dlmc_quant_torch.quant.deploy import prepare_deploy
from dlmc_quant_torch.quant.layers import QConv, QDense
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables
from dlmc_quant_torch.utils.launches import LaunchRecorder
from test_torch_ghostnet import (BATCH, CLASSES, SCHEME, capture, close,
                                 hold_eval, images, jax_codes,
                                 node, np_tree, rel, to_port, variables)

torch.set_num_threads(1)

# name → map size
CASES = {"cifar_efficientnetb0": 32, "efficientnetb0": 64}
LAUNCHES = dict(conv=1, gemm=32, im2col=0, stem_pool=0, dwconv=16,
                window_sum=0)
N_LAYERS = 1 + 15 + 16 + 16 + 2 * 16 + 1 + 1     # convs and dense layers


def port_model(name, deploy=False):
    return _REGISTRY[name](num_classes=CLASSES, deploy=deploy,
                           scheme=port_scheme(SCHEME)).eval()


@functools.lru_cache(maxsize=None)
def train_form(name: str):
    jm = jax_get_model(name, num_classes=CLASSES, scheme=jax_scheme(SCHEME))
    size = CASES[name]
    v = variables(jm, size, seed=size)
    x = jnp.asarray(images(0, size))
    fp = jax.jit(lambda v, x: jm.apply(v, x, qmode="fp"))(v, x)
    v_cal = jax_calibrate(jm, v, [x])
    ev = jax.jit(lambda v, x: jm.apply(v, x, qmode="eval"))(v_cal, x)
    return dict(name=name, jm=jm, v=v, x=images(0, size), fp=np.asarray(fp),
                v_cal=np_tree(v_cal), eval=np.asarray(ev))


@pytest.fixture(scope="module")
def effnet():
    """cifar_efficientnetb0: JAX's efficientnet_deploy of the train form,
    calibrated and prepared; its ``fp`` and ``intc`` logits and its eager
    ``int`` forward with every layer's inputs and outputs; the port's twin
    on the same variables, prepared."""
    t = train_form("cifar_efficientnetb0")
    x = jnp.asarray(t["x"])
    dm, dv = jax_efficientnet_deploy(t["jm"], t["v"], example_input=x[:1])
    fp = jax.jit(lambda v, x: dm.apply(v, x, qmode="fp"))(dv, x)
    dv = jdeploy.prepare_deploy(dm, jax_calibrate(dm, dv, [x]),
                                sample_input=x)
    logits_int, seen = capture(dm, "int", (JQConv, JQDense), jit=False)(dv,
                                                                         x)
    plain = np_tree({k: t for k, t in dv.items() if k != "qint"})
    port = prepare_deploy(load_jax_variables(
        port_model("cifar_efficientnetb0", deploy=True), plain))
    return dict(t=t, dv=plain, qint=np_tree(dv["qint"]), fp=np.asarray(fp),
                int=np.asarray(logits_int), seen=seen, port=port)


def test_factories_registered_and_build_jax_configurations():
    for variant, (w, d, p) in _COEFFS.items():
        for name in (f"efficientnet{variant}", f"cifar_efficientnet{variant}"):
            j = jax_get_model(name)
            with torch.device("meta"):
                port = _REGISTRY[name]()
            assert (port.width_mult, port.depth_mult, port.dropout,
                    port.cifar) == (j.width_mult, j.depth_mult, j.dropout,
                                    j.cifar) == (w, d, p, port.cifar)
            assert port.cifar == name.startswith("cifar")
            assert len(port.block_names) == sum(
                int(np.ceil(d * r)) for _, _, r, _, _ in EfficientNet.CFG)


@pytest.mark.parametrize("name", ["efficientnetb0", "efficientnetb3"])
def test_parameter_counts_match_jax(name):
    j = jax_get_model(name)
    shapes = jax.eval_shape(j.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3),
                                                 jnp.float32))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        got = sum(p.numel() for p in _REGISTRY[name]().parameters())
    assert got == want
    if name == "efficientnetb0":
        assert 4.5e6 < got < 6e6, got


@pytest.mark.parametrize("name", list(CASES))
def test_train_form_fp_and_eval_match_jax(name):
    t = train_form(name)
    x = torch.from_numpy(t["x"])
    with torch.no_grad():
        fp = load_jax_variables(port_model(name), t["v"])(x, qmode="fp")
    assert fp.shape == (BATCH, CLASSES) and close(fp, t["fp"])
    flip = hold_eval(load_jax_variables(port_model(name), t["v_cal"]),
                     t["jm"], t["v_cal"], t["x"], t["eval"])
    print(f"{name} eval: tie flipped at {flip}")


def test_deploy_fold_matches_jax(effnet):
    t = effnet["t"]
    train = load_jax_variables(port_model(t["name"]), t["v"])
    dep = efficientnet_deploy(train)
    assert not any(isinstance(m, BatchNorm) for m in dep.modules())
    assert {m.eps for m in train.modules() if isinstance(m, BatchNorm)} \
        == {1e-3}
    jparams = effnet["dv"]["params"]
    n = 0
    for path, m in dep.named_modules():
        if isinstance(m, (QConv, QDense)):
            kern = node(jparams, path)["kernel"]
            kern = np.transpose(kern, (3, 2, 0, 1) if kern.ndim == 4
                                else (1, 0))
            for got, want in ((m.weight, kern),
                              (m.bias, node(jparams, path)["bias"])):
                np.testing.assert_allclose(
                    got.detach().numpy(), want, rtol=1e-6,
                    atol=1e-6 * np.abs(want).max(), err_msg=path)
            n += 1
    assert n == N_LAYERS
    with torch.no_grad():
        got = dep(torch.from_numpy(t["x"]), qmode="fp").numpy()
    for want in (t["fp"], effnet["fp"]):
        np.testing.assert_allclose(got, want, rtol=2e-3,
                                   atol=3e-5 * np.abs(want).max())


def test_layers_fed_jax_inputs(effnet):
    """Every conv and dense layer of the deploy form fed JAX's ``int``
    input: its input codes within one of JAX's (0 expected), and on JAX's
    codes its f32 output within 1e-6 relative."""
    port, seen, qint = effnet["port"], effnet["seen"], effnet["qint"]
    off_by_one = total = dw = n = 0
    for path, m in port.named_modules():
        if not isinstance(m, (QConv, QDense)):
            continue
        n += 1
        (x_j, *_), y_j = seen[path]
        if isinstance(m, QDense):
            with torch.no_grad():
                got = m(to_port(x_j), qmode="int")
            assert rel(got, np.asarray(y_j)) <= 1e-6, path
            continue
        codes_j = jax_codes(x_j, node(qint, path))
        with torch.no_grad():
            codes, epi_scale, bias_eff, pad = m._int_input(to_port(x_j))
            dq = np.abs(codes.numpy().astype(int) - codes_j.astype(int))
            assert dq.max() <= 1, path
            off_by_one += int((dq > 0).sum())
            total += dq.size
            de = m.deferred(torch.from_numpy(np.array(codes_j)), epi_scale,
                            bias_eff, pad)
            dw += isinstance(de.acc, PendingDwConv)
            got = chain.materialize(de).numpy()
        want = np.asarray(y_j)
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=path)
    print(f"cifar_efficientnetb0: {off_by_one} of {total} input codes one "
          "apart")
    assert dw == 16 and n == N_LAYERS


def test_int_and_intc_logits_match_jax(effnet):
    x = torch.from_numpy(effnet["t"]["x"])
    port = effnet["port"]
    with torch.no_grad():
        got = {q: port(x, qmode=q).numpy() for q in ("fp", "int", "intc")}
    assert np.array_equal(got["int"], got["intc"])
    assert np.isfinite(got["int"]).all()
    assert rel(got["int"], effnet["int"]) < 2e-2
    rel_int, rel_c = rel(got["int"], got["fp"]), rel(got["intc"], got["fp"])
    assert rel_c < max(1.5 * rel_int, 0.02), (rel_c, rel_int)


def test_request_launches(effnet):
    with torch.no_grad(), LaunchRecorder() as rec:
        effnet["port"](torch.from_numpy(images(4, 32)), qmode="intc")
    assert rec.counts() == LAUNCHES
    windows = [args[1].shape[0] for kind, args, _, _ in rec.calls
               if kind == "dwconv"]
    assert windows.count(25) == 9 and windows.count(9) == 7


def test_drop_connect_draws_from_its_generator():
    model = EfficientNet(0.25, 0.25, 0.5, num_classes=CLASSES, cifar=True,
                         drop_generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(images(5, 32))
    with torch.no_grad():
        model.eval()
        a, b = model(x, qmode="fp"), model(x, qmode="fp")
        assert torch.equal(a, b)
        model.train()
        model.drop_generator.manual_seed(7)
        c = model(x, qmode="fp")
        model.drop_generator.manual_seed(7)
        assert torch.equal(model(x, qmode="fp"), c)
        assert not torch.equal(model(x, qmode="fp"), c)
